"""Rank-aware logging (reference: ``reference:apex/__init__.py:27-39`` and
``reference:apex/transformer/log_util.py:5-20``).

Counterpart of ``apex_tpu/utils/logging.py``, under the root logger
``"apex_tpu_torch"``. Every record carries the process index
(:func:`apex_tpu_torch.parallel.multiproc.process_id`) or, once the mesh
is initialized, the (dp, tp, pp, vpp) tuple of
:func:`apex_tpu_torch.transformer.parallel_state.get_rank_info`, so logs
of several processes interleave legibly. :func:`rank_zero_only` gates
chatty messages the way amp's ``maybe_print`` does
(``reference:apex/amp/_amp_state.py:39-51``).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

__all__ = ["RankInfoFormatter", "get_logger", "setup_logging",
           "rank_zero_only", "set_verbosity"]

_ROOT_NAME = "apex_tpu_torch"


def _process_index() -> int:
    from apex_tpu_torch.parallel import multiproc
    return multiproc.process_id()


def _rank_info() -> str:
    """(dp, tp, pp, vpp) once the mesh is initialized, else the process
    index."""
    from apex_tpu_torch.transformer import parallel_state
    if parallel_state.model_parallel_is_initialized():
        return str(parallel_state.get_rank_info())
    return f"(proc {_process_index()})"


class RankInfoFormatter(logging.Formatter):
    def format(self, record):
        record.rank_info = _rank_info()
        return super().format(record)


_configured = False


def setup_logging(level: Optional[int] = None, stream=None) -> logging.Logger:
    """Install the rank-aware handler on the ``apex_tpu_torch`` logger
    (once). ``level=None`` leaves a configured logger's level as it is, so
    an implicit ``get_logger`` never resets a verbosity the user chose."""
    global _configured
    logger = logging.getLogger(_ROOT_NAME)
    if not _configured:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(RankInfoFormatter(
            "%(asctime)s %(levelname)s %(rank_info)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(logging.INFO if level is None else level)
        _configured = True
    elif level is not None:
        logger.setLevel(level)
    return logger


def get_logger(name: Optional[str] = None) -> logging.Logger:
    setup_logging()
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)


def set_verbosity(level: int) -> None:
    logging.getLogger(_ROOT_NAME).setLevel(level)


def rank_zero_only(fn):
    """Decorator: run only on process 0 (cf. ``maybe_print``'s rank
    gating); elsewhere the call returns None."""

    def wrapped(*args, **kwargs):
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped
