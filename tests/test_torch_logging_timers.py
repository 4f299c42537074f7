"""The port's rank-aware logging and its timers against the JAX package's,
on the CPU.

- Records through each package's ``RankInfoFormatter`` equal line for
  line (the same format, a fixed record time), with the process index
  before a mesh exists and with the mesh's (dp, tp, pp, vpp) once one
  does (each package's ``parallel_state`` answering the same sizes);
  ``setup_logging`` installing one handler on its own root logger
  (``"apex_tpu_torch"``, where the reference's is ``"apex_tpu"``), keeping
  a chosen verbosity, ``get_logger``'s names, ``set_verbosity``, and
  ``rank_zero_only`` on process 0 and elsewhere; the top-level
  ``get_logger``/``setup_logging``;
- ``Timer`` and ``Timers`` as the reference's: the assertions on a double
  start or a stop without a start, ``reset``, a timer as a context
  manager with ``wait_for``, ``count_``, and the span hook's calls.
"""

import io
import logging
import time

import numpy as np
import pytest
import torch

import apex_tpu.utils.logging as jlog
import apex_tpu.utils.timers as jtimers
import apex_tpu_torch
import apex_tpu_torch.utils.logging as tlog
import apex_tpu_torch.utils.timers as ttimers
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import parallel_state as tps

FMT = "%(asctime)s %(levelname)s %(rank_info)s %(name)s: %(message)s"


def _format(mod, name, level, msg, *args):
    fmt = mod.RankInfoFormatter(FMT, datefmt="%H:%M:%S")
    rec = logging.LogRecord(name, level, __file__, 1, msg, args, None)
    rec.created = 1.7e9 + 0.25
    return fmt.format(rec)


@pytest.mark.parametrize("mesh", [None, (4, 2, 1, None), (2, 1, 2, 3)])
def test_formatter_lines_match(mesh, monkeypatch):
    if mesh is not None:
        for ps in (jps, tps):
            monkeypatch.setattr(ps, "model_parallel_is_initialized",
                                lambda: True)
            monkeypatch.setattr(ps, "get_rank_info", lambda: mesh)
    for level, msg, args in ((logging.INFO, "step %d loss %.3f", (3, 2.5)),
                             (logging.WARNING, "overflow", ()),
                             (logging.ERROR, "rank %s died", ("1",))):
        got = _format(tlog, "apex_tpu_torch.train", level, msg, *args)
        want = _format(jlog, "apex_tpu_torch.train", level, msg, *args)
        assert got == want
    assert (str(mesh) if mesh else "(proc 0)") in got


@pytest.fixture
def fresh_logging(monkeypatch):
    """Each package's root logger as if never configured; restored
    after."""
    saved = {}
    for mod in (jlog, tlog):
        logger = logging.getLogger(mod._ROOT_NAME)
        saved[mod] = (list(logger.handlers), logger.level, logger.propagate)
        logger.handlers = []
        monkeypatch.setattr(mod, "_configured", False)
    yield
    for mod, (handlers, level, propagate) in saved.items():
        logger = logging.getLogger(mod._ROOT_NAME)
        logger.handlers, logger.level, logger.propagate = \
            handlers, level, propagate


def test_setup_logging_and_loggers(fresh_logging):
    outs = {}
    for mod in (jlog, tlog):
        stream = io.StringIO()
        root = mod.setup_logging(logging.DEBUG, stream=stream)
        assert root.name == mod._ROOT_NAME and not root.propagate
        assert mod.setup_logging(stream=io.StringIO()) is root
        assert len(root.handlers) == 1 and root.level == logging.DEBUG
        mod.set_verbosity(logging.WARNING)
        assert mod.setup_logging().level == logging.WARNING
        log = mod.get_logger("engine")
        assert log.name == f"{mod._ROOT_NAME}.engine"
        assert mod.get_logger() is root
        log.info("dropped at WARNING")
        log.warning("slot %d poisoned", 3)
        outs[mod] = [line.split(" ", 1)[1] for line in
                     stream.getvalue().splitlines()]
    assert tlog._ROOT_NAME == "apex_tpu_torch"
    assert outs[tlog] == [line.replace("apex_tpu.", "apex_tpu_torch.")
                          for line in outs[jlog]]
    assert outs[tlog] == ["WARNING (proc 0) apex_tpu_torch.engine: slot 3 "
                          "poisoned"]
    assert apex_tpu_torch.get_logger is tlog.get_logger
    assert apex_tpu_torch.setup_logging is tlog.setup_logging


def test_rank_zero_only(monkeypatch):
    calls = []

    def note(x):
        calls.append(x)
        return x * 2

    assert tlog.rank_zero_only(note)(4) == jlog.rank_zero_only(note)(4) == 8
    monkeypatch.setattr(multiproc, "_INFO", None)
    monkeypatch.setenv(multiproc.ENV_PROCESS_ID, "1")
    assert tlog.rank_zero_only(note)(5) is None
    assert calls == [4, 4]


def test_timer_rules_match(monkeypatch):
    ticks = iter(np.arange(10.0, 100.0, 0.5))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    results = []
    for mod in (jtimers, ttimers):
        seen = []
        mod.set_span_hook(lambda name, t0, t1: seen.append((name, t1 - t0)))
        try:
            t = mod.Timer("x")
            with pytest.raises(AssertionError, match="is not started"):
                t.stop()
            t.start()
            with pytest.raises(AssertionError, match="already started"):
                t.start()
            t.stop()
            with t():
                pass
            if mod is ttimers:
                with t(wait_for={"y": torch.ones(2)}):
                    pass
            else:
                with t(wait_for={"y": np.ones(2, np.float32)}):
                    pass
            count, total = t.count_, t.elapsed(reset=False)
            t.reset()
            results.append((count, total, t.count_, t.elapsed(), seen))
        finally:
            mod.set_span_hook(None)
    assert results[1] == results[0]
    assert results[1][0] == 3 and results[1][2] == 0
