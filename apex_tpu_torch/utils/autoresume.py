"""Preemption-aware auto-resume: the port's ``apex_tpu/utils/autoresume.py``.

The reference's cluster hook (ADLR's ``AutoResume``: ``get_autoresume``,
``reference:apex/transformer/pipeline_parallel/utils.py:142-144``, and the
``--adlr-autoresume-interval`` polling) made self-contained: a preempted
job gets SIGTERM with a grace window, so the request comes from a signal
handler, plus the ``APEX_TPU_TERMINATE`` env var and an optional hook for
a cluster scheduler; the answer is "checkpoint through
:mod:`apex_tpu_torch.checkpoint`, then ask for a clean exit; on restart,
restore the latest checkpoint". No tensor is involved: the class is the
reference's, line for line.

Usage::

    ar = AutoResume(interval=50)          # poll every 50 steps
    for step in range(start, total):
        ...train...
        if ar.termination_requested(step):
            save_checkpoint(dir, state, step, host_state={"step": step})
            ar.request_resume()           # exit(0) -> scheduler restarts
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import Callable, Optional

__all__ = ["AutoResume"]


class AutoResume:
    """Termination detection + resume request.

    ``hook``: optional callable returning True when the scheduler wants
    the job to stop (the role of ADLR's ``AutoResume.termination_
    requested``); the ``APEX_TPU_TERMINATE`` env var (any non-empty
    value — whitespace-only strings count, only the empty string and an
    unset var do not) and SIGTERM are always honored.

    Every source LATCHES: once SIGTERM arrives, the env var reads
    non-empty, or the hook returns True on any polled step, the request
    is permanent for this instance — a hook that fires once at step K
    and then returns False at K+1 (or an env var cleared between polls)
    cannot lose the termination request.
    """

    def __init__(self, interval: int = 1,
                 hook: Optional[Callable[[], bool]] = None,
                 install_sigterm_handler: bool = True):
        if interval < 1:
            raise ValueError("interval must be >= 1")
        self.interval = interval
        self.hook = hook
        self._flag = threading.Event()
        self._prev_handler = None
        if install_sigterm_handler and threading.current_thread() is \
                threading.main_thread():
            self._prev_handler = signal.signal(
                signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        self._flag.set()
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    def termination_requested(self, step: Optional[int] = None) -> bool:
        """True when the job should checkpoint and stop. With ``step``,
        external hooks are only polled every ``interval`` steps (the
        ``--adlr-autoresume-interval`` semantics); the SIGTERM flag is
        always checked."""
        if self._flag.is_set():
            return True
        if step is not None and step % self.interval:
            return False
        # "any non-empty" contract: a whitespace-only value is a request;
        # only unset / empty-string is not
        if os.environ.get("APEX_TPU_TERMINATE", "") != "" or (
                self.hook is not None and bool(self.hook())):
            # latch: a hook that returns True once at step K then False at
            # K+1 (or an env var cleared between polls) must not lose the
            # request — the next poll may be an interval-off step
            self._flag.set()
            return True
        return False

    def close(self) -> None:
        """Restore the previous SIGTERM handler. Call (or use the instance
        as a context manager) when the training run ends, so abandoned
        instances do not permanently swallow SIGTERM or chain handlers."""
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except ValueError:  # not in main thread anymore
                pass
            self._prev_handler = None

    def __enter__(self) -> "AutoResume":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request_resume(self, exit_code: int = 0) -> None:
        """Clean exit so the scheduler restarts the job (ADLR
        ``request_resume``). Call after checkpointing."""
        sys.exit(exit_code)
