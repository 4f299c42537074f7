"""Wall-clock timers and the profiling workflow.

Counterpart of ``apex_tpu/utils/timers.py`` (the Megatron-style timers of
``reference:apex/transformer/pipeline_parallel/_timers.py:6-79``).

- :class:`Timer`/:class:`Timers` keep the reference's API (start, stop,
  reset, elapsed, ``log``, ``write``). CUDA launches return before the
  card has run them, so ``stop(wait_for=tree)`` first calls
  :func:`device_fence` on the tensors the timed work produced; without
  ``wait_for`` a timer measures host wall time (the dispatch), which is
  what a blocking section wants.
- :func:`profile_trace` is the capture step: a ``torch.profiler`` window
  (CPU activity, and CUDA activity when a card is present) that writes a
  Chrome trace, ``trace.json``, into ``log_dir`` for Perfetto or
  ``chrome://tracing``.

While span capture is on (:mod:`apex_tpu_torch.observability.trace`),
every ``Timer.stop`` also hands ``(name, t0, t1)`` to the span recorder,
which a :class:`~apex_tpu_torch.observability.report.StepReporter` drains
into its sinks.

Typical workflow::

    from apex_tpu_torch.utils.timers import Timers, profile_trace

    timers = Timers()
    with profile_trace("/tmp/trace"):
        for step in range(3):
            timers("fwd-bwd").start()
            loss = model.loss(tokens, tokens)
            loss.backward()
            timers("fwd-bwd").stop(wait_for=loss)
    timers.log(["fwd-bwd"])
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["Timer", "Timers", "profile_trace", "device_fence",
           "set_span_hook"]

# installed by apex_tpu_torch.observability.trace while span capture is
# on: a callable (name, t0, t1) fed from every Timer.stop. A module global
# keeps the cost off at one None check a stop, with no import cycle
_SPAN_HOOK = None


def set_span_hook(hook) -> None:
    global _SPAN_HOOK
    _SPAN_HOOK = hook


def device_fence(tree: Any) -> None:
    """Block until the work that produced ``tree`` has run: the current
    stream of the first non-empty CUDA tensor leaf is synchronized (work
    on a stream runs in order, so one leaf drains everything queued before
    it). A tree of CPU tensors, or of none, returns at once."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            if leaf.is_cuda:
                torch.cuda.current_stream(leaf.device).synchronize()
            return


class Timer:
    """``_Timer`` (``_timers.py:9-56``) with an explicit device fence."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed_ = 0.0
        self.count_ = 0
        self.started_ = False
        self._t0 = 0.0

    def start(self) -> None:
        assert not self.started_, f"timer {self.name} already started"
        self._t0 = time.perf_counter()
        self.started_ = True

    def stop(self, wait_for: Any = None) -> None:
        assert self.started_, f"timer {self.name} is not started"
        if wait_for is not None:
            device_fence(wait_for)
        t1 = time.perf_counter()
        self.elapsed_ += t1 - self._t0
        self.count_ += 1
        self.started_ = False
        if _SPAN_HOOK is not None:
            _SPAN_HOOK(self.name, self._t0, t1)

    def reset(self) -> None:
        self.elapsed_ = 0.0
        self.count_ = 0
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        """Total elapsed seconds; a running timer is stopped for the read
        and started again, as the reference does (``_timers.py:40-56``)."""
        was_running = self.started_
        if was_running:
            self.stop()
        out = self.elapsed_
        if reset:
            self.reset()
        if was_running:
            self.start()
        return out

    @contextlib.contextmanager
    def __call__(self, wait_for: Any = None):
        self.start()
        try:
            yield
        finally:
            self.stop(wait_for=wait_for)


class Timers:
    """``_Timers`` (``_timers.py:59-79``): a named group."""

    def __init__(self):
        self.timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def write(self, names: Iterable[str], writer, iteration: int,
              normalizer: float = 1.0, reset: bool = False) -> None:
        """``writer.add_scalar(name + "-time", seconds, iteration)`` for
        each name (the TensorBoard protocol, ``_timers.py:66-75``)."""
        assert normalizer > 0.0
        for name in names:
            value = self.timers[name].elapsed(reset=reset) / normalizer
            writer.add_scalar(name + "-time", value, iteration)

    def log(self, names: Optional[Iterable[str]] = None,
            normalizer: float = 1.0, reset: bool = True) -> str:
        """Print ``time (ms) | name: x.xx`` (``_timers.py:76-79``) and
        return the string."""
        assert normalizer > 0.0
        if names is None:
            names = list(self.timers)
        string = "time (ms)"
        for name in names:
            ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            string += " | {}: {:.2f}".format(name, ms)
        print(string, flush=True)
        return string


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` window around the block (CPU activity, plus
    CUDA activity when a card is present) whose Chrome trace is written
    to ``<log_dir>/trace.json`` (``log_dir`` created if missing) when the
    block ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
