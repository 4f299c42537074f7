"""Wall-clock span capture and its Chrome-trace (Perfetto) export.

Counterpart of ``apex_tpu/observability/trace.py``.
:class:`~apex_tpu_torch.utils.timers.Timer` keeps elapsed totals; trace
viewers want spans. While span recording is on, every ``Timer.stop``
pushes ``(name, t0, t1)`` here through a hook installed into
:mod:`apex_tpu_torch.utils.timers` (one ``is None`` test a stop when off,
and no import cycle: this module imports nothing else of the port at its
top). The :class:`~apex_tpu_torch.observability.sinks.ChromeTraceSink`
drains the buffer each report and writes the ``traceEvents`` JSON, which
loads in ``chrome://tracing`` or Perfetto beside a ``torch.profiler``
trace (:func:`~apex_tpu_torch.utils.timers.profile_trace`).

:func:`epoch_offset` and :func:`trace_metadata` stamp each document with
the translation from this process's ``perf_counter`` timebase to the unix
epoch, which :func:`merge_chrome_traces` uses to put several ranks' files
on one timeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterable, List, NamedTuple, Optional

__all__ = ["Span", "spans_enabled", "enable_spans", "disable_spans",
           "record_span", "drain_spans", "span_recording",
           "chrome_trace_events", "epoch_offset", "trace_metadata",
           "merge_chrome_traces"]


class Span(NamedTuple):
    name: str
    start: float  # perf_counter seconds
    end: float


_LOCK = threading.Lock()
_SPANS: List[Span] = []
_ENABLED = False


def spans_enabled() -> bool:
    return _ENABLED


def record_span(name: str, start: float, end: float) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _SPANS.append(Span(name, start, end))


def _install_timer_hook(on: bool) -> None:
    from apex_tpu_torch.utils import timers
    timers.set_span_hook(record_span if on else None)


def enable_spans() -> None:
    global _ENABLED
    _ENABLED = True
    _install_timer_hook(True)


def disable_spans() -> None:
    """Stop recording and drop the spans not drained: a later recording
    must not inherit them under its own step numbers."""
    global _ENABLED
    _ENABLED = False
    _install_timer_hook(False)
    with _LOCK:
        _SPANS.clear()


def drain_spans() -> List[Span]:
    with _LOCK:
        out = list(_SPANS)
        _SPANS.clear()
    return out


@contextlib.contextmanager
def span_recording():
    """Record spans over a region (e.g. the whole training loop)."""
    was = _ENABLED
    enable_spans()
    try:
        yield
    finally:
        if not was:
            disable_spans()


def epoch_offset() -> float:
    """``time.time() - time.perf_counter()``: the translation from this
    process's ``perf_counter`` timebase, whose zero point is arbitrary, to
    the unix epoch, so traces of several processes can be aligned."""
    return time.time() - time.perf_counter()


def trace_metadata() -> dict:
    """The metadata block a Chrome-trace export stamps into its document:
    the clock its ``ts`` fields are in and the epoch offset."""
    return {"clock": "perf_counter", "epoch_offset_s": epoch_offset()}


def merge_chrome_traces(docs: Iterable[dict]) -> dict:
    """Per-rank Chrome-trace documents merged onto one epoch timeline.

    Each document must carry ``metadata.epoch_offset_s`` (both exporters
    stamp it), else ``ValueError``; every event's ``ts`` is shifted by its
    document's offset. When a pid appears in more than one document, each
    ``(document, pid)`` pair gets a fresh pid (document order, then pid
    order); documents whose pids do not collide keep theirs. The merged
    document's metadata says ``clock: "epoch"`` with offset 0.
    """
    docs = list(docs)
    for i, doc in enumerate(docs):
        meta = doc.get("metadata") or {}
        if "epoch_offset_s" not in meta:
            raise ValueError(
                f"trace document {i} carries no metadata.epoch_offset_s "
                f"— cannot align its process-local perf_counter timebase")
    doc_pids = [{ev.get("pid", 0) for ev in doc.get("traceEvents", [])}
                for doc in docs]
    seen: set = set()
    collide = False
    for pids in doc_pids:
        if pids & seen:
            collide = True
            break
        seen |= pids
    remap: dict = {}
    if collide:
        for i, pids in enumerate(doc_pids):
            for p in sorted(pids, key=repr):
                remap[(i, p)] = len(remap)
    events: List[dict] = []
    for i, doc in enumerate(docs):
        shift_us = float(doc["metadata"]["epoch_offset_s"]) * 1e6
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            if collide:
                ev["pid"] = remap[(i, ev.get("pid", 0))]
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"clock": "epoch", "epoch_offset_s": 0.0}}


def chrome_trace_events(spans, pid: int = 0, tid: int = 0,
                        step: Optional[int] = None) -> List[dict]:
    """Spans as Chrome-trace complete events (``ph="X"``, microsecond
    timestamps); ``step``, when given, lands in ``args``."""
    events = []
    for s in spans:
        ev = {"name": s.name, "ph": "X", "cat": "apex_tpu",
              "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
              "pid": pid, "tid": tid}
        if step is not None:
            ev["args"] = {"step": step}
        events.append(ev)
    return events
