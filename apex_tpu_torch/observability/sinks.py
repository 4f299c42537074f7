"""Metric sinks of the :class:`~apex_tpu_torch.observability.report.
StepReporter`.

Counterpart of ``apex_tpu/observability/sinks.py``. A sink receives one
flattened ``{name: float}`` payload (and any timer spans) a reported step:

- :class:`JSONLSink`: one strict-JSON object a step, the grep-able event
  log;
- :class:`TensorBoardSink`: ``writer.add_scalar(tag, value, step)`` on any
  object with that method (the protocol ``Timers.write`` targets), so a
  ``SummaryWriter`` drops in; the port imports no TensorBoard;
- :class:`ChromeTraceSink`: timer spans, and the payloads as counter
  tracks, in a ``chrome://tracing``/Perfetto JSON written on ``close``.

:func:`json_safe_value`/:func:`json_safe_metrics` spell non-finite floats
as the strings ``"NaN"``/``"Infinity"``/``"-Infinity"``, which strict
JSON parsers take; health metrics carry them by design.
"""

from __future__ import annotations

import io
import json
import math
import os
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Union

from apex_tpu_torch.observability.registry import json_safe_float
from apex_tpu_torch.observability.trace import (Span, chrome_trace_events,
                                                trace_metadata)

__all__ = ["Sink", "JSONLSink", "TensorBoardSink", "ChromeTraceSink",
           "json_safe_value", "json_safe_metrics"]


def json_safe_value(value: Any) -> Any:
    """Non-finite floats as the strings ``"NaN"``/``"Infinity"``/
    ``"-Infinity"``; every other value passes through untouched."""
    if isinstance(value, float) and not math.isfinite(value):
        return json_safe_float(value)
    return value


def json_safe_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: json_safe_value(v) for k, v in metrics.items()}


class Sink:
    """Interface: ``emit`` once a reported step, ``close`` at shutdown."""

    def emit(self, step: int, metrics: Dict[str, float],
             spans: Sequence[Span] = ()) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JSONLSink(Sink):
    """One ``{"step", "time", "metrics"}`` JSON line a report, to a path
    (opened for append, flushed each line) or any text file object."""

    def __init__(self, path_or_file: Union[str, os.PathLike, io.TextIOBase]):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._file = open(path_or_file, "a")
            self._owns = True
        else:
            self._file = path_or_file
            self._owns = False

    def emit(self, step, metrics, spans=()):
        self._file.write(json.dumps(
            {"step": int(step), "time": time.time(),
             "metrics": {k: json_safe_value(metrics[k])
                         for k in sorted(metrics)}},
            allow_nan=False) + "\n")
        self._file.flush()

    def close(self):
        if self._owns:
            self._file.close()


class TensorBoardSink(Sink):
    """A payload as ``writer.add_scalar(name, value, step)`` calls."""

    def __init__(self, writer):
        if not hasattr(writer, "add_scalar"):
            raise TypeError("TensorBoardSink needs an object with "
                            "add_scalar(tag, value, step)")
        self.writer = writer

    def emit(self, step, metrics, spans=()):
        for name in sorted(metrics):
            self.writer.add_scalar(name, metrics[name], step)

    def close(self):
        flush = getattr(self.writer, "flush", None)
        if flush is not None:
            flush()


class ChromeTraceSink(Sink):
    """Spans as complete events and payloads as counter events
    (``ph="C"``), written as one Chrome-trace JSON on ``close``. ``pid``
    defaults to this process's rank
    (:func:`apex_tpu_torch.parallel.multiproc.process_id`); ``counters``
    is True (every metric), False, or the names to keep."""

    def __init__(self, path: Union[str, os.PathLike],
                 pid: Optional[int] = None,
                 counters: Union[bool, Iterable[str]] = True):
        self.path = os.fspath(path)
        if pid is None:
            from apex_tpu_torch.parallel import multiproc
            pid = multiproc.process_id()
        self.pid = pid
        self._counters = counters
        self._events = []
        # sampled once: what aligns this file's perf_counter timestamps
        # with other ranks' in merge_chrome_traces
        self._metadata = trace_metadata()

    def emit(self, step, metrics, spans=()):
        self._events.extend(
            chrome_trace_events(spans, pid=self.pid, step=step))
        if self._counters and metrics:
            names = (sorted(metrics) if self._counters is True
                     else [n for n in self._counters if n in metrics])
            ts = time.perf_counter() * 1e6
            for name in names:
                self._events.append(
                    {"name": name, "ph": "C", "cat": "apex_tpu",
                     "ts": ts, "pid": self.pid,
                     "args": {name: json_safe_value(metrics[name])}})

    def close(self):
        with open(self.path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms",
                       "metadata": self._metadata}, f, allow_nan=False)
