"""StepReporter: one snapshot a training step into pluggable sinks.

Counterpart of ``apex_tpu/observability/report.py``. Each
:meth:`~StepReporter.report` merges into one payload:

- the step's in-step :class:`~apex_tpu_torch.observability.ingraph.
  Metrics` (0-d tensors on the device, read back with one transfer,
  :meth:`Metrics.as_floats`);
- the host :class:`~apex_tpu_torch.observability.registry.MetricsRegistry`
  snapshot (compile counters, sampled memory gauges, ...);
- each finished timer of a ``Timers`` group as ``time/<name>_ms`` (the
  ``_Timers.write`` role, ``reference:apex/transformer/pipeline_parallel/
  _timers.py:66-75``);

and emits it to every sink, with any captured timer spans.

The module-level default is a :class:`NullReporter`, so library code and
training loops can call ``get_reporter().report(...)`` at no cost;
:func:`attach_reporter` installs a real one.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Sequence

from apex_tpu_torch.observability import trace
from apex_tpu_torch.observability.ingraph import Metrics
from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry)
from apex_tpu_torch.observability.sinks import Sink

__all__ = ["StepReporter", "NullReporter", "attach_reporter",
           "detach_reporter", "get_reporter"]


class StepReporter:
    """Registry + timers + in-step metrics into sinks.

    ``interval`` reports every Nth step; the others are dropped without a
    read from the card. ``capture_spans`` turns on ``Timer`` span capture
    for the reporter's life, for a
    :class:`~apex_tpu_torch.observability.sinks.ChromeTraceSink`.

    ``hooks`` are host callbacks ``hook(step, payload)`` run after the
    sinks emit (a hook that raises, as the health monitor does at
    ``on_nonfinite="raise"``, does so after the failing step reached every
    sink). Hooks also run on off-interval steps that carry ``metrics``,
    with the in-step payload alone and no sink emission: a watchdog that
    saw every Nth step would miss a transient non-finite step. That read
    a step is the watchdog's price; without hooks off-interval steps read
    nothing.

    :meth:`attach_flops_budget` (or ``flops_per_step``) turns on the
    ``perf/mfu`` gauge from the wall time between reports, against
    :func:`~apex_tpu_torch.observability.costs.peak_flops` by default;
    :meth:`attach_memory_budget` sets the ``mem/*`` gauges and
    :meth:`attach_attribution` the ``perf/*`` attribution gauges (duck
    typed: any object with the reference's ``AttributionReport`` fields).
    """

    def __init__(self, sinks: Sequence[Sink],
                 registry: Optional[MetricsRegistry] = None,
                 timers=None, interval: int = 1,
                 capture_spans: bool = False,
                 hooks: Sequence[Callable[[int, Dict[str, float]], None]]
                 = (),
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        if interval < 1:
            raise ValueError("interval must be >= 1")
        self.sinks = list(sinks)
        self.registry = registry if registry is not None else get_registry()
        self.timers = timers
        self.interval = interval
        self.hooks = list(hooks)
        self._capture_spans = capture_spans
        self._flops_per_step: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._last_report: Optional[tuple] = None  # (step, perf_counter)
        if flops_per_step is not None:
            self.attach_flops_budget(flops_per_step, peak_flops)
        if capture_spans:
            trace.enable_spans()

    def attach_flops_budget(self, flops_per_step: float,
                            peak: Optional[float] = None) -> "StepReporter":
        """Turn on ``perf/mfu``: ``flops_per_step`` are a step's model
        FLOPs (an analytic count, or
        :func:`~apex_tpu_torch.observability.costs.flops_budget`); ``peak``
        defaults to the first card's
        :func:`~apex_tpu_torch.observability.costs.peak_flops`. A value
        that is not positive raises ``ValueError`` here rather than in a
        report. Returns self."""
        from apex_tpu_torch.observability.costs import peak_flops as _peak
        flops = float(flops_per_step)
        peak = float(peak) if peak is not None else _peak()
        if flops <= 0.0 or peak <= 0.0:
            raise ValueError("flops_per_step and peak must be positive, "
                             f"got {flops} and {peak}")
        self._flops_per_step = flops
        self._peak_flops = peak
        return self

    def attach_memory_budget(self, budget) -> "StepReporter":
        """Set the ``mem/*`` gauges from ``budget``: the dict
        :func:`~apex_tpu_torch.observability.costs.memory_budget` returns,
        or an object with ``memory_analysis()`` to read it from. None (no
        budget off the card) leaves the gauges unset. Returns self."""
        if budget is not None and not isinstance(budget, dict):
            from apex_tpu_torch.observability.costs import memory_budget
            budget = memory_budget(budget)
        if budget is None:
            return self
        reg = self.registry
        reg.gauge("mem/peak_hbm_bytes").set(budget["peak_hbm_bytes"])
        reg.gauge("mem/temp_bytes").set(budget["temp_bytes"])
        reg.gauge("mem/argument_bytes").set(budget["argument_bytes"])
        reg.gauge("mem/output_bytes").set(budget["output_bytes"])
        reg.gauge("mem/host_temp_bytes").set(budget["host_temp_bytes"])
        return self

    def attach_attribution(self, report) -> "StepReporter":
        """Set ``perf/modeled_step_ms``, and ``perf/comm_exposed_ms`` and
        ``perf/overlap_efficiency`` where they are not None, from an
        attribution report (anything with those three attributes).
        Returns self."""
        reg = self.registry
        reg.gauge("perf/modeled_step_ms").set(report.modeled_step_ms)
        if report.comm_exposed_ms is not None:
            reg.gauge("perf/comm_exposed_ms").set(report.comm_exposed_ms)
        if report.overlap_efficiency is not None:
            reg.gauge("perf/overlap_efficiency").set(
                report.overlap_efficiency)
        return self

    def _update_mfu(self, step: int) -> None:
        """Set ``perf/mfu`` from the wall time since the previous report;
        it reaches the payload through the registry snapshot."""
        if self._flops_per_step is None:
            return
        now = time.perf_counter()
        prev, self._last_report = self._last_report, (step, now)
        if prev is None:
            return
        d_steps, dt = step - prev[0], now - prev[1]
        if d_steps <= 0 or dt <= 0.0:
            return
        from apex_tpu_torch.observability.costs import mfu
        value = mfu(self._flops_per_step * d_steps, dt, self._peak_flops)
        # a ~0 wall delta gives NaN or inf: leave the gauge as it was
        # rather than report a made-up utilization
        if math.isfinite(value):
            self.registry.gauge("perf/mfu").set(value)

    @staticmethod
    def _metrics_payload(metrics) -> Dict[str, float]:
        """One read from the card for the step's in-step metrics."""
        if isinstance(metrics, Metrics):
            return metrics.as_floats()
        return {k: float(v) for k, v in metrics.items()}

    def _timer_payload(self, reset: bool) -> Dict[str, float]:
        if self.timers is None:
            return {}
        out = {}
        for name, t in self.timers.timers.items():
            if t.started_:  # a running timer is left alone
                continue
            out[f"time/{name}_ms"] = t.elapsed(reset=reset) * 1e3
        return out

    def report(self, step: int, metrics: Optional[Metrics] = None,
               extra: Optional[Dict[str, float]] = None,
               reset_timers: bool = True) -> Optional[Dict[str, float]]:
        """Emit one payload and return it (None on an off-interval step).
        ``metrics`` is the step's :class:`Metrics` (or a plain dict of
        scalars); ``extra`` merges host-side values (e.g. a loss already
        read)."""
        if step % self.interval:
            if self.hooks and metrics is not None:
                payload = self._metrics_payload(metrics)
                for hook in self.hooks:
                    hook(step, payload)
            return None
        payload: Dict[str, float] = {}
        if metrics is not None:
            payload.update(self._metrics_payload(metrics))
        self._update_mfu(step)
        payload.update(self.registry.snapshot())
        payload.update(self._timer_payload(reset=reset_timers))
        if extra:
            payload.update({k: float(v) for k, v in extra.items()})
        spans = trace.drain_spans() if trace.spans_enabled() else []
        for sink in self.sinks:
            sink.emit(step, payload, spans)
        # after the sinks: a raising policy never loses the failing step
        for hook in self.hooks:
            hook(step, payload)
        return payload

    def close(self) -> None:
        if self._capture_spans:
            trace.disable_spans()
        for sink in self.sinks:
            sink.close()
        # a closed reporter must not stay the process default
        if _ACTIVE is self:
            detach_reporter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullReporter:
    """The module-level no-op default: the reporter's surface, doing
    nothing."""

    sinks: tuple = ()
    interval = 1

    def report(self, step, metrics=None, extra=None, reset_timers=True):
        return None

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __bool__(self):
        return False  # `if get_reporter():` reads naturally


_NULL = NullReporter()
_ACTIVE = _NULL


def get_reporter():
    """The attached reporter, or the no-op default."""
    return _ACTIVE


def attach_reporter(reporter: StepReporter):
    """Make ``reporter`` the process-wide default; returns it, so ``with
    attach_reporter(StepReporter(...)):`` works."""
    global _ACTIVE
    _ACTIVE = reporter
    return reporter


def detach_reporter() -> None:
    global _ACTIVE
    _ACTIVE = _NULL
