"""Serving SLO tracking: latency targets, rolling goodput, burn rate, and a
flight-recorder dump on violation.

The port's copy of ``apex_tpu/observability/slo.py``:

- :class:`SLOTarget`: one target, e.g. *TTFT p95 <= 200 ms* (``metric``
  is a request-record latency field; ``quantile`` sets both the
  percentile to police and the error budget ``1 - q/100``);
- :class:`SLOTracker`: :meth:`~SLOTracker.observe` ingests each retired
  :class:`~apex_tpu_torch.observability.reqtrace.RequestRecord` (the
  scheduler calls it when wired with ``slo=``), keeps a rolling window per
  target and sets the ``slo/*`` gauges: goodput (the share of windowed
  requests meeting every target and not retired by a server-side failure),
  burn rate (the over-threshold share over the error budget: 1.0 burns
  exactly the budget) and a 0/1 ``violating`` flag;
- the reporter hook: the tracker is a callable ``(step, payload)``; after
  ``consecutive`` violating reports it writes a flight-recorder
  :class:`~apex_tpu_torch.observability.health.CrashDump` whose
  ``requests`` carry the last records of the attached
  :class:`~apex_tpu_torch.observability.reqtrace.RequestTrace`, and with
  ``on_violation="raise"`` raises :class:`SLOViolationError`.

All of it is host arithmetic over timestamps already taken.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.observability.health import CrashDump
from apex_tpu_torch.observability.registry import get_registry
from apex_tpu_torch.observability.reqtrace import RequestRecord, RequestTrace

__all__ = ["SLOTarget", "SLOTracker", "SLOViolationError",
           "LATENCY_METRICS", "ON_VIOLATION", "FAILED_REASONS"]

LATENCY_METRICS = ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms")
ON_VIOLATION = ("skip", "dump", "raise")

# finish reasons that are server-side failures: such a retirement counts
# against goodput whatever its (often absent) latencies say, or a request
# expired while queued (no ttft, tiny e2e) would read as served well at the
# moment the server sheds its queue. "cancelled" stays latency-based: a
# user disconnect is not the server failing.
FAILED_REASONS = ("expired", "poisoned", "error")


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """``metric``'s p-``quantile`` must stay at or under ``threshold_ms``;
    *p95 <= X* tolerates 5% of requests over X (the error budget)."""

    metric: str
    quantile: float
    threshold_ms: float

    def __post_init__(self):
        if self.metric not in LATENCY_METRICS:
            raise ValueError(f"metric must be one of {LATENCY_METRICS}, "
                             f"got {self.metric!r}")
        if not 0.0 < self.quantile < 100.0:
            raise ValueError("quantile must be in (0, 100), "
                             f"got {self.quantile!r}")
        if self.threshold_ms <= 0.0:
            raise ValueError("threshold_ms must be positive, "
                             f"got {self.threshold_ms!r}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.quantile / 100.0

    def describe(self) -> str:
        return f"{self.metric} p{self.quantile:g} <= {self.threshold_ms:g}ms"


class SLOViolationError(RuntimeError):
    """A target's window exceeded its budget under
    ``on_violation="raise"``; carries the flight-recorder
    :class:`CrashDump` and the path it was written to."""

    def __init__(self, message: str, dump: CrashDump,
                 dump_path: Optional[str] = None):
        super().__init__(message)
        self.dump = dump
        self.dump_path = dump_path


class SLOTracker:
    """See module docstring.

    Args:
      targets: the :class:`SLOTarget` list (at least one).
      window: rolling window in requests for goodput, burn rate and the
        percentile readouts.
      registry: the registry of the ``slo/*`` family (the process default
        when None).
      trace: the :class:`RequestTrace` a violation dump draws its last
        ``flight_n`` records from.
      on_violation: ``"skip"`` (gauges only), ``"dump"`` (write the
        flight-recorder dump) or ``"raise"`` (dump, then raise
        :class:`SLOViolationError`).
      dump_dir: where ``slo_dump_step<N>.json`` files land.
      flight_n: how many trailing request records a dump carries.
      consecutive: violating reports in a row before the hook fires (a
        clean report resets the streak).
    """

    def __init__(self, targets: Sequence[SLOTarget], *, window: int = 512,
                 registry=None, trace: Optional[RequestTrace] = None,
                 on_violation: str = "dump", dump_dir: str = ".",
                 flight_n: int = 64, consecutive: int = 1):
        targets = tuple(targets)
        if not targets:
            raise ValueError("need at least one SLOTarget")
        if on_violation not in ON_VIOLATION:
            raise ValueError(f"on_violation must be one of {ON_VIOLATION}, "
                             f"got {on_violation!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if consecutive < 1:
            raise ValueError(f"consecutive must be >= 1, got {consecutive}")
        self.targets = targets
        self.window = int(window)
        self.trace = trace
        self.on_violation = on_violation
        self.dump_dir = dump_dir
        self.flight_n = int(flight_n)
        self.consecutive = int(consecutive)
        self._reg = registry if registry is not None else get_registry()
        # rolling windows with incremental counters, so observe() (on the
        # scheduler's retirement path) costs O(targets), not O(window);
        # eviction is explicit so the counters can follow it
        self._vals = [collections.deque() for _ in targets]
        self._over = [0 for _ in targets]
        self._good: collections.deque = collections.deque()
        self._good_count = 0
        self.dumps: List[str] = []
        self.streak = 0
        self._last_dump: Optional[CrashDump] = None

    # -- ingestion ----------------------------------------------------------

    def observe(self, record: RequestRecord) -> None:
        """Ingest one retired request and refresh the ``slo/*`` gauges. A
        latency the request does not define (``tpot_ms`` of a one-token
        request) counts neither for nor against its target; a
        :data:`FAILED_REASONS` retirement counts against goodput."""
        good = record.finish_reason not in FAILED_REASONS
        for i, target in enumerate(self.targets):
            v = getattr(record, target.metric)
            if v is None:
                continue
            vals = self._vals[i]
            if len(vals) >= self.window:
                if vals.popleft() > target.threshold_ms:
                    self._over[i] -= 1
            vals.append(float(v))
            if v > target.threshold_ms:
                self._over[i] += 1
                good = False
        if len(self._good) >= self.window:
            self._good_count -= self._good.popleft()
        self._good.append(good)
        self._good_count += good
        self._update_gauges()

    # -- rolling readouts ---------------------------------------------------

    def goodput(self) -> float:
        """Share of windowed requests that met every target and did not
        retire by a server-side failure; NaN before the first
        retirement."""
        if not self._good:
            return float("nan")
        return self._good_count / len(self._good)

    def burn_rate(self, target: SLOTarget) -> float:
        """The over-threshold share over the target's error budget (1.0
        burns exactly the budget); NaN with no samples."""
        i = self.targets.index(target)
        if not self._vals[i]:
            return float("nan")
        return (self._over[i] / len(self._vals[i])) / target.error_budget

    def max_burn_rate(self) -> float:
        """The worst burn rate across targets (NaN with no samples)."""
        burns = [b for t in self.targets
                 if (b := self.burn_rate(t)) == b]
        return max(burns) if burns else float("nan")

    def window_percentile(self, target: SLOTarget) -> float:
        """The target metric's p-``quantile`` over the window, exact
        ``np.percentile`` of the retained samples, computed on demand."""
        i = self.targets.index(target)
        vals = self._vals[i]
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals), target.quantile))

    def violating_targets(self) -> List[SLOTarget]:
        """Targets whose windowed over-threshold share exceeds the error
        budget."""
        return [t for t in self.targets
                if self.burn_rate(t) > 1.0]  # NaN > 1 is False

    def _update_gauges(self) -> None:
        reg = self._reg
        reg.gauge("slo/goodput").set(self.goodput())
        burn = self.max_burn_rate()
        if burn == burn:  # skip the NaN empty-window readout
            reg.gauge("slo/burn_rate").set(burn)
        reg.gauge("slo/violating").set(
            1.0 if self.violating_targets() else 0.0)
        reg.gauge("slo/window_requests").set(float(len(self._good)))

    # -- the flight recorder ------------------------------------------------

    def flight_dump(self, step: int = 0,
                    payload: Optional[Dict[str, float]] = None) -> str:
        """Write the flight-recorder dump now: a strict-JSON
        :class:`CrashDump` whose ``requests`` hold the last ``flight_n``
        request records. Returns the written path."""
        records = self.trace.last(self.flight_n) if self.trace else []
        dump = CrashDump.from_payload(
            step, payload if payload is not None else {},
            requests=[r.to_dict() for r in records])
        dump.config = {
            "targets": [t.describe() for t in self.targets],
            "window": self.window, "on_violation": self.on_violation,
            "flight_n": self.flight_n, "consecutive": self.consecutive,
        }
        path = dump.write(self.dump_dir, prefix="slo_dump")
        self.dumps.append(path)
        self._last_dump = dump
        return path

    # -- the reporter hook --------------------------------------------------

    def __call__(self, step: int, payload: Dict[str, float]) -> None:
        """Evaluated once per reported payload."""
        if self.on_violation == "skip":
            return
        violating = self.violating_targets()
        if not violating:
            self.streak = 0
            return
        self.streak += 1
        if self.streak < self.consecutive:
            return
        self._reg.counter("slo/violations").inc()
        path = self.flight_dump(step, payload)
        if self.on_violation == "raise":
            desc = "; ".join(
                f"{t.describe()} (p{t.quantile:g}="
                f"{self.window_percentile(t):.1f}ms)" for t in violating)
            raise SLOViolationError(
                f"SLO violated at step {step}: {desc}; flight recorder: "
                f"{path}", self._last_dump, dump_path=path)

    def reporter_hook(self) -> "SLOTracker":
        """The tracker is the hook."""
        return self
