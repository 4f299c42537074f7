"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of ``apex_tpu/observability/registry.py`` (that module
imports nothing of JAX, but the port imports nothing of the JAX package):
plain Python accumulators for host-observed quantities such as the
scheduler's ``serve/*`` family. A :class:`MetricsRegistry` is a named
collection whose :meth:`~MetricsRegistry.snapshot` flattens everything to
``{name: float}``; :func:`get_registry` is the process-wide default.
:meth:`~MetricsRegistry.to_dict` / :meth:`~MetricsRegistry.from_dict` carry
a registry's typed state across a process boundary as strict JSON, and
:meth:`~MetricsRegistry.render_prometheus` is its Prometheus text
exposition.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS", "log_buckets",
           "json_safe_float", "json_float"]

# power-of-4 spread from sub-millisecond to minutes
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(4.0 ** e for e in range(-6, 6))


def log_buckets(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """``n`` log-spaced bucket bounds from ``lo`` to ``hi`` inclusive.
    Adjacent bounds keep the constant ratio ``r = (hi/lo)**(1/(n-1))``,
    which bounds the relative error of :meth:`Histogram.percentile` by
    ``r - 1``."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if n < 2:
        raise ValueError(f"need at least 2 bounds, got n={n}")
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


class Metric:
    """Base: a named observable with a uniform ``observe`` write API."""

    def __init__(self, name: str):
        self.name = name

    def observe(self, value: float) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def snapshot(self) -> Dict[str, float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(Metric):
    """Monotonic accumulator."""

    def __init__(self, name: str):
        super().__init__(name)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    observe = inc

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, float]:
        return {self.name: self._value}

    def reset(self) -> None:
        self._value = 0.0


class Gauge(Metric):
    """Last-value metric. "Never set" is an explicit flag, not a NaN
    sentinel, so a gauge legitimately set to NaN is still reported."""

    def __init__(self, name: str):
        super().__init__(name)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    observe = set

    @property
    def is_set(self) -> bool:
        return self._value is not None

    @property
    def value(self) -> float:
        return math.nan if self._value is None else self._value

    def snapshot(self) -> Dict[str, float]:
        return {self.name: self.value}

    def reset(self) -> None:
        self._value = None


class Histogram(Metric):
    """Fixed-bucket histogram (Prometheus-style cumulative ``le``
    buckets) that also tracks count, sum, min and max."""

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # +1 = overflow (+inf)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        # total count moves before the bucket count, so a concurrent
        # reader always sees count >= the running bucket sum
        value = float(value)
        self._sum += value
        self._count += 1
        if value < self._min:
            self._min = value
        if value > self._max:
            self._max = value
        self._counts[bisect.bisect_left(self.bounds, value)] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _order_stat(self, k: int) -> float:
        """Bucket estimate of the k-th order statistic (1-indexed), exact
        at the ends and clamped to the observed range."""
        if k <= 1:
            return self._min
        if k >= self._count:
            return self._max
        running = 0
        lo = -math.inf
        bounds = (*self.bounds, math.inf)
        for bound, c in zip(bounds, self._counts):
            if c and running + c >= k:
                b_lo = max(lo, self._min)
                b_hi = min(bound, self._max)
                est = b_lo + (b_hi - b_lo) * ((k - running) / c)
                return min(max(est, self._min), self._max)
            running += c
            lo = bound
        return self._max

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile (``q`` in [0, 100]) in numpy's
        linear-interpolation convention, each order statistic estimated
        from its bucket. NaN on an empty histogram."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        if self._count == 0:
            return math.nan
        pos = 1.0 + (q / 100.0) * (self._count - 1)
        k = int(math.floor(pos))
        frac = pos - k
        x_k = self._order_stat(k)
        if frac <= 0.0 or k >= self._count:
            return x_k
        return x_k + frac * (self._order_stat(k + 1) - x_k)

    def bucket_counts(self) -> Dict[str, int]:
        """Cumulative counts: ``..._bucket_le_B`` is the number of samples
        ``<= B`` and ``le_inf`` equals ``count``."""
        out = {}
        running = 0
        for bound, c in zip(self.bounds, self._counts):
            running += c
            out[f"{self.name}_bucket_le_{bound:g}"] = running
        out[f"{self.name}_bucket_le_inf"] = running + self._counts[-1]
        return out

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {f"{self.name}_count": float(self._count),
                                 f"{self.name}_sum": self._sum}
        out.update({k: float(v) for k, v in self.bucket_counts().items()})
        return out

    def reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf


class MetricsRegistry:
    """Named collection with get-or-create accessors. Re-requesting a
    name returns the existing metric; requesting it as another kind
    raises."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind, factory) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, buckets))

    def names(self) -> Iterable[str]:
        return tuple(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name: value}`` over every metric; never-set gauges are
        skipped."""
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            if isinstance(m, Gauge) and not m.is_set:
                continue
            out.update(m.snapshot())
        return out

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    # -- typed serialization ------------------------------------------------
    def to_dict(self) -> dict:
        """A typed, strict-JSON-safe dict of the whole registry: each
        metric's kind and full state (a flat :meth:`snapshot` cannot be
        merged or rebuilt). Non-finite values are the strings ``"NaN"`` /
        ``"Infinity"`` / ``"-Infinity"``; never-set gauges are skipped."""
        with self._lock:
            metrics = list(self._metrics.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in metrics:
            if isinstance(m, Counter):
                out["counters"][name] = json_safe_float(m.value)
            elif isinstance(m, Gauge):
                if m.is_set:
                    out["gauges"][name] = json_safe_float(m.value)
            elif isinstance(m, Histogram):
                out["histograms"][name] = {
                    "bounds": list(m.bounds),
                    "counts": list(m._counts),
                    "sum": json_safe_float(m._sum),
                    "count": int(m._count),
                    "min": json_safe_float(m._min),
                    "max": json_safe_float(m._max),
                }
        return out

    @classmethod
    def from_dict(cls, doc: dict) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`to_dict` output. Histograms
        restore their bucket counts and the observed min, max and sum, so
        :meth:`Histogram.percentile` answers the same after a round trip."""
        reg = cls()
        for name, value in doc.get("counters", {}).items():
            reg.counter(name).inc(json_float(value))
        for name, value in doc.get("gauges", {}).items():
            reg.gauge(name).set(json_float(value))
        for name, h in doc.get("histograms", {}).items():
            hist = reg.histogram(name, h["bounds"])
            _restore_histogram(hist, h)
        return reg

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format. Characters
        outside ``[a-zA-Z0-9_:]`` in names become underscores
        (``serve/ttft_ms`` -> ``serve_ttft_ms``); histograms emit the
        cumulative ``_bucket{le="..."}`` series ending in ``le="+Inf"``
        plus ``_sum``/``_count``; never-set gauges are skipped; non-finite
        values are spelled ``NaN``/``+Inf``/``-Inf``."""
        with self._lock:
            metrics = list(self._metrics.items())
        lines: List[str] = []
        for name, m in metrics:
            pn = _prometheus_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {_prometheus_value(m.value)}")
            elif isinstance(m, Gauge):
                if not m.is_set:
                    continue
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_prometheus_value(m.value)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} histogram")
                running = 0
                for bound, c in zip(m.bounds, m._counts):
                    running += c
                    lines.append(f'{pn}_bucket{{le="{bound:g}"}} {running}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pn}_sum {_prometheus_value(m.sum)}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def json_safe_float(value: float) -> Any:
    """Strict-JSON spelling of one float: non-finite values become the
    strings ``"NaN"``/``"Infinity"``/``"-Infinity"``, so
    ``json.dump(..., allow_nan=False)`` round-trips."""
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "Infinity" if value > 0 else "-Infinity"
    return value


def json_float(value: Any) -> float:
    """Inverse of :func:`json_safe_float` (``float`` parses the string
    spellings natively)."""
    return float(value)


def _restore_histogram(hist: Histogram, doc: dict) -> None:
    """Overwrite ``hist``'s state from a serialized dict whose ``bounds``
    already match (``from_dict`` creates it that way)."""
    counts = [int(c) for c in doc["counts"]]
    if len(counts) != len(hist.bounds) + 1:
        raise ValueError(
            f"histogram {hist.name!r}: {len(counts)} counts for "
            f"{len(hist.bounds)} bounds (+1 overflow expected)")
    hist._counts = counts
    hist._sum = json_float(doc["sum"])
    hist._count = int(doc["count"])
    hist._min = json_float(doc["min"])
    hist._max = json_float(doc["max"])


_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _prometheus_name(name: str) -> str:
    pn = _PROM_BAD_CHARS.sub("_", name)
    return "_" + pn if pn[:1].isdigit() else pn


def _prometheus_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return f"{value:g}"


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
