"""Observability for the port: the metrics registry with its strict-JSON
and Prometheus exports, the request-lifecycle records and their
flight-recorder ring and Chrome-trace export, the serving SLO tracker
(goodput, burn rate, violation dumps), the structured crash dump, and the
in-step metrics (:mod:`~apex_tpu_torch.observability.ingraph`: ``record``
in instrumented code, ``reap``/``collecting`` around a step). The sinks,
reporters, runtime listeners, health checks, fleet and perfwatch of
``apex_tpu.observability`` are not ported yet."""

from apex_tpu_torch.observability import (health, ingraph,  # noqa: F401
                                          registry, reqtrace, slo)
from apex_tpu_torch.observability.health import (CrashDump,
                                                 decode_attribution)
from apex_tpu_torch.observability.ingraph import (Metrics, aggregate,
                                                  collecting, reap, record,
                                                  recording)
from apex_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                                   MetricsRegistry,
                                                   get_registry, log_buckets)
from apex_tpu_torch.observability.reqtrace import (LATENCY_BUCKETS_MS,
                                                   RequestRecord,
                                                   RequestTrace,
                                                   chrome_request_trace)
from apex_tpu_torch.observability.slo import (SLOTarget, SLOTracker,
                                              SLOViolationError)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "log_buckets", "CrashDump", "decode_attribution",
           "LATENCY_BUCKETS_MS", "RequestRecord", "RequestTrace",
           "chrome_request_trace", "SLOTarget", "SLOTracker",
           "SLOViolationError", "Metrics", "aggregate", "collecting",
           "reap", "record", "recording",
           "health", "ingraph", "registry", "reqtrace", "slo"]
