"""Observability for the port: structured training and serving telemetry.

Counterpart of ``apex_tpu/observability``. Each module is free when
unused:

- :mod:`~apex_tpu_torch.observability.registry`: host-side counters,
  gauges and fixed-bucket histograms, strict-JSON and Prometheus exports;
- :mod:`~apex_tpu_torch.observability.ingraph`: in-step metrics
  (``record`` in instrumented code, ``reap``/``collecting`` around a step,
  ``aggregate`` across ranks), 0-d tensors read once a report;
- :mod:`~apex_tpu_torch.observability.report`, ``sinks`` and ``trace``:
  the :class:`StepReporter` snapshotting registry, ``Timers`` and in-step
  metrics each step into JSONL, TensorBoard-protocol and Chrome-trace
  sinks, with timer spans;
- :mod:`~apex_tpu_torch.observability.runtime`: compile counters
  (``torch/*``: Dynamo compilations and kernel-library builds) and the
  allocator's memory gauges;
- :mod:`~apex_tpu_torch.observability.health`: the numerics watchdog
  (per-leaf ``health/*`` attribution, replica agreement, the
  :class:`HealthConfig` policy and its :class:`HealthMonitor` hook, the
  :class:`CrashDump`);
- :mod:`~apex_tpu_torch.observability.costs`: the H100's peak rates, MFU,
  and a step's FLOP and memory budgets;
- :mod:`~apex_tpu_torch.observability.reqtrace` and ``slo``: the serving
  request records, their flight recorder and Chrome export, and the
  :class:`SLOTracker`;
- :mod:`~apex_tpu_torch.observability.perfwatch`: the bench history, the
  regression detector, attribution diffs and model drift
  (``python -m apex_tpu_torch.perfwatch``);
- :mod:`~apex_tpu_torch.observability.fleet`: rank snapshots, their
  merge, gang postmortems and the ``/metrics`` server.

The library's hot paths record ``amp/*``, ``ddp/*``, ``pipeline/*``,
``optim/*``, ``tp/*`` and ``health/*``; with no collector open every
instrumentation point returns before it computes anything.
"""

from apex_tpu_torch.observability import (costs, fleet,  # noqa: F401
                                          health, ingraph, perfwatch,
                                          registry, report, reqtrace,
                                          runtime, sinks, slo, trace)
from apex_tpu_torch.observability.costs import (flops_budget, memory_budget,
                                                mfu, peak_flops)
from apex_tpu_torch.observability.fleet import (FleetAggregator,
                                                FleetPublisher,
                                                MetricsServer,
                                                PostmortemReport,
                                                merge_registry_dicts)
from apex_tpu_torch.observability.health import (CrashDump, HealthConfig,
                                                 HealthMonitor,
                                                 NonFiniteError, TreeStats,
                                                 check_replica_agreement,
                                                 decode_attribution,
                                                 tensor_stats)
from apex_tpu_torch.observability.ingraph import (Metrics, aggregate,
                                                  collecting, reap, record,
                                                  recording)
from apex_tpu_torch.observability.perfwatch import (AttributionDiff,
                                                    BenchHistory, DriftShift,
                                                    Regression,
                                                    RegressionDetector,
                                                    detect_drift_shifts,
                                                    drift_series,
                                                    publish_drift,
                                                    unit_direction)
from apex_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                                   MetricsRegistry,
                                                   get_registry, log_buckets)
from apex_tpu_torch.observability.report import (NullReporter, StepReporter,
                                                 attach_reporter,
                                                 detach_reporter,
                                                 get_reporter)
from apex_tpu_torch.observability.reqtrace import (LATENCY_BUCKETS_MS,
                                                   RequestRecord,
                                                   RequestTrace,
                                                   chrome_request_trace)
from apex_tpu_torch.observability.runtime import (install_compile_listeners,
                                                  reset_compile_listeners,
                                                  sample_memory_stats,
                                                  uninstall_compile_listeners)
from apex_tpu_torch.observability.sinks import (ChromeTraceSink, JSONLSink,
                                                TensorBoardSink)
from apex_tpu_torch.observability.slo import (SLOTarget, SLOTracker,
                                              SLOViolationError)
from apex_tpu_torch.observability.trace import (Span, chrome_trace_events,
                                                drain_spans, epoch_offset,
                                                merge_chrome_traces,
                                                span_recording,
                                                spans_enabled)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "log_buckets", "Metrics", "aggregate",
           "collecting", "reap", "record", "recording", "Span",
           "chrome_trace_events", "drain_spans", "epoch_offset",
           "merge_chrome_traces", "span_recording", "spans_enabled",
           "ChromeTraceSink", "JSONLSink", "TensorBoardSink",
           "NullReporter", "StepReporter", "attach_reporter",
           "detach_reporter", "get_reporter", "install_compile_listeners",
           "reset_compile_listeners", "sample_memory_stats",
           "uninstall_compile_listeners", "CrashDump", "HealthConfig",
           "HealthMonitor", "NonFiniteError", "TreeStats",
           "check_replica_agreement", "decode_attribution", "tensor_stats",
           "flops_budget", "memory_budget", "mfu", "peak_flops",
           "LATENCY_BUCKETS_MS", "RequestRecord", "RequestTrace",
           "chrome_request_trace", "SLOTarget", "SLOTracker",
           "SLOViolationError", "FleetAggregator", "FleetPublisher",
           "MetricsServer", "PostmortemReport", "merge_registry_dicts",
           "AttributionDiff", "BenchHistory", "DriftShift", "Regression",
           "RegressionDetector", "detect_drift_shifts", "drift_series",
           "publish_drift", "unit_direction",
           "costs", "fleet", "health", "ingraph", "perfwatch", "registry",
           "report", "reqtrace", "runtime", "sinks", "slo", "trace"]
