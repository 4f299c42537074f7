"""Host-side observability for the port: the metrics registry and the
request-lifecycle record the serving scheduler stamps."""

from apex_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                                   MetricsRegistry,
                                                   get_registry, log_buckets)
from apex_tpu_torch.observability.reqtrace import (LATENCY_BUCKETS_MS,
                                                   RequestRecord)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "log_buckets", "LATENCY_BUCKETS_MS",
           "RequestRecord"]
