"""Serving fast path of the port: KV-cached decode for the GPT model.

A dense :class:`~apex_tpu_torch.serving.cache.KVCache` written in place,
eager prefill/decode steps (:class:`~apex_tpu_torch.serving.engine
.ServingEngine`) whose attention runs the hand-written CUDA kernels on the
card, per-slot sampling (:mod:`~apex_tpu_torch.serving.sampling`) and a
continuous slot batcher (:class:`~apex_tpu_torch.serving.scheduler
.SlotScheduler`) emitting the ``serve/*`` metric family. The request record
is re-exported for wiring convenience.
"""

from apex_tpu_torch.observability.reqtrace import RequestRecord
from apex_tpu_torch.serving.cache import (KVCache, cache_bytes_per_slot,
                                          store_roundtrip)
from apex_tpu_torch.serving.engine import ServingEngine
from apex_tpu_torch.serving.sampling import sample_tokens
from apex_tpu_torch.serving.scheduler import (Completion, Request,
                                              SlotScheduler)

__all__ = ["KVCache", "cache_bytes_per_slot", "store_roundtrip",
           "ServingEngine", "sample_tokens", "Completion", "Request",
           "SlotScheduler", "RequestRecord"]
