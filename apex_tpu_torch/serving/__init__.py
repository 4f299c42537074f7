"""Serving fast path of the port: KV-cached decode for the GPT model.

A dense :class:`~apex_tpu_torch.serving.cache.KVCache` or a paged block
pool (:class:`~apex_tpu_torch.serving.cache.PagedKVCache` with its host
:class:`~apex_tpu_torch.serving.cache.BlockAllocator`), both written in
place; eager prefill, decode and speculative verify steps
(:class:`~apex_tpu_torch.serving.engine.ServingEngine`,
:class:`~apex_tpu_torch.serving.engine.PagedServingEngine`) whose
attention runs the hand-written CUDA kernels on the card; per-slot
sampling and the speculative acceptance rule
(:mod:`~apex_tpu_torch.serving.sampling`), host-side draft sources and a
continuous slot batcher (:class:`~apex_tpu_torch.serving.scheduler
.SlotScheduler`) emitting the ``serve/*`` metric family, with typed
:class:`~apex_tpu_torch.serving.resilience.Rejection` s, the SLO-driven
:class:`~apex_tpu_torch.serving.resilience.BrownoutPolicy`, deadlines,
cancel, drain, weight swaps (also from a training run's newest committed
checkpoint: :class:`~apex_tpu_torch.serving.resilience.CheckpointWatcher`)
and the quarantine engines' poison check. The
request-trace and SLO types are re-exported for wiring convenience.
"""

from apex_tpu_torch.observability.reqtrace import (RequestRecord,
                                                   RequestTrace,
                                                   chrome_request_trace)
from apex_tpu_torch.observability.slo import (SLOTarget, SLOTracker,
                                              SLOViolationError)
from apex_tpu_torch.serving.cache import (AdmitPlan, BlockAllocator,
                                          KVCache, PagedKVCache,
                                          PoolExhausted, StepPlan,
                                          cache_bytes_per_slot,
                                          paged_block_bytes, store_roundtrip)
from apex_tpu_torch.serving.engine import PagedServingEngine, ServingEngine
from apex_tpu_torch.serving.resilience import (REJECTION_REASONS,
                                               BrownoutPolicy,
                                               CheckpointWatcher, Rejection,
                                               watch_checkpoints)
from apex_tpu_torch.serving.sampling import sample_tokens, verify_tokens
from apex_tpu_torch.serving.scheduler import (Completion, DraftSource,
                                              NGramDraftSource, Request,
                                              SlotScheduler)

__all__ = ["KVCache", "cache_bytes_per_slot", "store_roundtrip",
           "PagedKVCache", "BlockAllocator", "AdmitPlan", "StepPlan",
           "PoolExhausted", "paged_block_bytes", "ServingEngine",
           "PagedServingEngine", "Rejection", "REJECTION_REASONS",
           "sample_tokens", "verify_tokens", "Completion", "Request",
           "SlotScheduler", "DraftSource", "NGramDraftSource",
           "RequestRecord", "RequestTrace", "chrome_request_trace",
           "SLOTarget", "SLOTracker", "SLOViolationError", "BrownoutPolicy",
           "CheckpointWatcher", "watch_checkpoints"]
