"""Typed admission rejections for the serving scheduler.

Counterpart of ``Rejection`` and ``REJECTION_REASONS`` in
``apex_tpu/serving/resilience.py``: what
:meth:`~apex_tpu_torch.serving.scheduler.SlotScheduler.submit` returns,
instead of a request id, for a request it will not enqueue. In this slice
the only reason it returns is ``"pool_exhausted"``: a paged engine whose
block pool could never hold the prompt (transient pressure queues
instead). The rest of the reference module (brownout, the checkpoint
watcher) and the scheduler knobs behind ``queue_full``, ``shed`` and
``draining`` come with the serving host-layer slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Rejection", "REJECTION_REASONS"]

# the closed vocabulary of submit()-time rejections. Bad input (an empty or
# oversized prompt, a duplicate in-flight id) still raises ValueError: a
# malformed request is a caller bug, not a load condition.
REJECTION_REASONS = ("queue_full", "shed", "draining", "pool_exhausted")


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A typed admission refusal: why the request was not enqueued. Check
    with ``isinstance(r, Rejection)``, not truthiness: request id 0 is a
    valid admission. (A Rejection is falsy all the same.)"""

    reason: str
    request_id: Optional[int] = None
    detail: str = ""

    def __post_init__(self):
        if self.reason not in REJECTION_REASONS:
            raise ValueError(f"reason must be one of {REJECTION_REASONS}, "
                             f"got {self.reason!r}")

    def __bool__(self) -> bool:
        return False
