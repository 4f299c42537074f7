"""Serving resilience: typed admission rejections and SLO-driven brownout.

Counterpart of ``Rejection``, ``REJECTION_REASONS`` and ``BrownoutPolicy``
in ``apex_tpu/serving/resilience.py``. :class:`Rejection` is what
:meth:`~apex_tpu_torch.serving.scheduler.SlotScheduler.submit` returns,
instead of a request id, for a request it will not enqueue:
``queue_full`` at the ``max_queue`` bound, ``shed`` by a brownout,
``draining`` during a drain, ``pool_exhausted`` for a paged engine whose
pool could never hold the prompt. :class:`BrownoutPolicy` sits between the
SLO tracker and admission: past a burn rate it sheds new requests or caps
their ``max_new_tokens``.

The reference's ``CheckpointWatcher`` and ``watch_checkpoints`` (a live
training run's latest committed checkpoint swapped into the engine) need
the port's checkpoint module and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Rejection", "REJECTION_REASONS", "BrownoutPolicy"]

# the closed vocabulary of submit()-time rejections. Bad input (an empty or
# oversized prompt, a non-positive deadline, a duplicate in-flight id)
# still raises ValueError: a malformed request is a caller bug, not a load
# condition.
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


class BrownoutPolicy:
    """SLO-driven degradation: when the tracker's worst burn rate exceeds
    ``burn_threshold`` (1.0: on track to violate), the scheduler's
    admission sheds the new request (``shed=True``:
    ``Rejection(reason="shed")``, counted as ``serve/shed``) or caps its
    ``max_new_tokens`` at ``cap_max_new_tokens``. Shedding wins when both
    are set. Re-evaluated at each submission from the tracker's window and
    exported by the scheduler as the 0/1 ``serve/brownout`` gauge."""

    def __init__(self, tracker, *, burn_threshold: float = 1.0,
                 shed: bool = True,
                 cap_max_new_tokens: Optional[int] = None):
        if burn_threshold <= 0.0:
            raise ValueError("burn_threshold must be positive, "
                             f"got {burn_threshold!r}")
        if cap_max_new_tokens is not None and cap_max_new_tokens < 1:
            raise ValueError("cap_max_new_tokens must be >= 1, "
                             f"got {cap_max_new_tokens!r}")
        if not shed and cap_max_new_tokens is None:
            raise ValueError("a BrownoutPolicy with shed=False and no "
                             "cap_max_new_tokens would do nothing")
        self.tracker = tracker
        self.burn_threshold = float(burn_threshold)
        self.shed = bool(shed)
        self.cap_max_new_tokens = cap_max_new_tokens

    def engaged(self) -> bool:
        """True when the tracker's worst burn rate exceeds the threshold;
        an empty window (NaN) never engages: a cold server admits."""
        return self.tracker.max_burn_rate() > self.burn_threshold

    def cap(self, max_new_tokens: int) -> int:
        if self.cap_max_new_tokens is None:
            return max_new_tokens
        return min(max_new_tokens, self.cap_max_new_tokens)
