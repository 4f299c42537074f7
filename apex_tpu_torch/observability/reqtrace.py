"""Request-lifecycle records for the serving stack.

The port's copy of the record half of ``apex_tpu/observability/reqtrace.py``:
:class:`RequestRecord` holds one request's ``time.perf_counter`` stamps
(submit, admit, first token, last token, retire) and derives the serving
latencies ``queue_wait_ms``/``ttft_ms``/``tpot_ms``/``e2e_ms``. The
per-tick stamps, the ring buffer and the Chrome-trace export come with a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from apex_tpu_torch.observability.registry import log_buckets

__all__ = ["RequestRecord", "LATENCY_BUCKETS_MS"]

# the serving latency grid: 10 us .. 60 s in milliseconds, constant ratio
# r = (6e4/1e-2)**(1/67) ~= 1.26 between bounds
LATENCY_BUCKETS_MS = log_buckets(1e-2, 6e4, 68)


def _ms(t0: Optional[float], t1: Optional[float]) -> Optional[float]:
    if t0 is None or t1 is None:
        return None
    return (t1 - t0) * 1e3


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle; ``None`` marks a transition that has not
    happened yet."""

    request_id: int
    prompt_len: int
    submit_t: float
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    retire_t: Optional[float] = None
    slot: Optional[int] = None
    generated: int = 0
    finish_reason: Optional[str] = None

    @property
    def queue_wait_ms(self) -> Optional[float]:
        """Submit -> admit: time spent waiting for a free slot."""
        return _ms(self.submit_t, self.admit_t)

    @property
    def ttft_ms(self) -> Optional[float]:
        """Submit -> first sampled token, queue wait included."""
        return _ms(self.submit_t, self.first_token_t)

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean time per output token after the first (None for
        single-token requests)."""
        if self.generated < 2:
            return None
        span = _ms(self.first_token_t, self.last_token_t)
        if span is None:
            return None
        return span / (self.generated - 1)

    @property
    def e2e_ms(self) -> Optional[float]:
        """Submit -> retire: the whole request."""
        return _ms(self.submit_t, self.retire_t)
