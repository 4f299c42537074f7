"""Request-lifecycle tracing for the serving stack.

The port's copy of ``apex_tpu/observability/reqtrace.py``:

- :class:`RequestRecord`: one request's ``time.perf_counter`` stamps
  (submit, admit, prefill done, first token, each decode tick, retire),
  its slot, lengths and finish reason, and the derived
  ``queue_wait_ms``/``ttft_ms``/``tpot_ms``/``e2e_ms``;
- :class:`RequestTrace`: a bounded, thread-safe ring of retired records
  (overflow evicts the oldest), the flight recorder the
  :class:`~apex_tpu_torch.observability.slo.SLOTracker` and the poison
  quarantine dump from;
- :func:`chrome_request_trace`: the strict-JSON Chrome-trace export, one
  lane per slot plus a queue lane, a flow event from each request's queue
  wait to its slot, and optional per-tick instants.

The scheduler stamps one ``perf_counter`` per transition whether or not a
trace is attached; the ring, the per-tick lists and the export exist only
with a :class:`RequestTrace`. Tracing never touches the device.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
from typing import Any, Dict, Iterable, List, Optional

from apex_tpu_torch.observability.registry import log_buckets
from apex_tpu_torch.observability.trace import trace_metadata

__all__ = ["RequestRecord", "RequestTrace", "chrome_request_trace",
           "LATENCY_BUCKETS_MS"]

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
    happened yet. ``decode_ts`` is filled only when a
    :class:`RequestTrace` is attached to the scheduler."""

    request_id: int
    prompt_len: int
    submit_t: float
    admit_t: Optional[float] = None
    prefill_done_t: Optional[float] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    retire_t: Optional[float] = None
    slot: Optional[int] = None
    generated: int = 0
    finish_reason: Optional[str] = None
    decode_ts: List[float] = dataclasses.field(default_factory=list)

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

    def to_dict(self) -> Dict[str, Any]:
        """A strict-JSON-safe dict of the raw stamps, the derived
        latencies and the tick list (non-finite floats become None)."""
        out: Dict[str, Any] = {
            "request_id": self.request_id,
            "prompt_len": self.prompt_len,
            "generated": self.generated,
            "slot": self.slot,
            "finish_reason": self.finish_reason,
            "submit_t": self.submit_t,
            "admit_t": self.admit_t,
            "prefill_done_t": self.prefill_done_t,
            "first_token_t": self.first_token_t,
            "last_token_t": self.last_token_t,
            "retire_t": self.retire_t,
            "queue_wait_ms": self.queue_wait_ms,
            "ttft_ms": self.ttft_ms,
            "tpot_ms": self.tpot_ms,
            "e2e_ms": self.e2e_ms,
            "decode_ts": list(self.decode_ts),
        }
        return {k: (None if isinstance(v, float) and not math.isfinite(v)
                    else v) for k, v in out.items()}


class RequestTrace:
    """Bounded thread-safe ring of retired :class:`RequestRecord` s:
    appends past ``capacity`` evict the oldest."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def append(self, record: RequestRecord) -> None:
        with self._lock:
            self._buf.append(record)

    def records(self) -> List[RequestRecord]:
        """The buffer, oldest first (non-destructive)."""
        with self._lock:
            return list(self._buf)

    def last(self, n: int) -> List[RequestRecord]:
        """The newest ``n`` records (all of them when fewer)."""
        with self._lock:
            if n <= 0:
                return []
            return list(self._buf)[-n:]

    def drain(self) -> List[RequestRecord]:
        """Pop and return everything, oldest first; each record comes out
        exactly once under concurrent appends."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def chrome_trace(self, pid: int = 0, ticks: bool = True) -> dict:
        return chrome_request_trace(self.records(), pid=pid, ticks=ticks)

    def write_chrome_trace(self, path, pid: int = 0,
                           ticks: bool = True) -> None:
        """Write the Chrome-trace JSON of the buffered records, strict
        JSON (``allow_nan=False``)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pid=pid, ticks=ticks), f,
                      allow_nan=False)


def _span_args(r: RequestRecord) -> Dict[str, Any]:
    args: Dict[str, Any] = {"request_id": r.request_id,
                            "prompt_len": r.prompt_len,
                            "generated": r.generated}
    if r.finish_reason is not None:
        args["finish_reason"] = r.finish_reason
    for key in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
        v = getattr(r, key)
        if v is not None and math.isfinite(v):
            args[key] = round(v, 3)
    return args


def chrome_request_trace(records: Iterable[RequestRecord], pid: int = 0,
                         ticks: bool = True) -> dict:
    """Chrome-trace (Perfetto-loadable) document for request records.

    ``tid 0`` is the queue lane (one span per request, submit -> admit);
    ``tid slot+1`` is that slot's lane (one span per residency, admit ->
    retire, the latencies in ``args``), with a flow event tying the two;
    ``ticks=True`` adds one instant per decode tick. Timestamps are
    ``perf_counter`` microseconds; ``metadata.epoch_offset_s`` aligns
    processes. The document is strict JSON."""
    records = list(records)
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "apex_tpu serving"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "queue"}},
    ]
    for slot in sorted({r.slot for r in records if r.slot is not None}):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": slot + 1, "args": {"name": f"slot {slot}"}})
    for r in records:
        rid = r.request_id
        if r.admit_t is not None:
            events.append({"name": f"req {rid} queued", "ph": "X",
                           "cat": "serve", "ts": r.submit_t * 1e6,
                           "dur": (r.admit_t - r.submit_t) * 1e6,
                           "pid": pid, "tid": 0,
                           "args": {"request_id": rid}})
        end = r.retire_t if r.retire_t is not None else r.last_token_t
        if r.admit_t is None or end is None or r.slot is None:
            continue  # still queued or mid-flight: no slot span yet
        tid = r.slot + 1
        events.append({"name": f"req {rid}", "ph": "s", "cat": "serve",
                       "id": rid, "ts": r.submit_t * 1e6, "pid": pid,
                       "tid": 0})
        events.append({"name": f"req {rid}", "ph": "f", "bp": "e",
                       "cat": "serve", "id": rid, "ts": r.admit_t * 1e6,
                       "pid": pid, "tid": tid})
        events.append({"name": f"req {rid}", "ph": "X", "cat": "serve",
                       "ts": r.admit_t * 1e6,
                       "dur": (end - r.admit_t) * 1e6, "pid": pid,
                       "tid": tid, "args": _span_args(r)})
        if r.first_token_t is not None:
            events.append({"name": "first_token", "ph": "i", "s": "t",
                           "cat": "serve", "ts": r.first_token_t * 1e6,
                           "pid": pid, "tid": tid,
                           "args": {"request_id": rid}})
        if ticks:
            for t in r.decode_ts:
                events.append({"name": "tick", "ph": "i", "s": "t",
                               "cat": "serve", "ts": t * 1e6, "pid": pid,
                               "tid": tid, "args": {"request_id": rid}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": trace_metadata()}
