"""Continuous slot batching: admit into freed slots, retire mid-flight.

Counterpart of ``SlotScheduler`` in ``apex_tpu/serving/scheduler.py``. The
decode step always steps all ``max_seqs`` slots; between steps the host
admits queued requests into whatever slots just freed and retires whatever
finished (eos, length, or cache capacity), so a sequence holds a slot for
exactly its own lifetime.

Every request carries a
:class:`~apex_tpu_torch.observability.reqtrace.RequestRecord` stamped with
one ``time.perf_counter()`` per transition, so completions report measured
``queue_wait_ms``/``ttft_ms``/``tpot_ms``/``e2e_ms``, and each step emits
the ``serve/*`` counters, gauges and latency histograms into a
:class:`~apex_tpu_torch.observability.registry.MetricsRegistry`.

With a paged engine (one with an ``allocator``) admission follows the
block pool: :meth:`SlotScheduler.submit` returns a typed
:class:`~apex_tpu_torch.serving.resilience.Rejection` for a prompt that
could never fit the pool, a request the pool cannot take yet waits at the
head of the queue, prefix hits are counted, a slot the pool could not give
a block retires ``"capacity"``, and each step sets the pool gauges. The
dense engine's behaviour is unchanged.

**Speculative decoding**: ``speculate_k=k`` (with an engine built
``speculate_k=k``) drives the engine's ``verify`` step instead of
``decode``: a host-side :class:`DraftSource` (default
:class:`NGramDraftSource`, prompt-lookup self-drafting) proposes ``k``
tokens a slot, one step scores them all, and each slot emits its accepted
prefix plus one correction or bonus token. The ``serve/spec_*`` metrics
track the acceptance rate.

The other resilience knobs (bounded queue, deadlines, cancel, quarantine,
drain, brownout, fault plans) come with later slices.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from apex_tpu_torch.observability.registry import get_registry
from apex_tpu_torch.observability.reqtrace import (LATENCY_BUCKETS_MS,
                                                   RequestRecord)
from apex_tpu_torch.serving.cache import PoolExhausted
from apex_tpu_torch.serving.resilience import Rejection

__all__ = ["Request", "Completion", "SlotScheduler", "DraftSource",
           "NGramDraftSource"]


class DraftSource:
    """What a speculative draft proposer implements: given a slot's whole
    token context (prompt and everything generated so far, never empty),
    propose the next ``k`` tokens. Runs on the host between steps. A wrong
    draft costs its slot the rejected rows' compute, never correctness."""

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        """Exactly ``k`` proposed tokens to follow ``context``."""
        raise NotImplementedError


class NGramDraftSource(DraftSource):
    """Prompt-lookup (n-gram) self-drafting: find the longest suffix of the
    context, up to ``max_ngram`` tokens, that also occurred earlier in it,
    and propose the ``k`` tokens that followed its most recent earlier
    occurrence, padded by repeating the last proposal where the match sits
    near the end. No match proposes the last context token ``k`` times."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = int(max_ngram)

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        ctx = [int(t) for t in context]
        n = len(ctx)
        for m in range(min(self.max_ngram, n - 1), 0, -1):
            suffix = ctx[n - m:]
            for start in range(n - m - 1, -1, -1):
                if ctx[start:start + m] == suffix:
                    out = ctx[start + m:start + m + k]
                    while len(out) < k:
                        out.append(out[-1])
                    return out
        return [ctx[-1]] * k


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature`` <= 0 is greedy;
    ``eos_token`` (optional) stops generation early; ``max_new_tokens``
    always bounds it."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_token: Optional[int] = None
    request_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    """A finished request: the generated tokens (prompt excluded), why
    generation stopped (``"eos"`` | ``"length"`` | ``"capacity"``), and
    the measured latencies (``tpot_ms`` is None for single-token
    requests)."""
    request_id: int
    tokens: List[int]
    finish_reason: str
    queue_wait_ms: Optional[float] = None
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    e2e_ms: Optional[float] = None


@dataclasses.dataclass
class _Active:
    request: Request
    generated: List[int]
    position: int            # prompt_len + len(generated), vs cache capacity
    record: RequestRecord


class SlotScheduler:
    """Drive with :meth:`submit` + :meth:`step` (one decode step per
    call), or :meth:`run` for a closed batch. ``registry`` defaults to
    the process-wide one.

    ``speculate_k=k`` (the engine built with the same ``k``) steps the
    engine's ``verify`` instead of ``decode``: ``draft_source`` (default
    :class:`NGramDraftSource`) proposes ``k`` tokens a slot and each slot
    emits 1 to ``k + 1`` tokens a step. A retirement mid-harvest (eos,
    length, capacity) abandons only tokens whose KV sits above the cursor,
    which advanced by the accepted count alone."""

    def __init__(self, engine, registry=None, *, speculate_k: int = 0,
                 draft_source: Optional[DraftSource] = None):
        if speculate_k:
            if getattr(engine, "speculate_k", 0) != speculate_k:
                raise ValueError(
                    f"speculate_k={speculate_k} but the engine was built "
                    f"with speculate_k={getattr(engine, 'speculate_k', 0)}: "
                    "the scheduler and the engine must agree on the verify "
                    "window")
        elif draft_source is not None:
            raise ValueError(
                "draft_source without speculate_k: pass speculate_k=k "
                "(matching the engine's) to enable speculative decoding")
        self.speculate_k = int(speculate_k)
        self.draft_source = draft_source if draft_source is not None \
            else (NGramDraftSource() if speculate_k else None)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.engine = engine
        self._reg = registry if registry is not None else get_registry()
        self.queue: collections.deque = collections.deque()
        self.free: List[int] = list(range(engine.max_seqs))[::-1]
        self.active: Dict[int, _Active] = {}
        self.completed: List[Completion] = []
        self.steps = 0              # decode steps executed
        self._tokens = np.zeros(engine.max_seqs, np.int64)
        self._temps = np.zeros(engine.max_seqs, np.float32)
        self._next_id = 0
        self._in_flight_ids = set()
        self._tok_count = 0
        self._tok_t0: Optional[float] = None
        self._cow_seen = 0

    # -- submission ---------------------------------------------------------

    def submit(self, request: Request):
        """Enqueue ``request`` and return its id, or a
        :class:`~apex_tpu_torch.serving.resilience.Rejection` when a paged
        engine's pool could never hold its prompt. A malformed request
        raises here, never mid-step."""
        if len(request.prompt) == 0:
            raise ValueError("empty prompt")
        if len(request.prompt) > self.engine.prefill_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds the "
                f"engine's prefill window {self.engine.prefill_len}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens} (the prefill always samples "
                "one token)")
        if (request.request_id is not None
                and request.request_id in self._in_flight_ids):
            raise ValueError(
                f"request_id {request.request_id} is already in flight")
        alloc = getattr(self.engine, "allocator", None)
        if alloc is not None:
            # a prompt that could never fit the whole pool is refused here
            # (queued, it would block the head forever); blocks held by
            # in-flight sequences only make it wait in the queue
            need = alloc.blocks_for(len(request.prompt))
            if need > alloc.num_blocks - 1:
                self._reg.counter("serve/rejected").inc()
                return Rejection(
                    "pool_exhausted", request.request_id,
                    f"prompt needs {need} blocks but the pool only has "
                    f"{alloc.num_blocks - 1} allocatable")
        if request.request_id is None:
            request.request_id = self._next_id
        self._next_id = max(self._next_id, request.request_id) + 1
        self._in_flight_ids.add(request.request_id)
        record = RequestRecord(request_id=request.request_id,
                               prompt_len=len(request.prompt),
                               submit_t=time.perf_counter())
        self.queue.append((request, record))
        return request.request_id

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.active)

    # -- the loop -----------------------------------------------------------

    def _retire(self, slot: int, reason: str, now: float) -> None:
        st = self.active.pop(slot)
        self.engine.release_slot(slot)
        self.free.append(slot)
        self._in_flight_ids.discard(st.request.request_id)
        rec = st.record
        rec.retire_t = now
        rec.finish_reason = reason
        rec.generated = len(st.generated)
        self.completed.append(Completion(
            st.request.request_id, st.generated, reason,
            queue_wait_ms=rec.queue_wait_ms, ttft_ms=rec.ttft_ms,
            tpot_ms=rec.tpot_ms, e2e_ms=rec.e2e_ms))
        self._reg.counter("serve/retired").inc()
        for name, value in (("serve/queue_wait_ms", rec.queue_wait_ms),
                            ("serve/ttft_ms", rec.ttft_ms),
                            ("serve/tpot_ms", rec.tpot_ms),
                            ("serve/e2e_ms", rec.e2e_ms)):
            if value is not None:
                self._reg.histogram(name, LATENCY_BUCKETS_MS).observe(value)

    def _finish_reason(self, st: _Active, tok: int) -> Optional[str]:
        req = st.request
        if req.eos_token is not None and tok == req.eos_token:
            return "eos"
        if len(st.generated) >= req.max_new_tokens:
            return "length"
        if st.position >= self.engine.max_len:
            return "capacity"
        return None

    def _record(self, tok: int, st: _Active, slot: int, now: float) -> None:
        st.generated.append(tok)
        st.position += 1
        self._tokens[slot] = tok
        self._tok_count += 1
        st.record.last_token_t = now
        reason = self._finish_reason(st, tok)
        if reason is not None:
            self._retire(slot, reason, now)

    def _build_drafts(self) -> np.ndarray:
        """The host drafting pass: one :meth:`DraftSource.draft` call per
        active slot over its whole context. Free slots draft zeros (their
        counts come back 0)."""
        drafts = np.zeros((self.engine.max_seqs, self.speculate_k),
                          np.int64)
        for slot, st in self.active.items():
            ctx = list(st.request.prompt) + st.generated
            drafts[slot] = self.draft_source.draft(ctx, self.speculate_k)
        return drafts

    def _admit(self) -> int:
        admitted = 0
        while self.queue and self.free:
            req, rec = self.queue.popleft()
            if (hasattr(self.engine, "can_admit")
                    and not self.engine.can_admit(req.prompt)):
                # block-pool pressure: in-flight sequences hold the blocks;
                # wait at the head for retirements to free them
                self.queue.appendleft((req, rec))
                break
            slot = self.free.pop()
            rec.admit_t = time.perf_counter()
            rec.slot = slot
            try:
                first = self.engine.prefill(req.prompt, slot,
                                            req.temperature)
            except PoolExhausted:
                # can_admit is conservative, but the shared path's COW
                # block can still miss under pressure: requeue (the
                # allocator rolled its partial allocation back)
                self.free.append(slot)
                self.queue.appendleft((req, rec))
                break
            # prefill() syncs on the sampled token: this stamp is the
            # honest first-token time
            rec.first_token_t = time.perf_counter()
            st = _Active(req, [], len(req.prompt), rec)
            self.active[slot] = st
            self._temps[slot] = req.temperature
            self._reg.counter("serve/admitted").inc()
            self._reg.counter("serve/prefill_tokens").inc(len(req.prompt))
            plan = getattr(self.engine, "last_admit", None)
            if plan is not None and not plan.prefill:
                # a prefix-shared admission: the shared span skipped its
                # prefill; serve/ttft_prefix_ms is the admission's time
                self._reg.counter("serve/prefix_hits").inc()
                self._reg.counter("serve/prefix_hit_tokens").inc(
                    plan.shared_tokens)
                self._reg.histogram("serve/ttft_prefix_ms",
                                    LATENCY_BUCKETS_MS).observe(
                    (rec.first_token_t - rec.admit_t) * 1e3)
            admitted += 1
            # the prefill sampled the first token: the request may even
            # complete here (max_new_tokens == 1)
            self._record(first, st, slot, rec.first_token_t)
        return admitted

    def step(self) -> int:
        """Admit whatever fits, then run ONE decode step for the whole
        slot grid (skipped when nothing is active). Returns the number of
        tokens generated, prefill first tokens included."""
        if self._tok_t0 is None:
            self._tok_t0 = time.perf_counter()
        before = self._tok_count
        self._admit()
        if self.active:
            # a slot at capacity retires before the step: its append would
            # be dropped, so one more step would decode against a hole
            now = time.perf_counter()
            for slot in list(self.active):
                if self.active[slot].position >= self.engine.max_len:
                    self._retire(slot, "capacity", now)
        if self.active:
            mask = np.zeros(self.engine.max_seqs, np.bool_)
            mask[list(self.active)] = True
            if self.speculate_k:
                nxt, counts = self.engine.verify(
                    self._tokens, self._build_drafts(), self._temps, mask)
            else:
                nxt = self.engine.decode(self._tokens, self._temps, mask)
            self.steps += 1
            self._reg.counter("serve/decode_steps").inc()
            # one stamp for the whole grid's tick (decode() and verify()
            # synced on the fetched tokens)
            now = time.perf_counter()
            if not self.speculate_k:
                for slot in list(self.active):
                    self._record(int(nxt[slot]), self.active[slot], slot,
                                 now)
            else:
                self._harvest(nxt, counts, int(mask.sum()), now)
            # paged engines: a slot the exhausted pool could not give a
            # block retires "capacity". Its token is valid (the current
            # token is merged in flight) but its KV was dropped, so one
            # more step would decode against a hole. A failed verify
            # window aimed at the null block and its count came back 0: it
            # emitted nothing this step
            for slot in getattr(self.engine, "last_failed", ()):
                if slot in self.active:
                    self._retire(slot, "capacity", now)
        generated = self._tok_count - before
        self._reg.counter("serve/generated_tokens").inc(generated)
        self._reg.gauge("serve/queue_depth").set(len(self.queue))
        self._reg.gauge("serve/active_slots").set(len(self.active))
        alloc = getattr(self.engine, "allocator", None)
        if alloc is not None:
            # used and utilization beside free: free alone cannot tell
            # fragmentation from load (block 0 is the null block)
            capacity = alloc.num_blocks - 1
            used = capacity - alloc.free_blocks
            self._reg.gauge("serve/pool_blocks_free").set(alloc.free_blocks)
            self._reg.gauge("serve/pool_blocks_used").set(used)
            self._reg.gauge("serve/pool_utilization").set(
                used / capacity if capacity else 0.0)
            if alloc.cow_copies > self._cow_seen:
                self._reg.counter("serve/blocks_cow_copied").inc(
                    alloc.cow_copies - self._cow_seen)
                self._cow_seen = alloc.cow_copies
        elapsed = time.perf_counter() - self._tok_t0
        if elapsed > 0:
            self._reg.gauge("serve/tokens_per_sec").set(
                self._tok_count / elapsed)
        return generated

    def _harvest(self, nxt: np.ndarray, counts: np.ndarray, n_active: int,
                 now: float) -> None:
        """A verify step's tokens: each slot its accepted prefix plus one
        correction or bonus token, ``nxt[slot, :counts[slot]]``, until a
        retirement stops it; then the ``serve/spec_*`` metrics."""
        self._reg.counter("serve/spec_steps").inc()
        drafted = n_active * self.speculate_k
        self._spec_drafted += drafted
        self._reg.counter("serve/spec_drafted").inc(drafted)
        accepted = 0
        # a snapshot: _record may retire and free slots mid-harvest
        for slot in list(self.active):
            st = self.active[slot]
            accepted += max(0, int(counts[slot]) - 1)
            for j in range(int(counts[slot])):
                self._record(int(nxt[slot, j]), st, slot, now)
                if slot not in self.active:
                    break
        self._spec_accepted += accepted
        if accepted:
            self._reg.counter("serve/spec_accepted").inc(accepted)
        if self._spec_drafted:
            self._reg.gauge("serve/spec_accept_rate").set(
                self._spec_accepted / self._spec_drafted)

    def run(self, requests: Sequence[Request],
            max_steps: Optional[int] = None) -> Dict[int, Completion]:
        """Submit ``requests``, loop :meth:`step` until all complete (or
        ``max_steps``), and return ``{request_id: Completion}`` for the
        completions of this run."""
        n0 = len(self.completed)
        for req in requests:
            self.submit(req)
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {c.request_id: c for c in self.completed[n0:]}
