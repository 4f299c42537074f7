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

**Resilience** (the policy objects live in
:mod:`apex_tpu_torch.serving.resilience`): ``max_queue=`` bounds the
queue, so an over-limit :meth:`~SlotScheduler.submit` returns a typed
:class:`~apex_tpu_torch.serving.resilience.Rejection`;
``default_deadline_ms=`` and a request's ``deadline_ms`` expire it while
queued and mid-flight (``"expired"``), and :meth:`~SlotScheduler.cancel`
removes one by id; a quarantine engine's non-finite slot retires alone
(``"poisoned"``, with a
:class:`~apex_tpu_torch.observability.health.CrashDump` flight record);
``brownout=`` sheds or caps admissions at an SLO burn rate over its
threshold; :meth:`~SlotScheduler.drain` and
:meth:`~SlotScheduler.swap_params` roll the weights; ``fault_plan=``
scripts serving chaos (:class:`~apex_tpu_torch.elastic.faults.FaultPlan`);
an engine fault retires every in-flight request ``"error"`` before it
propagates. ``trace=`` (a
:class:`~apex_tpu_torch.observability.reqtrace.RequestTrace`) keeps
retired records with their per-tick stamps, and ``slo=`` (an
:class:`~apex_tpu_torch.observability.slo.SLOTracker`) ingests each
retirement. All of it is host work: with every knob on, a step launches
what a bare scheduler's step launches and copies to the host once.

The reference's ``run(no_recompile=True)`` wraps the loop in an XLA
compile-storm guard. Its counterpart here is a CUDA-graph recapture
guard, which comes with the graph capture of the serving steps (ROADMAP
queue A7b); until then ``run`` has no such keyword.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from apex_tpu_torch.observability.health import CrashDump
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
    always bounds it. ``deadline_ms`` (optional, > 0, from submission)
    expires the request while queued and mid-flight; the scheduler's
    ``default_deadline_ms`` applies when it is None."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_token: Optional[int] = None
    request_id: Optional[int] = None
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A finished request: the generated tokens (prompt excluded), why
    generation stopped (``"eos"`` | ``"length"`` | ``"capacity"`` |
    ``"expired"`` | ``"cancelled"`` | ``"poisoned"`` | ``"error"``), and
    the measured latencies (``tpot_ms`` is None for single-token
    requests). A request retired before admission has no slot-side
    latencies and no tokens."""
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
    deadline_t: Optional[float] = None  # perf_counter seconds, absolute


# retirement reasons with a counter of their own beside serve/retired
_REASON_COUNTERS = {"expired": "serve/expired",
                    "cancelled": "serve/cancelled",
                    "poisoned": "serve/poisoned",
                    "error": "serve/errors"}


class SlotScheduler:
    """Drive with :meth:`submit` + :meth:`step` (one decode step per
    call), or :meth:`run` for a closed batch. ``registry`` defaults to
    the process-wide one.

    ``trace`` (a :class:`~apex_tpu_torch.observability.reqtrace
    .RequestTrace`) keeps retired records for the Chrome-trace export and
    the flight recorder; ``slo`` (an :class:`~apex_tpu_torch.observability
    .slo.SLOTracker`) ingests each retirement. The resilience knobs:
    ``max_queue`` (the admission bound), ``default_deadline_ms`` (the
    deadline of requests that set none), ``brownout`` (a
    :class:`~apex_tpu_torch.serving.resilience.BrownoutPolicy`),
    ``fault_plan`` (a :class:`~apex_tpu_torch.elastic.faults.FaultPlan`;
    a poison plan needs a quarantine engine and is refused otherwise) and
    ``dump_dir`` (where the poison quarantine's CrashDumps land).

    ``speculate_k=k`` (the engine built with the same ``k``) steps the
    engine's ``verify`` instead of ``decode``: ``draft_source`` (default
    :class:`NGramDraftSource`) proposes ``k`` tokens a slot and each slot
    emits 1 to ``k + 1`` tokens a step. A retirement mid-harvest (eos,
    length, capacity, a deadline, quarantine) abandons only tokens whose
    KV sits above the cursor, which advanced by the accepted count
    alone."""

    def __init__(self, engine, registry=None, trace=None, slo=None, *,
                 max_queue: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 brownout=None, fault_plan=None, dump_dir: str = ".",
                 speculate_k: int = 0,
                 draft_source: Optional[DraftSource] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
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
        if default_deadline_ms is not None and default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be positive, "
                             f"got {default_deadline_ms}")
        if (fault_plan is not None
                and getattr(fault_plan, "poison_logits", None)
                and not engine.quarantine):
            raise ValueError(
                "fault_plan schedules poison_logits but the engine has no "
                "quarantine check: the fault would be silently dropped; "
                "build the engine with quarantine=True")
        self.engine = engine
        self._reg = registry if registry is not None else get_registry()
        self.trace = trace
        self.slo = slo
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        self.brownout = brownout
        self.fault_plan = fault_plan
        self.dump_dir = dump_dir
        self.speculate_k = int(speculate_k)
        self.draft_source = draft_source if draft_source is not None \
            else (NGramDraftSource() if speculate_k else None)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.queue: collections.deque = collections.deque()
        self.free: List[int] = list(range(engine.max_seqs))[::-1]
        self.active: Dict[int, _Active] = {}
        self.completed: List[Completion] = []
        self.steps = 0              # decode steps executed (fault keying)
        self.poison_dumps: List[str] = []
        self._tokens = np.zeros(engine.max_seqs, np.int64)
        self._temps = np.zeros(engine.max_seqs, np.float32)
        self._next_id = 0
        self._in_flight_ids = set()
        self._draining = False
        # a scheduler without deadlines skips the per-step queue walk
        self._any_deadlines = default_deadline_ms is not None
        self._tok_count = 0
        self._tok_t0: Optional[float] = None
        # paged engines: the allocator's copy-on-write count at the last
        # step, so serve/blocks_cow_copied emits deltas
        self._cow_seen = 0

    # -- submission ---------------------------------------------------------

    def submit(self, request: Request) -> Union[int, Rejection]:
        """Enqueue ``request`` and return its id, or a falsy
        :class:`~apex_tpu_torch.serving.resilience.Rejection` under
        backpressure (``draining`` during :meth:`drain`, ``queue_full`` at
        ``max_queue``, ``pool_exhausted`` for a paged engine's pool that
        could never hold the prompt, ``shed`` by the brownout). A
        malformed request raises here, never mid-step."""
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
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got "
                f"{request.deadline_ms} (None means no deadline)")
        if (request.request_id is not None
                and request.request_id in self._in_flight_ids):
            raise ValueError(
                f"request_id {request.request_id} is already in flight")
        if self._draining:
            self._reg.counter("serve/rejected").inc()
            return Rejection("draining", request.request_id,
                             "scheduler is draining in-flight requests")
        if (self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            self._reg.counter("serve/rejected").inc()
            return Rejection("queue_full", request.request_id,
                             f"queue at max_queue={self.max_queue}")
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
        if self.brownout is not None:
            engaged = self.brownout.engaged()
            self._reg.gauge("serve/brownout").set(1.0 if engaged else 0.0)
            if engaged:
                if self.brownout.shed:
                    self._reg.counter("serve/shed").inc()
                    return Rejection(
                        "shed", request.request_id,
                        "SLO burn rate over the brownout threshold")
                capped = self.brownout.cap(request.max_new_tokens)
                if capped != request.max_new_tokens:
                    # cap a copy: the caller's request must not carry a
                    # passing brownout's cut into its retries
                    request = dataclasses.replace(
                        request, max_new_tokens=capped)
        if request.request_id is None:
            request.request_id = self._next_id
        self._next_id = max(self._next_id, request.request_id) + 1
        self._in_flight_ids.add(request.request_id)
        if request.deadline_ms is not None:
            self._any_deadlines = True
        record = RequestRecord(request_id=request.request_id,
                               prompt_len=len(request.prompt),
                               submit_t=time.perf_counter())
        self.queue.append((request, record))
        return request.request_id

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.active)

    @property
    def draining(self) -> bool:
        return self._draining

    def _deadline_t(self, request: Request,
                    record: RequestRecord) -> Optional[float]:
        ms = request.deadline_ms if request.deadline_ms is not None \
            else self.default_deadline_ms
        return None if ms is None else record.submit_t + ms / 1e3

    # -- retirement ---------------------------------------------------------

    def _observe(self, record: RequestRecord) -> None:
        if self.trace is not None:
            self.trace.append(record)
        if self.slo is not None:
            self.slo.observe(record)

    def _retire(self, slot: int, reason: str, now: float) -> None:
        st = self.active.pop(slot)
        # the books below (record, slot, completion, id) must be set right
        # whatever the release does: on the "error" path the engine is
        # already known broken and its own fault propagates; on any other
        # path a failed release re-raises after them
        release_exc = None
        try:
            self.engine.release_slot(slot)
        except Exception as exc:
            if reason != "error":
                release_exc = exc
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
        if reason in _REASON_COUNTERS:
            self._reg.counter(_REASON_COUNTERS[reason]).inc()
        for name, value in (("serve/queue_wait_ms", rec.queue_wait_ms),
                            ("serve/ttft_ms", rec.ttft_ms),
                            ("serve/tpot_ms", rec.tpot_ms),
                            ("serve/e2e_ms", rec.e2e_ms)):
            if value is not None:
                self._reg.histogram(name, LATENCY_BUCKETS_MS).observe(value)
        self._observe(rec)
        if release_exc is not None:
            raise release_exc

    def _retire_queued(self, request: Request, record: RequestRecord,
                       reason: str, now: float) -> None:
        """Retire a request that never held a slot (expired or cancelled
        in the queue, or its prefill raised): no tokens, no slot-side
        latencies, not counted as ``serve/retired`` (a freed slot) but
        under its reason's counter, and still seen by the trace and the
        SLO tracker (an expired request must hurt goodput)."""
        record.retire_t = now
        record.finish_reason = reason
        self._in_flight_ids.discard(request.request_id)
        self.completed.append(Completion(
            request.request_id, [], reason, e2e_ms=record.e2e_ms))
        if reason in _REASON_COUNTERS:
            self._reg.counter(_REASON_COUNTERS[reason]).inc()
        self._observe(record)

    def _expire_queued(self, now: float) -> None:
        if not self._any_deadlines:
            return
        kept: collections.deque = collections.deque()
        while self.queue:
            req, rec = self.queue.popleft()
            deadline = self._deadline_t(req, rec)
            if deadline is not None and now >= deadline:
                self._retire_queued(req, rec, "expired", now)
            else:
                kept.append((req, rec))
        self.queue = kept

    def _quarantine(self, slot: int, now: float) -> None:
        """Retire only the poisoned slot (``"poisoned"``, released like
        any retirement) and write a CrashDump flight record
        (``poison_dump_step<N>.json``); every other slot keeps decoding
        untouched."""
        st = self.active[slot]
        rec = st.record
        self._retire(slot, "poisoned", now)
        records = ([r.to_dict() for r in self.trace.last(16)]
                   if self.trace is not None else [rec.to_dict()])
        dump = CrashDump.from_payload(self.steps, dict(self._reg.snapshot()),
                                      requests=records)
        dump.config = {"slot": int(slot),
                       "request_id": int(st.request.request_id),
                       "prompt_len": int(rec.prompt_len),
                       "generated": int(rec.generated),
                       "finish_reason": "poisoned"}
        self.poison_dumps.append(dump.write(self.dump_dir,
                                            prefix="poison_dump"))

    def _abort_in_flight(self) -> None:
        """A prefill or step raised: retire every in-flight request
        ``"error"`` (records stamped, slots released where the engine
        still can, completions visible) before the fault propagates."""
        now = time.perf_counter()
        for slot in list(self.active):
            self._retire(slot, "error", now)

    # -- the loop -----------------------------------------------------------

    def _finish_reason(self, st: _Active, tok: int) -> Optional[str]:
        req = st.request
        if req.eos_token is not None and tok == req.eos_token:
            return "eos"
        if len(st.generated) >= req.max_new_tokens:
            return "length"
        if st.position >= self.engine.max_len:
            return "capacity"
        return None

    def _record(self, tok: int, st: _Active, slot: int, now: float,
                is_tick: bool) -> None:
        st.generated.append(tok)
        st.position += 1
        self._tokens[slot] = tok
        self._tok_count += 1
        st.record.last_token_t = now
        if is_tick and self.trace is not None:
            st.record.decode_ts.append(now)
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
            now = time.perf_counter()
            deadline = self._deadline_t(req, rec)
            if deadline is not None and now >= deadline:
                # expired while waiting: never spend a prefill on it
                self._retire_queued(req, rec, "expired", now)
                continue
            if (hasattr(self.engine, "can_admit")
                    and not self.engine.can_admit(req.prompt)):
                # block-pool pressure: in-flight sequences hold the blocks;
                # wait at the head for retirements to free them
                self.queue.appendleft((req, rec))
                break
            slot = self.free.pop()
            rec.admit_t = now
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
            except Exception:
                # the popped request must not vanish: retire it "error"
                # (the slot never held a cursor) and let the fault through
                self.free.append(slot)
                self._retire_queued(req, rec, "error", now)
                raise
            # prefill() syncs on the sampled token: this stamp is the
            # honest first-token time (the prefill samples it)
            rec.prefill_done_t = rec.first_token_t = time.perf_counter()
            st = _Active(req, [], len(req.prompt), rec, deadline_t=deadline)
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
            self._record(first, st, slot, rec.first_token_t, is_tick=False)
        return admitted

    def step(self) -> int:
        """Expire what is overdue, admit whatever fits (not while
        draining), then run ONE decode (or verify) step for the whole slot
        grid (skipped when nothing is active). Returns the number of
        tokens generated, prefill first tokens included. An engine fault
        retires every in-flight request ``"error"`` before it
        propagates."""
        if self._tok_t0 is None:
            self._tok_t0 = time.perf_counter()
        before = self._tok_count
        self._expire_queued(time.perf_counter())
        try:
            if not self._draining:
                self._admit()
            if self.active:
                # a slot at capacity retires before the step: its append
                # would be dropped, so one more step would decode against
                # a hole
                now = time.perf_counter()
                for slot in list(self.active):
                    if self.active[slot].position >= self.engine.max_len:
                        self._retire(slot, "capacity", now)
            if self.active:
                self._decode_step()
        except Exception:
            self._abort_in_flight()
            raise
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

    def _decode_step(self) -> None:
        """One decode or verify step over the active slots and its
        harvest: the fault plan's hooks first, then the quarantine (a
        non-finite slot retires alone, its token discarded), the paged
        pool's failed slots, and mid-flight deadlines."""
        step_idx = self.steps + 1  # this step, 1-based
        poison = None
        if self.fault_plan is not None:
            self.fault_plan.before_decode(step_idx)
            pslot = self.fault_plan.poison_slot(step_idx)
            if pslot is not None:
                poison = np.zeros(self.engine.max_seqs, np.float32)
                poison[pslot] = np.nan
        mask = np.zeros(self.engine.max_seqs, np.bool_)
        mask[list(self.active)] = True
        counts = None
        if self.speculate_k:
            nxt, counts = self.engine.verify(
                self._tokens, self._build_drafts(), self._temps, mask,
                poison=poison)
        else:
            nxt = self.engine.decode(self._tokens, self._temps, mask,
                                     poison=poison)
        self.steps = step_idx
        self._reg.counter("serve/decode_steps").inc()
        finite = self.engine.last_finite if self.engine.quarantine else None
        # one stamp for the whole grid's tick (the step synced on its
        # fetched tokens)
        now = time.perf_counter()
        if counts is not None:
            self._reg.counter("serve/spec_steps").inc()
            drafted = int(mask.sum()) * self.speculate_k
            self._spec_drafted += drafted
            self._reg.counter("serve/spec_drafted").inc(drafted)
        accepted = 0
        # a snapshot: _record may retire and free slots mid-harvest
        for slot in list(self.active):
            if finite is not None and not finite[slot]:
                self._quarantine(slot, now)
                continue
            if counts is None:
                self._record(int(nxt[slot]), self.active[slot], slot, now,
                             is_tick=True)
                continue
            # the accepted prefix plus one correction or bonus token
            accepted += max(0, int(counts[slot]) - 1)
            st = self.active[slot]
            for j in range(int(counts[slot])):
                self._record(int(nxt[slot, j]), st, slot, now, is_tick=True)
                if slot not in self.active:
                    break
        if counts is not None:
            self._spec_accepted += accepted
            if accepted:
                self._reg.counter("serve/spec_accepted").inc(accepted)
            if self._spec_drafted:
                self._reg.gauge("serve/spec_accept_rate").set(
                    self._spec_accepted / self._spec_drafted)
        # paged engines: a slot the exhausted pool could not give a block
        # retires "capacity". Its token is valid (the current token is
        # merged in flight) but its KV was dropped, so one more step would
        # decode against a hole. A failed verify window aimed at the null
        # block and its count came back 0: it emitted nothing this step
        for slot in getattr(self.engine, "last_failed", ()):
            if slot in self.active:
                self._retire(slot, "capacity", now)
        # mid-flight deadlines: overdue survivors of the harvest retire now
        for slot in list(self.active):
            st = self.active[slot]
            if st.deadline_t is not None and now >= st.deadline_t:
                self._retire(slot, "expired", now)

    # -- resilience surface -------------------------------------------------

    def cancel(self, request_id: int) -> bool:
        """Cancel one request by id, queued (it never admits) or
        mid-flight (retired now, ``"cancelled"``, slot released). False
        for an unknown or finished id: a second cancel is a no-op."""
        now = time.perf_counter()
        for i, (req, rec) in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                self._retire_queued(req, rec, "cancelled", now)
                return True
        for slot, st in list(self.active.items()):
            if st.request.request_id == request_id:
                self._retire(slot, "cancelled", now)
                return True
        return False

    def drain(self, deadline_s: Optional[float] = None
              ) -> Dict[int, Completion]:
        """Stop admitting (a :meth:`submit` meanwhile gets
        ``Rejection(reason="draining")``), step until every in-flight
        request finishes, and return this drain's completions. Queued
        requests stay queued, to be served after a weight swap.
        ``deadline_s`` bounds the wait: the leftovers retire
        ``"expired"`` (a server-side failure, against goodput). Admission
        resumes on return; ``serve/drains`` counts calls."""
        self._draining = True
        t0 = time.perf_counter()
        n0 = len(self.completed)
        try:
            while self.active:
                if (deadline_s is not None
                        and time.perf_counter() - t0 >= deadline_s):
                    now = time.perf_counter()
                    for slot in list(self.active):
                        self._retire(slot, "expired", now)
                    break
                self.step()
        finally:
            self._draining = False
        self._reg.counter("serve/drains").inc()
        return {c.request_id: c for c in self.completed[n0:]}

    def swap_params(self, new_params) -> None:
        """Hot weight swap through the engine's ``swap_params``, counted
        as ``serve/swaps``. In-flight requests keep their old-weight KV
        prefix and finish under the new weights; :meth:`drain` first for
        a clean boundary."""
        self.engine.swap_params(new_params)
        self._reg.counter("serve/swaps").inc()

    def drain_completed(self) -> List[Completion]:
        """Pop and return the completion buffer (a long-lived server
        driving :meth:`step` must collect it)."""
        out, self.completed = self.completed, []
        return out

    def run(self, requests: Sequence[Request],
            max_steps: Optional[int] = None) -> Dict[int, Completion]:
        """Submit ``requests``, loop :meth:`step` until all complete (or
        ``max_steps``), and return ``{request_id: Completion}`` for the
        completions of this run.

        A closed batch knows the rest of its work, so the queue bound
        paces it: a request that would meet ``queue_full`` waits on the
        host and is submitted as the queue drains, without counting as a
        rejection. ``shed``, ``draining`` and ``pool_exhausted`` are
        final: the request is dropped, as for a live caller."""
        n0 = len(self.completed)
        waiting = collections.deque(requests)

        def feed():
            while waiting:
                if (self.max_queue is not None
                        and len(self.queue) >= self.max_queue):
                    return  # a paced retry is not a refused submission
                res = self.submit(waiting[0])
                if isinstance(res, Rejection) \
                        and res.reason == "queue_full":
                    return
                waiting.popleft()  # admitted, or finally rejected

        feed()
        steps = 0
        while self.pending or waiting:
            self.step()
            feed()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {c.request_id: c for c in self.completed[n0:]}
