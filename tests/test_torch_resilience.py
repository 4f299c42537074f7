"""The port's serving resilience layer against the JAX package's, on the CPU.

Modules held here: ``BrownoutPolicy``, ``FaultPlan`` (the serving hooks and
the JSON document), the engines' quarantine (``poison``, ``last_finite``)
and capacity (``overhead_bytes``, ``suggest_max_seqs``), and the
scheduler's knobs: the queue bound and ``run``'s paced feed, deadlines,
cancel, drain, ``swap_params``, brownout, exception safety and the
flood + poison + slow chaos run, dense and paged.

Timing decides deadlines, expiry and every latency, so both schedulers
read one fake clock: an object with ``perf_counter()`` and ``sleep(s)``
that moves only when an engine's ``prefill``, ``decode`` or ``verify`` is
called (by fixed ticks) or on ``sleep``. It replaces the ``time`` module
of both scheduler modules and both fault modules, from this file; it is
reset before each side's run. Completions (ids, tokens, finish reasons),
every ``serve/*`` and ``slo/*`` counter and gauge, and the trace records
must then agree: integers and tokens exactly, latencies and stamps at
1e-9 ms. All streams are greedy at fp32 on one tiny GPT (2 layers, hidden
64, 4 heads, vocab 128, ``max_len`` 64, ``prefill_len`` 16) whose weights
come from the JAX model's ``init`` through ``_bridge.params_from_jax``.

The JAX engines compile their programs ahead of time, so the module builds
each of its four at most once: plain, quarantine, paged quarantine and
speculative quarantine.

The reference asserts "zero cost when off" as byte-identical XLA programs.
The port runs eagerly, so here it is counted: the aten calls of one
``step()`` (a ``TorchDispatchMode``) and the tensor reads to the host, for
a bare scheduler and for one with every host knob attached, on decode and
verify steps of both engines.
"""

import collections
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import apex_tpu.elastic.faults as jax_faults_mod
import apex_tpu.serving.scheduler as jax_sched_mod
from apex_tpu.elastic.faults import FaultPlan as JaxFaultPlan
from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.observability.registry import MetricsRegistry as JaxRegistry
from apex_tpu.observability.reqtrace import RequestRecord as JaxRecord
from apex_tpu.observability.reqtrace import RequestTrace as JaxTrace
from apex_tpu.observability.slo import SLOTarget as JaxTarget
from apex_tpu.observability.slo import SLOTracker as JaxTracker
from apex_tpu.serving import BlockAllocator as JaxAllocator
from apex_tpu.serving import BrownoutPolicy as JaxBrownout
from apex_tpu.serving import PagedKVCache as JaxPagedKVCache
from apex_tpu.serving import PagedServingEngine as JaxPagedEngine
from apex_tpu.serving import Rejection as JaxRejection
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import SlotScheduler as JaxScheduler
import apex_tpu_torch.elastic.faults as port_faults_mod
import apex_tpu_torch.serving.scheduler as port_sched_mod
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.elastic import FaultPlan
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import (MetricsRegistry, RequestRecord,
                                          RequestTrace, SLOTarget,
                                          SLOTracker)
from apex_tpu_torch.serving import (BrownoutPolicy, PagedServingEngine,
                                    Rejection, Request, ServingEngine,
                                    SlotScheduler)

SIZES = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=64)
DENSE = dict(max_seqs=2, max_len=64, prefill_len=16)
PAGED = dict(DENSE, num_blocks=33, block_size=4)
K = 2
KINDS = {"plain": (DENSE, {}), "quarantine": (DENSE, dict(quarantine=True)),
         "paged_q": (PAGED, dict(quarantine=True)),
         "spec_q": (DENSE, dict(quarantine=True, speculate_k=K))}
TICKS = {"prefill": 0.004, "decode": 0.002, "verify": 0.003}

JAX = types.SimpleNamespace(
    name="jax", Request=JaxRequest, SlotScheduler=JaxScheduler,
    MetricsRegistry=JaxRegistry, RequestTrace=JaxTrace,
    RequestRecord=JaxRecord, SLOTracker=JaxTracker, SLOTarget=JaxTarget,
    BrownoutPolicy=JaxBrownout, FaultPlan=JaxFaultPlan,
    Rejection=JaxRejection)
PORT = types.SimpleNamespace(
    name="port", Request=Request, SlotScheduler=SlotScheduler,
    MetricsRegistry=MetricsRegistry, RequestTrace=RequestTrace,
    RequestRecord=RequestRecord, SLOTracker=SLOTracker, SLOTarget=SLOTarget,
    BrownoutPolicy=BrownoutPolicy, FaultPlan=FaultPlan, Rejection=Rejection)


@functools.lru_cache(maxsize=None)
def _weights(seed=0):
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, **SIZES))
    jp = jm.init(jax.random.PRNGKey(seed))
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    return jm, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   cfg)


class _JaxEngines(dict):
    """The JAX engines by kind, each built at its first use: a worker that
    runs only some of this module's tests compiles only their engines."""

    def __missing__(self, kind):
        jm, jp, _ = _weights()
        args, kw = KINDS[kind]
        cls = JaxPagedEngine if "block_size" in args else JaxEngine
        eng = self[kind] = cls(jm, jp, cache_dtype=jnp.float32, **args,
                               **kw)
        return eng


@pytest.fixture(scope="module")
def jax_engines():
    return _JaxEngines()


def _fresh(eng):
    """A JAX engine with every slot free; a paged one with an empty pool
    and an allocator whose ``advance`` waits for the step (the reference's
    paged ``decode`` may read a cursor its host mirror already advanced:
    ``tests/test_torch_paged.py::_fresh``)."""
    if not isinstance(eng, JaxPagedEngine):
        for slot in range(eng.max_seqs):
            eng.release_slot(slot)
        return eng
    cfg = eng.model.cfg
    eng.cache = JaxPagedKVCache.create(
        cfg.num_layers, eng.num_blocks, cfg.num_attention_heads,
        eng.block_size, cfg.head_dim, dtype=jnp.float32)
    alloc = JaxAllocator(eng.num_blocks, eng.block_size,
                         eng.allocator.blocks_per_slot, eng.max_seqs)
    advance = alloc.advance

    def synced_advance(slots):
        jax.block_until_ready(eng.cache)
        advance(slots)

    alloc.advance = synced_advance
    eng.allocator = alloc
    return eng


def _port(kind, seed=0):
    args, kw = KINDS[kind]
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(_weights(seed)[2])
    cls = PagedServingEngine if "block_size" in args else ServingEngine
    return cls(model, cache_dtype=torch.float32, device="cpu", **args, **kw)


class FakeClock:
    """``perf_counter`` and ``sleep`` of a clock that moves only on
    ``sleep`` and on the ticking engines' calls."""

    def __init__(self):
        self.t = 0.0

    def reset(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class Ticking:
    """An engine whose ``prefill``, ``decode`` and ``verify`` move the
    clock by fixed ticks; everything else is the engine's."""

    def __init__(self, engine, clock):
        self._engine = engine
        self._clock = clock

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def prefill(self, *args, **kw):
        self._clock.sleep(TICKS["prefill"])
        return self._engine.prefill(*args, **kw)

    def decode(self, *args, **kw):
        self._clock.sleep(TICKS["decode"])
        return self._engine.decode(*args, **kw)

    def verify(self, *args, **kw):
        self._clock.sleep(TICKS["verify"])
        return self._engine.verify(*args, **kw)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jax_sched_mod, port_sched_mod, jax_faults_mod,
                port_faults_mod):
        monkeypatch.setattr(mod, "time", c)
    return c


def both(scenario, jax_engines, clock, kind="plain", **kw):
    """Run ``scenario(ns, engine, clock, **kw)`` on the JAX side and on
    the port's, each from a reset clock on a fresh engine of ``kind``;
    hold the two results to each other and return them."""
    out = {}
    for ns in (JAX, PORT):
        clock.reset()
        eng = (_fresh(jax_engines[kind]) if ns is JAX else _port(kind))
        out[ns.name] = scenario(ns, Ticking(eng, clock), clock, **kw)
    _same(out["jax"], out["port"])
    return out["jax"], out["port"]


def _same_float(a, b, what):
    if a is None or b is None:
        assert a is b, what
    else:
        assert abs(a - b) <= 1e-9, (what, a, b)


def _same(j, p):
    """Completions, registry snapshots, trace records and extras equal."""
    jc, pc = j["completions"], p["completions"]
    assert [c.request_id for c in pc] == [c.request_id for c in jc]
    for a, b in zip(jc, pc):
        assert b.tokens == a.tokens, a.request_id
        assert b.finish_reason == a.finish_reason, a.request_id
        for key in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
            _same_float(getattr(a, key), getattr(b, key),
                        (a.request_id, key))
    js, ps = j["registry"].snapshot(), p["registry"].snapshot()
    assert sorted(ps) == sorted(js)
    for key in js:
        assert ps[key] == pytest.approx(js[key], rel=1e-12, abs=1e-9,
                                        nan_ok=True), key
    if j.get("trace") is not None:
        jr = [r.to_dict() for r in j["trace"].records()]
        pr = [r.to_dict() for r in p["trace"].records()]
        assert len(pr) == len(jr)
        for a, b in zip(jr, pr):
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], float) or isinstance(b[key], float):
                    # stamps in seconds, latencies in ms: 1e-9 ms either way
                    _same_float(a[key], b[key], (a["request_id"], key))
                elif key == "decode_ts":
                    assert len(a[key]) == len(b[key])
                    for x, y in zip(a[key], b[key]):
                        _same_float(x, y, (a["request_id"], key))
                else:
                    assert a[key] == b[key], (a["request_id"], key)
    assert p.get("extra") == j.get("extra")


def _result(sched, reg, trace=None, **extra):
    return {"completions": list(sched.completed), "registry": reg,
            "trace": trace, "extra": extra}


def _reasons(sched):
    return {c.request_id: c.finish_reason for c in sched.completed}


# ---------------------------------------------------------------------------
# admission control and load shedding
# ---------------------------------------------------------------------------

def _queue_full(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(64)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace, max_queue=2)
    ids = [sched.submit(ns.Request(prompt=[1 + i], max_new_tokens=2))
           for i in range(5)]
    rejected = [(r.reason, bool(r)) for r in ids
                if isinstance(r, ns.Rejection)]
    depth = len(sched.queue)
    sched.run([])
    return _result(sched, reg, trace, rejected=rejected, depth=depth)


def _paced_run(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(64)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace, max_queue=1)
    out = sched.run([ns.Request(prompt=[1 + i, 3], max_new_tokens=2)
                     for i in range(4)])
    return _result(sched, reg, trace, ids=sorted(out))


def _overload(ns, eng, clock):
    """2x sustained oversubmission against ``max_queue=2``, then a burst
    of 4x the bound in one go; an SLO tracker attached."""
    tracker = ns.SLOTracker([ns.SLOTarget("e2e_ms", 95, 60.0)],
                            registry=ns.MetricsRegistry(),
                            on_violation="skip")
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(256)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace, slo=tracker,
                             max_queue=2)
    reasons, depth = [], 0

    def offer(i):
        r = sched.submit(ns.Request(prompt=[1 + i % 90], max_new_tokens=3))
        if isinstance(r, ns.Rejection):
            reasons.append(r.reason)

    for i in range(30):
        offer(2 * i)
        offer(2 * i + 1)
        sched.step()
        depth = max(depth, len(sched.queue))
    for i in range(8):
        offer(100 + i)
    depth = max(depth, len(sched.queue))
    sched.run([])
    return _result(sched, reg, trace, reasons=reasons, depth=depth,
                   goodput=tracker.goodput(),
                   burn=tracker.max_burn_rate())


@pytest.mark.parametrize("scenario", [_queue_full, _paced_run, _overload])
def test_queue_bound(scenario, jax_engines, clock):
    _, p = both(scenario, jax_engines, clock)
    extra, snap = p["extra"], p["registry"].snapshot()
    if scenario is _queue_full:
        assert extra["rejected"] == [("queue_full", False)] * 3
        assert extra["depth"] == 2 and snap["serve/rejected"] == 3.0
    elif scenario is _paced_run:
        assert extra["ids"] == [0, 1, 2, 3]
        assert snap.get("serve/rejected", 0.0) == 0.0
    else:
        assert extra["depth"] <= 2
        assert extra["reasons"] and set(extra["reasons"]) == {"queue_full"}
        assert snap["serve/rejected"] == len(extra["reasons"])
        assert all(c.finish_reason == "length" for c in p["completions"])


def test_queue_and_deadline_validation():
    eng = _port("plain")
    with pytest.raises(ValueError, match="max_queue"):
        SlotScheduler(eng, registry=MetricsRegistry(), max_queue=0)
    with pytest.raises(ValueError, match="default_deadline_ms"):
        SlotScheduler(eng, registry=MetricsRegistry(),
                      default_deadline_ms=0.0)
    sched = SlotScheduler(eng, registry=MetricsRegistry())
    for bad in (0.0, -5.0):
        with pytest.raises(ValueError, match="deadline_ms"):
            sched.submit(Request(prompt=[1], deadline_ms=bad))
    assert sched.pending == 0
    sched.submit(Request(prompt=[1], max_new_tokens=2, request_id=7))
    with pytest.raises(ValueError, match="already in flight"):
        sched.submit(Request(prompt=[2], request_id=7))
    assert sched.run([])[7].finish_reason == "length"
    assert sorted(sched.run([Request(prompt=[3], max_new_tokens=2,
                                     request_id=7)])) == [7]


# ---------------------------------------------------------------------------
# deadlines and cancel
# ---------------------------------------------------------------------------

def _queued_expiry(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    for i in range(2):
        sched.submit(ns.Request(prompt=[1 + i], max_new_tokens=4))
    sched.submit(ns.Request(prompt=[9], max_new_tokens=4, deadline_ms=1e-3))
    clock.sleep(0.005)
    sched.run([])
    return _result(sched, reg, trace)


def _mid_flight_expiry(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=40, deadline_ms=30.0))
    sched.submit(ns.Request(prompt=[2, 4], max_new_tokens=40,
                            deadline_ms=41.0))
    sched.step()
    clock.sleep(0.02)
    while sched.pending:
        sched.step()
    return _result(sched, reg, trace, free=sorted(sched.free))


def _default_deadline(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace,
                             default_deadline_ms=1e-3)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=2))
    sched.submit(ns.Request(prompt=[2], max_new_tokens=2,
                            deadline_ms=60000.0))
    clock.sleep(0.005)
    sched.run([])
    return _result(sched, reg, trace)


def _cancel(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    a = sched.submit(ns.Request(prompt=[1], max_new_tokens=50))
    sched.submit(ns.Request(prompt=[2], max_new_tokens=3))
    c = sched.submit(ns.Request(prompt=[3], max_new_tokens=3))
    sched.step()
    calls = [sched.cancel(c), sched.cancel(a), sched.cancel(a),
             sched.cancel(999)]
    sched.run([])
    return _result(sched, reg, trace, calls=calls)


def _expired_hurt_goodput(ns, eng, clock):
    tracker = ns.SLOTracker([ns.SLOTarget("e2e_ms", 95, 60000.0)],
                            registry=ns.MetricsRegistry(),
                            on_violation="skip")
    reg = ns.MetricsRegistry()
    sched = ns.SlotScheduler(eng, registry=reg, slo=tracker)
    for i in range(2):
        sched.submit(ns.Request(prompt=[1 + i], max_new_tokens=2))
    sched.submit(ns.Request(prompt=[9], max_new_tokens=2, deadline_ms=1e-3))
    clock.sleep(0.005)
    sched.run([])
    return _result(sched, reg, goodput=tracker.goodput())


@pytest.mark.parametrize("scenario", [_queued_expiry, _mid_flight_expiry,
                                      _default_deadline, _cancel,
                                      _expired_hurt_goodput])
def test_deadlines_and_cancel(scenario, jax_engines, clock):
    _, p = both(scenario, jax_engines, clock)
    reasons = {c.request_id: c.finish_reason for c in p["completions"]}
    tokens = {c.request_id: c.tokens for c in p["completions"]}
    snap = p["registry"].snapshot()
    if scenario is _queued_expiry:
        assert reasons[2] == "expired" and tokens[2] == []
        assert snap["serve/expired"] == 1.0 and snap["serve/admitted"] == 2.0
    elif scenario is _mid_flight_expiry:
        assert reasons == {0: "expired", 1: "expired"}
        assert all(len(t) >= 1 for t in tokens.values())
        assert p["extra"]["free"] == [0, 1]
        assert snap["serve/expired"] == 2.0
    elif scenario is _default_deadline:
        assert reasons == {0: "expired", 1: "length"}
    elif scenario is _cancel:
        assert p["extra"]["calls"] == [True, True, False, False]
        assert reasons == {2: "cancelled", 0: "cancelled", 1: "length"}
        assert tokens[2] == [] and snap["serve/cancelled"] == 2.0
    else:
        assert p["extra"]["goodput"] == pytest.approx(2.0 / 3.0)


# ---------------------------------------------------------------------------
# drain and the hot weight swap
# ---------------------------------------------------------------------------

def _drain(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    for i in range(4):
        sched.submit(ns.Request(prompt=[1 + i], max_new_tokens=4))
    sched.step()
    done = sched.drain()
    kept = len(sched.queue)
    after = sched.submit(ns.Request(prompt=[9], max_new_tokens=2))
    sched.run([])
    return _result(sched, reg, trace, done=sorted(done), kept=kept,
                   after=after, draining=sched.draining)


def _submit_during_drain(ns, eng, clock):
    reg = ns.MetricsRegistry()
    sched = ns.SlotScheduler(eng, registry=reg)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=3))
    sched.step()
    seen = []
    step = sched.step

    def probing_step():
        r = sched.submit(ns.Request(prompt=[5], max_new_tokens=1))
        seen.append((r.reason, sched.draining))
        return step()

    sched.step = probing_step
    sched.drain()
    return _result(sched, reg, seen=seen)


def _drain_deadline(ns, eng, clock):
    tracker = ns.SLOTracker([ns.SLOTarget("e2e_ms", 95, 60000.0)],
                            registry=ns.MetricsRegistry(),
                            on_violation="skip")
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace, slo=tracker)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=1000))
    sched.submit(ns.Request(prompt=[2], max_new_tokens=5))
    sched.step()
    done = sched.drain(deadline_s=0.005)
    return _result(sched, reg, trace, done=sorted(done),
                   goodput=tracker.goodput(), free=sorted(sched.free))


@pytest.mark.parametrize("scenario", [_drain, _submit_during_drain,
                                      _drain_deadline])
def test_drain(scenario, jax_engines, clock):
    _, p = both(scenario, jax_engines, clock)
    extra, snap = p["extra"], p["registry"].snapshot()
    assert snap["serve/drains"] == 1.0
    if scenario is _drain:
        assert extra["done"] == [0, 1] and extra["kept"] == 2
        assert extra["after"] == 4 and extra["draining"] is False
        assert all(c.finish_reason == "length" for c in p["completions"])
    elif scenario is _submit_during_drain:
        assert extra["seen"] and all(s == ("draining", True)
                                     for s in extra["seen"])
        assert snap["serve/rejected"] == len(extra["seen"])
    else:
        reasons = {c.request_id: c.finish_reason for c in p["completions"]}
        assert reasons == {0: "expired", 1: "length"}
        assert extra["free"] == [0, 1] and snap["serve/expired"] == 1.0
        assert extra["goodput"] == 0.5


def _swap(ns, eng, clock, new_params, old_params, probe):
    """A request in flight across a swap to the second seed's weights, then
    the probe prompt under the new weights, against its stream under the
    old ones."""
    old = ns.SlotScheduler(eng, registry=ns.MetricsRegistry()).run(
        [ns.Request(prompt=probe, max_new_tokens=6)])[0].tokens
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    sched.submit(ns.Request(prompt=[7, 8], max_new_tokens=12))
    for _ in range(3):
        sched.step()
    sched.swap_params(new_params)
    try:
        while sched.pending:
            sched.step()
        post = sched.run([ns.Request(prompt=probe, max_new_tokens=6,
                                     request_id=50)])[50].tokens
    finally:
        eng.swap_params(old_params)
    return _result(sched, reg, trace, old=old, post=post)


def test_swap_params_mid_run_changes_the_stream(jax_engines, clock):
    _, jp1, sd1 = _weights(1)
    _, jp0, sd0 = _weights(0)
    # a probe prompt whose first greedy token differs between the two
    # weight sets: a tiny random model can repeat one token under both
    e0, e1 = _port("plain"), _port("plain", seed=1)
    probe = next(t for t in ([1 + i, 2 + i, 3 + i] for i in range(60))
                 if int(e0.prefill_logits(t, 0).argmax())
                 != int(e1.prefill_logits(t, 0).argmax()))
    out = {}
    for ns, new, old in ((JAX, jp1, jp0), (PORT, sd1, sd0)):
        clock.reset()
        eng = _fresh(jax_engines["plain"]) if ns is JAX else _port("plain")
        out[ns.name] = _swap(ns, Ticking(eng, clock), clock, new, old,
                             probe)
    _same(out["jax"], out["port"])
    p = out["port"]
    assert p["extra"]["post"] != p["extra"]["old"]
    (mid, post) = p["completions"]
    assert mid.finish_reason == "length" and len(mid.tokens) == 12
    assert p["registry"].snapshot()["serve/swaps"] == 1.0


def test_swap_params_refuses_mismatches():
    eng = _port("plain")
    sd = dict(_weights(0)[2])
    with pytest.raises(ValueError, match="names differ"):
        eng.swap_params({k: v for k, v in list(sd.items())[1:]})
    name = next(iter(sd))
    with pytest.raises(ValueError, match=name):
        eng.swap_params(dict(sd, **{name: torch.zeros(3, 3)}))
    assert eng.swaps == 0
    out = SlotScheduler(eng, registry=MetricsRegistry()).run(
        [Request(prompt=[1], max_new_tokens=2)])
    assert out[0].finish_reason == "length"


# ---------------------------------------------------------------------------
# SLO-driven brownout
# ---------------------------------------------------------------------------

def _hot_tracker(ns, threshold_ms=1.0, n=16):
    tracker = ns.SLOTracker([ns.SLOTarget("e2e_ms", 95, threshold_ms)],
                            registry=ns.MetricsRegistry(),
                            on_violation="skip")
    for i in range(n):
        rec = ns.RequestRecord(request_id=i, prompt_len=1, submit_t=0.0)
        rec.retire_t = 10.0
        tracker.observe(rec)
    return tracker


def _brownout_shed(ns, eng, clock):
    reg = ns.MetricsRegistry()
    sched = ns.SlotScheduler(
        eng, registry=reg,
        brownout=ns.BrownoutPolicy(_hot_tracker(ns), shed=True))
    r = sched.submit(ns.Request(prompt=[1], max_new_tokens=4))
    out = sched.run([ns.Request(prompt=[2], max_new_tokens=2)])
    return _result(sched, reg, reason=r.reason, out=sorted(out))


def _brownout_cap(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    policy = ns.BrownoutPolicy(_hot_tracker(ns), shed=False,
                               cap_max_new_tokens=2)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace,
                             brownout=policy)
    req = ns.Request(prompt=[1], max_new_tokens=50)
    sched.submit(req)
    sched.run([])
    return _result(sched, reg, trace, caller=req.max_new_tokens)


def _brownout_cold(ns, eng, clock):
    reg = ns.MetricsRegistry()
    tracker = ns.SLOTracker([ns.SLOTarget("e2e_ms", 95, 1.0)],
                            registry=ns.MetricsRegistry(),
                            on_violation="skip")
    sched = ns.SlotScheduler(eng, registry=reg,
                             brownout=ns.BrownoutPolicy(tracker, shed=True))
    rid = sched.submit(ns.Request(prompt=[1], max_new_tokens=2))
    sched.run([])
    return _result(sched, reg, rid=rid)


@pytest.mark.parametrize("scenario", [_brownout_shed, _brownout_cap,
                                      _brownout_cold])
def test_brownout(scenario, jax_engines, clock):
    _, p = both(scenario, jax_engines, clock)
    snap = p["registry"].snapshot()
    if scenario is _brownout_shed:
        assert p["extra"] == {"reason": "shed", "out": []}
        assert snap["serve/shed"] == 2.0 and snap["serve/brownout"] == 1.0
    elif scenario is _brownout_cap:
        (c,) = p["completions"]
        assert c.finish_reason == "length" and len(c.tokens) == 2
        assert p["extra"]["caller"] == 50    # the caller's request uncut
    else:
        assert p["extra"]["rid"] == 0 and snap["serve/brownout"] == 0.0


@pytest.mark.parametrize("kw, match", [
    (dict(burn_threshold=0.0), "burn_threshold"),
    (dict(cap_max_new_tokens=0), "cap_max_new_tokens"),
    (dict(shed=False), "nothing"),
])
def test_brownout_policy_validation(kw, match):
    for ns in (JAX, PORT):
        with pytest.raises(ValueError, match=match):
            ns.BrownoutPolicy(_hot_tracker(ns), **kw)
    policy = BrownoutPolicy(_hot_tracker(PORT), cap_max_new_tokens=3)
    assert policy.engaged() and policy.cap(9) == 3 and policy.cap(2) == 2
    assert BrownoutPolicy(_hot_tracker(PORT)).cap(9) == 9


# ---------------------------------------------------------------------------
# exception safety
# ---------------------------------------------------------------------------

def _decode_fault(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=9))
    sched.submit(ns.Request(prompt=[2], max_new_tokens=9))
    sched.step()

    def boom(*args, **kw):
        raise RuntimeError("injected decode fault")

    eng.decode = boom
    with pytest.raises(RuntimeError, match="injected decode fault"):
        sched.step()
    del eng.decode
    state = (len(sched.active), sorted(sched.free))
    post = sched.run([ns.Request(prompt=[3], max_new_tokens=2)])
    return _result(sched, reg, trace, state=state, post=sorted(post))


def _prefill_fault(ns, eng, clock):
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace)
    sched.submit(ns.Request(prompt=[1], max_new_tokens=4))

    def boom(*args, **kw):
        raise RuntimeError("injected prefill fault")

    eng.prefill = boom
    with pytest.raises(RuntimeError, match="injected prefill fault"):
        sched.step()
    del eng.prefill
    free = sorted(sched.free)
    post = sched.run([ns.Request(prompt=[2], max_new_tokens=2)])
    return _result(sched, reg, trace, free=free, post=sorted(post))


@pytest.mark.parametrize("scenario", [_decode_fault, _prefill_fault])
def test_engine_fault_retires_in_flight(scenario, jax_engines, clock):
    _, p = both(scenario, jax_engines, clock)
    reasons = [c.finish_reason for c in p["completions"]]
    snap = p["registry"].snapshot()
    if scenario is _decode_fault:
        assert p["extra"]["state"] == (0, [0, 1])
        assert reasons == ["error", "error", "length"]
        assert all(len(c.tokens) >= 1 for c in p["completions"][:2])
        assert snap["serve/errors"] == 2.0
    else:
        assert p["extra"]["free"] == [0, 1]
        assert reasons == ["error", "length"] and snap["serve/errors"] == 1.0


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return {f: getattr(plan, f) for f in (
        "sigterm_at_step", "save_errors", "tear_after_step", "slow_save_s",
        "kill_process", "poison_logits", "slow_decode_s", "flood", "seed")}


@pytest.mark.parametrize("plan_kw", [
    dict(poison_logits={4: 1}, slow_decode_s=0.25, flood={2: 6}, seed=9),
    dict(sigterm_at_step=3, save_errors={2: 1}, tear_after_step=3,
         slow_save_s=0.5, kill_process={1: 4}),
    dict(),
])
def test_fault_plan_json_both_ways(plan_kw):
    p, j = FaultPlan(**plan_kw), JaxFaultPlan(**plan_kw)
    assert json.loads(p.to_json()) == json.loads(j.to_json())
    assert _plan_fields(JaxFaultPlan.from_json(p.to_json())) == \
        _plan_fields(p)
    assert FaultPlan.from_json(j.to_json()) == p
    assert FaultPlan.from_json(p.to_json()) == p


def test_fault_plan_sampling_draws_the_reference_plans():
    for seed in range(20):
        p = FaultPlan.sample_serving(seed, 12, max_slots=4, flood_n=3,
                                     slow_decode_s=0.002)
        j = JaxFaultPlan.sample_serving(seed, 12, max_slots=4, flood_n=3,
                                        slow_decode_s=0.002)
        assert _plan_fields(p) == _plan_fields(j)
        (fstep, fn), = p.flood.items()
        (pstep, pslot), = p.poison_logits.items()
        assert 1 <= fstep < 3 and fn == 3 and 6 <= pstep < 12
        assert 0 <= pslot < 4
        for kw in (dict(), dict(save_interval=3, tear=True),
                   dict(transient_errors=False)):
            assert _plan_fields(FaultPlan.sample(seed, 10, **kw)) == \
                _plan_fields(JaxFaultPlan.sample(seed, 10, **kw))
    assert FaultPlan.sample_serving(23, 10, max_slots=2) == \
        FaultPlan.sample_serving(23, 10, max_slots=2)


@pytest.mark.parametrize("call, kw, match", [
    ("sample_serving", dict(seed=0, total_steps=3, max_slots=2),
     "total_steps"),
    ("sample_serving", dict(seed=0, total_steps=8, max_slots=0),
     "max_slots"),
    ("sample", dict(seed=0, total_steps=1), "total_steps"),
    ("sample", dict(seed=0, total_steps=5, save_interval=0),
     "save_interval"),
])
def test_fault_plan_sampling_validation(call, kw, match):
    for cls in (FaultPlan, JaxFaultPlan):
        with pytest.raises(ValueError, match=match):
            getattr(cls, call)(**kw)


def test_fault_plan_hooks(clock, tmp_path):
    plan = FaultPlan(poison_logits={3: 1}, slow_decode_s=0.25,
                     flood={2: 6})
    assert plan.poison_slot(3) == 1 and plan.poison_slot(2) is None
    assert plan.flood_n(2) == 6 and plan.flood_n(3) == 0
    plan.before_decode(1)
    assert clock.t == 0.25
    FaultPlan().before_decode(1)
    assert clock.t == 0.25
    # no training fault scripted: the runner's hook does nothing (its
    # signals are held against the reference in test_torch_elastic.py)
    plan.before_step(1)
    assert clock.t == 0.25
    # the checkpoint hooks act: transient errors, the slow save, the tear
    saving = FaultPlan(save_errors={2: 2}, slow_save_s=0.5,
                       tear_after_step=3)
    for attempt in (0, 1):
        with pytest.raises(OSError, match=f"step 2, attempt {attempt}"):
            saving.on_save_attempt(2, attempt)
    saving.on_save_attempt(2, 2)
    saving.on_save_attempt(1, 0)
    assert clock.t == 0.25 + 4 * 0.5
    path = tmp_path / "step_00000003"
    path.mkdir()
    (path / "COMMITTED").write_text("ok\n")
    saving.after_save(2, str(path))
    assert (path / "COMMITTED").exists()
    saving.after_save(3, str(path))
    assert not (path / "COMMITTED").exists()
    plan.after_save(3, str(path))       # no tear scripted: nothing to do


def _slow(ns, eng, clock):
    reg = ns.MetricsRegistry()
    sched = ns.SlotScheduler(eng, registry=reg,
                             fault_plan=ns.FaultPlan(slow_decode_s=0.02))
    sched.run([ns.Request(prompt=[1], max_new_tokens=4)])
    return _result(sched, reg, elapsed=clock.t)


def test_slow_decode_stretches_steps(jax_engines, clock):
    _, p = both(_slow, jax_engines, clock)
    assert p["extra"]["elapsed"] == pytest.approx(
        TICKS["prefill"] + 3 * (TICKS["decode"] + 0.02))


# ---------------------------------------------------------------------------
# quarantine: engines, isolation, the chaos run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "paged_q", "spec_q"])
def test_poison_on_a_plain_engine_is_refused(kind):
    """A poison vector, or a poison plan, on an engine built without
    quarantine raises, before any state changes."""
    args, kw = KINDS[kind]
    cls = PagedServingEngine if "block_size" in args else ServingEngine
    eng = cls(GPTModel(GPTConfig(compute_dtype=torch.float32, **SIZES),
                       device="cpu"),
              cache_dtype=torch.float32, device="cpu", **args,
              **dict(kw, quarantine=False))
    z = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="quarantine"):
        SlotScheduler(eng, registry=MetricsRegistry(),
                      fault_plan=FaultPlan(poison_logits={1: 0}))
    with pytest.raises(ValueError, match="quarantine"):
        if kw.get("speculate_k"):
            eng.verify(np.zeros(2, np.int64), np.zeros((2, K), np.int64), z,
                       poison=z)
        else:
            eng.decode(np.zeros(2, np.int64), z, poison=z)
    assert eng.last_finite is None
    if kind == "paged_q":
        assert eng.allocator.lengths.tolist() == [0, 0]
    else:
        assert eng.cache.lengths.tolist() == [0, 0]


@pytest.mark.parametrize("kind", ["quarantine", "paged_q", "spec_q"])
def test_finite_flags_equal_jax(kind, jax_engines):
    """Engine level: the same poison vectors give the same finite flags
    and, on the slots left finite, the same greedy tokens (and counts)."""
    je, pe = _fresh(jax_engines[kind]), _port(kind)
    prompts = ([3, 4, 5], [9, 8])
    toks = np.array([je.prefill(p, s) for s, p in enumerate(prompts)])
    assert [pe.prefill(p, s) for s, p in enumerate(prompts)] == toks.tolist()
    temps = np.zeros(2, np.float32)
    for poison in (None, [np.nan, 0.0], [0.0, np.inf], [0.0, 0.0]):
        pv = None if poison is None else np.asarray(poison, np.float32)
        if kind == "spec_q":
            drafts = np.stack([toks, toks], axis=1)
            jt, jc = je.verify(toks, drafts, temps, poison=pv)
            pt, pc = pe.verify(toks, drafts, temps, poison=pv)
        else:
            jt, pt = (e.decode(toks, temps, poison=pv) for e in (je, pe))
            jc = pc = None
        assert pe.last_finite.dtype == bool
        np.testing.assert_array_equal(pe.last_finite, je.last_finite)
        for s in np.flatnonzero(pe.last_finite):
            if jc is None:
                assert pt[s] == jt[s]
            else:
                assert pc[s] == jc[s]
                assert pt[s, :pc[s]].tolist() == jt[s, :jc[s]].tolist()
        toks = np.where(pe.last_finite, pt if jc is None else pt[:, 0],
                        toks)
        if jc is not None:
            break   # a poisoned window advanced the cursors apart


def _isolation(ns, eng, clock, plan_kw, dump_dir):
    reqs = [([5, 6], 8), ([7, 8], 8)]

    def run(plan):
        reg, trace = ns.MetricsRegistry(), ns.RequestTrace(16)
        sched = ns.SlotScheduler(eng, registry=reg, trace=trace,
                                 fault_plan=plan, dump_dir=str(dump_dir))
        sched.run([ns.Request(prompt=list(p), max_new_tokens=n)
                   for p, n in reqs])
        return sched, reg, trace

    clean, _, _ = run(None)
    sched, reg, trace = run(ns.FaultPlan(**plan_kw))
    dumps = []
    for path in sched.poison_dumps:
        with open(path) as f:
            doc = json.load(f)
        dumps.append((doc["step"], doc["config"],
                      [r["finish_reason"] for r in doc["requests"]]))
    return _result(sched, reg, trace, clean=[c.tokens for c in
                                             clean.completed],
                   dumps=dumps)


@pytest.mark.parametrize("kind", ["quarantine", "paged_q"])
def test_poison_retires_only_the_poisoned_slot(kind, jax_engines, clock,
                                               tmp_path):
    _, p = both(_isolation, jax_engines, clock, kind=kind,
                plan_kw=dict(poison_logits={3: 0}), dump_dir=tmp_path)
    (a, b), clean = p["completions"], p["extra"]["clean"]
    assert a.finish_reason == "poisoned" and a.tokens == clean[0][:3]
    assert b.finish_reason == "length" and b.tokens == clean[1]
    assert p["registry"].snapshot()["serve/poisoned"] == 1.0
    (step, config, reasons), = p["extra"]["dumps"]
    assert step == 3 and config["slot"] == 0
    assert config["finish_reason"] == "poisoned" and "poisoned" in reasons


def test_quarantine_engine_serves_as_the_plain_one():
    reqs = [([11, 12, 13], 5), ([14], 5)]
    outs = []
    for kind in ("plain", "quarantine"):
        outs.append(SlotScheduler(_port(kind), registry=MetricsRegistry())
                    .run([Request(prompt=list(p), max_new_tokens=n)
                          for p, n in reqs]))
    for rid in outs[0]:
        assert outs[0][rid].tokens == outs[1][rid].tokens


CHAOS_SEED = 23


def _chaos(ns, eng, clock, plan_kw, dump_dir, max_queue=4):
    """``tests/test_resilience.py``'s chaos drive: flood, poison and a
    slow step from ``FaultPlan.sample_serving``, a bounded queue."""
    plan = ns.FaultPlan.sample_serving(CHAOS_SEED, 10, max_slots=2,
                                       **plan_kw)
    reg, trace = ns.MetricsRegistry(), ns.RequestTrace(64)
    sched = ns.SlotScheduler(eng, registry=reg, trace=trace,
                             max_queue=max_queue, fault_plan=plan,
                             dump_dir=str(dump_dir))
    rng = np.random.RandomState(0)

    def fresh(i):
        return ns.Request(prompt=[1 + int(rng.randint(90)), 2],
                          max_new_tokens=10, request_id=100 + i)

    for i in range(4):
        sched.submit(fresh(i))
    submitted, reasons, depth = 4, [], 0
    while sched.pending:
        for _ in range(plan.flood_n(sched.steps + 1)):
            r = sched.submit(fresh(submitted))
            submitted += 1
            if isinstance(r, ns.Rejection):
                reasons.append(r.reason)
        sched.step()
        depth = max(depth, len(sched.queue))
    return _result(sched, reg, trace, reasons=reasons, depth=depth,
                   plan=_plan_fields(plan))


@pytest.mark.parametrize("kind", ["quarantine", "paged_q"])
def test_chaos_run(kind, jax_engines, clock, tmp_path):
    kw = dict(flood_n=6, slow_decode_s=0.002)
    _, faulted = both(_chaos, jax_engines, clock, kind=kind, plan_kw=kw,
                      dump_dir=tmp_path)
    plan = faulted["extra"]["plan"]
    # the same request schedule, poison and stretch stripped: the flood
    # still happens through the same driving loop
    _, clean = both(_chaos, jax_engines, clock, kind=kind,
                    plan_kw=dict(flood_n=6), dump_dir=tmp_path)
    assert faulted["extra"]["depth"] <= 4
    assert faulted["extra"]["reasons"] and set(
        faulted["extra"]["reasons"]) == {"queue_full"}
    assert faulted["registry"].snapshot()["serve/poisoned"] == 1.0
    poisoned = [c for c in faulted["completions"]
                if c.finish_reason == "poisoned"]
    assert len(poisoned) == 1 and plan["poison_logits"]
    clean_out = {c.request_id: c for c in clean["completions"]}
    compared = 0
    for c in faulted["completions"]:
        if c.finish_reason == "poisoned" or c.request_id not in clean_out:
            continue
        if clean_out[c.request_id].finish_reason == "length":
            assert c.tokens == clean_out[c.request_id].tokens, c.request_id
            compared += 1
    assert compared >= 3


def _poison_mid_verify(ns, eng, clock, dump_dir):
    reqs = [[7, 8, 7, 8], [9, 1, 9, 1]]

    def run(plan):
        reg = ns.MetricsRegistry()
        sched = ns.SlotScheduler(eng, registry=reg, speculate_k=K,
                                 fault_plan=plan, dump_dir=str(dump_dir))
        out = sched.run([ns.Request(prompt=list(p), max_new_tokens=8)
                         for p in reqs])
        return sched, reg, out

    _, _, clean = run(None)
    sched, reg, faulted = run(ns.FaultPlan(poison_logits={2: 0}))
    _, _, again = run(None)
    return _result(sched, reg, clean={k: v.tokens for k, v in clean.items()},
                   again={k: v.tokens for k, v in again.items()})


def _check_mid_verify(p):
    (a, b), clean = p["completions"], p["extra"]["clean"]
    assert a.finish_reason == "poisoned"
    assert a.tokens == clean[0][:len(a.tokens)]
    assert b.tokens == clean[1] and b.finish_reason == "length"
    assert p["registry"].snapshot()["serve/poisoned"] == 1.0
    assert p["extra"]["again"] == clean


def test_poison_mid_verify_retires_clean(jax_engines, clock, tmp_path):
    """``tests/test_speculative.py::test_poison_mid_verify_retires_clean``
    on the speculative quarantine engine: the poisoned window is
    discarded whole, the neighbour's stream is untouched, and a request
    re-admitted into the freed slot reproduces the clean stream."""
    _, p = both(_poison_mid_verify, jax_engines, clock, kind="spec_q",
                dump_dir=tmp_path)
    _check_mid_verify(p)


def test_poison_mid_verify_paged(clock, tmp_path):
    eng = PagedServingEngine(
        GPTModel(GPTConfig(compute_dtype=torch.float32, **SIZES),
                 device="cpu").init(torch.Generator().manual_seed(0)),
        cache_dtype=torch.float32, device="cpu", quarantine=True,
        speculate_k=K, **PAGED)
    _check_mid_verify(_poison_mid_verify(PORT, Ticking(eng, clock), clock,
                                         tmp_path))
    assert eng.allocator.free_blocks == PAGED["num_blocks"] - 1


# ---------------------------------------------------------------------------
# trace ticks, capacity
# ---------------------------------------------------------------------------

def test_decode_ticks_only_with_a_trace():
    seen = []

    class Recorder(SLOTracker):
        def observe(self, record):
            seen.append(list(record.decode_ts))
            super().observe(record)

    tracker = Recorder([SLOTarget("e2e_ms", 95, 1e4)],
                       registry=MetricsRegistry(), on_violation="skip")
    SlotScheduler(_port("plain"), registry=MetricsRegistry(),
                  slo=tracker).run([Request(prompt=[1], max_new_tokens=4)])
    assert seen == [[]]
    trace = RequestTrace(4)
    SlotScheduler(_port("plain"), registry=MetricsRegistry(),
                  trace=trace).run([Request(prompt=[1], max_new_tokens=4)])
    assert len(trace.records()[0].decode_ts) == 3


@pytest.mark.parametrize("kind", ["plain", "paged_q"])
def test_capacity_falls_back_to_the_parameter_bytes(kind, jax_engines,
                                                    monkeypatch):
    je, pe = jax_engines[kind], _port(kind)
    monkeypatch.setattr(je, "overhead_bytes", lambda: None)
    assert pe.overhead_bytes() is None
    assert pe.bytes_per_slot() == je.bytes_per_slot()
    if kind == "plain":
        assert pe.cache.nbytes() == je.cache.nbytes()
    for hbm in (10 ** 6, 3 * 10 ** 7, 80 * 2 ** 30):
        for reserve in (0.0, 0.1, 0.5):
            assert pe.suggest_max_seqs(hbm, reserve) == \
                je.suggest_max_seqs(hbm, reserve), (hbm, reserve)


# ---------------------------------------------------------------------------
# zero cost when off, counted
# ---------------------------------------------------------------------------

class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


_HOST_READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
               "__index__")


def _count_step(monkeypatch, sched):
    """The aten calls of one ``sched.step()`` and the tensor reads to the
    host (``.cpu()``, ``.item()``, ``.tolist()`` and the conversions)."""
    reads = collections.Counter()
    with monkeypatch.context() as m:
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def wrapped(self, *a, _orig=orig, _name=name, **kw):
                reads[_name] += 1
                return _orig(self, *a, **kw)

            m.setattr(torch.Tensor, name, wrapped)
        with CountOps() as mode:
            sched.step()
    return mode.ops, reads


def _knobbed(eng, plan):
    tracker = SLOTracker([SLOTarget("ttft_ms", 95, 6e4)],
                         registry=MetricsRegistry(), on_violation="skip")
    return SlotScheduler(
        eng, registry=MetricsRegistry(), trace=RequestTrace(8), slo=tracker,
        max_queue=8, default_deadline_ms=6e4,
        brownout=BrownoutPolicy(tracker, cap_max_new_tokens=64),
        fault_plan=plan, speculate_k=eng.speculate_k)


def _steady_step(monkeypatch, sched):
    """Admit two requests, then count one step that only decodes."""
    for p in ([3, 4, 5], [6, 7]):
        sched.submit(Request(prompt=p, max_new_tokens=20))
    sched.step()
    ops, reads = _count_step(monkeypatch, sched)
    assert len(sched.active) == 2 and sched.steps == 2
    return ops, reads


ZERO_COST = [("dense", {}), ("paged", dict(num_blocks=33, block_size=4)),
             ("dense verify", dict(speculate_k=K)),
             ("paged verify", dict(num_blocks=33, block_size=4,
                                   speculate_k=K))]

# what a quarantine engine's step adds, by aten op: the poison add, the
# finite reduction (``isfinite`` decomposes into eq, abs, ne and mul; one
# ``all`` over the vocab, or over a verify window's rows and vocab), the
# flags' cast to the tokens' dtype and, for decode, the concatenation
# that puts them in the step's one host copy (verify already makes one
# for its counts); the unsqueezes are views
_ISFINITE = {"aten.eq.Tensor": 1, "aten.abs.default": 1,
             "aten.ne.Scalar": 1, "aten.mul.Tensor": 1}
QUARANTINE_EXTRA = {
    "decode": dict(_ISFINITE, **{
        "aten.add.Tensor": 1, "aten.all.dim": 1,
        "aten._to_copy.default": 1, "aten.cat.default": 1,
        "aten.unsqueeze.default": 3}),
    "verify": dict(_ISFINITE, **{
        "aten.add.Tensor": 1, "aten.all.dims": 1,
        "aten._to_copy.default": 1, "aten.unsqueeze.default": 3}),
}


def _engine(kw, quarantine=False):
    args = dict(DENSE, **{k: v for k, v in kw.items()
                          if k in ("num_blocks", "block_size")})
    cls = PagedServingEngine if "block_size" in kw else ServingEngine
    model = GPTModel(GPTConfig(compute_dtype=torch.float32, **SIZES),
                     device="cpu")
    model.load_state_dict(_weights(0)[2])
    return cls(model, cache_dtype=torch.float32, device="cpu",
               quarantine=quarantine, speculate_k=kw.get("speculate_k", 0),
               **args)


@pytest.mark.parametrize("what, kw", ZERO_COST, ids=[z[0] for z in ZERO_COST])
def test_host_knobs_add_no_device_work(what, kw, monkeypatch):
    bare = SlotScheduler(_engine(kw), registry=MetricsRegistry(),
                         speculate_k=kw.get("speculate_k", 0))
    ops0, reads0 = _steady_step(monkeypatch, bare)
    assert reads0 == {"cpu": 1}, reads0
    for plan in (None, FaultPlan()):
        ops1, reads1 = _steady_step(monkeypatch,
                                    _knobbed(_engine(kw), plan))
        assert ops1 == ops0
        assert reads1 == reads0


@pytest.mark.parametrize("what, kw", ZERO_COST, ids=[z[0] for z in ZERO_COST])
def test_quarantine_adds_only_the_finite_check(what, kw, monkeypatch):
    bare = SlotScheduler(_engine(kw), registry=MetricsRegistry(),
                         speculate_k=kw.get("speculate_k", 0))
    ops0, reads0 = _steady_step(monkeypatch, bare)
    q = SlotScheduler(_engine(kw, quarantine=True),
                      registry=MetricsRegistry(),
                      speculate_k=kw.get("speculate_k", 0))
    ops1, reads1 = _steady_step(monkeypatch, q)
    assert reads1 == reads0 == {"cpu": 1}
    assert not ops0 - ops1, "the quarantine step dropped an op"
    assert dict(ops1 - ops0) == QUARANTINE_EXTRA[
        "verify" if "verify" in what else "decode"]
