"""Port speculative serving vs the JAX package's on the CPU, fp32.

Both port engines (dense and paged) at ``speculate_k`` 1 and 3 against the
JAX speculative engines built once for the module (each compiles four
programs) on one tiny GPT (2 layers, hidden 64, 4 heads, vocab 97), its
weights carried by ``_bridge.params_from_jax``. Every comparison is
exact: greedy tokens are an argmax over logits that agree to ~1e-6, and
counts, cursors and metrics are integers.

- verify step by step: tokens, counts and cursors equal JAX's, drafts
  right, wrong and half right, an inactive slot frozen at count 0, and the
  emitted streams equal the port's non-speculative greedy streams (the
  rejected rows' KV is never read);
- ``SlotScheduler(speculate_k=k)``: completions equal the port's
  non-speculative scheduler's and the JAX speculative scheduler's, token
  for token with the same finish reasons, and the ``serve/spec_*`` values
  equal the JAX registry's;
- a retirement in the middle of a harvest (``"length"``), then a request
  admitted into the freed slot: its stream is the clean one;
- pool exhaustion mid-verify retires ``"capacity"`` with count 0;
- the constructors' and ``verify``'s argument errors, as the reference's.

Stochastic streams cannot match JAX's draws (different generators): they
are held by distribution in ``tests/test_torch_speculative.py``, and here
to their length and to repeating under one seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.observability.registry import MetricsRegistry as JaxRegistry
from apex_tpu.serving import BlockAllocator as JaxAllocator
from apex_tpu.serving import PagedKVCache as JaxPagedKVCache
from apex_tpu.serving import PagedServingEngine as JaxPagedEngine
from apex_tpu.serving import Rejection as JaxRejection
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import SlotScheduler as JaxScheduler
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import (DraftSource, NGramDraftSource,
                                    PagedServingEngine, Rejection, Request,
                                    ServingEngine, SlotScheduler)

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=64)
V = SIZES["vocab_size"]
DENSE = dict(max_seqs=2, max_len=24, prefill_len=8)
PAGED = dict(DENSE, num_blocks=16, block_size=4)
TINY_POOL = dict(max_seqs=1, max_len=16, prefill_len=12, num_blocks=3,
                 block_size=4)
KS = (1, 3)
SPEC_KEYS = ("serve/spec_steps", "serve/spec_drafted",
             "serve/spec_accepted", "serve/spec_accept_rate",
             "serve/decode_steps", "serve/generated_tokens")


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX speculative engines, one per (kind, k), and the tiny-pool
    one; :func:`_fresh` resets a paged one before use."""
    jm, jp, _ = _weights()
    engines = {}
    for k in KS:
        engines["dense", k] = JaxEngine(jm, jp, cache_dtype=jnp.float32,
                                        speculate_k=k, **DENSE)
        engines["paged", k] = JaxPagedEngine(jm, jp, cache_dtype=jnp.float32,
                                             speculate_k=k, **PAGED)
    engines["tiny_pool", 1] = JaxPagedEngine(
        jm, jp, cache_dtype=jnp.float32, speculate_k=1, **TINY_POOL)
    return engines


def _fresh(eng):
    """A JAX engine with every slot free; a paged one with an empty pool
    and allocator whose ``advance`` waits for the step (the reference's
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


def _port(kind, k=0, **kw):
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_weights()[2], cfg))
    cls = PagedServingEngine if kind in ("paged", "tiny_pool") \
        else ServingEngine
    args = {"dense": DENSE, "paged": PAGED, "tiny_pool": TINY_POOL}[kind]
    return cls(model, cache_dtype=torch.float32, speculate_k=k,
               device="cpu", **dict(args, **kw))


def _cursors(eng):
    if hasattr(eng, "allocator"):
        return np.asarray(eng.allocator.lengths).tolist()
    return np.asarray(eng.cache.lengths).tolist()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, V, n).tolist()


def _plain_streams(kind, prompts, n):
    """Greedy streams of ``n`` tokens from the port's non-speculative
    engine, every slot stepping together."""
    eng = _port(kind)
    streams = [[eng.prefill(p, s)] for s, p in enumerate(prompts)]
    temps = np.zeros(eng.max_seqs, np.float32)
    for _ in range(n - 1):
        toks = np.array([s[-1] for s in streams], np.int64)
        nxt = eng.decode(toks, temps)
        for s, st in enumerate(streams):
            st.append(int(nxt[s]))
    return streams


# ---------------------------------------------------------------------------
# verify, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_steps_equal_jax_and_plain(kind, k, jax_engines):
    je = _fresh(jax_engines[kind, k])
    pe = _port(kind, k)
    prompts = [_prompt(1, 5), _prompt(2, 7)]
    n = 12
    plain = _plain_streams(kind, prompts, n + k + 1)
    got = []
    for s, p in enumerate(prompts):
        a, b = je.prefill(p, s), pe.prefill(p, s)
        assert a == b == plain[s][0]
        got.append([b])
    temps = np.zeros(2, np.float32)
    step = 0
    while min(len(g) for g in got) < n:
        # a slot rests once it has n tokens, and slot 1 at times
        active = np.array([len(got[0]) < n,
                           len(got[1]) < n and step % 3 != 2])
        toks = np.array([g[-1] for g in got], np.int64)
        drafts = np.zeros((2, k), np.int64)
        for s, g in enumerate(got):
            right = plain[s][len(g): len(g) + k]
            mode = (step + s) % 3                    # right, wrong, half
            if mode == 1:
                right = [(t + 1) % V for t in right]
            elif mode == 2:
                right = right[: k // 2] + [(t + 1) % V
                                           for t in right[k // 2:]]
            drafts[s] = right
        jt, jc = je.verify(toks.astype(np.int32), drafts.astype(np.int32),
                           temps, active)
        pt, pc = pe.verify(toks, drafts, temps, active)
        assert pt.shape == (2, k + 1) and pc.shape == (2,)
        np.testing.assert_array_equal(pc, np.asarray(jc), err_msg=str(step))
        for s in np.flatnonzero(active):
            np.testing.assert_array_equal(pt[s], np.asarray(jt)[s],
                                          err_msg=f"step {step} slot {s}")
            got[s].extend(int(t) for t in pt[s, : pc[s]])
        assert all(pc[~active] == 0) and all(pc[active] >= 1)
        assert _cursors(pe) == _cursors(je)
        assert _cursors(pe) == [len(p) + len(g) - 1
                                for p, g in zip(prompts, got)]
        step += 1
    for s in range(2):
        assert got[s] == plain[s][: len(got[s])], f"slot {s}"
    if kind == "paged":
        np.testing.assert_array_equal(pe.allocator.tables,
                                      je.allocator.tables)
    for slot in range(2):
        je.release_slot(slot)


# ---------------------------------------------------------------------------
# the scheduler's speculative loop
# ---------------------------------------------------------------------------

def _requests(cls, specs):
    return [cls(prompt=list(p), max_new_tokens=n, eos_token=eos)
            for p, n, eos in specs]


def _specs(eos=None):
    # repetitive prompts (the n-gram source lands accepts), a random one
    # and one with an eos token; more requests than slots, so slots are
    # re-admitted
    return [([1, 2, 1, 2, 1, 2], 7, None), ([3, 4, 3, 4], 9, None),
            ([5, 5, 5, 5, 5], 6, None), (_prompt(7, 6), 8, None),
            ([8, 9, 8, 9, 8], 10, eos)]


def _run(sched, reqs):
    out = sched.run(reqs)
    return {rid: (c.tokens, c.finish_reason) for rid, c in out.items()}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_scheduler_completions_equal_jax_and_plain(kind, k, jax_engines):
    def plain_run(specs):
        return _run(SlotScheduler(_port(kind), registry=MetricsRegistry()),
                    _requests(Request, specs))

    # the last request stops at the 4th token of its greedy stream
    specs = _specs(eos=plain_run(_specs())[4][0][3])
    plain = plain_run(specs)
    reg = MetricsRegistry()
    sched = SlotScheduler(_port(kind, k), registry=reg, speculate_k=k)
    assert isinstance(sched.draft_source, NGramDraftSource)
    spec = _run(sched, _requests(Request, specs))
    jreg = JaxRegistry()
    jspec = _run(JaxScheduler(_fresh(jax_engines[kind, k]), registry=jreg,
                              speculate_k=k),
                 _requests(JaxRequest, specs))
    assert spec == plain == jspec
    assert {r for _, r in spec.values()} == {"length", "eos"}
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    for key in SPEC_KEYS:
        assert snap[key] == jsnap[key], key
    assert snap["serve/spec_steps"] == snap["serve/decode_steps"]
    assert snap["serve/spec_accepted"] > 0
    assert snap["serve/decode_steps"] < sum(n - 1 for _, n, _ in specs)


class _Replay(DraftSource):
    """Drafts each request's known greedy continuation: every draft of an
    active slot is right, so every count is k + 1."""

    def __init__(self, streams):
        self.streams = streams

    def draft(self, context, k):
        for prompt, stream in self.streams.items():
            if tuple(context[: len(prompt)]) == prompt:
                done = len(context) - len(prompt)
                out = list(stream[done: done + k])
                return out + [out[-1] if out else 0] * (k - len(out))
        raise AssertionError("unknown context")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_mid_harvest_retirement_then_readmission(kind, jax_engines):
    """k = 3, all drafts right: a request of 1 + 4 + 2 tokens retires
    ``"length"`` two tokens into its second harvest of four, its slot
    holding two rejected-but-written rows above the cursor; the requests
    admitted into the freed slots give the clean streams."""
    k = 3
    specs = [(_prompt(11, 5), 7, None), (_prompt(12, 6), 6, None),
             (_prompt(13, 4), 9, None), (_prompt(14, 7), 8, None)]
    plain = _run(SlotScheduler(_port(kind), registry=MetricsRegistry()),
                 _requests(Request, specs))
    streams = {tuple(p): plain[i][0] for i, (p, _, _) in enumerate(specs)}
    eng = _port(kind, k)
    counts = []
    verify = eng.verify

    def recorded(*args, **kw):
        toks, c = verify(*args, **kw)
        counts.append(c.copy())
        return toks, c

    eng.verify = recorded
    spec = _run(SlotScheduler(eng, registry=MetricsRegistry(),
                              speculate_k=k, draft_source=_Replay(streams)),
                _requests(Request, specs))
    jspec = _run(JaxScheduler(_fresh(jax_engines[kind, k]),
                              registry=JaxRegistry(), speculate_k=k,
                              draft_source=_Replay(streams)),
                 _requests(JaxRequest, specs))
    assert spec == plain == jspec
    assert all(r == "length" for _, r in spec.values())
    # every live count was k + 1: the 7-token request's second harvest
    # was cut after 2 of its 4 tokens
    assert all(int(c) in (0, k + 1) for row in counts for c in row)
    assert len(spec[0][0]) == 7 and (7 - 1) % (k + 1) != 0


def test_stochastic_speculative_streams_repeat_under_one_seed():
    def run():
        sched = SlotScheduler(_port("dense", 2, rng_seed=3),
                              registry=MetricsRegistry(), speculate_k=2)
        return _run(sched, [Request(prompt=[1, 2, 1, 2], max_new_tokens=9,
                                    temperature=0.9),
                            Request(prompt=[4, 4, 4], max_new_tokens=5,
                                    temperature=0.0)])

    a, b = run(), run()
    assert a == b
    assert [len(a[rid][0]) for rid in (0, 1)] == [9, 5]
    assert all(0 <= x < V for t, _ in a.values() for x in t)


def test_pool_exhaustion_mid_verify_equals_jax(jax_engines):
    """A 3-block prompt is refused at submit; a 4-token one grows to the
    pool's 8 tokens and retires ``"capacity"`` at the window the dry pool
    cannot map, its count 0 there."""
    je = _fresh(jax_engines["tiny_pool", 1])
    eng = _port("tiny_pool", 1)
    seen = []
    verify = eng.verify

    def recorded(*args, **kw):
        toks, c = verify(*args, **kw)
        seen.append((c.copy(), list(eng.last_failed)))
        return toks, c

    eng.verify = recorded
    sched = SlotScheduler(eng, registry=MetricsRegistry(), speculate_k=1)
    jsched = JaxScheduler(je, registry=JaxRegistry(), speculate_k=1)
    r, jr = (s.submit(cls(prompt=list(range(1, 13)), max_new_tokens=12))
             for s, cls in ((sched, Request), (jsched, JaxRequest)))
    assert isinstance(r, Rejection) and r.reason == "pool_exhausted"
    assert isinstance(jr, JaxRejection) and jr.reason == r.reason
    out = {}
    for s, cls in ((sched, Request), (jsched, JaxRequest)):
        rid = s.submit(cls(prompt=[1, 2, 3, 4], max_new_tokens=12))
        for _ in range(20):
            if not s.pending:
                break
            s.step()
        (comp,) = s.completed
        assert comp.request_id == rid
        out[cls] = (comp.tokens, comp.finish_reason)
    assert out[Request] == out[JaxRequest]
    assert out[Request][1] == "capacity"
    assert 1 <= len(out[Request][0]) < 12
    assert int(seen[-1][0][0]) == 0 and seen[-1][1] == [0]


# ---------------------------------------------------------------------------
# argument errors
# ---------------------------------------------------------------------------

def test_argument_errors_match_reference(jax_engines):
    jm, jp, _ = _weights()
    for engine, model, extra in ((JaxEngine, jm, (jp,)),
                                 (ServingEngine, _port("dense").model, ())):
        kw = dict(max_seqs=1, prefill_len=4)
        if engine is ServingEngine:
            kw["device"] = "cpu"
        with pytest.raises(ValueError, match="speculate_k must be >= 0"):
            engine(model, *extra, max_len=16, speculate_k=-1, **kw)
        with pytest.raises(ValueError, match="verify window"):
            engine(model, *extra, max_len=8, speculate_k=8, **kw)
    with pytest.raises(ValueError, match="speculative"):
        _port("dense").verify(np.zeros(2, np.int64), np.zeros((2, 1)),
                              np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="speculative"):
        _port("paged").verify(np.zeros(2, np.int64), np.zeros((2, 1)),
                              np.zeros(2, np.float32))
    for sched, reg, eng, plain in (
            (JaxScheduler, JaxRegistry, jax_engines["dense", 1], None),
            (SlotScheduler, MetricsRegistry, _port("dense", 1),
             _port("dense"))):
        with pytest.raises(ValueError, match="speculate_k"):
            sched(eng, registry=reg(), speculate_k=3)
        with pytest.raises(ValueError, match="draft_source"):
            sched(eng, registry=reg(), draft_source=NGramDraftSource())
        if plain is not None:
            with pytest.raises(ValueError, match="speculate_k"):
                sched(plain, registry=reg(), speculate_k=1)
