"""Port paged serving vs the JAX package's on the CPU, same inputs.

- ``paged_decode_attention``: the port's plain version against the JAX
  Pallas kernel in interpret mode at block size 32 (as
  ``tests/test_paged.py`` runs it), on scattered tables with lengths
  ``[0, 1, 100, 256]``. Tolerances: fp32 pools 2e-6 and int8 pools with
  fp32 q 2e-6 (both sides dequantize the same int8 values against the same
  scales; the sums differ by order only); bf16 5e-2 (both compute in fp32
  and round the output to bf16, one ulp at |x| < 4 is <= 0.016); lse 2e-6.
- ``PagedKVCache`` writes: stores of identically rounded values, so the
  pools must agree bit for bit (the null block excepted: several masked
  writes land there in an unspecified order on both sides).
- ``BlockAllocator``: the port's and the JAX one under one seeded random
  sequence of calls, state for state.
- ``PagedServingEngine`` and ``SlotScheduler`` at fp32 on the tiny GPT of
  ``tests/test_paged.py``: greedy streams and completions must EQUAL the
  JAX paged engine's and the port's dense engine's (an exact argmax over
  logits that agree to ~1e-6).
"""

import dataclasses
import functools
import importlib

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
from apex_tpu.serving import PoolExhausted as JaxPoolExhausted
from apex_tpu.serving import Rejection as JaxRejection
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import SlotScheduler as JaxScheduler
from apex_tpu.serving import paged_block_bytes as jax_block_bytes
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import (BlockAllocator, PagedKVCache,
                                    PagedServingEngine, PoolExhausted,
                                    Rejection, Request, ServingEngine,
                                    SlotScheduler, paged_block_bytes)
from apex_tpu_torch.serving.cache import NULL_BLOCK

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pcache = importlib.import_module("apex_tpu_torch.serving.cache")

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# paged_decode_attention vs the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

B, H, BS, NBS, D = 4, 2, 32, 8, 64      # per-slot span 256
NB = 34                                  # pool blocks (0 = null)
LENGTHS = np.array([0, 1, 100, 256], np.int32)


def _tables(rng):
    """Each slot's blocks scattered through the pool, never block 0."""
    perm = rng.permutation(np.arange(1, NB))
    return perm[: B * NBS].reshape(B, NBS).astype(np.int32)


def _pool_inputs(seed, pool, q_len=None):
    rng = np.random.RandomState(seed)
    qshape = (B, H, D) if q_len is None else (B, H, q_len, D)
    qdt = "bfloat16" if pool == "bfloat16" else "float32"
    jq, tq = _both(rng.randn(*qshape), qdt)
    kf = rng.randn(NB, H, BS, D).astype(np.float32)
    vf = rng.randn(NB, H, BS, D).astype(np.float32)
    ej, et = {}, {}
    if pool == "int8":
        kq, ks = pcache._quantize(torch.from_numpy(kf))
        vq, vs = pcache._quantize(torch.from_numpy(vf))
        jk, jv, tk, tv = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                          kq, vq)
        ej = {"k_scale": jnp.asarray(ks.numpy()),
              "v_scale": jnp.asarray(vs.numpy())}
        et = {"k_scale": ks, "v_scale": vs}
    else:
        jk, tk = _both(kf, pool)
        jv, tv = _both(vf, pool)
    return (jq, jk, jv, ej), (tq, tk, tv, et), qdt, _tables(rng), rng


def _tol(qdt):
    return 5e-2 if qdt == "bfloat16" else 2e-6


@pytest.mark.parametrize("with_new", [False, True])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_decode_matches_jax_kernel(pool, with_new):
    (jq, jk, jv, ej), (tq, tk, tv, et), qdt, tables, rng = _pool_inputs(
        0, pool)
    if with_new:
        jkn, tkn = _both(rng.randn(B, H, D), qdt)
        jvn, tvn = _both(rng.randn(B, H, D), qdt)
        ej = dict(ej, k_new=jkn, v_new=jvn)
        et = dict(et, k_new=tkn, v_new=tvn)
    ref = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(LENGTHS), use_pallas=True,
                                     **ej)
    out = pfa.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(LENGTHS), **et)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(qdt))
    if not with_new:
        assert np.all(_f32(out)[0] == 0)      # empty prefix: exactly zero
    elif qdt == "float32":
        # empty prefix + current token: softmax over one position
        np.testing.assert_array_equal(_f32(out)[0], _f32(et["v_new"])[0])


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_paged_decode_multi_row_matches_jax_kernel(pool):
    (jq, jk, jv, _), (tq, tk, tv, _), qdt, tables, _ = _pool_inputs(
        1, pool, q_len=3)
    ref = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(LENGTHS), use_pallas=True)
    out = pfa.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(LENGTHS))
    assert out.shape == (B, H, 3, D)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(qdt))


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_paged_plain_lse_matches_jax_kernel(pool):
    """The kernel-layout plain version, ``(out, lse)`` on ``(b*h, q_len,
    d)``, against the Pallas call's own outputs."""
    (jq, jk, jv, ej), (tq, tk, tv, et), _, tables, _ = _pool_inputs(
        2, pool, q_len=2)
    j_out, j_lse = jfa._paged_decode_pallas(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
        ej.get("k_scale"), ej.get("v_scale"), scale=D ** -0.5,
        mean_context=None)
    out, lse = pfa._paged_decode_plain(
        tq.reshape(B * H, 2, D), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(LENGTHS), et.get("k_scale"), et.get("v_scale"))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j_out).reshape(B * H, 2, D),
                               atol=2e-6)
    j_lse = np.asarray(j_lse).reshape(B * H, 2)
    empty = np.repeat(LENGTHS, H) == 0
    assert np.all(lse.numpy()[empty] == -np.inf)
    assert np.all(j_lse[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], j_lse[~empty],
                               atol=2e-6)


def test_paged_plain_ignores_unmapped_blocks_nan_and_garbage_ids():
    """Table entries past ceil(length / block) may be stale or garbage,
    and blocks no cursor covers may hold anything, NaN included: the
    output equals the clean one bit for bit, and the JAX kernel's."""
    (jq, jk, jv, _), (tq, tk, tv, _), _, tables, _ = _pool_inputs(
        3, "float32")
    lengths = np.array([40, 0, 33, 64], np.int32)       # 2, 0, 2, 2 blocks
    clean = pfa.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                       torch.from_numpy(lengths))
    ref = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(lengths), use_pallas=True)
    np.testing.assert_allclose(clean.numpy(), np.asarray(ref), atol=2e-6)
    used = {int(b) for s, n in enumerate(lengths)
            for b in tables[s, : -(-int(n) // BS)]}
    kp, vp = tk.clone(), tv.clone()
    for blk in range(NB):
        if blk not in used:
            kp[blk] = float("nan")
            vp[blk] = float("inf")
    garbage = tables.copy()
    garbage[:, 2:] = 10 ** 6                             # no such block
    garbage[1] = -5
    out = pfa.paged_decode_attention(tq, kp, vp, torch.from_numpy(garbage),
                                     torch.from_numpy(lengths))
    assert torch.equal(out, clean)


def test_paged_decode_argument_errors():
    q = torch.zeros(1, 2, 64)
    pool = torch.zeros(3, 2, 4, 64)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale"):
        pfa.paged_decode_attention(q, pool.to(torch.int8),
                                   pool.to(torch.int8), tables, lens)
    with pytest.raises(ValueError, match="pool shapes"):
        pfa.paged_decode_attention(q[..., :32], pool, pool, tables, lens)
    with pytest.raises(ValueError, match="block_tables"):
        pfa.paged_decode_attention(q, pool, pool, tables[0], lens)
    # the verify rows' in-flight keys and values must have q's shape
    with pytest.raises(ValueError, match="v_new shape"):
        pfa.paged_decode_attention(q[:, :, None], pool, pool, tables, lens,
                                   k_new=q[:, :, None], v_new=q)
    with pytest.raises(ValueError, match="v_cast shape"):
        pfa.paged_decode_attention(q[:, :, None], pool, pool, tables, lens,
                                   k_new=q[:, :, None], v_new=q[:, :, None],
                                   v_cast=q[:, :, None, :32])
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        pfa.paged_decode_attention(q, pool, pool, tables, lens,
                                   use_kernel=True)


# ---------------------------------------------------------------------------
# PagedKVCache writes vs the JAX pool, bit for bit
# ---------------------------------------------------------------------------

def _assert_pools_equal(jc, pc):
    names = ("k", "v") + (("k_scale", "v_scale") if pc.quantized else ())
    for name in names:
        a = np.asarray(getattr(jc, name).astype(jnp.float32))
        b = getattr(pc, name).float().numpy()
        # the null block absorbs repeated masked writes in any order
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_cache_writes_match_jax(dtype):
    L, NBk, Hk, bs, Dk, S = 2, 7, 3, 4, 8, 3
    rng = np.random.RandomState(0)
    jc = JaxPagedKVCache.create(L, NBk, Hk, bs, Dk, dtype=JDT[dtype])
    pc = PagedKVCache.create(L, NBk, Hk, bs, Dk, dtype=TDT[dtype],
                             device="cpu")
    assert pc.nbytes() == jc.nbytes()
    _assert_pools_equal(jc, pc)
    # prompts of 8 and 5 tokens into blocks (3, 5) and (6, null)
    for row in ([3, 5], [6, NULL_BLOCK]):
        k = rng.randn(L, Hk, 2 * bs, Dk).astype(np.float32)
        v = rng.randn(L, Hk, 2 * bs, Dk).astype(np.float32)
        jc = jc.write_prompt_blocks(jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(row, jnp.int32))
        pc.write_prompt_blocks(torch.from_numpy(k), torch.from_numpy(v),
                               np.asarray(row, np.int32))
        _assert_pools_equal(jc, pc)
    # appends: two masked slots share the null block
    for ids, offs in (([5, NULL_BLOCK, NULL_BLOCK], [0, 0, 0]),
                      ([5, 6, NULL_BLOCK], [1, 1, 3]),
                      ([2, 6, 1], [3, 2, 0])):
        kn = rng.randn(L, S, Hk, Dk).astype(np.float32)
        vn = rng.randn(L, S, Hk, Dk).astype(np.float32)
        jc = jc.append(jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(ids, jnp.int32),
                       jnp.asarray(offs, jnp.int32))
        pc.append(torch.from_numpy(kn), torch.from_numpy(vn),
                  np.asarray(ids, np.int32), np.asarray(offs, np.int32))
        _assert_pools_equal(jc, pc)
    # copy-on-write: a real pair beside the null no-op pairs
    for src, dst in (([5, 0, 0], [4, 0, 0]), ([0, 3, 6], [0, 2, 1])):
        jc = jc.cow_copy(jnp.asarray(src, jnp.int32),
                         jnp.asarray(dst, jnp.int32))
        pc.cow_copy(np.asarray(src, np.int32), np.asarray(dst, np.int32))
        _assert_pools_equal(jc, pc)
    assert torch.equal(pc.k[:, 4], pc.k[:, 5])


def test_paged_cache_in_place_scrub_and_bytes():
    pc = PagedKVCache.create(2, 4, 2, 4, 8, dtype=torch.int8, device="cpu")
    ptrs = [t.data_ptr() for t in pc._leaves()]
    ones = torch.ones(2, 2, 2, 8)
    pc.append(ones, ones, [NULL_BLOCK, 2], [1, 3])
    pc.write_prompt_blocks(torch.ones(2, 2, 8, 8), torch.ones(2, 2, 8, 8),
                           [1, NULL_BLOCK])
    pc.cow_copy([1], [3])
    assert [t.data_ptr() for t in pc._leaves()] == ptrs
    assert pc.k[:, NULL_BLOCK].abs().sum() > 0
    pc.scrub_null_block()
    assert pc.k[:, NULL_BLOCK].abs().sum() == 0
    assert bool((pc.k_scale[:, NULL_BLOCK] == pcache._MIN_SCALE).all())
    assert pc.k[:, 3].abs().sum() > 0
    for dtype in ("float32", "bfloat16", "int8"):
        assert paged_block_bytes(12, 12, 128, 64, TDT[dtype]) == \
            jax_block_bytes(12, 12, 128, 64, JDT[dtype])
    with pytest.raises(ValueError, match="num_blocks must be >= 2"):
        PagedKVCache.create(1, 1, 1, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        pc.write_prompt_blocks(torch.ones(2, 2, 6, 8),
                               torch.ones(2, 2, 6, 8), [1, 2])


# ---------------------------------------------------------------------------
# BlockAllocator: differential test against the JAX allocator
# ---------------------------------------------------------------------------

def _assert_alloc_same(ja, pa, what):
    np.testing.assert_array_equal(ja.tables, pa.tables, err_msg=what)
    np.testing.assert_array_equal(ja.lengths, pa.lengths, err_msg=what)
    np.testing.assert_array_equal(ja.refcount, pa.refcount, err_msg=what)
    for name in ("free_blocks", "cow_copies", "prefix_hits",
                 "prefix_hit_tokens"):
        assert getattr(ja, name) == getattr(pa, name), (what, name)


def _call_both(ja, pa, method, *args):
    """Call ``method`` on both allocators; both must return equal results
    or raise the same way."""
    out = []
    for alloc, exhausted in ((ja, JaxPoolExhausted), (pa, PoolExhausted)):
        try:
            out.append(("ok", getattr(alloc, method)(*args)))
        except exhausted:
            out.append(("exhausted", None))
        except ValueError:
            out.append(("value", None))
    (jk, jr), (pk, pr) = out
    assert jk == pk, (method, args, out)
    return jk, jr, pr


def _same_result(jr, pr, what):
    if jr is None:
        assert pr is None, what
    elif isinstance(jr, tuple):
        for a, b in zip(jr, pr):
            np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        a, b = dataclasses.asdict(jr), dataclasses.asdict(pr)
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{what} {key}")
            else:
                assert a[key] == b[key], (what, key, a[key], b[key])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_matches_jax_state_for_state(seed):
    """One seeded random sequence of admit (shared prompts and cold),
    register_prefix, prepare_step / prepare_verify, append_targets /
    verify_targets, advance / advance_counts and release on both
    allocators: every result and the whole state agree after every call."""
    rng = np.random.RandomState(seed)
    num_blocks, bs, per_slot, slots = 12, 4, 5, 4
    ja = JaxAllocator(num_blocks, bs, per_slot, slots)
    pa = BlockAllocator(num_blocks, bs, per_slot, slots)
    bases = [rng.randint(0, 9, 20).tolist() for _ in range(3)]
    prompts = {}
    for step in range(150):
        occupied = sorted(prompts)
        op = rng.choice(["admit", "step", "verify", "release"],
                        p=[0.35, 0.35, 0.1, 0.2])
        what = f"seed {seed} step {step} {op}"
        if op == "admit":
            slot = int(rng.randint(slots))
            base = bases[rng.randint(3)]
            # whole blocks half the time: full-cover hits, then COW
            n = int(rng.choice([4, 8, 12]) if rng.rand() < 0.5
                    else rng.randint(1, 13))
            prompt = (base[:n] if rng.rand() < 0.7
                      else rng.randint(0, 9, n).tolist())
            kind, jr, pr = _call_both(ja, pa, "admit", slot, prompt, 3,
                                      bool(rng.rand() < 0.9))
            if kind == "ok":
                _same_result(jr, pr, what)
                prompts[slot] = prompt
                if jr.prefill:
                    _call_both(ja, pa, "register_prefix", slot, prompt)
        elif op in ("step", "verify") and occupied:
            active = [s for s in occupied if rng.rand() < 0.8]
            mask = np.zeros(slots, bool)
            mask[active] = True
            k = 1 if op == "step" else int(rng.randint(2, 5))
            kind, jr, pr = _call_both(
                ja, pa, "prepare_step" if k == 1 else "prepare_verify",
                active, *(() if k == 1 else (k,)))
            _same_result((jr.cow_src, jr.cow_dst), (pr.cow_src, pr.cow_dst),
                         what)
            assert jr.failed == pr.failed, what
            mask[jr.failed] = False
            if k == 1:
                _, jt, pt = _call_both(ja, pa, "append_targets", mask)
                _same_result(jt, pt, what)
                _call_both(ja, pa, "advance", list(np.flatnonzero(mask)))
            else:
                _, jt, pt = _call_both(ja, pa, "verify_targets", mask, k)
                _same_result(jt, pt, what)
                counts = rng.randint(1, k + 1, slots).tolist()
                okidx = list(np.flatnonzero(mask))
                _call_both(ja, pa, "advance_counts", okidx,
                           [counts[s] for s in okidx])
        elif op == "release" and occupied:
            slot = occupied[rng.randint(len(occupied))]
            _call_both(ja, pa, "release", slot)
            del prompts[slot]
        _assert_alloc_same(ja, pa, what)
        for base in bases:
            assert ja.lookup(base) == pa.lookup(base), what
    assert ja.prefix_hits > 0 and ja.cow_copies > 0


def test_allocator_checks_ids_on_the_host():
    a = BlockAllocator(6, 4, 3, 2)
    a.admit(0, list(range(6)), prefill_blocks=2)
    a.tables[1, 0] = 99                          # corrupted mirror
    a.lengths[1] = 1
    with pytest.raises(AssertionError, match="block id outside"):
        a.append_targets(np.array([True, True]))


# ---------------------------------------------------------------------------
# PagedServingEngine and SlotScheduler vs the JAX paged engine, fp32
# ---------------------------------------------------------------------------

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=64)
ENGINES = {  # name -> engine arguments (tests/test_paged.py's configs)
    "default": dict(max_seqs=2, max_len=24, prefill_len=8, num_blocks=16,
                    block_size=4),
    "small_pool": dict(max_seqs=2, max_len=16, prefill_len=16, num_blocks=4,
                       block_size=4),
    "tiny_pool": dict(max_seqs=1, max_len=16, prefill_len=4, num_blocks=3,
                      block_size=4),
}


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX paged engine per configuration for the module: each
    construction compiles three programs. :func:`_fresh` resets one to an
    empty pool before a test."""
    jm, jp, _ = _weights()
    return {name: JaxPagedEngine(jm, jp, cache_dtype=jnp.float32, **kw)
            for name, kw in ENGINES.items()}


def _fresh(eng):
    """An empty pool and allocator for a JAX paged engine.

    The JAX engine's ``decode`` hands the allocator's live numpy
    ``tables``/``lengths`` to an asynchronous dispatch (``jnp.asarray`` on
    the CPU may alias a numpy buffer rather than copy it) and advances the
    cursors in place before the step has surely read them, so a step can
    read the next step's cursor. Here the allocator's ``advance`` first
    waits for the step's outputs, which makes the reference's streams
    repeatable."""
    eng.cache = JaxPagedKVCache.create(
        eng.model.cfg.num_layers, eng.num_blocks,
        eng.model.cfg.num_attention_heads, eng.block_size,
        eng.model.cfg.head_dim, dtype=jnp.float32)
    alloc = JaxAllocator(eng.num_blocks, eng.block_size,
                         eng.allocator.blocks_per_slot, eng.max_seqs)
    advance = alloc.advance

    def synced_advance(slots):
        jax.block_until_ready(eng.cache)
        advance(slots)

    alloc.advance = synced_advance
    eng.allocator = alloc
    return eng


def _port_model():
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(_weights()[2], cfg))
    return model


def _port_paged(name="default", cache_dtype=torch.float32):
    return PagedServingEngine(_port_model(), cache_dtype=cache_dtype,
                              device="cpu", **ENGINES[name])


def _port_dense(name="default", cache_dtype=torch.float32):
    kw = {k: v for k, v in ENGINES[name].items()
          if k not in ("num_blocks", "block_size")}
    return ServingEngine(_port_model(), cache_dtype=cache_dtype,
                         device="cpu", **kw)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 97, n).tolist()


def _greedy(eng, slot, first, steps):
    """``steps`` greedy decode steps of ``slot`` alone."""
    active = np.zeros(eng.max_seqs, bool)
    active[slot] = True
    toks = np.zeros(eng.max_seqs, np.int64)
    temps = np.zeros(eng.max_seqs, np.float32)
    stream = [first]
    for _ in range(steps):
        toks[slot] = stream[-1]
        stream.append(int(eng.decode(toks, temps, active)[slot]))
    return stream


def test_engine_greedy_streams_equal_jax_and_dense(jax_engines):
    je = _fresh(jax_engines["default"])
    pe, de = _port_paged(), _port_dense()
    prompts = [_prompt(1, 7), _prompt(2, 3)]
    tokens = np.zeros(2, np.int64)
    for slot, p in enumerate(prompts):
        a, b, c = je.prefill(p, slot), pe.prefill(p, slot), de.prefill(p,
                                                                        slot)
        assert a == b == c, f"slot {slot} first token"
        tokens[slot] = a
    temps = np.zeros(2, np.float32)
    for step in range(12):          # both slots cross block boundaries
        a = je.decode(tokens, temps)
        b = pe.decode(tokens, temps)
        c = de.decode(tokens, temps)
        np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        np.testing.assert_array_equal(b, c, err_msg=f"step {step}")
        tokens = b.astype(np.int64)
    np.testing.assert_array_equal(pe.allocator.tables, je.allocator.tables)
    assert pe.allocator.lengths.tolist() == [19, 15] == \
        de.cache.lengths.tolist()


def test_prefix_hit_stream_equals_cold_stream_and_jax(jax_engines):
    je = _fresh(jax_engines["default"])
    pe = _port_paged()
    prompt = [5, 9, 1, 33, 7, 21, 2, 40]
    cold = _greedy(pe, 0, pe.prefill(prompt, 0), 5)
    assert pe.last_admit.prefill
    jcold = _greedy(je, 0, je.prefill(prompt, 0), 5)
    # the same prompt admits into slot 1 as a full-cover prefix hit (COW)
    shared = _greedy(pe, 1, pe.prefill(prompt, 1), 5)
    plan = pe.last_admit
    assert not plan.prefill and plan.shared_tokens == len(prompt) - 1
    assert plan.cow_pending and pe.allocator.cow_copies == 1
    jshared = _greedy(je, 1, je.prefill(prompt, 1), 5)
    assert shared == cold == jshared == jcold
    # a partial hit: the first block shared, the tail decoded
    tail = prompt[:4] + [11, 12]
    pe.release_slot(1)
    je.release_slot(1)
    a = _greedy(pe, 1, pe.prefill(tail, 1), 3)
    assert pe.last_admit.shared_tokens == 4 and not pe.last_admit.prefill
    b = _greedy(je, 1, je.prefill(tail, 1), 3)
    assert a == b
    _assert_alloc_same(je.allocator, pe.allocator, "after the hits")


def _mix(seed):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, 97, 8).tolist()
    specs = [(shared, 4), (rs.randint(1, 97, 5).tolist(), 6), (shared, 3),
             (shared[:4] + [3, 3], 5), (rs.randint(1, 97, 2).tolist(), 9),
             (shared, 2), (rs.randint(1, 97, 8).tolist(), 7)]
    return specs


def test_scheduler_completions_equal_jax_and_dense(jax_engines):
    je = _fresh(jax_engines["default"])
    pe, de = _port_paged(), _port_dense()
    specs = _mix(3)
    jreg, preg = JaxRegistry(), MetricsRegistry()
    jdone = JaxScheduler(je, registry=jreg).run(
        [JaxRequest(prompt=p, max_new_tokens=m) for p, m in specs])
    psched = SlotScheduler(pe, registry=preg)
    pdone = psched.run([Request(prompt=p, max_new_tokens=m)
                        for p, m in specs])
    ddone = SlotScheduler(de, registry=MetricsRegistry()).run(
        [Request(prompt=p, max_new_tokens=m) for p, m in specs])
    assert sorted(pdone) == sorted(jdone) == sorted(ddone) == \
        list(range(len(specs)))
    for rid in jdone:
        assert pdone[rid].tokens == jdone[rid].tokens == ddone[rid].tokens
        assert pdone[rid].finish_reason == jdone[rid].finish_reason == \
            ddone[rid].finish_reason == "length"
    for name in ("serve/admitted", "serve/retired", "serve/decode_steps",
                 "serve/generated_tokens", "serve/prefill_tokens",
                 "serve/prefix_hits", "serve/prefix_hit_tokens",
                 "serve/blocks_cow_copied"):
        assert preg.counter(name).value == jreg.counter(name).value, name
    assert preg.counter("serve/prefix_hits").value >= 2
    assert preg.counter("serve/blocks_cow_copied").value >= 1
    assert preg.histogram("serve/ttft_prefix_ms").count == \
        preg.counter("serve/prefix_hits").value
    for name in ("serve/pool_blocks_free", "serve/pool_blocks_used",
                 "serve/pool_utilization"):
        assert preg.gauge(name).value == jreg.gauge(name).value, name
    assert pe.allocator.free_blocks == pe.num_blocks - 1
    assert psched.pending == 0 and sorted(psched.free) == [0, 1]


def test_pool_exhausted_rejection_and_queueing_equal_jax(jax_engines):
    je = _fresh(jax_engines["small_pool"])
    pe = _port_paged("small_pool")
    runs = []
    for eng, sched_cls, req_cls, reg, rej in (
            (je, JaxScheduler, JaxRequest, JaxRegistry(), JaxRejection),
            (pe, SlotScheduler, Request, MetricsRegistry(), Rejection)):
        sched = sched_cls(eng, registry=reg)
        r = sched.submit(req_cls(prompt=list(range(1, 17)),
                                 max_new_tokens=1))
        assert isinstance(r, rej) and r.reason == "pool_exhausted"
        assert not r
        # two 8-token prompts want 2 blocks each plus a decode block, and
        # the pool has 3: the second waits at the head of the queue
        ids = [sched.submit(req_cls(prompt=p, max_new_tokens=2))
               for p in ([1, 2, 3, 4, 5, 6, 7, 8],
                         [11, 12, 13, 14, 15, 16, 17, 18])]
        queued = []
        for _ in range(30):
            if not sched.pending:
                break
            sched.step()
            queued.append(len(sched.queue))
        runs.append(([(c.request_id, c.tokens, c.finish_reason)
                      for c in sched.completed], queued,
                     reg.counter("serve/rejected").value))
    assert runs[0] == runs[1]
    (done, queued, rejected) = runs[1]
    assert {c[0] for c in done} == {0, 1} and rejected == 1
    assert queued[0] == 1                 # pool pressure queued request 1


def test_capacity_retirement_mid_decode_equals_jax(jax_engines):
    je = _fresh(jax_engines["tiny_pool"])
    pe = _port_paged("tiny_pool")
    out = []
    for eng, sched_cls, req_cls, reg in (
            (je, JaxScheduler, JaxRequest, JaxRegistry()),
            (pe, SlotScheduler, Request, MetricsRegistry())):
        sched = sched_cls(eng, registry=reg)
        sched.submit(req_cls(prompt=[1, 2, 3, 4], max_new_tokens=12))
        for _ in range(20):
            if not sched.pending:
                break
            sched.step()
        (comp,) = sched.completed
        out.append((comp.tokens, comp.finish_reason))
    assert out[0] == out[1]
    tokens, reason = out[1]
    # the pool ran dry before max_new_tokens: a loud capacity retirement
    assert reason == "capacity" and 1 <= len(tokens) < 12
    assert pe.allocator.free_blocks == 2


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_paged_logits_equal_dense_logits(cache_dtype):
    """The paged engine stores the same rounded K/V as the dense engine
    and the plain versions read them alike: the logits agree to fp32
    summation order (1e-5), bf16 and int8 caches included."""
    pe = _port_paged(cache_dtype=TDT[cache_dtype])
    de = _port_dense(cache_dtype=TDT[cache_dtype])
    toks = np.zeros(2, np.int64)
    for slot, p in enumerate([_prompt(5, 8), _prompt(6, 6)]):
        a, b = pe.prefill_logits(p, slot), de.prefill_logits(p, slot)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        toks[slot] = int(a.argmax())
    for _ in range(6):
        a, b = pe.decode_logits(toks), de.decode_logits(toks)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        toks = a.argmax(-1).numpy()


def test_engine_release_capacity_and_errors(jax_engines):
    pe = _port_paged()
    je = jax_engines["default"]
    assert pe.block_bytes() == je.block_bytes()
    hbm = 16 * 2 ** 30
    params = sum(t.numel() * 4 for t in pe.model.state_dict().values())
    assert pe.suggest_pool_blocks(hbm, mean_len=128) == \
        (int(hbm * 0.9) - params) // pe.block_bytes()
    for blocks, mean in ((129, 128.0), (129, 256.0), (7, 3.0)):
        assert pe.suggest_max_seqs_for_pool(blocks, mean) == \
            je.suggest_max_seqs_for_pool(blocks, mean)
    pe.prefill(_prompt(7, 5), 0)
    pe.decode(np.zeros(2, np.int64), np.zeros(2, np.float32),
              np.array([True, False]))
    assert pe.cache.k[:, NULL_BLOCK].abs().sum() > 0    # slot 1's write
    assert not pe.can_admit(list(range(61)))
    pe.release_slot(0)
    assert pe.cache.k[:, NULL_BLOCK].abs().sum() == 0
    assert pe.allocator.free_blocks == 15
    with pytest.raises(ValueError, match="multiple of block_size"):
        PagedServingEngine(_port_model(), max_seqs=1, max_len=24,
                           prefill_len=6, num_blocks=8, block_size=4,
                           device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        PagedServingEngine(_port_model(), max_seqs=1, max_len=8,
                           prefill_len=16, num_blocks=8, block_size=4,
                           device="cpu")
    with pytest.raises(ValueError, match="exceeds the prefill window"):
        pe.prefill(list(range(1, 10)), 1)
    with pytest.raises(ValueError, match="out of range"):
        pe.prefill([1], 2)
    assert pe.allocator.free_blocks == 15        # nothing was admitted
