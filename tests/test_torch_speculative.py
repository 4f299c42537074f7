"""Port speculative decoding's pieces vs the JAX package's on the CPU.

The same seeded numpy inputs go through the JAX function and its port:

- ``_merge_drafts`` (the verify step's causal LSE merge, plain on both
  sides) at q_len 1-5 and d 8 and 64 with empty-prefix rows, atol 1e-6
  (fp32 sums in another order); at q_len 1 it equals ``_merge_current``;
- rank-4 ``decode_attention`` and ``paged_decode_attention`` with
  ``k_new``/``v_new``/``k_cast``/``v_cast`` against the JAX Pallas kernels
  in interpret mode plus the JAX merge (as ``tests/test_paged.py`` runs
  them), fp32 q over fp32, bf16 and int8 caches: both sides read the same
  cache values and merge in fp32, so 1e-5;
- ``verify_tokens``: greedy equal to JAX's (an exact argmax), and the
  reference's stochastic properties (``tests/test_speculative.py``), which
  the port's generator cannot match draw for draw: a sure draft always
  accepts, a rejection never emits the draft, the first token's marginal
  follows the model within 0.07, ``top_k=1`` is greedy;
- ``NGramDraftSource``: equal to JAX's on the reference's cases and on
  random contexts (host logic, exact);
- ``KVCache.append_k`` and ``PagedKVCache.append_k``: stores of identically
  rounded values, so bit for bit (the null block excepted, where masked
  rows land in any order);
- ``GPTModel.verify_forward`` over random dense and paged caches at a tiny
  config in fp32: logits and the window's K/V within 1e-5.
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
from apex_tpu.serving import DraftSource as JaxDraftSource
from apex_tpu.serving import KVCache as JaxKVCache
from apex_tpu.serving import NGramDraftSource as JaxNGram
from apex_tpu.serving import PagedKVCache as JaxPagedKVCache
from apex_tpu.serving import verify_tokens as jax_verify_tokens
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import (BlockAllocator, DraftSource, KVCache,
                                    NGramDraftSource, PagedKVCache,
                                    store_roundtrip, verify_tokens)
from apex_tpu_torch.serving.cache import NULL_BLOCK
from apex_tpu_torch.serving.sampling import _mask_top_k, sample_tokens

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
jcache = importlib.import_module("apex_tpu.serving.cache")

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def _t(arr):
    return torch.from_numpy(np.array(arr))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# _merge_drafts
# ---------------------------------------------------------------------------

def _merge_inputs(seed, q_len, d, b=3, h=2):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, q_len, d).astype(np.float32) for _ in range(6)]
    lse = (rng.randn(b, h, q_len) * 3).astype(np.float32)
    lse[0] = -np.inf                       # slot 0: an empty prefix
    lse[1, 0, 0] = -np.inf
    return arrs, lse


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("q_len", [1, 2, 3, 4, 5])
def test_merge_drafts_matches_jax(q_len, d):
    (out, q, kn, vn, kc, vc), lse = _merge_inputs(q_len * 10 + d, q_len, d)
    scale = d ** -0.5
    ref = jfa._merge_drafts(*(jnp.asarray(a) for a in (out, lse, q, kn, vn,
                                                        kc, vc)),
                            scale, jnp.float32)
    got = pfa._merge_drafts(*(_t(a) for a in (out, lse, q, kn, vn, kc, vc)),
                            scale, torch.float32)
    assert got.shape == (3, 2, q_len, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if q_len == 1:
        cur = pfa._merge_current(_t(out[:, :, 0]), _t(lse[:, :, 0]),
                                 _t(q[:, :, 0]), _t(kn[:, :, 0]),
                                 _t(vn[:, :, 0]), scale, torch.float32)
        assert torch.equal(got[:, :, 0], cur)
    # an empty prefix gives the prefix no weight: row 0 is exactly v_new
    np.testing.assert_allclose(got.numpy()[0, :, 0], vn[0, :, 0],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# rank-4 decode attention with the in-flight rows merged
# ---------------------------------------------------------------------------

B, H, T, D, Q = 4, 2, 128, 64, 5
LENGTHS = np.array([0, 1, 77, 123], np.int32)
BS, NBS, NB = 32, 4, 18                 # paged: span 128, 17 real blocks


def _cache_arrays(rng, cache, shape):
    """Random cache contents of ``shape`` stored as ``cache``: the JAX
    leaves and the same values as torch tensors (k, v, and the scales of
    an int8 cache)."""
    kf = rng.randn(*shape).astype(np.float32)
    vf = rng.randn(*shape).astype(np.float32)
    if cache == "int8":
        kq, ks = jcache._quantize(jnp.asarray(kf))
        vq, vs = jcache._quantize(jnp.asarray(vf))
        j = (kq, vq, ks, vs)
        return j, tuple(_t(a) for a in j)
    j = (jnp.asarray(kf, JDT[cache]), jnp.asarray(vf, JDT[cache]))
    return j, tuple(_t(np.asarray(a.astype(jnp.float32))).to(TDT[cache])
                    for a in j)


def _in_flight(rng, cache, b):
    """q, k_new, v_new (fp32) and the cache images k_cast, v_cast, as
    JAX arrays and torch tensors."""
    q, kn, vn = (rng.randn(b, H, Q, D).astype(np.float32) for _ in range(3))
    quant = cache == "int8"
    jx = [jnp.asarray(a) for a in (q, kn, vn)]
    jx += [jcache.store_roundtrip(a, JDT[cache], quant) for a in jx[1:]]
    tx = [_t(a) for a in (q, kn, vn)]
    tx += [store_roundtrip(a, TDT[cache], quant) for a in tx[1:]]
    for a, b_ in zip(jx[3:], tx[3:]):
        np.testing.assert_array_equal(_np(a), _np(b_))
    return jx, tx


def _named(arrs):
    return dict(zip(("k_new", "v_new", "k_cast", "v_cast"), arrs))


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_verify_rows_match_jax(cache):
    rng = np.random.RandomState(1)
    jc, tc = _cache_arrays(rng, cache, (B, H, T, D))
    jx, tx = _in_flight(rng, cache, B)
    jsc = dict(zip(("k_scale", "v_scale"), jc[2:]))
    tsc = dict(zip(("k_scale", "v_scale"), tc[2:]))
    ref = jfa.decode_attention(jx[0], jc[0], jc[1], jnp.asarray(LENGTHS),
                               use_pallas=True, **_named(jx[1:]), **jsc)
    got = pfa.decode_attention(tx[0], tc[0], tc[1], _t(LENGTHS),
                               **_named(tx[1:]), **tsc)
    assert got.shape == (B, H, Q, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
    # empty prefix, first row: softmax over itself alone
    np.testing.assert_array_equal(got.numpy()[0, :, 0],
                                  tx[2].numpy()[0, :, 0])


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_paged_decode_verify_rows_match_jax(cache):
    rng = np.random.RandomState(2)
    jc, tc = _cache_arrays(rng, cache, (NB, H, BS, D))
    jx, tx = _in_flight(rng, cache, B)
    tables = (rng.permutation(np.arange(1, NB))[: B * NBS]
              .reshape(B, NBS).astype(np.int32))
    jsc = dict(zip(("k_scale", "v_scale"), jc[2:]))
    tsc = dict(zip(("k_scale", "v_scale"), tc[2:]))
    ref = jfa.paged_decode_attention(
        jx[0], jc[0], jc[1], jnp.asarray(tables), jnp.asarray(LENGTHS),
        use_pallas=True, **_named(jx[1:]), **jsc)
    got = pfa.paged_decode_attention(tx[0], tc[0], tc[1], _t(tables),
                                     _t(LENGTHS), **_named(tx[1:]), **tsc)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
    # the paged read equals the dense read of the gathered cache
    gathered = [c[_t(tables).long()].transpose(1, 2).reshape(
        B, H, NBS * BS, *c.shape[3:]) for c in tc]
    want = pfa.decode_attention(tx[0], gathered[0], gathered[1],
                                _t(LENGTHS), **_named(tx[1:]),
                                **dict(zip(("k_scale", "v_scale"),
                                           gathered[2:])))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# verify_tokens
# ---------------------------------------------------------------------------

def _greedy_case(seed, S=6, Qv=4, V=11):
    """Random logits, and drafts that follow the argmax for a random
    prefix of each row, then stray."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(S, Qv, V).astype(np.float32)
    drafts = logits[:, :-1].argmax(-1)
    for s in range(S):
        cut = rng.randint(0, Qv)
        drafts[s, cut:] = (drafts[s, cut:] + rng.randint(1, V,
                                                         Qv - 1 - cut)) % V
    return logits, drafts.astype(np.int32)


@pytest.mark.parametrize("top_k", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_tokens_greedy_equals_jax(seed, top_k):
    logits, drafts = _greedy_case(seed)
    temps = np.zeros(len(logits), np.float32)
    jt, ja = jax_verify_tokens(jnp.asarray(logits), jnp.asarray(drafts),
                               jax.random.PRNGKey(seed), jnp.asarray(temps),
                               top_k)
    pt, pa = verify_tokens(_t(logits), _t(drafts),
                           torch.Generator().manual_seed(seed), _t(temps),
                           top_k)
    assert pt.dtype == torch.int32 and pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert 0 < pa.sum() < drafts.size          # some accept, some reject


class TestVerifyTokensRule:
    """The reference's ``tests/test_speculative.py::TestVerifyTokens``."""

    V = 7

    def _chain_logits(self, argmaxes):
        out = np.zeros((1, len(argmaxes), self.V), np.float32)
        for i, t in enumerate(argmaxes):
            out[0, i, t] = 5.0
        return torch.from_numpy(out)

    @pytest.mark.parametrize("drafts,want_accepted,want_emit", [
        ([2, 4], 2, [2, 4, 1]),
        ([2, 3], 1, [2, 4]),
        ([3, 4], 0, [2]),
    ])
    def test_greedy_exact_prefix(self, drafts, want_accepted, want_emit):
        toks, accepted = verify_tokens(
            self._chain_logits([2, 4, 1]), torch.tensor([drafts]),
            torch.Generator().manual_seed(0), torch.zeros(1))
        assert int(accepted[0]) == want_accepted
        assert toks[0, : want_accepted + 1].tolist() == want_emit

    def test_stochastic_sure_draft_always_accepts(self):
        logits = self._chain_logits([2, 4, 1]) * 20.0
        gen = torch.Generator().manual_seed(0)
        for _ in range(5):
            toks, accepted = verify_tokens(logits, torch.tensor([[2, 4]]),
                                           gen, torch.ones(1))
            assert int(accepted[0]) == 2
            assert toks[0, :2].tolist() == [2, 4]

    def test_stochastic_rejection_never_emits_the_draft(self):
        logits = torch.zeros(1, 2, self.V)
        logits[0, :, 3] = -1e9
        gen = torch.Generator().manual_seed(0)
        for _ in range(8):
            toks, accepted = verify_tokens(logits, torch.tensor([[3]]), gen,
                                           torch.ones(1))
            assert int(accepted[0]) == 0
            assert int(toks[0, 0]) != 3

    def test_stochastic_marginal_is_exactly_the_model(self):
        # 600 independent slots in one call: the first emitted token's
        # frequencies against softmax(logits) (the reference's bar)
        n = 600
        row = torch.tensor([[0.8, 0.1, -0.4], [0.0, 0.0, 0.0]])
        logits = row[None].expand(n, 2, 3).contiguous()
        toks, _ = verify_tokens(logits, torch.ones(n, 1, dtype=torch.long),
                                torch.Generator().manual_seed(42),
                                torch.ones(n))
        got = np.bincount(toks[:, 0].numpy(), minlength=3) / n
        want = torch.softmax(row[0], -1).numpy()
        np.testing.assert_allclose(got, want, atol=0.07)

    def test_top_k_one_is_greedy_even_when_stochastic(self):
        toks, accepted = verify_tokens(
            self._chain_logits([2, 4, 1]), torch.tensor([[2, 4]]),
            torch.Generator().manual_seed(0), torch.ones(1), top_k=1)
        assert int(accepted[0]) == 2
        assert toks[0].tolist() == [2, 4, 1]


def test_verify_tokens_draws_three_streams_and_bonus_is_sample_tokens():
    """The bonus row is a ``sample_tokens`` draw taken after the acceptance
    uniforms and the residual draw, from the top-k-masked last row."""
    rng = np.random.RandomState(5)
    logits = _t(rng.randn(3, 4, 9).astype(np.float32))
    drafts = _t(rng.randint(0, 9, (3, 3)))
    temps = torch.tensor([0.7, 1.3, 0.0])
    toks, _ = verify_tokens(logits, drafts,
                            torch.Generator().manual_seed(9), temps, top_k=4)
    gen = torch.Generator().manual_seed(9)
    torch.rand(drafts.shape, generator=gen)            # acceptance
    torch.rand((3, 3, 9), generator=gen)               # residual
    bonus = sample_tokens(_mask_top_k(logits[:, -1], 4), gen, temps, 0)
    assert torch.equal(toks[:, -1], bonus)


# ---------------------------------------------------------------------------
# NGramDraftSource
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx,k,max_ngram,want", [
    ([1, 2, 3, 1, 2, 3, 1, 2], 3, 3, [3, 1, 2]),
    ([5, 6, 7], 3, 3, [7, 7, 7]),
    ([1, 2, 1, 2], 4, 3, [1, 2, 2, 2]),
    ([2, 9, 7, 4, 9, 5, 2, 9], 1, 3, [7]),
    ([4], 2, 3, [4, 4]),
])
def test_ngram_reference_cases(ctx, k, max_ngram, want):
    assert NGramDraftSource(max_ngram).draft(ctx, k) == want
    assert JaxNGram(max_ngram).draft(ctx, k) == want


def test_ngram_random_contexts_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        ctx = rng.randint(0, 5, rng.randint(1, 30)).tolist()
        k, m = int(rng.randint(1, 6)), int(rng.randint(1, 5))
        assert NGramDraftSource(m).draft(ctx, k) == JaxNGram(m).draft(ctx, k)


def test_draft_source_interface_and_arguments():
    with pytest.raises(NotImplementedError):
        DraftSource().draft([1, 2], 2)
    with pytest.raises(NotImplementedError):
        JaxDraftSource().draft([1, 2], 2)
    with pytest.raises(ValueError, match="max_ngram"):
        NGramDraftSource(0)


# ---------------------------------------------------------------------------
# append_k, bit for bit against the JAX caches
# ---------------------------------------------------------------------------

L_, S_, H_, T_, D_, K_ = 2, 4, 2, 16, 8, 4


def _dense_pair(dtype, lengths, seed=0):
    rng = np.random.RandomState(seed)
    shape = (L_, S_, H_, T_, D_)
    j = JaxKVCache.create(L_, S_, H_, T_, D_, dtype=JDT[dtype])
    p = KVCache.create(L_, S_, H_, T_, D_, dtype=TDT[dtype], device="cpu")
    if dtype == "int8":
        kq, ks = jcache._quantize(jnp.asarray(rng.randn(*shape)))
        vq, vs = jcache._quantize(jnp.asarray(rng.randn(*shape)))
        j = dataclasses.replace(j, k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        j = dataclasses.replace(
            j, k=jnp.asarray(rng.randn(*shape), JDT[dtype]),
            v=jnp.asarray(rng.randn(*shape), JDT[dtype]))
    j = dataclasses.replace(j, lengths=jnp.asarray(lengths, jnp.int32))
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(p, name) is not None:
            getattr(p, name).copy_(_t(_np(getattr(j, name))))
    p.lengths.copy_(_t(np.asarray(lengths, np.int32)))
    return j, p


def _assert_dense_equal(j, p):
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        a = getattr(j, name)
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(getattr(p, name)),
                                          err_msg=name)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_append_k_matches_jax(dtype, count):
    # cursors: fresh, mid, near saturation (T - K < len < T) and at max_len
    lengths = [0, 5, T_ - 2, T_]
    j, p = _dense_pair(dtype, lengths, seed=count)
    rng = np.random.RandomState(10 + count)
    kn = rng.randn(L_, S_, H_, K_, D_).astype(np.float32)
    vn = rng.randn(L_, S_, H_, K_, D_).astype(np.float32)
    counts = np.asarray([count, count, min(count, 2), 0], np.int32)
    before = p.k.clone()
    ptrs = (p.k.data_ptr(), p.v.data_ptr(), p.lengths.data_ptr())
    j = j.append_k(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(counts))
    out = p.append_k(_t(kn), _t(vn), _t(counts))
    assert out is p and (p.k.data_ptr(), p.v.data_ptr(),
                         p.lengths.data_ptr()) == ptrs
    _assert_dense_equal(j, p)
    assert p.lengths.tolist() == [count, 5 + count,
                                  min(T_, T_ - 2 + min(count, 2)), T_]
    # a slot at max_len writes nothing; positions below a cursor never move
    assert torch.equal(p.k[:, 3], before[:, 3])
    for s, c in enumerate(lengths):
        assert torch.equal(p.k[:, s, :, :c], before[:, s, :, :c])


def test_dense_append_k_rejects_a_window_past_max_len():
    _, p = _dense_pair("float32", [0] * S_)
    big = torch.zeros(L_, S_, H_, T_ + 1, D_)
    with pytest.raises(ValueError, match="verify window"):
        p.append_k(big, big, torch.zeros(S_, dtype=torch.int32))


def _paged_pair(dtype, seed=0, nb=12, bs=4):
    rng = np.random.RandomState(seed)
    shape = (L_, nb, H_, bs, D_)
    j = JaxPagedKVCache.create(L_, nb, H_, bs, D_, dtype=JDT[dtype])
    p = PagedKVCache.create(L_, nb, H_, bs, D_, dtype=TDT[dtype],
                            device="cpu")
    if dtype == "int8":
        kq, ks = jcache._quantize(jnp.asarray(rng.randn(*shape)))
        vq, vs = jcache._quantize(jnp.asarray(rng.randn(*shape)))
        j = dataclasses.replace(j, k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        j = dataclasses.replace(
            j, k=jnp.asarray(rng.randn(*shape), JDT[dtype]),
            v=jnp.asarray(rng.randn(*shape), JDT[dtype]))
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(p, name) is not None:
            getattr(p, name).copy_(_t(_np(getattr(j, name))))
    return j, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_append_k_matches_jax(dtype):
    """Windows of K tokens from the allocator: slot 0 crosses a block edge
    (cursor 3, block size 4), slot 1 starts on one, slot 2 is inactive and
    slot 3 runs past its capacity (both aim at the null block)."""
    j, p = _paged_pair(dtype)
    alloc = BlockAllocator(12, 4, blocks_per_slot=3, max_seqs=S_)
    for slot, prompt in enumerate(([1, 2, 3], [4] * 4, [5, 6], [7] * 10)):
        alloc.admit(slot, prompt, prefill_blocks=3)
    active = np.array([True, True, False, True])
    assert alloc.prepare_verify(list(np.flatnonzero(active)), K_).failed \
        == []
    bids, offs = alloc.verify_targets(active, K_)
    assert bids[0, 0] != bids[0, 1] and offs[0].tolist() == [3, 0, 1, 2]
    assert np.all(bids[2] == NULL_BLOCK)
    assert bids[3].tolist()[2:] == [NULL_BLOCK] * 2     # past 12 tokens
    rng = np.random.RandomState(3)
    kn = rng.randn(L_, S_, H_, K_, D_).astype(np.float32)
    vn = rng.randn(L_, S_, H_, K_, D_).astype(np.float32)
    j = j.append_k(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(bids),
                   jnp.asarray(offs))
    out = p.append_k(_t(kn), _t(vn), bids, offs)
    assert out is p
    names = ("k", "v") + (("k_scale", "v_scale") if dtype == "int8" else ())
    for name in names:
        np.testing.assert_array_equal(_np(getattr(j, name))[:, 1:],
                                      _np(getattr(p, name))[:, 1:],
                                      err_msg=name)
    # every row of an active window landed at its target
    kq = store_roundtrip(_t(kn), TDT[dtype], dtype == "int8")
    for r in range(K_):
        got = p.k[:, bids[0, r], :, offs[0, r]].float()
        if dtype == "int8":
            got = got * p.k_scale[:, bids[0, r], :, offs[0, r], None]
        assert torch.equal(got, kq[:, 0, :, r].float())


# ---------------------------------------------------------------------------
# GPTModel.verify_forward
# ---------------------------------------------------------------------------

SIZES = dict(vocab_size=61, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32)
VS, VQ, VT = 3, 4, 32             # slots, window, max_len


@functools.lru_cache(maxsize=None)
def _models():
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    pm = GPTModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp), cfg))
    return jm, jp, pm


def _check_verify(jout, pout, what):
    (jl, (jk, jv), _), (pl, (pk, pv), _) = jout, pout
    assert pl.shape == (VS, VQ, SIZES["vocab_size"])
    assert pk.shape == (2, VS, 4, VQ, 16)
    for a, b, name in ((jl, pl, "logits"), (jk, pk, "k_new"),
                       (jv, pv, "v_new")):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_verify_forward_dense_matches_jax(cache):
    jm, jp, pm = _models()
    rng = np.random.RandomState(4)
    # cursors: empty, mid, and one whose window runs past the position
    # table (clipped)
    lengths = np.array([0, 9, VT - 2], np.int32)
    shape = (2, VS, 4, VT, 16)
    jc, tc = _cache_arrays(rng, cache, shape)
    jcache_ = JaxKVCache(*jc[:2], jnp.asarray(lengths), *jc[2:])
    pcache_ = KVCache(*tc[:2], _t(lengths), *tc[2:])
    tokens = rng.randint(0, SIZES["vocab_size"], (VS, VQ)).astype(np.int32)
    jout = jm.verify_forward(jp, jnp.asarray(tokens), jcache_)
    with torch.no_grad():
        pout = pm.verify_forward(_t(tokens).long(), pcache_)
    _check_verify(jout, pout, "dense")
    assert pcache_.lengths.tolist() == lengths.tolist()   # nothing appended


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_verify_forward_paged_matches_jax(cache):
    jm, jp, pm = _models()
    rng = np.random.RandomState(5)
    nb, bs = 26, 4
    jc, tc = _cache_arrays(rng, cache, (2, nb, 4, bs, 16))
    jpool = JaxPagedKVCache(*jc)
    ppool = PagedKVCache(*tc)
    tables = (rng.permutation(np.arange(1, nb))[: VS * 8]
              .reshape(VS, 8).astype(np.int32))
    lengths = np.array([0, 7, 30], np.int32)
    tokens = rng.randint(0, SIZES["vocab_size"], (VS, VQ)).astype(np.int32)
    # a copy-on-write pair: block tables[1, 1] is first filled from block
    # tables[2, 0] on both sides
    src, dst = tables[2, :1], tables[1, 1:2]
    jout = jm.verify_forward(jp, jnp.asarray(tokens), jpool,
                             block_tables=jnp.asarray(tables),
                             lengths=jnp.asarray(lengths),
                             cow_src=jnp.asarray(src),
                             cow_dst=jnp.asarray(dst))
    with torch.no_grad():
        pout = pm.verify_forward(_t(tokens).long(), ppool,
                                 block_tables=_t(tables), lengths=_t(lengths),
                                 cow_src=_t(src), cow_dst=_t(dst))
    _check_verify(jout, pout, "paged")
    assert torch.equal(ppool.k[:, dst[0]], ppool.k[:, src[0]])


def test_verify_forward_arguments():
    _, _, pm = _models()
    pool = PagedKVCache.create(2, 4, 4, 4, 16, dtype=torch.float32,
                               device="cpu")
    with pytest.raises(ValueError, match="block_tables and lengths"):
        pm.verify_forward(torch.zeros(1, 2, dtype=torch.long), pool)
    dense = KVCache.create(2, 1, 4, 8, 16, dtype=torch.float32,
                           device="cpu")
    with pytest.raises(ValueError, match="max_seqs, Q"):
        pm.verify_forward(torch.zeros(3, dtype=torch.long), dense)
