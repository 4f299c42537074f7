"""Port flash attention with packed-sequence segment ids vs the JAX package
on the CPU.

``flash_attention(segment_ids=...)`` runs the autograd Function over the
plain twins of the flash kernels (``_flash_fwd_plain``,
``_flash_bwd_dq_plain``, ``_flash_bwd_dkv_plain``, ``_flash_dbias_plain``),
which take int32 ids ``(b, s)`` as the CUDA kernels do; the JAX side is
``flash_attention(..., use_pallas=True)``, its Pallas kernels in interpret
mode. Self-attention ids and ``(q_ids, kv_ids)`` pairs at sq < sk, a pair
with a query id that no key carries (a fully masked row), causal and not,
d 32 and 64; ids with a learned bias and dropout.

The reference's Pallas path carries ids as fp32, so ids that differ only
past 2**24 compare equal there; its ``mha_reference`` compares them
exactly, and so does the port: that case is held against
``mha_reference``.

Inputs come from numpy with a seed, b 2, h 2, s 128-256. Tolerance: fp32
2e-5 absolute on outputs and grads (values and grads of magnitude ~1; the
two sides sum in different orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = 2e-5
B, H = 2, 2


def _packed(rng, b: int, s: int, docs: int = 4) -> np.ndarray:
    """``(b, s)`` int32 ids counting up at ``docs - 1`` cut points a row,
    as ``examples/long_context.py`` packs its documents."""
    ids = np.zeros((b, s), np.int32)
    for row in range(b):
        for cut in rng.choice(np.arange(1, s), docs - 1, replace=False):
            ids[row, cut:] += 1
    return ids


def _grads_both(q, k, v, w, **kw):
    """Out and (dq, dk, dv) of the JAX Pallas flash and of the port's."""
    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, use_pallas=True, **kw)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tkw = dict(kw)
    if "segment_ids" in kw:
        ids = kw["segment_ids"]
        tkw["segment_ids"] = (tuple(torch.from_numpy(np.asarray(x))
                                    for x in ids)
                              if isinstance(ids, tuple)
                              else torch.from_numpy(np.asarray(ids)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = pfa.flash_attention(*leaves, **tkw)
    out.backward(torch.from_numpy(w))
    return ((np.asarray(j_out), [np.asarray(g) for g in j_grads]),
            (out.detach().numpy(), [t.grad.numpy() for t in leaves]))


# (kind, causal, d): self ids at s 128; a pair at sq 128 < sk 256, whose
# query ids include one no key carries
CASES = [(kind, causal, d) for kind in ("self", "pair")
         for causal in (False, True) for d in (32, 64)]


@pytest.mark.parametrize("kind,causal,d", CASES)
def test_segments_match_jax_kernels(kind, causal, d):
    rng = np.random.RandomState(10 + 2 * causal + d)
    sq, sk = (128, 128) if kind == "self" else (128, 256)
    q = rng.randn(B, H, sq, d).astype(np.float32)
    k, v = (rng.randn(B, H, sk, d).astype(np.float32) for _ in range(2))
    w = rng.randn(B, H, sq, d).astype(np.float32)
    if kind == "self":
        ids = _packed(rng, B, sq)
    else:
        kv_ids = _packed(rng, B, sk)
        q_ids = _packed(rng, B, sq)
        q_ids[1, :9] = 77          # no key carries id 77: rows fully masked
        ids = (q_ids, kv_ids)
    (j_out, j_grads), (out, grads) = _grads_both(
        q, k, v, w, causal=causal, segment_ids=ids)
    np.testing.assert_allclose(out, j_out, atol=TOL)
    for name, g, jg in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(g, jg, atol=TOL, err_msg=f"d{name}")
    if kind == "pair":
        assert (out[1, :, :9] == 0).all() and (grads[0][1, :, :9] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_segments_with_learned_bias_and_dropout_match_jax(causal):
    """Ids with a learned per-head bias and dropout 0.2: out, dq, dk, dv
    and dbias against the JAX Pallas kernels (its dbias kernel included)."""
    rng = np.random.RandomState(34 + causal)
    s, d = 128, 64
    q, k, v = (0.3 * rng.randn(B, H, s, d).astype(np.float32)
               for _ in range(3))
    w = rng.randn(B, H, s, d).astype(np.float32)
    ids = _packed(rng, B, s)
    bias = (0.1 * rng.randn(1, H, s, s)).astype(np.float32)
    kw = dict(causal=causal, bias_requires_grad=True, dropout_rate=0.2,
              dropout_seed=4242)

    def jax_loss(q, k, v, bias):
        out = jfa.flash_attention(q, k, v, bias=bias, use_pallas=True,
                                  segment_ids=ids, **kw)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(q, k, v, bias)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = pfa.flash_attention(*leaves[:3], bias=leaves[3],
                              segment_ids=torch.from_numpy(ids), **kw)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL)
    for name, t, jg in zip(("dq", "dk", "dv", "dbias"), leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=TOL,
                                   err_msg=name)


def test_fully_masked_rows_give_zero_out_and_infinite_lse():
    """A query id that no key carries leaves its row nothing to attend:
    the forward twin gives out 0 and lse +inf, the backward twins zero
    dq on it and no gradient from it."""
    rng = np.random.RandomState(5)
    n, sq, sk, d = 4, 16, 24, 16
    q, do = (torch.from_numpy(rng.randn(n, sq, d).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(n, sk, d).astype(np.float32))
            for _ in range(2))
    q_ids = torch.zeros(2, sq, dtype=torch.int32)
    q_ids[:, 3:7] = 5
    segs = (q_ids, torch.zeros(2, sk, dtype=torch.int32))
    out, lse = pfa._flash_fwd_plain(q, k, v, False, d ** -0.5,
                                    segments=segs)
    assert torch.isinf(lse[:, 3:7]).all() and (lse[:, 3:7] > 0).all()
    assert (out[:, 3:7] == 0).all() and torch.isfinite(lse[:, 7:]).all()
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, False, d ** -0.5)
    dq = pfa._flash_bwd_dq_plain(*args, segments=segs)
    dk, dv = pfa._flash_bwd_dkv_plain(*args, segments=segs)
    assert (dq[:, 3:7] == 0).all()
    ref = pfa._flash_bwd_dkv_plain(q[:, 7:].contiguous(), k, v,
                                   do[:, 7:].contiguous(),
                                   lse[:, 7:].contiguous(),
                                   delta[:, 7:].contiguous(), False,
                                   d ** -0.5)
    # the masked rows add nothing: dK, dV over rows 0-2 and 7+ only
    full = pfa._flash_bwd_dkv_plain(
        torch.cat([q[:, :3], q[:, 7:]], 1), k, v,
        torch.cat([do[:, :3], do[:, 7:]], 1),
        torch.cat([lse[:, :3], lse[:, 7:]], 1),
        torch.cat([delta[:, :3], delta[:, 7:]], 1), False, d ** -0.5)
    torch.testing.assert_close(dk, full[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, full[1], atol=1e-6, rtol=0)
    assert not torch.allclose(dk, ref[0])


def test_ids_past_2_24_stay_apart_as_in_mha_reference():
    """Ids 2**24 and 2**24 + 1 are two documents. The port's twins keep
    them apart and agree with the JAX ``mha_reference``, which compares
    ids exactly (the JAX Pallas path's fp32 carrier merges them)."""
    rng = np.random.RandomState(24)
    s, d = 128, 64
    q, k, v = (rng.randn(1, 1, s, d).astype(np.float32) for _ in range(3))
    ids = np.full((1, s), 2 ** 24, np.int64)
    ids[:, s // 2:] += 1
    ref = np.asarray(jfa.mha_reference(q, k, v,
                                       segment_ids=jnp.asarray(ids)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, segment_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
    merged = pfa.flash_attention(tq, tk, tv)
    assert float((out - merged).abs().max()) > 0.1
    # the first half attends only itself: equal to attention over it alone
    half = pfa.flash_attention(tq[:, :, :s // 2], tk[:, :, :s // 2],
                               tv[:, :, :s // 2])
    torch.testing.assert_close(out[:, :, :s // 2], half, atol=TOL, rtol=0)


def test_segment_id_validation():
    q = torch.zeros(1, 1, 8, 32)
    k = torch.zeros(1, 1, 12, 32)
    with pytest.raises(ValueError, match="cross-attention"):
        pfa.flash_attention(q, k, k, segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="do not match"):
        pfa.flash_attention(q, k, k, segment_ids=(torch.zeros(1, 8),
                                                  torch.zeros(1, 8)))
    with pytest.raises(ValueError, match="outside int32"):
        pfa.flash_attention(q, q, q, segment_ids=torch.full(
            (1, 8), 2 ** 31, dtype=torch.int64))
    with pytest.raises(ValueError, match="whole numbers"):
        pfa.flash_attention(q, q, q, segment_ids=torch.full((1, 8), 0.5))
    with pytest.raises(ValueError, match="integers"):
        pfa.flash_attention(q, q, q, segment_ids=torch.ones(1, 8,
                                                            dtype=torch.bool))
    # whole-number floats and int64 within int32 are taken, as int32
    q_ids, kv_ids = pfa._norm_segment_ids(torch.arange(8.0)[None], 8, 8)
    assert q_ids.dtype == kv_ids.dtype == torch.int32
    assert q_ids.tolist() == [list(range(8))]


def test_kernel_wrappers_refuse_cpu_segments_and_dbias():
    q = torch.zeros(4, 8, 64)
    rows = torch.zeros(4, 8)
    ids = torch.zeros(2, 8, dtype=torch.int32)
    bias = torch.zeros(1, 2, 1, 8)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, q, q, False, 0.125, segments=(ids, ids))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dq(q, q, q, q, rows, rows, False, 0.125,
                              segments=(ids, ids))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.125,
                               segments=(ids, ids))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_dbias(q, q, q, q, rows, rows, True, 0.125, bias=bias,
                             segments=(ids, ids))
    with pytest.raises(ValueError, match="needs the bias"):
        _kernels.flash_dbias(q, q, q, q, rows, rows, True, 0.125)
    assert _kernels.LAUNCHES == before
