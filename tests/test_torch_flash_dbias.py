"""Port flash attention's learned-bias gradient vs the JAX package on the
CPU.

``flash_attention(bias=..., bias_requires_grad=True)`` runs the autograd
Function whose backward returns ``_flash_dbias_plain`` (the plain twin of
the ``flash_dbias`` CUDA kernel): the score cotangent summed over the
bias's broadcast dims. The JAX side is ``flash_attention(...,
use_pallas=True)``, whose backward runs the Pallas ``_dbias_kernel`` in
interpret mode. Bias shapes: the five of ``tests/test_flash_attention.py``
(``(1, h, s, s)``, ``(b, h, s, s)``, ``(1, 1, s, s)``, ``(b, 1, s, s)``,
``(1, h, 1, s)``), causal and not; dropout 0.3 in fp32 and bf16; and the
zero gradient without ``bias_requires_grad``.

Inputs come from numpy with a seed, b 2, h 2, s 128, d 64, scaled as the
JAX test scales them (q, k, v 0.3, bias 0.1). Tolerances: fp32 2e-5
absolute (dbias values of magnitude up to ~1, sums of up to 256 score
cotangents taken in different orders); bf16 2e-2 absolute and relative,
as the JAX test allows its bf16 case.
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
TOL_BF16 = 2e-2
B, H, S, D = 2, 2, 128, 64
SHAPES = [(1, H, S, S), (B, H, S, S), (1, 1, S, S), (B, 1, S, S),
          (1, H, 1, S)]


def _inputs(seed: int, bias_shape):
    rng = np.random.RandomState(seed)
    q, k, v = (0.3 * rng.randn(B, H, S, D).astype(np.float32)
               for _ in range(3))
    w = rng.randn(B, H, S, D).astype(np.float32)
    bias = (0.1 * rng.randn(*bias_shape)).astype(np.float32)
    return q, k, v, w, bias


def _dbias_both(q, k, v, w, bias, dtype=np.float32, **kw):
    """The bias's gradient from the JAX Pallas flash and from the port."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    j_db = jax.grad(lambda b: jnp.sum(jfa.flash_attention(
        jq, jk, jv, bias=b, use_pallas=True, **kw).astype(jnp.float32)
        * w))(bias)
    tb = torch.from_numpy(bias).requires_grad_()
    out = pfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)), bias=tb, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return np.asarray(j_db), tb.grad.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", SHAPES)
def test_dbias_matches_jax_kernels(bias_shape, causal):
    q, k, v, w, bias = _inputs(13 + causal, bias_shape)
    j_db, db = _dbias_both(q, k, v, w, bias, causal=causal,
                           bias_requires_grad=True)
    assert db.shape == bias.shape and np.abs(j_db).max() > 1e-3
    np.testing.assert_allclose(db, j_db, atol=TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dbias_with_dropout_matches_jax_kernels(dtype):
    """Dropout 0.3: ds takes the dropped dp and the undropped p, as the
    reference's ``_recompute_p_ds``; bf16 q/k/v round where the JAX
    kernels round (the JAX test's bf16 case, 2e-2)."""
    q, k, v, w, bias = _inputs(23, (1, H, S, S))
    j_db, db = _dbias_both(q, k, v, w, bias, dtype=dtype, causal=True,
                           bias_requires_grad=True, dropout_rate=0.3,
                           dropout_seed=987654321)
    tol = TOL if dtype == "fp32" else TOL_BF16
    np.testing.assert_allclose(db, j_db, atol=tol, rtol=tol)


def test_bias_gradient_is_zero_without_bias_requires_grad():
    q, k, v, w, bias = _inputs(14, (1, H, S, S))
    j_db, db = _dbias_both(q, k, v, w, bias, causal=True)
    assert not np.abs(j_db).any() and not np.abs(db).any()


@pytest.mark.parametrize("bias_shape", [(B, 1, 1, 40), (1, H, 1, 1),
                                        (H, 24, 40), (40,)])
def test_dbias_twin_is_the_autograd_of_attention(bias_shape):
    """At shapes off the kernel tiles (sq 24 < sk 40, causal, ids, dropout)
    and at bias ranks and keys dims the normalization widens, the learned
    bias's gradient through the twins equals autograd through
    ``mha_reference``."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(B, H, 24, 32).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, H, 40, 32).astype(np.float32))
            for _ in range(2))
    w = torch.from_numpy(rng.randn(B, H, 24, 32).astype(np.float32))
    bias = torch.from_numpy(rng.randn(*bias_shape).astype(np.float32))
    ids = (torch.from_numpy(np.repeat([[0] * 10 + [1] * 14], B, 0)),
           torch.from_numpy(np.repeat([[0] * 25 + [1] * 15], B, 0)))
    kw = dict(causal=True, segment_ids=ids, dropout_rate=0.25,
              dropout_seed=11)
    got = torch.autograd.grad(pfa.flash_attention(
        q, k, v, bias=bias.requires_grad_(), bias_requires_grad=True, **kw),
        bias, w)[0]
    want = torch.autograd.grad(pfa.mha_reference(q, k, v, bias=bias, **kw),
                               bias, w)[0]
    assert got.shape == bias.shape
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("bias_shape", [(B, H, 1, S), (1, H, S, S),
                                        (B, 1, 1, S), (1, 1, S, S)])
def test_dbias_split_enumerates_each_batch_head_once(bias_shape):
    """The kernel's ``(kept, reduced, g_stride, r_stride)``: slice ``g``
    sums batch-heads ``g * g_stride + r * r_stride``, each of the ``n``
    exactly once, each into the bias entry the forward read it from."""
    n = B * H
    bias = torch.zeros(bias_shape)
    kept, reduced, gs, rs = _kernels._dbias_split(bias, n)
    heads = pfa._bias_heads(bias, n)
    bb, hb = bias_shape[:2]
    seen = []
    for g in range(kept):
        for r in range(reduced):
            bh = g * gs + r * rs
            seen.append(bh)
            # the forward's (batch, head) of bh, kept dims only
            kb = bh // heads if bb > 1 else 0
            kh = bh % heads if hb > 1 else 0
            assert g == kb * hb + kh
    assert sorted(seen) == list(range(n))
