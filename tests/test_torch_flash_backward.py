"""Port flash attention training contract vs the JAX package on the CPU.

- the counter-hash dropout mask, bit for bit against JAX's
  ``dropout_keep_mask``;
- ``flash_attention`` (the autograd Function over the plain versions of the
  three flash kernels) out and grads against JAX's ``flash_attention`` with
  ``use_pallas=True``, its Pallas kernels in interpret mode;
- the plain backward versions (``_flash_bwd_dq_plain``,
  ``_flash_bwd_dkv_plain``, which mirror the CUDA kernels) against
  autograd of the plain forward, including zero grads on fully masked rows;
- the contract: a dropout rate without a seed raises, a bias or segment ids
  on the kernel path raise, a bias gets zero grad unless
  ``bias_requires_grad``.

Inputs come from numpy with a seed. Tolerances: fp32 1e-5 absolute on
values and grads of magnitude ~1 (the two sides sum in different orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -123456789])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_mask_bit_identical_to_jax(seed, rate):
    b, h, sq, sk = 2, 3, 37, 53   # ragged: no tile multiple anywhere
    ref = np.asarray(jfa.dropout_keep_mask(seed, b, h, sq, sk, rate))
    got = pfa.dropout_keep_mask(seed, b, h, sq, sk, rate)
    assert got.dtype == torch.bool and got.shape == (b, h, sq, sk)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the keep rate is what was asked for
    assert abs(ref.mean() - (1.0 - rate)) < 0.02


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32)
               for s in (sq, sk, sk))
    w = rng.randn(b, h, sq, d).astype(np.float32)   # output cotangent
    return q, k, v, w


def _torch_grads(fn, q, k, v, w):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(w))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_out_and_grads_match_jax_kernels(causal, rate, d):
    q, k, v, w = _inputs(0, 1, 2, 128, 128, d)
    seed = 1234 if rate else None

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, use_pallas=True,
                                  dropout_rate=rate, dropout_seed=seed)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    out, grads = _torch_grads(
        lambda a, b_, c: pfa.flash_attention(a, b_, c, causal=causal,
                                             dropout_rate=rate,
                                             dropout_seed=seed), q, k, v, w)
    np.testing.assert_allclose(out, np.asarray(j_out), atol=TOL)
    for name, g, jg in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=TOL,
                                   err_msg=f"d{name}")


BWD_CASES = [  # (n, sq, sk, d, causal, rate)
    (3, 40, 40, 16, True, 0.0),
    (3, 40, 40, 16, True, 0.3),
    (2, 24, 50, 32, True, 0.1),       # cross, sq < sk
    (2, 24, 50, 32, False, 0.2),
    (2, 50, 20, 16, True, 0.1),       # sq > sk: fully masked rows
    (2, 33, 33, 64, False, 0.0),
]


@pytest.mark.parametrize("n,sq,sk,d,causal,rate", BWD_CASES)
def test_plain_backward_matches_autograd_of_plain_forward(n, sq, sk, d,
                                                          causal, rate):
    q, k, v, w = (torch.from_numpy(x[0]) for x in _inputs(1, 1, n, sq, sk,
                                                          d))
    scale, seed = d ** -0.5, -99
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = pfa._flash_fwd_plain(*leaves, causal, scale, rate, seed)
    ref = torch.autograd.grad(out, leaves, w)
    delta = (w * out.detach()).sum(dim=-1)
    args = (q, k, v, w, lse.detach(), delta, causal, scale, rate, seed)
    dq = pfa._flash_bwd_dq_plain(*args)
    dk, dv = pfa._flash_bwd_dkv_plain(*args)
    for name, got, exp in zip("qkv", (dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=TOL,
                                   err_msg=f"d{name}")
    if causal and sq > sk:
        masked = sq - sk    # rows that see no key
        assert torch.isinf(lse[:, :masked]).all()
        assert (out[:, :masked] == 0).all() and (dq[:, :masked] == 0).all()


def test_autograd_function_runs_the_plain_backward_on_cpu():
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(2, 2, 3, 16, 24, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pfa.flash_attention(*leaves, causal=True, dropout_rate=0.2,
                              dropout_seed=5)
    got = torch.autograd.grad(out, leaves, w)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = pfa.mha_reference(*ref_leaves, causal=True, dropout_rate=0.2,
                            dropout_seed=5)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=TOL)
    for g, e in zip(got, torch.autograd.grad(ref, ref_leaves, w)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), atol=TOL)


def test_dropout_rate_without_seed_raises():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        pfa.flash_attention(q, q, q, dropout_rate=0.1)


def test_bias_and_segments_raise_on_the_kernel_path():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(NotImplementedError, match="dbias"):
        pfa.flash_attention(q, q, q, bias=torch.zeros(1, 1, 1, 8),
                            use_kernel=True)
    with pytest.raises(NotImplementedError, match="segment"):
        pfa.flash_attention(q, q, q, segment_ids=torch.zeros(1, 8),
                            use_kernel=True)


@pytest.mark.parametrize("bias_requires_grad", [False, True])
def test_plain_bias_grad_follows_bias_requires_grad(bias_requires_grad):
    q, k, v, w = _inputs(3, 2, 2, 8, 8, 16)
    bias = np.random.RandomState(4).randn(2, 1, 1, 8).astype(np.float32)

    def jax_loss(q, k, v, bias):
        out = jfa.flash_attention(q, k, v, bias=bias, causal=True,
                                  use_pallas=False,
                                  bias_requires_grad=bias_requires_grad)
        return jnp.sum(out * w)

    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = pfa.flash_attention(*leaves[:3], bias=leaves[3], causal=True,
                              bias_requires_grad=bias_requires_grad)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(w),
                                allow_unused=True)
    dbias = grads[3]
    if not bias_requires_grad:
        assert dbias is None or not dbias.abs().any()
        assert not np.abs(np.asarray(j_grads[3])).any()
    for g, jg in zip(grads[:3] + ((grads[3],) if bias_requires_grad
                                  else ()), j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=TOL)
