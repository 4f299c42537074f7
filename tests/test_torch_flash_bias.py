"""Port flash attention with an additive score bias vs the JAX package on
the CPU.

``flash_attention(bias=...)`` runs the autograd Function over the plain
twins of the three flash kernels (``_flash_fwd_plain``,
``_flash_bwd_dq_plain``, ``_flash_bwd_dkv_plain``), which take the bias
broadcast as the CUDA kernels do; the JAX side is ``flash_attention(...,
use_pallas=True)``, its Pallas kernels in interpret mode with the bias
kept broadcast (``_bias_spec``). Bias shapes: a ``(b, 1, 1, s)`` padding
mask, ``(1, h, s, s)``, ``(b, h, s, s)`` and a keys dim of 1; causal and
not; with dropout on the padding and per-head biases. The bias's gradient
is zero on both sides (``bias_requires_grad=False``).

Inputs come from numpy with a seed, b 2, h 2, s 128, d 64. Tolerance:
fp32 1e-5 absolute on the output and on dq, dk, dv (values and grads of
magnitude ~1; the two sides sum in different orders).
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

TOL = 1e-5
B, H, S, D = 2, 2, 128, 64


def _bias(kind: str, rng) -> np.ndarray:
    if kind == "padding":          # BERT's: -10000 past each row's length
        lengths = np.array([S, 77])
        keep = np.arange(S)[None, :] < lengths[:, None]
        return np.where(keep, 0.0, -10000.0).astype(np.float32)[:, None,
                                                                None, :]
    shape = {"per_head": (1, H, S, S), "full": (B, H, S, S),
             "keys_dim_1": (B, H, S, 1)}[kind]
    return rng.randn(*shape).astype(np.float32)


# every bias shape causal and not; dropout with the broadcast and the
# per-(row, col) kinds
CASES = [(kind, causal, 0.0)
         for kind in ("padding", "per_head", "full", "keys_dim_1")
         for causal in (False, True)]
CASES += [(kind, causal, 0.1) for kind in ("padding", "per_head")
          for causal in (False, True)]


@pytest.mark.parametrize("kind,causal,rate", CASES)
def test_biased_flash_matches_jax_kernels(kind, causal, rate):
    rng = np.random.RandomState(len(kind) + 2 * causal)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32)
                  for _ in range(4))
    bias = _bias(kind, rng)
    seed = 4321 if rate else None

    def jax_loss(q, k, v, bias):
        out = jfa.flash_attention(q, k, v, bias=bias, causal=causal,
                                  use_pallas=True, dropout_rate=rate,
                                  dropout_seed=seed)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(q, k, v, bias)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = pfa.flash_attention(*leaves[:3], bias=leaves[3], causal=causal,
                              dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL)
    for name, t, jg in zip("qkv", leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=TOL,
                                   err_msg=f"d{name}")
    # the bias takes a zero gradient on both sides
    assert leaves[3].grad is not None and not leaves[3].grad.abs().any()
    assert not np.abs(np.asarray(j_grads[3])).any()


def test_padding_bias_is_a_finite_score():
    """A row whose every key carries -10000 is not a fully masked row: the
    softmax is uniform over them and the logsumexp finite, while a causal
    row with no visible key keeps lse +inf."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, D).astype(np.float32))
               for _ in range(3))
    bias = torch.full((2, 1, 1, 16), -10000.0)
    out, lse = pfa._flash_fwd_plain(q, k, v, False, D ** -0.5, bias=bias)
    ref = pfa.mha_reference(q[:, None], k[:, None], v[:, None],
                            bias=bias)[:, 0]
    _, ref_lse = pfa._flash_fwd_plain(q, k, v, False, D ** -0.5)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    # fp32 scores near -10000 keep ~1e-3 of their fractional part
    torch.testing.assert_close(lse, ref_lse - 10000.0, atol=1e-2, rtol=0)
    # sq > sk causal: the first rows see no key at all
    _, lse = pfa._flash_fwd_plain(q, k[:, :8].contiguous(),
                                  v[:, :8].contiguous(), True, D ** -0.5,
                                  bias=torch.zeros(1, 1, 1, 8))
    assert torch.isinf(lse[:, :8]).all() and torch.isfinite(lse[:, 8:]).all()


def test_bias_normalization_follows_the_reference():
    q = torch.zeros(2, 3, 4, 8)
    k = torch.zeros(2, 3, 5, 8)
    assert pfa._norm_bias(torch.zeros(5), 2, 3, 4, 5).shape == (1, 1, 1, 5)
    assert pfa._norm_bias(torch.zeros(4, 1), 2, 3, 4, 5).shape == (1, 1, 4,
                                                                   5)
    with pytest.raises(ValueError, match="bias dim 1 is 2"):
        pfa.flash_attention(q, k, k, bias=torch.zeros(1, 2, 4, 5))
    with pytest.raises(ValueError, match="rank 5"):
        pfa.flash_attention(q, k, k, bias=torch.zeros(1, 1, 1, 1, 5))


def test_learned_bias_keeps_the_reference_route_on_cpu():
    """``bias_requires_grad=True`` on the CPU runs the plain twins, the
    bias's gradient from ``_flash_dbias_plain``, and matches the gradient
    of the JAX package's reference route (``use_pallas=False``)."""
    rng = np.random.RandomState(9)
    q, k, v, w = (rng.randn(1, 2, 16, 16).astype(np.float32)
                  for _ in range(4))
    bias = rng.randn(1, 2, 16, 16).astype(np.float32)
    j_db = jax.grad(lambda b: jnp.sum(jfa.flash_attention(
        q, k, v, bias=b, use_pallas=False, bias_requires_grad=True) * w))(
            bias)
    tb = torch.from_numpy(bias).requires_grad_()
    out = pfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              bias=tb, bias_requires_grad=True)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(j_db), atol=TOL)


def test_kernel_wrappers_refuse_a_cpu_bias():
    q = torch.zeros(4, 8, 64)
    rows = torch.zeros(4, 8)
    bias = torch.zeros(2, 1, 1, 8)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, q, q, False, 0.125, bias=bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dq(q, q, q, q, rows, rows, False, 0.125,
                              bias=bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dkv(q, q, q, q, rows, rows, False, 0.125,
                               bias=bias)
    assert _kernels.LAUNCHES == before
