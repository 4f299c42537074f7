"""The port's sigmoid focal loss against the JAX package's
``apex_tpu.ops.focal_loss`` on the CPU.

With and without label smoothing, gamma 2 and 0.5, the class axis padded
(``num_real_classes`` below its width), all three target codes (-2
ignores an anchor, -1 makes every class negative, y >= 0 one positive),
2-d and batched 3-d logits, and logits past where fp32's sigmoid reaches
0 or 1: the loss, and the gradient through ``jax.grad`` and autograd.
Where the reference's AD gives 0 * inf = NaN (``pow(sigma, gamma)`` at
sigma 0 or 1 with gamma < 1), the port's gradient is NaN at the same
entries; at gamma 2 both are finite. Also ``FocalLoss.apply``.

Tolerance: the loss and every finite gradient entry within 1e-6 of the
reference's, relative to the largest magnitude (the same fp32 elementwise
math, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import focal_loss as jfocal
from apex_tpu_torch.ops import FocalLoss, focal_loss

TOL = 1e-6
NUM_REAL, ALPHA = 6, 0.25


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    x.reshape(-1, shape[-1])[0, :3] = (-120.0, 40.0, -30.0)
    y = rng.randint(-2, shape[-1], size=shape[:-1])
    flat = y.reshape(-1)
    flat[:4] = (-2, -1, 0, NUM_REAL - 1)
    flat[4] = shape[-1] - 1          # a positive on a padding column
    npos = np.float32(max((flat >= 0).sum(), 1))
    return x, y, npos


@pytest.mark.parametrize("shape", [(12, 8), (2, 5, 8)], ids=["2d", "3d"])
@pytest.mark.parametrize("gamma", [2.0, 0.5])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grad_match_jax(shape, gamma, smoothing):
    x, y, npos = _inputs(shape, seed=5)

    def jloss(lg):
        return jfocal(lg, jnp.asarray(y), jnp.asarray(npos), NUM_REAL,
                      ALPHA, gamma, smoothing)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = focal_loss(xt, torch.tensor(y), torch.tensor(npos), NUM_REAL,
                     ALPHA, gamma, smoothing)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    jg, g = np.asarray(jgrad), xt.grad.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(jg))
    if gamma >= 1.0:
        assert np.isfinite(g).all()
    else:
        assert np.isnan(g).any()
    fin = np.isfinite(jg)
    limit = TOL * max(1.0, float(np.abs(jg[fin]).max()))
    assert np.abs(g[fin] - jg[fin]).max() <= limit
    # ignored anchors and padding columns: no gradient (but the
    # reference's NaN where 0 * inf meets a skipped entry)
    g2 = g.reshape(-1, shape[-1])
    for skipped in (g2[y.reshape(-1) == -2], g2[:, NUM_REAL:]):
        assert np.all(skipped[np.isfinite(skipped)] == 0)


def test_bf16_logits_and_apply():
    x, y, npos = _inputs((12, 8), seed=6)
    xb = torch.tensor(x).bfloat16()
    got = FocalLoss.apply(xb, torch.tensor(y), torch.tensor(npos), NUM_REAL,
                          ALPHA, 2.0)
    want = jfocal(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y),
                  jnp.asarray(npos), NUM_REAL, ALPHA, 2.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
