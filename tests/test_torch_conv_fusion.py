"""The port's fused conv ops against the JAX package's
``apex_tpu.ops.conv_fusion`` on the CPU.

``conv_bias``, ``conv_bias_relu``, ``conv_bias_mask_relu`` and
``conv_frozen_scale_bias_relu`` on NHWC inputs and HWIO weights, at
stride 1 and 2 and padding 0 and 1, fp32: the outputs and the gradients
with respect to the input, the weight, the bias and the scale. Then a
bf16 input over fp32 weights (the weight cast to bf16, bias and scale
applied in bf16, as the reference does).

Tolerance: fp32 within 1e-5 of each tensor's largest magnitude (1e-5
absolute below 1); the same products summed in another order. bf16
outputs within one bf16 ulp (2**-8) of the largest magnitude: the
accumulations round to bf16 once, where fp32 sums of two orders can fall
on either side of a rounding point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import conv_fusion as jc
from apex_tpu_torch.ops import conv_fusion as pc

TOL = 1e-5
OPS = ("conv_bias", "conv_bias_relu", "conv_bias_mask_relu",
       "conv_frozen_scale_bias_relu")


def _inputs(seed, stride, padding, k=3, n=2, hw=9, cin=8, cout=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(
        np.float32)
    b = rng.randn(cout).astype(np.float32) * 0.1
    scale = (1.0 + 0.1 * rng.randn(cout)).astype(np.float32)
    out_hw = (hw + 2 * padding - k) // stride + 1
    mask = (rng.rand(n, out_hw, out_hw, cout) > 0.3).astype(np.float32)
    dy = rng.randn(n, out_hw, out_hw, cout).astype(np.float32)
    return x, w, b, scale, mask, dy


def _args(op, mod, x, w, b, scale, mask):
    if op == "conv_bias_mask_relu":
        return (x, w, b, mask)
    if op == "conv_frozen_scale_bias_relu":
        return (x, w, scale, b)
    return (x, w, b)


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    limit = tol * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= limit, (what, np.abs(got - want).max())


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("op", OPS)
def test_fp32_outputs_and_grads_match_jax(op, stride, padding):
    x, w, b, scale, mask, dy = _inputs(7, stride, padding)
    nd = 3 if op != "conv_frozen_scale_bias_relu" else 4
    jargs = [jnp.asarray(a) for a in _args(op, jc, x, w, b, scale, mask)]
    jfn = getattr(jc, op)

    def jloss(*diff):
        full = list(diff) + jargs[len(diff):]
        out = jfn(*full, stride=stride, padding=padding)
        return jnp.sum(out * dy), out

    n_diff = nd if op != "conv_bias_mask_relu" else 3
    grads, jout = jax.grad(jloss, argnums=tuple(range(n_diff)),
                           has_aux=True)(*jargs[:n_diff])
    targs = [torch.tensor(a) for a in _args(op, pc, x, w, b, scale, mask)]
    for t in targs[:n_diff]:
        t.requires_grad_(True)
    out = getattr(pc, op)(*targs, stride=stride, padding=padding)
    assert out.shape == jout.shape
    _close(out, jout, TOL, "out")
    (out * torch.tensor(dy)).sum().backward()
    for i in range(n_diff):
        _close(targs[i].grad, grads[i], TOL, f"grad {i}")


@pytest.mark.parametrize("op", OPS)
def test_bf16_input(op):
    x, w, b, scale, mask, _ = _inputs(8, 1, 1)
    args = _args(op, jc, x, w, b, scale, mask)
    want = getattr(jc, op)(jnp.asarray(x, jnp.bfloat16),
                           *[jnp.asarray(a) for a in args[1:]], padding=1)
    got = getattr(pc, op)(torch.tensor(x).bfloat16(),
                          *[torch.tensor(a) for a in args[1:]], padding=1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, 2.0 ** -8, op)
