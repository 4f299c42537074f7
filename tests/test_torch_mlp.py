"""Port MLP and fused dense layers vs the JAX package on the CPU.

- ``MLP`` (``mlp_forward``) with relu, sigmoid and no activation, with
  and without biases, at fp32 and with a bf16 input over fp32 weights
  (each GEMM the product of the exact values in fp32, as the reference's
  ``preferred_element_type=float32``), the activation after every layer,
  the last included: outputs and the grads of every weight, bias and the
  input;
- ``fused_dense``/``FusedDense`` and ``fused_dense_gelu_dense``/
  ``FusedDenseGeluDense`` (tanh GELU), the same way;
- the bridge (``mlp_params_from_jax``, ``module_params_from_jax``) bit
  for bit, ``init``'s bounds from a generator, the refusals.

Tolerance: fp32 results 1e-6 of each tensor's largest magnitude (or 1e-6
absolute below 1); a bf16 output within one bf16 ulp (2**-8 relative) of
the reference's, and the fp32 weight grads under a bf16 input at 1e-6 too
(the same bf16 values go into the same fp32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import MLP as JaxMLP
from apex_tpu.ops import FusedDense as JaxDense
from apex_tpu.ops import FusedDenseGeluDense as JaxDGD
from apex_tpu_torch._bridge import mlp_params_from_jax, module_params_from_jax
from apex_tpu_torch.ops import (MLP, FusedDense, FusedDenseGeluDense,
                                fused_dense, fused_dense_gelu_dense,
                                mlp_forward)

TOL = 1e-6
SIZES = (24, 32, 16, 8)


def _close(got, want, what, bf16=False):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    tol = TOL * max(1.0, float(np.abs(want).max()))
    if bf16:
        tol = tol + 2 ** -8 * np.abs(want)
    assert (np.abs(got - want) <= tol).all(), (what, np.abs(got - want).max())


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(jmodel, jparams, pmodel, x, bf16, out_features):
    jd = jnp.bfloat16 if bf16 else jnp.float32
    dtype = torch.bfloat16 if bf16 else torch.float32
    w = _x((x.shape[0], out_features), 9)

    def jloss(params, xx):
        out = jmodel(params, xx)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x, jd))
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    out = pmodel(tx)
    assert out.dtype == dtype
    (out.float() * torch.from_numpy(w)).sum().backward()
    _close(out, jout, "out", bf16)
    _close(tx.grad, jgx, "d input", bf16)
    return jg


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_matches_jax(activation, bias, bf16):
    jm = JaxMLP(SIZES, bias=bias, activation=activation)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = MLP(SIZES, bias=bias, activation=activation, device="cpu")
    pm.load_state_dict(mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    jg = _check(jm, jp, pm, _x((6, SIZES[0])), bf16, SIZES[-1])
    for i, (w, b) in enumerate(pm.layers()):
        _close(w.grad, jg[i][0], f"weight_{i}")
        if bias:
            _close(b.grad, jg[i][1], f"bias_{i}")
        else:
            assert b is None and jg[i][1] is None


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_dense_matches_jax(bf16):
    jm = JaxDense(24, 12)
    jp = jm.init(jax.random.PRNGKey(1))
    pm = FusedDense(24, 12, device="cpu")
    pm.load_state_dict(module_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    jg = _check(jm, jp, pm, _x((5, 24), 1), bf16, 12)
    _close(pm.weight.grad, jg["weight"], "weight")
    _close(pm.bias.grad, jg["bias"], "bias")


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_dense_gelu_dense_matches_jax(bf16):
    jm = JaxDGD(24, 40, 12)
    jp = jm.init(jax.random.PRNGKey(2))
    pm = FusedDenseGeluDense(24, 40, 12, device="cpu")
    sd = module_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert set(sd) == {"dense1.weight", "dense1.bias", "dense2.weight",
                       "dense2.bias"}
    pm.load_state_dict(sd)
    jg = _check(jm, jp, pm, _x((5, 24), 2), bf16, 12)
    for name, p in pm.named_parameters():
        layer, leaf = name.split(".")
        _close(p.grad, jg[layer][leaf], name)


def test_functions_and_bridge_bit_for_bit():
    jm = JaxMLP(SIZES)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    sd = mlp_params_from_jax(jp)
    for i, (w, b) in enumerate(jp):
        assert np.array_equal(sd[f"weight_{i}"].numpy(), w)
        assert np.array_equal(sd[f"bias_{i}"].numpy(), b)
    x = torch.from_numpy(_x((3, SIZES[0]), 4))
    pairs = [(sd[f"weight_{i}"], sd[f"bias_{i}"]) for i in range(3)]
    m = MLP(SIZES, device="cpu")
    m.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(m(x), mlp_forward(pairs, x))
    w1, b1, w2, b2 = (torch.from_numpy(_x(s, 5 + i)) for i, s in
                      enumerate(((40, 24), (40,), (12, 40), (12,))))
    xx = torch.from_numpy(_x((5, 24), 6))
    want = JaxDGD(24, 40, 12)({"dense1": {"weight": w1.numpy(),
                                          "bias": b1.numpy()},
                               "dense2": {"weight": w2.numpy(),
                                          "bias": b2.numpy()}}, xx.numpy())
    _close(fused_dense_gelu_dense(xx, w1, b1, w2, b2), want, "function")
    _close(fused_dense(xx, w1, b1), JaxDense(24, 40)(
        {"weight": w1.numpy(), "bias": b1.numpy()}, xx.numpy()), "dense")


def test_init_bounds_and_refusals():
    m = MLP(SIZES, device="cpu").init(torch.Generator().manual_seed(0))
    again = MLP(SIZES, device="cpu").init(torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(m.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
        fan_in = SIZES[int(name.split("_")[1])]
        top = float(p.detach().abs().max())
        assert 0 < top <= fan_in ** -0.5, name
    d = FusedDenseGeluDense(24, 40, 12, device="cpu").init(
        torch.Generator().manual_seed(1))
    assert float(d.dense2.weight.detach().abs().max()) <= 40 ** -0.5
    with pytest.raises(ValueError, match="at least 2"):
        MLP([8], device="cpu")
    with pytest.raises(ValueError, match="activation"):
        MLP([8, 4], activation="tanh", device="cpu")
    with pytest.raises(ValueError, match="bias=True"):
        FusedDenseGeluDense(4, 8, 4, bias=False, device="cpu")
