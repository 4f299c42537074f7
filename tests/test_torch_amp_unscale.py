"""The port's loss-scale ``unscale`` vs the JAX package's on the CPU.

``DynamicLossScale.unscale`` and ``StaticLossScale.unscale`` of
``apex_tpu_torch.amp`` against those of ``apex_tpu.amp.scaler``, for
``cast_to`` in {fp32, bf16, fp16}, over grads in bf16, fp16 and fp32 made
with ``np.random.RandomState(0)``: the reference casts each grad to
``cast_to``, then multiplies by the fp32 ``1 / scale``, and JAX promotes
the product, so every ``cast_to`` gives fp32 grads. The port must give
the same dtype and the same values bit for bit, and pass an int leaf
through untouched.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jsc = importlib.import_module("apex_tpu.amp.scaler")
psc = importlib.import_module("apex_tpu_torch.amp.scaler")

_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "fp16": (jnp.float16, torch.float16)}


def _grads(grad_dtype: str):
    """Float leaves of ``grad_dtype`` (values spanning the fp16 range a
    scaled grad takes) and an int leaf, on both sides."""
    rng = np.random.RandomState(0)
    vals = {"w": rng.randn(7, 13) * 3e3, "b": rng.randn(13) * 1e2}
    jd, td = _DTYPES[grad_dtype]
    steps = np.arange(5, dtype=np.int32)
    jax_tree = {"w": jnp.asarray(vals["w"], jnp.float32).astype(jd),
                "b": jnp.asarray(vals["b"], jnp.float32).astype(jd),
                "step": jnp.asarray(steps)}
    port_tree = {"w": torch.from_numpy(vals["w"]).float().to(td),
                 "b": torch.from_numpy(vals["b"]).float().to(td),
                 "step": torch.from_numpy(steps)}
    return jax_tree, port_tree


def _scalers(kind: str):
    if kind == "dynamic":
        return (jsc.DynamicLossScale(init_scale=3.0 * 2 ** 10),
                psc.DynamicLossScale(init_scale=3.0 * 2 ** 10))
    return jsc.StaticLossScale(384.0 / 7.0), psc.StaticLossScale(384.0 / 7.0)


@pytest.mark.parametrize("kind", ["dynamic", "static"])
@pytest.mark.parametrize("grad_dtype", sorted(_DTYPES))
@pytest.mark.parametrize("cast_to", sorted(_DTYPES))
def test_unscale_matches_reference(kind, grad_dtype, cast_to):
    jax_scaler, port_scaler = _scalers(kind)
    jax_state = jax_scaler.init()
    port_state = port_scaler.init(device="cpu")
    jax_tree, port_tree = _grads(grad_dtype)
    want = jax_scaler.unscale(jax_state, jax_tree,
                              cast_to=_DTYPES[cast_to][0])
    got = port_scaler.unscale(port_state, port_tree,
                              cast_to=_DTYPES[cast_to][1])
    for name in ("w", "b"):
        w = np.asarray(want[name])
        g = got[name]
        assert str(w.dtype) == "float32"
        assert g.dtype == torch.float32, (name, g.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    assert got["step"] is port_tree["step"]
    np.testing.assert_array_equal(np.asarray(want["step"]),
                                  got["step"].numpy())
