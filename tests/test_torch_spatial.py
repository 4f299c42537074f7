"""The port's halo exchange and height-sharded convolution on gloo ranks
against the JAX package's under ``shard_map``.

The rank bodies live in ``tests/_torch_cp_ranks.py``; the JAX side runs
over ``Mesh(jax.devices()[:sp], ("spatial",))``, the reference's
``tests/test_spatial.py`` the guide:

- ``halo_exchange`` rows at sp 4 (one and two halo rows) bit for bit
  against JAX's, zeros at the boundaries;
- ``spatial_conv2d`` at strides 1 and 2 (sp 2 and 4): each rank's output
  and the grads of its input shard and of the weight (summed over the
  ranks) under ``sum(out * dy)``, against the JAX spatial conv's and the
  dense SAME conv's; the boundary ranks' masked halos pass no gradient
  round the ring (the dense grads would differ there).

Tolerance: 2e-5 absolute and relative, the reference's limit against the
dense conv (fp32 convolutions, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cp_ranks as R
from apex_tpu.parallel.spatial import halo_exchange, spatial_conv2d
from apex_tpu.utils.compat import shard_map

TOL = 2e-5
DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _mesh(sp):
    return Mesh(np.array(jax.devices()[:sp]), ("spatial",))


@pytest.mark.parametrize("rows", [1, 2])
def test_halo_rows_match_jax(pools, rows):
    sp = 4
    x = np.arange(sp * 3 * 5 * 2, dtype=np.float32).reshape(1, sp * 3, 5, 2)
    outs = pools.run(sp, R.halo, x, rows)
    want = np.asarray(shard_map(
        lambda x: halo_exchange(x, "spatial", rows), mesh=_mesh(sp),
        in_specs=P(None, "spatial"), out_specs=P(None, "spatial"))(
            jnp.asarray(x)))
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), want)
    assert np.all(outs[0][:, :rows] == 0) and np.all(outs[-1][:, -rows:] == 0)


@pytest.mark.parametrize("sp,stride", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_spatial_conv_matches_jax_and_dense(pools, sp, stride):
    rng = np.random.RandomState(sp + stride)
    x = rng.randn(2, sp * 4, 10, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 5) * 0.2).astype(np.float32)
    H = -(-x.shape[1] // stride)
    dy = rng.randn(2, H, -(-x.shape[2] // stride), 5).astype(np.float32)
    outs = pools.run(sp, R.spatial, x, w, stride, dy)

    def loss(x, w):
        def inner(x, w, dy):
            out = spatial_conv2d(x, w, "spatial", stride=stride)
            return jax.lax.psum(jnp.sum(out * dy), "spatial"), out
        return shard_map(inner, mesh=_mesh(sp),
                         in_specs=(P(None, "spatial"), P(),
                                   P(None, "spatial")),
                         out_specs=(P(), P(None, "spatial")))(
                             x, w, jnp.asarray(dy))

    (_, out), (gx, gw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))

    def dense(x, w):
        out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                           dimension_numbers=DN)
        return jnp.sum(out * dy), out

    (_, dout), (dgx, dgw) = jax.value_and_grad(
        dense, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    got_out = np.concatenate([o[0] for o in outs], axis=1)
    got_gx = np.concatenate([o[1] for o in outs], axis=1)
    got_gw = sum(o[2] for o in outs)
    for want in ((out, gx, gw), (dout, dgx, dgw)):
        for name, g, w_ in zip(("out", "dx", "dw"), (got_out, got_gx, got_gw),
                               want):
            np.testing.assert_allclose(g, np.asarray(w_), rtol=TOL, atol=TOL,
                                       err_msg=name)
