"""Cross-rank batch norm and the axis reductions of the port on gloo
ranks, against the JAX package's under ``shard_map``.

- ``SyncBatchNorm`` over "data" at world 2 and 4, NCHW and NHWC, fp32 and
  with the bf16 apply, and over equal and uneven ``axis_index_groups``:
  each rank's output and input grads, the weight and bias grads summed
  over the ranks, and the running statistics against the JAX
  ``SyncBatchNorm`` (grads through ``psum`` by AD), at 1e-6 of each
  tensor's largest magnitude (bf16 outputs: one bf16 ulp);
- uneven batches a rank (5 + 11 rows, 3 + 1 + 8 + 4): against the JAX
  package's one-device batch norm over the whole batch, at 1e-6;
- ``convert_syncbn_model`` over a port ResNet, sharing the parameters,
  and ``create_syncbn_process_group`` against the reference's;
- ``all_finite`` over "data" and over ("data", "tensor"),
  ``scaled_value_and_grad(axis_names="data")`` and
  ``GradScaler.all_finite_synced`` on a (1, 2, 1, 2) mesh with a NaN on
  one rank, against the JAX functions on the same mesh;
- ``ingraph.aggregate`` over "data" for each declared reduction against
  the JAX ``aggregate``; without parallel state an axis name raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist_ranks as R
from apex_tpu.parallel import SyncBatchNorm as JBN
from apex_tpu.parallel import sync_batch_norm as j_sync_bn
from apex_tpu.utils.compat import shard_map

TOL = 1e-6
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def pools():
    p = R.Pools()
    yield p
    p.close()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _bn_params(c):
    return {"weight": jnp.linspace(0.5, 1.5, c, dtype=jnp.float32),
            "bias": jnp.linspace(-0.2, 0.3, c, dtype=jnp.float32)}


def _jax_syncbn(x, dy, n, groups, channel_axis, apply_dtype):
    """Per-rank outputs, x grads and running statistics, and the weight
    and bias grads of the psum'd loss."""
    c = x.shape[channel_axis]
    bn = JBN(c, axis_name="data", axis_index_groups=groups,
             channel_axis=channel_axis)
    _, state = bn.init()
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def loss(params, x):
        def inner(params, x, dy):
            out, st = j_sync_bn(
                x, params["weight"], params["bias"], state, training=True,
                channel_axis=channel_axis, axis_name="data",
                axis_index_groups=groups, apply_dtype=apply_dtype)
            total = jax.lax.psum(jnp.sum(out.astype(jnp.float32) * dy),
                                 "data")
            return total, (out, st.running_mean[None],
                           st.running_var[None])
        return shard_map(inner, mesh=mesh,
                         in_specs=(P(), P("data"), P("data")),
                         out_specs=(P(), (P("data"), P("data"),
                                          P("data"))))(params, x, dy)

    (_, aux), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(_bn_params(c), x)
    return aux, grads


@pytest.mark.parametrize("world,groups", [
    (2, None), (4, None), (4, [[0, 1], [2, 3]]), (4, [[0], [1, 2, 3]])],
    ids=["w2", "w4", "w4-halves", "w4-uneven-groups"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc", "nhwc-bf16"])
def test_sync_batch_norm_matches_jax(pools, world, groups, layout):
    rng = np.random.RandomState(3)
    n_local = 4
    if layout == "nchw":
        shape, ca, apply = (world * n_local, 6, 5, 5), 1, None
    else:
        shape, ca = (world * n_local, 5, 5, 6), -1
        apply = R.torch.bfloat16 if layout == "nhwc-bf16" else None
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    (out, rmean, rvar), (gp, gx) = _jax_syncbn(
        jnp.asarray(x), jnp.asarray(dy), world, groups, ca,
        None if apply is None else jnp.bfloat16)
    splits = [r * n_local for r in range(world + 1)]
    outs = pools.run(world, R.syncbn, x, dy, splits, groups, ca, apply)
    bf16 = apply is not None
    for r, (o, dx, dw, db, rm, rv, nbt) in enumerate(outs):
        rows = slice(splits[r], splits[r + 1])
        if bf16:
            np.testing.assert_allclose(o, np.asarray(out, np.float32)[rows],
                                       rtol=2 * BF16_ULP, atol=2 * BF16_ULP)
        else:
            _close(o, np.asarray(out)[rows])
            _close(dx, np.asarray(gx)[rows])
        _close(rm, np.asarray(rmean)[r])
        _close(rv, np.asarray(rvar)[r])
        assert int(nbt) == 1
    if not bf16:
        _close(sum(o[2] for o in outs), gp["weight"])
        _close(sum(o[3] for o in outs), gp["bias"])


@pytest.mark.parametrize("splits", [[0, 5, 16], [0, 3, 4, 12, 16]],
                         ids=["5+11", "3+1+8+4"])
def test_sync_batch_norm_uneven_batches(pools, splits):
    world = len(splits) - 1
    rng = np.random.RandomState(4)
    x = (rng.randn(16, 7) * 3 - 1).astype(np.float32)
    dy = rng.randn(16, 7).astype(np.float32)
    params = _bn_params(7)
    _, state = JBN(7, channel_axis=-1).init()

    def loss(params, x):
        out, st = j_sync_bn(x, params["weight"], params["bias"], state,
                            training=True, channel_axis=-1)
        return jnp.sum(out * dy), (out, st)

    (_, (out, st)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    outs = pools.run(world, R.syncbn, x, dy, splits, None, -1, None)
    _close(np.concatenate([o[0] for o in outs]), out)
    _close(np.concatenate([o[1] for o in outs]), gx)
    _close(sum(o[2] for o in outs), gp["weight"])
    _close(sum(o[3] for o in outs), gp["bias"])
    for o in outs:
        _close(o[4], st.running_mean)
        _close(o[5], st.running_var)


def test_convert_syncbn_model_and_groups():
    import torch

    from apex_tpu.parallel import (
        create_syncbn_process_group as j_groups)
    from apex_tpu_torch.models import ResNet50, ResNetConfig
    from apex_tpu_torch.parallel import (SyncBatchNorm,
                                         convert_syncbn_model,
                                         create_syncbn_process_group)

    model = ResNet50(ResNetConfig(num_classes=10, stage_sizes=(1, 1, 1, 1),
                                  width=8), device="cpu")
    before = {n: p for n, p in model.named_parameters()}
    bufs = {n: b for n, b in model.named_buffers()}
    out = convert_syncbn_model(model, axis_name="data",
                               axis_index_groups=[[0, 1]])
    assert out is model
    bns = [m for m in model.modules() if isinstance(m, SyncBatchNorm)]
    assert bns and all(m.axis_name == "data"
                       and m.axis_index_groups == [[0, 1]] for m in bns)
    after = dict(model.named_parameters())
    assert after.keys() == before.keys()
    assert all(after[n] is p for n, p in before.items())
    assert all(b is bufs[n] for n, b in model.named_buffers())
    kept = SyncBatchNorm(3, axis_name="tensor", device="cpu")
    assert convert_syncbn_model(kept) is kept
    mixed = convert_syncbn_model([SyncBatchNorm(2, device="cpu"), "x",
                                  {"k": SyncBatchNorm(2, device="cpu")}])
    assert mixed[0].axis_name == "data" and mixed[1] == "x"
    assert mixed[2]["k"].axis_name == "data"
    for size, world in ((0, 8), (4, 8), (2, 4), (1, 2)):
        assert create_syncbn_process_group(size, world) == j_groups(size,
                                                                    world)
    with pytest.raises(ValueError, match="divisible"):
        create_syncbn_process_group(3, 8)
    assert create_syncbn_process_group(0) == [[0]]
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="not bound"):
        SyncBatchNorm(3, axis_name="data", device="cpu")(x)


# -- the finite flags and aggregate --------------------------------------------------

def _mesh4():
    devs = np.array(jax.devices()[:4]).reshape(1, 2, 1, 2)
    return Mesh(devs, ("pipe", "data", "context", "tensor"))


@pytest.mark.parametrize("bad", [None, 1, 2])
def test_finite_flags_match_jax(pools, bad):
    from apex_tpu.amp import (DynamicLossScale as JScale,
                              all_finite as j_all_finite,
                              scaled_value_and_grad as j_svg)
    from apex_tpu.transformer.amp import GradScaler as JGradScaler

    rng = np.random.RandomState(9)
    grads = {"w": rng.randn(4, 3, 5).astype(np.float32)}
    if bad is not None:
        grads["w"][bad, 1, 2] = np.nan
    axes = ("pipe", "data", "context", "tensor")
    scaler = JScale(init_scale=4.0)

    def inner(g):
        g = {"w": g["w"][0]}
        st = scaler.init()
        _, _, _, fin, st = j_svg(lambda p: jnp.sum(p["w"] * p["w"]), scaler,
                                 axis_names="data")(st, g)
        return tuple(jnp.asarray(v)[None] for v in (
            j_all_finite(g, axis_names="data"),
            j_all_finite(g, axis_names=("data", "tensor")), fin,
            st.loss_scale, JGradScaler().all_finite_synced(g)))

    want = jax.jit(shard_map(inner, mesh=_mesh4(), in_specs=P(axes),
                             out_specs=P(axes)))(grads)
    outs = pools.run(4, R.finite_flags, grads, 2)
    for r, got in enumerate(outs):
        assert got == tuple(type(g)(np.asarray(w)[r])
                            for g, w in zip(got, want)), r


def test_aggregate_matches_jax(pools):
    from apex_tpu.observability import ingraph as jingraph

    rng = np.random.RandomState(10)
    values = [{m: float(rng.randn()) for m in jingraph.REDUCTIONS}
              for _ in range(4)]
    table = np.asarray([[v[m] for m in jingraph.REDUCTIONS] for v in values],
                       np.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))

    def inner(row):
        with jingraph.collecting() as col:
            for i, m in enumerate(jingraph.REDUCTIONS):
                jingraph.record(f"x_{m}", row[0, i], reduce=m)
            metrics = col.freeze()
        agg = jingraph.aggregate(metrics, "data")
        return {k: v[None] for k, v in agg.values.items()}

    want = jax.jit(shard_map(inner, mesh=mesh, in_specs=P("data"),
                             out_specs=P("data")))(table)
    outs = pools.run(4, R.aggregate, values)
    for r, got in enumerate(outs):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k])[r],
                                       rtol=1e-6)
