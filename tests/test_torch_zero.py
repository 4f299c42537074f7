"""The port's ZeRO-1 optimizers on gloo ranks against the JAX package's
under ``shard_map``, and ``TrainConfig``'s ZeRO spellings.

The same numpy params and per-rank grads (seeded) go through the JAX
``DistributedFusedAdam``/``DistributedFusedLAMB`` in ``shard_map`` over
``jax.devices()[:dp]`` (the harness of
``tests/test_distributed_optimizers.py::_run_zero``, copied) and through
the port's on ``dp`` gloo ranks (``apex_tpu_torch.parallel._spawn``, one
pool a world size for the module), each rank stepping its own grads:

- Adam (AdamW and the L2 mode) and LAMB, monolithic and bucketed, 3-step
  trajectories at dp 2 and 4: params and each rank's state shard against
  JAX's at 1e-6 (relative and absolute: sums over ranks and leaves in
  another order);
- the layout bit for bit: shard sizes ``padded / dp``, the bucket-major
  shard order (the state's shards concatenated equal JAX's global arrays
  at 1e-6 element by element);
- the overflow skip (params, state and step count kept, bit for bit);
  bf16 params with an fp32 master (params within one bf16 ulp, the
  master at 1e-6); a bucket-grid mismatch raises; the ``zero/*`` and
  ``ddp/*`` metrics;
- a JAX state carried into each rank's port state
  (``_bridge.zero_state_from_jax``), stepped twice more by both, equal at
  1e-6, and carried back (``zero_state_to_numpy``);
- ``TrainConfig``: ``zero`` off/1 spellings build ``FusedAdam`` or the
  ZeRO optimizers with the bucket grid, ``"auto"`` raises naming A7b,
  ``fastpath()`` equal to the JAX config's ``fastpath()`` as a dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist_ranks as R
from apex_tpu.optimizers import DistributedFusedAdam as JAdam
from apex_tpu.optimizers import DistributedFusedLAMB as JLamb
from apex_tpu.optimizers import ZeroAdamState as JState
from apex_tpu.utils.compat import shard_map

TOL = 1e-6
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def pools():
    p = R.Pools()
    yield p
    p.close()


def _params(seed=0):
    # keys in sorted order: JAX flattens a dict sorted, torch as inserted
    rng = np.random.RandomState(seed)
    return {"b": rng.randn(33).astype(np.float32),
            "emb": rng.randn(7, 16).astype(np.float32),
            "w": rng.randn(16, 33).astype(np.float32)}   # odd: padding


def _grads(params, dp, seed=1):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(dp, *v.shape).astype(np.float32)
            for k, v in params.items()}


def _jax_zero(opt, params, grads, dp, steps, finite=True, dtype=None,
              state=None):
    mesh = Mesh(np.array(jax.devices()[:dp]), ("data",))
    spec = JState(step=P(), master=P("data"), exp_avg=P("data"),
                  exp_avg_sq=P("data"), bucket_stamp=P())
    p0 = {k: jnp.asarray(v, dtype or jnp.float32) for k, v in params.items()}
    g0 = {k: jnp.asarray(v) for k, v in grads.items()}
    flag = jnp.asarray(finite)

    def inner(p, g, st):
        g = jax.tree_util.tree_map(lambda s: s[0], g)
        if st is None:
            st = opt.init(p)
        for _ in range(steps):
            p, st = opt.step(g, st, p, grads_finite=flag)
        return p, st

    gspec = jax.tree_util.tree_map(lambda _: P("data"), g0)
    if state is None:
        f = shard_map(lambda p, g: inner(p, g, None), mesh=mesh,
                      in_specs=(P(), gspec), out_specs=(P(), spec))
        return jax.jit(f)(p0, g0)
    f = shard_map(inner, mesh=mesh, in_specs=(P(), gspec, spec),
                  out_specs=(P(), spec))
    return jax.jit(f)(p0, g0, state)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check(outs, jp, jst, dp, tol=TOL):
    """Every rank's params against JAX's, and the ranks' shards,
    concatenated, against JAX's global state."""
    for p, _ in outs:
        for k in jp:
            _close(p[k], jp[k], tol)
    chunk = np.asarray(jst.master).shape[0] // dp
    for field in ("master", "exp_avg", "exp_avg_sq"):
        for r, (_, st) in enumerate(outs):
            assert getattr(st, field).shape == (chunk,)
        _close(np.concatenate([getattr(st, field) for _, st in outs]),
               getattr(jst, field), tol)
    assert {int(st.step) for _, st in outs} == {int(jst.step)}
    assert {int(st.bucket_stamp) for _, st in outs} == {int(jst.bucket_stamp)}


CASES = {
    "adam": ("DistributedFusedAdam", JAdam,
             dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)),
    "adam_l2": ("DistributedFusedAdam", JAdam,
                dict(lr=1e-2, adam_w_mode=False, weight_decay=0.1)),
    "lamb": ("DistributedFusedLAMB", JLamb,
             dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0)),
}


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("bucket_bytes", [None, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_zero_trajectory_matches_jax(pools, case, bucket_bytes, dp):
    name, jcls, kw = CASES[case]
    kw = dict(kw, bucket_bytes=bucket_bytes)
    params, grads = _params(), _grads(_params(), dp)
    jp, jst = _jax_zero(jcls(**kw), params, grads, dp, 3)
    outs = pools.run(dp, R.zero_run, name, kw, params, grads, 3)
    _check(outs, jp, jst, dp)
    total = sum(v.size for v in params.values())
    padded = -(-total // dp) * dp
    assert outs[0][1].master.shape == (padded // dp,)


@pytest.mark.parametrize("case", ["adam", "lamb"])
def test_zero_overflow_skip_keeps_everything(pools, case):
    name, _, kw = CASES[case]
    params, grads = _params(3), _grads(_params(3), 2, 4)
    outs = pools.run(2, R.zero_run, name, dict(kw, bucket_bytes=64), params,
                     grads, 2, False)
    for r, (p, st) in enumerate(outs):
        for k in params:
            np.testing.assert_array_equal(p[k], params[k])
        assert int(st.step) == 0
        assert not st.exp_avg.any() and not st.exp_avg_sq.any()
    # each rank's master is its half of every 16-element bucket
    flat = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    flat = np.pad(flat, (0, -flat.size % 2))
    for r, (_, st) in enumerate(outs):
        want = np.concatenate([flat[o:o + 16][r * n // 2:(r + 1) * n // 2]
                               for o in range(0, flat.size, 16)
                               for n in [min(16, flat.size - o)]])
        np.testing.assert_array_equal(st.master, want)


def test_zero_bf16_params_keep_an_fp32_master(pools):
    kw = dict(lr=1e-2, weight_decay=0.01, bucket_bytes=64)
    params, grads = _params(5), _grads(_params(5), 2, 6)
    jp, jst = _jax_zero(JAdam(**kw), params, grads, 2, 3,
                        dtype=jnp.bfloat16)
    outs = pools.run(2, R.zero_run, "DistributedFusedAdam", kw, params,
                     grads, 3, True, R.torch.bfloat16)
    chunk = np.asarray(jst.master).shape[0] // 2
    for r, (p, st) in enumerate(outs):
        for k in params:
            np.testing.assert_allclose(p[k], np.asarray(jp[k], np.float32),
                                       rtol=BF16_ULP, atol=BF16_ULP)
        _close(st.master, np.asarray(jst.master)[r * chunk:(r + 1) * chunk])
        assert st.master.dtype == np.float32


def test_zero_bucket_grid_mismatch_raises(pools):
    msgs = pools.run(2, R.zero_mismatch, _params())
    assert all(m is not None and "bucket_bytes=64" in m for m in msgs)


def test_zero_metrics(pools):
    params = _params()
    grads = _grads(params, 2)
    total = sum(v.size for v in params.values())
    padded = -(-total // 2) * 2
    for bb in (None, 64):
        m = pools.run(2, R.zero_metrics, params, grads, bb)[0]
        assert m["ddp/reduce_scatter_bytes"] == 4 * padded
        assert m["zero/shard_bytes"] == 4 * padded // 2
        assert ("ddp/num_buckets" in m) == (bb is not None)
        if bb:
            assert m["ddp/num_buckets"] == -(-padded // 16)
            assert m["ddp/bucket_bytes"] == 64


@pytest.mark.parametrize("case", ["adam", "lamb"])
def test_bridged_jax_state_steps_like_jax(pools, case):
    from apex_tpu_torch._bridge import zero_state_to_numpy
    name, jcls, kw = CASES[case]
    kw = dict(kw, bucket_bytes=64)
    params, grads = _params(7), _grads(_params(7), 2, 8)
    jp, jst = _jax_zero(jcls(**kw), params, grads, 2, 3)
    host = {k: np.asarray(v) for k, v in jst._asdict().items()}
    host_p = {k: np.asarray(v) for k, v in jp.items()}
    jp2, jst2 = _jax_zero(jcls(**kw), host_p, grads, 2, 2, state=jst)
    outs = pools.run(2, R.zero_run, name, kw, host_p, grads, 2, True, None,
                     host)
    _check(outs, jp2, jst2, 2)
    back = zero_state_to_numpy([st for _, st in outs])
    for field in ("master", "exp_avg", "exp_avg_sq"):
        _close(back[field], getattr(jst2, field))
    assert int(back["step"]) == 5 and int(back["bucket_stamp"]) == 64


# -- TrainConfig ---------------------------------------------------------------------

def test_config_zero_spellings():
    from apex_tpu_torch.config import OptimizerConfig, TrainConfig
    from apex_tpu_torch.optimizers import (DistributedFusedAdam,
                                           DistributedFusedLAMB, FusedAdam)

    def build(z, name="adam", bb=None):
        return TrainConfig(optimizer=OptimizerConfig(name=name, zero=z),
                           ddp_bucket_bytes=bb).build_optimizer()

    for z in (False, 0, "off"):
        assert isinstance(build(z), FusedAdam)
    for z in (True, 1, "1"):
        assert isinstance(build(z), DistributedFusedAdam)
    assert build(1, "adamw").adam_w_mode and not build(1).adam_w_mode
    lamb = build(1, "lamb", 4 << 20)
    assert isinstance(lamb, DistributedFusedLAMB)
    assert lamb.bucket_bytes == 4 << 20 and build(1, bb=4096).bucket_bytes \
        == 4096
    with pytest.raises(ValueError, match="zero"):
        build("2")
    with pytest.raises(ValueError, match="no ZeRO variant"):
        build(1, "sgd")
    with pytest.raises(NotImplementedError, match="A7b"):
        build(1, bb="auto")


@pytest.mark.parametrize("kw", [
    {}, {"bucket_bytes": 1 << 20}, {"bucket_bytes": None},
], ids=["auto", "pinned", "monolithic"])
@pytest.mark.parametrize("receiver", ["plain", "grid", "remat", "lamb"])
def test_fastpath_matches_the_reference_config(kw, receiver):
    from apex_tpu import config as jcfg
    from apex_tpu_torch import config as tcfg

    def make(mod):
        return {
            "plain": mod.TrainConfig(),
            "grid": mod.TrainConfig(ddp_bucket_bytes=2048),
            "remat": mod.TrainConfig(model=mod.ModelConfig(remat=True)),
            "lamb": mod.TrainConfig(optimizer=mod.OptimizerConfig(
                name="lamb")),
        }[receiver]

    got = make(tcfg).fastpath(**kw)
    assert got.to_dict() == make(jcfg).fastpath(**kw).to_dict()
    assert got.optimizer.zero == 1
    if got.ddp_bucket_bytes == "auto":
        with pytest.raises(NotImplementedError, match="A7b"):
            got.build_optimizer()
    else:
        assert got.build_optimizer().bucket_bytes == got.ddp_bucket_bytes
    with pytest.raises(ValueError, match="ZeRO-capable"):
        tcfg.TrainConfig(optimizer=tcfg.OptimizerConfig(
            name="sgd")).fastpath()
