"""The port's data-parallel gradient sync on gloo ranks against the JAX
package's under ``shard_map``.

The same numpy grads (seeded, one tree a rank) go through the JAX
``allreduce_grads``/``Reducer``/``DistributedDataParallel``/
``accumulate_gradients`` in ``shard_map`` over ``jax.devices()[:N]`` (the
harness of ``tests/test_parallel.py`` and ``tests/test_dp_overlap.py``,
copied) and through the port's on N gloo ranks
(``apex_tpu_torch.parallel._spawn``, one pool a world size for the
module), each rank taking its own slice:

- ``allreduce_grads`` at world 2 and 4: per leaf, bucketed, with a
  predivide factor (both paths), without averaging, fp32-always over bf16
  grads, over equal and uneven ``axis_index_groups``; the ``ddp/*``
  metrics; fp32 at rtol 1e-6 and an atol of 1e-6 of the tensor's
  largest magnitude, at least 1e-7 (gloo's ring adds in another order
  than XLA's ``psum``; ``_close``), bf16 within one bf16 ulp;
- ``Reducer`` per leaf, bucketed and over groups;
- ``DistributedDataParallel.value_and_grad`` on a 2-layer d 64 GPT
  (dropout 0) against JAX's DDP grads at ``tests/test_torch_train.py``'s
  one-device limits (loss 1e-5, grads 1e-6 absolute), and the synced
  grads against the mean of the ranks' unsynced grads (``_close``);
- ``accumulate_gradients`` per leaf and bucketed against JAX's window,
  and its errors (an empty window, an unbound axis);
- the constructors' exclusion of ``bucket_bytes`` with groups, and the
  bucketed engine's refusal of groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist_ranks as R
from apex_tpu.parallel import (DistributedDataParallel as JDDP,
                               Reducer as JReducer,
                               allreduce_grads as j_allreduce)
from apex_tpu.utils.compat import shard_map

RTOL, ATOL = 1e-6, 1e-7
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def pools():
    p = R.Pools()
    yield p
    p.close()


def _per_rank(fn, n, *stacked):
    """``fn`` on each of ``n`` devices' rows of the stacked inputs; the
    outputs stacked by rank."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def inner(*xs):
        xs = [jax.tree_util.tree_map(lambda a: a[0], x) for x in xs]
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None],
                                      fn(*xs))

    specs = tuple(jax.tree_util.tree_map(lambda _: P("data"), x)
                  for x in stacked)
    return jax.jit(shard_map(inner, mesh=mesh, in_specs=specs,
                             out_specs=P("data")))(*stacked)


def _grads(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"b": rng.randn(n, 13).astype(np.float32),
            "emb": rng.randn(n, 5, 16).astype(np.float32),
            "w": rng.randn(n, 100, 7).astype(np.float32)}


def _close(got, want, bf16=False):
    """fp32: rtol 1e-6 and an atol of 1e-6 of the tensor's largest
    magnitude (at least 1e-7): gloo's ring adds the ranks' terms in
    another order than XLA's ``psum``, which moves a sum by an ulp of its
    largest term, not of the result (a sum near 0 moves by more than
    1e-6 of itself). bf16: one bf16 ulp."""
    want = np.asarray(want, np.float32)
    if bf16:
        rtol = atol = BF16_ULP
    else:
        rtol, atol = RTOL, max(ATOL, RTOL * float(np.abs(want).max(
            initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=rtol, atol=atol)


def _check_ranks(outs, jout, bf16=False):
    for r, got in enumerate(outs):
        for k in jout:
            _close(got[k], np.asarray(jout[k], np.float32)[r], bf16)


AR_CASES = {
    "per_leaf": {},
    "bucketed": {"bucket_bytes": 256},
    "predivide": {"gradient_predivide_factor": 2.0},
    "predivide_bucketed": {"gradient_predivide_factor": 4.0,
                           "bucket_bytes": 1024},
    "sum": {"gradient_average": False},
    "sum_predivide": {"gradient_average": False,
                      "gradient_predivide_factor": 2.0},
    "sum_bucketed": {"gradient_average": False, "bucket_bytes": 256},
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(AR_CASES))
def test_allreduce_grads_matches_jax(pools, case, world):
    kw = AR_CASES[case]
    grads = _grads(world)
    jout = _per_rank(lambda g: j_allreduce(g, "data", **kw), world,
                     {k: jnp.asarray(v) for k, v in grads.items()})
    outs = pools.run(world, R.allreduce, grads, kw)
    _check_ranks([o for o, _ in outs], jout)
    metrics = outs[0][1]
    total = sum(v[0].size for v in grads.values())
    assert metrics["ddp/allreduce_bytes"] == 4 * total
    if "bucket_bytes" in kw:
        assert metrics["ddp/num_buckets"] == -(-total // (
            kw["bucket_bytes"] // 4))
        assert metrics["ddp/bucket_bytes"] == kw["bucket_bytes"]
    else:
        assert metrics["ddp/buckets"] == len(grads)


@pytest.mark.parametrize("always_fp32", [True])
def test_allreduce_bf16_grads_in_fp32(pools, always_fp32):
    grads = _grads(2, 1)
    jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()}
    kw = {"allreduce_always_fp32": always_fp32,
          "gradient_predivide_factor": 2.0}
    jout = _per_rank(lambda g: j_allreduce(g, "data", **kw), 2, jg)
    host = {k: np.asarray(v, np.float32) for k, v in jg.items()}
    outs = pools.run(2, R.allreduce, host, kw, R.torch.bfloat16)
    _check_ranks([o for o, _ in outs], jout, bf16=True)
    total = sum(v[0].size for v in grads.values())
    assert outs[0][1]["ddp/allreduce_bytes"] == 4 * total


@pytest.mark.parametrize("groups,world", [
    ([[0, 1], [2, 3]], 4), ([[0], [1, 2, 3]], 4), ([[0, 2], [1, 3]], 4),
    ([[0], [1]], 2)], ids=["halves", "uneven", "strided", "singletons"])
def test_allreduce_grads_over_groups(pools, groups, world):
    grads = _grads(world, 2)
    kw = {"axis_index_groups": groups}
    jout = _per_rank(lambda g: j_allreduce(g, "data", **kw), world,
                     {k: jnp.asarray(v) for k, v in grads.items()})
    outs = pools.run(world, R.allreduce, grads, kw)
    _check_ranks([o for o, _ in outs], jout)
    # each rank averaged by its own group's size
    for g in groups:
        for r in g:
            want = np.mean([grads["b"][i] for i in g], axis=0)
            _close(outs[r][0]["b"], want)


@pytest.mark.parametrize("kw", [{}, {"bucket_bytes": 512},
                                {"axis_index_groups": [[0], [1, 2, 3]]}],
                         ids=["per_leaf", "bucketed", "groups"])
def test_reducer_matches_jax(pools, kw):
    tree = _grads(4, 3)
    jout = _per_rank(lambda t: JReducer("data", **kw).reduce(t), 4,
                     {k: jnp.asarray(v) for k, v in tree.items()})
    _check_ranks(pools.run(4, R.reducer, tree, kw), jout)


def test_bucket_bytes_and_groups_are_exclusive():
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         allreduce_grads)
    for cls in (DistributedDataParallel, Reducer):
        with pytest.raises(ValueError, match="mutually exclusive"):
            cls("data", axis_index_groups=[[0]], bucket_bytes=64)
    with pytest.raises(ValueError, match="mutually exclusive"):
        allreduce_grads({"w": R.torch.ones(2)}, "data",
                        axis_index_groups=[[0]], bucket_bytes=64)


# -- DDP on a small GPT ---------------------------------------------------------

GPT_SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=32)


@pytest.mark.parametrize("world,bucket_bytes", [(2, None), (2, 4096),
                                                (4, 4096)])
def test_ddp_value_and_grad_on_gpt(pools, world, bucket_bytes):
    from apex_tpu.models import GPTConfig as JCfg, GPTModel as JGPT
    from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
    from apex_tpu_torch.models import GPTConfig

    jm = JGPT(JCfg(compute_dtype=jnp.float32, **GPT_SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(
        0, GPT_SIZES["vocab_size"], (world, 2, 32))
    ddp = JDDP("data", bucket_bytes=bucket_bytes)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def inner(p, tok):
        loss, g = ddp.value_and_grad(
            lambda p, t: jm.loss(p, t, t))(p, tok[0])
        return loss[None], g

    j_loss, j_grads = jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P(), P("data")),
        out_specs=(P("data"), P())))(jp, jnp.asarray(tokens))
    cfg = GPTConfig(compute_dtype=R.torch.float32, **GPT_SIZES)
    state = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg).items()}
    outs = pools.run(world, R.ddp_gpt,
                     dict(GPT_SIZES, compute_dtype=R.torch.float32), state,
                     tokens, bucket_bytes)
    local_mean = {k: np.mean([o["local"][1][k] for o in outs], axis=0)
                  for k in outs[0]["local"][1]}
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["synced"][0], np.asarray(j_loss)[r],
                                   atol=1e-5)
        got = params_to_numpy({k: R.torch.from_numpy(v)
                               for k, v in o["synced"][1].items()}, cfg)
        for path, want in jax.tree_util.tree_leaves_with_path(j_grads):
            g = got
            for key in path:
                g = g[key.key]
            np.testing.assert_allclose(g, np.asarray(want), atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
        for k, v in o["synced"][1].items():
            _close(v, local_mean[k])


# -- accumulate_gradients -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bucket_bytes", [None, 256])
def test_accumulate_gradients_matches_jax(pools, world, bucket_bytes):
    from apex_tpu.training import accumulate_gradients as j_accumulate

    rng = np.random.RandomState(6)
    K = 3
    params = {"w1": rng.randn(4, 33).astype(np.float32),
              "w2": rng.randn(33, 2).astype(np.float32)}
    xs = rng.randn(K, 16, 4).astype(np.float32)
    ys = rng.randn(K, 16, 2).astype(np.float32)

    def loss_fn(p, mb):
        x, y = mb
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    ddp = JDDP("data", delay_allreduce=True, bucket_bytes=bucket_bytes)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    def inner(p, xs, ys):
        loss, grads = j_accumulate(ddp, loss_fn, p, (xs, ys))
        return loss[None], grads

    j_loss, j_grads = jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P(), P(None, "data"), P(None, "data")),
        out_specs=(P("data"), P())))(params, xs, ys)
    outs = pools.run(world, R.accumulate, params, xs, ys, bucket_bytes)
    for r, (loss, grads) in enumerate(outs):
        _close(loss, np.asarray(j_loss)[r])
        for k in params:
            _close(grads[k], j_grads[k])


def test_accumulate_gradients_errors():
    import torch

    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.training import accumulate_gradients

    ddp = DistributedDataParallel("data", delay_allreduce=True)
    p = torch.zeros(2, 2, requires_grad=True)
    with pytest.raises(ValueError, match="num_micro == 0"):
        accumulate_gradients(ddp, lambda p, mb: p.sum(), p,
                             torch.zeros(0, 4))
    with pytest.raises(ValueError, match="disagree"):
        accumulate_gradients(ddp, lambda p, mb: p.sum(), p,
                             (torch.zeros(2, 4), torch.zeros(3, 4)))
    for axis in ("nonexistent_axis", "data"):   # unknown; none initialized
        ddp = DistributedDataParallel(axis, delay_allreduce=True)
        with pytest.raises(ValueError, match="is not bound"):
            accumulate_gradients(ddp, lambda p, mb: p.sum(), p,
                                 torch.zeros(3, 4))
