"""Rank bodies for the port's distributed CPU tests.

Each function here runs on every rank of an
:class:`apex_tpu_torch.parallel._spawn.RankPool` (gloo on the CPU). The
children import this module by name, so it imports torch, numpy and the
port only: never JAX or the JAX package. Inputs arrive as numpy arrays
stacked by rank on axis 0 (a body takes its own row) or whole; what a
body returns goes back to the test as numpy.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from apex_tpu_torch.transformer import parallel_state as ps


def _rank() -> int:
    return dist.get_rank()


def _mine(tree, dtype=None):
    """This rank's row of every stacked numpy leaf, as tensors."""
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a[_rank()]))
        return t if dtype is None else t.to(dtype)
    return tree_map(one, tree)


def _tensors(tree, dtype=None):
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if dtype is None else t.to(dtype)
    return tree_map(one, tree)


def mesh(tp=1, pp=1, cp=1):
    """(Re)lay the world out at these sizes: every body that names an
    axis calls this first."""
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)


# -- the rank pool itself -------------------------------------------------------

def whoami():
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def skip_the_collective(skipper: int):
    """Every rank but ``skipper`` joins an all-reduce: they wait."""
    x = torch.ones(2)
    if _rank() != skipper:
        dist.all_reduce(x)
    return x


def subgroups_in_a_new_world(store: str):
    """A subgroup summed over, the world torn down and joined again over
    ``store``, the same subgroup summed over again: the second sum must
    run on a group of the new world."""
    import datetime
    from apex_tpu_torch.parallel.distributed import _subgroup, grouped_psum
    groups = [list(range(dist.get_world_size()))]
    x = torch.full((2,), float(_rank() + 1))
    mesh()
    before = grouped_psum(x, "data", groups)
    world, rank = dist.get_world_size(), _rank()
    ps.destroy_model_parallel()
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh()
    after = grouped_psum(10 * x, "data", groups)
    # a group of the new world is registered there; a dead one is not
    group, _ = _subgroup("data", groups)
    return before, after, dist.get_process_group_ranks(group)


def raise_on(rank: int):
    if _rank() == rank:
        raise KeyError(f"raised on rank {rank}")
    return _rank()


# -- parallel_state ------------------------------------------------------------

def layout(tp, pp, cp, local_world=None):
    """This rank's coordinates, predicates, group lists and the members
    of its four process groups; ``local_world`` ranks a node, as
    ``torchrun``'s ``LOCAL_WORLD_SIZE`` says it."""
    import os
    if local_world is None:
        mesh(tp, pp, cp)
    else:
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
        try:
            mesh(tp, pp, cp)
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
    out = {
        "sizes": (ps.get_tensor_model_parallel_world_size(),
                  ps.get_pipeline_model_parallel_world_size(),
                  ps.get_context_parallel_world_size(),
                  ps.get_data_parallel_world_size()),
        "ranks": (ps.get_tensor_model_parallel_rank(),
                  ps.get_pipeline_model_parallel_rank(),
                  ps.get_context_parallel_rank(),
                  ps.get_data_parallel_rank()),
        "first": ps.is_pipeline_first_stage(),
        "last": ps.is_pipeline_last_stage(),
        "next": ps.get_pipeline_model_parallel_next_rank(),
        "prev": ps.get_pipeline_model_parallel_prev_rank(),
        "lists": {"tensor": ps.get_tensor_model_parallel_groups(),
                  "data": ps.get_data_parallel_groups(),
                  "context": ps.get_context_parallel_groups(),
                  "pipe": ps.get_pipeline_model_parallel_groups(),
                  "embedding": ps.get_embedding_ranks()},
        "members": {
            "tensor": dist.get_process_group_ranks(
                ps.get_tensor_model_parallel_group()),
            "data": dist.get_process_group_ranks(
                ps.get_data_parallel_group()),
            "context": dist.get_process_group_ranks(
                ps.get_context_parallel_group()),
            "pipe": dist.get_process_group_ranks(
                ps.get_pipeline_model_parallel_group())},
        "info": ps.get_rank_info(),
    }
    # one all-reduce over each group, so a group that is wrong shows
    for axis in ("tensor", "data", "context", "pipe"):
        x = torch.tensor([float(_rank())])
        dist.all_reduce(x, group=ps.resolve_axis(axis))
        out[f"sum_{axis}"] = float(x)
    return out


def config_mesh(cfg_dict):
    """``TrainConfig.initialize_mesh`` from a config dict: the data
    group's members and sizes."""
    from apex_tpu_torch.config import TrainConfig
    ps.destroy_model_parallel()
    TrainConfig.from_dict(cfg_dict).initialize_mesh()
    return (dist.get_process_group_ranks(ps.get_data_parallel_group()),
            ps.get_rank_info())


# -- DDP ---------------------------------------------------------------------------

def allreduce(grads, kw, dtype=None):
    from apex_tpu_torch.parallel import allreduce_grads
    from apex_tpu_torch.observability import ingraph
    mesh()
    with ingraph.collecting() as col:
        out = allreduce_grads(_mine(grads, dtype), "data", **kw)
        metrics = col.freeze().as_floats()
    return out, metrics


def reducer(tree, kw):
    from apex_tpu_torch.parallel import Reducer
    mesh()
    return Reducer("data", **kw).reduce(_mine(tree))


def ddp_gpt(sizes, state, tokens, bucket_bytes):
    """``DistributedDataParallel.value_and_grad`` of a small GPT's loss
    on this rank's tokens, and the unsynced grads of the same loss."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.parallel import DistributedDataParallel
    mesh()
    cfg = GPTConfig(**sizes)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(_tensors(state))
    params = dict(model.named_parameters())
    tok = _mine(tokens)

    def loss_fn(p, t):
        return model.loss(t, t)

    out = {}
    for what, ddp in (
            ("synced", DistributedDataParallel(bucket_bytes=bucket_bytes)),
            ("local", DistributedDataParallel(delay_allreduce=True))):
        loss, grads = ddp.value_and_grad(loss_fn)(params, tok)
        out[what] = (loss, grads)
    return out


def accumulate(params, xs, ys, bucket_bytes):
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.training import accumulate_gradients
    mesh()
    p = {k: v.requires_grad_(True) for k, v in _tensors(params).items()}
    world, r = dist.get_world_size(), _rank()
    rows = xs.shape[1] // world
    mb = (torch.from_numpy(xs[:, r * rows:(r + 1) * rows].copy()),
          torch.from_numpy(ys[:, r * rows:(r + 1) * rows].copy()))

    def loss_fn(p, mb):
        x, y = mb
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    ddp = DistributedDataParallel("data", delay_allreduce=True,
                                  bucket_bytes=bucket_bytes)
    return accumulate_gradients(ddp, loss_fn, p, mb)


# -- SyncBatchNorm ----------------------------------------------------------------

def syncbn(x, dy, splits, groups, channel_axis, apply_dtype):
    """Rank r normalizes rows ``splits[r]:splits[r + 1]`` of ``x``; the
    output, the new running statistics and the grads of ``sum(out * dy)``
    for x, weight and bias (weight and bias grads summed over the ranks
    of the group, as DDP would)."""
    from apex_tpu_torch.parallel import SyncBatchNorm
    mesh()
    r = _rank()
    c = x.shape[channel_axis]
    bn = SyncBatchNorm(c, axis_name="data", axis_index_groups=groups,
                       channel_axis=channel_axis, device="cpu",
                       apply_dtype=apply_dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, c))
    xr = torch.from_numpy(x[splits[r]:splits[r + 1]].copy()
                          ).requires_grad_(True)
    out = bn(xr)
    (out.float() * torch.from_numpy(dy[splits[r]:splits[r + 1]].copy())
     ).sum().backward()
    return (out.detach(), xr.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean, bn.running_var, bn.num_batches_tracked)


# -- the axis reductions -------------------------------------------------------------

def finite_flags(grads, tp):
    """``all_finite`` over "data", ``scaled_value_and_grad`` with
    ``axis_names="data"`` and ``GradScaler.all_finite_synced`` over the
    model-parallel axes, on this rank's grads."""
    from apex_tpu_torch.amp import (DynamicLossScale, all_finite,
                                    scaled_value_and_grad)
    from apex_tpu_torch.transformer.amp import GradScaler
    mesh(tp=tp)
    g = _mine(grads)
    data = all_finite(g, axis_names="data")
    both = all_finite(g, axis_names=("data", "tensor"))
    scaler = DynamicLossScale(init_scale=4.0)
    w = g["w"].clone().requires_grad_(True)
    step = scaled_value_and_grad(lambda p: (p["w"] * p["w"]).sum(), scaler,
                                 axis_names="data")
    _, _, _, svg_finite, svg_state = step(scaler.init(device="cpu"),
                                          {"w": w})
    synced = GradScaler().all_finite_synced(g)
    return (bool(data), bool(both), bool(svg_finite),
            float(svg_state.loss_scale), bool(synced))


def aggregate(values):
    from apex_tpu_torch.observability import ingraph
    mesh()
    mine = values[_rank()]
    with ingraph.collecting() as col:
        for mode in ingraph.REDUCTIONS:
            ingraph.record(f"x_{mode}", float(mine[mode]), reduce=mode)
        metrics = col.freeze()
    return ingraph.aggregate(metrics, "data").as_floats()


# -- ZeRO --------------------------------------------------------------------------

def zero_run(name, kw, params, grads, steps, finite=True, dtype=None,
             state=None, axis="data"):
    """``steps`` steps of a ZeRO optimizer on this rank's grads from
    ``params`` (or from a bridged JAX ``state``): the params and this
    rank's state."""
    from apex_tpu_torch import optimizers
    from apex_tpu_torch._bridge import zero_state_from_jax
    mesh()
    opt = getattr(optimizers, name)(axis_name=axis, **kw)
    p = _tensors(params, dtype)
    if state is None:
        st = opt.init(p)
    else:
        st = zero_state_from_jax(state, _rank(), dist.get_world_size())
    g = _mine(grads)
    flag = torch.tensor(bool(finite))
    for _ in range(steps):
        opt.step(g, st, p, grads_finite=flag)
    return p, st


def zero_mismatch(params):
    """A state built with one bucket grid, stepped by an optimizer with
    another: the error's text."""
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    mesh()
    p = _tensors(params)
    st = DistributedFusedAdam(bucket_bytes=64).init(p)
    g = tree_map(torch.ones_like, p)
    try:
        DistributedFusedAdam(bucket_bytes=None).step(g, st, p)
    except ValueError as e:
        return str(e)
    return None


def zero_metrics(params, grads, bucket_bytes):
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    mesh()
    p = _tensors(params)
    opt = DistributedFusedAdam(lr=1e-2, bucket_bytes=bucket_bytes)
    st = opt.init(p)
    with ingraph.collecting() as col:
        opt.step(_mine(grads), st, p)
        return col.freeze().as_floats()


# -- a test module's pools ----------------------------------------------------------

class Pools:
    """One :class:`RankPool` a world size, made on first use and
    remade if a call killed it; ``close`` ends them all and checks that
    no rank outlives them."""

    def __init__(self):
        self._pools = {}
        self._pids = []

    def __call__(self, world: int):
        from apex_tpu_torch.parallel._spawn import RankPool
        pool = self._pools.get(world)
        if pool is None or not pool.alive:
            pool = RankPool(world, device="cpu")
            self._pools[world] = pool
            self._pids += pool.pids()
        return pool

    def run(self, world: int, fn, *args, timeout: float = 120.0):
        return self(world).run(fn, *args, timeout=timeout)

    def close(self):
        from apex_tpu_torch.parallel._spawn import children_alive
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()
        left = children_alive(self._pids)
        assert not left, f"ranks outlived their pools: {left}"
