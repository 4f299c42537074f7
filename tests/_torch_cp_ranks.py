"""Rank bodies for the port's context-, expert- and spatial-parallel and
checkpoint CPU tests.

Each function here runs on every rank of an
:class:`apex_tpu_torch.parallel._spawn.RankPool` (gloo on the CPU). The
children import this module by name, so it imports torch, numpy and the
port only: never JAX or the JAX package. Inputs arrive whole as numpy
arrays (the same on every rank), and a body cuts its own shard; what it
returns goes back to the test as numpy.
"""

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mesh(tp=1, pp=1, cp=1):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)


def _t(a, dtype="float32", grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(DTYPES[dtype])
    return t.requires_grad_(True) if grad else t


def _shard(a, axis):
    rank, world = dist.get_rank(), dist.get_world_size()
    return np.array_split(np.asarray(a), world, axis=axis)[rank]


# -- context parallelism -------------------------------------------------------

def attention(kind, cp, q, k, v, dy, causal, remat=True, dtype="float32"):
    """This rank's output shard of ``ring_attention`` or
    ``ulysses_attention`` over the context group, and the grads of its
    q/k/v shards under ``sum(out * dy_shard)``."""
    from apex_tpu_torch.transformer import context_parallel as cpm
    mesh(cp=cp)
    qs, ks, vs = (_t(_shard(x, 2), dtype, grad=True) for x in (q, k, v))
    if kind == "ring":
        out = cpm.ring_attention(qs, ks, vs, "context", causal=causal,
                                 remat=remat)
    else:
        out = cpm.ulysses_attention(qs, ks, vs, "context", causal=causal)
    (out.float() * _t(_shard(dy, 2))).sum().backward()
    return out, qs.grad, ks.grad, vs.grad


def ulysses_heads_error(cp, q):
    """The message of the ``ValueError`` a head count ``cp`` does not
    divide raises."""
    from apex_tpu_torch.transformer import context_parallel as cpm
    mesh(cp=cp)
    x = _t(_shard(q, 2))
    try:
        cpm.ulysses_attention(x, x, x, "context")
    except ValueError as e:
        return str(e)
    return None


def config_cp(cfg_dict):
    """``TrainConfig.from_dict(cfg_dict)``'s mesh and model on this rank:
    the context, tensor and data groups, and the model's parameter
    shapes."""
    from apex_tpu_torch.config import TrainConfig
    cfg = TrainConfig.from_dict(cfg_dict)
    ps.destroy_model_parallel()
    cfg.initialize_mesh()
    model = cfg.build_model(device="cpu")
    return {"context": ps.get_context_parallel_groups(),
            "tensor": ps.get_tensor_model_parallel_groups(),
            "data": ps.get_data_parallel_groups(),
            "cp": (ps.get_context_parallel_world_size(),
                   ps.get_context_parallel_rank()),
            "shapes": {n: tuple(p.shape)
                       for n, p in model.named_parameters()}}


# -- expert parallelism ----------------------------------------------------------

def moe(ep, tree, x, sizes, aux_weight, dtype="float32"):
    """``ExpertParallelMLP(**sizes)`` over the world on this rank's tokens
    (``x`` split on axis 0) with its experts (``tree`` the JAX ``init``
    tree as numpy): out, aux, the tokens dropped, and the grads of the
    router and this rank's experts under ``sum(out**2) + aux_weight *
    aux / ep`` (this rank's share of the JAX objective)."""
    from apex_tpu_torch._bridge import moe_params_from_jax
    from apex_tpu_torch.transformer.expert_parallel import ExpertParallelMLP
    rank = dist.get_rank()
    layer = ExpertParallelMLP(**sizes, axis_name=dist.group.WORLD)
    params = moe_params_from_jax(tree, ep, rank)
    for leaf in (params["router"]["weight"], *params["experts"].values()):
        leaf.requires_grad_(True)
    xs = _t(_shard(x, 0), dtype)
    out, aux = layer(params, xs)
    (torch.sum(out.float() ** 2) + aux_weight * aux / ep).backward()
    with torch.no_grad():
        dispatch, _, _, C = layer._route(params, xs)
    return {"out": out, "aux": aux, "capacity": C,
            "dropped": int(xs.shape[0] - dispatch.sum()),
            "router": params["router"]["weight"].grad,
            "experts": {k: v.grad for k, v in params["experts"].items()}}


# -- spatial parallelism ---------------------------------------------------------

def halo(x, halo_rows):
    from apex_tpu_torch.parallel.spatial import halo_exchange
    return halo_exchange(_t(_shard(x, 1)), dist.group.WORLD, halo_rows)


def spatial(x, w, stride, dy):
    """This rank's ``spatial_conv2d`` output and the grads of its input
    shard and of ``w`` (this rank's part of the sum) under ``sum(out *
    dy_shard)``."""
    from apex_tpu_torch.parallel.spatial import spatial_conv2d
    xs, wt = _t(_shard(x, 1), grad=True), _t(w, grad=True)
    out = spatial_conv2d(xs, wt, dist.group.WORLD, stride=stride)
    (out * _t(_shard(dy, 1))).sum().backward()
    return out, xs.grad, wt.grad


# -- checkpoints -------------------------------------------------------------

def _zero_params(params):
    return {k: _t(v) for k, v in sorted(params.items())}


def _zero_steps(opt, state, params, grads, n):
    g = {k: _t(v) for k, v in sorted(grads.items())}
    for _ in range(n):
        opt.step(g, state, params)
    return state


def zero_save(directory, params, grads, steps, bucket_bytes):
    """ZeRO-1 Adam over the world (the data axis): ``steps`` steps with the
    same ``grads`` on every rank, then ``save_checkpoint`` of params and
    state at that step; returns this rank's state."""
    from apex_tpu_torch.checkpoint import save_checkpoint
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    mesh()
    p = _zero_params(params)
    opt = DistributedFusedAdam(lr=1e-2, bucket_bytes=bucket_bytes)
    st = _zero_steps(opt, opt.init(p), p, grads, steps)
    save_checkpoint(directory, {"params": p, "opt": st}, steps,
                    host_state={"world": dist.get_world_size()})
    return {"master": st.master, "exp_avg": st.exp_avg,
            "exp_avg_sq": st.exp_avg_sq, "step": st.step}


def zero_resume(directory, params, grads, steps, bucket_bytes, dp_old):
    """Restore the dp ``dp_old`` checkpoint into this world through
    ``reshard_zero_state``, take ``steps`` more steps, and the same number
    of steps from the start straight at this world: both runs' params and
    state (they must be bit for bit alike), and the restored natural
    vectors."""
    from apex_tpu_torch.checkpoint import read_host_state, restore_checkpoint
    from apex_tpu_torch.elastic.reshard import reshard_zero_state, to_natural
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    mesh()
    rank, dp = dist.get_rank(), dist.get_world_size()
    step, host = read_host_state(directory)
    assert host["world"] == dp_old, host
    p = _zero_params(params)
    opt = DistributedFusedAdam(lr=1e-2, bucket_bytes=bucket_bytes)
    fresh = opt.init(p)
    total = opt._layout.total
    shard_old = -(-total // dp_old)
    like = fresh._replace(**{f: torch.zeros(shard_old * dp_old)
                             for f in ("master", "exp_avg", "exp_avg_sq")})
    got, _ = restore_checkpoint(directory, {"params": p, "opt": like})
    natural = {f: to_natural(getattr(got["opt"], f), total, dp_old,
                             bucket_bytes)
               for f in ("master", "exp_avg", "exp_avg_sq")}
    glob = reshard_zero_state(got["opt"], total=total, dp_old=dp_old,
                              dp_new=dp, bucket_bytes=bucket_bytes)
    mine = glob._replace(**{f: getattr(glob, f).chunk(dp)[rank].clone()
                            for f in ("master", "exp_avg", "exp_avg_sq")})
    rp = {k: v.clone() for k, v in got["params"].items()}
    resumed = _zero_steps(opt, mine, rp, grads, steps)
    sp = _zero_params(params)
    straight = _zero_steps(opt, opt.init(sp), sp, grads, step + steps)
    return {"step": step, "natural": natural,
            "resumed": (rp, tuple(resumed[:4])),
            "straight": (sp, tuple(straight[:4]))}
