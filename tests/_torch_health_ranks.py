"""Rank bodies of ``tests/test_torch_health.py`` (gloo on the CPU).

Run on every rank of an :class:`apex_tpu_torch.parallel._spawn.RankPool`;
the children import this module by name, so it imports torch, numpy and
the port only, never JAX. Inputs arrive as numpy (stacked by rank on axis
0 where a body takes its own row); results go back as numpy or floats.
"""

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_ranks import _mine, mesh


def replica_divergence(stacked: dict) -> float:
    """This rank's ``check_replica_agreement`` over ``"data"`` of its row
    of ``stacked``, outside any collector."""
    from apex_tpu_torch.observability.health import check_replica_agreement
    mesh()
    return float(check_replica_agreement(_mine(stacked), "data"))


def ddp_health(grads: dict, kw: dict) -> dict:
    """``allreduce_grads`` of this rank's row at level "full" inside a
    collector: the recorded metrics, and the same call at level "cheap"
    (nothing recorded)."""
    from apex_tpu_torch.observability import health, ingraph
    from apex_tpu_torch.parallel.distributed import allreduce_grads
    mesh()
    out = {}
    for level in ("full", "cheap"):
        with health.activate(health.HealthConfig(level=level)), \
                ingraph.collecting() as col:
            allreduce_grads(_mine(grads), "data", **kw)
            out[level] = col.freeze().as_floats()
    return out


def trainer_health(cfg_dict: dict, tokens, targets, steps: int) -> dict:
    """The hybrid trainer at dp = world, tp = pp = 1, from one seed:
    ``train_step_with_metrics`` at each health level for ``steps`` steps;
    each level's losses and payloads."""
    from apex_tpu_torch.config import TrainConfig
    from apex_tpu_torch.observability.health import HealthConfig
    from apex_tpu_torch.training import GPTHybridTrainer
    from apex_tpu_torch.transformer import parallel_state as ps
    out = {}
    for level in ("off", "cheap", "full"):
        ps.destroy_model_parallel()
        cfg = TrainConfig.from_dict(cfg_dict)
        trainer = GPTHybridTrainer(cfg, cfg.initialize_mesh(), device="cpu",
                                   health=HealthConfig(level=level))
        state = trainer.init_state(torch.Generator().manual_seed(0))
        losses, payloads = [], []
        for _ in range(steps):
            loss, *state, metrics = trainer.train_step_with_metrics(
                *state, torch.from_numpy(tokens), torch.from_numpy(targets))
            losses.append(loss.item())
            payloads.append(metrics.as_floats())
        out[level] = (np.asarray(losses), payloads)
    ps.destroy_model_parallel()
    out["world"] = dist.get_world_size()
    return out
