"""Rank bodies for the port's elastic CPU tests.

Each function runs on every rank of an
:class:`apex_tpu_torch.parallel._spawn.RankPool` (gloo on the CPU); the
children import this module by name, so it imports torch, numpy and the
port only, never JAX or the JAX package. A body lays out its own mesh
(tp = pp = 1: the whole world is the data group) and returns numpy.
"""

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps

SEQ, MB, GB_ROWS = 8, 2, 8  # global batch rows, the same at every dp
VOCAB, DATA_ROWS = 32, 64


def any_process(flags):
    """``multiproc.any_process`` of this rank's flag."""
    from apex_tpu_torch.parallel import multiproc
    return multiproc.any_process(bool(flags[dist.get_rank()]))


def gpt_config(dp, zero=False, bucket_bytes=None, layers=1, hidden=16,
               heads=2):
    """The reference's ``TestSimulatedShrink`` config, ``M`` microbatches
    of ``MB`` rows a data rank over a global batch of ``GB_ROWS``."""
    from apex_tpu_torch.config import (BatchConfig, ModelConfig,
                                       OptimizerConfig, ParallelConfig,
                                       TrainConfig)
    return TrainConfig(
        model=ModelConfig(name="gpt", vocab_size=VOCAB, hidden_size=hidden,
                          num_layers=layers, num_attention_heads=heads,
                          max_position_embeddings=SEQ),
        parallel=ParallelConfig(tensor_model_parallel_size=1,
                                pipeline_model_parallel_size=1),
        batch=BatchConfig(global_batch_size=GB_ROWS, micro_batch_size=MB),
        optimizer=OptimizerConfig(name="adam", lr=1e-2, weight_decay=0.0,
                                  zero=1 if zero else False),
        opt_level="O0", ddp_bucket_bytes=bucket_bytes)


def gpt_data(dp):
    from apex_tpu_torch.elastic import (PrefetchingIterator,
                                        ShardedIndexIterator,
                                        token_batch_fetcher)
    M = GB_ROWS // (MB * dp)
    data = np.random.RandomState(3).randint(0, VOCAB, (DATA_ROWS, SEQ + 1))
    return PrefetchingIterator(
        ShardedIndexIterator(DATA_ROWS, GB_ROWS, seed=9),
        token_batch_fetcher(data, M, GB_ROWS // M, SEQ), depth=1,
        device="cpu")


def _digest(state):
    from torch import nn
    from torch.utils._pytree import tree_leaves
    h = hashlib.sha256()
    for part in state:
        leaves = (list(part.state_dict().values())
                  if isinstance(part, nn.Module) else tree_leaves(part))
        for x in leaves:
            if isinstance(x, torch.Tensor):
                h.update(x.detach().contiguous().view(-1).view(torch.uint8)
                         .numpy().tobytes())
            else:
                h.update(repr(x).encode())
    return h.hexdigest()


def gpt_fit(directory, steps, zero=False, bucket_bytes=None, plan=None,
            save_interval=1, layers=1, hidden=16, heads=2):
    """One ``ElasticRunner.fit`` of ``GPTHybridTrainer`` at this world's
    dp: the FitResult's fields, losses by step, the data cursor, the
    state's sha256, this rank's ZeRO master shard and the registry."""
    from apex_tpu_torch.elastic import ElasticRunner, FaultPlan
    from apex_tpu_torch.observability.registry import MetricsRegistry
    from apex_tpu_torch.training import GPTHybridTrainer

    dp = dist.get_world_size()
    cfg = gpt_config(dp, zero, bucket_bytes, layers, hidden, heads)
    ps.destroy_model_parallel()
    mesh = cfg.initialize_mesh()
    reg = MetricsRegistry()
    try:
        trainer = GPTHybridTrainer(cfg, mesh, device="cpu")
        data = gpt_data(dp)
        losses = {}
        runner = ElasticRunner(
            trainer, data, directory, save_interval=save_interval,
            keep_last=5, exit_on_preempt=False, registry=reg,
            fault_plan=FaultPlan.from_json(plan) if plan else None,
            on_step=lambda k, lo: losses.__setitem__(k, float(lo)))
        res = runner.fit(steps, generator=torch.Generator().manual_seed(0))
    finally:
        ps.destroy_model_parallel()
    out = {"step": res.step, "preempted": res.preempted,
           "restored_from": res.restored_from, "resharded": res.resharded,
           "loss": res.loss, "losses": losses, "cursor": data.state_dict(),
           "digest": _digest(res.state), "metrics": reg.snapshot()}
    if zero:
        out["master"] = res.state[2].master.detach().numpy().copy()
        out["flat_total"] = int(trainer.opt._layout.total)
    return out


def preempt_resume(root, layers=2, hidden=32, heads=4):
    """6 straight steps against 3, a SIGTERM, and a fresh runner to 6."""
    from apex_tpu_torch.elastic import FaultPlan
    kw = dict(save_interval=2, layers=layers, hidden=hidden, heads=heads)
    ref = gpt_fit(f"{root}/ref", 6, **kw)
    first = gpt_fit(f"{root}/run", 6,
                    plan=FaultPlan(sigterm_at_step=3).to_json(), **kw)
    second = gpt_fit(f"{root}/run", 6, **kw)
    return {"ref": ref, "first": first, "second": second}


def bucket_guard(root):
    """A ZeRO checkpoint saved under 64 bucket bytes restored by a trainer
    built with 128: the first step must raise naming bucket_bytes."""
    from apex_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from apex_tpu_torch.elastic.runner import _tree, _untree
    from apex_tpu_torch.training import GPTHybridTrainer

    rng = np.random.RandomState(0)
    M = GB_ROWS // MB
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (M, GB_ROWS, SEQ)))
    for bb, save in ((64, True), (128, False)):
        cfg = gpt_config(1, True, bb)
        ps.destroy_model_parallel()
        mesh = cfg.initialize_mesh()
        trainer = GPTHybridTrainer(cfg, mesh, device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        if save:
            save_checkpoint(root, _tree(state), step=1)
            continue
        tree, _ = restore_checkpoint(root, _tree(state))
        restored = _untree(state, tree)
        try:
            trainer.jit_train_step()(*restored, tokens, tokens)
        except ValueError as e:
            return str(e)
        finally:
            ps.destroy_model_parallel()
    return None


def model_axis_refused(root):
    """A sidecar doctored to another pp: the restore must refuse it."""
    from apex_tpu_torch import checkpoint as ckpt
    real = ckpt.read_host_state

    def doctored(directory, step=None):
        s, host = real(directory, step)
        host = dict(host)
        host["world"] = dict(host["world"], pp=7)
        return s, host

    ckpt.read_host_state = doctored
    try:
        gpt_fit(root, 2)
    except ValueError as e:
        return str(e)
    finally:
        ckpt.read_host_state = real
    return None
