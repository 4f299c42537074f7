"""Rank bodies for the port's pipeline-parallel CPU tests.

Each function here runs on every rank of an
:class:`apex_tpu_torch.parallel._spawn.RankPool` (gloo on the CPU). The
children import this module by name, so it imports torch, numpy and the
port only: never JAX or the JAX package. Inputs arrive as numpy arrays,
whole (the same on every rank); what a body returns goes back to the test
as numpy.
"""

import weakref

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps


def mesh(tp=1, pp=1, cp=1):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def _pp_rank() -> int:
    return ps.get_pipeline_model_parallel_rank()


# -- a toy stage: tanh(x @ w + b) ------------------------------------------

def stage_fn(p, x, g):
    return torch.tanh(x @ p["w"] + p["b"])


def _mse(targets):
    tg = _t(targets)
    return lambda y, m: torch.mean((y - tg[m]) ** 2)


def _chunks(ws, bs, pp, chunks):
    """This rank's chunks of the global stages' params (chunk ``c`` is
    global stage ``c * pp + rank``)."""
    r = _pp_rank()
    return [{"w": _t(ws[c * pp + r], True), "b": _t(bs[c * pp + r], True)}
            for c in range(chunks)]


# -- the hops -----------------------------------------------------------------

def hops(pp, x, w):
    """``rotate_forward``/``rotate_backward`` of this rank's row of ``x``
    and the grad of ``sum(out * w[rank])`` through each; the schedules'
    ``exchange_stages`` of a pair of tensors to the next rank."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)
    mesh(pp=pp)
    r = _pp_rank()
    out = {}
    for name, fn in (("forward", p2p.rotate_forward),
                     ("backward", p2p.rotate_backward)):
        xi = _t(x[r], True)
        y = fn(xi)
        (y * _t(w[r])).sum().backward()
        out[name] = (y.detach(), xi.grad)
    pipe = p2p._Pipe()
    a, b = _t(x[r]), _t(w[r]).double()
    got = p2p.exchange_stages(pipe, [(a, (r + 1) % pp), (b, (r + 1) % pp)],
                              [(a, (r - 1) % pp), (b, (r - 1) % pp)])
    out["pair"] = got
    out["empty"] = p2p.exchange_stages(pipe, [], [])
    return out


def hang(pp):
    """Rank 0 posts a receive its peer never sends: the call must fail by
    the pool's limit."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)
    mesh(pp=pp)
    pipe = p2p._Pipe()
    if pipe.rank == 0:
        p2p.exchange_stages(pipe, [], [(torch.zeros(4), 1)])
    return pipe.rank


# -- the schedules -------------------------------------------------------------

def schedules(pp, chunks, ws, bs, micro, targets, mode):
    """One schedule at this pipeline size: ``mode`` "1f1b" or "allfwd"
    (``memory_efficient`` True or False), interleaved when ``chunks`` > 1,
    or "apply" (``pipelined_apply``); the loss (or outputs), this rank's
    chunk grads and the ``pipeline/*`` metrics."""
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    mesh(pp=pp)
    params = _chunks(ws, bs, pp, chunks)
    mb = _t(micro)
    with ingraph.collecting() as col:
        if mode == "apply":
            out = sc.pipelined_apply(stage_fn, params, mb, num_chunks=chunks)
            grads = None
        elif chunks == 1:
            out, grads = sc.forward_backward_pipelining_without_interleaving(
                stage_fn, mb, params[0], loss_fn=_mse(targets),
                memory_efficient=mode == "1f1b")
            grads = [grads]
        else:
            out, grads = sc.forward_backward_pipelining_with_interleaving(
                stage_fn, mb, params, loss_fn=_mse(targets),
                num_model_chunks=chunks, memory_efficient=mode == "1f1b")
        metrics = col.freeze().as_floats()
    return out, grads, metrics


def forward_only(pp, ws, bs, micro, targets):
    """The 1F1B function with ``forward_only``: the mean loss, no grads."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    mesh(pp=pp)
    params = _chunks(ws, bs, pp, 1)
    return sc.forward_backward_pipelining_without_interleaving(
        stage_fn, _t(micro), params[0], loss_fn=_mse(targets),
        forward_only=True)


def inflight(pp, chunks, ws, bs, micro, targets, memory_efficient):
    """The most stage outputs alive on each of this rank's chunks at any
    stage call (each output counted by a weakref until it is freed)."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    mesh(pp=pp)
    live = {c: [] for c in range(chunks)}
    most = {c: 0 for c in range(chunks)}

    def counted(p, x, g):
        c = g // pp
        y = stage_fn(p, x, g)
        live[c] = [ref for ref in live[c] if ref() is not None]
        live[c].append(weakref.ref(y))
        most[c] = max(most[c], len(live[c]))
        return y

    params = _chunks(ws, bs, pp, chunks)
    if chunks == 1:
        sc.forward_backward_pipelining_without_interleaving(
            counted, _t(micro), params[0], loss_fn=_mse(targets),
            memory_efficient=memory_efficient)
    else:
        sc.forward_backward_pipelining_with_interleaving(
            counted, _t(micro), params, loss_fn=_mse(targets),
            num_model_chunks=chunks, memory_efficient=memory_efficient)
    return [most[c] for c in range(chunks)]


# -- GPT through pipeline_fns ----------------------------------------------------

def _gpt(sizes, tree, **kw):
    from apex_tpu_torch._bridge import params_from_jax
    from apex_tpu_torch.models import GPTConfig, GPTModel
    cfg = GPTConfig(compute_dtype=torch.float32, **sizes, **kw)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def gpt_pipeline(pp, chunks, sizes, tree, tokens, targets,
                 remat="none"):
    """GPT with the pipelined embedding and tied head: this rank's chunks
    of ``pp * chunks`` stages (the model's layers), the shared embedding
    and final LayerNorm; the loss, the chunk grads by parameter name and
    the shared grads."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    mesh(pp=pp)
    model = _gpt(sizes, tree, remat_policy=remat)
    stage, embed_fn, head_fn, split, shared_of = model.pipeline_fns(
        pp * chunks, _t(targets))
    stages = split(model)
    mine = [stages[c * pp + _pp_rank()] for c in range(chunks)]
    if chunks == 1:
        loss, (sg, shg) = sc.forward_backward_pipelining_without_interleaving(
            stage, _t(tokens), mine[0], loss_fn=head_fn,
            shared_params=shared_of(model), embed_fn=embed_fn)
        sg = [sg]
    else:
        loss, (sg, shg) = sc.forward_backward_pipelining_with_interleaving(
            stage, _t(tokens), mine, loss_fn=head_fn, num_model_chunks=chunks,
            shared_params=shared_of(model), embed_fn=embed_fn)
    return loss, sg, shg


def gpt_stage_refusals(sizes):
    """The errors' types and texts: a stage count that does not divide
    the layers, and sequence parallelism across stages."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    mesh(tp=2)
    out = {}
    for name, (kw, stages) in {
            "indivisible": ({}, 3),
            "sp": (dict(tensor_model_parallel_size=2,
                        sequence_parallel=True), 2)}.items():
        model = GPTModel(GPTConfig(**sizes, **kw), device="cpu")
        try:
            model.stage_fn(stages)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# -- utils over groups --------------------------------------------------------

def group_utils(tp, pp, losses, tree):
    """``average_losses_across_data_parallel_group`` of this data rank's
    row of ``losses``, and ``calc_params_l2_norm`` of this tensor rank's
    row of each leaf of ``tree``."""
    from apex_tpu_torch.transformer.pipeline_parallel import utils
    mesh(tp=tp, pp=pp)
    d, t = ps.get_data_parallel_rank(), ps.get_tensor_model_parallel_rank()
    avg = utils.average_losses_across_data_parallel_group(
        [torch.tensor(float(v)) for v in losses[d]])
    norm = utils.calc_params_l2_norm({k: _t(v[t]) for k, v in tree.items()})
    return avg, norm


# -- the hybrid trainer ---------------------------------------------------------

def _trainer(cfg_dict, **kw):
    from apex_tpu_torch.config import TrainConfig
    from apex_tpu_torch.training import GPTHybridTrainer
    ps.destroy_model_parallel()
    cfg = TrainConfig.from_dict(cfg_dict)
    mesh_ = cfg.initialize_mesh()
    return GPTHybridTrainer(cfg, mesh_, device="cpu", **kw), cfg


def _rank_state(trainer, cfg, jax_state):
    from apex_tpu_torch._bridge import hybrid_state_from_jax
    from apex_tpu_torch.models import GPTConfig
    stage_stack, shared = jax_state
    gcfg = GPTConfig(num_layers=cfg.model.num_layers)
    stage, sh = hybrid_state_from_jax(
        stage_stack, shared, gcfg, cfg.parallel.pipeline_model_parallel_size,
        ps.get_pipeline_model_parallel_rank(),
        ps.get_tensor_model_parallel_rank())
    return trainer.load_state(stage, sh)


def _state_dicts(stage, shared):
    return ({k: v.detach().clone() for k, v in stage.state_dict().items()},
            {k: v.detach().clone() for k, v in shared.state_dict().items()})


def _unsummed_shared(sc):
    """``_Run.grads`` without the shared grads' sum over the pipeline
    group (a planted error)."""
    real = sc._Run.grads

    def grads(self):
        size, self.S = self.S, 1
        try:
            return real(self)
        finally:
            self.S = size
    return real, grads


def trainer_steps(cfg_dict, jax_state, tokens, targets, steps,
                  plant=None, metrics=False):
    """``steps`` steps of the trainer from the JAX trainer's initial state
    (``jax_state``: its stage stack and shared params, numpy): the losses,
    this rank's coordinates, its (stage, shared) state dicts after step 0
    and after the last step, and (with ``metrics``) each step's
    aggregated metrics. ``plant="unsummed_shared"`` leaves the shared
    grads unsummed over the pipeline."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    trainer, cfg = _trainer(cfg_dict)
    state = _rank_state(trainer, cfg, jax_state)
    real = None
    if plant == "unsummed_shared":
        real, sc._Run.grads = _unsummed_shared(sc)
    step = trainer.jit_train_step(with_metrics=metrics)
    losses, after0, mets = [], None, []
    try:
        for i in range(steps):
            out = step(*state, _t(tokens), _t(targets))
            loss, state = out[0], tuple(out[1:5])
            if metrics:
                mets.append(out[5].as_floats())
            losses.append(float(loss))
            if i == 0:
                after0 = _state_dicts(state[0], state[1])
    finally:
        if real is not None:
            sc._Run.grads = real
    coords = (ps.get_pipeline_model_parallel_rank(),
              ps.get_tensor_model_parallel_rank(),
              ps.get_data_parallel_rank())
    return {"losses": losses, "coords": coords, "after0": after0,
            "last": _state_dicts(state[0], state[1]), "metrics": mets,
            "step": int(state[2].step)}


def trainer_seeded(cfg_dict, seed, tokens, targets, steps):
    """The trainer from ``init_state`` with a seeded generator, stepped
    through ``jit_train_step`` (on the ZeRO path its first call checks
    the state's bucket grid): its losses and final state dicts."""
    trainer, _ = _trainer(cfg_dict)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    step = trainer.jit_train_step()
    losses = []
    for _ in range(steps):
        loss, *state = step(*state, _t(tokens), _t(targets))
        losses.append(float(loss))
    coords = (ps.get_pipeline_model_parallel_rank(),
              ps.get_tensor_model_parallel_rank(),
              ps.get_data_parallel_rank())
    return {"losses": losses, "coords": coords,
            "last": _state_dicts(state[0], state[1])}


def trainer_nan(cfg_dict, seed, tokens, targets, nan_rank):
    """A step with a NaN put into global rank ``nan_rank``'s stage grads:
    this rank's scale before and after, whether its params and step count
    were kept."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    trainer, _ = _trainer(cfg_dict)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    before = _state_dicts(state[0], state[1])
    real = sc._Run.grads

    def poisoned(self):
        chunks, shared = real(self)
        if dist.get_rank() == nan_rank:
            leaf = next(iter(chunks[0].values()))
            leaf.view(-1)[0] = float("nan")
        return chunks, shared

    sc._Run.grads = poisoned
    try:
        loss, *after = trainer.train_step(*state, _t(tokens), _t(targets))
    finally:
        sc._Run.grads = real
    kept = all(torch.equal(a, b) for a, b in zip(
        before[0].values(), after[0].state_dict().values())) and all(
        torch.equal(a, b) for a, b in zip(
            before[1].values(), after[1].state_dict().values()))
    return {"scale": (float(state[3].loss_scale),
                      float(after[3].loss_scale)),
            "kept": kept, "step": int(after[2].step)}


def trainer_refusals(cfg_dict):
    """The errors' types and texts (None where the trainer builds): a
    health policy at level "full" (builds) and a config's unknown health
    level, the donation self-check and ``attribution_report`` (A7b),
    ``ddp_bucket_bytes="auto"`` (A7b), and a config whose pipeline size
    is not the mesh's."""
    import dataclasses
    from apex_tpu_torch.config import TrainConfig
    from apex_tpu_torch.observability.health import HealthConfig
    from apex_tpu_torch.training import GPTHybridTrainer

    trainer, cfg = _trainer(cfg_dict)
    cases = {
        "health": lambda: GPTHybridTrainer(
            cfg, device="cpu", health=HealthConfig(level="full")),
        "health_cfg": lambda: GPTHybridTrainer(
            dataclasses.replace(cfg, health_level="basic"), device="cpu"),
        "verify_donation": lambda: trainer.jit_train_step(
            verify_donation=True),
        "attribution": lambda: trainer.attribution_report(),
        "auto": lambda: GPTHybridTrainer(
            dataclasses.replace(cfg, ddp_bucket_bytes="auto"),
            device="cpu"),
        "pp": lambda: GPTHybridTrainer(TrainConfig.from_dict(dict(
            cfg_dict, parallel=dict(cfg_dict["parallel"],
                                    pipeline_model_parallel_size=1))),
            device="cpu"),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _trainer_error(cfg_dict):
    """The type and text of what building the trainer raises."""
    try:
        _trainer(cfg_dict)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def trainer_donation(cfg_dict, seed, tokens, targets):
    """``jit_train_step(donate=False)`` leaves the state it is handed as
    it was and returns a stepped copy; ``donate=True`` steps in place."""
    trainer, _ = _trainer(cfg_dict)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    before = _state_dicts(state[0], state[1])
    out = trainer.jit_train_step(donate=False)(*state, _t(tokens),
                                               _t(targets))
    kept = all(torch.equal(before[0][k], v)
               for k, v in state[0].state_dict().items())
    moved = any(not torch.equal(before[0][k], v)
                for k, v in out[1].state_dict().items())
    out2 = trainer.jit_train_step()(*state, _t(tokens), _t(targets))
    in_place = out2[1] is state[0] and any(
        not torch.equal(before[0][k], v)
        for k, v in state[0].state_dict().items())
    same = float(out[0]) == float(out2[0])
    return {"kept": kept, "moved": moved, "in_place": in_place,
            "same_loss": same}
