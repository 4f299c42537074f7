"""Rank bodies for the port's tensor-parallel CPU tests.

Each function here runs on every rank of an
:class:`apex_tpu_torch.parallel._spawn.RankPool` (gloo on the CPU), after
laying the world out as one tensor group (``mesh(tp)``). The children
import this module by name, so it imports torch, numpy and the port
only: never JAX or the JAX package. Inputs arrive as numpy arrays,
either whole (the same on every rank) or stacked by tensor rank on axis
0 (a body takes its own row); what a body returns goes back to the test
as numpy.
"""

import numpy as np
import torch

from apex_tpu_torch.transformer import parallel_state as ps


def mesh(tp):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp)


def _rank() -> int:
    return ps.get_tensor_model_parallel_rank()


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def _mine(a, grad=False):
    return _t(a[_rank()], grad)


# -- the mappings and the sequence-parallel regions ---------------------------

# name -> (input stacked by rank?, seed stacked by rank?)
MAPPINGS = {"copy": (False, True), "reduce": (True, False),
            "scatter": (False, True), "gather": (True, False),
            "sp_scatter": (False, True), "sp_gather": (True, True),
            "sp_gather_invariant": (True, False),
            "sp_reduce_scatter": (True, True)}


def mappings(tp, inputs, seeds):
    """Each mapping's output and its input's gradient under the objective
    ``sum(out * seed)`` (the seeds of all mappings summed into one
    backward); ``inputs``/``seeds`` by mapping name, stacked by rank where
    :data:`MAPPINGS` says so."""
    from apex_tpu_torch.transformer import context_parallel as cp
    from apex_tpu_torch.transformer import tensor_parallel as tpm
    mesh(tp)
    fns = {
        "copy": tpm.copy_to_tensor_model_parallel_region,
        "reduce": tpm.reduce_from_tensor_model_parallel_region,
        "scatter": tpm.scatter_to_tensor_model_parallel_region,
        "gather": tpm.gather_from_tensor_model_parallel_region,
        "sp_scatter": lambda x: cp.scatter_to_sequence_parallel_region(
            x, "tensor", seq_axis=1),
        "sp_gather": lambda x: cp.gather_from_sequence_parallel_region(
            x, "tensor", seq_axis=1),
        "sp_gather_invariant": lambda x:
            cp.gather_from_sequence_parallel_region(
                x, "tensor", seq_axis=1, invariant=True),
        "sp_reduce_scatter": lambda x:
            cp.reduce_scatter_to_sequence_parallel_region(
                x, "tensor", seq_axis=1),
    }
    xs, outs, total = {}, {}, 0.0
    for name, (stacked_in, stacked_seed) in MAPPINGS.items():
        x = _mine(inputs[name], True) if stacked_in else _t(inputs[name],
                                                             True)
        seed = _mine(seeds[name]) if stacked_seed else _t(seeds[name])
        out = fns[name](x)
        total = total + (out * seed).sum()
        xs[name], outs[name] = x, out.detach()
    total.backward()
    return outs, {k: x.grad for k, x in xs.items()}


def refusals(tp):
    """The errors' texts: an indivisible last dim for the scatter, an
    indivisible sequence for the SP scatter and the ring."""
    from apex_tpu_torch.transformer import context_parallel as cp
    from apex_tpu_torch.transformer import tensor_parallel as tpm
    mesh(tp)
    out = []
    for fn in (lambda: tpm.scatter_to_tensor_model_parallel_region(
                   torch.ones(4, 7)),
               lambda: cp.scatter_to_sequence_parallel_region(
                   torch.ones(2, 7, 4), "tensor", seq_axis=1),
               lambda: tpm.matmul_reduce_scatter(
                   torch.ones(2, 7, 4), torch.ones(4, 4 // tp), None,
                   "tensor", 1)):
        try:
            fn()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


# -- the sharded layers -------------------------------------------------------

def _load(layer, params):
    with torch.no_grad():
        for name, arr in params.items():
            getattr(layer, name).copy_(torch.from_numpy(arr[_rank()]))


def layer_pair(tp, mode, col_p, row_p, x, dy, h):
    """A Column -> Row pair (h -> 2h -> h) in ``mode`` ("plain", "sp" or
    "overlap"): the output, and the grads of ``sum(out * dy)`` for the
    input and both layers' parameters. Under SP ``x`` and ``dy`` are
    stacked sequence shards."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    mesh(tp)
    sp, ov = mode != "plain", mode == "overlap"
    kw = dict(world_size=tp, sequence_parallel=sp, seq_axis=1,
              tp_comm_overlap=ov, device="cpu")
    col = ColumnParallelLinear(h, 2 * h, gather_output=False, **kw)
    row = RowParallelLinear(2 * h, h, input_is_parallel=True, **kw)
    _load(col, col_p)
    _load(row, row_p)
    xt = _mine(x, True) if sp else _t(x, True)
    y, _ = col(xt)
    out, _ = row(y)
    (out * (_mine(dy) if sp else _t(dy))).sum().backward()
    return out.detach(), {"x": xt.grad, "col_w": col.weight.grad,
                          "col_b": col.bias.grad, "row_w": row.weight.grad,
                          "row_b": row.bias.grad}


def layer_gathered(tp, col_p, row_p, x, dy_col, dy_row):
    """``ColumnParallelLinear(gather_output=True)`` and
    ``RowParallelLinear(input_is_parallel=False)`` each on the whole
    input: outputs and the grads of ``sum(out * dy)``; and the Column
    with ``skip_bias_add`` (its bias returned, gathered)."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    mesh(tp)
    h_in, h_out = x.shape[-1], dy_col.shape[-1]
    col = ColumnParallelLinear(h_in, h_out, gather_output=True,
                               device="cpu")
    row = RowParallelLinear(h_in, dy_row.shape[-1], input_is_parallel=False,
                            device="cpu")
    skip = ColumnParallelLinear(h_in, h_out, gather_output=True,
                                skip_bias_add=True, device="cpu")
    for layer, p in ((col, col_p), (row, row_p), (skip, col_p)):
        _load(layer, p)
    xc, xr = _t(x, True), _t(x, True)
    yc, _ = col(xc)
    yr, _ = row(xr)
    ys, bias = skip(_t(x))
    ((yc * _t(dy_col)).sum() + (yr * _t(dy_row)).sum()).backward()
    return {"col": yc.detach(), "row": yr.detach(), "skip": ys,
            "skip_bias": bias.detach(), "x_col": xc.grad, "x_row": xr.grad,
            "col_w": col.weight.grad, "col_b": col.bias.grad,
            "row_w": row.weight.grad, "row_b": row.bias.grad}


def embedding(tp, weight, ids, dy):
    from apex_tpu_torch.transformer.tensor_parallel import (
        VocabParallelEmbedding)
    mesh(tp)
    emb = VocabParallelEmbedding(weight.shape[0] * weight.shape[1],
                                 weight.shape[2], device="cpu")
    _load(emb, {"weight": weight})
    out = emb(_t(ids))
    (out * _t(dy)).sum().backward()
    return out.detach(), emb.weight.grad


def init_shards(tp, out_size, in_size, vocab, seed):
    """Each layer's ``init`` from one seeded CPU generator: this rank's
    Column, Row and embedding shards."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    mesh(tp)
    out = {}
    for name, layer in (
            ("col", ColumnParallelLinear(in_size, out_size, device="cpu")),
            ("row", RowParallelLinear(in_size, out_size, device="cpu")),
            ("emb", VocabParallelEmbedding(vocab, in_size, device="cpu"))):
        layer.init(torch.Generator().manual_seed(seed))
        out[name] = layer.weight.detach().clone()
    return out


# -- the ring collective matmuls ----------------------------------------------

def ring_primitives(tp, x_ag, w_ag, dy_ag, x_rs, w_rs, add, dy_rs):
    """``all_gather_matmul`` and ``matmul_reduce_scatter`` (with
    ``partial_add``) forward, and the grads of ``sum(out * dy)``; the
    inputs and seeds stacked by rank."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        all_gather_matmul, matmul_reduce_scatter)
    mesh(tp)
    xa, wa = _mine(x_ag, True), _mine(w_ag, True)
    ya = all_gather_matmul(xa, wa, "tensor", 1)
    xr, wr, ar = _mine(x_rs, True), _mine(w_rs, True), _t(add, True)
    yr = matmul_reduce_scatter(xr, wr, ar, "tensor", 1)
    ((ya * _mine(dy_ag)).sum() + (yr * _mine(dy_rs)).sum()).backward()
    return {"ag": ya.detach(), "rs": yr.detach(), "ag_x": xa.grad,
            "ag_w": wa.grad, "rs_x": xr.grad, "rs_w": wr.grad,
            "rs_add": ar.grad}


def ring_against_fused(tp, x, col_p, row_p, dy, h):
    """The SP Column -> Row pair with and without ``tp_comm_overlap`` on
    the same fp32 inputs: whether output and every grad are equal bit
    for bit."""
    a = layer_pair(tp, "sp", col_p, row_p, x, dy, h)
    b = layer_pair(tp, "overlap", col_p, row_p, x, dy, h)
    same = {"out": torch.equal(a[0], b[0])}
    for k in a[1]:
        same[k] = torch.equal(a[1][k], b[1][k])
    return same


# -- cross-entropy, broadcast -------------------------------------------------

def cross_entropy(tp, logits, target, weight, smoothing):
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy)
    mesh(tp)
    x = _mine(logits, True)
    loss = vocab_parallel_cross_entropy(x, _t(target), smoothing)
    (loss * _t(weight)).sum().backward()
    return loss.detach(), x.grad


def broadcast(tp, data, dtype_name):
    from apex_tpu_torch.transformer.tensor_parallel import broadcast_data
    mesh(tp)
    mine = {k: _mine(v) for k, v in data.items()}
    dtype = None if dtype_name is None else getattr(torch, dtype_name)
    out = broadcast_data(sorted(mine), mine, dtype)
    return {k: (v.to(torch.int64) if v.dtype == torch.bool else v,
                str(v.dtype)) for k, v in out.items()}


# -- GPT and BERT at tp > 1 ---------------------------------------------------

LEGS = {"plain": (False, False), "sp": (True, False), "overlap": (True, True)}


def _gpt(tp, sizes, leg, tree=None, **kw):
    from apex_tpu_torch._bridge import params_from_jax
    from apex_tpu_torch.models import GPTConfig, GPTModel
    sp, ov = LEGS[leg]
    cfg = GPTConfig(tensor_model_parallel_size=tp, sequence_parallel=sp,
                    tp_comm_overlap=ov, compute_dtype=torch.float32,
                    **sizes, **kw)
    model = GPTModel(cfg, device="cpu")
    if tree is not None:
        model.load_state_dict(params_from_jax(tree, cfg, tp_rank=_rank()))
    return model


def gpt_legs(tp, sizes, tree, tokens, legs):
    """Each leg's loss, grads by parameter name and ``tp/*`` metrics
    (aggregated over the tensor group) on this rank's shards of the JAX
    tree; and whether ``sp_grad_sync`` handed its grads back as they
    were."""
    from apex_tpu_torch.observability import ingraph
    mesh(tp)
    out = {}
    tok = _t(tokens)
    for leg in legs:
        model = _gpt(tp, sizes, leg, tree)
        with ingraph.collecting() as col:
            loss = model.loss(tok, tok)
            metrics = col.freeze()
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        synced = model.sp_grad_sync(grads)
        out[leg] = (loss.detach(), grads, ingraph.aggregate(
            metrics, "tensor").as_floats(),
            all(synced[n] is g for n, g in grads.items()))
    return out


def bert_loss(tp, sizes, tree, tokens, labels, mask):
    from apex_tpu_torch._bridge import params_from_jax
    from apex_tpu_torch.models import BertConfig, BertModel
    mesh(tp)
    cfg = BertConfig(tensor_model_parallel_size=tp,
                     compute_dtype=torch.float32, **sizes)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg, tp_rank=_rank()))
    loss = model.loss(_t(tokens), _t(labels), loss_mask=_t(mask))
    loss.backward()
    # the token types are not passed: their grad is JAX's zeros
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None
                           else p.grad for n, p in model.named_parameters()}


def dropout_streams(tp, sizes, leg):
    """One train-mode forward with attention and hidden dropout from a
    generator seeded alike on every rank: the attention seeds the flash
    calls got, and the hidden masks (embedding and layer dropout)."""
    import apex_tpu_torch.models.gpt as gpt_mod
    mesh(tp)
    seeds, masks = [], []
    flash, drop = gpt_mod.flash_attention, gpt_mod.dropout

    def record_flash(*args, **kw):
        seeds.append(kw.get("dropout_seed"))
        return flash(*args, **kw)

    def record_drop(x, rate, generator=None):
        out = drop(x, rate, generator)
        masks.append((out == 0).to(torch.int8))
        return out

    gpt_mod.flash_attention, gpt_mod.dropout = record_flash, record_drop
    try:
        model = _gpt(tp, sizes, leg, hidden_dropout=0.5,
                     attention_dropout=0.5)
        model.init(torch.Generator().manual_seed(0))
        tok = torch.arange(2 * 16).reshape(2, 16) % sizes["vocab_size"]
        model.loss(tok, tok, generator=torch.Generator().manual_seed(1))
    finally:
        gpt_mod.flash_attention, gpt_mod.dropout = flash, drop
    return seeds, masks


def config_build(cfg_dict, bucket_bytes):
    """``TrainConfig`` at tp > 1: the mesh, then the GPT it builds, and
    the model ``fastpath`` builds (sequence parallelism and its overlap
    on): each model's config flags and parameter shapes."""
    from apex_tpu_torch.config import TrainConfig
    ps.destroy_model_parallel()
    cfg = TrainConfig.from_dict(cfg_dict)
    cfg.initialize_mesh()
    out = {}
    for what, c in (("config", cfg),
                    ("fastpath", cfg.fastpath(bucket_bytes=bucket_bytes))):
        model = c.build_model(device="cpu")
        out[what] = (model.cfg.tensor_model_parallel_size,
                     model.cfg.sequence_parallel, model.cfg.tp_comm_overlap,
                     {n: tuple(p.shape) for n, p in
                      model.named_parameters()})
    return out


def gpt_refusals(tp, sizes):
    """The errors' types and texts: heads the group does not divide, a
    width it does not divide, overlap without SP, SP at tp = 1, BERT
    under SP, and the serving legs and engine at tp > 1."""
    from apex_tpu_torch.models import (BertConfig, BertModel, GPTConfig,
                                       GPTModel)
    from apex_tpu_torch.serving.cache import KVCache
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear)
    mesh(tp)
    model = _gpt(tp, sizes, "plain")
    model.init(torch.Generator().manual_seed(0))
    cache = KVCache.create(sizes["num_layers"], 2,
                           sizes["num_attention_heads"], 16,
                           sizes["hidden_size"]
                           // sizes["num_attention_heads"],
                           dtype=torch.float32, device="cpu")
    cases = {
        "heads": lambda: GPTModel(GPTConfig(
            **dict(sizes, num_attention_heads=3 * tp, hidden_size=6 * tp),
            tensor_model_parallel_size=2 * tp), device="cpu"),
        "width": lambda: ColumnParallelLinear(8, 4 * tp + 1, device="cpu"),
        "overlap": lambda: GPTModel(GPTConfig(
            **sizes, tensor_model_parallel_size=tp, tp_comm_overlap=True),
            device="cpu"),
        "sp_tp1": lambda: GPTModel(GPTConfig(
            **sizes, sequence_parallel=True), device="cpu"),
        "bert_sp": lambda: BertModel(BertConfig(
            **sizes, tensor_model_parallel_size=tp, sequence_parallel=True),
            device="cpu"),
        "prefill": lambda: model(torch.zeros(1, 4, dtype=torch.long),
                                 kv_cache=cache, slot=0),
        "decode": lambda: model(torch.zeros(2, 1, dtype=torch.long),
                                kv_cache=cache),
        "verify": lambda: model.verify_forward(
            torch.zeros(2, 2, dtype=torch.long), cache),
        "engine": lambda: ServingEngine(model, max_seqs=2, max_len=16,
                                        prefill_len=8, device="cpu"),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except Exception as e:   # the test reads each case's error
            out[name] = (type(e).__name__, str(e))
    return out


def skip_on_nan(tp, sizes, tree, tokens):
    """A train step at tp > 1 (scaled loss, unscale, ``all_finite`` over
    the tensor group, the scale update, FusedAdam with the skip) with a
    NaN put into rank 1's grads: this rank's finite flag, the scale
    before and after, and whether every parameter is unchanged."""
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.optimizers import FusedAdam
    mesh(tp)
    model = _gpt(tp, sizes, "sp", tree)
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    opt, scaler = FusedAdam(lr=1e-3), DynamicLossScale(init_scale=2.0 ** 8)
    state, ls = opt.init(params), scaler.init(device="cpu")
    tok = _t(tokens)
    (model.loss(tok, tok) * ls.loss_scale).backward()
    grads = scaler.unscale(ls, {n: p.grad for n, p in params.items()})
    if _rank() == 1:
        grads["layers.0.fc1.weight"][0, 0] = float("nan")
    finite = all_finite(grads, axis_names=("tensor",))
    new_ls = scaler.update(ls, finite)
    opt.step(grads, state, params, grads_finite=finite)
    kept = all(torch.equal(p.detach(), before[n]) for n, p in params.items())
    return (bool(finite), float(ls.loss_scale), float(new_ls.loss_scale),
            kept, int(state.step))


def init_against_split(tp, sizes, seed):
    """A GPT built at ``tp`` and ``init``-ed from ``seed`` on this rank,
    against ``_bridge.split_tp_state`` of the tp = 1 GPT from the same
    seed: the names whose tensors differ (none expected)."""
    from apex_tpu_torch._bridge import split_tp_state
    from apex_tpu_torch.models import GPTConfig, GPTModel
    mesh(tp)
    one = GPTModel(GPTConfig(**sizes), device="cpu").init(
        torch.Generator().manual_seed(seed))
    mine = _gpt(tp, sizes, "sp")
    mine.init(torch.Generator().manual_seed(seed))
    want = split_tp_state(one.state_dict(), mine.cfg, tp, _rank())
    got = mine.state_dict()
    assert set(got) == set(want)
    return sorted(n for n in got if not torch.equal(got[n], want[n]))
