"""Weight bridge between the JAX package's GPT and BERT pytrees and the
port.

``params_from_jax`` turns the ``GPTModel.init`` or ``BertModel.init``
pytree of the JAX package, with its leaves converted to numpy arrays, into
a state dict for :class:`apex_tpu_torch.models.gpt.GPTModel` or
:class:`apex_tpu_torch.models.bert.BertModel`; ``params_to_numpy`` is the
inverse. The JAX layers are stacked ``(L, ...)`` and its tensor-parallel
weights keep a leading shard dim of tp (qkv weight ``(L, tp, 3h/tp, h)``,
a Row bias ``(L, tp, h)`` of tp copies, the word embedding ``(tp, V/tp,
h)``, the MLM output bias ``(tp, V/tp)``); the port's layers are a
``ModuleList`` with plain ``(out, in)`` weights, each rank holding its own
shard. ``params_from_jax(tree, cfg, tp_rank)`` takes rank ``tp_rank``'s
shard of each such leaf (a Row bias: its copy), ``params_to_numpy`` gives
one rank's tree with a shard dim of 1, and ``stack_tp_params`` joins
every rank's state dict back into the whole tree. ``split_tp_state``
cuts a tp = 1 state dict into rank ``r``'s shards by the law of the
layers' ``init`` (:func:`apex_tpu_torch.models.gpt.tp_shard_dim`). A BERT
tree is told from a GPT one by its token-type table
(``embedding.tokentype``). Values pass bit for bit: bf16 leaves go
through a ``uint16`` view, since ``torch.from_numpy`` refuses numpy's bf16
extension dtype.

Pipeline parallelism: ``pipeline_layers`` gives the global layers of a
pipeline rank's chunks (chunk ``c`` on rank ``d`` is global stage ``c *
pp + d``), ``split_pipeline_state`` cuts a state dict into a rank's stage
(``"<j>.<layer leaf>"``, or ``"<c>.<j>.<layer leaf>"`` with chunks, the
names of the ``nn.ModuleList`` ``GPTModel.stage_fn`` gives) and the shared
parameters (``embedding.*``, ``final_ln.*``, the names of the trainer's
``nn.ModuleDict``), and ``join_pipeline_state`` is its inverse.
``hybrid_state_from_jax`` takes one rank's stage and shared state dicts
(and, with an optimizer state, its Adam moments) from the JAX
``GPTHybridTrainer`` state, whose stage leaves are stacked ``(pp, per,
...)`` (``(chunks, pp, per, ...)`` with chunks), composing with the tensor
shards of ``params_from_jax``; ``stack_hybrid_state`` restacks every
rank's pair into that layout.

``resnet_params_from_jax`` and ``resnet_params_to_numpy`` do the same for
ResNet-50: the ``ResNet50.init`` params and ``BatchNormState`` trees
become one state dict of :class:`apex_tpu_torch.models.resnet.ResNet50`
(parameters and BN buffers) and back. Conv weights go from HWIO to OIHW;
the head's ``(classes, features)`` weight is unchanged; the BN counts are
int64 buffers here, as torch's BN keeps them, and int32 on the JAX side.

The ops' parameters: ``mlp_params_from_jax`` turns the JAX ``MLP.init``
list of ``(w, b)`` pairs into the port ``MLP``'s state dict
(``weight_i``/``bias_i``), and ``module_params_from_jax`` a nested dict
(``FusedDense``, ``FusedDenseGeluDense``, ``SelfMultiheadAttn``,
``EncdecMultiheadAttn``) into a state dict of dotted names (``qkv.weight``,
``dense1.bias``, ...). ``optimizer_state_from_jax`` turns a JAX optimizer
state (``LAMBState``, ``MixedPrecisionLambState``, ``NovoGradState``,
``AdagradState``, or any of the port's state named tuples with the same
fields) into the port's, its dict trees in the key order of the port's
parameter tree ``like`` (the port's optimizers pair state and parameter
leaves by position, and JAX sorts dict keys).

``zero_state_from_jax`` carries a JAX ``ZeroAdamState``/``ZeroLambState``
(global arrays: the concatenation, rank by rank, of each rank's
bucket-major shard) into one rank's port state, and
``zero_state_to_numpy`` joins the ranks' port states back into the
global arrays. The flat order is the parameter tree's leaf order: the two
packages agree when the tree flattens alike in both (JAX sorts dict keys,
torch keeps their order, so build the port's dicts with sorted keys).

``moe_params_from_jax`` carries the JAX ``ExpertParallelMLP.init`` tree
(router ``(E, h)``, experts ``wi``, ``bi``, ``wo``, ``bo`` stacked over E)
into the port's, the experts cut to one rank's ``E / ep`` of them.

``rnn_params_from_jax`` turns the JAX ``ApexRNN.init`` dict (``l0``,
``l0_rev``, ... each holding ``w_ih``, ``w_hh``, ...) into the port
``ApexRNN``'s state dict (``l0.w_ih``, ...); ``rnn_params_to_numpy`` is
the inverse.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "stack_tp_params",
           "split_tp_state", "pipeline_layers", "split_pipeline_state",
           "join_pipeline_state", "hybrid_state_from_jax",
           "stack_hybrid_state", "resnet_params_from_jax",
           "resnet_params_to_numpy", "mlp_params_from_jax",
           "module_params_from_jax", "optimizer_state_from_jax",
           "rnn_params_from_jax", "rnn_params_to_numpy",
           "zero_state_from_jax", "zero_state_to_numpy",
           "moe_params_from_jax"]

_LINEARS = ("qkv", "proj", "fc1", "fc2")
_NORMS = ("ln1", "ln2")
_LEAVES = ("weight", "bias")
# BERT's dense parameter groups beyond GPT's, by their pytree path
_BERT_DENSE = (("pooler",), ("lm_head", "dense"), ("lm_head", "ln"),
               ("binary_head",))


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        raw = np.array(arr.view(np.uint16))   # a writable copy of the bits
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def params_from_jax(tree: dict, cfg, tp_rank: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors) of tensor rank ``tp_rank`` from the JAX
    ``GPTModel.init`` or ``BertModel.init`` pytree with numpy leaves (its
    tensor-parallel leaves stacked by rank, or a shard dim of 1 for
    rank 0's view). ``cfg`` gives ``num_layers``."""
    def shard(arr, what: str):
        if not 0 <= tp_rank < arr.shape[0]:
            raise ValueError(f"{what}: no shard {tp_rank} in a leading "
                             f"shard dim of {arr.shape[0]}")
        return arr[tp_rank]

    sd: Dict[str, torch.Tensor] = {
        "embedding.word.weight": _to_torch(shard(
            tree["embedding"]["word"]["weight"], "embedding.word.weight")),
        "embedding.position": _to_torch(tree["embedding"]["position"]),
        "final_ln.weight": _to_torch(tree["final_ln"]["weight"]),
        "final_ln.bias": _to_torch(tree["final_ln"]["bias"]),
    }
    layers = tree["layers"]
    for i in range(cfg.num_layers):
        for name in _NORMS:
            for leaf in ("weight", "bias"):
                sd[f"layers.{i}.{name}.{leaf}"] = _to_torch(
                    layers[name][leaf][i])
        for name in _LINEARS:
            for leaf in ("weight", "bias"):
                sd[f"layers.{i}.{name}.{leaf}"] = _to_torch(shard(
                    layers[name][leaf][i], f"layers.{name}.{leaf}"))
    if "tokentype" in tree["embedding"]:
        sd["embedding.tokentype"] = _to_torch(tree["embedding"]["tokentype"])
        for path in _BERT_DENSE:
            node = _get(tree, path)
            if node is not None:
                for leaf in _LEAVES:
                    sd[".".join(path + (leaf,))] = _to_torch(node[leaf])
        sd["lm_head.bias"] = _to_torch(shard(tree["lm_head"]["bias"],
                                             "lm_head.bias"))
    return sd


def _get(tree: dict, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def params_to_numpy(state_dict, cfg) -> dict:
    """The JAX pytree layout (numpy leaves, layers stacked, shard dim 1)
    from one rank's port state dict. bf16 leaves come back as their raw
    ``uint16`` bits (view them as numpy's bf16 extension dtype, which the
    port does not import, to hand them to JAX)."""
    def get(name):
        return _to_numpy(state_dict[name])

    L = cfg.num_layers
    layers: dict = {}
    for name in _NORMS:
        layers[name] = {leaf: np.stack([get(f"layers.{i}.{name}.{leaf}")
                                        for i in range(L)])
                        for leaf in ("weight", "bias")}
    for name in _LINEARS:
        layers[name] = {leaf: np.stack([get(f"layers.{i}.{name}.{leaf}")[None]
                                        for i in range(L)])
                        for leaf in ("weight", "bias")}
    tree = {
        "embedding": {"word": {"weight": get("embedding.word.weight")[None]},
                      "position": get("embedding.position")},
        "layers": layers,
        "final_ln": {"weight": get("final_ln.weight"),
                     "bias": get("final_ln.bias")},
    }
    if "embedding.tokentype" in state_dict:
        tree["embedding"]["tokentype"] = get("embedding.tokentype")
        for path in _BERT_DENSE:
            if ".".join(path + ("weight",)) not in state_dict:
                continue
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            for leaf in _LEAVES:
                node[leaf] = get(".".join(path + (leaf,)))
        tree["lm_head"]["bias"] = get("lm_head.bias")[None]
    return tree


def stack_tp_params(states, cfg) -> dict:
    """The whole JAX pytree (numpy leaves) from every tensor rank's state
    dict (or grads by parameter name), in rank order: the tensor-parallel
    leaves stacked along their shard dim, the rest from rank 0."""
    trees = [params_to_numpy(sd, cfg) for sd in states]

    def join(nodes, path):
        if isinstance(nodes[0], dict):
            return {k: join([n[k] for n in nodes], path + (k,))
                    for k in nodes[0]}
        if path in (("embedding", "word", "weight"), ("lm_head", "bias")):
            return np.concatenate(nodes, axis=0)
        if path[0] == "layers" and path[1] in _LINEARS:
            return np.concatenate(nodes, axis=1)
        return nodes[0]

    return join(trees, ())


def split_tp_state(state_dict, cfg, tp: int, rank: int
                   ) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``tp``'s state dict from a tp = 1 one: each
    tensor-parallel parameter's ``1/tp`` slice along its shard dim (the
    layers' ``init`` law), a copy of the rest."""
    from apex_tpu_torch.models.gpt import tp_shard_dim
    out = {}
    for name, t in state_dict.items():
        dim = tp_shard_dim(name)
        part = t if dim is None else t.chunk(tp, dim)[rank]
        out[name] = part.detach().clone()
    return out


def pipeline_layers(num_layers: int, pp: int, pp_rank: int,
                    chunks: int = 1) -> List[List[int]]:
    """The global layer indices of each chunk of pipeline rank
    ``pp_rank``: chunk ``c`` is global stage ``c * pp + pp_rank`` of ``pp
    * chunks`` equal stages."""
    stages = pp * chunks
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers do not split into {stages} "
                         "equal stages")
    per = num_layers // stages
    return [list(range((c * pp + pp_rank) * per,
                       (c * pp + pp_rank + 1) * per)) for c in range(chunks)]


def _stage_name(c: int, j: int, leaf: str, chunks: int) -> str:
    return f"{j}.{leaf}" if chunks == 1 else f"{c}.{j}.{leaf}"


def split_pipeline_state(state_dict, cfg, pp: int, pp_rank: int,
                         chunks: int = 1):
    """``(stage, shared)`` state dicts of pipeline rank ``pp_rank`` from a
    GPT state dict (one tensor rank's): the rank's layers renamed by
    their place in its stage, and the embedding and final LayerNorm."""
    layer_of = {i: (c, j) for c, ids in enumerate(
        pipeline_layers(cfg.num_layers, pp, pp_rank, chunks))
        for j, i in enumerate(ids)}
    stage, shared = {}, {}
    for name, t in state_dict.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            if int(i) in layer_of:
                stage[_stage_name(*layer_of[int(i)], leaf, chunks)] = t
        else:
            shared[name] = t
    return stage, shared


def join_pipeline_state(stages, shared, cfg, pp: int, chunks: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """A GPT state dict from every pipeline rank's stage state dict (in
    rank order) and the shared one: the inverse of
    :func:`split_pipeline_state`."""
    out = dict(shared)
    for rank, stage in enumerate(stages):
        ids = pipeline_layers(cfg.num_layers, pp, rank, chunks)
        for name, t in stage.items():
            parts = name.split(".", 1 if chunks == 1 else 2)
            c, j, leaf = ((0, *parts) if chunks == 1 else parts)
            out[f"layers.{ids[int(c)][int(j)]}.{leaf}"] = t
    return out


def _hybrid_tree(stage_stack, shared, num_layers: int, chunks: int) -> dict:
    """The ``GPTModel.init`` tree from a hybrid trainer's stacked stage
    leaves (``(pp, per, ...)`` or ``(chunks, pp, per, ...)``, whose
    leading dims flatten into the global layer order) and shared params."""
    lead = 2 if chunks == 1 else 3
    layers = {k: {leaf: np.asarray(a).reshape(num_layers,
                                              *np.shape(a)[lead:])
                  for leaf, a in node.items()}
              for k, node in stage_stack.items()}
    return {"embedding": shared["embedding"], "final_ln": shared["final_ln"],
            "layers": layers}


def hybrid_state_from_jax(stage_stack, shared, cfg, pp: int, pp_rank: int,
                          tp_rank: int = 0, chunks: int = 1,
                          opt_state=None):
    """One rank's ``(stage, shared)`` state dicts (CPU tensors) from the
    JAX ``GPTHybridTrainer`` state with numpy leaves: ``stage_stack`` with
    leaves ``(pp, per, ...)`` (``(chunks, pp, per, ...)`` with chunks),
    ``shared`` the embedding and final LayerNorm; the tensor shards are
    rank ``tp_rank``'s. With ``opt_state`` (a JAX ``AdamState`` over
    ``(stage_stack, shared)``) also the port's ``AdamState`` over the
    trainer's parameter tree ``(stage, shared)``, moments under the same
    names."""
    def cut(stack, sh):
        tree = _hybrid_tree(stack, sh, cfg.num_layers, chunks)
        return split_pipeline_state(params_from_jax(tree, cfg, tp_rank),
                                    cfg, pp, pp_rank, chunks)

    stage, sh = cut(stage_stack, shared)
    if opt_state is None:
        return stage, sh
    from apex_tpu_torch.optimizers import AdamState
    return stage, sh, AdamState(
        step=torch.tensor(int(np.asarray(opt_state.step)),
                          dtype=torch.int32),
        exp_avg=cut(*opt_state.exp_avg), exp_avg_sq=cut(*opt_state.exp_avg_sq))


def stack_hybrid_state(states, cfg, pp: int, tp: int = 1, chunks: int = 1):
    """The JAX ``GPTHybridTrainer`` layout ``(stage_stack, shared)``
    (numpy leaves) from every rank's ``(stage, shared)`` state dicts
    (or grads, or moments), ``states[pp_rank][tp_rank]``; the shared
    leaves are pipeline rank 0's."""
    full = [join_pipeline_state([states[p][t][0] for p in range(pp)],
                                states[0][t][1], cfg, pp, chunks)
            for t in range(tp)]
    tree = stack_tp_params(full, cfg)
    lead = (chunks, pp) if chunks > 1 else (pp,)
    per = cfg.num_layers // (pp * chunks)
    stack = {k: {leaf: a.reshape(*lead, per, *a.shape[1:])
                 for leaf, a in node.items()}
             for k, node in tree["layers"].items()}
    return stack, {"embedding": tree["embedding"],
                   "final_ln": tree["final_ln"]}


_BN_STATE = ("running_mean", "running_var", "num_batches_tracked")


def resnet_params_from_jax(params: dict, state: dict
                           ) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors) of the port's ``ResNet50`` from the JAX
    ``ResNet50.init`` pytrees ``(params, bn_state)`` with numpy leaves (a
    ``BatchNormState`` node may be the named tuple or any 3-sequence)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk_params(node, prefix):
        for key, sub in node.items():
            name = prefix + key
            if isinstance(sub, dict):
                walk_params(sub, name + ".")
                continue
            arr = np.asarray(sub)
            if key.startswith("conv"):       # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            sd[name] = _to_torch(arr)

    def walk_state(node, prefix):
        for key, sub in node.items():
            if isinstance(sub, dict):
                walk_state(sub, prefix + key + ".")
                continue
            for leaf, arr in zip(_BN_STATE, sub):
                t = _to_torch(arr)
                sd[f"{prefix}{key}.{leaf}"] = (
                    t.to(torch.int64) if leaf == "num_batches_tracked" else t)

    walk_params(params, "")
    walk_state(state, "")
    return sd


def resnet_params_to_numpy(state_dict) -> tuple:
    """``(params, bn_state)`` in the JAX ``ResNet50`` layout (numpy leaves,
    conv weights HWIO, each BN's state a ``(running_mean, running_var,
    num_batches_tracked)`` tuple with an int32 count) from the port's
    state dict."""
    params: dict = {}
    state: dict = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        if leaf in _BN_STATE:
            node = state
            for key in path[:-1]:
                node = node.setdefault(key, {})
            entry = list(node.get(path[-1], (None, None, None)))
            arr = _to_numpy(t)
            entry[_BN_STATE.index(leaf)] = (
                arr.astype(np.int32) if leaf == "num_batches_tracked"
                else arr)
            node[path[-1]] = tuple(entry)
            continue
        node = params
        for key in path:
            node = node.setdefault(key, {})
        arr = _to_numpy(t)
        node[leaf] = arr.transpose(2, 3, 1, 0) if leaf.startswith(
            "conv") else arr
    return params, state


def mlp_params_from_jax(layers) -> Dict[str, torch.Tensor]:
    """The port ``MLP``'s state dict from the JAX ``MLP.init`` list of
    ``(weight, bias)`` pairs (bias ``None`` without biases)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (w, b) in enumerate(layers):
        sd[f"weight_{i}"] = _to_torch(w)
        if b is not None:
            sd[f"bias_{i}"] = _to_torch(b)
    return sd


def module_params_from_jax(tree: dict, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """A state dict of dotted names from a nested dict of arrays (the JAX
    ``FusedDense``, ``FusedDenseGeluDense`` and attention modules'
    ``init`` trees)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            sd.update(module_params_from_jax(sub, f"{prefix}{key}."))
        else:
            sd[prefix + key] = _to_torch(sub)
    return sd


def rnn_params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The port ``ApexRNN``'s state dict from the JAX ``ApexRNN.init``
    dict of ``l{layer}[_rev]`` leaf dicts (numpy leaves)."""
    return module_params_from_jax(params)


def rnn_params_to_numpy(state_dict) -> dict:
    """The JAX ``ApexRNN`` params layout (numpy leaves) from the port's
    state dict."""
    tree: dict = {}
    for name, t in state_dict.items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = _to_numpy(t)
    return tree


def _tree_like(tree, like):
    """``tree`` (numpy leaves) as CPU tensors, its dicts in ``like``'s key
    order (``like`` None: as they come)."""
    if isinstance(tree, dict):
        keys = list(like.keys()) if isinstance(like, dict) else list(tree)
        return {k: _tree_like(tree[k], like[k] if isinstance(like, dict)
                              else None) for k in keys}
    if isinstance(tree, (list, tuple)):
        likes = like if isinstance(like, (list, tuple)) else [None] * len(
            tree)
        return type(tree)(_tree_like(t, l) for t, l in zip(tree, likes))
    return _to_torch(tree)


def optimizer_state_from_jax(state, cls, like=None):
    """The port's optimizer state ``cls`` (a named tuple of the JAX
    state's field names) from a JAX optimizer state with numpy leaves;
    the step count becomes an int32 0-d tensor, each tree's dicts take
    the key order of the port's parameter tree ``like``."""
    out = {}
    for field in cls._fields:
        value = getattr(state, field)
        if field == "step":
            out[field] = torch.tensor(int(np.asarray(value)),
                                      dtype=torch.int32)
        else:
            out[field] = _tree_like(value, like)
    return cls(**out)


_ZERO_SHARDS = ("master", "exp_avg", "exp_avg_sq")


def zero_state_from_jax(state, rank: int, world: int, device="cpu"):
    """Rank ``rank`` of ``world``'s port ``ZeroAdamState`` from a JAX
    ZeRO state with numpy leaves: its slice of each global shard array,
    the step as an int32 0-d tensor and the bucket stamp as an int.
    ``state`` may also be a dict of its fields."""
    from apex_tpu_torch.optimizers.distributed_fused import ZeroAdamState
    if not isinstance(state, dict):
        state = {f: getattr(state, f) for f in ZeroAdamState._fields}
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=device),
           "bucket_stamp": int(np.asarray(state["bucket_stamp"]))}
    for field in _ZERO_SHARDS:
        full = np.asarray(state[field], np.float32)
        if full.shape[0] % world:
            raise ValueError(f"{field} of {full.shape[0]} elements does not "
                             f"split into {world} shards")
        chunk = full.shape[0] // world
        out[field] = torch.from_numpy(
            full[rank * chunk:(rank + 1) * chunk].copy()).to(device)
    return ZeroAdamState(**out)


def zero_state_to_numpy(states) -> dict:
    """The JAX layout of a ZeRO state from every rank's port state, in
    rank order: ``{"step", "master", "exp_avg", "exp_avg_sq",
    "bucket_stamp"}`` as numpy (the shards concatenated)."""
    steps = {int(np.asarray(st.step)) for st in states}
    stamps = {int(np.asarray(st.bucket_stamp)) for st in states}
    if len(steps) != 1 or len(stamps) != 1:
        raise ValueError(f"the ranks' states disagree: steps {steps}, "
                         f"bucket stamps {stamps}")
    out = {"step": np.asarray(steps.pop(), np.int32),
           "bucket_stamp": np.asarray(stamps.pop(), np.int32)}
    for field in _ZERO_SHARDS:
        out[field] = np.concatenate([
            np.asarray(getattr(st, field).cpu() if isinstance(
                getattr(st, field), torch.Tensor) else getattr(st, field),
                np.float32) for st in states])
    return out


def moe_params_from_jax(tree: dict, ep: int = 1, rank: int = 0,
                        device="cpu") -> dict:
    """The port's ``ExpertParallelMLP`` parameters from the JAX tree with
    numpy leaves: the router whole, and rank ``rank`` of ``ep``'s experts
    (rows ``rank * E / ep`` to ``(rank + 1) * E / ep`` of each stacked
    leaf), bit for bit."""
    E = np.asarray(tree["router"]["weight"]).shape[0]
    if E % ep:
        raise ValueError(f"{E} experts do not split over ep={ep}")
    lo, hi = rank * E // ep, (rank + 1) * E // ep
    return {"router": {"weight": _to_torch(
                tree["router"]["weight"]).to(device)},
            "experts": {k: _to_torch(np.asarray(tree["experts"][k])[lo:hi])
                        .to(device) for k in ("wi", "bi", "wo", "bo")}}
