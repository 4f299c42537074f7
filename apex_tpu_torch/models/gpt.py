"""GPT for the port: dense forward, LM loss, KV-cached prefill and decode.

Counterpart of ``apex_tpu/models/gpt.py`` (pre-LN GPT-2 style, learned
positions, tied output embedding) as an ``nn.Module`` whose parameter names
mirror the JAX pytree keys: ``embedding.word.weight``,
``embedding.position``, ``layers.<i>.{ln1,qkv,proj,ln2,fc1,fc2}.*`` and
``final_ln.*`` (the JAX layers are stacked ``(L, ...)``; here they are a
``ModuleList``, see :mod:`apex_tpu_torch._bridge`).

Numerics follow the reference's mixed-dtype rules: fp32 parameters, bf16
compute by default; linear products accumulate in fp32 and are cast to the
activation dtype before the bias is added; LayerNorm parameters are cast
to the activation dtype; the embedding and position sum is taken in fp32
and then cast; the tied head casts the word embedding to the activation
dtype and returns fp32 logits; gelu is the tanh approximation.

Attention runs :func:`~apex_tpu_torch.ops.flash_attention.flash_attention`
in the dense forward and prefill (differentiable: the flash forward and
backward kernels),
:func:`~apex_tpu_torch.ops.flash_attention.decode_attention` in decode
over a dense cache and
:func:`~apex_tpu_torch.ops.flash_attention.paged_decode_attention` in
decode over a paged one; every LayerNorm runs
:func:`~apex_tpu_torch.normalization.fused_layer_norm_affine` (the
``ln_fwd``/``ln_bwd`` kernels). ``GPTConfig.use_kernel`` is passed to all
of them (``None``: the CUDA kernels on the card, the plain versions on the
CPU; ``False`` keeps the whole model on the plain versions).

Training: every parameter is trainable, and :meth:`GPTModel.loss` is the
reference's LM loss (softmax cross-entropy with ``padding_idx=None``, mean
or masked mean). A ``torch.Generator`` passed to :meth:`GPTModel.forward`
or :meth:`GPTModel.loss` turns on train-mode dropout, the reference's
layout: embedding and hidden dropout at ``hidden_dropout``
(:func:`~apex_tpu_torch.ops.dropout.dropout`), and attention dropout at
``attention_dropout`` inside the flash kernels, seeded per layer by ints
drawn from the generator in ``[0, 2**31 - 1)``. The serving legs run
under ``torch.no_grad`` (:mod:`apex_tpu_torch.serving.engine`).

Serving runs over a dense :class:`~apex_tpu_torch.serving.cache.KVCache`
or a paged :class:`~apex_tpu_torch.serving.cache.PagedKVCache` (the
reference's paged legs: prefill into pool blocks, decode through block
tables with copy-on-write first) and the speculative verify leg
(:meth:`GPTModel.verify_forward`: each slot's last token and its drafts in
one pass, both decode kernels at ``q_len = k + 1``).

Activation remat: ``GPTConfig.remat_policy`` (``"none"``, ``"full"``,
``"selective"``, ``"offload"`` or a :class:`~apex_tpu_torch.remat.
RematPolicy`; the deprecated ``remat=True`` means ``"full"``) and
``remat_names`` are resolved once, in the constructor, as the reference
resolves them. :meth:`GPTModel.transform` wraps each layer with the policy;
under a name-based policy the layer tags its LayerNorm, QKV, projection and
MLP outputs and the flash op its context and logsumexp
(:data:`~apex_tpu_torch.remat.CHECKPOINT_NAMES`), and under ``none`` and
``full`` it calls no tag.

Tensor parallelism (``tensor_model_parallel_size`` above 1, the ranks of
the installed mesh's tensor group): QKV and fc1 are column-sharded, proj
and fc2 row-sharded, the heads split ``heads / tp`` a rank, the word
embedding and the tied head vocab-sharded; :meth:`GPTModel.logits`
returns this rank's vocab shard and :meth:`GPTModel.loss` runs
vocab-parallel cross-entropy. ``sequence_parallel`` runs the LayerNorms,
dropout and residuals on ``(b, s / tp, h)`` sequence shards: ``embed``
scatters the sequence, the ColumnParallel inputs gather it, the
RowParallel outputs reduce-scatter it, and ``transform`` gathers it after
the final LayerNorm. The LayerNorm parameters enter their region through
:func:`~apex_tpu_torch.transformer.tensor_parallel.mappings.
copy_to_tensor_model_parallel_region`, so ``loss.backward()`` leaves
their grads summed over the tensor group (the JAX package sums them
inside its LayerNorm's backward) and :meth:`GPTModel.sp_grad_sync` is the
reference's no-op. ``tp_comm_overlap`` swaps the sequence-parallel
gather and reduce-scatter for the ring-decomposed
:mod:`~apex_tpu_torch.transformer.tensor_parallel.collective_matmul`.
Dropout at tp > 1 follows the reference's streams: the attention seeds
come from a generator folded with the tensor rank, and so do the hidden
and embedding masks under sequence parallelism (each rank drops its own
shard); without it the hidden masks are the caller's, the same on every
rank. The serving legs refuse tp > 1 and sequence parallelism, as the
reference does.

Pipeline parallelism: :meth:`GPTModel.stage_fn` cuts the layer stack into
equal stages (a rank's stage is an ``nn.ModuleList`` of its layers) and
:meth:`GPTModel.pipeline_fns` adds the pipelined embedding (global stage
0) and the final LayerNorm, tied head and LM loss (the last stage) over
the shared parameters, for the schedules of
:mod:`apex_tpu_torch.transformer.pipeline_parallel.schedules`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.dropout import dropout
from apex_tpu_torch.ops.flash_attention import (decode_attention,
                                                flash_attention,
                                                paged_decode_attention)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.remat import RematPolicy, tag as _remat_tag
from apex_tpu_torch.serving.cache import PagedKVCache, store_roundtrip
from apex_tpu_torch.transformer.context_parallel import (
    gather_from_sequence_parallel_region,
    scatter_to_sequence_parallel_region)
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    init_method_normal)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region)

__all__ = ["GPTConfig", "GPTModel"]

# the stride between the tensor ranks' dropout seeds (golden ratio, as
# model_parallel_seed's data-rank stride)
_RANK_STRIDE = 0x9E3779B97F4A7C15
# the parameters sharded along the vocab (BERT's MLM output bias too)
_VOCAB_SHARDED = ("embedding.word.weight", "lm_head.bias")


def tp_shard_dim(name: str) -> Optional[int]:
    """The dim along which the tensor ranks split the parameter ``name``
    of a GPT or BERT state dict: 0 for the vocab-sharded word embedding
    and MLM output bias and the Column (qkv, fc1) weights and biases, 1
    for the Row (proj, fc2) weights, ``None`` for what every rank holds
    whole (the norms, the positions, the dense heads, and the Row biases,
    which are copies)."""
    layer, leaf = (name.split(".")[-2:] + [""])[:2]
    if name in _VOCAB_SHARDED or layer in ("qkv", "fc1"):
        return 0
    if layer in ("proj", "fc2") and leaf == "weight":
        return 1
    return None


def _fold_tensor_rank(generator: torch.Generator) -> torch.Generator:
    """A generator for this tensor rank, split off ``generator``: one seed
    drawn from it (which advances it alike on every rank, since the ranks
    share it) plus the rank's stride. The reference folds the rank into
    its key (``fold_in(key, rank + 1)``)."""
    from apex_tpu_torch.transformer import parallel_state
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    rank = parallel_state.get_tensor_model_parallel_rank()
    child = torch.Generator(device=generator.device)
    child.manual_seed((seed + (rank + 1) * _RANK_STRIDE) % 2 ** 63)
    return child


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Sizes follow the Megatron argument names, as in the reference."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    tensor_model_parallel_size: int = 1
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    init_method_std: float = 0.02
    layernorm_epsilon: float = 1e-5
    # the reference's ``use_flash``: None = the kernels iff on CUDA
    use_kernel: Optional[bool] = None
    # train-mode dropout rates (0.0 = off), applied only when a generator
    # is passed to forward/loss
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    # Per-layer activation rematerialization, as in the reference:
    # ``remat_policy`` None | "none" | "full" | "selective" | "offload" | a
    # remat.RematPolicy ("selective" keeps the registry-tagged GEMM and
    # flash outputs and recomputes the LayerNorms, gelu and adds: see
    # apex_tpu_torch/remat.py); ``remat: bool`` is the deprecated spelling,
    # honoured (True -> "full") when remat_policy is None; ``remat_names``:
    # a custom save-list for the name-based modes
    remat: bool = False
    remat_policy: Any = None
    remat_names: Optional[Tuple[str, ...]] = None
    # Megatron-LM sequence parallelism (LayerNorms, dropout and residuals
    # on sequence shards; tp > 1), and its ring-decomposed gather and
    # reduce-scatter under the GEMMs (needs sequence_parallel)
    sequence_parallel: bool = False
    tp_comm_overlap: bool = False

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _resolve_remat(cfg: GPTConfig) -> RematPolicy:
    """The config's remat policy, resolved once (the legacy bool's
    deprecation warning fires here), with ``remat_names`` folded in: the
    reference's ``GPTModel.__init__`` checks and messages."""
    policy = RematPolicy.resolve(cfg.remat_policy, legacy_bool=cfg.remat,
                                 owner=type(cfg).__name__)
    if cfg.remat_names is None:
        return policy
    if not policy.uses_names:
        raise ValueError(
            "remat_names requires a name-based remat_policy "
            f"('selective' or 'offload'), got {policy.mode!r}")
    if policy.names is not None and policy.names != tuple(cfg.remat_names):
        raise ValueError(
            "conflicting save-lists: remat_policy carries "
            f"names={policy.names!r} but remat_names="
            f"{tuple(cfg.remat_names)!r}; set the list in one place")
    return dataclasses.replace(policy, names=tuple(cfg.remat_names))


class _Norm(nn.Module):
    def __init__(self, h: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(h, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(h, dtype=dtype, device=device))

    def init(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class _Layer(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.params_dtype
        init = init_method_normal(cfg.init_method_std)
        # output layers scaled by sqrt(2 * layers), as in the reference
        out_init = init_method_normal(
            cfg.init_method_std / math.sqrt(2.0 * cfg.num_layers))
        tp = dict(world_size=cfg.tensor_model_parallel_size,
                  sequence_parallel=cfg.sequence_parallel, seq_axis=1,
                  tp_comm_overlap=cfg.tp_comm_overlap, params_dtype=dt,
                  device=device)
        self.ln1 = _Norm(h, dt, device)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                        init_method=init, **tp)
        self.proj = RowParallelLinear(h, h, input_is_parallel=True,
                                      init_method=out_init, **tp)
        self.ln2 = _Norm(h, dt, device)
        self.fc1 = ColumnParallelLinear(h, cfg.ffn, gather_output=False,
                                        init_method=init, **tp)
        self.fc2 = RowParallelLinear(cfg.ffn, h, input_is_parallel=True,
                                     init_method=out_init, **tp)


class _Embedding(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        self.word = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            init_method=init_method_normal(cfg.init_method_std),
            params_dtype=cfg.params_dtype,
            world_size=cfg.tensor_model_parallel_size, device=device)
        self.position = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size,
            dtype=cfg.params_dtype, device=device))


class GPTModel(nn.Module):
    """GPT as an ``nn.Module`` on ``device`` (default ``"cuda"``; raises
    when no card is present). Parameters are allocated, not initialized:
    call :meth:`init` with a ``torch.Generator`` or load a state dict
    (:func:`apex_tpu_torch._bridge.params_from_jax` makes one from the
    JAX ``GPTModel.init`` pytree). ``model(tokens)`` returns the logits
    of the dense forward; :meth:`forward` with a ``kv_cache`` runs the
    serving legs."""

    # the layer stack's attention mask: causal here; an encoder subclass
    # (BERT) sets False and passes a padding bias to transform()
    causal = True

    def __init__(self, config: GPTConfig, device="cuda"):
        super().__init__()
        cfg = config
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError("hidden_size must divide num_attention_heads")
        if cfg.num_attention_heads % cfg.tensor_model_parallel_size:
            raise ValueError("heads must divide tp size")
        if cfg.sequence_parallel and cfg.tensor_model_parallel_size <= 1:
            raise ValueError("sequence_parallel requires tp > 1")
        if cfg.tp_comm_overlap and not cfg.sequence_parallel:
            raise ValueError(
                "tp_comm_overlap requires sequence_parallel=True: only the "
                "SP gather->GEMM / GEMM->reduce-scatter pairs are dependent "
                "collectives (plain-TP collectives already overlap)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.remat_policy = _resolve_remat(cfg)
        # tags only under a name-based policy: none and full run the
        # untagged forward
        self._tag = (_remat_tag if self.remat_policy.uses_names
                     else (lambda x, name: x))
        self.embedding = _Embedding(cfg, dev)
        self.layers = nn.ModuleList(_Layer(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.final_ln = _Norm(cfg.hidden_size, cfg.params_dtype, dev)

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "GPTModel":
        """The reference's init law: N(0, std) for the embeddings, qkv and
        fc1, N(0, std / sqrt(2L)) for proj and fc2, zero biases, unit
        LayerNorm. Draws come from the CPU ``generator`` in a fixed order,
        so a seed gives the same weights on every device (not the JAX
        package's weights: the two generators differ)."""
        std = self.cfg.init_method_std
        self.embedding.word.init(generator)
        init_method_normal(std)(self.embedding.position, generator)
        for lp in self.layers:
            lp.ln1.init()
            lp.ln2.init()
            for lin in (lp.qkv, lp.proj, lp.fc1, lp.fc2):
                lin.init(generator)
        self.final_ln.init()
        return self

    # -- blocks -------------------------------------------------------------

    def _ln(self, p: _Norm, x: torch.Tensor) -> torch.Tensor:
        # bf16 activations, fp32 LN params -> params cast, bf16 out
        weight, bias = p.weight, p.bias
        if self.cfg.sequence_parallel:
            # on a sequence shard: the grads are summed over the group
            weight = copy_to_tensor_model_parallel_region(weight)
            bias = copy_to_tensor_model_parallel_region(bias)
        out = fused_layer_norm_affine(
            x, weight.to(x.dtype), bias.to(x.dtype),
            self.cfg.hidden_size, eps=self.cfg.layernorm_epsilon,
            use_kernel=self.cfg.use_kernel)
        # not in the selective save-list: recomputing a LayerNorm is one
        # kernel launch
        return self._tag(out, "ln_out")

    def _split_heads(self, qkv: torch.Tensor):
        """``(..., 3*hidden/tp)`` -> q, k, v ``(..., heads/tp,
        head_dim)``: this rank's heads. The layout is per-head
        interleaved: each head's ``[q|k|v]`` sits together, so the
        reshape comes before the split."""
        cfg = self.cfg
        local_heads = cfg.num_attention_heads // cfg.tensor_model_parallel_size
        qkv = qkv.reshape(*qkv.shape[:-1], local_heads, 3 * cfg.head_dim)
        return qkv.split(cfg.head_dim, dim=-1)

    def _attention(self, lp: _Layer, x: torch.Tensor, attn_seed=None,
                   collect_kv: bool = False, bias=None):
        qkv, _ = lp.qkv(x)
        # under SP the ColumnParallel input gather restores the sequence
        b, s, _ = qkv.shape
        qkv = self._tag(qkv, "qkv_out")
        q, k, v = (t.transpose(1, 2) for t in self._split_heads(qkv))
        rate = self.cfg.attention_dropout if attn_seed is not None else 0.0
        ctx = flash_attention(q, k, v, bias=bias, causal=self.causal,
                              use_kernel=self.cfg.use_kernel,
                              dropout_rate=rate, dropout_seed=attn_seed,
                              checkpoint_names=self.remat_policy.uses_names)
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        out, _ = lp.proj(ctx)
        out = self._tag(out, "attn_proj_out")
        if collect_kv:
            # prefill: the serving cache wants this layer's K/V
            return out, (k, v)
        return out

    def _mlp(self, lp: _Layer, x: torch.Tensor) -> torch.Tensor:
        h, _ = lp.fc1(x)
        # tagged before gelu: the same bytes as its output, and only the
        # elementwise gelu is left to recompute for fc2's weight gradient
        h = self._tag(h, "mlp_fc1_out")
        h = F.gelu(h, approximate="tanh")
        out, _ = lp.fc2(h)
        return self._tag(out, "mlp_fc2_out")

    def _layer(self, lp: _Layer, x: torch.Tensor, attn_seed=None,
               generator: Optional[torch.Generator] = None,
               collect_kv: bool = False, bias=None):
        rate = self.cfg.hidden_dropout
        a = self._attention(lp, self._ln(lp.ln1, x), attn_seed,
                            collect_kv=collect_kv, bias=bias)
        if collect_kv:
            a, kv = a
        x = x + dropout(a, rate, generator)
        x = x + dropout(self._mlp(lp, self._ln(lp.ln2, x)), rate, generator)
        return (x, kv) if collect_kv else x

    # -- dense forward ------------------------------------------------------

    def embed(self, tokens: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Word plus position embedding, summed in fp32 and cast; with a
        ``generator``, embedding dropout at the hidden rate. Under
        sequence parallelism: this rank's sequence shard, its dropout
        from a rank-folded generator."""
        return self._embed(self.embedding, tokens, generator)

    def _embed(self, embedding: _Embedding, tokens: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        h = embedding.word(tokens)
        pos = embedding.position[: tokens.shape[1]]
        h = (h + pos).to(cfg.compute_dtype)
        if cfg.sequence_parallel:
            h = scatter_to_sequence_parallel_region(h, TENSOR_AXIS,
                                                    seq_axis=1)
            if generator is not None and cfg.hidden_dropout > 0.0:
                generator = _fold_tensor_rank(generator)
        return dropout(h, cfg.hidden_dropout, generator)

    def transform(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The layer stack and the final LayerNorm, every layer's
        attention taking the additive score ``bias`` (if any), each layer
        wrapped by the remat policy. With a ``generator`` and a non-zero
        dropout rate: train-mode dropout, one attention seed per layer
        drawn first (the reference's ``_layer_rngs``), then the hidden
        masks layer by layer (the same masks under every policy). At
        tp > 1 the seeds come from a rank-folded generator, and under
        sequence parallelism the hidden masks too; there ``x`` is this
        rank's sequence shard and the result the gathered sequence."""
        cfg = self.cfg
        if cfg.tp_comm_overlap:
            self.record_tp_overlap(tuple(x.shape))
        if cfg.hidden_dropout == 0.0 and cfg.attention_dropout == 0.0:
            generator = None
        seeds = [None] * len(self.layers)
        if generator is not None:
            seed_gen = generator
            if cfg.tensor_model_parallel_size > 1:
                seed_gen = _fold_tensor_rank(generator)
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.layers),),
                                  generator=seed_gen,
                                  device=seed_gen.device).tolist()
            if cfg.sequence_parallel:
                generator = _fold_tensor_rank(generator)
        layer_fn = self.remat_policy.wrap(self._layer)
        for lp, seed in zip(self.layers, seeds):
            x = layer_fn(lp, x, seed, generator, bias=bias)
        x = self._ln(self.final_ln, x)
        if cfg.sequence_parallel:
            # the whole sequence for the tied head, whose backward sums
            # the gradient over the group first: keep this rank's slice
            x = gather_from_sequence_parallel_region(
                x, TENSOR_AXIS, seq_axis=1, invariant=True)
        return x

    def tp_overlap_fwd_bytes(self, shard_shape: Tuple[int, ...]) -> int:
        """A rank's forward ring bytes for one pass through the layer
        stack on a ``(b, s / tp, h)`` activation shard (the
        ``tp/collective_bytes`` accounting): two Column rings (qkv, fc1)
        carrying the activation dtype and two Row rings (proj, fc2)
        carrying the fp32 partial sum, ``tp - 1`` hops each, a layer. The
        backward rings move the same chunk counts with fp32 payloads."""
        cfg = self.cfg
        tp = cfg.tensor_model_parallel_size
        shard = math.prod(shard_shape)
        col_bytes = shard * torch.empty(
            (), dtype=cfg.compute_dtype).element_size()
        row_bytes = shard * 4
        return cfg.num_layers * (tp - 1) * (2 * col_bytes + 2 * row_bytes)

    def record_tp_overlap(self, shard_shape: Tuple[int, ...],
                          passes: int = 1) -> None:
        """``tp/overlap_chunks`` (mean) and ``tp/collective_bytes`` (sum)
        into the open :mod:`~apex_tpu_torch.observability.ingraph`
        collector, once a layer-stack pass; nothing without one.
        ``passes``: layer-stack passes a step."""
        from apex_tpu_torch.observability import ingraph
        if not ingraph.recording():
            return
        dev = self.final_ln.weight.device
        ingraph.record("tp/overlap_chunks", torch.tensor(
            float(self.cfg.tensor_model_parallel_size), device=dev),
            reduce="mean")
        ingraph.record("tp/collective_bytes", torch.tensor(
            float(passes * self.tp_overlap_fwd_bytes(shard_shape)),
            device=dev), reduce="sum")

    def param_specs(self) -> dict:
        """Each parameter's tensor-axis shard dim by name
        (:func:`tp_shard_dim`): the reference's ``PartitionSpec`` tree,
        for a port state dict."""
        return {name: tp_shard_dim(name) for name, _ in
                self.named_parameters()}

    def sp_grad_sync(self, grads: dict) -> dict:
        """Megatron-LM all-reduces the grads of the sequence-parallel
        parameters (the LayerNorms) in a pass of its own, since torch's
        autograd leaves per-rank partials. Here the LayerNorm parameters
        enter their region through copy-to-region, whose backward sums
        over the tensor group, so ``loss.backward()`` already leaves them
        summed and this is the reference's no-op, kept for its training
        loop's call sequence."""
        return grads

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output embedding: the word embedding cast to the
        activation dtype, products accumulated in fp32, fp32 logits; at
        tp > 1 this rank's vocab shard of them (the hidden state enters
        the region through copy-to-region: its gradient is summed over
        the group)."""
        return self._logits(self.embedding.word.weight, x)

    def _logits(self, word_weight: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tensor_model_parallel_size > 1:
            x = copy_to_tensor_model_parallel_region(x)
        w = word_weight.to(x.dtype)
        return torch.matmul(x.float(), w.float().t())

    def forward(self, tokens: torch.Tensor, kv_cache=None, slot=None,
                prompt_len=None, last_logit_only: bool = False,
                active: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                block_row=None, block_tables=None, lengths=None,
                append_block_ids=None, append_offsets=None, cow_src=None,
                cow_dst=None):
        """Without ``kv_cache``: the dense forward, logits
        ``(b, s, vocab)``, in train mode (dropout) when a ``generator`` is
        given. With a
        :class:`~apex_tpu_torch.serving.cache.KVCache`:

        - **prefill** (``slot`` given): ``tokens (1, P)``, the causal
          forward that also writes every layer's K/V into cache slot
          ``slot`` and sets its cursor to ``prompt_len`` (default ``P``).
          Returns ``(logits (1, P, vocab), cache)``, or ``(1, 1, vocab)``
          for the position ``prompt_len - 1`` alone with
          ``last_logit_only``.
        - **decode** (no ``slot``): ``tokens (max_seqs, 1)``, one token per
          slot. Attention reads each slot's cached prefix, folds in the
          current token, and after the layer stack the new K/V are
          appended at each slot's cursor (slots outside ``active`` keep a
          frozen cursor). The cursors, clipped to the position table,
          index the position embedding. Returns ``(logits (max_seqs,
          vocab), cache)``.

        With a :class:`~apex_tpu_torch.serving.cache.PagedKVCache` the
        same two legs run over the block pool: **paged prefill**
        (``block_row`` given, ``(P // block_size,)``, null-padded) writes
        the prompt's K/V into those pool blocks; **paged decode** first
        copies the copy-on-write pairs ``cow_src -> cow_dst`` (if given),
        reads each slot's context through ``block_tables``/``lengths``
        (host-side cursors, which also index the position embedding) and
        appends the new token at ``append_block_ids``/``append_offsets``.

        The cache is updated in place (the port's counterpart of the
        reference's donated cache) and returned for API parity. The
        cached legs refuse tp > 1 and sequence parallelism."""
        if kv_cache is None:
            return self.logits(self.transform(self.embed(tokens, generator),
                                              generator))
        self._require_cacheable()
        if isinstance(kv_cache, PagedKVCache):
            if block_row is not None:
                return self._paged_prefill_forward(
                    tokens, kv_cache, block_row, prompt_len,
                    last_logit_only)
            return self._paged_decode_forward(
                tokens, kv_cache, block_tables, lengths, append_block_ids,
                append_offsets, cow_src, cow_dst)
        if slot is not None:
            return self._prefill_forward(tokens, kv_cache, slot, prompt_len,
                                         last_logit_only)
        return self._decode_forward(tokens, kv_cache, active)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """LM loss, an fp32 scalar: the mean per-token softmax
        cross-entropy of the logits against ``targets`` (every token id
        counts: ``padding_idx=None``), or its ``loss_mask``-weighted mean.
        A ``generator`` turns on train-mode dropout. At tp > 1 the
        cross-entropy is vocab-parallel over the tensor group, and every
        rank gets the same loss."""
        return self._lm_loss(
            self(tokens, generator=generator), targets, loss_mask,
            vocab_parallel=self.cfg.tensor_model_parallel_size > 1)

    @staticmethod
    def _lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                 loss_mask: Optional[torch.Tensor],
                 vocab_parallel: bool = False) -> torch.Tensor:
        """Per-token softmax cross-entropy of ``logits`` against
        ``targets`` (``padding_idx=None``; with ``vocab_parallel``, of
        this rank's vocab shard of them over the tensor group), fp32,
        averaged over the tokens or over ``loss_mask``'s weight."""
        if vocab_parallel:
            per_tok = vocab_parallel_cross_entropy(logits, targets)
        else:
            per_tok = softmax_cross_entropy_loss(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                padding_idx=None, half_to_float=True).reshape(targets.shape)
        if loss_mask is not None:
            mask = loss_mask.to(per_tok.dtype)
            return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return per_tok.mean()

    # -- pipeline integration -----------------------------------------------

    def stage_fn(self, num_stages: int):
        """``(stage, split_params)`` for the pipeline schedules: the layer
        stack cut into ``num_stages`` equal stages; the embedding and the
        head stay outside (:meth:`pipeline_fns`). ``stage(stage_params, x,
        stage_idx)`` runs each layer of ``stage_params`` (a sequence of
        this model's layers) on ``x`` with no dropout, each wrapped by the
        remat policy; ``split_params(model)`` gives the ``num_stages``
        stages of a model's layers (or of a sequence of layers), each an
        ``nn.ModuleList`` sharing the layers' parameters. Raises, as the
        reference does, when ``num_stages`` does not divide the layers,
        and under sequence parallelism at ``num_stages > 1``."""
        if self.cfg.num_layers % num_stages:
            raise ValueError(
                f"num_layers ({self.cfg.num_layers}) must be divisible by "
                f"num_stages ({num_stages})")
        if self.cfg.sequence_parallel and num_stages > 1:
            raise NotImplementedError(
                "sequence_parallel does not compose with a real pipeline "
                "split yet: the inter-stage activations would cross the "
                "pipe axis as sequence shards and the shared LN grads "
                "would skip sp_grad_sync. num_stages == 1 (the hybrid "
                "trainer at pp=1) is supported — embed scatters and the "
                "head gathers, mirroring transform()")
        per = self.cfg.num_layers // num_stages
        layer_fn = self.remat_policy.wrap(self._layer)

        def stage(stage_params, x: torch.Tensor, stage_idx) -> torch.Tensor:
            for lp in stage_params:
                x = layer_fn(lp, x)
            return x

        def split_params(model) -> list:
            layers = getattr(model, "layers", model)
            return [nn.ModuleList(layers[s * per:(s + 1) * per])
                    for s in range(num_stages)]

        return stage, split_params

    def pipeline_fns(self, num_stages: int, targets: torch.Tensor):
        """The whole model as a pipeline: global stage 0 embeds the tokens,
        the last stage runs the final LayerNorm, the tied head and the LM
        loss, the layer stages lie between (upstream's pre_process and
        post_process). The embedding and the final LayerNorm are shared
        over the pipeline: the schedules sum their grads over the group
        (the tied embedding's two contributions, from the first and the
        last stage).

        ``targets``: ``(M, mb, seq)`` labels, microbatch ``m``'s loss
        against ``targets[m]``. Returns ``(stage_fn, embed_fn,
        head_loss_fn, split_params, shared_of)`` for the schedules'
        ``shared_params``/``embed_fn``: feed token microbatches ``(M, mb,
        seq)`` as the batch; ``shared_of(model)`` is ``{"embedding",
        "final_ln"}`` of a model. At tp > 1 the loss is vocab-parallel
        cross-entropy; under sequence parallelism (one stage) the head
        gathers the sequence after the final LayerNorm, as
        :meth:`transform` does."""
        stage, split_params = self.stage_fn(num_stages)

        def shared_of(model) -> dict:
            return {"embedding": model.embedding, "final_ln": model.final_ln}

        def embed_fn(shared: dict, tokens: torch.Tensor) -> torch.Tensor:
            return self._embed(shared["embedding"], tokens)

        def head_loss_fn(shared: dict, y: torch.Tensor, m) -> torch.Tensor:
            x = self._ln(shared["final_ln"], y)
            if self.cfg.sequence_parallel:
                x = gather_from_sequence_parallel_region(
                    x, TENSOR_AXIS, seq_axis=1, invariant=True)
            logits = self._logits(shared["embedding"].word.weight, x)
            return self._lm_loss(
                logits, targets[m], None,
                vocab_parallel=self.cfg.tensor_model_parallel_size > 1)

        return stage, embed_fn, head_loss_fn, split_params, shared_of

    # -- serving: KV-cached prefill/decode ----------------------------------

    def _require_cacheable(self) -> None:
        cfg = self.cfg
        if cfg.tensor_model_parallel_size != 1 or cfg.sequence_parallel:
            raise NotImplementedError(
                "the KV-cached serving path runs tp=1, as the "
                "reference's does; got tp="
                f"{cfg.tensor_model_parallel_size}, sequence_parallel="
                f"{cfg.sequence_parallel}")

    def _prefill_kv(self, tokens, prompt_len, last_logit_only: bool):
        """The prefill's causal forward over ``tokens (1, P)``: returns
        ``(logits, k, v, prompt_len)`` with every layer's K/V stacked
        ``(L, H, P, D)`` for the cache write."""
        b, P = tokens.shape
        if b != 1:
            raise ValueError(f"prefill is per-request: tokens must be "
                             f"(1, P), got {tuple(tokens.shape)}")
        if prompt_len is None:
            prompt_len = P
        # a cursor past the written window would make every later decode
        # read stale cache
        prompt_len = int(prompt_len)
        if not 0 < prompt_len <= P:
            raise ValueError(f"prompt_len {prompt_len} outside the written "
                             f"window (1, {P}]")
        x = self.embed(tokens)
        ks, vs = [], []
        for lp in self.layers:
            x, (k, v) = self._layer(lp, x, collect_kv=True)
            ks.append(k[0])
            vs.append(v[0])
        x = self._ln(self.final_ln, x)
        if last_logit_only:
            # the head is per-position: slice the hidden row first
            x = x[:, prompt_len - 1: prompt_len]
        return self.logits(x), torch.stack(ks), torch.stack(vs), prompt_len

    def _prefill_forward(self, tokens, cache, slot, prompt_len,
                         last_logit_only: bool = False):
        if tokens.shape[-1] > cache.max_len:
            raise ValueError(f"prompt window {tokens.shape[-1]} exceeds "
                             f"cache max_len {cache.max_len}")
        logits, k, v, prompt_len = self._prefill_kv(tokens, prompt_len,
                                                    last_logit_only)
        cache.write_prompt(k, v, slot, prompt_len)
        return logits, cache

    def _paged_prefill_forward(self, tokens, cache, block_row, prompt_len,
                               last_logit_only: bool = False):
        if tokens.shape[-1] % cache.block_size != 0:
            raise ValueError(f"paged prefill window {tokens.shape[-1]} must "
                             f"be a multiple of block_size "
                             f"{cache.block_size}")
        logits, k, v, _ = self._prefill_kv(tokens, prompt_len,
                                           last_logit_only)
        # null block_row entries absorb the padding
        cache.write_prompt_blocks(k, v, block_row)
        return logits, cache

    def _decode_embed(self, tokens, positions: torch.Tensor) -> torch.Tensor:
        """Word embedding of ``tokens (S, 1)`` plus the position embedding
        at ``positions (S,)``, clipped to the position table."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[1] != 1:
            raise ValueError(f"decode tokens must be (max_seqs, 1), got "
                             f"{tuple(tokens.shape)}")
        h = self.embedding.word(tokens)
        pos = self.embedding.position[
            positions.long().clamp(0, cfg.max_position_embeddings - 1)]
        return (h + pos[:, None]).to(cfg.compute_dtype)

    def _decode_layer(self, lp: _Layer, x: torch.Tensor, attend):
        """One layer of the decode step: ``x (S, 1, hidden)``; ``attend(q,
        k_new, v_new)`` is the cache read with the current token folded
        in, all ``(S, H, D)``. Returns ``(x, (k_new, v_new))``, appended by
        the caller after the stack (the cache is read-only inside it)."""
        h = self._ln(lp.ln1, x)
        qkv, _ = lp.qkv(h)                                  # (S, 1, 3*hidden)
        q, k_new, v_new = self._split_heads(qkv[:, 0])      # (S, H, D)
        ctx = attend(q, k_new, v_new)
        out, _ = lp.proj(ctx.reshape(ctx.shape[0], 1, -1))
        x = x + out
        x = x + self._mlp(lp, self._ln(lp.ln2, x))
        return x, (k_new, v_new)

    def _decode_stack(self, x: torch.Tensor, attend_layer):
        """The layer stack and head of a decode step; ``attend_layer(i)``
        gives layer ``i``'s ``attend``. Returns ``(logits (S, vocab),
        k_new, v_new)``, the new K/V stacked ``(L, S, H, D)``."""
        k_all, v_all = [], []
        for i, lp in enumerate(self.layers):
            x, (k_new, v_new) = self._decode_layer(lp, x, attend_layer(i))
            k_all.append(k_new)
            v_all.append(v_new)
        x = self._ln(self.final_ln, x)
        return self.logits(x)[:, 0], torch.stack(k_all), torch.stack(v_all)

    def _decode_forward(self, tokens, cache, active=None):
        x = self._decode_embed(tokens, cache.lengths)

        def attend_layer(i):
            ksc = cache.k_scale[i] if cache.quantized else None
            vsc = cache.v_scale[i] if cache.quantized else None
            return lambda q, k_new, v_new: decode_attention(
                q, cache.k[i], cache.v[i], cache.lengths, k_new=k_new,
                v_new=v_new, k_scale=ksc, v_scale=vsc,
                use_kernel=self.cfg.use_kernel)

        logits, k_new, v_new = self._decode_stack(x, attend_layer)
        # only `active` slots advance their cursor (see KVCache.append)
        cache.append(k_new, v_new, active)
        return logits, cache

    def _paged_decode_forward(self, tokens, cache, block_tables, lengths,
                              block_ids, offsets, cow_src=None,
                              cow_dst=None):
        if block_tables is None or lengths is None or block_ids is None \
                or offsets is None:
            raise ValueError("paged decode needs block_tables, lengths, "
                             "append_block_ids and append_offsets")
        dev = cache.k.device
        tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                 device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        # copy-on-write first: a pending shared block becomes private
        # before this step reads or writes it
        if cow_src is not None:
            cache.cow_copy(cow_src, cow_dst)
        x = self._decode_embed(tokens, lengths)

        def attend_layer(i):
            ksc = cache.k_scale[i] if cache.quantized else None
            vsc = cache.v_scale[i] if cache.quantized else None
            return lambda q, k_new, v_new: paged_decode_attention(
                q, cache.k[i], cache.v[i], tables, lengths, k_new=k_new,
                v_new=v_new, k_scale=ksc, v_scale=vsc,
                use_kernel=self.cfg.use_kernel)

        logits, k_new, v_new = self._decode_stack(x, attend_layer)
        cache.append(k_new, v_new, block_ids, offsets)
        return logits, cache

    # -- serving: speculative k-token verify --------------------------------

    def _verify_embed(self, tokens, lengths: torch.Tensor) -> torch.Tensor:
        """Word embedding of ``tokens (S, Q)`` plus the position embedding
        at ``lengths + [0, Q)``, clipped to the position table: row i sits
        where sequential decode step i would have put it."""
        cfg = self.cfg
        positions = (lengths.long()[:, None]
                     + torch.arange(tokens.shape[1], device=lengths.device))
        pos = self.embedding.position[
            positions.clamp(0, cfg.max_position_embeddings - 1)]
        return (self.embedding.word(tokens) + pos).to(cfg.compute_dtype)

    def _verify_layer(self, lp: _Layer, x: torch.Tensor, attend):
        """One layer of the verify step: ``x (S, Q, hidden)``, the last
        accepted token and the drafts; ``attend(q, k_new, v_new)``, all
        ``(S, H, Q, D)``, is the cache read with the in-flight rows merged
        causally. Returns ``(x, (k_new, v_new))``."""
        h = self._ln(lp.ln1, x)
        qkv, _ = lp.qkv(h)                                  # (S, Q, 3*hidden)
        q, k_new, v_new = (t.transpose(1, 2)
                           for t in self._split_heads(qkv))  # (S, H, Q, D)
        ctx = attend(q, k_new, v_new)
        S, _, Q, _ = ctx.shape
        out, _ = lp.proj(ctx.transpose(1, 2).reshape(S, Q, -1))
        x = x + out
        x = x + self._mlp(lp, self._ln(lp.ln2, x))
        return x, (k_new, v_new)

    def verify_forward(self, tokens: torch.Tensor, kv_cache,
                       block_tables=None, lengths=None, cow_src=None,
                       cow_dst=None):
        """Speculative verify: score ``tokens (max_seqs, Q)``, each slot's
        last accepted token and its ``Q - 1`` drafts, in one pass over the
        cached prefix (a decode kernel launch a layer at ``q_len = Q``).
        Causality among the Q rows is the exact merge inside the decode
        op, fed the cache's store-and-load images of the earlier rows, so
        the numerics follow Q sequential steps. Returns ``(logits (S, Q,
        vocab), (k_new, v_new) (L, S, H, Q, D), cache)``; the window is
        not appended (the engine appends after deciding the accepted
        counts). A dense cache reads ``kv_cache.lengths``; a paged one
        takes the host's tables and cursors, as the decode leg, and
        copies the copy-on-write pairs first."""
        self._require_cacheable()
        if tokens.dim() != 2:
            raise ValueError(f"verify tokens must be (max_seqs, Q), got "
                             f"{tuple(tokens.shape)}")
        cache = kv_cache
        paged = isinstance(cache, PagedKVCache)
        if paged:
            if block_tables is None or lengths is None:
                raise ValueError("paged verify needs block_tables and "
                                 "lengths")
            dev = cache.k.device
            tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                     device=dev)
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=dev)
            # copy-on-write first, as in the decode leg
            if cow_src is not None:
                cache.cow_copy(cow_src, cow_dst)
        else:
            lengths = cache.lengths
        x = self._verify_embed(tokens, lengths)
        store = cache.k.dtype

        def attend_layer(i):
            ksc = cache.k_scale[i] if cache.quantized else None
            vsc = cache.v_scale[i] if cache.quantized else None

            def attend(q, k_new, v_new):
                kw = dict(k_new=k_new, v_new=v_new, k_scale=ksc,
                          v_scale=vsc, use_kernel=self.cfg.use_kernel,
                          k_cast=store_roundtrip(k_new, store,
                                                 cache.quantized),
                          v_cast=store_roundtrip(v_new, store,
                                                 cache.quantized))
                if paged:
                    return paged_decode_attention(
                        q, cache.k[i], cache.v[i], tables, lengths, **kw)
                return decode_attention(q, cache.k[i], cache.v[i], lengths,
                                        **kw)
            return attend

        k_all, v_all = [], []
        for i, lp in enumerate(self.layers):
            x, (k_new, v_new) = self._verify_layer(lp, x, attend_layer(i))
            k_all.append(k_new)
            v_all.append(v_new)
        x = self._ln(self.final_ln, x)
        return (self.logits(x), (torch.stack(k_all), torch.stack(v_all)),
                cache)
