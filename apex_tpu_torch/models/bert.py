"""BERT for the port: the bidirectional encoder and its pretraining loss.

Counterpart of ``apex_tpu/models/bert.py`` (the reference's
``standalone_bert.py``): GPT's layer stack run without the causal mask,
with token-type embeddings, a pooler over ``[CLS]``, the masked-LM head
(dense, gelu, LayerNorm, the tied embedding and an output bias) and the
binary sentence-order head. Parameter names mirror the JAX pytree keys on
top of GPT's: ``embedding.tokentype``, ``pooler.{weight,bias}``,
``lm_head.dense.*``, ``lm_head.ln.*``, ``lm_head.bias`` (the reference's
``(tp, V/tp)`` layout is this rank's ``(vocab / tp,)`` shard here, see
:mod:`apex_tpu_torch._bridge`) and ``binary_head.*``.

A ``(b, s)`` attention mask (1 attend, 0 pad) becomes the fp32 score bias
``(b, 1, 1, s)``, ``-10000`` on padded keys, which every layer's
:func:`~apex_tpu_torch.ops.flash_attention.flash_attention` reads broadcast
inside the flash kernels on the card. Every LayerNorm, the MLM head's
included, runs the ``ln_fwd``/``ln_bwd`` kernels there. Numerics follow
GPT's (see :mod:`apex_tpu_torch.models.gpt`); the pooler and the heads
cast their fp32 parameters to the activation dtype before the product, as
the reference does.

At tp > 1 the encoder is GPT's tensor-parallel stack (this rank's heads,
sharded linears); the MLM head's dense and LayerNorm are replicated, its
logits are this rank's vocab shard plus the vocab-sharded output bias,
and the masked-LM loss is vocab-parallel cross-entropy. The pooler and
the binary head are replicated. Sequence parallelism is refused: the
reference's BERT adds the token types to the whole sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, _Norm
from apex_tpu_torch.ops.dropout import dropout
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    init_method_normal)

__all__ = ["BertConfig", "BertModel"]

# the reference draws the token types and the heads at a fixed std
_HEAD_STD = 0.02


@dataclasses.dataclass(frozen=True)
class BertConfig(GPTConfig):
    num_token_types: int = 2
    add_pooler: bool = True
    add_binary_head: bool = True  # sentence-order head, needs the pooler


class _Dense(nn.Module):
    """``x @ w.T + b`` with the fp32 parameters cast to ``x``'s dtype first
    (the reference's ``x @ w.astype(x.dtype).T + b.astype(x.dtype)``),
    products accumulated in fp32."""

    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dtype,
                                             device=device))

    def init(self, generator: torch.Generator) -> None:
        init_method_normal(_HEAD_STD)(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        out = torch.matmul(x.float(), w.float().t()).to(x.dtype)
        return out + self.bias.to(x.dtype)


class _LMHead(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.params_dtype
        self.dense = _Dense(h, h, dt, device)
        self.ln = _Norm(h, dt, device)
        self.bias = nn.Parameter(torch.zeros(
            cfg.vocab_size // cfg.tensor_model_parallel_size, dtype=dt,
            device=device))


class BertModel(GPTModel):
    """BERT as an ``nn.Module`` on ``device`` (default ``"cuda"``; raises
    when no card is present). Parameters are allocated, not initialized:
    call :meth:`init` or load a state dict
    (:func:`apex_tpu_torch._bridge.params_from_jax` takes the JAX
    ``BertModel.init`` pytree). ``model(tokens, token_types,
    attention_mask)`` returns the MLM logits; :meth:`loss` is the
    pretraining loss."""

    causal = False

    def __init__(self, config: BertConfig, device="cuda"):
        if config.sequence_parallel:
            raise ValueError("BertModel runs no sequence parallelism: its "
                             "token types are added to the whole sequence")
        super().__init__(config, device)
        cfg = config
        dev = resolve_device(device)
        h, dt = cfg.hidden_size, cfg.params_dtype
        self.embedding.tokentype = nn.Parameter(torch.empty(
            cfg.num_token_types, h, dtype=dt, device=dev))
        if cfg.add_pooler:
            self.pooler = _Dense(h, h, dt, dev)
        self.lm_head = _LMHead(cfg, dev)
        # the binary head reads the pooled [CLS], so it needs the pooler
        if cfg.add_binary_head and cfg.add_pooler:
            self.binary_head = _Dense(h, 2, dt, dev)

    def init(self, generator: torch.Generator) -> "BertModel":
        """GPT's init law, then N(0, 0.02) for the token types, the pooler
        and the heads' dense weights, zero biases, unit LayerNorm (the
        reference's law; draws from the CPU ``generator`` in a fixed
        order)."""
        super().init(generator)
        init_method_normal(_HEAD_STD)(self.embedding.tokentype, generator)
        heads = [self.lm_head.dense]
        if hasattr(self, "pooler"):
            heads.insert(0, self.pooler)
        if hasattr(self, "binary_head"):
            heads.append(self.binary_head)
        for head in heads:
            head.init(generator)
        self.lm_head.ln.init()
        with torch.no_grad():
            self.lm_head.bias.zero_()
        return self

    def encode(self, tokens: torch.Tensor,
               token_types: Optional[torch.Tensor] = None,
               attention_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Hidden states ``(b, s, hidden)`` after the final LayerNorm.
        ``attention_mask (b, s)``: 1 attend, 0 pad. A ``generator`` turns
        on train-mode dropout: embedding dropout over the full word,
        position and token-type sum, then GPT's per-layer dropout."""
        cfg = self.cfg
        h = self.embed(tokens)
        if token_types is not None:
            h = h + self.embedding.tokentype[token_types].to(h.dtype)
        if cfg.hidden_dropout == 0.0 and cfg.attention_dropout == 0.0:
            generator = None
        h = dropout(h, cfg.hidden_dropout, generator)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               -10000.0).float()
        return self.transform(h, generator, bias=bias)

    def pool(self, h: torch.Tensor) -> torch.Tensor:
        """tanh of the pooler's dense over the ``[CLS]`` position."""
        return torch.tanh(self.pooler(h[:, 0]))

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The MLM head: gelu(dense) -> LayerNorm -> tied-embedding
        logits (fp32) plus the output bias; at tp > 1 this rank's vocab
        shard."""
        head = self.lm_head
        t = F.gelu(head.dense(h), approximate="tanh")
        logits = self.logits(self._ln(head.ln, t))
        return logits + head.bias.to(logits.dtype)

    def forward(self, tokens: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.lm_logits(self.encode(tokens, token_types,
                                          attention_mask, generator))

    def loss(self, tokens: torch.Tensor, lm_labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             token_types: Optional[torch.Tensor] = None,
             attention_mask: Optional[torch.Tensor] = None,
             binary_labels: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The pretraining loss, an fp32 scalar: masked-LM cross-entropy
        over the ``loss_mask`` positions (all positions without one), plus,
        with ``binary_labels (b,)`` and a binary head, the sentence-order
        cross-entropy on the pooled ``[CLS]``."""
        h = self.encode(tokens, token_types, attention_mask, generator)
        lm_loss = self._lm_loss(
            self.lm_logits(h), lm_labels, loss_mask,
            vocab_parallel=self.cfg.tensor_model_parallel_size > 1)
        if binary_labels is None or not hasattr(self, "binary_head"):
            return lm_loss
        blogits = self.binary_head(self.pool(h)).float()
        return lm_loss + self._lm_loss(blogits, binary_labels, None)
