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
backward kernels) and
:func:`~apex_tpu_torch.ops.flash_attention.decode_attention` in decode;
``GPTConfig.use_kernel`` is passed to both (``None``: the CUDA kernels on
the card, the plain versions on the CPU).

Training: every parameter is trainable, and :meth:`GPTModel.loss` is the
reference's LM loss (softmax cross-entropy with ``padding_idx=None``, mean
or masked mean). A ``torch.Generator`` passed to :meth:`GPTModel.forward`
or :meth:`GPTModel.loss` turns on train-mode dropout, the reference's
layout: embedding and hidden dropout at ``hidden_dropout``
(:func:`~apex_tpu_torch.ops.dropout.dropout`), and attention dropout at
``attention_dropout`` inside the flash kernels, seeded per layer by ints
drawn from the generator in ``[0, 2**31 - 1)``. The serving legs run
under ``torch.no_grad`` (:mod:`apex_tpu_torch.serving.engine`).

Out of scope for this slice: remat, sequence parallelism, tp > 1, the
paged and speculative legs and the pipeline split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.dropout import dropout
from apex_tpu_torch.ops.flash_attention import (decode_attention,
                                                flash_attention)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    init_method_normal)

__all__ = ["GPTConfig", "GPTModel"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Sizes follow the Megatron argument names, as in the reference."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
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

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


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
        self.ln1 = _Norm(h, dt, device)
        self.qkv = ColumnParallelLinear(h, 3 * h, init_method=init,
                                        params_dtype=dt, device=device)
        self.proj = RowParallelLinear(h, h, init_method=out_init,
                                      params_dtype=dt, device=device)
        self.ln2 = _Norm(h, dt, device)
        self.fc1 = ColumnParallelLinear(h, cfg.ffn, init_method=init,
                                        params_dtype=dt, device=device)
        self.fc2 = RowParallelLinear(cfg.ffn, h, init_method=out_init,
                                     params_dtype=dt, device=device)


class _Embedding(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        self.word = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            init_method=init_method_normal(cfg.init_method_std),
            params_dtype=cfg.params_dtype, device=device)
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

    def __init__(self, config: GPTConfig, device="cuda"):
        super().__init__()
        cfg = config
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError("hidden_size must divide num_attention_heads")
        dev = resolve_device(device)
        self.cfg = cfg
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
        return fused_layer_norm_affine(
            x, p.weight.to(x.dtype), p.bias.to(x.dtype),
            self.cfg.hidden_size, eps=self.cfg.layernorm_epsilon)

    def _split_heads(self, qkv: torch.Tensor):
        """``(..., 3*hidden)`` -> q, k, v ``(..., heads, head_dim)``. The
        layout is per-head interleaved: each head's ``[q|k|v]`` sits
        together, so the reshape comes before the split."""
        cfg = self.cfg
        qkv = qkv.reshape(*qkv.shape[:-1], cfg.num_attention_heads,
                          3 * cfg.head_dim)
        return qkv.split(cfg.head_dim, dim=-1)

    def _attention(self, lp: _Layer, x: torch.Tensor, attn_seed=None,
                   collect_kv: bool = False):
        b, s, _ = x.shape
        qkv, _ = lp.qkv(x)
        q, k, v = (t.transpose(1, 2) for t in self._split_heads(qkv))
        rate = self.cfg.attention_dropout if attn_seed is not None else 0.0
        ctx = flash_attention(q, k, v, causal=True,
                              use_kernel=self.cfg.use_kernel,
                              dropout_rate=rate, dropout_seed=attn_seed)
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        out, _ = lp.proj(ctx)
        if collect_kv:
            # prefill: the serving cache wants this layer's K/V
            return out, (k, v)
        return out

    def _mlp(self, lp: _Layer, x: torch.Tensor) -> torch.Tensor:
        h, _ = lp.fc1(x)
        h = F.gelu(h, approximate="tanh")
        out, _ = lp.fc2(h)
        return out

    def _layer(self, lp: _Layer, x: torch.Tensor, attn_seed=None,
               generator: Optional[torch.Generator] = None,
               collect_kv: bool = False):
        rate = self.cfg.hidden_dropout
        a = self._attention(lp, self._ln(lp.ln1, x), attn_seed,
                            collect_kv=collect_kv)
        if collect_kv:
            a, kv = a
        x = x + dropout(a, rate, generator)
        x = x + dropout(self._mlp(lp, self._ln(lp.ln2, x)), rate, generator)
        return (x, kv) if collect_kv else x

    # -- dense forward ------------------------------------------------------

    def embed(self, tokens: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Word plus position embedding, summed in fp32 and cast; with a
        ``generator``, embedding dropout at the hidden rate."""
        h = self.embedding.word(tokens)
        pos = self.embedding.position[: tokens.shape[1]]
        h = (h + pos).to(self.cfg.compute_dtype)
        return dropout(h, self.cfg.hidden_dropout, generator)

    def transform(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """The layer stack and the final LayerNorm. With a ``generator``
        and a non-zero dropout rate: train-mode dropout, one attention seed
        per layer drawn first (the reference's ``_layer_rngs``), then the
        hidden masks layer by layer."""
        cfg = self.cfg
        if cfg.hidden_dropout == 0.0 and cfg.attention_dropout == 0.0:
            generator = None
        seeds = [None] * len(self.layers)
        if generator is not None:
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.layers),),
                                  generator=generator,
                                  device=generator.device).tolist()
        for lp, seed in zip(self.layers, seeds):
            x = self._layer(lp, x, seed, generator)
        return self._ln(self.final_ln, x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output embedding: the word embedding cast to the
        activation dtype, products accumulated in fp32, fp32 logits."""
        w = self.embedding.word.weight.to(x.dtype)
        return torch.matmul(x.float(), w.float().t())

    def forward(self, tokens: torch.Tensor, kv_cache=None, slot=None,
                prompt_len=None, last_logit_only: bool = False,
                active: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
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

        The cache is updated in place (the port's counterpart of the
        reference's donated cache) and returned for API parity."""
        if kv_cache is None:
            return self.logits(self.transform(self.embed(tokens, generator),
                                              generator))
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
        A ``generator`` turns on train-mode dropout."""
        logits = self(tokens, generator=generator)
        per_tok = softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            padding_idx=None, half_to_float=True).reshape(targets.shape)
        if loss_mask is not None:
            mask = loss_mask.to(per_tok.dtype)
            return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return per_tok.mean()

    # -- serving: KV-cached prefill/decode ----------------------------------

    def _prefill_forward(self, tokens, cache, slot, prompt_len,
                         last_logit_only: bool = False):
        b, P = tokens.shape
        if b != 1:
            raise ValueError(f"prefill is per-request: tokens must be "
                             f"(1, P), got {tuple(tokens.shape)}")
        if P > cache.max_len:
            raise ValueError(f"prompt window {P} exceeds cache max_len "
                             f"{cache.max_len}")
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
        logits = self.logits(x)
        cache.write_prompt(torch.stack(ks), torch.stack(vs), slot,
                           prompt_len)
        return logits, cache

    def _decode_layer(self, lp: _Layer, x: torch.Tensor, layer_cache,
                      lengths: torch.Tensor):
        """One layer of the decode step: ``x (S, 1, hidden)``,
        ``layer_cache`` this layer's ``(ck, cv, ksc, vsc)``. Returns
        ``(x, (k_new, v_new))`` with the new token's K/V ``(S, H, D)``,
        appended by the caller after the stack (the cache is read-only
        inside it)."""
        h = self._ln(lp.ln1, x)
        qkv, _ = lp.qkv(h)                                  # (S, 1, 3*hidden)
        q, k_new, v_new = self._split_heads(qkv[:, 0])      # (S, H, D)
        ck, cv, ksc, vsc = layer_cache
        ctx = decode_attention(q, ck, cv, lengths, k_new=k_new, v_new=v_new,
                               k_scale=ksc, v_scale=vsc,
                               use_kernel=self.cfg.use_kernel)
        out, _ = lp.proj(ctx.reshape(ctx.shape[0], 1, -1))
        x = x + out
        x = x + self._mlp(lp, self._ln(lp.ln2, x))
        return x, (k_new, v_new)

    def _decode_forward(self, tokens, cache, active=None):
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[1] != 1:
            raise ValueError(f"decode tokens must be (max_seqs, 1), got "
                             f"{tuple(tokens.shape)}")
        h = self.embedding.word(tokens)
        pos = self.embedding.position[
            cache.lengths.long().clamp(0, cfg.max_position_embeddings - 1)]
        x = (h + pos[:, None]).to(cfg.compute_dtype)
        k_all, v_all = [], []
        for i, lp in enumerate(self.layers):
            layer_cache = (cache.k[i], cache.v[i],
                           cache.k_scale[i] if cache.quantized else None,
                           cache.v_scale[i] if cache.quantized else None)
            x, (k_new, v_new) = self._decode_layer(lp, x, layer_cache,
                                                   cache.lengths)
            k_all.append(k_new)
            v_all.append(v_new)
        x = self._ln(self.final_ln, x)
        logits = self.logits(x)[:, 0]
        # only `active` slots advance their cursor (see KVCache.append)
        cache.append(torch.stack(k_all), torch.stack(v_all), active)
        return logits, cache
