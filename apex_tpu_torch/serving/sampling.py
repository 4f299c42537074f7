"""Token sampling for the serving steps, and the speculative acceptance rule.

Counterpart of ``sample_tokens`` and ``verify_tokens`` in
``apex_tpu/serving/sampling.py``. Per-slot temperature rides as a tensor,
so one call serves any mix of greedy and stochastic slots: greedy
(temperature <= 1e-6) is the exact argmax, selected per slot with a
``where``; otherwise the logits are temperature-scaled and sampled by the
Gumbel-max rule from an explicit ``torch.Generator`` (the same rule
``jax.random.categorical`` uses; the two generators give different draws
from one seed).

:func:`verify_tokens` is the speculative verify step's acceptance rule:
greedy slots accept a draft iff it is the argmax, stochastic slots run
rejection sampling against the draft with the corrected residual, so the
emitted tokens follow the model's distribution exactly.
"""

from __future__ import annotations

import torch

__all__ = ["sample_tokens", "verify_tokens"]

_GREEDY_EPS = 1e-6


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return logits


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One Gumbel-max draw over the last dim of ``logits``: a
    ``torch.rand`` of ``logits``' shape from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """One next token per row of ``logits (S, vocab)``; ``temperature
    (S,)``; ``top_k > 0`` masks everything below the k-th logit first.
    ``generator`` lives on the logits' device. Returns ``(S,)`` int32."""
    logits = _mask_top_k(logits.float(), top_k)
    greedy = torch.argmax(logits, dim=-1)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    safe_t = torch.clamp_min(temperature, _GREEDY_EPS)[:, None]
    sampled = _categorical(logits / safe_t, generator)
    return torch.where(temperature <= _GREEDY_EPS, greedy,
                       sampled).to(torch.int32)


def verify_tokens(logits: torch.Tensor, drafts: torch.Tensor,
                  generator: torch.Generator, temperature: torch.Tensor,
                  top_k: int = 0):
    """Speculative verification over ``logits (S, Q, vocab)``, row i the
    model's next-token distribution after in-flight token i (the last
    accepted token at i == 0, then the ``Q - 1`` drafts), against
    ``drafts (S, Q - 1)``.

    Per slot, position i < Q - 1 proposes ``drafts[:, i]``:

    - greedy (``temperature <= 1e-6``): accept iff the draft is the
      argmax; the emitted token is the argmax either way;
    - stochastic: accept with probability ``P_i(draft)``; on rejection
      emit a draw from ``P_i`` with the draft's mass removed (the
      corrected residual), which makes the emitted token's marginal
      exactly ``P_i``. Temperature and ``top_k`` shape ``P_i`` as
      :func:`sample_tokens` does.

    Row Q - 1 is the bonus token, a :func:`sample_tokens` draw from the
    top-k-masked last row. Three draws from ``generator``, in the order of
    the reference's key split: the acceptance uniforms, the residual
    categorical, the bonus.

    Returns ``(tokens (S, Q) int32, accepted (S,) int32)``: slot ``s``
    emits ``tokens[s, :accepted[s] + 1]`` (``accepted`` is the length of
    the all-accept prefix). Callers gate inactive slots themselves."""
    S, Q, V = logits.shape
    dev = logits.device
    logits = _mask_top_k(logits.float(), top_k)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    drafts = torch.as_tensor(drafts, device=dev).long()
    greedy_slot = (temperature <= _GREEDY_EPS)[:, None]          # (S, 1)
    safe_t = torch.clamp_min(temperature, _GREEDY_EPS)[:, None, None]
    argmax = torch.argmax(logits, dim=-1)                        # (S, Q)

    head = (logits / safe_t)[:, :-1]                             # (S, Q-1, V)
    p_draft = torch.softmax(head, dim=-1).gather(
        -1, drafts[..., None])[..., 0]                           # (S, Q-1)
    u = torch.rand(drafts.shape, generator=generator, device=dev)
    accept = torch.where(greedy_slot, argmax[:, :-1] == drafts,
                         u < p_draft)
    # the corrected residual: the draft's mass removed, emitted only on a
    # rejection, so the marginal stays the model's
    vocab = torch.arange(V, device=dev)
    residual = torch.where(vocab == drafts[..., None], -torch.inf, head)
    res_tok = _categorical(residual, generator)
    head_tok = torch.where(greedy_slot, argmax[:, :-1],
                           torch.where(accept, drafts, res_tok))
    bonus = sample_tokens(logits[:, -1], generator, temperature, top_k=0)
    tokens = torch.cat([head_tok.to(torch.int32), bonus[:, None]], dim=1)
    accepted = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    return tokens, accepted.to(torch.int32)
