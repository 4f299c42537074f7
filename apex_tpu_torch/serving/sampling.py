"""Token sampling for the serving steps.

Counterpart of ``sample_tokens`` in ``apex_tpu/serving/sampling.py``.
Per-slot temperature rides as a tensor, so one call serves any mix of
greedy and stochastic slots: greedy (temperature <= 1e-6) is the exact
argmax, selected per slot with a ``where``; otherwise the logits are
temperature-scaled and sampled by the Gumbel-max rule from an explicit
``torch.Generator`` (the same rule ``jax.random.categorical`` uses; the
two generators give different draws from one seed).
"""

from __future__ import annotations

import torch

__all__ = ["sample_tokens"]

_GREEDY_EPS = 1e-6


def _mask_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return logits


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
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(logits / safe_t + gumbel, dim=-1)
    return torch.where(temperature <= _GREEDY_EPS, greedy,
                       sampled).to(torch.int32)
