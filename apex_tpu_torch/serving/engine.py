"""Prefill and decode steps over an in-place KV cache.

Counterpart of the dense ``ServingEngine`` in ``apex_tpu/serving/engine.py``.
The engine owns the cache and the two steps a serving process runs
forever:

- **prefill**: one request's prompt, right-padded to ``(1, prefill_len)``,
  through the causal forward (the ``flash_fwd`` kernel on the card); its
  K/V are written into one cache slot and the first output token is
  sampled from the logits at the prompt's true last position;
- **decode**: one token for every slot ``(max_seqs, 1)`` through the
  ``decode_attention`` kernel; K/V appended at each slot's cursor, next
  tokens sampled.

The JAX engine compiles both steps ahead of time and donates the cache.
This one runs eagerly and writes the cache in place (see
:mod:`apex_tpu_torch.serving.cache`). ``quarantine``, ``speculate_k`` and
the paged engine come with later slices.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.cache import KVCache, cache_bytes_per_slot
from apex_tpu_torch.serving.sampling import sample_tokens

__all__ = ["ServingEngine"]


class ServingEngine:
    """See module docstring.

    Args:
      model: a :class:`~apex_tpu_torch.models.gpt.GPTModel` (tp=1).
      params: a state dict to load into ``model`` (e.g. from
        :func:`apex_tpu_torch._bridge.params_from_jax`), or None to serve
        the model's current parameters.
      max_seqs: concurrent sequence slots (the decode batch width).
      max_len: per-slot cache capacity in tokens (<= the model's
        ``max_position_embeddings``).
      prefill_len: the fixed prompt window; prompts are right-padded to it
        and longer prompts are rejected.
      cache_dtype: ``torch.bfloat16`` (default), ``torch.float32`` or
        ``torch.int8`` (quantized cache with per-(position, head) scales).
      top_k: top-k sampling cutoff (0 = full vocab).
      rng_seed: seed of the engine's sampling generator.
      device: where the cache and the steps live (default ``"cuda"``;
        raises when no card is present). The model is moved there.
    """

    def __init__(self, model, params: Optional[Mapping] = None, *,
                 max_seqs: int, max_len: int, prefill_len: int,
                 cache_dtype=torch.bfloat16, top_k: int = 0,
                 rng_seed: int = 0, device="cuda"):
        cfg = model.cfg
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} exceeds max_len "
                             f"{max_len}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.top_k = int(top_k)
        self.swaps = 0
        self.cache = KVCache.create(
            cfg.num_layers, self.max_seqs, cfg.num_attention_heads,
            self.max_len, cfg.head_dim, dtype=cache_dtype,
            device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(rng_seed))

    # -- stepping -----------------------------------------------------------

    def pad_prompt(self, prompt: Sequence[int]) -> torch.Tensor:
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.prefill_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the prefill window "
                f"{self.prefill_len} (pick a larger prefill_len at engine "
                "construction)")
        padded = np.zeros((1, self.prefill_len), np.int64)
        padded[0, : len(prompt)] = np.asarray(prompt, np.int64)
        return torch.from_numpy(padded).to(self.device)

    def _check_slot(self, slot: int) -> None:
        if not 0 <= int(slot) < self.max_seqs:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.max_seqs})")

    def prefill_logits(self, prompt: Sequence[int],
                       slot: int) -> torch.Tensor:
        """Admit ``prompt`` into ``slot`` and return the logits at its
        last position, ``(vocab,)`` fp32 (no sampling)."""
        self._check_slot(slot)
        with torch.no_grad():
            logits, _ = self.model.forward(
                self.pad_prompt(prompt), kv_cache=self.cache, slot=int(slot),
                prompt_len=len(prompt), last_logit_only=True)
        return logits[0, 0]

    def prefill(self, prompt: Sequence[int], slot: int,
                temperature: float = 0.0) -> int:
        """Admit ``prompt`` into ``slot`` and return the first sampled
        token (a host int)."""
        logits = self.prefill_logits(prompt, slot)
        temp = torch.tensor([temperature], dtype=torch.float32,
                            device=self.device)
        tok = sample_tokens(logits[None], self.generator, temp, self.top_k)
        return int(tok[0])

    def decode_logits(self, tokens: np.ndarray,
                      active: Optional[np.ndarray] = None) -> torch.Tensor:
        """One decode step for every slot; returns ``(max_seqs, vocab)``
        fp32 logits (no sampling). ``tokens (max_seqs,)`` are each slot's
        last token; slots outside ``active`` keep a frozen cursor."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device).reshape(self.max_seqs, 1)
        act = None if active is None else torch.as_tensor(
            np.asarray(active, np.bool_), device=self.device)
        with torch.no_grad():
            logits, _ = self.model.forward(toks, kv_cache=self.cache,
                                           active=act)
        return logits

    def decode(self, tokens: np.ndarray, temperatures: np.ndarray,
               active: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step for every slot: returns the next token per
        slot. ``active`` (``(max_seqs,)`` bool, default all): slots outside
        it keep a frozen cursor, so free slots never grow a prefix."""
        logits = self.decode_logits(tokens, active)
        temps = torch.as_tensor(np.asarray(temperatures, np.float32),
                                device=self.device)
        toks = sample_tokens(logits, self.generator, temps, self.top_k)
        return toks.cpu().numpy()

    def release_slot(self, slot: int) -> None:
        """Zero ``slot``'s write cursor: a retired slot stops paying
        attention over its dead prefix, and the cursor is the truth the
        next admission relies on."""
        self._check_slot(slot)
        self.cache.lengths[int(slot)] = 0

    # -- hot weight swap ----------------------------------------------------

    def swap_params(self, new_params: Mapping) -> None:
        """Copy ``new_params`` (a state dict with exactly the model's
        names, shapes and dtypes) into the served model in place.
        In-flight sequences keep their old-weight KV prefix."""
        own = self.model.state_dict()
        if set(own) != set(new_params):
            raise ValueError(
                "swap_params: parameter names differ from the served "
                f"model's (missing {sorted(set(own) - set(new_params))}, "
                f"unexpected {sorted(set(new_params) - set(own))})")
        for name, t in own.items():
            n = new_params[name]
            if tuple(n.shape) != tuple(t.shape) or n.dtype != t.dtype:
                raise ValueError(
                    f"swap_params: {name} is {tuple(n.shape)}/{n.dtype}, "
                    f"served as {tuple(t.shape)}/{t.dtype}")
        with torch.no_grad():
            for name, t in own.items():
                t.copy_(new_params[name])
        self.swaps += 1

    # -- capacity -----------------------------------------------------------

    def bytes_per_slot(self) -> int:
        cfg = self.model.cfg
        return cache_bytes_per_slot(cfg.num_layers, cfg.num_attention_heads,
                                    self.max_len, cfg.head_dim,
                                    self.cache.k.dtype)
