"""Prefill and decode steps over an in-place KV cache, dense or paged.

Counterpart of ``ServingEngine`` and ``PagedServingEngine`` in
``apex_tpu/serving/engine.py``. The engine owns the cache and the two
steps a serving process runs forever:

- **prefill**: one request's prompt, right-padded to ``(1, prefill_len)``,
  through the causal forward (the ``flash_fwd`` kernel on the card); its
  K/V are written into one cache slot and the first output token is
  sampled from the logits at the prompt's true last position;
- **decode**: one token for every slot ``(max_seqs, 1)`` through the
  ``decode_attention`` kernel; K/V appended at each slot's cursor, next
  tokens sampled.

:class:`PagedServingEngine` runs the same two steps over a global block
pool (:class:`~apex_tpu_torch.serving.cache.PagedKVCache`) whose host-side
bookkeeping is a :class:`~apex_tpu_torch.serving.cache.BlockAllocator`:
decode attention through block tables (the ``paged_decode_attention``
kernel on the card), prefix sharing with copy-on-write, and admission
that the pool's free blocks bound.

With ``speculate_k = k > 0`` both engines also run **verify**: each
slot's last token and ``k`` drafted tokens ``(max_seqs, k + 1)`` in one
pass over the cached prefix (the decode kernels at ``q_len = k + 1``), the
acceptance rule (:func:`~apex_tpu_torch.serving.sampling.verify_tokens`)
and a ``k + 1``-token cache append; each slot emits 1 to ``k + 1`` tokens.

With ``quarantine=True`` both engines check each step's sampling-path
logits: ``poison`` (``(max_seqs,)`` fp32, zeros by default; NaN for a slot
is the deterministic fault injection) is added to them, ``finite =
all(isfinite(logits))`` a slot is computed on the device and comes back in
the step's one host copy beside the tokens, and :attr:`last_finite` holds
it. The scheduler retires a non-finite slot alone. With
``quarantine=False`` the steps are exactly the plain ones.

The JAX engines compile their steps ahead of time and donate the cache.
These run eagerly and write the cache in place (see
:mod:`apex_tpu_torch.serving.cache`). The paged engine's ``mean_context``
(it only priced the TPU kernel's cost estimate) has no counterpart.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.serving.cache import (AdmitPlan, BlockAllocator, KVCache,
                                          PagedKVCache, cache_bytes_per_slot,
                                          paged_block_bytes)
from apex_tpu_torch.serving.sampling import sample_tokens, verify_tokens

__all__ = ["ServingEngine", "PagedServingEngine"]


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
      quarantine: add the poison argument and the per-slot finite check
        to :meth:`decode` and :meth:`verify` (module docstring).
      speculate_k: drafts a :meth:`verify` step scores a slot (0: no
        verify step); ``speculate_k + 1 <= max_len``.
      device: where the cache and the steps live (default ``"cuda"``;
        raises when no card is present). The model is moved there.
    """

    def __init__(self, model, params: Optional[Mapping] = None, *,
                 max_seqs: int, max_len: int, prefill_len: int,
                 cache_dtype=torch.bfloat16, top_k: int = 0,
                 rng_seed: int = 0, quarantine: bool = False,
                 speculate_k: int = 0, device="cuda"):
        model._require_cacheable()
        cfg = model.cfg
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} exceeds max_len "
                             f"{max_len}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if speculate_k + 1 > max_len:
            raise ValueError(
                f"speculate_k {speculate_k} needs a {speculate_k + 1}-token "
                f"verify window, which exceeds max_len {max_len}")
        self.speculate_k = int(speculate_k)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        self.max_seqs = int(max_seqs)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.top_k = int(top_k)
        self.quarantine = bool(quarantine)
        self.last_finite: Optional[np.ndarray] = None
        self.swaps = 0
        self._overhead: Optional[int] = None
        self.cache = self._create_cache(cache_dtype)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(rng_seed))
        self._zero_poison = (torch.zeros(self.max_seqs, device=self.device)
                             if self.quarantine else None)

    def _create_cache(self, cache_dtype):
        cfg = self.model.cfg
        return KVCache.create(
            cfg.num_layers, self.max_seqs, cfg.num_attention_heads,
            self.max_len, cfg.head_dim, dtype=cache_dtype,
            device=self.device)

    # -- stepping -----------------------------------------------------------

    def _check_prompt(self, prompt: Sequence[int]) -> None:
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.prefill_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the prefill window "
                f"{self.prefill_len} (pick a larger prefill_len at engine "
                "construction)")

    def pad_prompt(self, prompt: Sequence[int]) -> torch.Tensor:
        self._check_prompt(prompt)
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

    def _poison(self, poison: Optional[np.ndarray]
                ) -> Optional[torch.Tensor]:
        """The step's poison vector on the device (None on a plain
        engine, which refuses one: the fault would be silently
        dropped)."""
        if not self.quarantine:
            if poison is not None:
                raise ValueError(
                    "poison injection requires a quarantine engine "
                    f"({type(self).__name__}(..., quarantine=True)); on a "
                    "plain engine the fault would be silently dropped")
            return None
        if poison is None:
            return self._zero_poison
        return torch.as_tensor(
            np.asarray(poison, np.float32).reshape(self.max_seqs),
            device=self.device)

    def decode(self, tokens: np.ndarray, temperatures: np.ndarray,
               active: Optional[np.ndarray] = None,
               poison: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step for every slot: returns the next token per
        slot. ``active`` (``(max_seqs,)`` bool, default all): slots outside
        it keep a frozen cursor, so free slots never grow a prefix.

        ``poison`` (quarantine engines only, ``(max_seqs,)`` fp32, default
        zeros) is added to each slot's logits before sampling; afterwards
        :attr:`last_finite` holds each slot's finite flag, fetched in the
        same copy as the tokens."""
        pvec = self._poison(poison)
        logits = self.decode_logits(tokens, active)
        temps = torch.as_tensor(np.asarray(temperatures, np.float32),
                                device=self.device)
        if pvec is None:
            toks = sample_tokens(logits, self.generator, temps, self.top_k)
            return toks.cpu().numpy()
        logits = logits + pvec[:, None]
        finite = torch.isfinite(logits).all(dim=-1)
        toks = sample_tokens(logits, self.generator, temps, self.top_k)
        toks, finite = self._fetch(toks[:, None], finite)
        self.last_finite = finite.astype(bool)
        return toks[:, 0]

    def _check_speculative(self) -> None:
        if not self.speculate_k:
            raise ValueError(
                "verify requires a speculative engine "
                f"({type(self).__name__}(..., speculate_k=k) with k > 0)")

    def _verify_inputs(self, tokens, drafts, temperatures, active):
        """The verify step's host inputs on the device: the window
        ``(max_seqs, k + 1)``, the drafts ``(max_seqs, k)``, the
        temperatures and the active mask. Copied before the step's first
        launch: a copy from pageable host memory waits for the stream, so
        one made after the launches would be a second sync."""
        S = self.max_seqs
        drafts = np.asarray(drafts, np.int64).reshape(S, self.speculate_k)
        window = np.concatenate(
            [np.asarray(tokens, np.int64).reshape(S, 1), drafts], axis=1)
        return tuple(torch.from_numpy(a).to(self.device) for a in (
            window, drafts, np.asarray(temperatures, np.float32).reshape(S),
            np.asarray(active, np.bool_).reshape(S)))

    def _accept(self, logits, drafts, temps, active, pvec):
        """The acceptance rule over the verify logits (``pvec`` added
        first on a quarantine engine), each slot's count (accepted drafts
        + 1; 0 outside ``active``) and, with ``pvec``, its finite flag
        over the whole window, on the device: ``(toks, counts)`` or
        ``(toks, counts, finite)``."""
        finite = ()
        if pvec is not None:
            logits = logits + pvec[:, None, None]
            finite = (torch.isfinite(logits).all(dim=(-2, -1)),)
        toks, accepted = verify_tokens(logits, drafts, self.generator, temps,
                                       self.top_k)
        return (toks, torch.where(active, accepted + 1, 0).to(torch.int32),
                *finite)

    @staticmethod
    def _fetch(toks, *columns):
        """``toks (S, n)`` and per-slot ``columns`` (counts, finite flags)
        on the host in one copy, the step's sync: ``(toks, *columns)`` as
        int32 numpy arrays."""
        host = torch.cat([toks] + [c[:, None].to(toks.dtype)
                                   for c in columns], dim=1).cpu().numpy()
        n = toks.shape[1]
        return (host[:, :n],) + tuple(host[:, n + i]
                                      for i in range(len(columns)))

    def _harvest(self, fetched):
        """Tokens and counts of a fetched verify step; the finite flags,
        where fetched, into :attr:`last_finite`."""
        if len(fetched) == 3:
            self.last_finite = fetched[2].astype(bool)
        return fetched[0], fetched[1]

    def verify(self, tokens: np.ndarray, drafts: np.ndarray,
               temperatures: np.ndarray,
               active: Optional[np.ndarray] = None,
               poison: Optional[np.ndarray] = None):
        """One speculative verify step for every slot: ``tokens
        (max_seqs,)`` each slot's last emitted token, ``drafts (max_seqs,
        speculate_k)`` the proposals after it. Returns ``(tokens
        (max_seqs, speculate_k + 1) int32, counts (max_seqs,) int32)``:
        slot ``s`` emits ``tokens[s, :counts[s]]`` (``counts`` is 0
        outside ``active``, else the accepted drafts + 1), and its cursor
        has advanced by exactly ``counts[s]``. The whole window is written;
        the rejected rows sit above the cursor, where no read reaches
        them. Requires ``speculate_k > 0`` at construction. ``poison``
        follows :meth:`decode`'s contract; :attr:`last_finite` then flags
        each slot's whole verify window."""
        self._check_speculative()
        pvec = self._poison(poison)
        if active is None:
            active = np.ones(self.max_seqs, np.bool_)
        window, drafts, temps, act = self._verify_inputs(
            tokens, drafts, temperatures, active)
        with torch.no_grad():
            logits, (k_new, v_new), _ = self.model.verify_forward(
                window, self.cache)
            out = self._accept(logits, drafts, temps, act, pvec)
            self.cache.append_k(k_new, v_new, out[1])
        return self._harvest(self._fetch(*out))

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

    def overhead_bytes(self) -> Optional[int]:
        """Device memory a decode step needs beside the cache (weights,
        logits, temporaries): the CUDA allocator's peak over one decode
        step with every slot inactive, less the cache's bytes. It counts
        every tensor the process holds on the card at that moment, so
        measure with nothing else resident. Measured once and kept. None
        on the CPU, which has no allocator statistics (the reference's
        answer when the backend reports no memory analysis)."""
        if self.device.type != "cuda":
            return None
        if self._overhead is None:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.decode_logits(np.zeros(self.max_seqs, np.int64),
                               np.zeros(self.max_seqs, np.bool_))
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            self._overhead = max(0, int(peak) - self.cache.nbytes())
        return self._overhead

    def suggest_max_seqs(self, hbm_bytes: int,
                         reserve_fraction: float = 0.1) -> int:
        """Sequence slots that fit ``hbm_bytes``: the step's non-cache
        footprint (:meth:`overhead_bytes`, or the parameters' bytes where
        it is None) and a ``reserve_fraction`` margin held back, the rest
        divided by the bytes of one slot's cache."""
        overhead = self.overhead_bytes()
        if overhead is None:
            overhead = sum(t.numel() * t.element_size()
                           for t in self.model.state_dict().values())
        avail = int(hbm_bytes * (1.0 - reserve_fraction)) - overhead
        return max(0, avail // self.bytes_per_slot())


class PagedServingEngine(ServingEngine):
    """The paged engine: the dense engine's call contract over a global
    block pool, so a slot holds ``ceil(context / block_size)`` blocks
    instead of ``max_len`` positions, and an admission whose prompt prefix
    is already pooled shares those blocks and skips their prefill
    (copy-on-write; ``serve/ttft_prefix_ms`` tracks it). Host state (block
    tables, cursors, refcounts, the prefix index) lives in
    :attr:`allocator`; it is copied to the device as plain arguments of
    each step.

    Args beyond :class:`ServingEngine`'s:
      num_blocks: pool size in blocks, including the reserved null block 0
        (``num_blocks - 1`` are allocatable). Size it with
        :meth:`suggest_pool_blocks`.
      block_size: tokens per block, any size >= 1; ``prefill_len`` must be
        a multiple of it (the prefill writes whole blocks).
      prefix_suffix_cap: the longest un-shared prompt tail (tokens) served
        through per-token decode steps on a prefix hit; a hit whose tail
        is longer takes the cold prefill. Default: ``block_size``.
    """

    def __init__(self, model, params: Optional[Mapping] = None, *,
                 max_seqs: int, max_len: int, prefill_len: int,
                 num_blocks: int, block_size: int,
                 cache_dtype=torch.bfloat16, top_k: int = 0,
                 rng_seed: int = 0, quarantine: bool = False,
                 prefix_suffix_cap: Optional[int] = None,
                 speculate_k: int = 0, device="cuda"):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if prefill_len % block_size != 0:
            raise ValueError(
                f"prefill_len {prefill_len} must be a multiple of "
                f"block_size {block_size} (the prefill writes whole pool "
                "blocks)")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.prefix_suffix_cap = int(block_size if prefix_suffix_cap
                                     is None else prefix_suffix_cap)
        self.last_admit: Optional[AdmitPlan] = None
        self.last_failed: list = []
        super().__init__(model, params, max_seqs=max_seqs, max_len=max_len,
                         prefill_len=prefill_len, cache_dtype=cache_dtype,
                         top_k=top_k, rng_seed=rng_seed,
                         quarantine=quarantine, speculate_k=speculate_k,
                         device=device)
        self.prefill_blocks = self.prefill_len // self.block_size
        self.allocator = BlockAllocator(
            self.num_blocks, self.block_size,
            -(-self.max_len // self.block_size), self.max_seqs)

    def _create_cache(self, cache_dtype):
        cfg = self.model.cfg
        return PagedKVCache.create(
            cfg.num_layers, self.num_blocks, cfg.num_attention_heads,
            self.block_size, cfg.head_dim, dtype=cache_dtype,
            device=self.device)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # a fresh host copy: the allocator mutates its arrays in place
        return torch.from_numpy(np.array(arr)).to(self.device)

    # -- admission ----------------------------------------------------------

    def can_admit(self, prompt: Sequence[int]) -> bool:
        """Whether the pool can take ``prompt`` now (conservative: assumes
        a cold admission; a prefix hit needs fewer blocks)."""
        return (self.allocator.free_blocks
                >= self.allocator.blocks_for(len(prompt)))

    def prefill_logits(self, prompt: Sequence[int],
                       slot: int) -> torch.Tensor:
        """Admit ``prompt`` into ``slot`` and return the logits at its last
        position, ``(vocab,)`` fp32. Two paths, chosen by the allocator's
        prefix index:

        - **cold**: allocate blocks, run the prefill into them, register
          the prompt's full blocks for later sharing;
        - **prefix hit** (tail within ``prefix_suffix_cap``): map the
          shared blocks, skip their prefill, and run only the un-shared
          tail through the decode step one token at a time, this slot
          alone active; the last step's logits are the result.

        Raises :class:`~apex_tpu_torch.serving.cache.PoolExhausted` when
        the blocks are not there (the scheduler queues on that). Sets
        :attr:`last_admit` to the allocator's plan."""
        self._check_slot(slot)
        self._check_prompt(prompt)
        prompt = [int(t) for t in prompt]
        shared = self.allocator.lookup(prompt)
        covered = min(len(shared) * self.block_size, len(prompt) - 1)
        share = bool(shared) and (len(prompt) - covered
                                  <= self.prefix_suffix_cap)
        plan = self.allocator.admit(slot, prompt, self.prefill_blocks,
                                    share=share)
        self.last_admit = plan
        if plan.prefill:
            with torch.no_grad():
                logits, _ = self.model.forward(
                    self.pad_prompt(prompt), kv_cache=self.cache,
                    block_row=plan.block_row, prompt_len=len(prompt),
                    last_logit_only=True)
            # index the freshly written full blocks for later admissions
            self.allocator.register_prefix(slot, prompt)
            return logits[0, 0]
        active = np.zeros(self.max_seqs, np.bool_)
        active[slot] = True
        tokens = np.zeros(self.max_seqs, np.int64)
        for t in plan.suffix:
            tokens[slot] = t
            logits = self.decode_logits(tokens, active)
        return logits[slot]

    # -- stepping -----------------------------------------------------------

    def decode_logits(self, tokens: np.ndarray,
                      active: Optional[np.ndarray] = None) -> torch.Tensor:
        """One decode step for every slot, ``(max_seqs, vocab)`` fp32
        logits. The block bookkeeping happens here: pending copy-on-writes
        are resolved (the device copies the block before it is read or
        written), cursors that crossed a block boundary get a fresh block,
        and slots the exhausted pool could not serve land in
        :attr:`last_failed`: their append goes to the null block and the
        scheduler retires them."""
        if active is None:
            active = np.ones(self.max_seqs, np.bool_)
        active = np.asarray(active, bool)
        alloc = self.allocator
        step = alloc.prepare_step(list(np.flatnonzero(active)))
        self.last_failed = list(step.failed)
        ok = active.copy()
        ok[step.failed] = False
        block_ids, offsets = alloc.append_targets(ok)
        pending = np.flatnonzero(step.cow_dst)
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device).reshape(self.max_seqs, 1)
        with torch.no_grad():
            logits, _ = self.model.forward(
                toks, kv_cache=self.cache,
                block_tables=self._to_device(alloc.tables),
                lengths=self._to_device(alloc.lengths),
                append_block_ids=self._to_device(block_ids),
                append_offsets=self._to_device(offsets),
                cow_src=(self._to_device(step.cow_src[pending])
                         if pending.size else None),
                cow_dst=(self._to_device(step.cow_dst[pending])
                         if pending.size else None))
        alloc.advance(list(np.flatnonzero(ok)))
        return logits

    def verify(self, tokens: np.ndarray, drafts: np.ndarray,
               temperatures: np.ndarray,
               active: Optional[np.ndarray] = None,
               poison: Optional[np.ndarray] = None):
        """The paged verify step, :meth:`ServingEngine.verify`'s contract.
        The block bookkeeping happens here: every block the ``speculate_k
        + 1``-token window touches is made slot-private and writable first
        (:meth:`~apex_tpu_torch.serving.cache.BlockAllocator
        .prepare_verify`: copy-on-write resolved, fresh blocks mapped,
        atomic per slot); slots the exhausted pool could not serve land in
        :attr:`last_failed`, their window aims at the null block and their
        count comes back 0; the host cursors advance by the counts."""
        self._check_speculative()
        pvec = self._poison(poison)
        if active is None:
            active = np.ones(self.max_seqs, np.bool_)
        active = np.asarray(active, bool)
        alloc = self.allocator
        step = alloc.prepare_verify(list(np.flatnonzero(active)),
                                    self.speculate_k + 1)
        self.last_failed = list(step.failed)
        ok = active.copy()
        ok[step.failed] = False
        pending = np.flatnonzero(step.cow_dst)
        # every host input on the device before the first launch (see
        # _verify_inputs)
        window, drafts, temps, act = self._verify_inputs(
            tokens, drafts, temperatures, ok)
        tables, lengths, block_ids, offsets = (
            self._to_device(a) for a in (
                alloc.tables, alloc.lengths,
                *alloc.verify_targets(ok, self.speculate_k + 1)))
        cow = ((self._to_device(step.cow_src[pending]),
                self._to_device(step.cow_dst[pending])) if pending.size
               else (None, None))
        with torch.no_grad():
            logits, (k_new, v_new), _ = self.model.verify_forward(
                window, self.cache, block_tables=tables, lengths=lengths,
                cow_src=cow[0], cow_dst=cow[1])
            out = self._accept(logits, drafts, temps, act, pvec)
            self.cache.append_k(k_new, v_new, block_ids, offsets)
        toks, counts = self._harvest(self._fetch(*out))
        slots = np.flatnonzero(ok)
        alloc.advance_counts(list(slots), counts[slots].tolist())
        return toks, counts

    def release_slot(self, slot: int) -> None:
        """Retire ``slot``: drop its block references on the host (shared
        blocks survive for their other readers and for the prefix cache)
        and scrub the null block on the device."""
        self._check_slot(slot)
        self.allocator.release(int(slot))
        with torch.no_grad():
            self.cache.scrub_null_block()

    # -- capacity -----------------------------------------------------------

    def block_bytes(self) -> int:
        cfg = self.model.cfg
        return paged_block_bytes(cfg.num_layers, cfg.num_attention_heads,
                                 self.block_size, cfg.head_dim,
                                 self.cache.k.dtype)

    def suggest_pool_blocks(self, hbm_bytes: int, mean_len: float,
                            reserve_fraction: float = 0.1) -> int:
        """Pool blocks that fit ``hbm_bytes``: a ``reserve_fraction``
        margin and the parameter bytes (the reference's estimate of the
        step's non-cache footprint where no memory analysis is at hand)
        held back, the rest divided by the bytes of one block. A pool of
        ``B`` blocks sustains about ``B * block_size / mean_len``
        sequences (:meth:`suggest_max_seqs_for_pool`)."""
        if mean_len <= 0:
            raise ValueError(f"mean_len must be positive, got {mean_len}")
        overhead = sum(t.numel() * t.element_size()
                       for t in self.model.state_dict().values())
        avail = int(hbm_bytes * (1.0 - reserve_fraction)) - overhead
        return max(0, avail // self.block_bytes())

    def suggest_max_seqs_for_pool(self, num_blocks: int,
                                  mean_len: float) -> int:
        """Concurrent sequences a ``num_blocks`` pool sustains at the
        observed ``mean_len``."""
        per_seq = max(1, -(-int(mean_len) // self.block_size))
        return max(0, (num_blocks - 1) // per_seq)
