"""KV cache for the serving fast path.

Counterpart of the dense ``KVCache`` in ``apex_tpu/serving/cache.py``: one
preallocated buffer pair per layer stack, ``k``/``v`` shaped
``(num_layers, max_seqs, num_heads, max_len, head_dim)``, plus a per-slot
int32 write cursor ``lengths (max_seqs,)``. Each ``(slot, head)``'s
positions are contiguous along ``max_len``, the stripe the decode kernel
reads up to the cursor; admission, retirement and ragged lengths are all
expressed through the cursor, never through shapes.

``dtype=torch.int8`` stores the cache quantized with per-(position, head)
fp32 scales ``(L, S, H, T)``: symmetric absmax over the head dim, computed
when each token is written.

Writes are in place (slice assignment and ``index_put_`` on the
preallocated buffers): the port's counterpart of the reference's donated
cache buffers, so a decode step allocates no cache memory. The methods
return ``self`` for parity with the reference's functional API.

**Paged layout** (the reference's paged section of the same module):
:class:`PagedKVCache` is a global block pool ``(L, num_blocks, H,
block_size, D)`` (plus pooled ``(L, num_blocks, H, block_size)`` scales
for int8). Which blocks a slot owns is host state in
:class:`BlockAllocator`, plain numpy: per-slot block tables and cursors,
refcounts, a chained SHA-256 prefix index for sharing prompt blocks, an
LRU of cached unowned blocks, and lazily resolved copy-on-write. Block 0
is the reserved null block: unmapped table entries and masked writes land
there, and nothing ever reads it below a cursor. The reference drops
out-of-range scatter ids on the device (``mode="drop"``); here every id
comes from the allocator, which asserts on the host that it lies in
``[0, num_blocks)``.

The speculative verify step appends a window of ``k + 1`` tokens a slot
with ``append_k`` (both layouts): every row that fits is written, the
cursor advances by the accepted count only, so the rejected rows sit above
it, where no read reaches them and the next window overwrites them.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["KVCache", "cache_bytes_per_slot", "store_roundtrip",
           "PagedKVCache", "BlockAllocator", "AdmitPlan", "StepPlan",
           "PoolExhausted", "paged_block_bytes", "NULL_BLOCK"]

# floor for the absmax quantization scale: keeps an all-zero row (e.g. a
# never-written slot) from producing 0/0 at dequantization
_MIN_SCALE = 1e-8


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head) dim: ``(..., D)`` ->
    ``(int8 (..., D), fp32 scale (...))``. ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, _MIN_SCALE)
    q = torch.round(xf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _store(x: torch.Tensor, dtype, quantized: bool):
    """(value to store, scale or None) in a cache of ``dtype``."""
    if quantized:
        return _quantize(x)
    return x.to(dtype), None


def store_roundtrip(x: torch.Tensor, cache_dtype,
                    quantized: bool) -> torch.Tensor:
    """What a later step reads back after the cache stored ``x``: a dtype
    cast, or int8 quantize plus fp32 dequantize."""
    if quantized:
        q, scale = _quantize(x)
        return q.float() * scale[..., None]
    return x.to(cache_dtype)


@dataclasses.dataclass
class KVCache:
    """See module docstring."""

    k: torch.Tensor                        # (L, S, H, T, D)
    v: torch.Tensor                        # (L, S, H, T, D)
    lengths: torch.Tensor                  # (S,) int32 write cursor
    k_scale: Optional[torch.Tensor] = None  # (L, S, H, T) fp32 iff int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def max_seqs(self) -> int:
        return self.k.shape[1]

    @property
    def num_heads(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @classmethod
    def create(cls, num_layers: int, max_seqs: int, num_heads: int,
               max_len: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda") -> "KVCache":
        """Zero-filled cache on ``device``. ``dtype=torch.int8`` enables
        the quantized layout (scales allocated alongside)."""
        dev = resolve_device(device)
        shape = (num_layers, max_seqs, num_heads, max_len, head_dim)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.zeros(shape, dtype=dtype, device=dev)
        lengths = torch.zeros(max_seqs, dtype=torch.int32, device=dev)
        if dtype == torch.int8:
            return cls(k, v, lengths,
                       torch.full(shape[:-1], _MIN_SCALE, device=dev),
                       torch.full(shape[:-1], _MIN_SCALE, device=dev))
        return cls(k, v, lengths)

    def nbytes(self) -> int:
        """Total cache bytes (the number capacity planning divides)."""
        return sum(t.numel() * t.element_size() for t in (
            self.k, self.v, self.lengths) + ((self.k_scale, self.v_scale)
                                             if self.quantized else ()))

    def _store(self, x: torch.Tensor):
        return _store(x, self.k.dtype, self.quantized)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> "KVCache":
        """Append one token to every slot at its own cursor, in place:
        ``k_new``/``v_new`` are ``(L, S, H, D)``. Only slots in ``active``
        (``(S,)`` bool, default all) advance their cursor; an idle slot
        writes at a frozen cursor, overwritten by its next prefill. A slot
        already at ``max_len`` writes nothing and stays saturated."""
        S, T = self.max_seqs, self.max_len
        pos = self.lengths.long().clamp(max=T - 1)
        writable = self.lengths < T
        slots = torch.arange(S, device=self.k.device)

        def put(buf, new):
            # (S, T, L, H[, D]) view of the buffer: one batched in-place
            # write of each slot's row at its cursor; saturated slots
            # write back the value already there
            view = buf.movedim((1, 3), (0, 1))
            new_s = new.movedim(1, 0)                  # (S, L, H[, D])
            mask = writable.view(S, *([1] * (new_s.dim() - 1)))
            view[slots, pos] = torch.where(mask, new_s, view[slots, pos])

        kq, ks = self._store(k_new)
        vq, vs = self._store(v_new)
        put(self.k, kq)
        put(self.v, vq)
        if self.quantized:
            put(self.k_scale, ks)
            put(self.v_scale, vs)
        advanced = torch.clamp(self.lengths + 1, max=T)
        if active is not None:
            active = torch.as_tensor(active, dtype=torch.bool,
                                     device=self.lengths.device)
            advanced = torch.where(active, advanced, self.lengths)
        self.lengths.copy_(advanced)
        return self

    def append_k(self, k_new: torch.Tensor, v_new: torch.Tensor,
                 counts: torch.Tensor) -> "KVCache":
        """Speculative verify append, in place: a window of ``K`` tokens a
        slot, ``k_new``/``v_new`` ``(L, S, H, K, D)`` (row i belongs at
        position ``cursor + i``), and each slot's cursor advanced by
        ``counts (S,)`` (accepted drafts + 1; 0 for an inactive slot),
        clamped to ``max_len``. Every row below ``max_len`` is written;
        near saturation the window slides back to ``[max_len - K,
        max_len)`` and its positions below the cursor are written back
        unchanged, so a slot at ``max_len`` writes nothing."""
        S, T = self.max_seqs, self.max_len
        K = k_new.shape[3]
        if K > T:
            raise ValueError(f"verify window {K} exceeds max_len {T}")
        dev = self.k.device
        lengths = self.lengths.long()
        start = lengths.clamp(max=T - K)
        # > 0 only near saturation: row r sits at window offset r + shift
        r = (torch.arange(K, device=dev)[None, :]
             - (lengths - start)[:, None])                      # (S, K)
        pos = start[:, None] + torch.arange(K, device=dev)[None, :]
        slots = torch.arange(S, device=dev)[:, None]
        keep = r >= 0
        rows = r.clamp(0, K - 1)

        def put(buf, new):
            # (S, T, L, H[, D]) view of the buffer and (S, K, L, H[, D]) of
            # the window: the old window is read before the write
            view = buf.movedim((1, 3), (0, 1))
            new_s = new.movedim((1, 3), (0, 1))[slots, rows]
            mask = keep.view(S, K, *([1] * (new_s.dim() - 2)))
            view[slots, pos] = torch.where(mask, new_s, view[slots, pos])

        kq, ks = self._store(k_new)
        vq, vs = self._store(v_new)
        put(self.k, kq)
        put(self.v, vq)
        if self.quantized:
            put(self.k_scale, ks)
            put(self.v_scale, vs)
        counts = torch.as_tensor(counts, device=self.lengths.device)
        self.lengths.copy_(torch.clamp(self.lengths + counts, max=T))
        return self

    def write_prompt(self, k_new: torch.Tensor, v_new: torch.Tensor,
                     slot: int, true_len: int) -> "KVCache":
        """Prefill write, in place: ``k_new``/``v_new`` are ``(L, H, P,
        D)`` for one slot; positions ``[0, P)`` are overwritten and the
        slot's cursor is set to ``true_len`` (<= P; right-padded prompts
        write their padding too, masked by the cursor from every read)."""
        slot = int(slot)
        P = k_new.shape[2]
        kq, ks = self._store(k_new)
        vq, vs = self._store(v_new)
        self.k[:, slot, :, :P] = kq
        self.v[:, slot, :, :P] = vq
        if self.quantized:
            self.k_scale[:, slot, :, :P] = ks
            self.v_scale[:, slot, :, :P] = vs
        self.lengths[slot] = int(true_len)
        return self


def cache_bytes_per_slot(num_layers: int, num_heads: int, max_len: int,
                         head_dim: int, dtype=torch.bfloat16) -> int:
    """Device bytes one sequence slot pins for its whole lifetime (k + v,
    plus the fp32 scales when int8)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_pos = 2 * num_layers * num_heads * head_dim * itemsize
    if dtype == torch.int8:
        per_pos += 2 * num_layers * num_heads * 4
    return per_pos * max_len


def paged_block_bytes(num_layers: int, num_heads: int, block_size: int,
                      head_dim: int, dtype=torch.bfloat16) -> int:
    """Device bytes of one pool block (k + v across all layers, plus the
    fp32 scales when int8): the unit of the paged capacity math."""
    return cache_bytes_per_slot(num_layers, num_heads, block_size, head_dim,
                                dtype)


# ---------------------------------------------------------------------------
# paged layout: the device-side block pool
# ---------------------------------------------------------------------------

# the reserved null block: table entry 0 means "unmapped", and every masked
# write (inactive slot, saturated slot, prompt padding past the last real
# block) lands in it; the allocator never hands it out
NULL_BLOCK = 0


def _ids(ids, device) -> torch.Tensor:
    """Block ids or offsets (a list, numpy array or tensor) as int64 on
    ``device``."""
    return torch.as_tensor(ids, dtype=torch.long, device=device)


@dataclasses.dataclass
class PagedKVCache:
    """The paged serving cache: a global block pool (see the module
    docstring). Per-slot block tables and cursors are host state
    (:class:`BlockAllocator`), passed to the model as plain arguments."""

    k: torch.Tensor                         # (L, NB, H, block_size, D)
    v: torch.Tensor                         # (L, NB, H, block_size, D)
    k_scale: Optional[torch.Tensor] = None  # (L, NB, H, block_size) fp32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def num_heads(self) -> int:
        return self.k.shape[2]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    def _leaves(self):
        return (self.k, self.v) + ((self.k_scale, self.v_scale)
                                   if self.quantized else ())

    def nbytes(self) -> int:
        """Total pool bytes (the number the paged capacity math sizes)."""
        return sum(t.numel() * t.element_size() for t in self._leaves())

    @classmethod
    def create(cls, num_layers: int, num_blocks: int, num_heads: int,
               block_size: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        """Zero-filled pool on ``device``. ``num_blocks`` includes the
        reserved null block 0, so ``num_blocks - 1`` blocks are
        allocatable. ``dtype=torch.int8`` enables the quantized layout."""
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        dev = resolve_device(device)
        shape = (num_layers, num_blocks, num_heads, block_size, head_dim)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.zeros(shape, dtype=dtype, device=dev)
        if dtype == torch.int8:
            # two distinct scale buffers, each written in place
            return cls(k, v, torch.full(shape[:-1], _MIN_SCALE, device=dev),
                       torch.full(shape[:-1], _MIN_SCALE, device=dev))
        return cls(k, v)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor, block_ids,
               offsets) -> "PagedKVCache":
        """Append one token per slot, in place: ``k_new``/``v_new`` are
        ``(L, S, H, D)``; ``block_ids``/``offsets`` ``(S,)`` name the pool
        block and in-block position each slot writes (the host computes
        them; masked slots aim at the null block, where repeated writes
        land in any order)."""
        bid = _ids(block_ids, self.k.device)
        off = _ids(offsets, self.k.device)
        # two index tensors split by a slice: the indexed dims lead,
        # (S, L, H[, D])
        for buf, new in zip(self._leaves(), self._stored(k_new, v_new)):
            buf[:, bid, :, off] = new.transpose(0, 1)
        return self

    def append_k(self, k_new: torch.Tensor, v_new: torch.Tensor, block_ids,
                 offsets) -> "PagedKVCache":
        """Speculative verify append, in place: ``k_new``/``v_new`` are
        ``(L, S, H, K, D)`` and ``block_ids``/``offsets`` ``(S, K)`` name
        each token's pool block and in-block position
        (:meth:`BlockAllocator.verify_targets`: a window may cross a block
        edge). Masked tokens (inactive slots, positions past capacity) aim
        at the null block. Every row is written; the host cursor advances
        by the accepted count only (:meth:`BlockAllocator.advance_counts`),
        so the rejected rows sit above it in the slot's own blocks."""
        bid = _ids(block_ids, self.k.device).reshape(-1)
        off = _ids(offsets, self.k.device).reshape(-1)
        for buf, new in zip(self._leaves(), self._stored(k_new, v_new)):
            # (L, S, H, K[, D]) -> (S * K, L, H[, D]): two index tensors
            # split by a slice put the indexed dim first
            upd = new.movedim((1, 3), (0, 1))
            buf[:, bid, :, off] = upd.reshape(-1, *upd.shape[2:])
        return self

    def write_prompt_blocks(self, k_new: torch.Tensor, v_new: torch.Tensor,
                            block_row) -> "PagedKVCache":
        """Prefill write, in place: ``k_new``/``v_new`` are ``(L, H, P,
        D)`` for one slot, ``P`` a multiple of ``block_size``;
        ``block_row (P // block_size,)`` names the pool block of each
        prompt chunk (null entries absorb the padding past the last real
        block). Positions past the true prompt length hold padding, masked
        by the cursor from every read."""
        L, H, P, D = k_new.shape
        bs = self.block_size
        npb = P // bs
        if npb * bs != P:
            raise ValueError(f"prompt window {P} must be a multiple of "
                             f"block_size {bs}")
        row = _ids(block_row, self.k.device)
        for buf, new in zip(self._leaves(), self._stored(k_new, v_new)):
            # (L, H, P[, D]) -> (L, NPB, H, bs[, D])
            buf[:, row] = new.reshape(L, H, npb, bs, *new.shape[3:]
                                      ).transpose(1, 2)
        return self

    def cow_copy(self, src, dst) -> "PagedKVCache":
        """Copy-on-write, in place: pool block ``dst[i] <- src[i]`` in
        every layer, before the step's reads and append (the caller
        sequences it first). ``src == dst == 0`` is a no-op pair."""
        src = _ids(src, self.k.device)
        dst = _ids(dst, self.k.device)
        for buf in self._leaves():
            buf[:, dst] = buf[:, src]
        return self

    def scrub_null_block(self) -> "PagedKVCache":
        """Zero the null block (and set its scales to the floor), which
        every masked write lands in: a retirement restores the "reads as
        zeros" state there."""
        self.k[:, NULL_BLOCK].zero_()
        self.v[:, NULL_BLOCK].zero_()
        if self.quantized:
            self.k_scale[:, NULL_BLOCK].fill_(_MIN_SCALE)
            self.v_scale[:, NULL_BLOCK].fill_(_MIN_SCALE)
        return self

    def _stored(self, k_new, v_new):
        """The values to store, in :meth:`_leaves` order."""
        kq, ks = _store(k_new, self.k.dtype, self.quantized)
        vq, vs = _store(v_new, self.k.dtype, self.quantized)
        return (kq, vq) + ((ks, vs) if self.quantized else ())


# ---------------------------------------------------------------------------
# host-side block allocator: refcounts, prefix hashing, copy-on-write
# ---------------------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """No allocatable pool block (free list empty, nothing evictable)."""


@dataclasses.dataclass
class AdmitPlan:
    """What :meth:`BlockAllocator.admit` decided for one admission.

    ``shared_tokens > 0`` means a prefix hit: the first ``shared_tokens``
    positions are already in mapped (refcounted) shared blocks and the
    engine runs only ``suffix`` through the decode step. ``prefill=True``
    is the cold path: the full prefill into ``block_row``."""

    slot: int
    prompt_len: int
    prefill: bool
    block_row: List[int]        # prefill destinations (cold path only)
    shared_tokens: int = 0
    suffix: Tuple[int, ...] = ()
    cow_pending: bool = False   # the last shared block awaits COW


@dataclasses.dataclass
class StepPlan:
    """Per-decode-step arguments from :meth:`BlockAllocator.prepare_step`:
    the COW copy pairs (null pairs where nothing is pending) and the slots
    that could not be given a block to write (pool exhausted), which the
    scheduler retires."""

    cow_src: np.ndarray         # (S,) int32
    cow_dst: np.ndarray         # (S,) int32
    failed: List[int]


class BlockAllocator:
    """Host-side bookkeeping for a :class:`PagedKVCache`: the free list,
    per-block refcounts, per-slot block tables and cursors, the chained
    prefix-hash index and lazily resolved copy-on-write. The reference's
    ``BlockAllocator``, behaviour for behaviour.

    Prefix sharing: a cold admission registers each full prompt block under
    a chained hash (block i's key digests block i-1's key and the chunk's
    tokens). A later admission walks the chain; hits map the shared blocks
    into its table (refcount + 1) and skip prefill for the shared span.
    Every index entry stores its exact token chunk, and a mismatch reads as
    a miss, so a digest collision never serves wrong KV. Retired blocks
    whose content is still registered park in an LRU of cached blocks
    (refcount 0) so that a later admission with the same prefix still
    hits; allocation pressure evicts them oldest first.

    Copy-on-write: when a hit covers the whole prompt, the admission maps
    the final shared block but must write its own KV into it (the last
    prompt position is decoded to sample the first token). The block is
    marked COW-pending, and the next :meth:`prepare_step` that finds the
    slot's cursor inside it allocates a private copy; the device copies
    before it writes."""

    def __init__(self, num_blocks: int, block_size: int,
                 blocks_per_slot: int, max_seqs: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.blocks_per_slot = int(blocks_per_slot)
        self.max_seqs = int(max_seqs)
        # LIFO free list; block 0 is the reserved null block
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.refcount = np.zeros(num_blocks, np.int32)
        self.refcount[NULL_BLOCK] = 1           # pinned forever
        self.tables = np.zeros((max_seqs, blocks_per_slot), np.int32)
        self.lengths = np.zeros(max_seqs, np.int32)
        # prefix index: chain digest -> (block, parent digest, chunk)
        self._index: Dict[bytes, Tuple[int, Optional[bytes],
                                       Tuple[int, ...]]] = {}
        self._block_key: Dict[int, bytes] = {}
        # refcount-0 blocks still registered: evictable LRU
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._cow_pending: Dict[int, int] = {}   # slot -> table index
        # monotonic counters the scheduler reads into serve/*
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    # -- capacity -----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Immediately allocatable blocks (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    @property
    def capacity_tokens(self) -> int:
        """Per-slot token capacity (the table width in tokens)."""
        return self.blocks_per_slot * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def _check_ids(self, *ids: np.ndarray) -> None:
        """Every id the device is given lies in the pool: the host-side
        counterpart of the reference's ``mode="drop"`` writes."""
        for a in ids:
            assert a.size == 0 or 0 <= a.min() <= a.max() < self.num_blocks, \
                f"block id outside [0, {self.num_blocks})"

    # -- low-level block lifecycle ------------------------------------------

    def _evict_one(self) -> int:
        block, _ = self._cached.popitem(last=False)   # oldest first
        self._unregister(block)
        return block

    def _take_block(self) -> int:
        if self._free:
            return self._free.pop()
        if self._cached:
            return self._evict_one()
        raise PoolExhausted(
            f"block pool exhausted: {self.num_blocks - 1} allocatable "
            "blocks all referenced")

    def _unregister(self, block: int) -> None:
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key, (None,))[0] == block:
            del self._index[key]

    def _release_block(self, block: int) -> None:
        if block == NULL_BLOCK:
            return
        self.refcount[block] -= 1
        if self.refcount[block] > 0:
            return
        if block in self._block_key:
            # content still registered: park it for prefix reuse
            self._cached[block] = None
        else:
            self._free.append(block)

    def _revive(self, block: int) -> None:
        """refcount 0 -> 1 on a cached (registered, unowned) block."""
        if self.refcount[block] == 0:
            self._cached.pop(block, None)
        self.refcount[block] += 1

    # -- prefix hashing ------------------------------------------------------

    @staticmethod
    def _digest(parent: Optional[bytes], chunk: Sequence[int]) -> bytes:
        h = hashlib.sha256(parent or b"")
        h.update(np.asarray(chunk, np.int64).tobytes())
        return h.digest()

    def _chain(self, prompt: Sequence[int]):
        """(digest, chunk) per full block of ``prompt``, chained."""
        bs = self.block_size
        out = []
        parent: Optional[bytes] = None
        for i in range(len(prompt) // bs):
            chunk = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            digest = self._digest(parent, chunk)
            out.append((digest, chunk))
            parent = digest
        return out

    def lookup(self, prompt: Sequence[int]) -> List[int]:
        """Longest verified chain of live shared blocks covering
        ``prompt``'s full-block prefix. Verification compares the stored
        token chunk, so a digest collision reads as a miss."""
        blocks: List[int] = []
        for digest, chunk in self._chain(prompt):
            entry = self._index.get(digest)
            if entry is None or entry[2] != chunk:
                break
            blocks.append(entry[0])
        return blocks

    # -- admission / registration / release ---------------------------------

    def admit(self, slot: int, prompt: Sequence[int],
              prefill_blocks: int, share: bool = True) -> AdmitPlan:
        """Map ``slot``'s table for ``prompt`` and return the plan.

        ``prefill_blocks`` is the engine's prompt window in blocks: the
        cold path allocates ``ceil(P / block_size)`` real blocks and pads
        the row with nulls. ``share=False`` forces the cold path even on a
        prefix hit. Raises :class:`PoolExhausted` when the blocks are not
        there, after rolling back every partial allocation."""
        P = len(prompt)
        if not 0 <= slot < self.max_seqs:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.max_seqs})")
        if P > self.capacity_tokens:
            raise ValueError(f"prompt length {P} exceeds the per-slot "
                             f"capacity {self.capacity_tokens}")
        if np.any(self.tables[slot] != NULL_BLOCK) or self.lengths[slot]:
            raise ValueError(f"slot {slot} still holds blocks: release "
                             "it before re-admitting")
        shared = self.lookup(prompt) if share else []
        if shared:
            n_shared = len(shared)
            covers_all = n_shared * self.block_size >= P
            # the last prompt position is this request's divergence point:
            # it is decoded (it samples the first token) and its KV
            # written, never shared
            shared_tokens = (P - 1 if covers_all
                             else n_shared * self.block_size)
            for b in shared:
                self._revive(b)
            self.tables[slot, :n_shared] = shared
            self.lengths[slot] = shared_tokens
            if covers_all:
                # the write at P-1 lands inside the final shared block:
                # copy-on-write, resolved at the next step
                self._cow_pending[slot] = n_shared - 1
            self.prefix_hits += 1
            self.prefix_hit_tokens += int(shared_tokens)
            return AdmitPlan(slot, P, prefill=False, block_row=[],
                             shared_tokens=int(shared_tokens),
                             suffix=tuple(int(t)
                                          for t in prompt[shared_tokens:]),
                             cow_pending=covers_all)
        # cold path: real blocks for the prompt, nulls for the padding
        n_real = self.blocks_for(P)
        row: List[int] = []
        try:
            for _ in range(n_real):
                row.append(self._take_block())
        except PoolExhausted:
            for b in row:
                self._free.append(b)
            raise
        for b in row:
            self.refcount[b] = 1
        self.tables[slot, :n_real] = row
        self.lengths[slot] = P
        block_row = row + [NULL_BLOCK] * (prefill_blocks - n_real)
        self._check_ids(np.asarray(block_row))
        return AdmitPlan(slot, P, prefill=True, block_row=block_row)

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> None:
        """After a cold prefill lands: index ``slot``'s full prompt blocks
        under their chain digests so that later admissions can share them.
        Existing registrations win; a block never registers under a second
        key."""
        for i, (digest, chunk) in enumerate(self._chain(prompt)):
            block = int(self.tables[slot, i])
            if block == NULL_BLOCK or block in self._block_key:
                continue
            if digest in self._index:
                continue
            self._index[digest] = (block, None, chunk)
            self._block_key[block] = digest

    def release(self, slot: int) -> None:
        """Retire ``slot``: every mapped block drops a reference
        (registered blocks park in the prefix cache at refcount 0, the
        others free at once); table and cursor zero."""
        for b in self.tables[slot]:
            self._release_block(int(b))
        self.tables[slot] = NULL_BLOCK
        self.lengths[slot] = 0
        self._cow_pending.pop(slot, None)

    # -- per-step device arguments ------------------------------------------

    def append_targets(self, active: np.ndarray):
        """``(block_ids, offsets)`` ``(S,)`` int32 for this step's append:
        each active slot writes at its cursor; inactive or saturated slots
        aim at the null block."""
        cur = self.lengths
        bidx = np.minimum(cur // self.block_size, self.blocks_per_slot - 1)
        bid = self.tables[np.arange(self.max_seqs), bidx].copy()
        ok = np.asarray(active, bool) & (cur < self.capacity_tokens)
        bid[~ok] = NULL_BLOCK
        self._check_ids(bid)
        return bid.astype(np.int32), (cur % self.block_size).astype(np.int32)

    def verify_targets(self, active: np.ndarray, k: int):
        """``(block_ids, offsets)`` ``(S, k)`` int32 for a k-token append:
        active slot ``s`` writes token ``i`` at ``cursor + i``, a window
        that may cross a block boundary. Inactive slots and positions past
        capacity aim at the null block. :meth:`prepare_verify` must have
        mapped the touched blocks first."""
        cur = self.lengths[:, None].astype(np.int64)
        pos = cur + np.arange(k)[None, :]                       # (S, k)
        bidx = np.minimum(pos // self.block_size, self.blocks_per_slot - 1)
        bid = np.take_along_axis(self.tables, bidx.astype(np.intp),
                                 axis=1).copy()
        ok = np.asarray(active, bool)[:, None] & \
            (pos < self.capacity_tokens)
        bid[~ok] = NULL_BLOCK
        self._check_ids(bid)
        return bid.astype(np.int32), (pos % self.block_size).astype(
            np.int32)

    def prepare_step(self, active_slots: Sequence[int]) -> StepPlan:
        """Make every active slot writable for one append: resolve a COW
        whose block the cursor is about to enter (allocate the private
        copy, swap the table entry, emit the copy pair) and allocate a
        fresh block where the cursor crossed into an unmapped entry. Slots
        the pool cannot serve land in ``failed``."""
        return self.prepare_verify(active_slots, 1)

    def prepare_verify(self, active_slots: Sequence[int],
                       k: int) -> StepPlan:
        """:meth:`prepare_step` for a k-token window ``[cursor, cursor +
        k)``: every block it touches is made slot-private and writable
        before the step (the cursor block's pending COW resolved, unmapped
        entries given fresh blocks). Atomic per slot: a slot the pool
        cannot fully serve rolls its partial grab back and lands in
        ``failed``."""
        cow_src = np.zeros(self.max_seqs, np.int32)
        cow_dst = np.zeros(self.max_seqs, np.int32)
        failed: List[int] = []
        for slot in active_slots:
            cur = int(self.lengths[slot])
            if cur >= self.capacity_tokens:
                failed.append(slot)
                continue
            first = cur // self.block_size
            last = min((cur + k - 1) // self.block_size,
                       self.blocks_per_slot - 1)
            pend = self._cow_pending.get(slot)
            if pend is not None and pend == first:
                old = int(self.tables[slot, first])
                try:
                    new = self._take_block()
                except PoolExhausted:
                    failed.append(slot)
                    continue
                self.refcount[new] = 1
                self.tables[slot, first] = new
                cow_src[slot] = old
                cow_dst[slot] = new
                # the device copies old -> new this step before any write;
                # the content survives in the other readers' mapping
                self._release_block(old)
                del self._cow_pending[slot]
                self.cow_copies += 1
            taken: List[int] = []
            short = False
            for bidx in range(first, last + 1):
                if self.tables[slot, bidx] != NULL_BLOCK:
                    continue
                try:
                    new = self._take_block()
                except PoolExhausted:
                    short = True
                    break
                self.refcount[new] = 1
                self.tables[slot, bidx] = new
                taken.append(bidx)
            if short:
                # atomic per slot: hand the partial grab back
                for bidx in taken:
                    b = int(self.tables[slot, bidx])
                    self.tables[slot, bidx] = NULL_BLOCK
                    self._release_block(b)
                failed.append(slot)
        self._check_ids(cow_src, cow_dst)
        return StepPlan(cow_src, cow_dst, failed)

    def advance(self, slots: Sequence[int]) -> None:
        """Cursor +1 for the slots whose append just landed."""
        for slot in slots:
            self.lengths[slot] = min(int(self.lengths[slot]) + 1,
                                     self.capacity_tokens)

    def advance_counts(self, slots: Sequence[int],
                       counts: Sequence[int]) -> None:
        """Cursor advance by each slot's accepted count (the speculative
        verify step's)."""
        for slot, n in zip(slots, counts):
            self.lengths[slot] = min(int(self.lengths[slot]) + int(n),
                                     self.capacity_tokens)
