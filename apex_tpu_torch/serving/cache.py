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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["KVCache", "cache_bytes_per_slot", "store_roundtrip"]

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

    def _store(self, x: torch.Tensor):
        """(value to store, scale or None) in the cache dtype."""
        if self.quantized:
            return _quantize(x)
        return x.to(self.k.dtype), None

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
