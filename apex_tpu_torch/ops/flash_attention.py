"""Flash attention and KV-cache decode attention for the H100.

Counterpart of ``apex_tpu/ops/flash_attention.py``. Two hand-written CUDA
kernels (``apex_tpu_torch/csrc/``, built and launched by
:mod:`apex_tpu_torch._kernels`) replace the two Pallas kernels the serving
path runs:

- ``flash_fwd`` replaces ``_fwd_kernel``: blockwise online-softmax
  attention forward, returning the output and the per-row logsumexp
  (``+inf`` on fully masked rows);
- ``decode_attention`` replaces ``_decode_kernel``: ``q_len`` query rows
  per slot and head against a dense cache, masked by the per-slot write
  cursor, with optional int8 dequantization; it returns the output and the
  prefix logsumexp (``-inf`` on empty rows).

Beside each kernel sits its plain PyTorch version (:func:`_flash_fwd_plain`,
:func:`_decode_plain`), which takes the same inputs in the same layout.

Kernel selection follows the reference's ``use_pallas`` contract as
``use_kernel``: ``None`` runs the kernel iff the tensors lie on a CUDA
device, ``True`` on CPU tensors raises, ``False`` runs the plain version.
On CUDA there is no shape-based fallback: the kernels mask ragged lengths
themselves, and whatever they do not take (an additive bias, segment ids,
dropout, a head dim other than 64/128, inputs that require grad) raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch import _kernels

__all__ = ["flash_attention", "mha_reference", "decode_attention",
           "NEG_INF"]

NEG_INF = -1e30


def _use_kernel(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(
            "use_kernel=True needs CUDA tensors: the kernels run only on "
            f"the card, got a tensor on {x.device}")
    return bool(use_kernel)


def _norm_segment_ids(segment_ids, sq: int, sk: int):
    """Accept ``ids (b, s)`` (self-attention) or ``(q_ids, kv_ids)``."""
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        if sq != sk:
            raise ValueError(
                "cross-attention needs segment_ids=(q_ids, kv_ids)")
        q_ids = kv_ids = segment_ids
    if q_ids.shape[-1] != sq or kv_ids.shape[-1] != sk:
        raise ValueError(
            f"segment id lengths {q_ids.shape[-1]}/{kv_ids.shape[-1]} do "
            f"not match sequence lengths {sq}/{sk}")
    return q_ids, kv_ids


def mha_reference(q, k, v, bias=None, causal: bool = False,
                  softmax_scale: Optional[float] = None,
                  segment_ids=None, kv_length=None):
    """Plain attention over ``(b, h, s, d)``: the parity reference.

    ``kv_length`` ``(b,)`` masks key positions at or past each row's
    length (the KV-cache oracle). ``causal`` masks ``col > row + (sk -
    sq)``. Masked scores are ``NEG_INF``; rows with no valid key give
    exactly 0."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * softmax_scale
    if bias is not None:
        s = s + bias.float()
    if kv_length is not None:
        col = torch.arange(sk, device=s.device)
        lengths = kv_length.to(device=s.device, dtype=torch.int64)
        s = torch.where(col[None, None, None, :] < lengths[:, None, None, None],
                        s, NEG_INF)
    if segment_ids is not None:
        q_ids, kv_ids = _norm_segment_ids(segment_ids, sq, sk)
        same = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        s = torch.where(same, s, NEG_INF)
    if causal:
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(col > row + (sk - sq), NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    p = torch.where(s.amax(dim=-1, keepdim=True) <= NEG_INF, 0.0, p)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# flash forward: plain version and public API
# ---------------------------------------------------------------------------

def _flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """The function ``flash_fwd`` computes, on the kernel's layout:
    ``q (n, sq, d)``, ``k``/``v`` ``(n, sk, d)`` -> ``out (n, sq, d)`` in
    q's dtype and ``lse (n, sq)`` fp32, ``+inf`` on fully masked rows."""
    sq, sk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = None
    if causal:
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        valid = col <= row + (sk - sq)
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        # a fully masked row has m == NEG_INF and exp(s - m) == 1 on
        # every entry: zero the masked entries explicitly
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul((p / safe_l).to(v.dtype).float(), v.float())
    lse = torch.where(l == 0.0, math.inf, m + torch.log(safe_l))
    return out.to(q.dtype), lse[..., 0]


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None,
                    dropout_rate: float = 0.0,
                    segment_ids=None):
    """Fused attention over ``(b, h, s, d)`` tensors (inference only).

    On CUDA tensors this launches ``flash_fwd``; ``bias`` and
    ``segment_ids`` run only on the plain path in this slice and raise on
    the kernel path. Attention dropout raises on both: the counter-hash
    mask lands with the training slice."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout lands with the training slice")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    if not _use_kernel(use_kernel, q):
        return mha_reference(q, k, v, bias, causal, softmax_scale,
                             segment_ids=segment_ids)
    if bias is not None or segment_ids is not None:
        raise NotImplementedError(
            "the flash_fwd kernel takes no bias or segment_ids yet; they "
            "land with the training slice (pass use_kernel=False for the "
            "plain path)")
    out, _ = _kernels.flash_fwd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), causal, float(softmax_scale))
    return out.reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# decode attention: plain version, current-token merge and public API
# ---------------------------------------------------------------------------

def _dequant(x, scale):
    """int8 cache -> fp32 against per-(position, head) scales ``(..., T)``."""
    return x.float() * scale[..., None]


def _decode_plain(q, k, v, lengths, k_scale=None, v_scale=None,
                  softmax_scale: Optional[float] = None):
    """The function the ``decode_attention`` kernel computes, on its
    layout: ``q (n, q_len, d)``, ``k``/``v`` ``(n, T, d)``, ``lengths
    (n,)`` -> ``out (n, q_len, d)`` in q's dtype and ``lse (n, q_len)``
    fp32. Every q row attends the same prefix ``[0, lengths)``; empty rows
    give out 0 and lse ``-inf``."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    quantized = k.dtype == torch.int8
    kd = _dequant(k, k_scale) if quantized else k.float()
    vd = _dequant(v, v_scale) if quantized else v.float()
    s = torch.matmul(q.float(), kd.transpose(-1, -2)) * softmax_scale
    col = torch.arange(k.shape[-2], device=s.device)
    lengths = lengths.to(device=s.device, dtype=torch.int64)
    valid = col[None, None, :] < lengths[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p / safe_l, vd)
    lse = torch.where(lengths[:, None] <= 0, -math.inf,
                      (m + torch.log(safe_l))[..., 0])
    return out.to(q.dtype), lse


def _merge_current(out, lse, q, k_new, v_new, scale: float, out_dtype):
    """Exact two-way logsumexp merge of the cached-prefix attention
    ``(out, lse)`` with the current token's ``(k_new, v_new)``, all fp32;
    an empty prefix (lse == -inf) reduces to exactly ``v_new``."""
    s_new = (q.float() * k_new.float()).sum(dim=-1) * scale
    m = torch.maximum(lse, s_new)
    a_old = torch.exp(lse - m)
    a_new = torch.exp(s_new - m)
    merged = a_old[..., None] * out.float() + a_new[..., None] * v_new.float()
    return (merged / (a_old + a_new)[..., None]).to(out_dtype)


def decode_attention(q, k, v, lengths, k_new=None, v_new=None,
                     k_scale=None, v_scale=None,
                     softmax_scale: Optional[float] = None,
                     use_kernel: Optional[bool] = None):
    """Attention of ``q`` over a preallocated KV cache, masked by the
    per-slot write cursor.

    Args:
      q: ``(b, h, d)`` (one row per slot) or ``(b, h, q_len, d)``; every
        row attends the same cached prefix.
      k, v: ``(b, h, max_len, d)`` caches (bf16/fp32, or int8 with
        ``k_scale``/``v_scale``). Entries at or past ``lengths`` are
        never read.
      lengths: ``(b,)`` int, the number of valid cache positions.
      k_new, v_new: ``(b, h, d)``, the current token's key and value,
        folded in by :func:`_merge_current` (rank-3 ``q`` only; the
        rank-4 draft merge lands with the speculative slice).
      k_scale, v_scale: ``(b, h, max_len)`` fp32 dequantization scales.

    Returns ``q``'s shape in ``q.dtype``.
    """
    multi = q.dim() == 4
    if multi:
        b, h, q_len, d = q.shape
    else:
        b, h, d = q.shape
        q_len = 1
    T = k.shape[2]
    if tuple(k.shape) != (b, h, T, d) or tuple(v.shape) != (b, h, T, d):
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)} with max_len {T}")
    quantized = k.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 caches need k_scale/v_scale")
    if multi and k_new is not None:
        raise NotImplementedError(
            "the multi-row k_new merge (speculative verify) lands with the "
            "speculative slice")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    lengths_bh = lengths.to(device=k.device, dtype=torch.int32
                            ).repeat_interleave(h)
    q3 = q.reshape(b * h, q_len, d)
    k3 = k.reshape(b * h, T, d)
    v3 = v.reshape(b * h, T, d)
    ksc = k_scale.reshape(b * h, T) if quantized else None
    vsc = v_scale.reshape(b * h, T) if quantized else None
    if _use_kernel(use_kernel, q):
        out3, lse3 = _kernels.decode_attention(
            q3.contiguous(), k3, v3, lengths_bh, ksc, vsc,
            float(softmax_scale))
    else:
        out3, lse3 = _decode_plain(q3, k3, v3, lengths_bh, ksc, vsc,
                                   float(softmax_scale))
    out = out3.reshape(b, h, q_len, d)
    lse = lse3.reshape(b, h, q_len)
    if multi:
        return out
    out, lse = out[:, :, 0], lse[:, :, 0]
    if k_new is not None:
        out = _merge_current(out, lse, q, k_new, v_new,
                             float(softmax_scale), q.dtype)
    return out
