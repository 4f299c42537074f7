"""Flash attention and KV-cache decode attention for the H100.

Counterpart of ``apex_tpu/ops/flash_attention.py``. Four hand-written CUDA
kernels (``apex_tpu_torch/csrc/``, built and launched by
:mod:`apex_tpu_torch._kernels`) replace the Pallas kernels the serving and
training paths run:

- ``flash_fwd`` replaces ``_fwd_kernel``: blockwise online-softmax
  attention forward with optional in-kernel dropout, returning the output
  and the per-row logsumexp (``+inf`` on fully masked rows);
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``: the backward, probabilities recomputed from the
  saved logsumexp and the dropout mask regenerated from its counters;
- ``decode_attention`` replaces ``_decode_kernel``: ``q_len`` query rows
  per slot and head against a dense cache, masked by the per-slot write
  cursor, with optional int8 dequantization; it returns the output and the
  prefix logsumexp (``-inf`` on empty rows).

Beside each kernel sits its plain PyTorch version (:func:`_flash_fwd_plain`,
:func:`_flash_bwd_dq_plain`, :func:`_flash_bwd_dkv_plain`,
:func:`_decode_plain`), which takes the same inputs in the same layout.
:func:`flash_attention` is differentiable through :class:`_FlashAttention`,
the counterpart of the reference's ``custom_vjp`` (``_make_flash``): the
three flash kernels on the card, their plain versions on the CPU.

Attention dropout is the reference's counter hash (``_mix32``,
``_keep_mask``), bit for bit: :func:`dropout_keep_mask` gives the mask the
kernels generate, keyed only by the global ``(seed, batch-head, row, col)``.

Kernel selection follows the reference's ``use_pallas`` contract as
``use_kernel``: ``None`` runs the kernel iff the tensors lie on a CUDA
device, ``True`` on CPU tensors raises, ``False`` runs the plain version.
On CUDA there is no shape-based fallback: the kernels mask ragged lengths
themselves, and whatever they do not take (an additive bias, segment ids,
a head dim other than 64/128) raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch import _kernels

__all__ = ["flash_attention", "mha_reference", "decode_attention",
           "dropout_keep_mask", "NEG_INF"]

NEG_INF = -1e30

# murmur3 finalizer constants of the reference's counter hash
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_GOLD = 0x9E3779B1
_U32 = 0xFFFFFFFF


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


# ---------------------------------------------------------------------------
# counter-hash dropout: the plain twin of csrc/common.cuh's
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, split in 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_mix32`` on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def _keep_mask(seed: int, n: int, sq: int, sk: int, rate: float,
               device=None) -> torch.Tensor:
    """``(n, sq, sk)`` bool keep mask over flattened batch-heads ``0..n-1``:
    the reference's ``_keep_mask`` at global coordinates. ``seed`` is taken
    as its int32 bit pattern (what ``_pack_seed``/``_unpack_seed`` carry)."""
    seed = int(seed) & _U32
    row = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    inner = _mix32((_mul32(row, _GOLD) + col) & _U32)          # (sq, sk)
    bh = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix32(seed ^ _mix32(bh))[:, None, None]                # (n, 1, 1)
    x = _mix32((_mix32(h ^ inner) + _GOLD) & _U32)
    return (x >> 8) >= int(rate * (1 << 24))


def dropout_keep_mask(seed, b: int, h: int, sq: int, sk: int, rate: float,
                      device=None) -> torch.Tensor:
    """``(b, h, sq, sk)`` boolean keep mask, identical to what the kernels
    (and the reference's) generate for ``seed``."""
    return _keep_mask(seed, b * h, sq, sk, rate, device).reshape(b, h, sq, sk)


def mha_reference(q, k, v, bias=None, causal: bool = False,
                  softmax_scale: Optional[float] = None,
                  dropout_rate: float = 0.0, dropout_seed=None,
                  segment_ids=None, kv_length=None):
    """Plain attention over ``(b, h, s, d)``: the parity reference.

    ``kv_length`` ``(b,)`` masks key positions at or past each row's
    length (the KV-cache oracle). ``causal`` masks ``col > row + (sk -
    sq)``. Masked scores are ``NEG_INF``; rows with no valid key give
    exactly 0. With ``dropout_rate > 0`` the normalized probabilities take
    the kernels' keep mask for ``dropout_seed``, scaled by ``1 / (1 -
    rate)``."""
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
    if dropout_rate > 0.0:
        b, h = q.shape[:2]
        keep = dropout_keep_mask(dropout_seed, b, h, sq, sk, dropout_rate,
                                 device=s.device)
        p = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# flash forward and backward: plain versions on the kernels' layout
# ---------------------------------------------------------------------------

def _causal_valid(sq: int, sk: int, device) -> torch.Tensor:
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    return col <= row + (sk - sq)


def _flash_fwd_plain(q, k, v, causal: bool, scale: float,
                     dropout_rate: float = 0.0, seed=None):
    """The function ``flash_fwd`` computes, on the kernel's layout:
    ``q (n, sq, d)``, ``k``/``v`` ``(n, sk, d)`` -> ``out (n, sq, d)`` in
    q's dtype and ``lse (n, sq)`` fp32, ``+inf`` on fully masked rows. The
    normalizer sums the undropped probabilities; dropout then acts on the
    normalized ones."""
    n, sq, sk = q.shape[0], q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = None
    if causal:
        valid = _causal_valid(sq, sk, s.device)
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        # a fully masked row has m == NEG_INF and exp(s - m) == 1 on
        # every entry: zero the masked entries explicitly
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    p = p / safe_l
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, n, sq, sk, dropout_rate, s.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    lse = torch.where(l == 0.0, math.inf, m + torch.log(safe_l))
    return out.to(q.dtype), lse[..., 0]


def _recompute_p_ds(q, k, v, do, lse, delta, causal: bool, scale: float,
                    dropout_rate: float, seed):
    """The backward kernels' shared recompute (the reference's
    ``_recompute_p_ds``): ``p = exp(s - lse)`` with masked entries zeroed,
    ``p_eff`` (dropped, rescaled) for dV and ``ds = p * (dp_eff - delta)``
    with the undropped ``p``."""
    n, sq, sk = q.shape[0], q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    # lse = +inf on fully masked rows: exp(s - inf) == 0
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_valid(sq, sk, s.device), p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, n, sq, sk, dropout_rate, s.device)
        inv = 1.0 / (1.0 - dropout_rate)
        p_eff = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    return p_eff, p * (dp - delta[..., None])


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        dropout_rate: float = 0.0, seed=None):
    """The function ``flash_bwd_dq`` computes: ``dq (n, sq, d)`` in q's
    dtype, with ``ds`` rounded to k's dtype before the ``dS K`` product."""
    _, ds = _recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                            dropout_rate, seed)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                         scale: float, dropout_rate: float = 0.0, seed=None):
    """The function ``flash_bwd_dkv`` computes: ``(dk, dv)``, each ``(n,
    sk, d)`` in k's dtype, with ``p_eff`` rounded to do's dtype and ``ds``
    to q's before the products."""
    p_eff, ds = _recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                                dropout_rate, seed)
    dv = torch.matmul(p_eff.to(do.dtype).float().transpose(-1, -2),
                      do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the flash kernels, on the
    kernels' ``(n, s, d)`` layout: the forward saves ``q, k, v, out, lse``;
    the backward takes ``delta = rowsum(do * out)`` from the saved (rounded)
    output, in fp32 outside any kernel as the reference does, then runs dQ
    and dKV. ``use_kernel`` picks the kernels or their plain versions."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal: bool, scale: float,
                dropout_rate: float, seed, use_kernel: bool):
        fwd = _kernels.flash_fwd if use_kernel else _flash_fwd_plain
        out, lse = fwd(q3, k3, v3, causal, scale, dropout_rate, seed)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (causal, scale, dropout_rate, seed)
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, lse = ctx.saved_tensors
        do3 = do3.to(q3.dtype).contiguous()
        delta = (do3.float() * out.float()).sum(dim=-1)
        if ctx.use_kernel:
            dq = _kernels.flash_bwd_dq(q3, k3, v3, do3, lse, delta,
                                       *ctx.args)
            dk, dv = _kernels.flash_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                            *ctx.args)
        else:
            dq = _flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, *ctx.args)
            dk, dv = _flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta,
                                          *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None,
                    bias_requires_grad: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    segment_ids=None):
    """Fused attention over ``(b, h, s, d)`` tensors, differentiable.

    Without ``bias`` and ``segment_ids`` this is :class:`_FlashAttention`:
    the ``flash_fwd``/``flash_bwd_dq``/``flash_bwd_dkv`` kernels on CUDA
    tensors, their plain versions on the CPU (or with ``use_kernel=False``).
    ``dropout_rate``/``dropout_seed``: in-kernel attention dropout, keyed by
    the int seed (its int32 bit pattern); a rate without a seed raises.

    ``bias`` and ``segment_ids`` run on the plain path only in this slice
    (:func:`mha_reference`, autograd through plain ops) and raise on the
    kernel path: the learned-bias backward is the dbias kernel's (queue B6
    of ``ROADMAP.md``), segment ids come with the packed long-context path.
    As in the reference, ``bias`` gets zero gradient unless
    ``bias_requires_grad``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    if bias is not None or segment_ids is not None:
        if use_kernel or (use_kernel is None and q.is_cuda):
            raise NotImplementedError(
                "the flash kernels take no bias or segment_ids yet: the "
                "learned-bias backward is the dbias kernel's slice (ROADMAP "
                "queue B6) and segment ids come with the packed long-context "
                "path; pass use_kernel=False for the plain path")
        if bias is not None and not bias_requires_grad:
            bias = bias.detach()
        return mha_reference(q, k, v, bias, causal, softmax_scale,
                             dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed,
                             segment_ids=segment_ids)
    kernel = _use_kernel(use_kernel, q)
    seed = None if dropout_seed is None else int(dropout_seed)
    out = _FlashAttention.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), bool(causal),
        float(softmax_scale), float(dropout_rate), seed, kernel)
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
