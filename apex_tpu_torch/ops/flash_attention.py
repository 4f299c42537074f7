"""Flash attention and KV-cache decode attention for the H100.

Counterpart of ``apex_tpu/ops/flash_attention.py``. Six hand-written CUDA
kernels (``apex_tpu_torch/csrc/``, built and launched by
:mod:`apex_tpu_torch._kernels`) replace the Pallas kernels the serving and
training paths run:

- ``flash_fwd`` replaces ``_fwd_kernel``: blockwise online-softmax
  attention forward with an optional broadcast additive score bias,
  packed-sequence segment ids and in-kernel dropout, returning the output
  and the per-row logsumexp (``+inf`` on fully masked rows);
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``: the backward, probabilities recomputed from the
  saved logsumexp and the dropout mask regenerated from its counters;
- ``flash_dbias`` replaces ``_dbias_kernel``: a learned bias's gradient,
  the score cotangent summed over the bias's broadcast dims into a
  bias-shaped output (O(|bias|) memory, never the score matrix); for bf16
  inputs and a bias without query rows (``_kernels.dbias_folds``) that
  gradient is folded into ``flash_bwd_dkv``'s launch instead, which forms
  the same score cotangent for dK;
- ``decode_attention`` replaces ``_decode_kernel``: ``q_len`` query rows
  per slot and head against a dense cache, masked by the per-slot write
  cursor, with optional int8 dequantization, each slot-head's prefix split
  over several blocks whose partials merge in a fixed order; it returns the
  output and the prefix logsumexp (``-inf`` on empty rows);
- ``paged_decode_attention`` replaces ``_paged_decode_kernel``: the same
  over a global block pool, each slot's positions found through its block
  table (the paged serving engine's decode step).

The speculative verify step runs both decode kernels at ``q_len = k + 1``
rows a slot: every row attends the same cached prefix, and causality among
the in-flight rows is the exact logsumexp merge :func:`_merge_drafts`,
plain PyTorch outside the kernel, as the reference computes it outside
its Pallas kernel.

Beside each kernel sits its plain PyTorch version (:func:`_flash_fwd_plain`,
:func:`_flash_bwd_dq_plain`, :func:`_flash_bwd_dkv_plain`,
:func:`_flash_dbias_plain`, :func:`_decode_plain`,
:func:`_paged_decode_plain`), which takes the same inputs in the same
layout. :func:`flash_attention` is differentiable through
:class:`_FlashAttention`, the counterpart of the reference's
``custom_vjp`` (``_make_flash``): the four flash kernels on the card,
their plain versions on the CPU.

Attention dropout is the reference's counter hash (``_mix32``,
``_keep_mask``), bit for bit: :func:`dropout_keep_mask` gives the mask the
kernels generate, keyed only by the global ``(seed, batch-head, row, col)``.
Segment ids are compared as int32, exactly: the reference's Pallas path
carries them as fp32, which merges ids past 2**24, while its
``mha_reference`` compares them exactly, as the port does everywhere.

Kernel selection follows the reference's ``use_pallas`` contract as
``use_kernel``: ``None`` runs the kernel iff the tensors lie on a CUDA
device, ``True`` on CPU tensors raises, ``False`` runs the plain version.
On CUDA there is no shape-based fallback: the kernels mask ragged lengths
themselves, and whatever they do not take raises (the flash and decode
kernels take every head dim ``d % 8 == 0`` from 8 to 256, the reference's
rule up to the widest body that fits a block's shared memory).

Under a name-based remat policy (:mod:`apex_tpu_torch.remat`) the flash
forward is one op of the recorded layer, and with ``checkpoint_names`` it
tags its context ``flash_ctx`` and its logsumexp ``flash_lse``, so the
backward reads both and the forward kernel is not run again.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch._device import use_kernel_for
from apex_tpu_torch.remat import region_op, tag

__all__ = ["flash_attention", "mha_reference", "decode_attention",
           "paged_decode_attention", "dropout_keep_mask", "supports_flash",
           "supports_paged", "NEG_INF"]

NEG_INF = -1e30

# murmur3 finalizer constants of the reference's counter hash
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_GOLD = 0x9E3779B1
_U32 = 0xFFFFFFFF


_INT32 = (-2 ** 31, 2 ** 31 - 1)


def _int32_ids(ids, device) -> torch.Tensor:
    """Segment ids as a contiguous int32 tensor on ``device``. Ids outside
    int32, and float ids that are not whole numbers, raise."""
    ids = torch.as_tensor(ids, device=device)
    if ids.dtype == torch.int32:
        return ids.contiguous()
    if ids.dtype == torch.bool or ids.is_complex():
        raise ValueError(f"segment ids must be integers, got {ids.dtype}")
    if ids.numel():
        lo, hi = ids.min(), ids.max()
        if lo < _INT32[0] or hi > _INT32[1]:
            raise ValueError(
                f"segment ids in [{lo.item()}, {hi.item()}] lie outside "
                "int32")
        if ids.is_floating_point() and bool((ids != ids.round()).any()):
            raise ValueError("segment ids must be whole numbers")
    return ids.to(torch.int32).contiguous()


def supports_flash(sq: int, sk: int, d: int, block_q: int,
                   block_k: int) -> bool:
    """Whether the flash kernels take these shapes: any ``sq, sk >= 1``
    and every head dim ``d % 8 == 0`` from 8 to 256 (the kernels mask
    ragged lengths themselves, so the block sizes, which gate the
    reference's Pallas tiling, are accepted for its signature and do not
    matter)."""
    return (sq >= 1 and sk >= 1 and d % 8 == 0
            and 8 <= d <= _kernels._FLASH_MAX_D)


def supports_paged(block_size: int, d: int) -> bool:
    """Whether the paged decode kernel takes a pool of ``block_size``-token
    blocks at head dim ``d``: any ``block_size >= 1`` (the reference's
    ``block_size % 128 == 0`` is its Pallas tiling) and the head dims of
    :func:`~apex_tpu_torch._kernels.decode_dim_ok`."""
    return block_size >= 1 and _kernels.decode_dim_ok(d)


def _norm_segment_ids(segment_ids, sq: int, sk: int, device=None):
    """Accept ``ids (b, s)`` (self-attention) or ``(q_ids, kv_ids)``;
    returns both as int32 tensors on ``device`` (the ids' own without
    one)."""
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        if sq != sk:
            raise ValueError(
                "cross-attention needs segment_ids=(q_ids, kv_ids)")
        q_ids = kv_ids = segment_ids
    q_ids, kv_ids = (_int32_ids(x, device) for x in (q_ids, kv_ids))
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
        q_ids, kv_ids = _norm_segment_ids(segment_ids, sq, sk, s.device)
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


def _visible(n: int, sq: int, sk: int, causal: bool, segments, device):
    """The visible scores of ``n`` flattened batch-heads: a bool mask
    broadcastable to ``(n, sq, sk)``, or None when every score is. The
    causal mask (``col <= row + sk - sq``) and, with ``segments = (q_ids
    (b, sq), kv_ids (b, sk))`` int32, equal ids, batch ``bh // (n // b)``
    indexing the ids as the kernels index them."""
    valid = _causal_valid(sq, sk, device) if causal else None
    if segments is not None:
        q_ids, kv_ids = segments
        b = q_ids.shape[0]
        same = (q_ids[:, None, :, None] == kv_ids[:, None, None, :]).expand(
            b, n // b, sq, sk).reshape(n, sq, sk)
        valid = same if valid is None else same & valid
    return valid


def _tiles_meet(q_ids, kv_ids, tile: int = _kernels.ID_TILE) -> torch.Tensor:
    """``(b, ceil(sq / tile), ceil(sk / tile))`` bool: whether any id of a
    q tile can equal any id of a key tile, from the tiles' (min, max) id
    ranges (:func:`apex_tpu_torch._kernels.seg_tile_ranges`). Disjoint
    ranges mean no visible score, whatever the ids (monotone or not): the
    tensor-core kernels skip those pairs (``csrc/mma.cuh::tiles_meet``,
    the same predicate), an exact no-op."""
    q_rng = _kernels.seg_tile_ranges(q_ids, tile)
    kv_rng = _kernels.seg_tile_ranges(kv_ids, tile)
    return ((kv_rng[:, None, :, 1] >= q_rng[:, :, None, 0])
            & (kv_rng[:, None, :, 0] <= q_rng[:, :, None, 1]))


def _norm_bias(bias, b: int, h: int, sq: int, sk: int) -> torch.Tensor:
    """``bias`` broadcastable to ``(b, h, sq, sk)`` as the kernels take
    it, the reference's normalization: fp32, rank 4, each dim 1 or full, a
    keys dim of 1 expanded to ``sk``; the rest stays broadcast.
    Differentiable, so a gradient reaches the caller's bias."""
    bias4 = bias.float()
    if bias4.dim() > 4:
        raise ValueError(f"bias rank {bias4.dim()} > 4")
    while bias4.dim() < 4:
        bias4 = bias4[None]
    for ax, (dim, full) in enumerate(zip(bias4.shape, (b, h, sq, sk))):
        if dim not in (1, full):
            raise ValueError(f"bias dim {ax} is {dim}; must be 1 or {full}")
    if bias4.shape[3] == 1 and sk > 1:
        bias4 = bias4.expand(*bias4.shape[:3], sk)
    return bias4.contiguous()


def _bias_heads(bias, n: int) -> int:
    """How the kernels split a flattened batch-head index for the bias
    ``(bb, hb, sqb, sk)``: into ``(bh // heads, bh % heads)``."""
    bb, hb = bias.shape[:2]
    return hb if hb > 1 else (n // bb if bb > 1 else n)


def _add_bias(s: torch.Tensor, bias) -> torch.Tensor:
    """Scores ``s (n, sq, sk)`` over flattened batch-heads plus the
    broadcast bias ``(bb, hb, sqb, sk)`` (or ``s`` itself without one):
    the batch-head index splits as the kernels split it."""
    if bias is None:
        return s
    n = s.shape[0]
    heads = _bias_heads(bias, n)
    return (s.view(n // heads, heads, *s.shape[1:]) + bias).view(s.shape)


def _flash_fwd_plain(q, k, v, causal: bool, scale: float,
                     dropout_rate: float = 0.0, seed=None, bias=None,
                     segments=None):
    """The function ``flash_fwd`` computes, on the kernel's layout:
    ``q (n, sq, d)``, ``k``/``v`` ``(n, sk, d)``, the optional score bias
    (see :func:`_add_bias`) and segment ids (see :func:`_visible`) ->
    ``out (n, sq, d)`` in q's dtype and ``lse (n, sq)`` fp32, ``+inf`` on
    fully masked rows. The bias is added after the scale and before the
    masks. The normalizer sums the undropped probabilities; dropout then
    acts on the normalized ones."""
    n, sq, sk = q.shape[0], q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = _add_bias(s, bias)
    valid = _visible(n, sq, sk, causal, segments, s.device)
    if valid is not None:
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
                    dropout_rate: float, seed, bias=None, segments=None):
    """The backward kernels' shared recompute (the reference's
    ``_recompute_p_ds``): ``p = exp(s + bias - lse)`` with masked entries
    zeroed, ``p_eff`` (dropped, rescaled) for dV and ``ds = p * (dp_eff -
    delta)`` with the undropped ``p``."""
    n, sq, sk = q.shape[0], q.shape[-2], k.shape[-2]
    s = _add_bias(torch.matmul(q.float(), k.float().transpose(-1, -2))
                  * scale, bias)
    # lse = +inf on fully masked rows: exp(s - inf) == 0
    p = torch.exp(s - lse[..., None])
    valid = _visible(n, sq, sk, causal, segments, s.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, n, sq, sk, dropout_rate, s.device)
        inv = 1.0 / (1.0 - dropout_rate)
        p_eff = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    return p_eff, p * (dp - delta[..., None])


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        dropout_rate: float = 0.0, seed=None, bias=None,
                        segments=None):
    """The function ``flash_bwd_dq`` computes: ``dq (n, sq, d)`` in q's
    dtype, with ``ds`` rounded to k's dtype before the ``dS K`` product."""
    _, ds = _recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                            dropout_rate, seed, bias, segments)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                         scale: float, dropout_rate: float = 0.0, seed=None,
                         bias=None, segments=None):
    """The function ``flash_bwd_dkv`` computes: ``(dk, dv)``, each ``(n,
    sk, d)`` in k's dtype, with ``p_eff`` rounded to do's dtype and ``ds``
    to q's before the products."""
    p_eff, ds = _recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                                dropout_rate, seed, bias, segments)
    dv = torch.matmul(p_eff.to(do.dtype).float().transpose(-1, -2),
                      do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_dbias_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       dropout_rate: float = 0.0, seed=None, bias=None,
                       segments=None):
    """The function ``flash_dbias`` computes (the reference's
    ``_dbias_kernel``): the score cotangent ``ds`` of
    :func:`_recompute_p_ds`, unrounded fp32, summed over the broadcast dims
    of ``bias (bb, hb, sqb, sk)`` into a tensor of its shape, fp32."""
    if bias is None:
        raise ValueError("flash_dbias needs the bias whose gradient it is")
    _, ds = _recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                            dropout_rate, seed, bias, segments)
    n = ds.shape[0]
    heads = _bias_heads(bias, n)
    ds4 = ds.view(n // heads, heads, *ds.shape[1:])
    dims = [ax for ax in range(3)
            if bias.shape[ax] == 1 and ds4.shape[ax] > 1]
    return ds4.sum(dim=dims, keepdim=True) if dims else ds4


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the flash kernels, on the
    kernels' ``(n, s, d)`` layout: the forward saves ``q, k, v, out, lse``
    (with the score bias and the segment ids); the backward takes ``delta
    = rowsum(do * out)`` from the saved (rounded) output, in fp32 outside
    any kernel as the reference does, then runs dQ and dKV, and, for a
    learned bias (``need_dbias``), dbias: on the kernels folded into the
    dKV launch where ``_kernels.dbias_folds`` says so (bf16, a bias
    without query rows), else ``flash_dbias``. The bias ``(bb, hb, sqb, sk)``
    (or None) otherwise takes a zero gradient, as the reference's without
    ``bias_requires_grad``. The segment ids ``(b, sq)``/``(b, sk)`` int32
    (or None) take none; on the kernels, their tile ranges
    (``_kernels.seg_tile_ranges``) are computed once a forward and kept for
    the backward's two kernels. ``use_kernel`` picks the kernels or their
    plain versions."""

    @staticmethod
    def forward(ctx, q3, k3, v3, bias4, q_ids, kv_ids, causal: bool,
                scale: float, dropout_rate: float, seed, use_kernel: bool,
                need_dbias: bool, checkpoint_names: bool = False):
        segments = None if q_ids is None else (q_ids, kv_ids)
        if use_kernel:
            ranges = (None if segments is None else
                      tuple(_kernels.seg_tile_ranges(i) for i in segments))
            out, lse = region_op(
                _kernels.flash_fwd, q3, k3, v3, causal, scale, dropout_rate,
                seed, bias=bias4, segments=segments, tile_ranges=ranges)
            ctx.tile_ranges = ranges
        else:
            out, lse = region_op(_flash_fwd_plain, q3, k3, v3, causal, scale,
                                 dropout_rate, seed, bias=bias4,
                                 segments=segments)
        if checkpoint_names:
            # both residuals of the backward: kept together, they keep the
            # forward kernel out of the recompute
            out = tag(out, "flash_ctx")
            lse = tag(lse, "flash_lse")
        ctx.save_for_backward(q3, k3, v3, out, lse, bias4, q_ids, kv_ids)
        ctx.args = (causal, scale, dropout_rate, seed)
        ctx.use_kernel = use_kernel
        ctx.need_dbias = need_dbias
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out, lse, bias4, q_ids, kv_ids = ctx.saved_tensors
        segments = None if q_ids is None else (q_ids, kv_ids)
        do3 = do3.to(q3.dtype).contiguous()
        delta = (do3.float() * out.float()).sum(dim=-1)
        args = (q3, k3, v3, do3, lse, delta, *ctx.args)
        kw = dict(bias=bias4, segments=segments)
        learned = ctx.needs_input_grad[3] and ctx.need_dbias
        dbias = None
        if ctx.use_kernel:
            ranges = dict(tile_ranges=ctx.tile_ranges)
            dq = _kernels.flash_bwd_dq(*args, **kw, **ranges)
            if learned and _kernels.dbias_folds(bias4.shape, q3.dtype):
                dk, dv, dbias = _kernels.flash_bwd_dkv(
                    *args, **kw, **ranges, need_dbias=True)
            else:
                dk, dv = _kernels.flash_bwd_dkv(*args, **kw, **ranges)
                if learned:
                    dbias = _kernels.flash_dbias(*args, **kw)
        else:
            dq = _flash_bwd_dq_plain(*args, **kw)
            dk, dv = _flash_bwd_dkv_plain(*args, **kw)
            if learned:
                dbias = _flash_dbias_plain(*args, **kw)
        if ctx.needs_input_grad[3] and not ctx.need_dbias:
            dbias = torch.zeros_like(bias4)
        # None for the rest of the inputs given (checkpoint_names may be
        # left to its default)
        return (dq, dk, dv, dbias) + (None,) * (len(ctx.needs_input_grad)
                                                - 4)


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None,
                    bias_requires_grad: bool = False,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    segment_ids=None, checkpoint_names: bool = False):
    """Fused attention over ``(b, h, s, d)`` tensors, differentiable.

    This is :class:`_FlashAttention`: the ``flash_fwd``/``flash_bwd_dq``/
    ``flash_bwd_dkv`` (and, for a learned bias, ``flash_dbias`` or the
    fold of its gradient into ``flash_bwd_dkv``) kernels on
    CUDA tensors, their plain versions on the CPU (or with
    ``use_kernel=False``). ``dropout_rate``/``dropout_seed``: in-kernel
    attention dropout, keyed by the int seed (its int32 bit pattern); a
    rate without a seed raises.

    ``bias``: an additive score bias broadcastable to ``(b, h, sq, sk)``
    (a ``-10000`` padding mask ``(b, 1, 1, sk)``, a relative-position
    table ``(1, h, sq, sk)``, an ALiBi row ``(1, h, 1, sk)``), added after
    the scale and before the masks. The kernels read it broadcast, in
    fp32. As in the reference it gets a zero gradient unless
    ``bias_requires_grad``; with it, the gradient is the score cotangent
    summed over the bias's broadcast dims (``flash_dbias``), and reaches
    the caller's tensor through the rank and keys-dim normalization.

    ``segment_ids``: packed-sequence attention, ``ids (b, s)`` for
    self-attention or a ``(q_ids, kv_ids)`` pair; a score is visible only
    where the two ids are equal (with ``causal``, packed causal LM
    batches). Ids are compared as int32, exactly; ids outside int32 raise.
    A query row whose id no key shares gets out 0.

    ``checkpoint_names``: tag the context ``flash_ctx`` and the logsumexp
    ``flash_lse`` (:mod:`apex_tpu_torch.remat`), so a name-based remat
    policy keeps both and the forward kernel out of the recompute. Off by
    default, so an untagged forward calls no tag."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    kernel = use_kernel_for(use_kernel, q)
    seed = None if dropout_seed is None else int(dropout_seed)
    bias4 = None if bias is None else _norm_bias(bias, b, h, sq, sk)
    q_ids = kv_ids = None
    if segment_ids is not None:
        q_ids, kv_ids = _norm_segment_ids(segment_ids, sq, sk, q.device)
        q_ids, kv_ids = q_ids.reshape(b, sq), kv_ids.reshape(b, sk)
    out = _FlashAttention.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), bias4, q_ids, kv_ids,
        bool(causal), float(softmax_scale), float(dropout_rate), seed,
        kernel, bool(bias_requires_grad), bool(checkpoint_names))
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


def _merge_drafts(out, lse, q, k_new, v_new, k_cast, v_cast, scale: float,
                  out_dtype):
    """Exact ``(q_len + 1)``-way logsumexp merge of the speculative verify
    step: the cached-prefix attention ``(out, lse)`` of each row with the
    ``q_len`` in-flight tokens, causal among them (row i attends rows
    0..i). None of them is in the cache yet; sequential decode would have
    read rows j < i back from the cache, so those use ``k_cast``/
    ``v_cast`` (the store-and-load images of ``k_new``/``v_new``) while the
    diagonal stays fresh. All fp32; an empty prefix (lse == -inf) weighs 0.
    Reduces to :func:`_merge_current` at ``q_len == 1``.

    Shapes: ``out``, ``q``, ``k_new``, ``v_new``, ``k_cast``, ``v_cast``
    ``(b, h, q_len, d)``; ``lse (b, h, q_len)``."""
    q32 = q.float()
    q_len = q.shape[2]
    s_cast = torch.einsum("bhid,bhjd->bhij", q32, k_cast.float()) * scale
    s_self = (q32 * k_new.float()).sum(dim=-1) * scale
    idx = torch.arange(q_len, device=q.device)
    below = idx[None, :] < idx[:, None]            # strictly earlier rows
    s_off = torch.where(below, s_cast, -math.inf)
    m = torch.maximum(lse, torch.maximum(s_self, s_off.amax(dim=-1)))
    a_old = torch.exp(lse - m)                     # 0 when the prefix is empty
    p_self = torch.exp(s_self - m)
    p_off = torch.where(below, torch.exp(s_cast - m[..., None]), 0.0)
    denom = a_old + p_self + p_off.sum(dim=-1)
    merged = (a_old[..., None] * out.float()
              + p_self[..., None] * v_new.float()
              + torch.einsum("bhij,bhjd->bhid", p_off, v_cast.float()))
    return (merged / denom[..., None]).to(out_dtype)


def _check_in_flight(q, **tensors) -> None:
    """The current (or in-flight) tokens' keys and values, and their cache
    images, must have ``q``'s shape."""
    for name, t in tensors.items():
        if t is not None and tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"q {tuple(q.shape)}")


def decode_attention(q, k, v, lengths, k_new=None, v_new=None,
                     k_scale=None, v_scale=None,
                     softmax_scale: Optional[float] = None,
                     use_kernel: Optional[bool] = None,
                     k_cast=None, v_cast=None):
    """Attention of ``q`` over a preallocated KV cache, masked by the
    per-slot write cursor.

    Args:
      q: ``(b, h, d)`` (one row per slot) or ``(b, h, q_len, d)``; every
        row attends the same cached prefix.
      k, v: ``(b, h, max_len, d)`` caches (bf16/fp32, or int8 with
        ``k_scale``/``v_scale``). Entries at or past ``lengths`` are
        never read.
      lengths: ``(b,)`` int, the number of valid cache positions.
      k_new, v_new: ``q``'s shape: the current token's key and value,
        folded in by :func:`_merge_current` for rank-3 ``q``; for rank-4
        ``q`` (the speculative verify step) the ``q_len`` in-flight
        tokens', folded in causally by :func:`_merge_drafts`.
      k_scale, v_scale: ``(b, h, max_len)`` fp32 dequantization scales.
      k_cast, v_cast: rank-4 ``q`` only: the cache's store-and-load images
        of ``k_new``/``v_new``, which the merge uses for the earlier
        in-flight rows (default: ``k_new``/``v_new``).

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
    _check_in_flight(q, k_new=k_new, v_new=v_new, k_cast=k_cast,
                     v_cast=v_cast)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    lengths_bh = lengths.to(device=k.device, dtype=torch.int32
                            ).repeat_interleave(h)
    q3 = q.reshape(b * h, q_len, d)
    k3 = k.reshape(b * h, T, d)
    v3 = v.reshape(b * h, T, d)
    ksc = k_scale.reshape(b * h, T) if quantized else None
    vsc = v_scale.reshape(b * h, T) if quantized else None
    if use_kernel_for(use_kernel, q):
        out3, lse3 = _kernels.decode_attention(
            q3.contiguous(), k3, v3, lengths_bh, ksc, vsc,
            float(softmax_scale))
    else:
        out3, lse3 = _decode_plain(q3, k3, v3, lengths_bh, ksc, vsc,
                                   float(softmax_scale))
    return _decode_result(out3, lse3, q, k_new, v_new, k_cast, v_cast,
                          float(softmax_scale))


def _decode_result(out3, lse3, q, k_new, v_new, k_cast, v_cast,
                   scale: float):
    """A decode kernel's ``(out (b*h, q_len, d), lse (b*h, q_len))`` in
    ``q``'s shape, with the current token folded in for rank-3 ``q`` and
    the in-flight tokens for rank-4 ``q``."""
    out = out3.reshape(*q.shape[:2], -1, q.shape[-1])
    lse = lse3.reshape(*q.shape[:2], -1)
    if q.dim() == 4:
        if k_new is not None:
            out = _merge_drafts(out, lse, q, k_new, v_new,
                                k_new if k_cast is None else k_cast,
                                v_new if v_cast is None else v_cast, scale,
                                q.dtype)
        return out
    out, lse = out[:, :, 0], lse[:, :, 0]
    if k_new is not None:
        out = _merge_current(out, lse, q, k_new, v_new, scale, q.dtype)
    return out


# ---------------------------------------------------------------------------
# paged decode attention: plain version and public API
# ---------------------------------------------------------------------------

def _paged_decode_plain(q, k_pool, v_pool, tables, lengths, k_scale=None,
                        v_scale=None, softmax_scale: Optional[float] = None):
    """The function the ``paged_decode_attention`` kernel computes, on its
    layout: ``q (b*h, q_len, d)``, pools ``(num_blocks, h, block_size,
    d)``, ``tables (b, n_table)``, ``lengths (b,)`` -> ``out (b*h, q_len,
    d)`` in q's dtype and ``lse (b*h, q_len)`` fp32, as the reference's
    fallback computes it: the table-mapped blocks gathered into the dense
    layout, then :func:`_decode_plain`. Table entries at or past
    ``ceil(lengths / block_size)`` may name any block, or none: they are
    read as block 0, and every gathered position at or past the cursor is
    zeroed (keys, values and scales), so NaN or inf there never reaches
    ``p @ v``."""
    b, n_table = tables.shape
    _, h, bs, _ = k_pool.shape
    T = n_table * bs
    dev = k_pool.device
    lengths = lengths.to(device=dev, dtype=torch.int64).clamp(0, T)
    live = torch.arange(n_table, device=dev)[None, :] * bs < lengths[:, None]
    tab = torch.where(live, tables.to(device=dev, dtype=torch.int64), 0)
    valid = (torch.arange(T, device=dev)[None, :] < lengths[:, None]
             ).repeat_interleave(h, dim=0)                     # (b*h, T)

    def gather(pool):
        # (num_blocks, h, bs, ...) -> (b*h, T, ...), zero past the cursor
        g = pool[tab].transpose(1, 2).reshape(b * h, T, *pool.shape[3:])
        mask = valid.view(b * h, T, *([1] * (g.dim() - 2)))
        return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                                device=dev))

    quantized = k_pool.dtype == torch.int8
    return _decode_plain(
        q, gather(k_pool), gather(v_pool), lengths.repeat_interleave(h),
        gather(k_scale) if quantized else None,
        gather(v_scale) if quantized else None, softmax_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           k_new=None, v_new=None, k_scale=None,
                           v_scale=None,
                           softmax_scale: Optional[float] = None,
                           use_kernel: Optional[bool] = None,
                           k_cast=None, v_cast=None):
    """Attention of ``q`` over a paged KV cache: a global block pool, each
    slot's positions found through its block table and masked by its
    cursor. Counterpart of the reference's ``paged_decode_attention``.

    The reference's ``supports_paged`` (``block_size % 128 == 0`` on a
    TPU) is a tiling rule of the Pallas kernel and is not carried over:
    the CUDA kernel takes any ``block_size >= 1``. ``mean_context`` only
    priced the Pallas kernel's cost estimate and has no counterpart.

    Args:
      q: ``(b, h, d)`` (one row per slot) or ``(b, h, q_len, d)``; every
        row attends the same cached prefix.
      k_pool, v_pool: ``(num_blocks, h, block_size, d)`` pools
        (bf16/fp32, or int8 with ``k_scale``/``v_scale``). Only the
        blocks a slot's table names below its cursor are read for it.
      block_tables: ``(b, n_blocks_per_slot)`` int, pool indices of each
        slot's logical blocks in order. Entries at or past
        ``ceil(lengths / block_size)`` are never read.
      lengths: ``(b,)`` int, each slot's cursor (the current token is not
        in the pool: pass it as ``k_new``/``v_new``).
      k_new, v_new: ``q``'s shape: the current token's key and value
        for rank-3 ``q``, the in-flight tokens' for rank-4 ``q``, folded
        in as :func:`decode_attention` does.
      k_scale, v_scale: ``(num_blocks, h, block_size)`` fp32 pooled
        dequantization scales, required iff the pools are int8.
      k_cast, v_cast: rank-4 ``q`` only: the pool's store-and-load images
        of ``k_new``/``v_new`` (see :func:`decode_attention`).

    Returns ``q``'s shape in ``q.dtype``.
    """
    multi = q.dim() == 4
    if multi:
        b, h, q_len, d = q.shape
    else:
        b, h, d = q.shape
        q_len = 1
    if k_pool.dim() != 4:
        raise ValueError(f"pools must be (num_blocks, h, block_size, d), "
                         f"got {tuple(k_pool.shape)}")
    nb_pool, hp, block_size, dp = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or hp != h or dp != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (b, n_blocks_per_slot), "
                         f"got {tuple(block_tables.shape)}")
    quantized = k_pool.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 pools need k_scale/v_scale")
    if quantized and not all(
            tuple(s.shape) == (nb_pool, h, block_size)
            and s.dtype == torch.float32 for s in (k_scale, v_scale)):
        raise ValueError("int8 pools need (num_blocks, h, block_size) fp32 "
                         "k_scale/v_scale")
    _check_in_flight(q, k_new=k_new, v_new=v_new, k_cast=k_cast,
                     v_cast=v_cast)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    dev = k_pool.device
    tables = torch.as_tensor(block_tables, dtype=torch.int32,
                             device=dev).contiguous()
    lens = torch.as_tensor(lengths, dtype=torch.int32,
                           device=dev).contiguous()
    q3 = q.reshape(b * h, q_len, d)
    ksc = k_scale if quantized else None
    vsc = v_scale if quantized else None
    if use_kernel_for(use_kernel, q):
        out3, lse3 = _kernels.paged_decode_attention(
            q3.contiguous(), k_pool, v_pool, tables, lens, ksc, vsc,
            float(softmax_scale))
    else:
        out3, lse3 = _paged_decode_plain(q3, k_pool, v_pool, tables, lens,
                                         ksc, vsc, float(softmax_scale))
    return _decode_result(out3, lse3, q, k_new, v_new, k_cast, v_cast,
                          float(softmax_scale))
