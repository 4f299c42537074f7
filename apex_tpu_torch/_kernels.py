"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``apex_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together,
then one link) into a shared library under ``apex_tpu_torch/_build/``,
keyed by a hash of the sources and flags, and loaded with ``ctypes``: the
C entry points take raw device pointers and the stream, so no PyTorch
header is compiled. Nothing here is imported or built while a module is
imported: the CPU tests import every module of the package.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises if the launch reported an error, and adds one to its entry of
:data:`LAUNCHES` (and nowhere else). The wrappers know nothing of autograd:
:class:`apex_tpu_torch.ops.flash_attention` wraps the four flash kernels
in a ``torch.autograd.Function`` whose forward runs with grad disabled.

Attention dropout is keyed by ``seed``, the int32 bit pattern of the
reference's ``dropout_seed``; the kernels hash it with the global (batch-head,
row, col) of each score (``csrc/common.cuh``), so the mask equals
:func:`apex_tpu_torch.ops.flash_attention.dropout_keep_mask` bit for bit.
The flash kernels take an optional fp32 score bias ``(bb, hb, sqb, sk)``,
each of ``bb``, ``hb``, ``sqb`` 1 or full, kept broadcast: the wrapper
passes its element strides, 0 on a broadcast dim. They take optional
packed-sequence segment ids, int32 ``(b, sq)`` and ``(b, sk)``, one row
per batch of ``n / b`` heads. ``flash_dbias`` sums a learned bias's score
cotangent over its broadcast dims. For bf16 inputs and a bias without
query rows (:func:`dbias_folds`), ``flash_bwd_dkv(..., need_dbias=True)``
takes that gradient in its own launch instead (the fold: per-batch-head
partials from the tensor-core body, then a fixed-order sum over the
batch-heads that share a bias slice), counted as ``flash_dbias_fold``.

The flash kernels take every head dim ``d % 8 == 0`` from 8 to 256, each
run at the body width :func:`flash_width` gives (d rounded up to a
multiple of 16, or of 32 past 128): the loads zero-fill the columns past d
and the stores write the first d (``csrc/flash_width.cuh``). Their two
sources are compiled once per group of widths (:data:`_FLASH_PARTS`), the
groups side by side, each with its own entry points.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` have two bodies,
chosen by the inputs' dtype: bf16 runs on the tensor cores (``mma.sync``
tiles staged by ``cp.async``, ``csrc/mma.cuh``; the inputs must be 16-byte
aligned), and skips the (q tile, key tile) pairs whose segment ids never
meet, from the per-64-position id ranges :func:`seg_tile_ranges` computes
(the caller may pass them as ``tile_ranges``, so that one forward and its
backward compute them once); fp32 runs the exact SIMT bodies.
``flash_dbias`` runs one body for both.
The bf16 backward bodies round dS (and P_eff) where the plain version
does, re-taking the rare score near a bf16 rounding point
(``csrc/rounding.cuh``); the bf16 ``flash_bwd_dkv`` takes the row norms of
q and do for that test from the wrapper, ``flash_bwd_dq`` computes its
own.

``decode_attention`` and ``paged_decode_attention`` split each
slot-head's live prefix over :func:`decode_splits` blocks; the last block
of a slot-head to finish merges their partials in a fixed order. Both run
one body (``csrc/decode.cuh``), which differs only in how a position
becomes a cache row, and take every head dim :func:`decode_dim_ok` admits.

``ln_fwd`` and ``ln_bwd`` (``csrc/layer_norm.cu``) are the LayerNorm and
RMSNorm kernels; :mod:`apex_tpu_torch.normalization.fused_layer_norm`
wraps them in its ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "flash_width", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dq_retaken", "flash_bwd_dkv",
           "flash_dbias", "dbias_folds", "decode_attention", "decode_splits",
           "decode_dim_ok", "paged_decode_attention", "ln_fwd", "ln_bwd",
           "ln_bwd_ctas", "SOURCES", "BUILD_LISTENERS",
           "ID_TILE", "seg_tile_ranges", "build_log"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_dbias.cu",
           "decode_attention.cu", "paged_decode_attention.cu",
           "layer_norm.cu")
_HEADERS = ("common.cuh", "mma.cuh", "rounding.cuh", "decode.cuh",
            "flash_width.cuh")
# the sources built once per group of body widths (-DAPEX_FLASH_PART=i),
# and the groups: csrc/flash_width.cuh's table, which this must match
_FLASH_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_dbias.cu")
_FLASH_PARTS = ((16, 32, 48, 64), (80, 96, 112, 160), (128, 192), (224, 256))
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v writes each kernel's registers, shared memory and spills into
# the build log (build_log), without changing the code
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C entry points (csrc/common.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the widest head dim of the flash kernels (csrc/flash_width.cuh)
_FLASH_MAX_D = 256
# positions a segment-id range covers (csrc/mma.cuh::kIdTile)
ID_TILE = 64
# csrc/decode.cuh::kMaxD: the widest head dim of the decode kernels
_DECODE_MAX_D = 256
# csrc/layer_norm.cu: widths taken, and the widest rows of the backward's
# row kernel (one warp a row, 8 rows a block)
_LN_MAX_H = 65536
_LN_BWD_WARP_MAX_H = 1024
_LN_BWD_ROWS = 8
# csrc/decode.cuh: q rows a block past the first (one row takes a block of
# its own), and the H100's SMs, whose two waves the split aims to fill
_DECODE_ROWS = 4
_SMS = 132

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "flash_dbias": 0,
                            "flash_dbias_fold": 0, "decode_attention": 0,
                            "paged_decode_attention": 0, "ln_fwd": 0,
                            "ln_bwd": 0}

# callables(seconds) run after build() compiled the library, not when it
# loaded one built before: observability.runtime's compile counters
BUILD_LISTENERS: List[Callable[[float], None]] = []

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# the decode kernels' arrival counters, one buffer per (device, stream):
# zeroed once, and left at 0 by every launch (csrc/decode.cuh)
_ARRIVALS: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "built from apex_tpu_torch/csrc at first use on a machine with the "
        "CUDA toolkit")


def _source_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _jobs() -> Tuple[Tuple[str, str, Tuple[str, ...]], ...]:
    """``(name, source, extra flags)`` of each ``nvcc`` the build starts:
    one a source, and one a group of widths for the flash sources (named
    ``<source>#p<group>``)."""
    jobs = []
    for src in SOURCES:
        if src in _FLASH_SOURCES:
            jobs += [(f"{src}#p{i}", src, (f"-DAPEX_FLASH_PART={i}",))
                     for i in range(len(_FLASH_PARTS))]
        else:
            jobs.append((src, src, ()))
    return tuple(jobs)


def _compile(lib_path: Path) -> None:
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    jobs = _jobs()
    objs = [_BUILD / f"{name.replace('#', '_').replace('.cu', '')}.{tag}.o"
            for name, _, _ in jobs]
    t0 = time.perf_counter()

    def run(job, obj: Path) -> Tuple[int, str, float]:
        _, src, extra = job
        done = subprocess.run(
            [nvcc, *_ARCH, *_FLAGS, *extra, "-c", str(_CSRC / src), "-o",
             str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        return (done.returncode, done.stdout.decode(errors="replace"),
                time.perf_counter() - t0)

    with ThreadPoolExecutor(len(jobs)) as pool:
        runs = list(pool.map(run, jobs, objs))
    failed = [(job[0], log) for job, (rc, log, _) in zip(jobs, runs) if rc]
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{log}" for name, log in failed))
    # each job's compiler output, headed by the seconds it took
    lib_path.with_suffix(".log").write_text("".join(
        f"--- {job[0]} ({secs:.1f} s)\n{log}"
        for job, (_, log, secs) in zip(jobs, runs)))
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or none


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    drop = [I, U, I, F]  # on, seed, thresh, inv_keep
    bias = [P, I, I, I, I]  # pointer, heads, strides of batch, head, row
    seg = [P, P, I]  # q ids, kv ids, heads per id row
    rng = [P, P]  # the ids' per-tile ranges, q and kv
    # the flash entry points of each group of widths; ints n, sq, sk, d,
    # the body width, dtype, causal
    for part in range(len(_FLASH_PARTS)):
        fwd = getattr(lib, f"apex_flash_fwd_p{part}")
        fwd.argtypes = [P] * 5 + [I] * 7 + [F] + bias + seg + rng + drop + [P]
        fwd.restype = I
        # ... + the count of re-taken scores (null, or a uint64)
        dq = getattr(lib, f"apex_flash_bwd_dq_p{part}")
        dq.argtypes = ([P] * 7 + [I] * 7 + [F] + bias + seg + rng + drop
                       + [P, P])
        dq.restype = I
        # ... + the q and do row norms and the folded dbias's partials
        # (bf16 only)
        dkv = getattr(lib, f"apex_flash_bwd_dkv_p{part}")
        dkv.argtypes = ([P] * 8 + [I] * 7 + [F] + bias + seg + rng + [P] * 3
                        + drop + [P])
        dkv.restype = I
        # ... + kept slices, batch-heads each reduces, their two strides,
        # and whether the bias has full query rows
        dbias = getattr(lib, f"apex_flash_dbias_p{part}")
        dbias.argtypes = ([P] * 7 + [I] * 7 + [F] + bias + seg + [I] * 5
                          + drop + [P])
        dbias.restype = I
    # partials, db, kept, reduced, g_stride, r_stride, sk, stream
    lib.apex_flash_dbias_fold_sum.argtypes = [P, P] + [I] * 5 + [P]
    lib.apex_flash_dbias_fold_sum.restype = I
    # ... + the partials' scratch and the arrival counters
    lib.apex_decode_attention.argtypes = [P] * 10 + [I] * 7 + [F, P]
    lib.apex_decode_attention.restype = I
    # ... + the division by the block size (csrc/decode.cuh::FastDiv)
    lib.apex_paged_decode_attention.argtypes = ([P] * 11 + [I] * 7 + [U, I]
                                                + [I, I, F, P])
    lib.apex_paged_decode_attention.restype = I
    lib.apex_ln_fwd.argtypes = [P] * 6 + [I] * 5 + [F, I, P]
    lib.apex_ln_fwd.restype = I
    lib.apex_ln_bwd.argtypes = [P] * 10 + [I] * 7 + [P]
    lib.apex_ln_bwd.restype = I
    return lib


def build() -> Tuple[ctypes.CDLL, float]:
    """Load the kernels' library, compiling it first if this source hash
    has not been built. Returns ``(library, seconds spent compiling)``."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB, 0.0
        lib_path = _BUILD / f"libapex_tpu_torch_{_source_key()}.so"
        t0 = time.perf_counter()
        compiled = not lib_path.exists()
        if compiled:
            _compile(lib_path)
        seconds = time.perf_counter() - t0
        _LIB = _bind(ctypes.CDLL(str(lib_path)))
        if compiled:
            for listener in list(BUILD_LISTENERS):
                listener(seconds)
        return _LIB, seconds


def build_log() -> str:
    """The compiler's output of the current build (each source's seconds
    and ptxas's per-kernel registers, shared memory and spills), or "" if
    it was not built here."""
    path = _BUILD / f"libapex_tpu_torch_{_source_key()}.log"
    return path.read_text() if path.exists() else ""


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(name: str, tensors, device) -> None:
    for t in tensors:
        _require(t.is_cuda, f"{name}: inputs must be CUDA tensors, got one "
                            f"on {t.device}")
        _require(t.device == device,
                 f"{name}: every input must be on {device}, got {t.device}")
        _require(t.is_contiguous(), f"{name}: inputs must be contiguous")


def flash_width(d: int) -> int:
    """The body width the flash kernels run head dim ``d`` at: ``d``
    rounded up to a multiple of 16 (the k depth of the tensor cores'
    m16n8k16 product) at or below 128, to a multiple of 32 above. ``d``
    must be a multiple of 8 from 8 to 256, the reference's ``d % 8 == 0``
    up to the widest body whose tiles fit a block's shared memory;
    anything else raises ``NotImplementedError``."""
    if d % 8 or not 8 <= d <= _FLASH_MAX_D:
        raise NotImplementedError(
            f"head dim {d} is not a multiple of 8 in [8, {_FLASH_MAX_D}]")
    step = 16 if d <= 128 else 32
    return -(-d // step) * step


def _flash_entry(lib, name: str, width: int):
    """The entry point ``name`` of the group of widths that holds
    ``width`` (``csrc/flash_width.cuh``)."""
    part = next(i for i, ws in enumerate(_FLASH_PARTS) if width in ws)
    return getattr(lib, f"{name}_p{part}")


def _check_attention(name: str, q, k, v) -> Tuple[int, int, int, int, int]:
    """Shape and dtype checks shared by the three flash kernels; returns
    ``(n, sq, sk, d, body width)``."""
    _require(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
             f"{name}: q, k, v must be rank 3 (n, s, d)")
    n, sq, d = q.shape
    sk = k.shape[1]
    _require(tuple(k.shape) == (n, sk, d) and tuple(v.shape) == (n, sk, d),
             f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
             f"match q {tuple(q.shape)}")
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{name}: q/k/v must share one dtype of bf16/fp32, got "
             f"{q.dtype}/{k.dtype}/{v.dtype}")
    try:
        width = flash_width(d)
    except NotImplementedError as err:
        raise NotImplementedError(f"{name}: {err}") from None
    _require(n > 0 and sq > 0, f"{name}: empty batch or query")
    return n, sq, sk, d, width


def _dropout_args(dropout_rate: float, seed: Optional[int]):
    """``(on, seed bits, thresh, inv_keep)`` of ``csrc/common.cuh``'s
    ``Dropout``: the reference's ``int(rate * 2**24)`` threshold and the
    int32 bit pattern of the seed."""
    rate = float(dropout_rate)
    if rate == 0.0:
        return 0, 0, 0, 1.0
    _require(0.0 < rate < 1.0, f"dropout rate {rate} outside [0, 1)")
    _require(seed is not None, "dropout_rate > 0 requires a seed")
    return 1, int(seed) & 0xFFFFFFFF, int(rate * (1 << 24)), 1.0 / (1.0 - rate)


def _bias_args(name: str, bias: Optional[torch.Tensor], n: int, sq: int,
               sk: int) -> Tuple:
    """``(pointer, heads, batch stride, head stride, row stride)`` of the
    flash kernels' broadcast score bias ``(bb, hb, sqb, sk)`` fp32 over the
    ``n`` flattened batch-heads (``csrc/common.cuh::ScoreBias``); a null
    pointer without one."""
    if bias is None:
        return None, 1, 0, 0, 0
    _require(bias.dim() == 4 and bias.dtype == torch.float32,
             f"{name}: bias must be rank 4 fp32, got {tuple(bias.shape)} "
             f"{bias.dtype}")
    bb, hb, sqb, skb = bias.shape
    _require(skb == sk and sqb in (1, sq),
             f"{name}: bias {tuple(bias.shape)} does not match sq {sq}, "
             f"sk {sk}")
    heads = hb if hb > 1 else (n // bb if bb > 1 else 1)
    _require(bb * heads == n if bb > 1 else n % heads == 0,
             f"{name}: bias {tuple(bias.shape)} does not split {n} "
             "batch-heads")
    return (bias.data_ptr(), heads,
            hb * sqb * sk if bb > 1 else 0,
            sqb * sk if hb > 1 else 0,
            sk if sqb > 1 else 0)


def _seg_args(name: str, segments, n: int, sq: int, sk: int) -> Tuple:
    """``(q ids, kv ids, heads)`` of ``csrc/common.cuh::Segments`` from
    ``segments = (q_ids (b, sq), kv_ids (b, sk))`` int32, ``b`` dividing
    the ``n`` batch-heads; null pointers without them."""
    if segments is None:
        return None, None, 1
    q_ids, kv_ids = segments
    _require(q_ids.dim() == 2 and kv_ids.dim() == 2
             and q_ids.dtype == torch.int32 and kv_ids.dtype == torch.int32,
             f"{name}: segment ids must be rank 2 int32, got "
             f"{q_ids.dtype} {tuple(q_ids.shape)}, {kv_ids.dtype} "
             f"{tuple(kv_ids.shape)}")
    b = q_ids.shape[0]
    _require(tuple(q_ids.shape) == (b, sq) and tuple(kv_ids.shape) == (b, sk)
             and b > 0 and n % b == 0,
             f"{name}: segment ids {tuple(q_ids.shape)}/"
             f"{tuple(kv_ids.shape)} do not match {n} batch-heads of sq "
             f"{sq}, sk {sk}")
    return q_ids.data_ptr(), kv_ids.data_ptr(), n // b


def seg_tile_ranges(ids: torch.Tensor, tile: int = ID_TILE) -> torch.Tensor:
    """``(b, ceil(s / tile), 2)`` int32: the (min, max) segment id of each
    ``tile``-position tile of ``ids (b, s)``, the last tile padded with its
    row's last id (positions past ``s`` are masked anyway, so the range is
    exact). A (q tile, key tile) pair whose ranges are disjoint holds no
    pair of equal ids: the tensor-core bodies skip it
    (``csrc/mma.cuh::tiles_meet``; the predicate is
    :func:`apex_tpu_torch.ops.flash_attention._tiles_meet`)."""
    b, s = ids.shape
    pad = -s % tile
    if pad:
        ids = torch.cat([ids, ids[:, -1:].expand(b, pad)], dim=1)
    tiles = ids.view(b, -1, tile)
    return torch.stack([tiles.amin(dim=-1), tiles.amax(dim=-1)],
                       dim=-1).to(torch.int32).contiguous()


def _rng_args(segments, tile_ranges) -> Tuple:
    """The ids' tile ranges as the kernels take them (null pointers without
    ids): ``tile_ranges``, the :func:`seg_tile_ranges` of ``segments``,
    computed here if None; with the tensors that hold them alive until the
    launch."""
    if segments is None:
        return (None, None), ()
    held = (tuple(seg_tile_ranges(ids) for ids in segments)
            if tile_ranges is None else tuple(tile_ranges))
    for ids, rng in zip(segments, held):
        _require(rng.dtype == torch.int32 and rng.is_contiguous()
                 and tuple(rng.shape) == (ids.shape[0],
                                          -(-ids.shape[1] // ID_TILE), 2)
                 and rng.device == ids.device,
                 f"tile ranges {tuple(rng.shape)} do not match ids "
                 f"{tuple(ids.shape)}")
    return tuple(r.data_ptr() for r in held), held


def _check_aligned(name: str, *tensors) -> None:
    """The tensor-core bodies stage bf16 rows with 16-byte ``cp.async``
    copies: their inputs must start 16-byte aligned (rows of any d % 8 ==
    0 bf16 then are). Raises otherwise; nothing falls back."""
    for t in tensors:
        _require(t.dtype != torch.bfloat16 or t.data_ptr() % 16 == 0,
                 f"{name}: bf16 inputs must be 16-byte aligned")


def _extras(bias, segments) -> Tuple:
    """The optional tensors a flash kernel reads, for the common checks."""
    return ((() if bias is None else (bias,))
            + (() if segments is None else tuple(segments)))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, dropout_rate: float = 0.0,
              seed: Optional[int] = None,
              bias: Optional[torch.Tensor] = None,
              segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              tile_ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q (n, sq, d)``, ``k``/``v`` ``(n, sk, d)`` (bf16 or fp32, one
    dtype, d as :func:`flash_width` takes) -> ``(out (n, sq, d), lse (n,
    sq) fp32)``,
    with attention dropout at ``dropout_rate`` keyed by ``seed``, the score
    bias ``bias`` (see :func:`_bias_args`) added after the scale, and the
    segment ids ``segments`` (see :func:`_seg_args`) masking scores whose
    ids differ; ``tile_ranges`` are the ids' :func:`seg_tile_ranges`, or
    None to compute them."""
    _check_common("flash_fwd", (q, k, v, *_extras(bias, segments)),
                  q.device)
    n, sq, sk, d, width = _check_attention("flash_fwd", q, k, v)
    _check_aligned("flash_fwd", q, k, v)
    bias_args = _bias_args("flash_fwd", bias, n, sq, sk)
    seg_args = _seg_args("flash_fwd", segments, n, sq, sk)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    rng_args, _held = _rng_args(segments, tile_ranges)
    out = torch.empty_like(q)
    lse = torch.empty((n, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_entry(lib, "apex_flash_fwd", width)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), n, sq, sk, d, width, _DTYPE_CODE[q.dtype],
            int(causal),
            float(scale), *bias_args, *seg_args, *rng_args, *drop, stream)
    _check_launch("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_bwd(name: str, q, k, v, do, lse, delta, bias,
               segments) -> Tuple:
    """The backward kernels' checks; returns ``(n, sq, sk, d, body width,
    bias arguments, segment-id arguments)``."""
    _check_common(name, (q, k, v, do, lse, delta, *_extras(bias, segments)),
                  q.device)
    n, sq, sk, d, width = _check_attention(name, q, k, v)
    _require(tuple(do.shape) == (n, sq, d) and do.dtype == q.dtype,
             f"{name}: do {tuple(do.shape)} {do.dtype} does not match q")
    for t, what in ((lse, "lse"), (delta, "delta")):
        _require(tuple(t.shape) == (n, sq) and t.dtype == torch.float32,
                 f"{name}: {what} must be (n, sq) fp32, got "
                 f"{tuple(t.shape)} {t.dtype}")
    return (n, sq, sk, d, width, _bias_args(name, bias, n, sq, sk),
            _seg_args(name, segments, n, sq, sk))


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, scale: float, dropout_rate: float = 0.0,
                 seed: Optional[int] = None,
                 bias: Optional[torch.Tensor] = None,
                 segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 tile_ranges: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                 ) -> torch.Tensor:
    """``dq (n, sq, d)`` in q's dtype from ``q``, ``k``, ``v``, ``bias``,
    ``segments``, ``tile_ranges`` and ``do`` as for :func:`flash_fwd`, the
    forward's ``lse (n, sq)`` and ``delta = rowsum(do * out) (n, sq)``,
    both fp32."""
    return _flash_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                         dropout_rate, seed, bias, segments, tile_ranges,
                         None)


def flash_bwd_dq_retaken(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, causal: bool, scale: float,
                         dropout_rate: float = 0.0,
                         seed: Optional[int] = None,
                         bias: Optional[torch.Tensor] = None,
                         segments: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, int]:
    """:func:`flash_bwd_dq` on bf16 inputs, with the number of scores the
    tensor-core body's rounding pass took again (``csrc/rounding.cuh``):
    a diagnostic, which synchronizes to read the count; ``dq`` is the
    same."""
    _require(q.dtype == torch.bfloat16,
             "flash_bwd_dq_retaken: only the bf16 body re-takes scores")
    count = torch.zeros(1, dtype=torch.int64, device=q.device)
    dq = _flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, dropout_rate,
                       seed, bias, segments, None, count)
    return dq, int(count.item())


def _flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, dropout_rate,
                  seed, bias, segments, tile_ranges,
                  retaken) -> torch.Tensor:
    n, sq, sk, d, width, bias_args, seg_args = _check_bwd(
        "flash_bwd_dq", q, k, v, do, lse, delta, bias, segments)
    _check_aligned("flash_bwd_dq", q, k, v, do)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    rng_args, _held = _rng_args(segments, tile_ranges)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_entry(lib, "apex_flash_bwd_dq", width)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, sq, sk, d,
            width, _DTYPE_CODE[q.dtype], int(causal), float(scale), *bias_args,
            *seg_args, *rng_args, *drop,
            None if retaken is None else retaken.data_ptr(), stream)
    _check_launch("flash_bwd_dq", err)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float, dropout_rate: float = 0.0,
                  seed: Optional[int] = None,
                  bias: Optional[torch.Tensor] = None,
                  segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  tile_ranges: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  need_dbias: bool = False) -> Tuple[torch.Tensor, ...]:
    """``(dk, dv)``, each ``(n, sk, d)`` in k's dtype, from the inputs of
    :func:`flash_bwd_dq`. With ``need_dbias`` (only where
    :func:`dbias_folds` holds: bf16 inputs, a bias without query rows),
    ``(dk, dv, dbias)``: the learned bias's gradient of
    :func:`flash_dbias`, folded into the same launch (the body sums each
    key's dS over the rows of a batch-head into an ``(n, sk)`` fp32
    partial, then a second launch sums the partials of the batch-heads
    that share a bias slice in the order of :func:`_dbias_split`; with one
    batch-head a slice the body writes ``dbias`` itself). dK and dV are
    the same bits either way."""
    name = "flash_bwd_dkv"
    n, sq, sk, d, width, bias_args, seg_args = _check_bwd(
        name, q, k, v, do, lse, delta, bias, segments)
    _check_aligned(name, q, k, v, do)
    _require(not need_dbias or (bias is not None
                                and dbias_folds(bias.shape, q.dtype)),
             f"{name}: the folded dbias takes bf16 inputs and a bias "
             "without query rows (flash_dbias takes the rest)")
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    rng_args, _held = _rng_args(segments, tile_ranges)
    # the tensor-core body bounds its sums' error by the rows' norms
    # (csrc/flash_bwd.cu, kFixKappa)
    norms = ((torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32),
              torch.linalg.vector_norm(do, dim=-1, dtype=torch.float32))
             if q.dtype == torch.bfloat16 else ())
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    db = part = None
    if need_dbias:
        split = _dbias_split(bias, n)
        db = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
        # one batch-head a slice: slice g is batch-head g, so the partials
        # are dbias itself
        part = db if split[1] == 1 else torch.empty(
            (n, sk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_entry(lib, "apex_flash_bwd_dkv", width)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            n, sq, sk, d, width, _DTYPE_CODE[q.dtype], int(causal),
            float(scale),
            *bias_args, *seg_args, *rng_args,
            *([t.data_ptr() for t in norms] or [None, None]),
            None if part is None else part.data_ptr(), *drop, stream)
        _check_launch(name, err)
        if part is not None and part is not db:
            _check_launch(name, _dbias_fold_sum(lib, part, db, split,
                                                stream))
    LAUNCHES[name] += 1
    if not need_dbias:
        return dk, dv
    LAUNCHES["flash_dbias_fold"] += 1
    return dk, dv, db


def dbias_folds(bias_shape, dtype: torch.dtype) -> bool:
    """Whether a learned bias's gradient takes the fold in
    :func:`flash_bwd_dkv` (True) or :func:`flash_dbias` (False), by the
    bias's shape ``(bb, hb, sqb, sk)`` and the inputs' dtype alone: the
    fold for bf16 inputs and a bias without query rows (``sqb == 1``: an
    ALiBi row, a learned padding mask). A table with query rows stays on
    ``flash_dbias``, since its per-batch-head partials would hold ``n /
    (bb hb)`` times the table (6.4 GB at the long-context shape), and so
    do fp32 inputs, whose SIMT bodies hold the fp32 limits."""
    return dtype == torch.bfloat16 and bias_shape[2] == 1


def _dbias_fold_sum(lib, part: torch.Tensor, db: torch.Tensor, split,
                    stream: int) -> int:
    """The fold's second launch (``csrc/flash_dbias.cu``): ``db`` slice
    ``g`` = the partials of its batch-heads ``g * g_stride + r * r_stride``
    summed in the order ``r = 0..R-1``. Returns the launch's error code."""
    kept, reduced, g_stride, r_stride = split
    return lib.apex_flash_dbias_fold_sum(
        part.data_ptr(), db.data_ptr(), kept, reduced, g_stride, r_stride,
        part.shape[1], stream)


def _dbias_split(bias: torch.Tensor, n: int) -> Tuple[int, int, int, int]:
    """``(kept, reduced, g_stride, r_stride)``: the bias's ``kept = bb x
    hb`` slices each sum the score cotangent of ``reduced = n / kept``
    batch-heads, slice ``g``'s ``r``-th being ``g * g_stride + r *
    r_stride`` (the reference's ``_dbias_pallas.bh_of``)."""
    bb, hb = bias.shape[:2]
    kept = bb * hb
    reduced = n // kept
    if bb > 1 and hb > 1:
        return kept, reduced, 1, 0
    if hb > 1:                 # broadcast over batch: r walks the batches
        return kept, reduced, 1, hb
    if bb > 1:                 # broadcast over heads: r walks the heads
        return kept, reduced, reduced, 1
    return kept, reduced, 0, 1


def flash_dbias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                causal: bool, scale: float, dropout_rate: float = 0.0,
                seed: Optional[int] = None,
                bias: Optional[torch.Tensor] = None,
                segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The learned bias's gradient, ``dbias`` of ``bias``'s shape ``(bb,
    hb, sqb, sk)`` fp32: the score cotangent ``ds = p * (dp_eff -
    delta)`` (undropped ``p``, unrounded) of the inputs of
    :func:`flash_bwd_dq`, summed over the bias's broadcast dims in a fixed
    order (a repeat is equal bit for bit)."""
    name = "flash_dbias"
    _require(bias is not None, f"{name}: needs the bias whose gradient it "
                               "is")
    n, sq, sk, d, width, bias_args, seg_args = _check_bwd(
        name, q, k, v, do, lse, delta, bias, segments)
    kept, reduced, g_stride, r_stride = _dbias_split(bias, n)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    db = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_entry(lib, "apex_flash_dbias", width)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), db.data_ptr(), n, sq, sk, d,
            width, _DTYPE_CODE[q.dtype], int(causal), float(scale), *bias_args,
            *seg_args, kept, reduced, g_stride, r_stride,
            int(bias.shape[2] > 1), *drop, stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return db


def decode_splits(n: int, T: int, q_len: int) -> int:
    """Blocks ``decode_attention`` and ``paged_decode_attention`` split
    each slot-head's live prefix over, from the launch's shape alone (the
    host never reads a cursor; ``T`` is the positions a slot-head can
    hold: the dense cache's, or the table's span ``n_table * block_size``):
    a chunk of about 256 of the ``T`` positions, more blocks where the grid
    (``n`` slot-heads x splits x :func:`_decode_groups`) would not fill
    two waves of the H100's 132 SMs, but never a chunk under 64 of the
    ``T`` positions. A shorter live prefix is split over the same blocks
    (at the dense serving path's cursors, 17-144 of 1024, that ran faster
    than a floor of 64 live positions a chunk: PERF.md)."""
    groups = _decode_groups(n, q_len)
    splits = max(1, -(-T // 256))
    fill = -(-2 * _SMS // groups)
    return max(splits, min(fill, T // 64))


def _decode_groups(n: int, q_len: int) -> int:
    """The decode kernels' blocks a chunk: one a slot-head for one q row,
    else one per 4 q rows."""
    return n if q_len == 1 else n * -(-q_len // _DECODE_ROWS)


def decode_dim_ok(d: int) -> bool:
    """Whether the decode kernels take head dim ``d``: every multiple of 8
    from 8 to 256, the reference's ``d % 8 == 0`` rule (a row is split
    over lanes of 8 elements, ``csrc/decode.cuh``)."""
    return d % 8 == 0 and 8 <= d <= _DECODE_MAX_D


def _fast_div(divisor: int) -> Tuple[int, int]:
    """``(magic, shift)`` of ``csrc/decode.cuh::FastDiv``: ``x // divisor``
    is ``umulhi(x, magic) >> shift`` for ``0 <= x < 2**31``, with ``magic
    = ceil(2**(31 + l) / divisor)``, ``shift = l - 1``, ``l =
    ceil(log2(divisor))``; ``(0, 0)`` for a divisor of 1 (the quotient is
    ``x``)."""
    if divisor == 1:
        return 0, 0
    l = (divisor - 1).bit_length()
    return -(-(1 << (31 + l)) // divisor), l - 1


def _arrivals(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """``count`` uint32 arrival counters at 0 for a decode kernel's launch
    on ``stream``: a buffer kept per (device, stream), which every launch
    leaves at 0, so it is zeroed only when it grows."""
    key = (torch.device(device).index or 0, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor], scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q (n, q_len, d)`` bf16/fp32 over ``k``/``v`` ``(n, T, d)``
    (bf16, fp32, or int8 with ``(n, T)`` fp32 scales) masked by ``lengths
    (n,)`` int32 -> ``(out (n, q_len, d) in q.dtype, lse (n, q_len))``;
    ``d`` as :func:`decode_dim_ok` admits."""
    quantized = k.dtype == torch.int8
    scales = (k_scale, v_scale) if quantized else ()
    _check_common("decode_attention", (q, k, v, lengths, *scales), q.device)
    _require(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
             "decode_attention: q, k, v must be rank 3")
    n, q_len, d = q.shape
    T = k.shape[1]
    _require(tuple(k.shape) == (n, T, d) and tuple(v.shape) == (n, T, d),
             f"decode_attention: cache {tuple(k.shape)}/{tuple(v.shape)} "
             f"does not match q {tuple(q.shape)}")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"decode_attention: q dtype {q.dtype} is not bf16/fp32")
    _require(k.dtype in _DTYPE_CODE and v.dtype == k.dtype,
             f"decode_attention: cache dtypes {k.dtype}/{v.dtype}")
    _require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (n,),
             "decode_attention: lengths must be (n,) int32")
    if quantized:
        _require(all(s is not None and s.dtype == torch.float32
                     and tuple(s.shape) == (n, T) for s in (k_scale,
                                                            v_scale)),
                 "decode_attention: int8 caches need (n, T) fp32 scales")
    if not decode_dim_ok(d):
        raise NotImplementedError(
            f"decode_attention: head dim {d} is not a multiple of 8 in "
            f"[8, {_DECODE_MAX_D}]")
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             "decode_attention: cache rows must be 16-byte aligned")
    _require(n > 0 and q_len > 0, "decode_attention: empty batch or query")
    splits = decode_splits(n, T, q_len)
    lib, _ = build()
    out = torch.empty_like(q)
    lse = torch.empty((n, q_len), dtype=torch.float32, device=q.device)
    part = torch.empty(n * splits * q_len * (d + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        arrivals = _arrivals(q.device, stream, _decode_groups(n, q_len))
        err = lib.apex_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            part.data_ptr(), arrivals.data_ptr(), n, q_len, T, d, splits,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], float(scale),
            stream)
    _check_launch("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out, lse


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor],
                           v_scale: Optional[torch.Tensor], scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q (n, q_len, d)`` bf16/fp32 with ``n = slots * heads`` over the
    block pools ``k_pool``/``v_pool`` ``(num_blocks, heads, block_size,
    d)`` (bf16, fp32, or int8 with ``(num_blocks, heads, block_size)`` fp32
    scales), slot ``s`` reading logical position ``t`` from pool block
    ``tables[s, t // block_size]`` below its cursor ``lengths[s]``
    (``tables (slots, n_table)``, ``lengths (slots,)``, both int32) ->
    ``(out (n, q_len, d) in q.dtype, lse (n, q_len))``; ``d`` as
    :func:`decode_dim_ok` admits. Table entries at or past
    ``ceil(lengths[s] / block_size)`` are never read."""
    name = "paged_decode_attention"
    quantized = k_pool.dtype == torch.int8
    scales = (k_scale, v_scale) if quantized else ()
    _check_common(name, (q, k_pool, v_pool, tables, lengths, *scales),
                  q.device)
    _require(q.dim() == 3 and k_pool.dim() == 4 and tables.dim() == 2,
             f"{name}: q must be rank 3 (n, q_len, d), the pools rank 4 "
             "and the tables rank 2")
    n, q_len, d = q.shape
    num_blocks, heads, block_size, dp = k_pool.shape
    slots, n_table = tables.shape
    _require(tuple(v_pool.shape) == tuple(k_pool.shape) and dp == d
             and n == slots * heads,
             f"{name}: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
             f"and tables {tuple(tables.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"{name}: q dtype {q.dtype} is not bf16/fp32")
    _require(k_pool.dtype in _DTYPE_CODE and v_pool.dtype == k_pool.dtype,
             f"{name}: pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    _require(tables.dtype == torch.int32 and lengths.dtype == torch.int32
             and tuple(lengths.shape) == (slots,),
             f"{name}: tables must be (slots, n) int32 and lengths (slots,) "
             "int32")
    if quantized:
        _require(all(s is not None and s.dtype == torch.float32
                     and tuple(s.shape) == (num_blocks, heads, block_size)
                     for s in (k_scale, v_scale)),
                 f"{name}: int8 pools need (num_blocks, heads, block_size) "
                 "fp32 scales")
    if not decode_dim_ok(d):
        raise NotImplementedError(
            f"{name}: head dim {d} is not a multiple of 8 in [8, "
            f"{_DECODE_MAX_D}]")
    _require(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
             f"{name}: pool rows must be 16-byte aligned")
    _require(n > 0 and q_len > 0 and n_table > 0 and block_size > 0,
             f"{name}: empty batch, query, table or block")
    span = n_table * block_size
    _require(span < 1 << 31, f"{name}: a table spans {span} positions, "
                             "past 2**31 - 1")
    splits = decode_splits(n, span, q_len)
    lib, _ = build()
    out = torch.empty_like(q)
    lse = torch.empty((n, q_len), dtype=torch.float32, device=q.device)
    part = torch.empty(n * splits * q_len * (d + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        arrivals = _arrivals(q.device, stream, _decode_groups(n, q_len))
        err = lib.apex_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            part.data_ptr(), arrivals.data_ptr(), n, heads, q_len,
            block_size, n_table, d, splits, *_fast_div(block_size),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], float(scale),
            stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return out, lse


# ---------------------------------------------------------------------------
# LayerNorm / RMSNorm (csrc/layer_norm.cu)
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _check_rows(name: str, x2d: torch.Tensor) -> Tuple[int, int]:
    _require(x2d.dim() == 2 and x2d.dtype in _FLOATS,
             f"{name}: x must be (n, h) fp32 or bf16, got "
             f"{tuple(x2d.shape)} {x2d.dtype}")
    n, h = x2d.shape
    if h % 8 or not 8 <= h <= _LN_MAX_H:
        raise NotImplementedError(
            f"{name}: hidden size {h} is not a multiple of 8 in [8, "
            f"{_LN_MAX_H}]")
    _require(n > 0, f"{name}: no rows")
    _require(x2d.data_ptr() % 16 == 0, f"{name}: x must be 16-byte aligned")
    return n, h


def _check_params(name: str, h: int, *params) -> torch.dtype:
    """The affine parameters' common dtype (checks shape, dtype,
    alignment); ``None`` entries are absent parameters."""
    given = [p for p in params if p is not None]
    dtypes = {p.dtype for p in given}
    _require(len(dtypes) <= 1 and dtypes <= set(_FLOATS),
             f"{name}: weight and bias must share one dtype of fp32/bf16, "
             f"got {sorted(map(str, dtypes))}")
    for p in given:
        _require(tuple(p.shape) == (h,) and p.data_ptr() % 16 == 0,
                 f"{name}: parameters must be ({h},) and 16-byte aligned, "
                 f"got {tuple(p.shape)}")
    return dtypes.pop() if dtypes else None


def ln_fwd(x2d: torch.Tensor, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], eps: float, rms: bool,
           out_dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm (or RMSNorm with ``rms``) of the rows of ``x2d (n, h)``,
    fp32 or bf16, ``h`` a multiple of 8 up to 65536, with the optional
    ``weight``/``bias (h,)`` (fp32 or bf16, one dtype) -> ``(out (n, h) in
    out_dtype, mean (n, 1), invvar (n, 1))``, the statistics fp32 (mean 0
    for RMSNorm). ``out_dtype`` is x's or the weight's."""
    name = "ln_fwd"
    params = tuple(p for p in (weight, bias) if p is not None)
    _check_common(name, (x2d, *params), x2d.device)
    n, h = _check_rows(name, x2d)
    w_dtype = _check_params(name, h, weight, bias) or x2d.dtype
    _require(out_dtype in (x2d.dtype, w_dtype),
             f"{name}: out_dtype {out_dtype} is neither x's {x2d.dtype} "
             f"nor the weight's {w_dtype}")
    lib, _ = build()
    dev = x2d.device
    out = torch.empty((n, h), dtype=out_dtype, device=dev)
    mean = torch.empty((n, 1), dtype=torch.float32, device=dev)
    invvar = torch.empty((n, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_ln_fwd(
            x2d.data_ptr(), None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            mean.data_ptr(), invvar.data_ptr(), n, h,
            _DTYPE_CODE[x2d.dtype], _DTYPE_CODE[w_dtype],
            _DTYPE_CODE[out_dtype], float(eps), int(rms), stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return out, mean, invvar


def ln_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
           invvar: torch.Tensor, weight: Optional[torch.Tensor], rms: bool,
           has_bias: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                      Optional[torch.Tensor]]:
    """The backward of :func:`ln_fwd` from the output cotangent ``dy2d (n,
    h)`` (fp32 or bf16), the forward's input and statistics and its
    weight -> ``(dx (n, h) in x's dtype, dweight, dbias)``. ``dweight``
    (with a weight) and ``dbias`` (with ``has_bias``) are summed over the
    rows in fp32, partial rows per block (:func:`ln_bwd_ctas`) then
    a column sum in a second launch, which rounds them once to the
    weight's dtype (fp32 without one)."""
    name = "ln_bwd"
    params = () if weight is None else (weight,)
    _check_common(name, (dy2d, x2d, mean, invvar, *params), x2d.device)
    n, h = _check_rows(name, x2d)
    _require(tuple(dy2d.shape) == (n, h) and dy2d.dtype in _FLOATS
             and dy2d.data_ptr() % 16 == 0,
             f"{name}: dy must be ({n}, {h}) fp32/bf16 and 16-byte "
             f"aligned, got {tuple(dy2d.shape)} {dy2d.dtype}")
    for t, what in ((mean, "mean"), (invvar, "invvar")):
        _require(tuple(t.shape) == (n, 1) and t.dtype == torch.float32,
                 f"{name}: {what} must be ({n}, 1) fp32, got "
                 f"{tuple(t.shape)} {t.dtype}")
    w_dtype = _check_params(name, h, weight) or torch.float32
    lib, _ = build()
    dev = x2d.device
    dx = torch.empty_like(x2d)
    sums = torch.empty((2, h), dtype=w_dtype, device=dev)
    want_g, want_b = weight is not None, bool(has_bias)
    with torch.cuda.device(dev):
        # scratch for the partial rows of at most two blocks an SM; the C
        # entry point launches at most the blocks the SMs hold at once
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ctas = ln_bwd_ctas(n, h, 2 * sms)
        part = torch.empty((2, ctas, h), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_ln_bwd(
            dy2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(),
            invvar.data_ptr(), weight.data_ptr() if want_g else None,
            dx.data_ptr(), part[0].data_ptr() if want_g else None,
            part[1].data_ptr() if want_b else None, sums[0].data_ptr(),
            sums[1].data_ptr(), n, h, ctas, _DTYPE_CODE[x2d.dtype],
            _DTYPE_CODE[dy2d.dtype], _DTYPE_CODE[w_dtype], int(rms), stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return (dx, sums[0] if want_g else None, sums[1] if want_b else None)


def ln_bwd_ctas(n: int, h: int, max_blocks: int) -> int:
    """The partial rows of dweight and dbias :func:`ln_bwd` holds for ``n``
    rows of width ``h``, and the blocks it launches, each writing one: one
    block for every 8 rows up to ``h = 1024`` (a warp a row), else one for
    every row, and never more than ``max_blocks`` (``ln_bwd`` passes two
    an SM; a block walks its rows grid-stride). Where fewer blocks of the
    row kernel fit on the SMs at once, ``csrc/layer_norm.cu`` launches one
    wave of those (the CUDA occupancy query)."""
    rows = _LN_BWD_ROWS if h <= _LN_BWD_WARP_MAX_H else 1
    return max(1, min(-(-n // rows), max_blocks))

