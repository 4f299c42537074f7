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
:class:`apex_tpu_torch.ops.flash_attention` wraps the three flash kernels
in a ``torch.autograd.Function`` whose forward runs with grad disabled.

Attention dropout is keyed by ``seed``, the int32 bit pattern of the
reference's ``dropout_seed``; the kernels hash it with the global (batch-head,
row, col) of each score (``csrc/common.cuh``), so the mask equals
:func:`apex_tpu_torch.ops.flash_attention.dropout_keep_mask` bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "decode_attention", "SOURCES"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attention.cu")
_HEADERS = ("common.cuh",)
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# dtype codes of the C entry points (csrc/common.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "decode_attention": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


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


def _compile(lib_path: Path) -> None:
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [_BUILD / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    failed = [(src, log) for src, p, log in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {src}\n{log}" for src, log in failed))
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
    lib.apex_flash_fwd.argtypes = [P] * 5 + [I] * 6 + [F] + drop + [P]
    lib.apex_flash_fwd.restype = I
    lib.apex_flash_bwd_dq.argtypes = [P] * 7 + [I] * 6 + [F] + drop + [P]
    lib.apex_flash_bwd_dq.restype = I
    lib.apex_flash_bwd_dkv.argtypes = [P] * 8 + [I] * 6 + [F] + drop + [P]
    lib.apex_flash_bwd_dkv.restype = I
    lib.apex_decode_attention.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                          I, I, I, F, P]
    lib.apex_decode_attention.restype = I
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
        if not lib_path.exists():
            _compile(lib_path)
        seconds = time.perf_counter() - t0
        _LIB = _bind(ctypes.CDLL(str(lib_path)))
        return _LIB, seconds


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


def _check_attention(name: str, q, k, v) -> Tuple[int, int, int, int]:
    """Shape and dtype checks shared by the three flash kernels; returns
    ``(n, sq, sk, d)``."""
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
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: head dim {d} is not one of {_HEAD_DIMS}")
    _require(n > 0 and sq > 0, f"{name}: empty batch or query")
    return n, sq, sk, d


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


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, dropout_rate: float = 0.0,
              seed: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q (n, sq, d)``, ``k``/``v`` ``(n, sk, d)`` (bf16 or fp32, one
    dtype, d in {64, 128}) -> ``(out (n, sq, d), lse (n, sq) fp32)``, with
    attention dropout at ``dropout_rate`` keyed by ``seed``."""
    _check_common("flash_fwd", (q, k, v), q.device)
    n, sq, sk, d = _check_attention("flash_fwd", q, k, v)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    out = torch.empty_like(q)
    lse = torch.empty((n, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.apex_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), n, sq, sk, d, _DTYPE_CODE[q.dtype], int(causal),
            float(scale), *drop, stream)
    _check_launch("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_bwd(name: str, q, k, v, do, lse, delta) -> Tuple[int, int, int,
                                                            int]:
    _check_common(name, (q, k, v, do, lse, delta), q.device)
    n, sq, sk, d = _check_attention(name, q, k, v)
    _require(tuple(do.shape) == (n, sq, d) and do.dtype == q.dtype,
             f"{name}: do {tuple(do.shape)} {do.dtype} does not match q")
    for t, what in ((lse, "lse"), (delta, "delta")):
        _require(tuple(t.shape) == (n, sq) and t.dtype == torch.float32,
                 f"{name}: {what} must be (n, sq) fp32, got "
                 f"{tuple(t.shape)} {t.dtype}")
    return n, sq, sk, d


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, scale: float, dropout_rate: float = 0.0,
                 seed: Optional[int] = None) -> torch.Tensor:
    """``dq (n, sq, d)`` in q's dtype from ``q``, ``k``, ``v`` and ``do``
    as for :func:`flash_fwd`, the forward's ``lse (n, sq)`` and ``delta =
    rowsum(do * out) (n, sq)``, both fp32."""
    n, sq, sk, d = _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.apex_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, sq, sk, d,
            _DTYPE_CODE[q.dtype], int(causal), float(scale), *drop, stream)
    _check_launch("flash_bwd_dq", err)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float, dropout_rate: float = 0.0,
                  seed: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, each ``(n, sk, d)`` in k's dtype, from the inputs of
    :func:`flash_bwd_dq`."""
    n, sq, sk, d = _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    drop = _dropout_args(dropout_rate, seed)
    lib, _ = build()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.apex_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            n, sq, sk, d, _DTYPE_CODE[q.dtype], int(causal), float(scale),
            *drop, stream)
    _check_launch("flash_bwd_dkv", err)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor],
                     v_scale: Optional[torch.Tensor], scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q (n, q_len, d)`` bf16/fp32 over ``k``/``v`` ``(n, T, d)``
    (bf16, fp32, or int8 with ``(n, T)`` fp32 scales) masked by ``lengths
    (n,)`` int32 -> ``(out (n, q_len, d) in q.dtype, lse (n, q_len))``."""
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
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"decode_attention: head dim {d} is not one of {_HEAD_DIMS}")
    _require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
             "decode_attention: cache rows must be 16-byte aligned")
    _require(n > 0 and q_len > 0, "decode_attention: empty batch or query")
    lib, _ = build()
    out = torch.empty_like(q)
    lse = torch.empty((n, q_len), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.apex_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(), n, q_len, T,
            d, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], float(scale),
            stream)
    _check_launch("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out, lse
