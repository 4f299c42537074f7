"""Native host pieces of the port (C++, loaded with ``ctypes``).

Counterpart of ``apex_tpu/_native/``: apex's ``apex_C`` host buffer
packing (``flatten``, ``unflatten``) and the sampler's row gather, over
numpy arrays. The shared object is built at first use from this package's
``flatten.cpp`` with the system C++ compiler (``$CXX``, default ``g++``)
into ``apex_tpu_torch/_build/``, keyed by a hash of the source, never
beside the source; where no compiler works, every function takes its
numpy path, and :func:`native_available` says which path is in use.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["flatten", "unflatten", "gather_rows", "native_available"]

_SRC = pathlib.Path(__file__).resolve().parent / "flatten.cpp"
_BUILD = _SRC.parent.parent / "_build"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _library_path() -> pathlib.Path:
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libapex_native_{key}.so"


def _build(path: pathlib.Path) -> bool:
    """Compile the source into ``path``: written under a temporary name,
    then renamed, so processes building at once never load a partial
    file."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC", "-o",
           tmp, str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        ptrs, sizes = ctypes.c_void_p, ctypes.c_size_t
        lib.apex_tpu_flatten.argtypes = [ctypes.POINTER(ptrs),
                                         ctypes.POINTER(sizes), sizes, ptrs]
        lib.apex_tpu_flatten.restype = sizes
        lib.apex_tpu_unflatten.argtypes = [ptrs, ctypes.POINTER(ptrs),
                                           ctypes.POINTER(sizes), sizes]
        lib.apex_tpu_unflatten.restype = sizes
        lib.apex_tpu_gather_rows.argtypes = [ptrs, sizes, ptrs, sizes, ptrs]
        lib.apex_tpu_gather_rows.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """Whether the compiled library is in use (else the numpy paths)."""
    return _load() is not None


def _ptr_array(arrays: Sequence[np.ndarray], writable: bool):
    ptrs = (ctypes.c_void_p * len(arrays))()
    sizes = (ctypes.c_size_t * len(arrays))()
    for i, a in enumerate(arrays):
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("arrays must be C-contiguous")
        if writable and not a.flags["WRITEABLE"]:
            raise ValueError("destination arrays must be writable")
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
        sizes[i] = a.nbytes
    return ptrs, sizes


def flatten(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate host arrays' bytes into one contiguous uint8 buffer
    (``apex_C.flatten``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    total = sum(a.nbytes for a in arrays)
    out = np.empty(total, np.uint8)
    lib = _load()
    if lib is None:
        off = 0
        for a in arrays:
            out[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
            off += a.nbytes
        return out
    ptrs, sizes = _ptr_array(arrays, writable=False)
    lib.apex_tpu_flatten(ptrs, sizes, len(arrays),
                         out.ctypes.data_as(ctypes.c_void_p))
    return out


def unflatten(flat: np.ndarray, like: Sequence[np.ndarray]
              ) -> List[np.ndarray]:
    """Split a flat byte buffer back into arrays shaped and typed like
    ``like`` (``apex_C.unflatten``); a buffer shorter than they need
    raises ``ValueError``."""
    flat = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    outs = [np.empty(a.shape, a.dtype) for a in like]
    total = sum(o.nbytes for o in outs)
    if flat.nbytes < total:
        raise ValueError(f"flat buffer too small: {flat.nbytes} < {total}")
    lib = _load()
    if lib is None:
        off = 0
        for o in outs:
            o.view(np.uint8).reshape(-1)[:] = flat[off:off + o.nbytes]
            off += o.nbytes
        return outs
    ptrs, sizes = _ptr_array(outs, writable=True)
    lib.apex_tpu_unflatten(flat.ctypes.data_as(ctypes.c_void_p), ptrs,
                           sizes, len(outs))
    return outs


def gather_rows(src: np.ndarray, indices: Sequence[int]) -> np.ndarray:
    """``dst[i] = src[indices[i]]`` over axis 0 (one memcpy a row); 2-D
    indices raise ``ValueError``, indices out of range ``IndexError``."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(np.asarray(indices, np.int64))
    if idx.ndim != 1:
        raise ValueError("indices must be 1-D")
    if src.ndim < 1:
        raise ValueError("src must have a leading sample axis")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("index out of range")
    out = np.empty((idx.size,) + src.shape[1:], src.dtype)
    lib = _load()
    if lib is None:
        np.take(src, idx, axis=0, out=out)
        return out
    row_bytes = src.nbytes // max(src.shape[0], 1)
    lib.apex_tpu_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p), row_bytes,
        idx.ctypes.data_as(ctypes.c_void_p), idx.size,
        out.ctypes.data_as(ctypes.c_void_p))
    return out
