"""Checkpoint and resume: the port's ``apex_tpu/checkpoint.py``.

The directory protocol is the reference's, byte for byte where it is
text: ``step_{:08d}`` directories, each with a ``host.json`` sidecar
(``{"step", "fp32_on_disk", "host_state"}``) and a ``COMMITTED`` marker
written last, after a barrier across the ranks, so a checkpoint a writer
died in (a torn directory) is never taken for a whole one:
:func:`all_steps` and :func:`latest_step` see only committed steps,
:func:`restore_checkpoint` skips torn ones with the reference's
``UserWarning``, and ``keep_last`` pruning never deletes a torn one.

The arrays differ from the reference's orbax store, so neither package
reads the other's arrays (the text files read alike in both). They are
per-rank ``torch.save`` files under ``state/``, read back with
``weights_only=True``, each leaf keyed by its path in the state tree
(``torch.utils._pytree.keystr``; torch's pytree keeps a dict's order where
JAX sorts keys, so a position would not do), and
``state/index.json`` records every leaf's kind, dtype and shape and the
(pipe, data, context, tensor) grid it was saved from. Each rank writes
only what it owns:

- a ZeRO leaf (the ``master``, ``exp_avg`` and ``exp_avg_sq`` shards of a
  :class:`~apex_tpu_torch.optimizers.ZeroAdamState` in the tree) by every
  rank of context index 0, to ``zero_{i:05d}.pt`` with ``i`` its place in
  (pipe, data, tensor) order, so the concatenation of the files is the
  reference's global array, which :mod:`apex_tpu_torch.elastic.reshard`
  re-partitions;
- every other leaf (replicated over the data and context axes, and a
  rank's own shard on the tensor and pipe axes) by the ranks of data and
  context index 0, to ``model_p{p:03d}_t{t:03d}.pt``; without tensor or
  pipeline parallelism that is rank 0 alone.

``fp32_on_disk`` widens fp16 and bf16 tensors to fp32 on disk and
restore narrows every leaf to the target's dtype: both casts are exact.
Other dtypes are stored as they are (the loss scaler's tensors, the
``torch.Generator`` states of the RNG tracker, uint8), and python scalars
(ZeRO's ``bucket_stamp``) ride in the files as values; a numpy array
is stored as a tensor and comes back as numpy of the target's dtype.
Save then restore is the identity on every leaf.

Barriers are ``torch.distributed.barrier`` when a process group of more
than one rank exists; each call of :func:`save_checkpoint` must then be
made by every rank.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import (keystr, tree_flatten_with_path,
                                 tree_unflatten)

__all__ = ["save_checkpoint", "restore_checkpoint", "read_host_state",
           "latest_step", "all_steps", "torn_steps"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_HOST_FILE = "host.json"
_COMMIT_FILE = "COMMITTED"
_STATE_DIR = "state"
_INDEX_FILE = "index.json"
_HALF = (torch.float16, torch.bfloat16)
_ZERO_FIELDS = ("master", "exp_avg", "exp_avg_sq")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    """A sync point across the ranks; a no-op in a world of one
    process."""
    if _world()[1] > 1:
        dist.barrier()


def _grid() -> Tuple[Dict[str, int], Dict[str, int]]:
    """This rank's index along (pipe, data, context, tensor) and the
    sizes: the installed mesh's, else the whole world as data."""
    from apex_tpu_torch.transformer import parallel_state as ps
    if ps.model_parallel_is_initialized():
        sizes = {"pipe": ps.get_pipeline_model_parallel_world_size(),
                 "data": ps.get_data_parallel_world_size(),
                 "context": ps.get_context_parallel_world_size(),
                 "tensor": ps.get_tensor_model_parallel_world_size()}
        index = {"pipe": ps.get_pipeline_model_parallel_rank(),
                 "data": ps.get_data_parallel_rank(),
                 "context": ps.get_context_parallel_rank(),
                 "tensor": ps.get_tensor_model_parallel_rank()}
        return index, sizes
    rank, world = _world()
    return ({"pipe": 0, "data": rank, "context": 0, "tensor": 0},
            {"pipe": 1, "data": world, "context": 1, "tensor": 1})


def _model_file(p: int, t: int) -> str:
    return f"model_p{p:03d}_t{t:03d}.pt"


def _zero_file(i: int) -> str:
    return f"zero_{i:05d}.pt"


def _zero_index(index: Dict[str, int], sizes: Dict[str, int]) -> int:
    return ((index["pipe"] * sizes["data"] + index["data"]) * sizes["tensor"]
            + index["tensor"])


def _zero_ids(tree: Any) -> set:
    """``id`` of every ZeRO shard tensor in ``tree``."""
    from apex_tpu_torch.optimizers.distributed_fused import ZeroAdamState
    out = set()

    def walk(node):
        if isinstance(node, ZeroAdamState):
            out.update(id(getattr(node, f)) for f in _ZERO_FIELDS)
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _leaves(tree: Any):
    """``[(key, leaf, kind)]`` of ``tree`` and its spec; kind is
    ``"zero"``, ``"model"`` (any other tensor) or ``"value"``."""
    flat, spec = tree_flatten_with_path(tree)
    zero = _zero_ids(tree)
    out = []
    for path, leaf in flat:
        if isinstance(leaf, torch.Tensor):
            kind = "zero" if id(leaf) in zero else "model"
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            kind = "model"
        else:
            kind = "value"
        out.append((keystr(path), leaf, kind))
    return out, spec


def _stored(leaf, fp32_on_disk: bool):
    t = torch.as_tensor(leaf).detach()
    if fp32_on_disk and t.dtype in _HALF:
        t = t.float()
    return t.to("cpu", copy=True).contiguous()


def _write(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def all_steps(directory: str) -> list:
    """Committed checkpoint steps in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(
                os.path.join(directory, name, _COMMIT_FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def torn_steps(directory: str) -> list:
    """Steps of torn checkpoint directories (present without their
    COMMITTED marker), ascending; invisible to :func:`all_steps` and
    :func:`latest_step`, skipped with a warning by
    :func:`restore_checkpoint`."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and not os.path.exists(
                os.path.join(directory, name, _COMMIT_FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, state: Any, step: int, *,
                    fp32_on_disk: bool = True,
                    host_state: Optional[Dict[str, Any]] = None,
                    keep: Optional[int] = None,
                    keep_last: Optional[int] = None) -> str:
    """Write ``state`` (a tree of tensors and python scalars) at ``step``;
    returns the checkpoint's path. ``host_state`` must be
    JSON-serializable. ``keep_last=N`` (N >= 1) prunes all but the newest
    N committed checkpoints once this one commits; a torn directory is
    never pruned. ``keep`` is the reference's older spelling of
    ``keep_last``.

    Every rank of a process group calls it; rank 0 clears the step's
    directory, writes ``host.json``, the index and ``COMMITTED`` and
    prunes, fenced by barriers: before any rank writes, once every rank's
    files are written (so ``COMMITTED`` never precedes a rank's arrays),
    and after the marker (so no rank returns before it is visible)."""
    if keep is not None and keep_last is not None and keep != keep_last:
        raise ValueError(
            f"keep={keep} and keep_last={keep_last} are the same parameter "
            "spelled twice; pass only keep_last")
    if keep_last is None:
        keep_last = keep
    if keep_last is not None and keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    lead = _world()[0] == 0
    path = _step_dir(directory, step)
    arrays = os.path.join(path, _STATE_DIR)
    if lead:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(arrays, exist_ok=True)
    # no rank writes into a directory the lead is still clearing
    _barrier()

    index, sizes = _grid()
    leaves, _ = _leaves(state)
    model_owner = index["data"] == 0 and index["context"] == 0
    model, zero, meta = {}, {}, {}
    for key, leaf, kind in leaves:
        if kind == "value":
            model[key] = leaf
            meta[key] = {"kind": kind}
            continue
        t = _stored(leaf, fp32_on_disk)
        (zero if kind == "zero" else model)[key] = t
        meta[key] = {"kind": kind, "dtype": str(t.dtype).split(".")[-1],
                     "shape": list(t.shape)}
    if model_owner:
        _write(os.path.join(arrays, _model_file(index["pipe"],
                                                index["tensor"])), model)
    if zero and index["context"] == 0:
        _write(os.path.join(arrays, _zero_file(_zero_index(index, sizes))),
               zero)

    # every rank's files are written before COMMITTED can exist
    _barrier()
    if lead:
        with open(os.path.join(arrays, _INDEX_FILE), "w") as f:
            json.dump({"grid": sizes, "leaves": meta}, f)
        meta = {"step": int(step), "fp32_on_disk": bool(fp32_on_disk),
                "host_state": host_state if host_state is not None else {}}
        tmp = os.path.join(path, _HOST_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, _HOST_FILE))
        # the marker last: a checkpoint without it is never restored
        with open(os.path.join(path, _COMMIT_FILE), "w") as f:
            f.write("ok\n")
        if keep_last is not None:
            # only committed steps are listed: a torn directory another
            # writer may still own is never pruned
            steps = all_steps(directory)
            for old in steps[:max(len(steps) - keep_last, 0)]:
                shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    # no rank returns before the marker is visible
    _barrier()
    return path


def read_host_state(directory: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, Any]]:
    """``(step, host_state)`` of the checkpoint at ``step`` (default the
    latest committed one) without reading any array: an elastic restart
    reads the saved world here before it builds its restore target."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory!r}")
    path = _step_dir(directory, step)
    if not os.path.exists(os.path.join(path, _COMMIT_FILE)):
        raise FileNotFoundError(f"checkpoint at {path!r} is not committed")
    with open(os.path.join(path, _HOST_FILE)) as f:
        meta = json.load(f)
    return int(step), meta.get("host_state", {})


def _target_device(leaf) -> torch.device:
    dev = getattr(leaf, "device", None)
    if dev is None or torch.device(dev).type == "meta":
        return torch.device("cpu")
    return torch.device(dev)


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None
                       ) -> Tuple[Any, Dict[str, Any]]:
    """The checkpoint at ``step`` (default the latest committed one) in
    the structure of ``target``; returns ``(state, host_state)``.

    ``target`` is a tree like the saved one whose tensor leaves (meta
    tensors too) give each restored leaf's shape, dtype and device (a
    meta tensor's lands on the CPU). A model leaf is read from this
    rank's (pipe, tensor) file, so the saved grid's pipe and tensor sizes
    must be this world's. A ZeRO leaf whose target has the saved shard's
    shape, on the saved grid, is this rank's shard; one whose target has
    the whole of the saved shards' elements is their concatenation in
    (pipe, data, tensor) order (the reference's global array, for
    :func:`~apex_tpu_torch.elastic.reshard.reshard_zero_state`).

    Torn directories are skipped, not an error: the latest step falls
    back to the newest committed one, and a ``UserWarning`` names every
    torn step it skipped over. Only a torn ``step=`` asked for by number
    raises."""
    if step is None:
        step = latest_step(directory)
        torn = torn_steps(directory)
        skipped = [s for s in torn if step is None or s > step]
        if skipped:
            warnings.warn(
                f"skipping torn (uncommitted) checkpoint dir(s) at step(s) "
                f"{skipped} under {directory!r}; "
                + (f"falling back to committed step {step}" if step
                   is not None else "no committed checkpoint remains"))
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory!r}"
                + (f" (only torn dirs at steps {torn})" if torn else ""))
    path = _step_dir(directory, step)
    if not os.path.exists(os.path.join(path, _COMMIT_FILE)):
        raise FileNotFoundError(f"checkpoint at {path!r} is not committed")
    with open(os.path.join(path, _HOST_FILE)) as f:
        host = json.load(f).get("host_state", {})
    arrays = os.path.join(path, _STATE_DIR)
    with open(os.path.join(arrays, _INDEX_FILE)) as f:
        saved = json.load(f)
    grid, meta = saved["grid"], saved["leaves"]
    index, sizes = _grid()
    files: Dict[str, dict] = {}

    def load(name: str) -> dict:
        if name not in files:
            files[name] = torch.load(os.path.join(arrays, name),
                                     map_location="cpu", weights_only=True)
        return files[name]

    leaves, spec = _leaves(target)
    out = []
    for key, leaf, kind in leaves:
        if key not in meta:
            raise ValueError(f"leaf {key} is not in the checkpoint at "
                             f"{path!r}")
        kind_saved = meta[key]["kind"]
        if kind_saved != "zero":
            if (grid["pipe"], grid["tensor"]) != (sizes["pipe"],
                                                  sizes["tensor"]):
                raise ValueError(
                    f"leaf {key} was saved at pipe x tensor "
                    f"{grid['pipe']} x {grid['tensor']}; this world is "
                    f"{sizes['pipe']} x {sizes['tensor']}")
            t = load(_model_file(index["pipe"], index["tensor"]))[key]
            if kind == "value" or kind_saved == "value":
                out.append(t)
                continue
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {key} is {tuple(t.shape)} in the "
                                 f"checkpoint, {tuple(leaf.shape)} in the "
                                 "target")
        else:
            shard = tuple(meta[key]["shape"])
            count = grid["pipe"] * grid["data"] * grid["tensor"]
            if tuple(leaf.shape) == shard and all(
                    grid[a] == sizes[a] for a in ("pipe", "data", "tensor")):
                t = load(_zero_file(_zero_index(index, sizes)))[key]
            elif leaf.numel() == count * torch.Size(shard).numel():
                t = torch.cat([load(_zero_file(i))[key].reshape(-1)
                               for i in range(count)]).reshape(leaf.shape)
            else:
                raise ValueError(
                    f"ZeRO leaf {key}: target shape {tuple(leaf.shape)} is "
                    f"neither the saved shard {shard} on the saved grid "
                    f"{grid} nor the {count} shards together")
        if isinstance(leaf, torch.Tensor):
            out.append(t.to(device=_target_device(leaf), dtype=leaf.dtype))
        else:
            # a numpy leaf comes back as numpy of the target's dtype (a
            # numpy scalar as a scalar)
            arr = t.numpy().astype(leaf.dtype)
            out.append(arr[()] if isinstance(leaf, np.generic) else arr)
    return tree_unflatten(out, spec), host
