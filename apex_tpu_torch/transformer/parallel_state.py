"""Model-parallel process-group state.

Counterpart of ``apex_tpu/transformer/parallel_state.py``. The reference
reshapes its device list into one mesh with the axes ``("pipe", "data",
"context", "tensor")``, tensor fastest, then context, then data, then
pipeline, and names the axes inside ``shard_map``. The port lays the
ranks of the ``torch.distributed`` world out the same way, as a
:class:`torch.distributed.device_mesh.DeviceMesh` with those dim names,
and an axis name resolves to *this rank's* process group along that dim
(:func:`resolve_axis`; a ``ProcessGroup`` passes through). So the rank
arithmetic, the group lists and the stage predicates are the
reference's, and the ranks are plain ints where the reference traces
``lax.axis_index``.

Call :func:`initialize_model_parallel` after
``torch.distributed.init_process_group``, on every rank alike (torch
makes every group on every rank, in one order). In a world that spans
several nodes (``LOCAL_WORLD_SIZE`` ranks a node, as ``torchrun`` sets
it) the data axis goes outermost over the nodes and tensor, pipeline and
context stay inside a node, as :func:`_dcn_device_grid` gives it
(the reference's rule by process).

The data axis carries data parallelism and ZeRO; the tensor axis the
tensor- and sequence-parallel layers, their mappings and the ring
collective matmuls; the pipe axis the pipeline schedules' stage hops and
the shared parameters' grad sum; the context axis ring and Ulysses
attention (:mod:`apex_tpu_torch.transformer.context_parallel`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize_model_parallel", "destroy_model_parallel",
    "model_parallel_is_initialized", "get_mesh",
    "get_tensor_model_parallel_world_size", "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size", "get_virtual_pipeline_model_parallel_world_size",
    "get_tensor_model_parallel_rank", "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "is_pipeline_first_stage", "is_pipeline_last_stage",
    "is_rank_in_embedding_group",
    "get_pipeline_model_parallel_next_rank", "get_pipeline_model_parallel_prev_rank",
    "get_pipeline_model_parallel_split_rank",
    "set_pipeline_model_parallel_split_rank",
    "get_context_parallel_world_size", "get_context_parallel_rank",
    "get_context_parallel_groups",
    "get_tensor_model_parallel_groups", "get_data_parallel_groups",
    "get_pipeline_model_parallel_groups", "get_embedding_ranks",
    "get_rank_info",
    "get_tensor_model_parallel_group", "get_pipeline_model_parallel_group",
    "get_data_parallel_group", "get_context_parallel_group",
    "resolve_axis", "axis_columns",
    "PIPE_AXIS", "DATA_AXIS", "CONTEXT_AXIS", "TENSOR_AXIS",
]

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
CONTEXT_AXIS = "context"
TENSOR_AXIS = "tensor"
AXES = (PIPE_AXIS, DATA_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

_MESH = None
_GRID: Optional[np.ndarray] = None      # (pp, dp, cp, tp) global ranks
_VIRTUAL_PP_SIZE: Optional[int] = None
_VIRTUAL_PP_RANK: Optional[int] = None
_PP_SPLIT_RANK: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RankSlot:
    """A rank as the layout sees it: its global rank (``id``) and the
    index of the node (process in the reference) that holds it. Not a
    tuple, so numpy keeps it whole in an object array."""
    id: int
    process_index: int


def _dcn_device_grid(devices: Sequence, tp: int, pp: int, cp: int,
                     dp: int) -> np.ndarray:
    """The data axis outermost over the nodes, tensor, pipeline and
    context inside a node (the reference's rule, by node here).

    The devices are grouped by ``process_index`` (equal counts a node);
    ``dp = nodes x dp_local``; each node's devices, sorted by ``id``, are
    laid out ``(dp_local, pp, cp, tp)`` with tp fastest, and the node
    index becomes the outermost factor of the data axis. Returns the
    ``(pp, dp, cp, tp)`` grid of the device objects."""
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    procs = sorted(by_proc)
    nproc = len(procs)
    counts = {len(by_proc[p]) for p in procs}
    if len(counts) != 1:
        raise RuntimeError(
            f"uneven per-process device counts "
            f"{ {p: len(by_proc[p]) for p in procs} } — the DCN layout "
            f"needs identical local topology on every process")
    per = counts.pop()
    if dp % nproc != 0:
        raise RuntimeError(
            f"data-parallel size {dp} is not divisible by the process "
            f"count {nproc}: dp is the axis that spans the DCN, so every "
            f"process must hold the same number of dp ranks")
    dp_local = dp // nproc
    if per != dp_local * pp * cp * tp:
        raise RuntimeError(
            f"per-process device count {per} != dp_local({dp_local}) x "
            f"pp({pp}) x cp({cp}) x tp({tp}) — tensor/pipeline/context "
            f"axes must fit inside one process (only dp spans the DCN)")
    local = [sorted(by_proc[p], key=lambda d: getattr(d, "id", 0))
             for p in procs]
    natural = np.empty((nproc, per), dtype=object)
    for i, devs in enumerate(local):
        natural[i, :] = devs
    natural = natural.reshape(nproc, dp_local, pp, cp, tp)
    # (proc, dp_local, pp, cp, tp) -> (pp, proc x dp_local = dp, cp, tp)
    return natural.transpose(2, 0, 1, 3, 4).reshape(pp, dp, cp, tp)


def _world_slots() -> List[RankSlot]:
    """Every rank of the world with its node: ``LOCAL_WORLD_SIZE`` ranks
    a node (one node when it is not set)."""
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    return [RankSlot(r, r // max(per_node, 1)) for r in range(world)]


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    pipeline_model_parallel_split_rank: Optional[int] = None,
    context_parallel_size: int = 1,
    devices: Optional[Sequence] = None,
    dcn_data_parallel: Optional[bool] = None,
):
    """Lay the world out and install the mesh; returns the
    ``DeviceMesh``.

    ``devices`` defaults to every rank of the initialized world (with its
    node from ``LOCAL_WORLD_SIZE``); it may be a list of global ranks or
    of objects with ``id`` and ``process_index``, and must hold every
    rank once. dp is ``world / (tp * pp * cp)``. ``dcn_data_parallel``
    ``None`` takes the node layout when the ranks span more than one
    node; otherwise the grid is ``arange(world).reshape(pp, dp, cp,
    tp)``, the reference's single-process layout."""
    global _MESH, _GRID, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK, _PP_SPLIT_RANK
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "init_process_group before initialize_model_parallel")
    if devices is None:
        devices = _world_slots()
    devices = [RankSlot(d, 0) if isinstance(d, int) else d for d in devices]
    world = len(devices)
    if sorted(int(d.id) for d in devices) != list(
            range(dist.get_world_size())):
        raise ValueError(
            f"devices must hold every rank of the world "
            f"({dist.get_world_size()}) once, got "
            f"{sorted(int(d.id) for d in devices)}")
    tp, pp = tensor_model_parallel_size, pipeline_model_parallel_size
    cp = context_parallel_size
    if world % (tp * pp * cp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor ({tp}) x "
            f"pipeline ({pp}) x context ({cp}) parallel sizes")
    dp = world // (tp * pp * cp)
    if virtual_pipeline_model_parallel_size is not None and pp < 2:
        raise RuntimeError(
            "pipeline-model-parallel size must be at least 2 with the "
            "interleaved schedule")
    if dcn_data_parallel is None:
        dcn_data_parallel = len(
            {getattr(d, "process_index", 0) for d in devices}) > 1
    if dcn_data_parallel:
        grid = np.vectorize(lambda d: int(d.id), otypes=[np.int64])(
            _dcn_device_grid(devices, tp, pp, cp, dp))
    else:
        # the single-node layout: tp fastest, then cp, then dp, then pp
        grid = np.arange(world).reshape(pp, dp, cp, tp)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if (grid.reshape(-1) == np.arange(world)).all():
        mesh = init_device_mesh(_device_type(), (pp, dp, cp, tp),
                                mesh_dim_names=AXES)
    else:
        mesh = DeviceMesh(_device_type(), torch.from_numpy(grid),
                          mesh_dim_names=AXES)
    _MESH, _GRID = mesh, grid
    _VIRTUAL_PP_SIZE = virtual_pipeline_model_parallel_size
    _VIRTUAL_PP_RANK = 0 if virtual_pipeline_model_parallel_size else None
    _PP_SPLIT_RANK = pipeline_model_parallel_split_rank
    return mesh


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def get_mesh():
    if _MESH is None:
        raise RuntimeError("model parallel is not initialized — call "
                           "initialize_model_parallel() first")
    return _MESH


def destroy_model_parallel() -> None:
    """Forget the mesh (the groups stay with the process group, as
    torch's ``DeviceMesh`` keeps them)."""
    global _MESH, _GRID, _VIRTUAL_PP_SIZE, _VIRTUAL_PP_RANK, _PP_SPLIT_RANK
    _MESH = None
    _GRID = None
    _VIRTUAL_PP_SIZE = None
    _VIRTUAL_PP_RANK = None
    _PP_SPLIT_RANK = None


def _size(axis: str) -> int:
    return int(get_mesh().size(AXES.index(axis)))


def _rank(axis: str) -> int:
    return int(get_mesh().get_local_rank(axis))


# -- world sizes --------------------------------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    return _size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _size(PIPE_AXIS)


def get_data_parallel_world_size() -> int:
    return _size(DATA_AXIS)


def get_context_parallel_world_size() -> int:
    return _size(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PP_SIZE


# -- this rank's coordinates (ints; the reference traces them) -----------------

def get_tensor_model_parallel_rank() -> int:
    return _rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _rank(PIPE_AXIS)


def get_data_parallel_rank() -> int:
    return _rank(DATA_AXIS)


def get_context_parallel_rank() -> int:
    return _rank(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PP_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PP_RANK
    _VIRTUAL_PP_RANK = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PP_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: Optional[int]) -> None:
    global _PP_SPLIT_RANK
    _PP_SPLIT_RANK = rank


# -- stage predicates ----------------------------------------------------------

def is_pipeline_first_stage(ignore_virtual: bool = False,
                            virtual_rank=None) -> bool:
    """This rank is on the first stage (and, with an interleaved
    schedule, on its first chunk: ``virtual_rank`` or the module's
    virtual rank is 0)."""
    first = get_pipeline_model_parallel_rank() == 0
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        vr = _VIRTUAL_PP_RANK if virtual_rank is None else virtual_rank
        first = first and vr == 0
    return first


def is_pipeline_last_stage(ignore_virtual: bool = False,
                           virtual_rank=None) -> bool:
    """See :func:`is_pipeline_first_stage` for ``virtual_rank``."""
    last = (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)
    if not ignore_virtual and _VIRTUAL_PP_SIZE is not None:
        vr = _VIRTUAL_PP_RANK if virtual_rank is None else virtual_rank
        last = last and vr == _VIRTUAL_PP_SIZE - 1
    return last


def is_rank_in_embedding_group(pipeline_rank) -> bool:
    """The first and last stages tie their embedding grads; takes a
    pipeline rank."""
    return pipeline_rank in (0, get_pipeline_model_parallel_world_size() - 1)


def get_pipeline_model_parallel_next_rank() -> int:
    """The next stage's pipeline rank."""
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() + 1) % pp


def get_pipeline_model_parallel_prev_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() - 1) % pp


# -- group lists (global ranks) -------------------------------------------------

def _global_rank(pp_r: int, dp_r: int, tp_r: int, cp_r: int = 0) -> int:
    tp = get_tensor_model_parallel_world_size()
    cp = get_context_parallel_world_size()
    dp = get_data_parallel_world_size()
    return tp_r + tp * (cp_r + cp * (dp_r + dp * pp_r))


def _sizes() -> Tuple[int, int, int, int]:
    return (get_tensor_model_parallel_world_size(),
            get_context_parallel_world_size(),
            get_data_parallel_world_size(),
            get_pipeline_model_parallel_world_size())


def get_tensor_model_parallel_groups() -> List[List[int]]:
    """The reference's tensor groups, as lists of global ranks."""
    tp, cp, dp, pp = _sizes()
    return [[_global_rank(p, d, t, c) for t in range(tp)]
            for p in range(pp) for d in range(dp) for c in range(cp)]


def get_data_parallel_groups() -> List[List[int]]:
    tp, cp, dp, pp = _sizes()
    return [[_global_rank(p, d, t, c) for d in range(dp)]
            for p in range(pp) for c in range(cp) for t in range(tp)]


def get_context_parallel_groups() -> List[List[int]]:
    tp, cp, dp, pp = _sizes()
    return [[_global_rank(p, d, t, c) for c in range(cp)]
            for p in range(pp) for d in range(dp) for t in range(tp)]


def get_pipeline_model_parallel_groups() -> List[List[int]]:
    tp, cp, dp, pp = _sizes()
    return [[_global_rank(p, d, t, c) for p in range(pp)]
            for d in range(dp) for c in range(cp) for t in range(tp)]


def get_embedding_ranks() -> List[List[int]]:
    """The first and last stage of each (dp, cp, tp) column."""
    tp, cp, dp, pp = _sizes()
    cols = [(d, c, t) for d in range(dp) for c in range(cp)
            for t in range(tp)]
    if pp == 1:
        return [[_global_rank(0, d, t, c)] for d, c, t in cols]
    return [[_global_rank(0, d, t, c), _global_rank(pp - 1, d, t, c)]
            for d, c, t in cols]


def get_rank_info() -> Tuple[int, int, int, Optional[int]]:
    """(dp, tp, pp, vpp) sizes for log prefixes."""
    if not model_parallel_is_initialized():
        return (1, 1, 1, None)
    return (get_data_parallel_world_size(),
            get_tensor_model_parallel_world_size(),
            get_pipeline_model_parallel_world_size(),
            _VIRTUAL_PP_SIZE)


# -- process groups ------------------------------------------------------------

def get_tensor_model_parallel_group():
    return get_mesh().get_group(TENSOR_AXIS)


def get_pipeline_model_parallel_group():
    return get_mesh().get_group(PIPE_AXIS)


def get_data_parallel_group():
    return get_mesh().get_group(DATA_AXIS)


def get_context_parallel_group():
    return get_mesh().get_group(CONTEXT_AXIS)


def resolve_axis(axis: Any):
    """The process group an axis names, for this rank: a mesh axis name
    (``"data"``, ``"tensor"``, ``"pipe"``, ``"context"``) gives this
    rank's group along that dim; a ``ProcessGroup`` passes through. An
    axis that is not bound (an unknown name, or any name before
    :func:`initialize_model_parallel`) raises ``ValueError``, as an
    unbound axis name does in the reference."""
    if isinstance(axis, dist.ProcessGroup):
        return axis
    if not isinstance(axis, str):
        raise ValueError(f"an axis is a mesh axis name or a ProcessGroup, "
                         f"got {axis!r}")
    if axis not in AXES:
        raise ValueError(f"axis name {axis!r} is not bound: the mesh's "
                         f"axes are {AXES}")
    if _MESH is None:
        raise ValueError(
            f"axis name {axis!r} is not bound: parallel_state is not "
            "initialized (call initialize_model_parallel first)")
    return _MESH.get_group(axis)


def axis_columns(axis: Any) -> List[List[int]]:
    """Every group along ``axis`` as lists of global ranks, each in
    axis-index order, together covering the world: the mesh's columns
    for an axis name, the group itself for a ``ProcessGroup`` that spans
    the world. Subgroups (``axis_index_groups``) are cut from these."""
    if isinstance(axis, dist.ProcessGroup):
        ranks = dist.get_process_group_ranks(axis)
        if len(ranks) != dist.get_world_size():
            raise ValueError(
                "axis_index_groups over a ProcessGroup need one that spans "
                f"the world ({dist.get_world_size()} ranks), got {ranks}")
        return [list(ranks)]
    resolve_axis(axis)
    grid = np.moveaxis(_GRID, AXES.index(axis), -1)
    return [list(map(int, col)) for col in grid.reshape(-1, grid.shape[-1])]
