"""Numerics watchdog: per-leaf NaN/overflow attribution, replica agreement
and structured crash dumps.

Counterpart of ``apex_tpu/observability/health.py``. The amp scaler's
one finite flag (:func:`apex_tpu_torch.amp.all_finite`) says *that* a
step overflowed; this module says *which leaf*, *how badly*, and *whether
the replicas still agree*:

- :func:`tensor_stats`: a pass over a tree's floating leaves giving, per
  leaf, the non-finite count (int64: exact however large the leaf), the
  largest magnitude (NaN when the leaf holds one), the fp32 sum of squares
  of its finite values and, for fp16/bf16 leaves, the count of nonzero
  values below the dtype's smallest normal; a :class:`TreeStats` of
  stacked ``(num_leaves,)`` tensors on the leaves' device;
- :func:`observe_tree`: records a tree's ``health/<tree>/*`` scalars into
  the open in-step collector (:mod:`apex_tpu_torch.observability.
  ingraph`), among them ``first_nonfinite_leaf``, an index computed on the
  device (-1 when clean) that :func:`decode_attribution` maps back to the
  leaf's path on the host;
- :func:`check_replica_agreement`/:func:`observe_replica_agreement`: the
  largest ``|x - mean over replicas(x)|`` over a tree's leaves, one
  all-reduce a leaf over the groups of mesh axis names
  (:func:`~apex_tpu_torch.transformer.parallel_state.resolve_axis`);
- :class:`HealthConfig` and :class:`HealthMonitor`: the policy that the
  optimizers, DDP and :class:`~apex_tpu_torch.training.GPTHybridTrainer`
  read, and the :class:`~apex_tpu_torch.observability.report.StepReporter`
  hook that reacts to a non-finite step (skip, dump a :class:`CrashDump`,
  or raise :class:`NonFiniteError`).

Leaf order and paths are JAX's: a dict's keys are visited sorted (an
``OrderedDict``'s in order), a list's or tuple's items by index, a named
tuple's fields by name; a path is JAX's ``keystr`` (``['a'][0].field``).
So the same tree of arrays gives the same leaf index and path in both
packages; for a module's ``dict(named_parameters())`` the path is
``['<parameter name>']``.

**Zero cost when off.** The instrumented call sites (``all_finite``,
``OptimizerBase.step``, ``allreduce_grads``, the hybrid trainer) call the
``observe_*`` functions, which return before they touch their arguments
unless a policy at a high enough level is active (:func:`activate`) *and*
a collector is open (:func:`~apex_tpu_torch.observability.ingraph.
recording`). The reference checks these gates when it traces the step;
the port runs eagerly and checks them at each call. Nothing is read back
to the host inside the step: counts, maxima and the first index stay
tensors until the reporter's one :meth:`Metrics.as_floats`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import platform
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.observability import ingraph
from apex_tpu_torch.observability.sinks import json_safe_metrics

__all__ = [
    "LEVELS", "ON_NONFINITE", "HealthConfig", "HealthMonitor",
    "TreeStats", "tensor_stats", "observe_tree",
    "check_replica_agreement", "observe_replica_agreement",
    "decode_attribution", "leaf_paths", "payload_nonfinite",
    "CrashDump", "NonFiniteError",
    "activate", "active", "active_level",
]

LEVELS = ("off", "cheap", "full")
ON_NONFINITE = ("raise", "dump", "skip")


# -- policy ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Numerics-watchdog policy.

    ``level``: ``"off"`` adds nothing to a step; ``"cheap"`` adds the
    per-leaf stats and attribution of the amp grad check (one more pass
    over the grads); ``"full"`` also watches the optimizer's grads and the
    updated params and runs the replica-agreement checks (an all-reduce a
    leaf: a debugging tier).

    ``on_nonfinite``, the host's reaction to a reported non-finite step
    (:class:`HealthMonitor`): ``"skip"`` trusts the skip that already
    dropped the update, ``"dump"`` also writes a :class:`CrashDump` to
    ``dump_dir``, ``"raise"`` writes it and raises
    :class:`NonFiniteError`.

    ``consecutive``: the monitor fires only after this many non-finite
    reports in a row (a clean one resets the streak). Dynamic loss scaling
    overflows on purpose every ``growth_interval`` steps and backs off the
    next; real divergence stays non-finite. 1 fires at once (bf16, no
    scaler-driven overflow); fp16 dynamic-scale runs should set 2 or more.
    """

    level: str = "off"
    on_nonfinite: str = "skip"
    dump_dir: Union[str, os.PathLike] = "."
    consecutive: int = 1

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, "
                             f"got {self.level!r}")
        if self.on_nonfinite not in ON_NONFINITE:
            raise ValueError(f"on_nonfinite must be one of {ON_NONFINITE}, "
                             f"got {self.on_nonfinite!r}")
        if self.consecutive < 1:
            raise ValueError("consecutive must be >= 1, "
                             f"got {self.consecutive!r}")

    @property
    def enabled(self) -> bool:
        return self.level != "off"

    def reporter_hook(self) -> "HealthMonitor":
        """The ``StepReporter(hooks=[...])`` callable enforcing
        ``on_nonfinite`` on every reported payload."""
        return HealthMonitor(self)


class _State(threading.local):
    def __init__(self):
        self.stack: List[HealthConfig] = []


_STATE = _State()


@contextlib.contextmanager
def activate(config: Optional[HealthConfig]):
    """Make ``config`` the active policy for the code run inside the
    context (``None`` or ``level="off"`` activates nothing: the gates stay
    shut)."""
    if config is None or not config.enabled:
        yield
        return
    _STATE.stack.append(config)
    try:
        yield
    finally:
        popped = _STATE.stack.pop()
        assert popped is config


def active() -> Optional[HealthConfig]:
    """The innermost active policy, or None."""
    return _STATE.stack[-1] if _STATE.stack else None


def active_level() -> str:
    cfg = active()
    return cfg.level if cfg is not None else "off"


def _live(min_level: str) -> bool:
    """Both gates: a policy at ``min_level`` or above is active, and a
    collector is open to carry the scalars out of the step."""
    cfg = active()
    if cfg is None or LEVELS.index(cfg.level) < LEVELS.index(min_level):
        return False
    return ingraph.recording()


# -- leaves in JAX's order --------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_paths(tree: Any, prefix: str = ""):
    """``(keystr path, leaf)`` of every tensor leaf, in JAX's flatten
    order (the module's docstring)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        keys = (list(tree) if isinstance(tree, collections.OrderedDict)
                else sorted(tree))
        for k in keys:
            yield from _leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves_with_paths(getattr(tree, name),
                                          f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves_with_paths(x, f"{prefix}[{i}]")


def _float_leaves_with_paths(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    return [(p, x) for p, x in _leaves_with_paths(tree)
            if x.is_floating_point()]


# -- the per-leaf stats pass -------------------------------------------------------

_HALF = (torch.float16, torch.bfloat16)


class TreeStats:
    """Per-leaf numerics of one tree: four stacked ``(num_leaves,)``
    tensors on the leaves' device, and the leaves' paths, element counts
    and which are half precision.

    ``nonfinite[i]`` counts leaf ``i``'s non-finite elements (int64, so
    one NaN in a leaf of more than 2**24 elements is never rounded away);
    :attr:`finite_count` is the reference's view of it (made on first
    read, outside the step); ``abs_max[i]`` its largest ``|x|`` (fp32;
    NaN when the leaf holds a NaN, which is the signal); ``sq_sum[i]`` the
    fp32 sum of squares of its finite elements; ``underflow_count[i]``
    (int64) its nonzero elements below the smallest normal of an fp16
    (6.1e-5) or bf16 (1.18e-38) leaf, 0 for other dtypes. The aggregate
    views below are 0-d tensors; the counts become fp32 metrics there,
    exact zero or nonzero whatever their size."""

    def __init__(self, paths: Tuple[str, ...], sizes: Tuple[int, ...],
                 half_mask: Tuple[bool, ...],
                 nonfinite, abs_max, sq_sum, underflow_count):
        self.paths = tuple(paths)
        self.sizes = tuple(int(s) for s in sizes)
        self.half_mask = tuple(bool(h) for h in half_mask)
        self.nonfinite = nonfinite
        self.abs_max = abs_max
        self.sq_sum = sq_sum
        self.underflow_count = underflow_count

    @property
    def finite_count(self) -> torch.Tensor:
        """Per-leaf finite counts (int64: sizes less non-finite)."""
        return (torch.tensor(self.sizes, dtype=torch.int64).to(
            self.nonfinite.device) - self.nonfinite)

    @property
    def num_leaves(self) -> int:
        return len(self.paths)

    @property
    def total_size(self) -> int:
        return sum(self.sizes)

    def nonfinite_count(self) -> torch.Tensor:
        """Non-finite elements over every leaf (fp32 0-d; 0 iff clean)."""
        return self.nonfinite.sum().to(torch.float32)

    def nonfinite_flags(self) -> torch.Tensor:
        """Per-leaf bool: leaf ``i`` holds a non-finite element."""
        return self.nonfinite > 0

    def first_nonfinite_index(self) -> torch.Tensor:
        """Index (fp32 0-d) of the first leaf, in flatten order, holding a
        non-finite element; -1 when every leaf is clean."""
        flags = self.nonfinite_flags()
        first = torch.argmax(flags.to(torch.int32)).to(torch.float32)
        return torch.where(flags.any(), first, -1.0)

    def abs_max_total(self) -> torch.Tensor:
        return torch.max(self.abs_max)

    def l2(self) -> torch.Tensor:
        return torch.sqrt(torch.sum(self.sq_sum))

    def underflow_fraction(self) -> torch.Tensor:
        """Underflowed share of the tree's half-precision elements (0 when
        it holds none)."""
        half = sum(s for s, h in zip(self.sizes, self.half_mask) if h)
        if half == 0:
            return torch.zeros((), dtype=torch.float32,
                               device=self.sq_sum.device)
        return self.underflow_count.sum().to(torch.float32) / half

    def __repr__(self):
        return (f"TreeStats({self.num_leaves} leaves, "
                f"{self.total_size} elements)")


def _leaf_stats(x: torch.Tensor):
    """``(finite values, non-finite count, underflow count)`` of one
    non-empty leaf: the leaf with its non-finite values zeroed, the int64
    count of those values, and the underflow count (None for a leaf that
    is not half precision)."""
    finite = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    bad = (x != finite).sum()
    under = None
    if x.dtype in _HALF:
        tiny = torch.finfo(x.dtype).tiny
        under = ((x != 0) & (x.abs() < tiny)).sum()
    return finite, bad, under


def _norms(tensors: List[torch.Tensor], ord: float) -> List[torch.Tensor]:
    """Each tensor's fp32 norm of order ``ord`` (2, or inf: the largest
    magnitude, NaN when the tensor holds one): one multi-tensor pass on
    the card. Elsewhere the L2 norm is ``sqrt(sum(x * x))`` a tensor, since
    the CPU's norm loses accuracy over millions of fp32 values."""
    if tensors[0].is_cuda or ord != 2:
        return list(torch._foreach_norm(tensors, ord, dtype=torch.float32))
    return [torch.sqrt(torch.sum(t.to(torch.float32) ** 2))
            for t in tensors]


def tensor_stats(tree: Any) -> Optional[TreeStats]:
    """The :class:`TreeStats` of ``tree``'s floating leaves, or None when
    it has none: three kernels a leaf (its finite values, the count of the
    others), and two multi-tensor passes on the card (the largest
    magnitudes, the finite values' norms). Nothing is read back to the
    host."""
    pairs = _float_leaves_with_paths(tree)
    if not pairs:
        return None
    paths = tuple(p for p, _ in pairs)
    sizes = tuple(x.numel() for _, x in pairs)
    half_mask = tuple(x.dtype in _HALF for _, x in pairs)
    device = pairs[0][1].device
    full = [x for _, x in pairs if x.numel()]
    stats = [_leaf_stats(x) for x in full]
    amax = _norms(full, float("inf"))
    l2 = _norms([s[0] for s in stats], 2)
    bad = [s[1] for s in stats]
    unders = [s[2] for s in stats]
    if len(full) < len(pairs):
        # an empty leaf: nothing non-finite, its extremes and sums 0
        zero_i = torch.zeros((), dtype=torch.int64, device=device)
        zero_f = torch.zeros((), dtype=torch.float32, device=device)
        it = iter(range(len(full)))
        at = [next(it) if n else None for n in sizes]
        amax, l2 = ([zero_f if k is None else v[k] for k in at]
                    for v in (amax, l2))
        bad = [zero_i if k is None else bad[k] for k in at]
        unders = [None if k is None else unders[k] for k in at]
    if any(u is not None for u in unders):
        zero = torch.zeros((), dtype=torch.int64, device=device)
        under = torch.stack([zero if u is None else u for u in unders])
    else:
        under = torch.zeros(len(pairs), dtype=torch.int64, device=device)
    return TreeStats(paths, sizes, half_mask, torch.stack(bad),
                     torch.stack(amax), torch.stack(l2).square(), under)


# -- attribution side table ---------------------------------------------------------

# tree name -> leaf paths, in the order a first_nonfinite_leaf index
# counts them; written by observe_tree (the last observation wins)
_LEAF_PATHS: Dict[str, Tuple[str, ...]] = {}
_FIRST_LEAF_SUFFIX = "/first_nonfinite_leaf"


def leaf_paths(name: str) -> Optional[Tuple[str, ...]]:
    """The leaf paths recorded for tree ``name`` (None if that tree was
    never observed in this process)."""
    return _LEAF_PATHS.get(name)


def decode_attribution(payload: Dict[str, float]) -> Dict[str, str]:
    """Map every ``health/<tree>/first_nonfinite_leaf`` index in a payload
    back to the offending leaf's path: ``{tree: leaf path}`` for the trees
    that flagged (index >= 0); clean trees and unknown names are
    omitted."""
    out: Dict[str, str] = {}
    for key, value in payload.items():
        if not (key.startswith("health/")
                and key.endswith(_FIRST_LEAF_SUFFIX)):
            continue
        name = key[len("health/"):-len(_FIRST_LEAF_SUFFIX)]
        paths = _LEAF_PATHS.get(name)
        idx = int(value)
        if paths is not None and 0 <= idx < len(paths):
            out[name] = paths[idx]
    return out


# -- the gated recorders ------------------------------------------------------------

def observe_tree(tree: Any, name: str,
                 min_level: str = "cheap") -> Optional[TreeStats]:
    """Record ``health/<name>/*`` for ``tree`` into the open collector;
    returns before it touches ``tree`` unless a policy at ``min_level`` or
    above is active and a collector is open.

    Recorded, with their reductions across ranks: ``nonfinite_count``
    (sum), ``abs_max`` (max), ``l2`` (mean), ``underflow_frac`` (mean) and
    ``first_nonfinite_leaf`` (max; -1 clean). Observing a name a second
    time in one step records the second tree under ``<name>#2``, then
    ``#3``, ..., so each check keeps its attribution.
    """
    if not _live(min_level):
        return None
    stats = tensor_stats(tree)
    if stats is None:
        return None
    taken = set(ingraph.recorded_names())
    candidate, n = name, 1
    while f"health/{candidate}{_FIRST_LEAF_SUFFIX}" in taken:
        n += 1
        candidate = f"{name}#{n}"
    name = candidate
    _LEAF_PATHS[name] = stats.paths
    ingraph.record(f"health/{name}/nonfinite_count",
                   stats.nonfinite_count(), reduce="sum")
    ingraph.record(f"health/{name}/abs_max",
                   stats.abs_max_total(), reduce="max")
    ingraph.record(f"health/{name}/l2", stats.l2(), reduce="mean")
    ingraph.record(f"health/{name}/underflow_frac",
                   stats.underflow_fraction(), reduce="mean")
    ingraph.record(f"health/{name}{_FIRST_LEAF_SUFFIX}",
                   stats.first_nonfinite_index(), reduce="max")
    return stats


def check_replica_agreement(tree: Any,
                            axis_names: Union[Any, Sequence[Any]],
                            name: str = "params") -> torch.Tensor:
    """Divergence of ``tree`` across the replicas of ``axis_names`` (mesh
    axis names or process groups): the largest elementwise ``|x -
    mean over replicas(x)|`` over its floating leaves, an fp32 0-d
    tensor, recorded as ``health/<name>/replica_divergence`` (max) when a
    collector is open.

    Values replicated by construction (DDP params, synced grads) read ~0:
    the mean's summation order can differ from the identity by an ulp, so
    alert on a threshold (e.g. 1e-6 of ``health/<name>/abs_max``), not on
    nonzero. One all-reduce a leaf a group, issued together and waited on
    together; at one replica the divergence is exactly 0.
    """
    import torch.distributed as dist

    from apex_tpu_torch.transformer.parallel_state import resolve_axis
    if isinstance(axis_names, (str, dist.ProcessGroup)):
        axis_names = (axis_names,)
    groups = [resolve_axis(ax) for ax in axis_names]
    leaves = [x.to(torch.float32) for _, x in
              _float_leaves_with_paths(tree) if x.numel()]
    means = [x.clone() for x in leaves]
    for group in groups:
        works = [dist.all_reduce(m, group=group, async_op=True)
                 for m in means]
        for work in works:
            work.wait()
        world = dist.get_world_size(group)
        if world != 1:
            means = [m / world for m in means]
    devs = [torch.amax((x - m).abs()) for x, m in zip(leaves, means)]
    if devs:
        d = torch.max(torch.stack(devs))
    else:
        d = torch.zeros((), dtype=torch.float32)
    ingraph.record(f"health/{name}/replica_divergence", d, reduce="max")
    return d


def observe_replica_agreement(tree: Any,
                              axis_names: Union[Any, Sequence[Any]],
                              name: str = "params"
                              ) -> Optional[torch.Tensor]:
    """:func:`check_replica_agreement` gated at ``level="full"`` with a
    collector open (its all-reduces are real collectives, never free)."""
    if not _live("full"):
        return None
    return check_replica_agreement(tree, axis_names, name)


# -- host side: crash dumps and the reporter hook ------------------------------------

def payload_nonfinite(payload: Dict[str, float]) -> bool:
    """True when a read step payload shows non-finite values: any
    ``health/*/nonfinite_count`` above 0, or an overflow the amp scaler
    counted this step."""
    for key, value in payload.items():
        if key.startswith("health/") and key.endswith("/nonfinite_count"):
            if value > 0:
                return True
    return payload.get("amp/overflow_count", 0.0) > 0.0


def _versions() -> Dict[str, str]:
    import numpy

    import apex_tpu_torch
    out = {"python": platform.python_version(), "torch": torch.__version__,
           "numpy": numpy.__version__,
           "apex_tpu_torch": apex_tpu_torch.__version__}
    if torch.version.cuda is not None:
        out["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
    return out


@dataclasses.dataclass
class CrashDump:
    """Structured record of a failure. ``attribution`` maps each flagged
    tree to the leaf that went non-finite first; ``metrics`` is the step
    payload; ``config`` the policy; ``versions`` the software (``torch``,
    its CUDA, the port, in place of the reference's jax and jaxlib);
    ``requests`` the serving flight-recorder window (request records as
    :meth:`~apex_tpu_torch.observability.reqtrace.RequestRecord.to_dict`,
    empty for training-side dumps)."""

    step: int
    metrics: Dict[str, float]
    attribution: Dict[str, str]
    config: Dict[str, Any]
    versions: Dict[str, str]
    wall_time: float
    requests: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @classmethod
    def from_payload(cls, step: int, payload: Dict[str, float],
                     config: Optional[Any] = None,
                     requests: Sequence[Dict[str, Any]] = ()
                     ) -> "CrashDump":
        """``config`` is a policy dataclass (or None): its fields, paths
        as strings, become the dump's ``config``."""
        cfg_dict = dataclasses.asdict(config) if config is not None else {}
        cfg_dict = {k: (os.fspath(v) if isinstance(v, os.PathLike) else v)
                    for k, v in cfg_dict.items()}
        return cls(step=int(step), metrics=dict(payload),
                   attribution=decode_attribution(payload),
                   config=cfg_dict, versions=_versions(),
                   wall_time=time.time(), requests=list(requests))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def write(self, dump_dir: Union[str, os.PathLike] = ".",
              prefix: str = "health_dump") -> str:
        """Write ``<prefix>_step<N>.json`` into ``dump_dir`` (created if
        missing) as strict JSON and return its path."""
        dump_dir = os.fspath(dump_dir)
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(dump_dir,
                            f"{prefix}_step{self.step:08d}.json")
        doc = dict(self.to_dict(), metrics=json_safe_metrics(self.metrics),
                   requests=[json_safe_metrics(r) for r in self.requests])
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
        return path


class NonFiniteError(RuntimeError):
    """A reported step carried non-finite values and the policy said
    ``on_nonfinite="raise"``. Carries the :class:`CrashDump` and the path
    it was written to."""

    def __init__(self, message: str, dump: CrashDump,
                 dump_path: Optional[str] = None):
        super().__init__(message)
        self.dump = dump
        self.dump_path = dump_path


class HealthMonitor:
    """The :class:`~apex_tpu_torch.observability.report.StepReporter` hook
    enforcing a :class:`HealthConfig`'s ``on_nonfinite``. Called once a
    reported payload, after the sinks; keeps the written dumps' paths in
    ``dumps`` and the current non-finite streak in ``streak`` (it fires
    at ``config.consecutive``)."""

    def __init__(self, config: HealthConfig):
        self.config = config
        self.dumps: List[str] = []
        self.streak = 0

    def __call__(self, step: int, payload: Dict[str, float]) -> None:
        if self.config.on_nonfinite == "skip":
            return  # the on-device skip already dropped the update
        if not payload_nonfinite(payload):
            self.streak = 0
            return
        self.streak += 1
        if self.streak < self.config.consecutive:
            return  # may be a routine loss-scale calibration overflow
        dump = CrashDump.from_payload(step, payload, self.config)
        path = dump.write(self.config.dump_dir)
        self.dumps.append(path)
        if self.config.on_nonfinite == "raise":
            att = ", ".join(f"{k} -> {v}" for k, v in
                            dump.attribution.items()) or "unattributed"
            raise NonFiniteError(
                f"non-finite values at step {step} ({att}); "
                f"crash dump: {path}", dump, dump_path=path)
