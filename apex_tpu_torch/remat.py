"""Activation rematerialization for the port: named policies over tagged
activations.

Counterpart of ``apex_tpu/remat.py``, with its registry, save-list, tag and
policy: :data:`CHECKPOINT_NAMES` is every tag the models emit (every
``tag``/``_tag`` literal in the package comes from it; a test parses them),
:func:`tag` marks an activation by name, and :class:`RematPolicy` (``none |
full | selective | offload``, with a custom ``names`` save-list) wraps a
layer function. The reference maps the policies onto ``jax.checkpoint``;
here:

- ``none`` is the function itself;
- ``full`` is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=
  False)``: nothing inside the layer is kept, and the backward runs the
  whole layer again (its GEMMs and the flash forward kernel too);
- ``selective`` keeps exactly the tagged tensors of ``save_names`` that the
  backward needs, and recomputes the rest: no kept GEMM output and no flash
  forward is computed again;
- ``offload`` moves that tagged set to host memory (pinned where a card is
  present) in the forward and back in the backward, and recomputes what
  ``selective`` recomputes.

``selective`` and ``offload`` cannot rest on PyTorch's own selective
checkpoint, which chooses by aten op and never sees the port's kernels
(``ctypes`` calls). A name-based region (:class:`_Region`) instead records
the layer's forward as it runs: every aten op, through a
``TorchDispatchMode``, and every kernel call as one op
(:func:`region_op`, which the flash and LayerNorm autograd functions call),
with the tensors each reads and writes. ``saved_tensors_hooks`` keep what
autograd saves if it came from outside the region or is a kept tag, and
leave a placeholder otherwise. At the end of the forward the region finds
the ops that the placeholders depend on, stopping at kept tags (the
replay plan: the reference's dead-code elimination of the recompute), and
drops the rest of the record. The backward's first placeholder replays
that plan: the same ops on the same inputs, so the same bits.

Masks under recompute. The flash kernel's attention dropout is keyed by an
int seed, so any replay draws its masks again. Hidden dropout draws from an
explicit ``torch.Generator``: ``full`` hands its recompute a clone of each
generator argument as it stood at the region's entry, and ``selective`` and
``offload`` replay every random op (always in the plan) from clones of
their generators as they stood before the region's first draw from them
(the default generators through ``torch.random.fork_rng``). So every policy
draws the masks ``none`` draws, and leaves the caller's generators where
``none`` leaves them.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

__all__ = ["CHECKPOINT_NAMES", "SELECTIVE_SAVE", "RematPolicy", "tag",
           "region_op", "HOST_COPIES"]

# The registry: every tag the models emit. Keep entries plain string
# literals: tests/test_torch_remat.py parses every tag call site in the
# package and checks it against this tuple.
CHECKPOINT_NAMES: Tuple[str, ...] = (
    "flash_ctx",       # flash-attention context (kernel output)
    "flash_lse",       # flash-attention logsumexp (the backward's residual)
    "qkv_out",         # fused QKV ColumnParallel GEMM output
    "attn_proj_out",   # attention RowParallel projection GEMM output
    "mlp_fc1_out",     # MLP up-projection GEMM output (pre-gelu)
    "mlp_fc2_out",     # MLP down-projection GEMM output
    "ln_out",          # LayerNorm outputs (ln1 / ln2 / final)
)

# Megatron-selective default save-list: GEMM and flash outputs stay
# resident (each costs a GEMM or a kernel launch to recompute); LayerNorm
# outputs are recomputed (one kernel launch each)
SELECTIVE_SAVE: Tuple[str, ...] = (
    "flash_ctx",
    "flash_lse",
    "qkv_out",
    "attn_proj_out",
    "mlp_fc1_out",
    "mlp_fc2_out",
)

_MODES = ("none", "full", "selective", "offload")

# host copies the offload policy made: tagged tensors to the host in the
# forward, back to the card in the backward
HOST_COPIES: Dict[str, int] = {"to_host": 0, "to_device": 0}

_STATE = threading.local()


def _active() -> Optional["_Region"]:
    return getattr(_STATE, "region", None)


def tag(x, name: str):
    """Mark ``x`` with the registry name ``name``, so a name-based
    :class:`RematPolicy` can keep (or offload) it; returns ``x`` itself. A
    name outside :data:`CHECKPOINT_NAMES` raises. Outside a name-based
    region it does nothing else."""
    if name not in CHECKPOINT_NAMES:
        raise ValueError(
            f"checkpoint name {name!r} is not in remat.CHECKPOINT_NAMES; "
            f"register it there (and in the selective save-list if it "
            f"should stay resident): orphan tags are unreachable by every "
            f"policy")
    region = _active()
    if region is not None and name in region.save:
        region.keep(x)
    return x


def region_op(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, recorded as one op of an active name-based
    region: a kernel call, whose reads and writes the region's aten
    recording cannot see. Outside a region it is the call itself."""
    region = _active()
    if region is None or region.paused:
        return fn(*args, **kwargs)
    region.paused = True
    try:
        out = fn(*args, **kwargs)
    finally:
        region.paused = False
    region.record(fn, args, kwargs, out, must_run=False)
    return out


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Activation-checkpoint policy for a layer function.

    ``mode``: ``"none"`` (no checkpointing: autograd keeps every saved
    tensor), ``"full"`` (nothing kept inside the layer, the layer run again
    in the backward), ``"selective"`` (the tagged tensors of
    :attr:`save_names` kept, the rest recomputed) or ``"offload"`` (that
    tagged set on ``offload_dst``, host memory, between the forward and the
    backward; the rest recomputed).

    ``names``: a custom save/offload list (registry members); ``None``
    selects :data:`SELECTIVE_SAVE`. Only meaningful for the name-based
    modes. ``offload_src``/``offload_dst``: where offloaded tensors come
    from and go, the reference's ``"device"`` and ``"pinned_host"`` (the
    only pair the port takes; pinned only where a card is present).
    """

    mode: str = "none"
    names: Optional[Tuple[str, ...]] = None
    offload_src: str = "device"
    offload_dst: str = "pinned_host"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"remat mode {self.mode!r}; expected one of {_MODES}")
        if self.names is not None:
            object.__setattr__(self, "names", tuple(self.names))
            if self.mode not in ("selective", "offload"):
                raise ValueError(
                    f"names={self.names!r} is only meaningful for "
                    f"selective/offload policies, not mode={self.mode!r}")
            unknown = [n for n in self.names if n not in CHECKPOINT_NAMES]
            if unknown:
                raise ValueError(
                    f"unregistered checkpoint names {unknown}; the "
                    f"registry is remat.CHECKPOINT_NAMES={CHECKPOINT_NAMES}")

    @property
    def uses_names(self) -> bool:
        """Whether this policy consumes tags: the models call :func:`tag`
        only then, so ``none`` and ``full`` run exactly the untagged
        forward."""
        return self.mode in ("selective", "offload")

    @property
    def save_names(self) -> Tuple[str, ...]:
        return self.names if self.names is not None else SELECTIVE_SAVE

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` under this policy (``fn`` itself for ``none``): a layer
        function, or a pipeline stage ``fn(params, x, stage_idx)`` (the
        schedules' ``remat`` flag), whatever its arguments. Without grad
        mode the wrapped function is ``fn``'s plain call."""
        if self.mode == "none":
            return fn
        if self.mode == "full":
            return _full(fn)
        if (self.offload_src, self.offload_dst) != ("device", "pinned_host"):
            raise NotImplementedError(
                f"offload from {self.offload_src!r} to "
                f"{self.offload_dst!r}; the port offloads from 'device' to "
                "'pinned_host'")
        save = frozenset(self.save_names)
        offload = self.mode == "offload"

        def wrapped(*args, **kwargs):
            if not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            return _Region(save, offload).run(fn, args, kwargs)
        return wrapped

    @classmethod
    def resolve(cls, value: Any = None, legacy_bool: Optional[bool] = None,
                owner: str = "config") -> "RematPolicy":
        """Normalize every accepted spelling to a policy object.

        ``value``: ``None`` | mode string | bool | :class:`RematPolicy`.
        ``legacy_bool``: the deprecated ``remat: bool`` config field,
        consulted only when ``value`` is None: ``True`` maps to ``full``
        with a :class:`DeprecationWarning`. A bool passed as ``value`` (the
        pipeline schedules' ``remat`` flag) maps silently.
        """
        if isinstance(value, cls):
            return value
        if value is None:
            if legacy_bool:
                warnings.warn(
                    f"{owner}.remat=True (bool) is deprecated; use "
                    f"remat_policy='full' (or 'selective'/'offload' for "
                    f"the cheaper name-based policies)",
                    DeprecationWarning, stacklevel=3)
                return cls(mode="full")
            return cls(mode="none")
        if isinstance(value, bool):
            return cls(mode="full" if value else "none")
        if isinstance(value, str):
            return cls(mode=value)
        raise TypeError(
            f"cannot resolve a remat policy from {value!r} "
            f"(expected None, bool, mode string, or RematPolicy)")


# ---------------------------------------------------------------------------
# argument trees and generator clones, shared by both mechanisms
# ---------------------------------------------------------------------------

def _map(obj, fn):
    """``obj`` with ``fn`` applied to every leaf of its lists, tuples and
    dicts (a ``torch.Size`` or another tuple subclass is a leaf)."""
    kind = type(obj)
    if kind is tuple or kind is list:
        return kind([_map(x, fn) for x in obj])
    if kind is dict:
        return {k: _map(v, fn) for k, v in obj.items()}
    return fn(obj)


def _leaves(obj, out: List) -> List:
    """Every leaf of ``obj``'s lists, tuples (an op's named tuples too) and
    dicts, appended to ``out``."""
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    elif type(obj) is dict:
        for x in obj.values():
            _leaves(x, out)
    else:
        out.append(obj)
    return out


def _clone_generator(gen: torch.Generator, state) -> torch.Generator:
    clone = torch.Generator(device=gen.device)
    clone.set_state(state)
    return clone


# ---------------------------------------------------------------------------
# full: torch.utils.checkpoint, with the generators replayed
# ---------------------------------------------------------------------------

def _full(fn: Callable) -> Callable:
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        states = {id(g): (g, g.get_state())
                  for g in _leaves((args, kwargs), [])
                  if isinstance(g, torch.Generator)}
        calls = [0]

        def body(*a, **kw):
            calls[0] += 1
            if calls[0] > 1 and states:
                # the recompute draws from clones of the generators as
                # they stood at the region's entry
                clones = {k: _clone_generator(g, s)
                          for k, (g, s) in states.items()}
                a, kw = _map((a, kw), lambda x: clones.get(id(x), x)
                             if isinstance(x, torch.Generator) else x)
            return fn(*a, **kw)
        return checkpoint(body, *args, use_reentrant=False, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# selective and offload: a recorded region and its replay
# ---------------------------------------------------------------------------

class _Key:
    """A tensor the region produced, in a recorded op's arguments."""
    __slots__ = ("id",)

    def __init__(self, i: int):
        self.id = i


class _Holder:
    """What autograd keeps for a saved tensor the region produced: the
    tensor while the forward runs; afterwards the tensor itself for a kept
    tag (``selective``), else nothing (the replay or the host copy gives
    it)."""
    __slots__ = ("key", "tensor")

    def __init__(self, key: int, tensor: torch.Tensor):
        self.key = key
        self.tensor = tensor


class _Op:
    __slots__ = ("fn", "args", "outs", "must_run")

    def __init__(self, fn, args, outs, must_run: bool):
        self.fn, self.args, self.outs, self.must_run = (fn, args, outs,
                                                        must_run)


# per aten op: (draws random numbers, mutates an argument)
_OP_KIND: Dict[Any, Tuple[bool, bool]] = {}


class _Recorder(TorchDispatchMode):
    """Records every aten op the region's forward runs."""

    def __init__(self, region: "_Region"):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        region = self.region
        if region.paused:
            return func(*args, **kwargs)
        kind = _OP_KIND.get(func)
        if kind is None:
            kind = _OP_KIND[func] = (
                torch.Tag.nondeterministic_seeded in func.tags,
                func._schema.is_mutable)
        if kind[0]:
            region.snapshot_generators(func, args, kwargs)
        out = func(*args, **kwargs)
        region.record(func, args, kwargs, out, must_run=kind[0] or kind[1])
        return out


class _Region:
    """One call of a layer function under ``selective`` or ``offload``.

    Forward: the function runs with the aten recording on and the
    saved-tensor hooks in place; every tensor an op returns gets a key.
    :meth:`close` then turns the record into the replay plan. Backward: the
    first placeholder unpacked replays the plan (no grad, no recording),
    and each placeholder takes its key's value, dropped from the region at
    its last use."""

    def __init__(self, save, offload: bool):
        self.save = save
        self.offload = offload
        self.paused = False
        self.ops: List[_Op] = []
        self.keys = WeakTensorKeyDictionary()   # tensor -> key id
        self.count = 0
        self.kept: Dict[int, Any] = {}  # key -> tensor, or (host, device)
        self.holders: List[_Holder] = []
        self.generators: Dict[int, Tuple[torch.Generator, Any]] = {}
        self.default_rng = None        # (cpu state, cuda states)
        self.uses: Dict[int, int] = {}
        self.values: Dict[int, torch.Tensor] = {}
        self.fetched: Dict[int, torch.Tensor] = {}

    # -- forward ------------------------------------------------------------

    def run(self, fn, args, kwargs):
        prev = _active()
        _STATE.region = self
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                          self.unpack), \
                    _Recorder(self):
                out = fn(*args, **kwargs)
        finally:
            _STATE.region = prev
        self.close()
        return out

    def record(self, fn, args, kwargs, out, must_run: bool) -> None:
        def spec(x):
            if isinstance(x, torch.Tensor):
                key = self.keys.get(x)
                return x if key is None else _Key(key)
            return x
        outs = []
        for t in _leaves(out, []):
            if isinstance(t, torch.Tensor):
                self.keys[t] = self.count
                outs.append(self.count)
                self.count += 1
            else:
                outs.append(None)
        self.ops.append(_Op(fn, _map((args, kwargs), spec), outs, must_run))

    def snapshot_generators(self, func, args, kwargs) -> None:
        """The generators a random op draws from, as they stand before the
        region's first draw from each."""
        gens = [g for g in _leaves((args, kwargs), [])
                if isinstance(g, torch.Generator)]
        for g in gens:
            if id(g) not in self.generators:
                self.generators[id(g)] = (g, g.get_state())
        if not gens and self.default_rng is None:
            self.default_rng = (
                torch.get_rng_state(),
                torch.cuda.get_rng_state_all()
                if torch.cuda.is_initialized() else None)

    def keep(self, x: torch.Tensor) -> None:
        """A tag of the save-list: keep ``x`` (offload copies it to the
        host at :meth:`close`, if the backward reads it)."""
        key = self.keys.get(x)
        # (a tensor from outside the region has no key: autograd keeps it
        # as it is)
        if key is not None:
            self.kept[key] = x

    def pack(self, t: torch.Tensor):
        key = self.keys.get(t)
        if key is None:
            return t   # produced outside the region: kept as it is
        holder = _Holder(key, t)
        self.holders.append(holder)
        return holder

    def close(self) -> None:
        """The end of the forward: the holders let go of what the backward
        recomputes or fetches, and the record becomes the replay plan."""
        need = set()
        for h in self.holders:
            if h.key in self.kept and not self.offload:
                continue       # a kept tag: the holder keeps the tensor
            h.tensor = None
            self.uses[h.key] = self.uses.get(h.key, 0) + 1
            if h.key not in self.kept:
                need.add(h.key)
        self.needed = frozenset(need)
        plan, used_kept = [], set(self.uses) & set(self.kept)
        for op in reversed(self.ops):
            if op.must_run or any(k in need for k in op.outs
                                  if k is not None):
                plan.append(op)
                for x in _leaves(op.args, []):
                    if isinstance(x, _Key):
                        (used_kept if x.id in self.kept else need).add(x.id)
        plan.reverse()
        self.plan = plan
        # what nothing reads again is let go: a kept tag no op and no
        # saved tensor reads, the record's other ops
        self.kept = {k: v for k, v in self.kept.items() if k in used_kept}
        self.ops = self.keys = self.holders = None
        if self.offload:
            for key, x in self.kept.items():
                host = torch.empty_like(x, device="cpu",
                                        pin_memory=x.is_cuda)
                host.copy_(x, non_blocking=True)
                self.kept[key] = (host, x.device)
                HOST_COPIES["to_host"] += 1

    # -- backward -----------------------------------------------------------

    def unpack(self, h):
        if isinstance(h, torch.Tensor):
            return h
        if h.tensor is not None:
            return h.tensor
        key = h.key
        if key in self.kept:
            t = self.fetched.get(key)
            if t is None:
                t = self.fetched[key] = self._fetch(key)
        else:
            if key not in self.values:
                self._replay()
            t = self.values[key]
        self.uses[key] -= 1
        if self.uses[key] == 0:
            self.values.pop(key, None)
            self.fetched.pop(key, None)
        return t

    def _fetch(self, key: int) -> torch.Tensor:
        kept = self.kept[key]
        if not self.offload:
            return kept
        host, device = kept
        HOST_COPIES["to_device"] += 1
        return host.to(device, non_blocking=True)

    def _replay(self) -> None:
        vals: Dict[int, torch.Tensor] = {}
        clones = {k: _clone_generator(g, s)
                  for k, (g, s) in self.generators.items()}

        def resolve(x):
            if isinstance(x, _Key):
                t = vals.get(x.id)
                if t is not None:
                    return t
                t = self.fetched.get(x.id)
                return t if t is not None else self._fetch(x.id)
            if isinstance(x, torch.Generator):
                return clones.get(id(x), x)
            return x

        cuda = self.default_rng is not None and self.default_rng[1] is not None
        with torch.no_grad(), torch.random.fork_rng(
                devices=range(torch.cuda.device_count()) if cuda else [],
                enabled=self.default_rng is not None):
            if self.default_rng is not None:
                torch.set_rng_state(self.default_rng[0])
                if cuda:
                    torch.cuda.set_rng_state_all(self.default_rng[1])
            for op in self.plan:
                args, kwargs = _map(op.args, resolve)
                out = op.fn(*args, **kwargs)
                for key, t in zip(op.outs, _leaves(out, [])):
                    if key is not None:
                        vals[key] = t
        self.values = {k: vals[k] for k in self.needed}
