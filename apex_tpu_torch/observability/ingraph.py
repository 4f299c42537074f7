"""In-step metric accumulators: 0-d device tensors recorded during a step.

Counterpart of ``apex_tpu/observability/ingraph.py``. Instrumented code
(the loss scalers, the optimizers) calls :func:`record(name, value,
reduce=...)`; a reaping wrapper (:func:`reap` / :func:`collecting`)
gathers everything recorded while it is open into a :class:`Metrics`
mapping of 0-d fp32 tensors on the values' device. Nothing is read back
to the host inside the step: :meth:`Metrics.as_floats` makes the one
transfer when the caller wants numbers.

**Zero cost when off.** :func:`record` looks at the collector stack
first and, with none open, returns before it touches its value: pass
expensive values as thunks (``record("optim/grad_norm", lambda:
global_grad_norm(g))``) and an uninstrumented step makes no extra aten
call and no extra launch. The reference's trace-time check becomes a
call-time check here, since the port runs eagerly.

:func:`aggregate` reduces every entry across ranks by its declared
reduction, over the process groups that mesh axis names give
(:mod:`apex_tpu_torch.transformer.parallel_state`): one all-reduce for
each reduction kind and axis, on the card for an NCCL group and on the
CPU for a gloo one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Metrics", "record", "recording", "recorded_names", "reap",
           "collecting", "aggregate", "REDUCTIONS"]

REDUCTIONS = ("sum", "mean", "max", "min")


class Metrics:
    """An ordered ``{name: 0-d fp32 tensor}`` mapping plus each name's
    declared reduction."""

    def __init__(self, values: Optional[Dict[str, Any]] = None,
                 modes: Optional[Dict[str, str]] = None):
        self.values: Dict[str, Any] = dict(values or {})
        self.modes: Dict[str, str] = {k: (modes or {}).get(k, "mean")
                                      for k in self.values}

    def __len__(self):
        return len(self.values)

    def __contains__(self, name):
        return name in self.values

    def __getitem__(self, name):
        return self.values[name]

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.values)

    def as_floats(self) -> Dict[str, float]:
        """One transfer for every value, then plain floats."""
        if not self.values:
            return {}
        keys = list(self.values)
        host = torch.stack([self.values[k].to(self.values[keys[0]].device)
                            for k in keys]).tolist()
        return dict(zip(keys, (float(v) for v in host)))

    def __repr__(self):
        return f"Metrics({sorted(self.values)})"


class _Collector:
    def __init__(self):
        self.values: Dict[str, Any] = {}
        self.modes: Dict[str, str] = {}

    def add(self, name: str, value: Any, mode: str) -> None:
        prev_mode = self.modes.get(name)
        if prev_mode is not None and prev_mode != mode:
            raise ValueError(
                f"metric {name!r} recorded with reduce={mode!r} but was "
                f"previously recorded with reduce={prev_mode!r}")
        value = torch.as_tensor(value).to(torch.float32)
        if value.dim():
            raise ValueError(
                f"in-graph metrics must be scalars; {name!r} got shape "
                f"{tuple(value.shape)}")
        if name in self.values and mode == "sum":
            value = self.values[name] + value
        # non-sum re-records overwrite: last observation wins
        self.values[name] = value
        self.modes[name] = mode

    def freeze(self) -> Metrics:
        return Metrics(self.values, self.modes)


class _State(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _State()


def recording() -> bool:
    """True when a collector is open: guard computations done only for
    telemetry with this (or pass a thunk to :func:`record`)."""
    return bool(_STATE.stack)


def recorded_names() -> Tuple[str, ...]:
    """The names recorded so far into the innermost open collector (empty
    when none is open)."""
    if not _STATE.stack:
        return ()
    return tuple(_STATE.stack[-1].values)


def record(name: str, value: Union[Any, Callable[[], Any]],
           reduce: str = "mean") -> None:
    """Record a named scalar into the innermost open collector.

    No-op, before evaluating ``value`` (which may be a thunk), when no
    collector is open. ``reduce`` declares how values combine across
    ranks: ``"sum"`` for additive quantities, ``"mean"`` for gauges,
    ``"max"``/``"min"`` for extrema. Re-recording a name in one step sums
    for ``"sum"`` and overwrites otherwise.
    """
    if not _STATE.stack:
        return
    if reduce not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduce!r}; "
                         f"expected one of {REDUCTIONS}")
    if callable(value):
        value = value()
    _STATE.stack[-1].add(name, value, reduce)


@contextlib.contextmanager
def collecting():
    """Open a collector around a region; yields the collector, whose
    ``freeze()`` returns the :class:`Metrics`."""
    col = _Collector()
    _STATE.stack.append(col)
    try:
        yield col
    finally:
        popped = _STATE.stack.pop()
        if popped is not col:
            raise RuntimeError("in-graph collectors closed out of order")


def reap(fn: Callable) -> Callable:
    """Wrap ``fn`` so it returns ``(out, Metrics)`` with everything
    recorded during the call."""

    def wrapped(*args, **kwargs):
        with collecting() as col:
            out = fn(*args, **kwargs)
            metrics = col.freeze()
        return out, metrics

    return wrapped


def aggregate(metrics: Metrics,
              axis_names: Union[None, str, Sequence[str]]) -> Metrics:
    """Every entry reduced across the groups of ``axis_names`` by its
    declared reduction (``sum``, ``mean``, ``max``, ``min``); the result
    is the same on every rank of the group. With ``None`` or empty axes
    this is the identity. An axis that is not bound raises
    ``ValueError``."""
    if not axis_names:
        return metrics
    import torch.distributed as dist

    from apex_tpu_torch.transformer.parallel_state import resolve_axis
    axes = ((axis_names,) if isinstance(axis_names, (str, dist.ProcessGroup))
            else tuple(axis_names))
    groups = [resolve_axis(ax) for ax in axes]
    ops = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    out = dict(metrics.values)
    for mode in REDUCTIONS:
        names = [k for k, m in metrics.modes.items() if m == mode]
        if not names:
            continue
        for group in groups:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend(group) == "nccl"
                   else torch.device("cpu"))
            vec = torch.stack([out[k].to(dev, torch.float32)
                               for k in names])
            dist.all_reduce(vec, op=ops[mode], group=group)
            if mode == "mean":
                vec = vec / dist.get_world_size(group)
            out.update(zip(names, vec.unbind()))
    return Metrics(out, dict(metrics.modes))
