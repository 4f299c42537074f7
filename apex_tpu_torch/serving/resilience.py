"""Serving resilience: typed admission rejections, SLO-driven brownout and
serving from a live training run's checkpoints.

Counterpart of ``apex_tpu/serving/resilience.py``. :class:`Rejection` is what
:meth:`~apex_tpu_torch.serving.scheduler.SlotScheduler.submit` returns,
instead of a request id, for a request it will not enqueue:
``queue_full`` at the ``max_queue`` bound, ``shed`` by a brownout,
``draining`` during a drain, ``pool_exhausted`` for a paged engine whose
pool could never hold the prompt. :class:`BrownoutPolicy` sits between the
SLO tracker and admission: past a burn rate it sheds new requests or caps
their ``max_new_tokens``. :class:`CheckpointWatcher` rolls an engine's
weights onto the newest committed checkpoint of a training run
(:mod:`apex_tpu_torch.checkpoint`) through ``swap_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

__all__ = ["Rejection", "REJECTION_REASONS", "BrownoutPolicy",
           "CheckpointWatcher", "watch_checkpoints"]

# the closed vocabulary of submit()-time rejections. Bad input (an empty or
# oversized prompt, a non-positive deadline, a duplicate in-flight id)
# still raises ValueError: a malformed request is a caller bug, not a load
# condition.
REJECTION_REASONS = ("queue_full", "shed", "draining", "pool_exhausted")


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A typed admission refusal: why the request was not enqueued. Check
    with ``isinstance(r, Rejection)``, not truthiness: request id 0 is a
    valid admission. (A Rejection is falsy all the same.)"""

    reason: str
    request_id: Optional[int] = None
    detail: str = ""

    def __post_init__(self):
        if self.reason not in REJECTION_REASONS:
            raise ValueError(f"reason must be one of {REJECTION_REASONS}, "
                             f"got {self.reason!r}")

    def __bool__(self) -> bool:
        return False


class BrownoutPolicy:
    """SLO-driven degradation: when the tracker's worst burn rate exceeds
    ``burn_threshold`` (1.0: on track to violate), the scheduler's
    admission sheds the new request (``shed=True``:
    ``Rejection(reason="shed")``, counted as ``serve/shed``) or caps its
    ``max_new_tokens`` at ``cap_max_new_tokens``. Shedding wins when both
    are set. Re-evaluated at each submission from the tracker's window and
    exported by the scheduler as the 0/1 ``serve/brownout`` gauge."""

    def __init__(self, tracker, *, burn_threshold: float = 1.0,
                 shed: bool = True,
                 cap_max_new_tokens: Optional[int] = None):
        if burn_threshold <= 0.0:
            raise ValueError("burn_threshold must be positive, "
                             f"got {burn_threshold!r}")
        if cap_max_new_tokens is not None and cap_max_new_tokens < 1:
            raise ValueError("cap_max_new_tokens must be >= 1, "
                             f"got {cap_max_new_tokens!r}")
        if not shed and cap_max_new_tokens is None:
            raise ValueError("a BrownoutPolicy with shed=False and no "
                             "cap_max_new_tokens would do nothing")
        self.tracker = tracker
        self.burn_threshold = float(burn_threshold)
        self.shed = bool(shed)
        self.cap_max_new_tokens = cap_max_new_tokens

    def engaged(self) -> bool:
        """True when the tracker's worst burn rate exceeds the threshold;
        an empty window (NaN) never engages: a cold server admits."""
        return self.tracker.max_burn_rate() > self.burn_threshold

    def cap(self, max_new_tokens: int) -> int:
        if self.cap_max_new_tokens is None:
            return max_new_tokens
        return min(max_new_tokens, self.cap_max_new_tokens)


class CheckpointWatcher:
    """Serve while training: roll ``engine``'s weights onto the newest
    COMMITTED checkpoint step under ``run_dir``.

    :meth:`poll` costs one directory listing when nothing changed; when a
    newer committed step appears it restores onto ``target`` (default:
    the engine's own state dict, the params-only checkpoint a serving
    deployment publishes), applies ``extract`` (for a checkpoint whose
    state nests the model's state dict in larger trainer state: pass the
    full-state ``target`` and ``extract=lambda state: state[...]``) and
    calls ``engine.swap_params``. A torn directory is never named by
    ``latest_step``, so the watcher cannot roll onto a half-written
    checkpoint. Each rollover ticks ``serve/swaps`` on ``registry``
    (default the process registry)."""

    def __init__(self, engine, run_dir: str, *, target: Any = None,
                 extract: Optional[Callable[[Any], Any]] = None,
                 registry=None):
        from apex_tpu_torch.observability.registry import get_registry

        self.engine = engine
        self.run_dir = run_dir
        self.target = target
        self.extract = extract
        self.registry = registry if registry is not None \
            else get_registry()
        self.step: Optional[int] = None  # last step swapped in

    def poll(self) -> Optional[int]:
        """Swap in the newest committed step if it is newer than the last
        one swapped; returns that step, or None when nothing changed (no
        checkpoint yet included)."""
        from apex_tpu_torch.checkpoint import latest_step, restore_checkpoint

        step = latest_step(self.run_dir)
        if step is None or (self.step is not None and step <= self.step):
            return None
        target = self.target
        if target is None:
            target = self.engine.model.state_dict()
        state, _ = restore_checkpoint(self.run_dir, target, step=step)
        params = self.extract(state) if self.extract is not None else state
        self.engine.swap_params(params)
        self.step = step
        self.registry.counter("serve/swaps").inc()
        return step


def watch_checkpoints(engine, run_dir: str, **kw) -> CheckpointWatcher:
    """A :class:`CheckpointWatcher` that has polled once (rolling onto the
    newest committed step if one exists)."""
    watcher = CheckpointWatcher(engine, run_dir, **kw)
    watcher.poll()
    return watcher
