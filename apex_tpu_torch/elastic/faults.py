"""Deterministic fault injection: the port's ``FaultPlan``.

Counterpart of ``apex_tpu/elastic/faults.py``. A :class:`FaultPlan`
scripts when and how a run fails. Every field of the reference is kept,
so :meth:`~FaultPlan.to_json` and :meth:`~FaultPlan.from_json` carry the
same document both ways.

**Serving faults**, read by
:class:`~apex_tpu_torch.serving.scheduler.SlotScheduler` (steps are its
decode or verify steps, 1-based):

- ``poison_logits={step: slot}``: at that step add NaN to ``slot``'s
  sampling-path logits (the quarantine engine's ``poison`` argument); the
  quarantine must retire exactly that slot ``"poisoned"`` and leave every
  other stream untouched;
- ``slow_decode_s=t``: a host sleep of ``t`` seconds before every step;
- ``flood={step: n}``: the driving loop submits ``n`` extra requests
  right before that step (:meth:`~FaultPlan.flood_n`).

**Checkpoint faults**, read by
:class:`~apex_tpu_torch.elastic.ckpt.AsyncCheckpointer` through
:meth:`~FaultPlan.on_save_attempt` (its ``fault_hook``) and
:meth:`~FaultPlan.after_save`:

- ``save_errors={step: n}``: the first ``n`` serialization attempts of
  the checkpoint at ``step`` raise a transient ``OSError``, which the
  checkpointer retries with backoff;
- ``slow_save_s=t``: every attempt sleeps ``t`` seconds first;
- ``tear_after_step=K``: once the checkpoint at ``K`` commits, its
  COMMITTED marker is removed, the picture of a writer killed mid-save;
  a restore falls back past it with a warning.

Plans are seeded (:meth:`~FaultPlan.sample`,
:meth:`~FaultPlan.sample_serving` draw from ``numpy.random.RandomState``,
never from the clock).

``before_step`` (SIGTERM and SIGKILL at a step) needs the port's elastic
runner and multi-process launcher, queued as A6b; until then it raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["FaultPlan"]

_A6B = ("FaultPlan.before_step needs the port's elastic runner and "
        "multi-process launcher (ROADMAP queue A6b), which are not ported "
        "yet")


@dataclasses.dataclass
class FaultPlan:
    """A scripted failure schedule. All fields optional; an empty plan
    injects nothing."""

    sigterm_at_step: Optional[int] = None
    save_errors: Dict[int, int] = dataclasses.field(default_factory=dict)
    tear_after_step: Optional[int] = None
    slow_save_s: float = 0.0
    kill_process: Dict[int, int] = dataclasses.field(default_factory=dict)
    # serving faults (step-keyed, 1-based; see module docstring)
    poison_logits: Dict[int, int] = dataclasses.field(default_factory=dict)
    slow_decode_s: float = 0.0
    flood: Dict[int, int] = dataclasses.field(default_factory=dict)
    seed: Optional[int] = None  # provenance when built by sample*()

    # -- training hooks ---------------------------------------------------
    def before_step(self, step: int) -> None:
        raise NotImplementedError(_A6B)

    def on_save_attempt(self, step: int, attempt: int) -> None:
        """The checkpointer's fault hook, called before serialization
        attempt ``attempt`` (0-based) of the checkpoint at ``step``."""
        if self.slow_save_s > 0.0:
            time.sleep(self.slow_save_s)
        if attempt < int(self.save_errors.get(step, 0)):
            raise OSError(
                f"injected transient save fault (step {step}, attempt "
                f"{attempt})")

    def after_save(self, step: int, path: str) -> None:
        """After the checkpoint at ``step`` commits in ``path``: tears the
        scripted one by removing its COMMITTED marker."""
        if self.tear_after_step is not None and step == self.tear_after_step:
            from apex_tpu_torch.checkpoint import _COMMIT_FILE
            marker = os.path.join(path, _COMMIT_FILE)
            if os.path.exists(marker):
                os.remove(marker)

    # -- serving hooks ----------------------------------------------------
    def before_decode(self, step: int) -> None:
        """Called by the scheduler right before step ``step`` launches:
        the scripted ``slow_decode_s`` stretch."""
        if self.slow_decode_s > 0.0:
            time.sleep(self.slow_decode_s)

    def poison_slot(self, step: int) -> Optional[int]:
        """The slot whose logits the scheduler must NaN at step ``step``
        (None: no injection). The scheduler refuses a poison plan on an
        engine without quarantine."""
        return self.poison_logits.get(step)

    def flood_n(self, step: int) -> int:
        """How many extra requests the driving loop should submit right
        before step ``step``."""
        return int(self.flood.get(step, 0))

    # -- construction / transport ----------------------------------------
    @classmethod
    def sample(cls, seed: int, total_steps: int, *,
               save_interval: int = 1, transient_errors: bool = True,
               tear: bool = False) -> "FaultPlan":
        """A training plan drawn from ``seed``: one preemption at a
        uniform step in ``[1, total_steps)``, optionally 1-2 transient
        save errors at a step that saves (a multiple of ``save_interval``
        up to the preemption, else the preemption save), optionally
        tearing the preemption-time checkpoint."""
        if total_steps < 2:
            raise ValueError("total_steps must be >= 2 to place a fault")
        if save_interval < 1:
            raise ValueError("save_interval must be >= 1")
        rs = np.random.RandomState(seed)
        k = int(rs.randint(1, total_steps))
        plan = cls(sigterm_at_step=k, seed=int(seed))
        if transient_errors:
            save_steps = list(range(save_interval, k + 1, save_interval))
            if not save_steps:
                save_steps = [k]  # only the preemption save exists
            plan.save_errors = {int(rs.choice(save_steps)):
                                int(rs.randint(1, 3))}
        if tear:
            plan.tear_after_step = k
        return plan

    @classmethod
    def sample_serving(cls, seed: int, total_steps: int, *,
                       max_slots: int, flood_n: int = 4,
                       slow_decode_s: float = 0.0) -> "FaultPlan":
        """A serving chaos plan drawn from ``seed``: one flood of
        ``flood_n`` requests early (a step in ``[1, max(2, total_steps //
        4))``), one poisoned slot (uniform in ``[0, max_slots)``) at a step
        in the second half of ``[1, total_steps)``, when the flood has
        filled the slots, and an optional per-step stretch."""
        if total_steps < 4:
            raise ValueError("total_steps must be >= 4 to place "
                             "flood and poison faults")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        rs = np.random.RandomState(seed)
        flood_step = int(rs.randint(1, max(2, total_steps // 4)))
        poison_step = int(rs.randint(total_steps // 2, total_steps))
        return cls(flood={flood_step: int(flood_n)},
                   poison_logits={poison_step: int(rs.randint(max_slots))},
                   slow_decode_s=float(slow_decode_s), seed=int(seed))

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for key in ("save_errors", "kill_process", "poison_logits",
                    "flood"):
            d[key] = {str(k): v for k, v in getattr(self, key).items()}
        return json.dumps(d)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        for key in ("save_errors", "kill_process", "poison_logits",
                    "flood"):
            d[key] = {int(k): int(v) for k, v in d.get(key, {}).items()}
        return cls(**d)
