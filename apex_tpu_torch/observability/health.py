"""Structured crash dumps: the post-mortem record of a failure.

The port's copy of :class:`CrashDump` and :func:`decode_attribution` from
``apex_tpu/observability/health.py``, which the serving scheduler's poison
quarantine and the :class:`~apex_tpu_torch.observability.slo.SLOTracker`'s
flight recorder write. A dump carries the step, the metrics payload, the
leaf attribution of non-finite trees, the policy config, the software
versions (``torch``, its CUDA, the port, in place of the reference's jax
and jaxlib), the wall time and, for serving dumps, the last request
records. It is written as strict JSON: non-finite metric values are the
strings ``"NaN"``/``"Infinity"``/``"-Infinity"``.

The in-graph health checks that fill ``health/<tree>/*`` (``tensor_stats``,
``observe_tree``), ``HealthConfig``, ``HealthMonitor`` and
``NonFiniteError`` are not ported yet; until they are, no leaf paths are
registered and :func:`decode_attribution` maps nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from apex_tpu_torch.observability._common import json_safe_metrics

__all__ = ["CrashDump", "decode_attribution"]

# tree name -> leaf path names, in the order a ``first_nonfinite_leaf``
# index counts them (filled by the in-graph health checks)
_LEAF_PATHS: Dict[str, List[str]] = {}
_FIRST_LEAF_SUFFIX = "/first_nonfinite_leaf"


def decode_attribution(payload: Dict[str, float]) -> Dict[str, str]:
    """Map every ``health/<tree>/first_nonfinite_leaf`` index in a payload
    back to the offending leaf's path name: ``{tree: leaf path}`` for the
    trees that flagged (index >= 0); clean trees and unknown names are
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


def _versions() -> Dict[str, str]:
    import numpy
    import torch

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
    payload; ``requests`` the serving flight-recorder window (request
    records as :meth:`~apex_tpu_torch.observability.reqtrace.RequestRecord
    .to_dict`, empty for training-side dumps)."""

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
