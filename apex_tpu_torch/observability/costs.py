"""Peak rates of the card, MFU, and a step's FLOP and memory budgets.

Counterpart of ``apex_tpu/observability/costs.py``, for the NVIDIA H100:

- :data:`PEAK_BF16_FLOPS` / :func:`peak_flops` and :class:`DeviceSpec` /
  :func:`device_spec`: the card's dense bf16 FLOP/s, HBM bandwidth and
  NVLink bandwidth, matched by a prefix of ``torch.cuda.get_device_name``.
  The table holds NVIDIA H100 80GB HBM3 (the SXM part at its 700 W
  limit) from NVIDIA's data sheet: 989.4e12 dense bf16 FLOP/s, 3350 GB/s
  of HBM3, 450 GB/s of NVLink each way. A CPU or an unknown card gets the
  H100's numbers, named "unknown (H100-class assumed)". The environment
  variables ``APEX_TPU_PEAK_FLOPS`` (FLOP/s), ``APEX_TPU_HBM_GBPS`` and
  ``APEX_TPU_ICI_GBPS`` (GB/s) override the matched entry field by field.
  ``DeviceSpec.ici_gbps`` keeps the reference's field name and holds
  NVLink's bandwidth each way.
- :func:`mfu`: model-flops utilization, the reference's arithmetic.
- :func:`flops_budget`: a step's FLOPs. The reference reads XLA's cost
  analysis of a compiled executable (an object with ``cost_analysis()``,
  still taken); here it is a callable and its arguments, run once under
  ``torch.utils.flop_counter.FlopCounterMode``. The counter sees aten's
  matmuls and convolutions, not the port's ctypes kernels: on the card a
  step through the flash kernels counts no attention FLOPs, so prefer an
  analytic count there (as ``bench.py`` does for the same reason).
- :func:`memory_budget`: a step's memory. The reference reads XLA's static
  plan (an object with ``memory_analysis()``, still taken); here it is one
  measured call on the card: ``peak_hbm_bytes`` is the allocator's peak
  over the call, ``argument_bytes``/``output_bytes`` the tensor bytes of
  the arguments and of the result, ``temp_bytes`` the peak less those,
  and the rest 0. Off the card it returns None, as the reference does on
  a backend with no analysis.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["PEAK_BF16_FLOPS", "DEFAULT_PEAK_FLOPS", "peak_flops",
           "DeviceSpec", "DEVICE_SPECS", "DEFAULT_DEVICE_SPEC",
           "device_spec", "flops_budget", "memory_budget", "mfu"]

# peak dense bf16 FLOP/s by device-name prefix (NVIDIA's data sheet: the
# SXM part at 700 W)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

# a CPU or a card the table does not know: H100-class
DEFAULT_PEAK_FLOPS = 989.4e12


def _device_kind(device=None) -> str:
    """The name the tables match: ``device.device_kind`` for an object
    that has one (the reference's device type), else
    ``torch.cuda.get_device_name`` of a CUDA ``torch.device`` (or its
    string; default: card 0 when one is present), else ""."""
    kind = getattr(device, "device_kind", None)
    if kind is not None:
        return str(kind)
    if device is None:
        return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else ""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""


def peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of ``device`` (default: the first card),
    matched by name prefix against :data:`PEAK_BF16_FLOPS`;
    :data:`DEFAULT_PEAK_FLOPS` when unknown."""
    kind = _device_kind(device)
    for prefix, value in PEAK_BF16_FLOPS.items():
        if kind.startswith(prefix):
            return value
    return DEFAULT_PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Roofline corners of one card: peak dense bf16 FLOP/s, HBM
    bandwidth and link bandwidth (``ici_gbps``, the reference's name: here
    NVLink, GB/s each way)."""
    name: str
    peak_flops: float   # dense bf16 FLOP/s
    hbm_gbps: float     # HBM bandwidth, GB/s
    ici_gbps: float     # NVLink bandwidth, GB/s each way

    def compute_ms(self, flops: float) -> float:
        return flops / self.peak_flops * 1e3

    def hbm_ms(self, traffic_bytes: float) -> float:
        return traffic_bytes / (self.hbm_gbps * 1e9) * 1e3

    def comm_ms(self, wire_bytes: float) -> float:
        return wire_bytes / (self.ici_gbps * 1e9) * 1e3


DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "NVIDIA H100 80GB HBM3", PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"],
        3350.0, 450.0),
}

DEFAULT_DEVICE_SPEC = DeviceSpec("unknown (H100-class assumed)",
                                 DEFAULT_PEAK_FLOPS, 3350.0, 450.0)


def device_spec(device=None) -> DeviceSpec:
    """The :class:`DeviceSpec` of ``device`` (default: the first card),
    matched by name prefix, else :data:`DEFAULT_DEVICE_SPEC`;
    ``APEX_TPU_PEAK_FLOPS``, ``APEX_TPU_HBM_GBPS`` and
    ``APEX_TPU_ICI_GBPS`` override the entry field by field (a value that
    is not positive raises ``ValueError``)."""
    kind = _device_kind(device)
    spec = DEFAULT_DEVICE_SPEC
    for prefix, value in DEVICE_SPECS.items():
        if kind.startswith(prefix):
            spec = value
            break
    overrides = {}
    for env, field in (("APEX_TPU_PEAK_FLOPS", "peak_flops"),
                       ("APEX_TPU_HBM_GBPS", "hbm_gbps"),
                       ("APEX_TPU_ICI_GBPS", "ici_gbps")):
        raw = os.environ.get(env)
        if raw:
            value = float(raw)
            if value <= 0.0:
                raise ValueError(f"{env} must be positive, got {raw!r}")
            overrides[field] = value
    if overrides:
        spec = dataclasses.replace(spec, name=spec.name + " (env-tuned)",
                                   **overrides)
    return spec


def _positive(flops: float) -> Optional[float]:
    return flops if 0.0 < flops < float("inf") else None  # rejects NaN


def flops_budget(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` (a forward and its ``.backward()`` inside ``fn``
    both count), or of an object with ``cost_analysis()`` (the reference's
    compiled executable, read as the reference reads it). None when the
    count is not positive and finite."""
    if hasattr(fn, "cost_analysis"):
        try:
            cost = fn.cost_analysis()
            if isinstance(cost, (list, tuple)):
                cost = cost[0]
            flops = float(cost["flops"])
        except Exception:
            return None
        return _positive(flops)
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return _positive(float(counter.get_total_flops()))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def memory_budget(fn, *args, **kwargs) -> Optional[Dict[str, int]]:
    """The memory of one call ``fn(*args, **kwargs)`` on the card (the
    module's docstring), with the reference's keys; or the reference's
    reading of an object with ``memory_analysis()``. None off the card: no
    card present, or a tensor argument on the CPU and none on a card."""
    if hasattr(fn, "memory_analysis"):
        try:
            ma = fn.memory_analysis()
        except Exception:
            return None
        if ma is None:
            return None

        def _get(attr: str) -> int:
            return int(getattr(ma, attr, 0) or 0)

        out = {
            "argument_bytes": _get("argument_size_in_bytes"),
            "output_bytes": _get("output_size_in_bytes"),
            "temp_bytes": _get("temp_size_in_bytes"),
            "alias_bytes": _get("alias_size_in_bytes"),
            "generated_code_bytes": _get("generated_code_size_in_bytes"),
            "host_temp_bytes": _get("host_temp_size_in_bytes"),
        }
        out["peak_hbm_bytes"] = (out["argument_bytes"] + out["output_bytes"]
                                 + out["temp_bytes"]
                                 + out["generated_code_bytes"]
                                 - out["alias_bytes"])
        return out
    if not torch.cuda.is_available():
        return None
    tensors = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
    if tensors and not any(t.is_cuda for t in tensors):
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated())
    arg_bytes, out_bytes = _tensor_bytes((args, kwargs)), \
        _tensor_bytes(result)
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": max(peak - arg_bytes - out_bytes, 0),
            "alias_bytes": 0, "generated_code_bytes": 0,
            "host_temp_bytes": 0, "peak_hbm_bytes": peak}


def mfu(flops_per_step: float, step_time_s: float,
        peak: Optional[float] = None) -> float:
    """Model-flops utilization ``flops_per_step / step_time_s / peak``
    (``peak`` defaults to :func:`peak_flops` of the first card). A step
    time or peak that is not positive gives NaN rather than raising: a
    reporter's first wall delta can be ~0, and telemetry must not stop a
    training loop."""
    if peak is None:
        peak = peak_flops()
    if step_time_s <= 0.0 or peak <= 0.0:
        return math.nan
    return flops_per_step / step_time_s / peak
