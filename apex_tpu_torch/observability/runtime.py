"""Runtime introspection: compile counters and memory gauges.

Counterpart of ``apex_tpu/observability/runtime.py``. Two regressions stay
out of a loss curve until they ruin a run: a storm of recompiles (a shape
leak compiling the step again each iteration) and memory growth. Both
land in the registry here:

- :func:`install_compile_listeners` counts compiles. In torch a compile
  is a Dynamo compilation (``torch.compile``; its start and end
  callbacks, ``torch._dynamo.callback``) or a real build of the port's
  kernel library (:func:`apex_tpu_torch._kernels.build` when it compiled,
  not when it loaded a library built before). The counters are
  ``torch/traces`` (Dynamo compilations started), ``torch/compiles``
  (compilations finished, and library builds) and the histogram
  ``torch/compile_seconds``, in place of the reference's ``jax/*``:
  ``torch/compiles`` climbing after warm-up is the storm. Neither torch
  nor the library can take a callback back, so one process-wide
  dispatcher is registered once and fans out to the installed registries.
- :func:`sample_memory_stats` sets ``memory/bytes_in_use/device<i>``,
  ``memory/peak_bytes_in_use/device<i>`` and ``memory/bytes_limit/
  device<i>`` from ``torch.cuda.memory_stats`` (the allocator's current
  and peak allocated bytes; the limit is the card's memory) for each card
  the process has used; on the CPU it sets nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry)

__all__ = ["install_compile_listeners", "uninstall_compile_listeners",
           "reset_compile_listeners", "sample_memory_stats"]

_TARGETS: List[tuple] = []   # [(registry, traces, compiles, seconds)]
_DISPATCHER_ON = False
_LOCK = threading.Lock()
_STARTS: List[float] = []    # perf_counter of the Dynamo compiles open


def _on_compile_start(*_args) -> None:
    with _LOCK:
        _STARTS.append(time.perf_counter())
    for _reg, traces, _compiles, _seconds in list(_TARGETS):
        traces.inc()


def _on_compile_end(*_args) -> None:
    with _LOCK:
        t0 = _STARTS.pop() if _STARTS else None
    _on_compiled(time.perf_counter() - t0 if t0 is not None else 0.0)


def _on_compiled(seconds: float) -> None:
    for _reg, _traces, compiles, compile_s in list(_TARGETS):
        compiles.inc()
        compile_s.observe(seconds)


def _register_dispatcher() -> None:
    global _DISPATCHER_ON
    if _DISPATCHER_ON:
        return
    from torch._dynamo import callback

    from apex_tpu_torch import _kernels
    callback.on_compile_start(_on_compile_start)
    callback.on_compile_end(_on_compile_end)
    _kernels.BUILD_LISTENERS.append(_on_compiled)
    _DISPATCHER_ON = True


def install_compile_listeners(
        registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Feed ``registry`` (default: the process default) from compiles.
    Installing the same registry twice counts once;
    :func:`uninstall_compile_listeners` undoes it. Returns the registry."""
    reg = registry if registry is not None else get_registry()
    if any(r is reg for r, *_ in _TARGETS):
        return reg
    _TARGETS.append((reg, reg.counter("torch/traces"),
                     reg.counter("torch/compiles"),
                     reg.histogram("torch/compile_seconds")))
    _register_dispatcher()
    return reg


def uninstall_compile_listeners(
        registry: Optional[MetricsRegistry] = None) -> bool:
    """Stop feeding ``registry`` (default: the process default); True when
    it was installed. Its counters keep their values and stop moving."""
    reg = registry if registry is not None else get_registry()
    for i, (r, *_) in enumerate(_TARGETS):
        if r is reg:
            del _TARGETS[i]
            return True
    return False


def reset_compile_listeners() -> None:
    """Detach every installed registry (for tests)."""
    del _TARGETS[:]


def sample_memory_stats(
        registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Set and return ``memory/<key>/device<i>`` gauges for each card the
    process has used (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``); ``{}`` on the CPU. A host-side read of the
    allocator's counters: no synchronization with the card."""
    reg = registry if registry is not None else get_registry()
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        values = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
        for key, value in values.items():
            if value is None:
                continue
            name = f"memory/{key}/device{i}"
            reg.gauge(name).set(float(value))
            out[name] = float(value)
    return out
