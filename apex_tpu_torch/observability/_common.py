"""Private helpers of the port's observability package.

The port's copies of ``json_safe_value``/``json_safe_metrics`` from
``apex_tpu/observability/sinks.py`` and ``epoch_offset``/``trace_metadata``
from ``apex_tpu/observability/trace.py``: the strict-JSON spelling the
crash dumps use, and the metadata block the Chrome-trace export stamps.
The rest of those two modules (the sinks, the span recorder) is not ported
yet.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict

from apex_tpu_torch.observability.registry import json_safe_float


def json_safe_value(value: Any) -> Any:
    """Non-finite floats as the strings ``"NaN"``/``"Infinity"``/
    ``"-Infinity"``; every other value passes through untouched."""
    if isinstance(value, float) and not math.isfinite(value):
        return json_safe_float(value)
    return value


def json_safe_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: json_safe_value(v) for k, v in metrics.items()}


def epoch_offset() -> float:
    """``time.time() - time.perf_counter()``: the translation from this
    process's ``perf_counter`` timebase, whose zero point is arbitrary, to
    the unix epoch, so traces of several processes can be aligned."""
    return time.time() - time.perf_counter()


def trace_metadata() -> dict:
    """The metadata block a Chrome-trace export stamps into its document:
    the clock its ``ts`` fields are in and the epoch offset."""
    return {"clock": "perf_counter", "epoch_offset_s": epoch_offset()}
