"""``python -m apex_tpu_torch.perfwatch``: the performance-observatory CLI.

A shim over :mod:`apex_tpu_torch.observability.perfwatch`, as the
reference's ``apex_tpu/perfwatch.py``. Exit status: 0 clean, 1
regressions, drift shifts or a dead selfcheck, 2 usage error.
"""

from apex_tpu_torch.observability.perfwatch import main

__all__ = ["main"]

if __name__ == "__main__":
    raise SystemExit(main())
