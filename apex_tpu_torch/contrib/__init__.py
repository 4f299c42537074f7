"""apex_tpu_torch.contrib: optional feature packages (the counterpart of
``apex_tpu/contrib``): sparsity (ASP), imported on first use."""

import importlib as _importlib

_LAZY = ("sparsity",)


def __getattr__(name):
    if name in _LAZY:
        return _importlib.import_module(f"apex_tpu_torch.contrib.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.contrib' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
