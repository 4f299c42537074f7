"""The port's packages export the JAX package's names for what is ported,
and resolve lazily.

For every package the port has, the JAX package's ``__all__`` (for
``observability``, which has none, its public names) less the port's is
exactly the set listed here by the queue item that ports it (ROADMAP.md,
queue A: A7a observability and the rest of utils);
every name in a port ``__all__`` exists. A bare
``import apex_tpu_torch`` imports no subpackage and builds no kernel, then
each subpackage resolves on first attribute access, and the reference's
unported subpackages raise ``AttributeError``.
"""

import importlib
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

UNPORTED = {
    "observability": {"A7a": {
        "AttributionDiff", "BenchHistory", "ChromeTraceSink", "DriftShift",
        "HealthConfig", "HealthMonitor", "JSONLSink", "NonFiniteError",
        "NullReporter", "Regression", "RegressionDetector", "Span",
        "StepReporter", "TensorBoardSink", "TreeStats", "attach_reporter",
        "check_replica_agreement", "chrome_trace_events", "costs",
        "detach_reporter", "detect_drift_shifts", "drain_spans",
        "drift_series", "epoch_offset", "flops_budget",
        "get_reporter", "install_compile_listeners", "memory_budget",
        "merge_chrome_traces", "mfu", "peak_flops",
        "perfwatch", "publish_drift", "report", "reset_compile_listeners",
        "runtime", "sample_memory_stats", "sinks", "span_recording",
        "spans_enabled", "tensor_stats", "trace",
        "uninstall_compile_listeners", "unit_direction"}},
    # the reference's utils has no __all__: its public names, with the
    # JAX shims imported first so the set does not hang on import order
    "utils": {"A7a": {"Timer", "Timers", "device_fence", "profile_trace",
                      "RankInfoFormatter", "get_logger", "rank_zero_only",
                      "set_verbosity", "setup_logging", "timers",
                      "logging"},
              "not queued": {"compat", "vma", "hostmesh"}},
}
PACKAGES = ("amp", "fp16_utils", "models", "multi_tensor_apply",
            "normalization", "observability", "ops", "optimizers",
            "parallel", "serving", "transformer",
            "transformer.tensor_parallel", "transformer.amp", "RNN",
            "contrib.sparsity", "elastic", "config", "remat",
            "transformer.parallel_state", "parallel.distributed",
            "optimizers.distributed_fused", "transformer.context_parallel",
            "transformer.pipeline_parallel", "transformer._data",
            "checkpoint", "transformer.expert_parallel", "parallel.spatial",
            "elastic.ckpt", "elastic.reshard", "elastic.faults",
            "serving.resilience", "parallel.multiproc", "utils",
            "utils.autoresume", "elastic.data", "elastic.runner",
            "elastic.launch", "observability.fleet")
# the modules A5a added, each importable with JAX and the JAX package
# blocked
A5A_MODULES = ("parallel._spawn", "transformer.parallel_state",
               "parallel.distributed", "optimizers.distributed_fused",
               "training")
# and the modules A5b added
A5B_MODULES = ("transformer.tensor_parallel.mappings",
               "transformer.context_parallel",
               "transformer.tensor_parallel.collective_matmul",
               "transformer.tensor_parallel.data",
               "transformer.tensor_parallel.memory")
# and the modules A5c added
A5C_MODULES = ("transformer.pipeline_parallel",
               "transformer.pipeline_parallel.microbatches",
               "transformer.pipeline_parallel.utils",
               "transformer.pipeline_parallel.p2p_communication",
               "transformer.pipeline_parallel.schedules",
               "transformer._data", "transformer._data.batchsampler",
               "parallel._p2p")
# and the modules A5d and A6a added
A5D_A6A_MODULES = ("transformer.expert_parallel", "parallel.spatial",
                   "checkpoint", "elastic", "elastic.ckpt", "elastic.reshard",
                   "elastic.faults", "serving.resilience")
# and the modules A6b and A6c added
A6B_A6C_MODULES = ("parallel.multiproc", "utils", "utils.autoresume",
                   "elastic.data", "elastic.runner", "elastic.launch",
                   "observability.fleet")
# subpackages of the JAX package the port does not have yet
UNPORTED_SUBPACKAGES = {"pyprof": "A7b", "reparameterization": "not queued"}
# the JAX shims of the reference's utils, imported before its names are
# read (test_exports_cover_the_reference_names)
UTILS_SHIMS = ("compat", "vma", "hostmesh")


def _reference_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")]
    return set(names)


@pytest.mark.parametrize("package", PACKAGES)
def test_exports_cover_the_reference_names(package):
    if package == "utils":
        for shim in UTILS_SHIMS:
            importlib.import_module(f"apex_tpu.utils.{shim}")
    ref = importlib.import_module(f"apex_tpu.{package}")
    port = importlib.import_module(f"apex_tpu_torch.{package}")
    later = set().union(*UNPORTED.get(package, {}).values())
    missing = _reference_names(ref) - set(port.__all__)
    assert missing == later, (sorted(missing - later),
                              sorted(later - missing))
    for name in port.__all__:
        assert hasattr(port, name), name


def test_c1_repairs():
    from apex_tpu_torch import observability, parallel, transformer
    from apex_tpu_torch.optimizers import LARC
    from apex_tpu_torch.ops import fused_softmax
    assert parallel.LARC is LARC
    assert transformer.functional is fused_softmax
    for name in ("FusedScaleMaskSoftmax", "LayerType", "AttnType",
                 "AttnMaskType", "ModelType"):
        assert name in transformer.__all__ and hasattr(transformer, name)
    for sub in ("health", "ingraph", "registry", "reqtrace", "slo"):
        assert sub in observability.__all__
        assert getattr(observability, sub).__name__ == \
            f"apex_tpu_torch.observability.{sub}"


def test_lazy_subpackages_after_a_bare_import():
    ref = importlib.import_module("apex_tpu")
    port_lazy = sorted(set(ref._LAZY_SUBMODULES)
                       - set(UNPORTED_SUBPACKAGES)) + ["amp", "elastic",
                                                       "serving"]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import apex_tpu_torch\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.startswith('apex_tpu_torch.'))\n"
        "assert not loaded, loaded\n"
        f"for name in {port_lazy!r}:\n"
        "    assert name in dir(apex_tpu_torch), name\n"
        "    mod = getattr(apex_tpu_torch, name)\n"
        "    assert mod.__name__ == 'apex_tpu_torch.' + name, name\n"
        "assert apex_tpu_torch.contrib.sparsity.ASP\n"
        f"for name in {sorted(UNPORTED_SUBPACKAGES)!r}:\n"
        "    try:\n"
        "        getattr(apex_tpu_torch, name)\n"
        "    except AttributeError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('resolved ' + name)\n"
        "from apex_tpu_torch import _kernels, _native\n"
        "assert _kernels._LIB is None, 'a kernel was built'\n"
        "assert _native._LIB is None and not _native._TRIED\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_contrib_lazy_names_match_the_reference():
    ref = importlib.import_module("apex_tpu.contrib")
    port = importlib.import_module("apex_tpu_torch.contrib")
    assert port._LAZY == ref._LAZY
    with pytest.raises(AttributeError):
        port.nothing_here


@pytest.mark.parametrize("module", A5A_MODULES + A5B_MODULES + A5C_MODULES
                         + A5D_A6A_MODULES + A6B_A6C_MODULES)
def test_a5a_modules_import_without_jax(module):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"import apex_tpu_torch.{module} as mod\n"
        "assert not [m for m, v in sys.modules.items() if v is not None\n"
        "            and (m in ('jax', 'apex_tpu')\n"
        "                 or m.startswith(('jax.', 'apex_tpu.')))]\n"
        "assert all(hasattr(mod, n) for n in mod.__all__)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(source: str) -> set:
    """Every module an ``import`` or ``from ... import`` names in a source
    (relative imports resolve inside the port)."""
    import ast
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of the port, read as source (a lazy import inside a
    function counts): none names ``jax``, ``jaxlib`` or ``apex_tpu``, nor
    does ``chip_smoke.py``."""
    def bad(name):
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "apex_tpu")

    files = sorted((REPO / "apex_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    found = {str(p.relative_to(REPO)): sorted(
        m for m in _imported_modules(p.read_text()) if bad(m))
        for p in files}
    assert {k: v for k, v in found.items() if v} == {}
    assert _imported_modules("import jax.numpy as jnp\n"
                             "def f():\n    from apex_tpu import x\n") == {
        "jax.numpy", "apex_tpu"}
