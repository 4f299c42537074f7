"""The optimizer and Transformer-op modules of the port stand alone: they
import with JAX and the JAX package blocked, build no kernel and compile
no native library at import (the AST scan of
``tests/test_torch_imports.py`` covers every port file, these included),
and the packages export the JAX package's ``__all__`` names for what is
ported."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

MODULES = ("apex_tpu_torch/multi_tensor_apply/__init__.py",
           "apex_tpu_torch/multi_tensor_apply/multi_tensor_apply.py",
           "apex_tpu_torch/_native/__init__.py",
           "apex_tpu_torch/_native/flatten.cpp",
           "apex_tpu_torch/optimizers/fused_lamb.py",
           "apex_tpu_torch/optimizers/fused_novograd.py",
           "apex_tpu_torch/optimizers/larc.py",
           "apex_tpu_torch/ops/fused_softmax.py",
           "apex_tpu_torch/ops/mlp.py",
           "apex_tpu_torch/ops/multihead_attn.py")


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_the_module(rel):
    assert (REPO / rel).is_file(), rel


def test_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from apex_tpu_torch.multi_tensor_apply import (flatten,\n"
        "    multi_tensor_scale, multi_tensor_l2norm, tree_global_norm)\n"
        "from apex_tpu_torch.optimizers import (FusedLAMB, FusedNovoGrad,\n"
        "    FusedAdagrad, FusedMixedPrecisionLamb, LARC)\n"
        "from apex_tpu_torch.ops import (SelfMultiheadAttn, MLP,\n"
        "    FusedScaleMaskSoftmax, SoftmaxCrossEntropyLoss, supports_flash)\n"
        "from apex_tpu_torch import _native, _kernels\n"
        "assert _kernels._LIB is None, 'a kernel was built at import'\n"
        "assert _native._LIB is None and not _native._TRIED, 'native built'\n"
        "assert not any(m.startswith('jax') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("package", ["optimizers", "ops",
                                     "multi_tensor_apply"])
def test_exports_cover_the_reference_names(package):
    import importlib
    ref = importlib.import_module(f"apex_tpu.{package}")
    port = importlib.import_module(f"apex_tpu_torch.{package}")
    # what is left: ZeRO (A5) and the A4b ops
    later = {"DistributedFusedAdam", "ZeroAdamState", "DistributedFusedLAMB",
             "ZeroLambState", "FocalLoss", "focal_loss", "TransducerJoint",
             "TransducerLoss", "transducer_joint", "transducer_loss",
             "conv_bias", "conv_bias_relu", "conv_bias_mask_relu",
             "conv_frozen_scale_bias_relu"}
    missing = set(ref.__all__) - set(port.__all__) - later
    assert not missing, missing
    for name in port.__all__:
        assert hasattr(port, name), name
