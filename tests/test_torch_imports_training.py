"""The training modules of the port stand alone: they import with JAX and
the JAX package blocked and build no kernel (the AST scan of
``tests/test_torch_imports.py`` covers every port file, these included)."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

MODULES = ("apex_tpu_torch/observability/ingraph.py",
           "apex_tpu_torch/optimizers/_base.py",
           "apex_tpu_torch/amp/scaler.py", "apex_tpu_torch/amp/policy.py",
           "apex_tpu_torch/amp/lists.py", "apex_tpu_torch/amp/__init__.py",
           "apex_tpu_torch/fp16_utils/__init__.py",
           "apex_tpu_torch/transformer/amp/grad_scaler.py",
           "apex_tpu_torch/config.py",
           "apex_tpu_torch/parallel/sync_batchnorm.py",
           "apex_tpu_torch/models/resnet.py",
           "apex_tpu_torch/optimizers/fused_sgd.py",
           "apex_tpu_torch/optimizers/_flatten.py",
           "apex_tpu_torch/optimizers/flat.py", "apex_tpu_torch/_bridge.py")


def test_port_has_the_training_slice_modules():
    for rel in MODULES:
        assert (REPO / rel).is_file(), rel


def test_training_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from apex_tpu_torch.amp import (Policy, get_policy, o1_context,\n"
        "    scaled_value_and_grad, with_policy, register_half_function)\n"
        "from apex_tpu_torch.fp16_utils import FP16_Optimizer\n"
        "from apex_tpu_torch.transformer.amp import GradScaler\n"
        "from apex_tpu_torch.config import TrainConfig, ModelConfig\n"
        "from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm\n"
        "from apex_tpu_torch.models import ResNet50, ResNetConfig\n"
        "from apex_tpu_torch.optimizers import (FusedSGD, FlatOptimizer,\n"
        "    global_grad_norm)\n"
        "from apex_tpu_torch.optimizers._flatten import build_layout\n"
        "from apex_tpu_torch.observability import ingraph, reap\n"
        "from apex_tpu_torch._bridge import resnet_params_from_jax\n"
        "from apex_tpu_torch import _kernels\n"
        "assert _kernels._LIB is None, 'a kernel was built at import'\n"
        "assert not any(m.startswith('jax') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
