"""The PyTorch/CUDA port stands alone: no module of ``apex_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, the package imports with
JAX blocked, and importing it builds no kernel."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in (REPO / "apex_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "apex_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("relpath", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_or_apex_tpu_import(relpath):
    tree = ast.parse((REPO / relpath).read_text(), filename=relpath)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{relpath} imports {bad}"


def test_port_has_the_slice_modules():
    for rel in ("apex_tpu_torch/models/gpt.py",
                "apex_tpu_torch/ops/flash_attention.py",
                "apex_tpu_torch/serving/engine.py",
                "apex_tpu_torch/csrc/flash_fwd.cu",
                "apex_tpu_torch/csrc/decode_attention.cu"):
        assert (REPO / rel).is_file(), rel


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import apex_tpu_torch\n"
        "from apex_tpu_torch import _kernels, _bridge\n"
        "from apex_tpu_torch.models import GPTConfig, GPTModel\n"
        "from apex_tpu_torch.serving import ServingEngine, SlotScheduler\n"
        "from apex_tpu_torch.ops import flash_attention, decode_attention\n"
        "from apex_tpu_torch.observability import get_registry\n"
        "assert _kernels._LIB is None, 'a kernel was built at import'\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import KVCache
    cfg = GPTConfig(vocab_size=16, hidden_size=16, num_layers=1,
                    num_attention_heads=2, max_position_embeddings=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        KVCache.create(1, 1, 1, 8, 8)


def test_use_kernel_true_on_cpu_raises():
    from apex_tpu_torch.ops import decode_attention, flash_attention
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        flash_attention(q, q, q, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        decode_attention(q[:, :, 0], q, q, torch.zeros(1, dtype=torch.int32),
                         use_kernel=True)


def test_kernel_wrappers_refuse_cpu_tensors():
    from apex_tpu_torch import _kernels
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.decode_attention(q, q, q, torch.zeros(2, dtype=torch.int32),
                                  None, None, 0.125)
    assert _kernels.LAUNCHES == {"flash_fwd": 0, "decode_attention": 0}


def test_source_key_tracks_sources():
    from apex_tpu_torch import _kernels
    key = _kernels._source_key()
    assert len(key) == 16 and key == _kernels._source_key()


def test_dropout_raises_until_training_slice():
    from apex_tpu_torch.ops import flash_attention
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q, q, q, dropout_rate=0.1)
