"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for the NVIDIA H100.

A package beside ``apex_tpu`` that mirrors its module paths
(``apex_tpu_torch/models/gpt.py`` is the counterpart of
``apex_tpu/models/gpt.py``, and so on). It imports PyTorch, numpy and the
standard library only: never JAX, never ``apex_tpu``. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package on the ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, built at first
use (:mod:`apex_tpu_torch._kernels`).

The ported slices serve GPT from a dense or a paged KV cache, with or
without speculative decoding, train it, pretrain BERT (padding masks as
the flash kernels' score bias, every LayerNorm on its own kernels) and
train ResNet-50 (cuDNN convs, batch norm in torch ops, as the reference
leaves them to XLA), with amp policies, telemetry and a ``TrainConfig``
that builds the pieces, and carry the rest of the one-device surface: the
RNN family (:mod:`apex_tpu_torch.RNN`), the RNN-T transducer, focal loss
and the fused convs (:mod:`apex_tpu_torch.ops`), 2:4 sparsity
(:mod:`apex_tpu_torch.contrib.sparsity`), and the tp=1 RNG tracker and
vocab-parallel cross-entropy (:mod:`apex_tpu_torch.transformer`). Across
ranks of ``torch.distributed`` it lays out the reference's process groups
(:mod:`apex_tpu_torch.transformer.parallel_state`) and trains with data
parallelism and ZeRO-1 (:mod:`apex_tpu_torch.parallel`,
:mod:`apex_tpu_torch.optimizers`), tensor and sequence parallelism
(:mod:`apex_tpu_torch.transformer.tensor_parallel`) and pipelines
(:mod:`apex_tpu_torch.transformer.pipeline_parallel`), all three at once
in :class:`apex_tpu_torch.training.GPTHybridTrainer`, with context
parallelism's ring and Ulysses attention, the expert-parallel MoE and the
height-sharded convolution beside them, and checkpoints that resume bit
for bit (:mod:`apex_tpu_torch.checkpoint`), and the elastic runtime of
:mod:`apex_tpu_torch.elastic`: the asynchronous writer, the ZeRO
reshard, the preemption-safe run loop over seeded resumable data, and
the multi-process launcher that restarts and shrinks a gang
(:mod:`apex_tpu_torch.parallel.multiproc`,
:mod:`apex_tpu_torch.observability.fleet`,
:mod:`apex_tpu_torch.utils`). Public entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the plain PyTorch path.

The subpackages resolve on first attribute access, as the reference's do
(``apex_tpu/__init__.py:32-44``): ``import apex_tpu_torch`` imports none
of them, builds no kernel and needs no card. The reference's ``pyprof``
and ``reparameterization`` are not ported, and raise ``AttributeError``
here.
"""

import importlib as _importlib

__version__ = "0.1.0"

_LAZY_SUBMODULES = (
    "amp", "optimizers", "normalization", "ops", "parallel", "transformer",
    "contrib", "fp16_utils", "models", "multi_tensor_apply", "RNN",
    "config", "observability", "remat", "serving", "elastic", "checkpoint",
    "utils",
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return _importlib.import_module(f"apex_tpu_torch.{name}")
    raise AttributeError(f"module 'apex_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_SUBMODULES))
