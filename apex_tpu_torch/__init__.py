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
that builds the pieces: :mod:`apex_tpu_torch.models`,
:mod:`apex_tpu_torch.serving`, :mod:`apex_tpu_torch.normalization`,
:mod:`apex_tpu_torch.optimizers`, :mod:`apex_tpu_torch.amp`,
:mod:`apex_tpu_torch.parallel` and :mod:`apex_tpu_torch.config`. Public
entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the plain PyTorch path.
"""

__version__ = "0.1.0"
