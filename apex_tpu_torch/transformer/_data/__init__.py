"""Megatron-style data samplers of the port (counterpart of
``apex_tpu/transformer/_data/``)."""

from apex_tpu_torch.transformer._data.batchsampler import (  # noqa: F401
    MegatronPretrainingRandomSampler, MegatronPretrainingSampler)

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]
