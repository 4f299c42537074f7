"""Tensor-parallel toolkit of the port at tp=1: the layers, the RNG
tracker with ``checkpoint``, and vocab-parallel cross-entropy."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401,E501
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    init_method_normal)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RNGStatesTracker, checkpoint, get_rng_tracker, model_parallel_seed)

__all__ = ["vocab_parallel_cross_entropy",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "init_method_normal",
           "RNGStatesTracker", "checkpoint", "get_rng_tracker",
           "model_parallel_seed"]
