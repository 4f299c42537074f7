"""Tensor-parallel toolkit of the port: the collective mappings, the
sharded layers, the ring-decomposed collective matmuls, vocab-parallel
cross-entropy, the batch broadcast, the memory buffers, and the RNG
tracker with ``checkpoint``."""

from apex_tpu_torch.transformer.tensor_parallel.collective_matmul import (  # noqa: F401,E501
    all_gather_matmul, matmul_reduce_scatter)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401,E501
    vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.tensor_parallel.data import (  # noqa: F401
    broadcast_data, broadcast_from_tensor_parallel_rank0)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    init_method_normal)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region)
from apex_tpu_torch.transformer.tensor_parallel.memory import (  # noqa: F401
    MemoryBuffer, RingMemBuffer, allocate_mem_buff)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RNGStatesTracker, checkpoint, get_rng_tracker, model_parallel_seed)

__all__ = [
    "all_gather_matmul", "matmul_reduce_scatter",
    "vocab_parallel_cross_entropy",
    "broadcast_data", "broadcast_from_tensor_parallel_rank0",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "init_method_normal",
    "copy_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "MemoryBuffer", "RingMemBuffer", "allocate_mem_buff",
    "RNGStatesTracker", "checkpoint", "get_rng_tracker", "model_parallel_seed",
]
