"""Pipeline parallelism of the port.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/``: the
microbatch calculators, the stage hops (``p2p_communication``), the four
schedules and their dispatcher (``schedules``), and the utilities. The
names resolve lazily, on first access, as the port's packages do."""

import importlib

_LAZY = {
    "get_forward_backward_func": "schedules",
    "pipelined_apply": "schedules",
    "forward_backward_no_pipelining": "schedules",
    "forward_backward_pipelining_without_interleaving": "schedules",
    "forward_backward_pipelining_with_interleaving": "schedules",
    "rotate_forward": "p2p_communication",
    "rotate_backward": "p2p_communication",
    "ConstantNumMicroBatches": "microbatches",
    "RampupBatchsizeNumMicroBatches": "microbatches",
    "NumMicroBatchesCalculator": "microbatches",
    "build_num_microbatches_calculator": "microbatches",
    "setup_microbatch_calculator": "utils",
    "get_num_microbatches": "utils",
    "update_num_microbatches": "utils",
    "get_kth_microbatch": "utils",
    "average_losses_across_data_parallel_group": "utils",
    "get_ltor_masks_and_position_ids": "utils",
}

__all__ = [
    "get_forward_backward_func", "pipelined_apply",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "rotate_forward", "rotate_backward",
    "ConstantNumMicroBatches", "RampupBatchsizeNumMicroBatches",
    "NumMicroBatchesCalculator", "build_num_microbatches_calculator",
    "setup_microbatch_calculator", "get_num_microbatches",
    "update_num_microbatches", "get_kth_microbatch",
    "average_losses_across_data_parallel_group",
    "get_ltor_masks_and_position_ids",
]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
