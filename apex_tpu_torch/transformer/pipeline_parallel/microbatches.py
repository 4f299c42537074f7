"""Microbatch calculators.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/microbatches.py``
(upstream ``apex/transformer/microbatches.py``): host-side scheduling
state, the same arithmetic and the same messages, so a calculator and
its ``state_dict`` mean the same in both packages.
``ConstantNumMicroBatches`` keeps ``global_batch_size / (micro_batch_size
* data_parallel_size)`` microbatches; ``RampupBatchsizeNumMicroBatches``
ramps the global batch from ``start_batch_size`` by
``batch_size_increment`` every ``rampup_samples / num_increments``
consumed samples.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Union

__all__ = ["build_num_microbatches_calculator", "NumMicroBatchesCalculator",
           "ConstantNumMicroBatches", "RampupBatchsizeNumMicroBatches"]


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> "NumMicroBatchesCalculator":
    """A constant calculator without ``rampup_batch_size``, else a ramp
    from its ``(start, increment, samples)``; ``rank`` is the reference's
    (for its logging) and unused."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(global_batch_size, micro_batch_size,
                                       data_parallel_size)
    if len(rampup_batch_size) != 3:
        raise ValueError("expected the following format: --rampup-batch-size "
                         "<start batch size> <batch size increment> "
                         "<ramp-up samples>")
    start, increment, samples = (int(rampup_batch_size[0]),
                                 int(rampup_batch_size[1]),
                                 int(rampup_batch_size[2]))
    return RampupBatchsizeNumMicroBatches(
        start, increment, samples, global_batch_size, micro_batch_size,
        data_parallel_size)


class NumMicroBatchesCalculator(ABC):
    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    @abstractmethod
    def update(self, consumed_samples, consistency_check) -> None:
        ...

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"num_micro_batches": self.num_micro_batches,
                "current_global_batch_size": self.current_global_batch_size}

    def load_state_dict(self, state: dict) -> None:
        self.num_micro_batches = state["num_micro_batches"]
        self.current_global_batch_size = state["current_global_batch_size"]


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        super().__init__()
        mb_times_dp = micro_batch_size * data_parallel_size
        assert global_batch_size % mb_times_dp == 0, (
            f"global batch size ({global_batch_size}) is not divisible by "
            f"micro batch size ({micro_batch_size}) times data parallel size "
            f"({data_parallel_size})")
        self.num_micro_batches = global_batch_size // mb_times_dp
        assert self.num_micro_batches >= 1
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check) -> None:
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        assert self.micro_batch_times_data_parallel_size > 0
        assert start_batch_size > 0
        self.start_batch_size = start_batch_size
        assert global_batch_size > 0
        self.global_batch_size = global_batch_size
        diff = global_batch_size - start_batch_size
        assert diff >= 0
        assert batch_size_increment > 0
        self.batch_size_increment = batch_size_increment
        assert diff % batch_size_increment == 0
        num_increments = diff // batch_size_increment
        self.ramup_samples = ramup_samples
        assert self.ramup_samples >= 0
        self.rampup_samples_per_increment = self.ramup_samples / num_increments
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        if consumed_samples > self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
            assert self.current_global_batch_size <= self.global_batch_size
        if consistency_check:
            assert (self.current_global_batch_size
                    % self.micro_batch_times_data_parallel_size == 0), (
                "current global batch size ({}) is not divisible by "
                "micro-batch-size ({}) times data parallel size ({})".format(
                    self.current_global_batch_size, self.micro_batch_size,
                    self.data_parallel_size))
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size)
