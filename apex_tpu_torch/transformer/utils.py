"""Shared transformer utilities, the counterpart of
``apex_tpu/transformer/utils.py`` (``reference:apex/transformer/utils.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ensure_divisibility", "divide", "split_tensor_along_last_dim",
           "VocabUtility"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    assert numerator % denominator == 0, (
        f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int
                                ) -> Tuple[torch.Tensor, ...]:
    """Equal chunks of the last dim (views of ``x``)."""
    last = divide(x.shape[-1], num_partitions)
    return tuple(torch.split(x, last, dim=-1))


class VocabUtility:
    """Vocab shard index ranges
    (``reference:apex/transformer/tensor_parallel/utils.py``)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank, world_size: int):
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank,
                                           world_size: int):
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)
