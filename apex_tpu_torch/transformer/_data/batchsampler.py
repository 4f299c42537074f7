"""Megatron pretraining batch samplers.

Counterpart of ``apex_tpu/transformer/_data/batchsampler.py`` (upstream
``apex/transformer/_data/_batchsampler.py:38,102``): data-parallel
sharded sequential and shuffled index samplers that resume exactly from
``consumed_samples`` and hand each data rank its disjoint slice of the
global batch. Index arithmetic on the host, the reference's exactly: the
shuffled sampler permutes a rank's bucket with
``numpy.random.RandomState(epoch)``, as the reference does, so an
epoch's order is the reference's for the same epoch.

Each yielded list indexes the host dataset; gather the rows and hand
them to the model (through ``tensor_parallel.broadcast_data`` under
tensor parallelism).
"""

from __future__ import annotations

import abc
from typing import Iterator, List

import numpy as np

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]


class _Base(abc.ABC):
    """The samplers' base (upstream ``_batchsampler.py:16-35``)."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def __iter__(self) -> Iterator[List[int]]:
        ...

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new: int) -> None:
        self._local_minibatch_size = new
        self.local_minibatch_times_data_parallel_size = (
            new * self.data_parallel_size)


def _check(total_samples, consumed_samples, local_minibatch_size,
           data_parallel_rank, data_parallel_size, sequential: bool):
    if total_samples <= 0:
        raise RuntimeError(f"no sample to consume: {total_samples}")
    if sequential and consumed_samples >= total_samples:
        raise RuntimeError(
            f"no samples left to consume: {consumed_samples}, "
            f"{total_samples}")
    if local_minibatch_size <= 0:
        raise RuntimeError(
            f"local minibatch size must be greater than 0: "
            f"{local_minibatch_size}")
    if data_parallel_size <= 0:
        raise RuntimeError(
            f"data parallel size must be greater than 0: "
            f"{data_parallel_size}")
    if data_parallel_rank >= data_parallel_size:
        raise RuntimeError(
            f"data_parallel_rank should be smaller than data size: "
            f"{data_parallel_rank}, {data_parallel_size}")


class MegatronPretrainingSampler(_Base):
    """Sequential data-parallel sampler (upstream
    ``_batchsampler.py:38-100``).

    Walks indices ``consumed_samples..total_samples``; every
    ``local_minibatch_size * dp`` indices form one global batch, of which
    this rank yields its contiguous slice.
    """

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True):
        _check(total_samples, consumed_samples, local_minibatch_size,
               data_parallel_rank, data_parallel_size, sequential=True)
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        self.drop_last = drop_last

    def __len__(self) -> int:
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def __iter__(self):
        batch = []
        # one global batch (lmb * dp indices), then this rank's slice, as
        # upstream Megatron-LM and the JAX package do (the apex fork slices
        # after local_minibatch_size indices, which leaves every rank > 0
        # an empty list)
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.local_minibatch_times_data_parallel_size:
                start, end = self.get_start_end_idx()
                yield batch[start:end]
                batch = []
        if batch and not self.drop_last:
            start, end = self.get_start_end_idx()
            tail = batch[start:end]
            if tail:
                yield tail


class MegatronPretrainingRandomSampler(_Base):
    """Shuffled data-parallel sampler (upstream
    ``_batchsampler.py:102-182``).

    Each rank owns a contiguous ``bucket`` of the dataset; per epoch the
    bucket is permuted with the epoch number as seed (determinism =
    resumability), and ``consumed_samples`` positions into the permutation.
    """

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int):
        _check(total_samples, consumed_samples, local_minibatch_size,
               data_parallel_rank, data_parallel_size, sequential=False)
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        self.last_batch_size = (
            self.total_samples % self.local_minibatch_times_data_parallel_size)

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples

        bucket_size = (self.total_samples
                       // self.local_minibatch_times_data_parallel_size
                       ) * self.local_minibatch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.RandomState(self.epoch)
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        # the last incomplete batch is dropped
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += (
                    self.local_minibatch_times_data_parallel_size)
                yield batch
                batch = []
