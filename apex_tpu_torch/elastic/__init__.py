"""The elastic runtime of the port (``apex_tpu/elastic``): so far the
checkpoint half.

- :mod:`~apex_tpu_torch.elastic.ckpt`: the asynchronous checkpointer
  (snapshot on the step's thread, serialize on a writer thread, bounded
  retry with jittered backoff, ``ckpt/*`` metrics);
- :mod:`~apex_tpu_torch.elastic.reshard`: ZeRO flat shards re-partitioned
  from one data-parallel size to another, element for element;
- :mod:`~apex_tpu_torch.elastic.faults`: the deterministic fault plan
  (checkpoint and serving faults).

The runner, the sharded data iterators and the launcher are queue item
A6b.
"""

from apex_tpu_torch.elastic.ckpt import (AsyncCheckpointer, host_snapshot,
                                         owned_copy, snapshot_nbytes)
from apex_tpu_torch.elastic.faults import FaultPlan

__all__ = ["AsyncCheckpointer", "FaultPlan", "host_snapshot", "owned_copy",
           "snapshot_nbytes"]
