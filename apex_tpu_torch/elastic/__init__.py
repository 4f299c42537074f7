"""The elastic runtime of the port (``apex_tpu/elastic``): survive
preemption and the loss of a process without losing the run.

- :mod:`~apex_tpu_torch.elastic.ckpt`: the asynchronous checkpointer
  (snapshot on the step's thread, serialize on a writer thread, bounded
  retry with jittered backoff, ``ckpt/*`` metrics);
- :mod:`~apex_tpu_torch.elastic.runner`: the preemption-safe loop over
  :class:`~apex_tpu_torch.training.GPTHybridTrainer`: it polls
  :class:`~apex_tpu_torch.utils.AutoResume`, drains the in-flight save,
  writes a final checkpoint and asks for a clean restart; on start it
  restores the latest COMMITTED checkpoint and goes on bit for bit;
- :mod:`~apex_tpu_torch.elastic.faults`: the deterministic fault plan
  (SIGTERM or SIGKILL at a step, save errors, torn checkpoints, serving
  faults);
- :mod:`~apex_tpu_torch.elastic.data`: the seeded per-host index sampler
  with a checkpointable cursor, and the prefetch to the card;
- :mod:`~apex_tpu_torch.elastic.launch`: the localhost launcher and
  supervisor (heartbeats, stall detection, gang teardown with a
  postmortem, restarts with backoff, shrink), with the fleet merge layer
  of :mod:`~apex_tpu_torch.observability.fleet`;
- :mod:`~apex_tpu_torch.elastic.reshard`: ZeRO flat shards re-partitioned
  from one data-parallel size to another, element for element.
"""

from apex_tpu_torch.elastic.ckpt import (AsyncCheckpointer, host_snapshot,
                                         owned_copy, snapshot_nbytes)
from apex_tpu_torch.elastic.data import (PrefetchingIterator,
                                         ShardedIndexIterator,
                                         token_batch_fetcher)
from apex_tpu_torch.elastic.faults import FaultPlan
from apex_tpu_torch.elastic.launch import (Heartbeat, LaunchReport,
                                           LocalLauncher, RoundResult)
from apex_tpu_torch.elastic.runner import (DrainInterrupt, ElasticRunner,
                                           FitResult)

__all__ = ["AsyncCheckpointer", "DrainInterrupt", "ElasticRunner",
           "FaultPlan", "FitResult", "Heartbeat", "LaunchReport",
           "LocalLauncher", "PrefetchingIterator", "RoundResult",
           "ShardedIndexIterator", "host_snapshot", "owned_copy",
           "snapshot_nbytes", "token_batch_fetcher"]
