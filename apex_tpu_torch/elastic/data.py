"""Deterministic, resumable, prefetching input for the data axis: the
port's ``apex_tpu/elastic/data.py``.

Two layers, both pure functions of ``(seed, batch_number)``, so a restart
reproduces any point of the stream from one integer cursor:

- :class:`ShardedIndexIterator`: a seeded per-host sampler over row
  indices. Epoch ``e``'s order is a ``numpy.random.RandomState``
  permutation keyed on ``(seed, e)``, the reference's draw, so both
  packages give the same indices for every seed, epoch, ``num_hosts``
  and host. Each global batch is a contiguous slice of it and each host
  takes its own contiguous sub-slice. The cursor is one integer (batches
  consumed) and :meth:`~ShardedIndexIterator.batch_indices` is random
  access, so a seek is an assignment.
- :class:`PrefetchingIterator`: a sampler plus a host ``fetch`` with a
  ``depth``-deep pipeline of copies to ``device``: from pinned host
  memory with ``non_blocking=True`` on the card, so the copy of batch
  ``k+1`` runs while the step consumes batch ``k``. Its ``state_dict``
  holds the *consumed* cursor, not the fetched one: batches fetched but
  not consumed are fetched again after a restore, which is exact
  because batch ``k`` is a pure function.

The cursor rides in the checkpoint's host sidecar
(:class:`~apex_tpu_torch.elastic.runner.ElasticRunner`), so N steps, a
preemption, a restore and M steps consume the data of N+M straight
steps.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

__all__ = ["ShardedIndexIterator", "PrefetchingIterator",
           "token_batch_fetcher"]

# epoch-key mixing: a fixed odd multiplier keeps (seed, epoch) streams
# distinct without wall-clock entropy; modulo keeps RandomState's u32 seed
_EPOCH_MIX = 1_000_003


class ShardedIndexIterator:
    """Seeded, seekable per-host index sampler.

    ``next()`` yields this host's ``global_batch // num_hosts`` row
    indices for the next global batch. ``drop_last`` semantics: each
    epoch uses the first ``batches_per_epoch * global_batch`` rows of its
    permutation; the remainder is dropped (never silently wrapped).
    """

    def __init__(self, total_samples: int, global_batch: int, *,
                 seed: int, host_id: int = 0, num_hosts: int = 1,
                 shuffle: bool = True):
        if global_batch < 1 or total_samples < global_batch:
            raise ValueError(
                f"need total_samples >= global_batch >= 1, got "
                f"{total_samples} / {global_batch}")
        if num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(f"bad host grid {host_id}/{num_hosts}")
        if global_batch % num_hosts:
            raise ValueError(
                f"global_batch {global_batch} not divisible by num_hosts "
                f"{num_hosts}")
        self.total_samples = int(total_samples)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.host_id = int(host_id)
        self.num_hosts = int(num_hosts)
        self.shuffle = bool(shuffle)
        self.batches_per_epoch = self.total_samples // self.global_batch
        self.consumed = 0  # batches handed out so far == the cursor
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            if self.shuffle:
                rs = np.random.RandomState(
                    (self.seed + _EPOCH_MIX * (epoch + 1)) % (2 ** 32))
                self._perm = rs.permutation(self.total_samples)
            else:
                self._perm = np.arange(self.total_samples)
            self._perm_epoch = epoch
        return self._perm

    def batch_indices(self, k: int) -> np.ndarray:
        """This host's row indices for global batch ``k`` — pure in
        ``(seed, k)``, the property resume correctness rests on."""
        if k < 0:
            raise ValueError(f"batch number must be >= 0, got {k}")
        epoch, b = divmod(k, self.batches_per_epoch)
        rows = self._epoch_perm(epoch)[b * self.global_batch:
                                       (b + 1) * self.global_batch]
        per_host = self.global_batch // self.num_hosts
        return rows[self.host_id * per_host:(self.host_id + 1) * per_host]

    def __iter__(self) -> "ShardedIndexIterator":
        return self

    def __next__(self) -> np.ndarray:
        out = self.batch_indices(self.consumed)
        self.consumed += 1
        return out

    # -- resume -----------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"consumed": int(self.consumed), "seed": self.seed,
                "num_hosts": self.num_hosts,
                "global_batch": self.global_batch}

    def _check_stream_identity(self, state: Dict[str, int]) -> None:
        """The fields that define the GLOBAL stream — any mismatch means
        the cursor indexes a different sequence and no reseek can fix
        it."""
        seed = state.get("seed")
        if seed is not None and int(seed) != self.seed:
            raise ValueError(
                f"data cursor was saved under seed {seed} but this "
                f"iterator is seeded with {self.seed}; resuming would "
                f"replay a different stream")
        gb = state.get("global_batch")
        if gb is not None and int(gb) != self.global_batch:
            raise ValueError(
                f"data cursor was saved with global_batch {gb} but this "
                f"iterator batches {self.global_batch} rows globally; "
                f"the cursor counts batches of the SAVED size, so "
                f"resuming would skip or replay rows. Keep the global "
                f"batch fixed across world-size changes (scale the "
                f"microbatch count instead).")

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """Same-world restore. A cursor saved under a **different**
        ``num_hosts`` is rejected loudly: the per-host slice of every
        global batch is a function of ``(host_id, num_hosts)``, so a
        stale cursor would silently shift which rows each host consumes
        (rows double-consumed on some hosts, skipped on others). A
        world-size change must go through :meth:`reseek`, which
        re-derives this host's slices from the new grid."""
        self._check_stream_identity(state)
        hosts = state.get("num_hosts")
        if hosts is not None and int(hosts) != self.num_hosts:
            raise ValueError(
                f"data cursor was saved under num_hosts={hosts} but this "
                f"iterator shards for num_hosts={self.num_hosts}. "
                f"Loading it as-is would silently shift which rows each "
                f"host consumes (the per-host slice is a function of the "
                f"host grid). If the world size changed on purpose "
                f"(elastic shrink/grow), call it.reseek(state): batch k "
                f"is a pure function of (seed, k), so the GLOBAL sample "
                f"sequence is preserved and the new grid just re-slices "
                f"it.")
        self.consumed = int(state["consumed"])

    def reseek(self, state: Dict[str, int]) -> None:
        """The world-size-change restore path (elastic shrink/grow):
        accept a cursor saved under a different ``num_hosts``. Safe
        because the cursor is GLOBAL (batches consumed) and
        :meth:`batch_indices` is pure in ``(seed, k)`` — the global
        sample sequence continues exactly where the old world left it
        (no row skipped or double-consumed); only the per-host slicing
        of each batch follows the new grid. Stream identity (seed,
        global_batch) must still match."""
        self._check_stream_identity(state)
        self.consumed = int(state["consumed"])


class PrefetchingIterator:
    """A ``depth``-deep device prefetch over a sampler.

    ``fetch(indices) -> host batch`` (a tree of tensors or numpy
    arrays); each fetched batch is copied to ``device`` (the card unless
    the caller passes ``"cpu"``; pinned and non-blocking on the card) as
    soon as it is produced, ``depth`` batches ahead of consumption.
    ``state_dict`` / ``load_state_dict`` expose the *consumed* cursor;
    loading clears the buffer and seeks the sampler, so the next
    ``next()`` after a restore yields the batch the interrupted run would
    have consumed. The reference's ``sharding=`` (where a batch's shards
    land) is ``device=`` here: a rank takes its data-parallel columns in
    the step.
    """

    def __init__(self, sampler: ShardedIndexIterator,
                 fetch: Callable[[np.ndarray], Any], *,
                 depth: int = 2, device="cuda"):
        from apex_tpu_torch._device import resolve_device
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.sampler = sampler
        self.fetch = fetch
        self.depth = depth
        self.device = resolve_device(device)
        self.consumed = 0
        self._buf: deque = deque()

    def _put_leaf(self, x: Any) -> Any:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _put(self, batch: Any) -> Any:
        return tree_map(self._put_leaf, batch)

    def _fill(self) -> None:
        while len(self._buf) < self.depth:
            self._buf.append(self._put(self.fetch(next(self.sampler))))

    def __iter__(self) -> "PrefetchingIterator":
        return self

    def __next__(self) -> Any:
        self._fill()
        batch = self._buf.popleft()
        self.consumed += 1
        self._fill()  # keep the pipeline primed while the step runs
        return batch

    @property
    def num_hosts(self) -> int:
        return self.sampler.num_hosts

    # -- resume -----------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        # the CONSUMED cursor: prefetched-but-unconsumed batches are
        # in-flight state the restore deliberately refetches. The
        # sampler's grid identity (seed/num_hosts/global_batch) rides
        # along so a restore into a different world is caught loudly.
        state = self.sampler.state_dict()
        state["consumed"] = int(self.consumed)
        return state

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.sampler.load_state_dict(state)  # seeks sampler.consumed too
        self.consumed = int(state["consumed"])
        self._buf.clear()

    def reseek(self, state: Dict[str, int]) -> None:
        """World-size-change restore: see
        :meth:`ShardedIndexIterator.reseek`."""
        self.sampler.reseek(state)
        self.consumed = int(state["consumed"])
        self._buf.clear()


def token_batch_fetcher(data: np.ndarray, num_micro: int, rows: int,
                        seq: int) -> Callable[[np.ndarray], Any]:
    """Fetch closure for the GPT trainer: gathers ``num_micro * rows``
    dataset rows of length ``seq + 1`` and splits them into the
    ``(tokens, targets)`` pair of ``(num_micro, rows, seq)`` host tensors
    (``int64``, what the port's embedding and cross-entropy take) the
    hybrid step consumes; the targets are the same rows shifted by one.
    The values are the reference's arrays."""
    data = np.asarray(data)
    if data.ndim != 2 or data.shape[1] < seq + 1:
        raise ValueError(
            f"dataset must be (N, >={seq + 1}), got {data.shape}")

    def fetch(indices: np.ndarray) -> Any:
        if len(indices) != num_micro * rows:
            raise ValueError(
                f"fetch got {len(indices)} indices, expected "
                f"{num_micro} * {rows}")
        chunk = np.take(data, indices, axis=0)[:, :seq + 1]
        chunk = torch.from_numpy(np.ascontiguousarray(
            chunk.reshape(num_micro, rows, seq + 1))).to(torch.int64)
        return chunk[..., :-1].contiguous(), chunk[..., 1:].contiguous()

    return fetch
