"""A pool of rank processes for ``torch.distributed`` on one host.

The JAX package's tests run every collective on eight virtual CPU devices
of one process; torch needs a process per rank. :class:`RankPool` starts
``world`` ranks with the ``spawn`` context, each of which joins one
process group over a ``FileStore`` in a fresh temporary directory (no TCP
port, so pools in parallel test workers never collide), and then runs the
functions it is handed until the pool closes::

    pool = RankPool(2)                       # NCCL on the card
    outs = pool.run(body, arg, timeout=120)  # body(arg) on every rank
    pool.close()

``body`` must be picklable by reference (a module-level function of a
module the children can import: one that imports neither JAX nor the JAX
package, so a test keeps its rank bodies in such a module). It runs on
every rank with the same arguments and reads its rank from
``torch.distributed.get_rank()``; ``run`` returns the list of what each
rank returned, indexed by rank, with every tensor in it turned into a
numpy array on the host (bf16 as fp32, which holds it exactly).

Every wait has a limit. A rank that does not answer within ``timeout``
seconds (a hang in a collective, a crash) fails the call with
:class:`RankError` and the pool kills every rank and closes: a pool never
blocks its caller past the limit, and never leaves a child behind
(``close`` kills what does not exit in time; an ``atexit`` hook closes
any pool still open). ``device`` is ``"cuda"`` unless the caller asks
for ``"cpu"`` (with no card, ``"cuda"`` raises before any rank starts);
every rank's device is then ``cuda:rank % device_count``. ``backend``
follows the device unless it is passed: ``"nccl"`` on the card,
``"gloo"`` on the CPU (gloo also takes CUDA tensors). ``pg_timeout`` is
the process group's own limit on a collective, in seconds.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

from .._device import resolve_device

__all__ = ["RankPool", "RankError", "children_alive"]

_OPEN: "set[RankPool]" = set()
# seconds the ranks may take to start and join the group (spawn, import
# torch, reach the card)
START_TIMEOUT = 120.0


class RankError(RuntimeError):
    """A rank failed, died or did not answer within the call's limit."""


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor replaced by a numpy array on the host."""
    import torch
    from torch.utils._pytree import tree_map

    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()

    return tree_map(one, obj)


def _child(rank: int, world: int, store: str, backend: str, device: str,
           pg_timeout: float, conn) -> None:
    try:
        import torch
        import torch.distributed as dist

        # one thread a rank: ranks share the host's cores
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout))
        conn.send(("ready", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        fn, args, kwargs = msg
        try:
            conn.send(("ok", _to_host(fn(*args, **kwargs))))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` rank processes joined in one process group; see the
    module's docstring."""

    def __init__(self, world: int, backend: Optional[str] = None,
                 device: str = "cuda", pg_timeout: float = 60.0):
        if world < 1:
            raise ValueError(f"world must be positive, got {world}")
        device = resolve_device(device).type
        self.world = world
        self.backend = backend or ("nccl" if device == "cuda" else "gloo")
        self.device = device
        self._dir = tempfile.mkdtemp(prefix="rankpool_")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_child, name=f"rank{rank}", daemon=True,
                args=(rank, world, os.path.join(self._dir, "store"),
                      self.backend, device, pg_timeout, child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        _OPEN.add(self)
        self._gather(START_TIMEOUT, "join the process group")

    @property
    def alive(self) -> bool:
        return bool(self._procs)

    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def _gather(self, timeout: float, what: str) -> List[Any]:
        deadline = time.monotonic() + timeout
        out: List[Any] = [None] * self.world
        errors = []
        for rank, conn in enumerate(self._conns):
            left = deadline - time.monotonic()
            try:
                ready = conn.poll(max(left, 0.0))
                msg = conn.recv() if ready else None
            except (EOFError, OSError):
                msg = ("err", f"rank {rank} died (exit code "
                              f"{self._procs[rank].exitcode})")
            if msg is None:
                self.close(kill=True)
                raise RankError(f"rank {rank} did not {what} within "
                                f"{timeout:g} s; the pool was killed")
            kind, value = msg
            if kind == "err":
                errors.append(f"rank {rank}:\n{value}")
            else:
                out[rank] = value
        if errors:
            if what == "join the process group":
                self.close(kill=True)
            raise RankError("\n".join(errors))
        return out

    def run(self, fn: Callable, *args, timeout: float = 120.0,
            **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the list of results by
        rank. Raises :class:`RankError` if a rank raised (the pool stays
        open), or died or passed ``timeout`` (the pool is killed)."""
        if not self.alive:
            raise RankError("the rank pool is closed")
        for rank, conn in enumerate(self._conns):
            try:
                conn.send((fn, args, kwargs))
            except (BrokenPipeError, OSError) as e:
                self.close(kill=True)
                raise RankError(f"rank {rank} is gone: {e!r}") from e
        return self._gather(timeout, f"finish {getattr(fn, '__name__', fn)}")

    def close(self, kill: bool = False, timeout: float = 20.0) -> None:
        """Stop every rank: ask each to leave the group and exit, then
        kill what has not exited after ``timeout`` seconds (at once with
        ``kill``). Removes the store's directory."""
        procs, conns = self._procs, self._conns
        self._procs, self._conns = [], []
        if not kill:
            for conn in conns:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
            deadline = time.monotonic() + timeout
            for proc in procs:
                proc.join(max(deadline - time.monotonic(), 0.0))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(5.0)
        for conn in conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        _OPEN.discard(self)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


@atexit.register
def _close_open_pools() -> None:
    for pool in list(_OPEN):
        pool.close(kill=True)


def children_alive(pids: Optional[List[int]]) -> List[int]:
    """Those of ``pids`` that still run (a test's check that a pool left
    no process behind)."""
    alive = []
    for pid in pids or ():
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        except PermissionError:
            pass
        # a zombie has exited: it is only waiting to be reaped
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] == "Z":
                    continue
        except OSError:
            continue
        alive.append(pid)
    return alive
