"""Multi-process bootstrap: the worker half of the elastic launcher.

Counterpart of ``apex_tpu/parallel/multiproc.py``. One Python process a
rank; the supervisor (:mod:`apex_tpu_torch.elastic.launch`) hands each
worker its place in the world through the environment, in the same
variables, byte for byte, as the reference, so either package's launcher
can drive either package's worker:

======================  =====================================================
env var                 meaning
======================  =====================================================
APEX_TPU_COORDINATOR    ``host:port`` of the rendezvous (rank 0 serves the
                        ``torch.distributed`` TCP store on it)
APEX_TPU_NUM_PROCESSES  world size (process count)
APEX_TPU_PROCESS_ID     this process's rank in ``[0, num_processes)``
APEX_TPU_LOCAL_DEVICES  CUDA devices a rank drives (unset/0: one)
APEX_TPU_RUN_DIR        scratch dir shared with the supervisor (heartbeats,
                        fleet snapshots)
======================  =====================================================

:func:`initialize` brings up ``torch.distributed`` over
``tcp://<coordinator>``. The backend follows what the ranks see:

- on the card, rank ``r`` takes device ``(r * local_devices) %
  device_count``; when every rank has a card of its own
  (``device_count >= num_processes * local_devices``) the group is NCCL,
  and when ranks share a card (one H100 and two ranks: NCCL refuses two
  ranks on one GPU) it is gloo, which takes CUDA tensors in its
  reductions;
- on the CPU (``device="cpu"``, what the tests ask for) it is gloo.

A worker asked for ``"cuda"`` on a machine with no card raises; it never
carries on on the CPU. Unlike the reference, which skips
``jax.distributed.initialize`` in a world of one, a group is made at
world 1 too when a coordinator is given: the port's meshes
(:mod:`apex_tpu_torch.transformer.parallel_state`) are built over a
process group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional

__all__ = ["ProcessInfo", "initialize", "initialize_from_env",
           "process_env", "process_id", "process_count", "any_process",
           "main",
           "ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
           "ENV_LOCAL_DEVICES", "ENV_RUN_DIR"]

ENV_COORDINATOR = "APEX_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "APEX_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "APEX_TPU_PROCESS_ID"
ENV_LOCAL_DEVICES = "APEX_TPU_LOCAL_DEVICES"
ENV_RUN_DIR = "APEX_TPU_RUN_DIR"

# the process group's limit on a collective: a rank whose peer died fails
# its next collective within it (the supervisor tears the gang down first)
PG_TIMEOUT_S = 300.0

_INFO: Optional["ProcessInfo"] = None


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """What :func:`initialize` established for this process (the
    reference's fields, then the port's ``backend`` and ``device``)."""

    process_id: int
    num_processes: int
    coordinator_address: Optional[str]
    local_devices: Optional[int]
    run_dir: Optional[str]
    backend: Optional[str] = None
    device: Optional[str] = None


def process_env(process_id: int, num_processes: int,
                coordinator_address: str, *,
                local_devices: Optional[int] = None,
                run_dir: Optional[str] = None) -> Dict[str, str]:
    """The env-var block a supervisor hands worker ``process_id``, the
    other half of :func:`initialize_from_env`."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"bad rank {process_id}/{num_processes}")
    env = {ENV_COORDINATOR: str(coordinator_address),
           ENV_NUM_PROCESSES: str(int(num_processes)),
           ENV_PROCESS_ID: str(int(process_id))}
    if local_devices:
        env[ENV_LOCAL_DEVICES] = str(int(local_devices))
    if run_dir:
        env[ENV_RUN_DIR] = str(run_dir)
    return env


def _choose(num_processes: int, process_id: int, local_devices: int,
            device: str):
    """``(backend, device)`` of this rank from what the ranks see."""
    import torch

    from apex_tpu_torch._device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", dev
    count = torch.cuda.device_count()
    per = max(1, int(local_devices or 1))
    index = (process_id * per) % count
    torch.cuda.set_device(index)
    backend = "nccl" if count >= num_processes * per else "gloo"
    return backend, torch.device("cuda", index)


def initialize(coordinator_address: Optional[str], num_processes: int,
               process_id: int, *, local_devices: Optional[int] = None,
               run_dir: Optional[str] = None,
               device="cuda") -> ProcessInfo:
    """Bring this process into a ``num_processes``-wide world.

    With a ``coordinator_address`` (``host:port``) it joins
    ``torch.distributed`` over ``tcp://`` with the backend the module
    docstring gives, and sets this rank's CUDA device; without one (a
    world of one, no supervisor) it only records the world. Returns (and
    caches) a :class:`ProcessInfo`; :func:`process_id` and
    :func:`process_count` read the cache."""
    global _INFO
    if not 0 <= process_id < num_processes:
        raise ValueError(f"bad rank {process_id}/{num_processes}")
    if num_processes > 1 and not coordinator_address:
        raise ValueError(
            "a multi-process world needs a coordinator_address "
            "(host:port; process 0 starts the service on it)")
    backend, dev = _choose(int(num_processes), int(process_id),
                           int(local_devices or 0), device)
    if coordinator_address:
        import torch.distributed as dist
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    else:
        backend = None
    _INFO = ProcessInfo(process_id=int(process_id),
                        num_processes=int(num_processes),
                        coordinator_address=coordinator_address,
                        local_devices=(int(local_devices)
                                       if local_devices else None),
                        run_dir=run_dir, backend=backend, device=str(dev))
    return _INFO


def initialize_from_env(device="cuda") -> Optional[ProcessInfo]:
    """Worker-side bootstrap from the supervisor's env block. Returns
    ``None`` (and does nothing) when ``APEX_TPU_COORDINATOR`` is unset:
    safe to call unconditionally at the top of a training script."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return None
    return initialize(
        coord,
        int(os.environ.get(ENV_NUM_PROCESSES, "1")),
        int(os.environ.get(ENV_PROCESS_ID, "0")),
        local_devices=int(os.environ.get(ENV_LOCAL_DEVICES, "0")) or None,
        run_dir=os.environ.get(ENV_RUN_DIR) or None, device=device)


def process_id() -> int:
    """This process's rank: the :func:`initialize` cache, else the env
    protocol, else 0. Touches no process group (callable from fault
    hooks before any is made)."""
    if _INFO is not None:
        return _INFO.process_id
    return int(os.environ.get(ENV_PROCESS_ID, "0"))


def process_count() -> int:
    """World size, resolved as :func:`process_id` is."""
    if _INFO is not None:
        return _INFO.num_processes
    return int(os.environ.get(ENV_NUM_PROCESSES, "1"))


def any_process(flag: bool) -> bool:
    """OR of a host bool over the world: the elastic runner's
    termination poll. If any process saw the preemption signal, every
    process must take the drain path at the same step, or the others
    wait in the next step's collectives while the drained rank waits in
    the checkpoint's barrier. An ``all_reduce`` with ``MAX`` of one int
    (on the card under NCCL, on the host under gloo); in a world of one,
    the flag itself, with no collective."""
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return bool(flag)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv=None) -> int:
    """CLI: ``python -m apex_tpu_torch.parallel.multiproc -n 2 --
    worker.py args...``, an alias of the elastic supervisor's CLI
    (:func:`apex_tpu_torch.elastic.launch.main`), as the reference's
    is."""
    from apex_tpu_torch.elastic.launch import main as _launch_main

    return _launch_main(argv)


if __name__ == "__main__":
    from apex_tpu_torch.elastic.launch import _supervisor_exit

    _supervisor_exit(main())
