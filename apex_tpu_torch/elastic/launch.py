"""Localhost multi-process launcher and elastic supervisor: the port's
``apex_tpu/elastic/launch.py``.

The supervisor half of the multi-process runtime (the worker half, the
rendezvous env protocol and the ``torch.distributed`` bootstrap, is
:mod:`apex_tpu_torch.parallel.multiproc`). :class:`LocalLauncher` spawns
a gang of ``num_processes`` workers and supervises them by the
reference's policy:

- **heartbeats**: each worker touches ``run_dir/hb/rank_<r>`` every step
  (:class:`Heartbeat`); a stale heartbeat is a hung rank (a peer of a
  SIGKILLed rank sits in a collective and never exits, so liveness
  cannot be read off process exits alone);
- **gang failure domain**: the ranks of one process group share a store
  and open collectives, so one rank's death poisons the rest. On any
  failure the supervisor tears the WHOLE gang down (SIGTERM, a grace
  window, then SIGKILL: a rank stuck in a collective ignores SIGTERM)
  and relaunches it on a fresh coordinator port; the new workers resume
  from the last COMMITTED checkpoint;
- **bounded restart with backoff**: up to ``max_restarts`` relaunches
  at the same world size, with exponential backoff between rounds;
- **shrink**: once the restart budget at a world size is spent, the
  failure is taken as permanent and the gang relaunches with ``world -
  1`` processes (ranks relabelled ``0..world-1``); the survivors restore
  onto the smaller data group through the runner's reshard
  (:mod:`apex_tpu_torch.elastic.runner`,
  :mod:`apex_tpu_torch.elastic.reshard`). Running out below
  ``min_processes`` returns ``LaunchReport(succeeded=False)`` (CLI exit
  1); exceptions are kept for faults of the supervisor itself.

Metrics (host registry): ``elastic/world_size`` (gauge),
``elastic/restarts`` / ``elastic/shrinks`` (counters),
``elastic/heartbeat_age_s`` (gauge, the oldest heartbeat of the live
ranks). The fleet layer (:mod:`apex_tpu_torch.observability.fleet`)
merges the ranks' published snapshots into the ``fleet/*`` straggler
gauges, writes a :class:`~apex_tpu_torch.observability.fleet.
PostmortemReport` under ``run_dir/postmortem/`` at every round that did
not end ``"ok"``, and with ``metrics_port`` serves the merged view on
``/metrics`` and ``/fleet``. Liveness and progress are told apart: a rank
whose heartbeat keeps moving while its reported step stays put for a
whole ``heartbeat_timeout_s`` is declared stalled (cause ``"stall"``).

Process exits in this package are two: :func:`_supervisor_exit` (the
CLI's exit code) and ``AutoResume.request_resume`` (the runner's
preemption); everything else raises.

CLI: ``python -m apex_tpu_torch.elastic.launch -n 2 -- python worker.py
...`` (also ``python -m apex_tpu_torch.parallel.multiproc``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry)
from apex_tpu_torch.parallel import multiproc

__all__ = ["Heartbeat", "LaunchReport", "LocalLauncher", "RoundResult",
           "main"]

_HB_DIR = "hb"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Heartbeat:
    """File-mtime heartbeat between one worker rank and the supervisor.

    Worker side: ``Heartbeat(run_dir).beat(step)`` each step — an atomic
    JSON payload (``{"schema", "step", "time"}``) into
    ``rank_<r>.json`` FIRST, then the atomic tmp+rename mtime touch of
    the legacy ``rank_<r>`` text file (``"<step> <unix_time>"``). The
    ordering matters: the mtime file is the supervisor's change
    detector, so by the time an mtime moves the step payload it vouches
    for is already on disk — the progress (stall) detector never reads a
    step older than the beat it observed. Supervisor side: :meth:`age_s`
    reads staleness off the file mtime — no shared memory, no sockets,
    works across SIGKILL (the files outlive the writer, so the
    supervisor can also read :meth:`last_step` of a dead rank when
    deciding what the restart will resume from).
    """

    SCHEMA = 1

    def __init__(self, run_dir: str, rank: Optional[int] = None):
        if rank is None:
            rank = multiproc.process_id()
        self.rank = int(rank)
        self.path = os.path.join(run_dir, _HB_DIR, f"rank_{self.rank}")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def beat(self, step: int = 0) -> None:
        import json
        payload = {"schema": self.SCHEMA, "step": int(step),
                   "time": time.time()}
        tmp = f"{self.path}.json.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, f"{self.path}.json")
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{int(step)} {time.time()}\n")
        os.replace(tmp, self.path)

    @staticmethod
    def age_s(run_dir: str, rank: int,
              default: Optional[float] = None) -> Optional[float]:
        """Seconds since rank ``rank`` last beat; ``default`` when it
        never has. Wall-clock (mtime-based) — a debugging convenience;
        the supervisor's hang detection uses the mtime only as a change
        detector and ages with monotonic deltas
        (:meth:`LocalLauncher._heartbeat_age`), so a system clock step
        cannot fake staleness there."""
        path = os.path.join(run_dir, _HB_DIR, f"rank_{rank}")
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            return default

    @staticmethod
    def last_step(run_dir: str, rank: int) -> Optional[int]:
        """The last completed step rank ``rank`` reported — read from
        the JSON payload when present, falling back to the legacy text
        format (external writers that only speak the text protocol stay
        supported; pinned by the stub-worker launcher tests)."""
        import json
        path = os.path.join(run_dir, _HB_DIR, f"rank_{rank}")
        try:
            with open(path + ".json") as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            pass
        try:
            with open(path) as f:
                return int(f.read().split()[0])
        except (OSError, ValueError, IndexError):
            return None

    @staticmethod
    def clear(run_dir: str) -> None:
        """Remove every rank's heartbeat (between rounds: a stale file
        from the previous gang must not vouch for the new one)."""
        shutil.rmtree(os.path.join(run_dir, _HB_DIR), ignore_errors=True)


@dataclasses.dataclass
class RoundResult:
    """One gang launch: its world size, every rank's exit code (negative
    = killed by that signal; ``None`` never materializes — teardown
    always reaps), why the round ended, and — for every non-ok round —
    the path of the :class:`~apex_tpu_torch.observability.fleet
    .PostmortemReport` JSON written at teardown (the ``.md`` twin sits
    next to it)."""

    world_size: int
    returncodes: Dict[int, int]
    cause: str  # "ok" | "exit" | "heartbeat" | "stall" | "timeout"
    postmortem: Optional[str] = None


@dataclasses.dataclass
class LaunchReport:
    """What :meth:`LocalLauncher.run` did end to end."""

    succeeded: bool     # the gang completed (every rank exited 0)
    world_size: int     # world size of the last round actually run
    restarts: int       # same-world relaunches taken
    shrinks: int        # world-size reductions taken
    rounds: List[RoundResult]


class LocalLauncher:
    """Spawn + supervise a localhost multi-process worker gang.

    ``worker_argv`` is the full worker command line; each rank gets it
    verbatim plus the :mod:`~apex_tpu_torch.parallel.multiproc` env block
    (coordinator address on a fresh port per round, world size, rank,
    ``devices_per_process``, ``run_dir``). ``devices_per_process`` is the
    number of CUDA devices a rank drives: rank ``r`` takes card ``(r *
    devices_per_process) % device_count`` in
    :func:`~apex_tpu_torch.parallel.multiproc.initialize`, so on a
    one-card machine every rank sees card 0 and the gang runs over gloo.
    Worker stdout/stderr stream to
    ``run_dir/logs/round<k>_rank<r>.log``.

    The policy knobs mirror the docstring above: ``max_restarts``
    same-world relaunches (backoff ``restart_backoff_s * 2**k``), then
    shrink by one process per permanent failure down to
    ``min_processes``; ``heartbeat_timeout_s`` declares a silent rank
    hung; ``round_timeout_s`` bounds a whole round; ``grace_s`` is the
    SIGTERM→SIGKILL escalation window at teardown.
    """

    def __init__(self, worker_argv: Sequence[str], *, num_processes: int,
                 run_dir: str, devices_per_process: int = 1,
                 min_processes: int = 1, max_restarts: int = 1,
                 restart_backoff_s: float = 0.5,
                 heartbeat_timeout_s: float = 300.0,
                 round_timeout_s: float = 900.0, grace_s: float = 5.0,
                 poll_s: float = 0.05,
                 env: Optional[Dict[str, str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 metrics_port: Optional[int] = None,
                 fleet_refresh_s: float = 0.5):
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not 1 <= min_processes <= num_processes:
            raise ValueError(
                f"need 1 <= min_processes <= num_processes, got "
                f"{min_processes}/{num_processes}")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.worker_argv = list(worker_argv)
        self.num_processes = num_processes
        self.devices_per_process = devices_per_process
        self.run_dir = run_dir
        self.min_processes = min_processes
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.round_timeout_s = round_timeout_s
        self.grace_s = grace_s
        self.poll_s = poll_s
        self.env = env
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._m_world = reg.gauge("elastic/world_size")
        self._m_restarts = reg.counter("elastic/restarts")
        self._m_shrinks = reg.counter("elastic/shrinks")
        self._m_hb_age = reg.gauge("elastic/heartbeat_age_s")
        # the fleet layer (observability/fleet.py): rank snapshots merged
        # into one registry (/metrics, fleet/* straggler gauges) and the
        # gang postmortems written at teardown
        from apex_tpu_torch.observability.fleet import FleetAggregator
        self.fleet = FleetAggregator(run_dir, registry=reg)
        self.metrics_port = metrics_port
        self.bound_metrics_port: Optional[int] = None
        self.fleet_refresh_s = fleet_refresh_s
        self._fleet_refreshed = 0.0  # monotonic of the last refresh
        os.makedirs(os.path.join(run_dir, "logs"), exist_ok=True)

    # -- one gang ---------------------------------------------------------
    def _spawn(self, world: int, round_idx: int) -> List[subprocess.Popen]:
        port = _free_port()  # fresh coordinator per round: the previous
        # gang's service may still hold the old one in TIME_WAIT
        procs = []
        for rank in range(world):
            env = dict(os.environ)
            if self.env:
                env.update(self.env)
            env.update(multiproc.process_env(
                rank, world, f"127.0.0.1:{port}",
                local_devices=self.devices_per_process,
                run_dir=self.run_dir))
            log_path = os.path.join(self.run_dir, "logs",
                                    f"round{round_idx}_rank{rank}.log")
            with open(log_path, "ab") as log:
                procs.append(subprocess.Popen(
                    self.worker_argv, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        return procs

    def _teardown(self, procs: List[subprocess.Popen]) -> None:
        """Reap the whole gang: SIGTERM, grace, SIGKILL. The SIGKILL leg
        is not optional politeness — a survivor of a dead peer sits
        inside a native gloo collective and never services SIGTERM."""
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace_s
        while time.monotonic() < deadline and any(
                p.poll() is None for p in procs):
            time.sleep(self.poll_s)
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in procs:
            p.wait()

    def _heartbeat_age(self, procs: List[subprocess.Popen],
                       started: float, seen: Dict[int, list]) -> float:
        """Max staleness over ranks still running; a rank that never
        beat ages from the round start (it may be compiling — the
        timeout budget covers first-compile).

        The file mtime is used only as a CHANGE detector: ``seen`` maps
        rank -> [last mtime observed, monotonic time of that
        observation, last reported step, monotonic time the STEP last
        advanced], and age is the monotonic delta since the mtime last
        moved. Aging ``time.time() - st_mtime`` directly would mix
        the wall clock into a monotonic budget — an NTP step or VM
        suspend/resume larger than ``heartbeat_timeout_s`` would then
        declare a perfectly healthy gang hung and tear it down.

        The step columns feed :meth:`_stalled_ranks` — liveness (mtime
        moving) is tracked separately from progress (step advancing),
        because a rank wedged inside one step keeps beating forever."""
        now = time.monotonic()
        ages = []
        for rank, p in enumerate(procs):
            if p.poll() is not None:
                continue
            path = os.path.join(self.run_dir, _HB_DIR, f"rank_{rank}")
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                ages.append(now - started)  # never beat yet
                continue
            last = seen.get(rank)
            if last is None or last[0] != mtime:
                step = Heartbeat.last_step(self.run_dir, rank)
                if last is None or step is None or step != last[2]:
                    seen[rank] = [mtime, now, step, now]
                else:  # mtime moved, step did not: keep the step clock
                    seen[rank] = [mtime, now, step, last[3]]
                ages.append(0.0)
            else:
                ages.append(now - last[1])
        return max(ages) if ages else 0.0

    def _stalled_ranks(self, procs: List[subprocess.Popen],
                       seen: Dict[int, list]) -> List[int]:
        """Ranks whose heartbeat mtime keeps moving but whose reported
        step has not advanced for a full ``heartbeat_timeout_s`` budget
        — liveness is not progress (a worker spinning inside a wedged
        collective, or deadlocked after a peer's silent failure, still
        touches its heartbeat). The budget also covers first-compile:
        the step clock starts at the first observed beat, exactly like
        the never-beat clock starts at round start. Ranks whose
        heartbeat carries no parseable step are exempt (external
        writers may only speak the mtime protocol)."""
        now = time.monotonic()
        out = []
        for rank, p in enumerate(procs):
            if p.poll() is not None:
                continue
            last = seen.get(rank)
            if last is None or last[2] is None:
                continue
            if now - last[3] > self.heartbeat_timeout_s:
                out.append(rank)
        return out

    def _fleet_refresh(self, force: bool = False) -> None:
        """Throttled fleet merge: publish the ``fleet/*`` straggler
        gauges off the rank snapshots. Never lethal — the supervisor
        must keep supervising even over a corrupt fleet dir."""
        now = time.monotonic()
        if not force and now - self._fleet_refreshed < self.fleet_refresh_s:
            return
        self._fleet_refreshed = now
        try:
            self.fleet.refresh()
        except Exception:
            pass

    def _run_round(self, world: int, round_idx: int) -> RoundResult:
        Heartbeat.clear(self.run_dir)
        self.fleet.clear()  # rank files of the previous gang must not
        # vouch for (or skew) this one — same rule as the heartbeats
        procs = self._spawn(world, round_idx)
        started = time.monotonic()
        hb_seen: Dict[int, list] = {}
        cause = "timeout"
        stalled: List[int] = []
        pre_rcs: Dict[int, Optional[int]] = {}
        try:
            while True:
                time.sleep(self.poll_s)
                rcs = [p.poll() for p in procs]
                if any(rc not in (None, 0) for rc in rcs):
                    cause = "exit"
                    break
                if all(rc == 0 for rc in rcs):
                    cause = "ok"
                    break
                age = self._heartbeat_age(procs, started, hb_seen)
                self._m_hb_age.set(age)
                self._fleet_refresh()
                if age > self.heartbeat_timeout_s:
                    cause = "heartbeat"
                    break
                stalled = self._stalled_ranks(procs, hb_seen)
                if stalled:
                    cause = "stall"
                    break
                if time.monotonic() - started > self.round_timeout_s:
                    cause = "timeout"
                    break
        finally:
            # exit codes BEFORE teardown: ranks the supervisor is about
            # to SIGKILL must not be framed as self-dead in the
            # postmortem (only a rank that died on its own carries a
            # pre-teardown code)
            pre_rcs = {r: p.poll() for r, p in enumerate(procs)}
            self._teardown(procs)
        postmortem = None
        if cause != "ok":
            postmortem = self._write_postmortem(
                round_idx, world, cause, pre_rcs, hb_seen, stalled,
                started)
        self._fleet_refresh(force=True)  # the final snapshots (ranks
        # publish on exit) reach /metrics and the fleet/* gauges even
        # after the gang is gone
        return RoundResult(
            world_size=world,
            returncodes={r: p.returncode for r, p in enumerate(procs)},
            cause=cause, postmortem=postmortem)

    def _write_postmortem(self, round_idx: int, world: int, cause: str,
                          pre_rcs: Dict[int, Optional[int]],
                          hb_seen: Dict[int, list],
                          stalled: List[int],
                          started: float) -> Optional[str]:
        """Harvest the dead gang into ``run_dir/postmortem/round<k>``
        (strict JSON + markdown). Monotonic heartbeat ages come from the
        supervisor's own change detector (``hb_seen``), not file
        mtimes, so the culprit ordering survives wall-clock steps; a
        rank that NEVER beat ages from the round start — the same clock
        the hang detector used to tear the gang down, so a
        wedged-before-first-beat rank is nameable as the culprit
        instead of dissolving into "unknown". Failure to write is
        logged into the report path as None, never raised — forensics
        must not mask the failure being dissected."""
        from apex_tpu_torch.observability.fleet import PostmortemReport
        now = time.monotonic()
        ages = {}
        for rank in range(world):
            if rank in hb_seen:
                ages[rank] = now - hb_seen[rank][1]
            elif pre_rcs.get(rank) is None:
                # alive pre-teardown and never beat: wedged before its
                # first heartbeat (e.g. inside distributed init) — ages
                # from round start, exactly like the hang detector aged
                # it. A rank that EXITED without beating keeps no
                # supervisor age (clean fast exits must not be framed).
                ages[rank] = now - started
        try:
            report = PostmortemReport.collect(
                self.run_dir, round_index=round_idx, world_size=world,
                cause=cause, returncodes=pre_rcs, heartbeat_ages=ages,
                stalled_ranks=stalled,
                heartbeat_timeout_s=self.heartbeat_timeout_s)
            json_path, _ = report.write(
                os.path.join(self.run_dir, "postmortem"))
            return json_path
        except Exception:
            return None

    # -- the supervisor loop ----------------------------------------------
    def run(self) -> LaunchReport:
        """Launch and supervise until the gang completes (every rank
        exits 0) or the elastic policy is exhausted (the world would
        shrink below ``min_processes``). Policy exhaustion is an
        OUTCOME, not a supervisor bug: it returns
        ``LaunchReport(succeeded=False, ...)`` with the per-round
        forensics (worker logs stay under ``run_dir/logs``), and the
        CLI maps it to exit code 1 through ``_supervisor_exit`` —
        exceptions out of ``run`` are reserved for real supervisor
        failures.

        With ``metrics_port`` set (0 = ephemeral; the bound port lands
        in ``bound_metrics_port``), the supervisor serves the MERGED
        view for the whole run: ``/metrics`` renders its own
        ``elastic/``+``fleet/`` registry combined with every rank
        snapshot (counters summed, gauges averaged) in Prometheus text
        format, ``/fleet`` returns the raw merged JSON. The server
        lives in :mod:`apex_tpu_torch.observability.fleet` and adds no
        process-exit path to this package."""
        server = None
        if self.metrics_port is not None:
            from apex_tpu_torch.observability.fleet import MetricsServer

            def _render() -> str:
                # one disk read + one cross-rank merge per scrape, and
                # the fleet/* gauges describe the same snapshot
                # generation the rendered counters came from (two
                # independent reads could straddle a rank's os.replace)
                _, merged = self.fleet.scrape()
                return merged.render_prometheus()

            server = MetricsServer(_render, self.fleet.view,
                                   port=self.metrics_port)
            self.bound_metrics_port = server.start()
        try:
            world = self.num_processes
            restarts = shrinks = attempts_at_world = 0
            rounds: List[RoundResult] = []
            while True:
                self._m_world.set(world)
                result = self._run_round(world, len(rounds))
                rounds.append(result)
                if result.cause == "ok":
                    return LaunchReport(succeeded=True, world_size=world,
                                        restarts=restarts,
                                        shrinks=shrinks, rounds=rounds)
                if attempts_at_world < self.max_restarts:
                    # transient-death policy: same world, backoff,
                    # relaunch
                    attempts_at_world += 1
                    restarts += 1
                    self._m_restarts.inc()
                    time.sleep(self.restart_backoff_s
                               * (2.0 ** (attempts_at_world - 1)))
                    continue
                # restart budget exhausted: the failure is permanent at
                # this world size. A shrink is only a shrink if the
                # smaller gang may actually launch — exhausting the
                # policy AT min_processes must not count (or emit) a
                # world-size reduction that never happened.
                if world - 1 < self.min_processes:
                    return LaunchReport(
                        succeeded=False, world_size=world,  # last RUN
                        restarts=restarts, shrinks=shrinks,
                        rounds=rounds)
                world -= 1
                shrinks += 1
                attempts_at_world = 0
                self._m_shrinks.inc()
        finally:
            if server is not None:
                server.close()


def main(argv=None) -> int:
    """CLI: ``python -m apex_tpu_torch.elastic.launch -n N [opts] --
    worker cmd...``. Returns the process exit code (0 = the gang
    completed)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.elastic.launch",
        description="localhost multi-process elastic supervisor")
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--min-processes", type=int, default=1)
    ap.add_argument("--max-restarts", type=int, default=1)
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0)
    ap.add_argument("--round-timeout", type=float, default=900.0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the merged fleet registry over HTTP: "
                         "/metrics (Prometheus text) and /fleet (raw "
                         "merged JSON); 0 picks an ephemeral port")
    ap.add_argument("worker", nargs=argparse.REMAINDER,
                    help="worker command line (prefix with --)")
    args = ap.parse_args(argv)
    # strip only the LEADING separator: a later "--" belongs to the
    # worker's own command line and must pass through verbatim
    worker = list(args.worker)
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        ap.error("missing worker command (pass it after --)")
    import tempfile

    run_dir = args.run_dir or tempfile.mkdtemp(
        prefix="apex_tpu_torch_launch_")
    launcher = LocalLauncher(
        worker, num_processes=args.num_processes,
        devices_per_process=args.devices_per_process, run_dir=run_dir,
        min_processes=args.min_processes, max_restarts=args.max_restarts,
        heartbeat_timeout_s=args.heartbeat_timeout,
        round_timeout_s=args.round_timeout,
        metrics_port=args.metrics_port)
    report = launcher.run()
    return 0 if report.succeeded else 1


def _supervisor_exit(code: int) -> None:
    """The one process exit of the supervisor CLI: ``sys.exit`` in this
    package is here and nowhere else (the runner's preemption path exits
    through ``AutoResume.request_resume``; a test holds both); every other
    failure raises."""
    sys.exit(int(code))


if __name__ == "__main__":
    _supervisor_exit(main())
