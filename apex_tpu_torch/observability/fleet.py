"""Fleet observability: the port's ``apex_tpu/observability/fleet.py``.

Cross-rank metric merging, straggler signals, gang postmortems and a live
``/metrics`` endpoint, over the port's host registry
(:mod:`apex_tpu_torch.observability.registry`). Everything else in the
port's observability is per rank; this is the merge layer the elastic
supervisor (:class:`~apex_tpu_torch.elastic.launch.LocalLauncher`) reads:

- :class:`FleetPublisher` (rank side): an atomic JSON snapshot of the
  rank's registry (counters, gauges, histogram buckets with their
  observed min/max), the last ``health/*`` payload it was handed and the
  completed step, into ``run_dir/fleet/rank_<i>.json`` (a temporary file,
  then ``os.replace``). Host code only: it never touches a tensor, so a
  step runs the same with it on or off.
- :func:`merge_registry_dicts` / :class:`FleetAggregator` (supervisor
  side): every snapshot merged into one registry (counters sum, gauges
  carry min/max/mean and the spread across ranks, histogram buckets add),
  and the ``fleet/*`` straggler gauges (``fleet/step_skew``,
  ``fleet/slowest_rank``, ``fleet/step_wall_spread_ms``).
- :class:`PostmortemReport`: at a gang's teardown, each rank's last
  snapshot, heartbeat age and log tail in one strict-JSON and markdown
  file naming the likely culprit (dead heartbeat, then stalled step,
  then non-finite health).
- :class:`MetricsServer`: a stdlib ``ThreadingHTTPServer`` serving
  ``/metrics`` (Prometheus text) and ``/fleet`` (the merged JSON); a
  handler error answers 500 and never exits the process.

Snapshots, views, bodies and postmortems have the reference's schema and
field names, so either package's supervisor reads the other's ranks.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry, json_float,
                                                   json_safe_float)

__all__ = ["FLEET_DIR", "SNAPSHOT_SCHEMA", "FleetPublisher",
           "FleetAggregator", "MetricsServer", "PostmortemReport",
           "RankForensics", "merge_registry_dicts", "snapshot_path"]

FLEET_DIR = "fleet"
SNAPSHOT_SCHEMA = 1

_RANK_FILE = re.compile(r"rank_(\d+)\.json$")


def snapshot_path(run_dir: str, rank: int) -> str:
    return os.path.join(run_dir, FLEET_DIR, f"rank_{int(rank)}.json")


def _json_safe_tree(value: Any) -> Any:
    """Recursive strict-JSON conversion: non-finite floats become their
    string spellings at any nesting depth (health payloads legitimately
    carry inf/NaN — that IS the signal the postmortem keeps)."""
    if isinstance(value, float):
        return json_safe_float(value)
    if isinstance(value, dict):
        return {k: _json_safe_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe_tree(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# rank side: the publisher
# ---------------------------------------------------------------------------

class FleetPublisher:
    """Rank-side snapshot writer. Entirely host-side: it reads the host
    registry and writes a file — it never touches the device, so the
    step programs cannot change with it on.

    Call :meth:`publish` once per completed step (the
    :class:`~apex_tpu_torch.elastic.runner.ElasticRunner` does this when
    one is attached); ``min_interval_s`` throttles the disk writes so a
    fast step loop is not one ``os.replace`` per step. Called as a
    function, ``publisher(step, payload)`` (the reference's step-reporter
    hook seat; the reporter itself is queue item A7a), it keeps the
    payload's ``health/*`` entries for the next snapshot, so the
    supervisor sees the last numerics state of every rank without a
    second channel.

    Each write is atomic (temp file + ``os.replace`` in the same
    directory) — the aggregator can read concurrently and never sees a
    torn snapshot, the checkpoint-sidecar discipline.
    """

    def __init__(self, run_dir: str, rank: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 min_interval_s: float = 0.0):
        if rank is None:
            from apex_tpu_torch.parallel import multiproc
            rank = multiproc.process_id()
        self.rank = int(rank)
        self.path = snapshot_path(run_dir, self.rank)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.registry = registry if registry is not None else get_registry()
        self.min_interval_s = float(min_interval_s)
        self._health: Dict[str, float] = {}
        self._last_write: Optional[float] = None   # monotonic
        self._last_step: Optional[Tuple[int, float]] = None  # (step, perf)
        self.publishes = 0

    # -- the reporter hook ---------------------------------------------------
    def __call__(self, step: int, payload: Dict[str, float]) -> None:
        """Reporter-hook seat: keep the payload's numerics-health state
        and publish (throttled). ``amp/overflow_count`` rides along with
        the ``health/*`` keys: it is the overflow signal the reference's
        ``health.payload_nonfinite`` checks (queue item A7a), and the
        postmortem's :func:`_health_nonfinite` reads it on the
        snapshot."""
        health = {k: v for k, v in payload.items()
                  if k.startswith("health/") or k == "amp/overflow_count"}
        if health:
            self._health = health
        self.publish(step)

    # -- the write ----------------------------------------------------------
    def _track_step_wall(self, step: int) -> None:
        """Per-rank wall ms per completed step, as a ``perf/`` gauge so
        the aggregator's gauge merge yields the cross-rank step-wall
        spread — the straggler signal ``fleet/step_wall_spread_ms``."""
        now = time.perf_counter()
        prev, self._last_step = self._last_step, (int(step), now)
        if prev is None:
            return
        d_steps, dt = int(step) - prev[0], now - prev[1]
        if d_steps > 0 and dt > 0.0:
            self.registry.gauge("perf/step_wall_ms").set(
                dt * 1e3 / d_steps)

    def publish(self, step: int, force: bool = False) -> Optional[str]:
        """Write the snapshot for completed step ``step``; returns the
        path, or None when throttled (``min_interval_s`` not elapsed and
        not ``force``)."""
        now = time.monotonic()
        if (not force and self._last_write is not None
                and now - self._last_write < self.min_interval_s):
            return None
        self._track_step_wall(step)
        doc = {
            "schema": SNAPSHOT_SCHEMA,
            "rank": self.rank,
            "step": int(step),
            "wall_time": time.time(),
            "registry": self.registry.to_dict(),
            "health": _json_safe_tree(self._health),
        }
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, allow_nan=False)
        os.replace(tmp, self.path)
        self._last_write = now
        self.publishes += 1
        return self.path


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def merge_registry_dicts(docs: Iterable[dict],
                         stat_sources: Optional[List[bool]] = None
                         ) -> Tuple[MetricsRegistry, dict]:
    """Merge typed registry dicts (:meth:`MetricsRegistry.to_dict`) into
    ``(merged_registry, stats)``.

    Merge rules, per metric kind:

    - **counters** sum (each rank counted its own events);
    - **gauges** land in the merged registry as the cross-source MEAN,
      with ``stats["gauges"][name]`` carrying ``min``/``max``/``mean``/
      ``spread`` (max−min) + the per-source values — the spread is the
      straggler signal a mean would hide;
    - **histograms** add bucket-by-bucket when the bucket bounds match
      (observed min/max combine, sums/counts add), so a percentile of
      the merged histogram estimates the percentile of the POOLED
      samples (bucket-resolution bound unchanged). A source whose bounds
      disagree is skipped for that name and listed in
      ``stats["skipped_histograms"]`` — a half-merged histogram would
      lie, a loud skip does not.

    ``stat_sources`` (one bool per doc, default all-True) restricts
    which sources feed ``stats`` — the merged REGISTRY always folds in
    everything. The aggregator's scrape path uses it to merge the
    supervisor's own registry alongside the rank snapshots in ONE pass
    while keeping the per-rank spread stats rank-only.
    """
    merged = MetricsRegistry()
    gauge_all: Dict[str, List[float]] = {}
    gauge_vals: Dict[str, List[float]] = {}
    counter_vals: Dict[str, List[float]] = {}
    skipped: List[str] = []
    for i, doc in enumerate(docs):
        in_stats = stat_sources[i] if stat_sources is not None else True
        for name, value in doc.get("counters", {}).items():
            if in_stats:
                counter_vals.setdefault(name, []).append(
                    json_float(value))
            merged.counter(name).inc(json_float(value))
        for name, value in doc.get("gauges", {}).items():
            gauge_all.setdefault(name, []).append(json_float(value))
            if in_stats:
                gauge_vals.setdefault(name, []).append(json_float(value))
        for name, h in doc.get("histograms", {}).items():
            bounds = [float(b) for b in h["bounds"]]
            hist = merged.histogram(name, bounds)
            if list(hist.bounds) != sorted(bounds):
                skipped.append(f"{name}[source {i}]")
                continue
            if len(h["counts"]) != len(hist._counts):
                skipped.append(f"{name}[source {i}]")
                continue
            for j, c in enumerate(h["counts"]):
                hist._counts[j] += int(c)
            hist._sum += json_float(h["sum"])
            hist._count += int(h["count"])
            hist._min = min(hist._min, json_float(h["min"]))
            hist._max = max(hist._max, json_float(h["max"]))
    for name, vals in gauge_all.items():
        # the merged registry's gauge = mean over EVERY source
        merged.gauge(name).set(math.fsum(vals) / len(vals))
    gauge_stats: Dict[str, dict] = {}
    for name, vals in gauge_vals.items():
        # NaN-tolerant reductions: a NaN gauge (a health signal) must
        # surface as NaN in the mean, not crash min/max
        finite = [v for v in vals if not math.isnan(v)]
        lo = min(finite) if finite else math.nan
        hi = max(finite) if finite else math.nan
        mean = (math.fsum(vals) / len(vals)) if vals else math.nan
        gauge_stats[name] = {"min": lo, "max": hi, "mean": mean,
                             "spread": hi - lo, "values": list(vals)}
    stats = {"gauges": gauge_stats,
             "counters": {n: {"total": math.fsum(v), "values": list(v)}
                          for n, v in counter_vals.items()},
             "skipped_histograms": skipped}
    return merged, stats


# ---------------------------------------------------------------------------
# supervisor side: the aggregator
# ---------------------------------------------------------------------------

class FleetAggregator:
    """Supervisor-side merge of every rank's published snapshot.

    ``registry`` is the SUPERVISOR's own registry (the one carrying
    ``elastic/*``): :meth:`refresh` writes the ``fleet/*`` straggler
    gauges into it, and :meth:`merged_registry` folds its metrics into
    the combined view the ``/metrics`` endpoint renders — one scrape
    shows the supervisor's policy counters next to the gang's summed
    training counters.
    """

    def __init__(self, run_dir: str,
                 registry: Optional[MetricsRegistry] = None):
        self.run_dir = run_dir
        self.dir = os.path.join(run_dir, FLEET_DIR)
        self.registry = registry if registry is not None else get_registry()

    # -- snapshot IO --------------------------------------------------------
    def snapshots(self) -> Dict[int, dict]:
        """``{rank: snapshot}`` for every readable ``rank_<i>.json``.
        Writes are atomic so a partial file should never exist, but a
        snapshot that fails to parse is SKIPPED, not fatal — the
        supervisor must keep supervising on a half-corrupt fleet dir."""
        out: Dict[int, dict] = {}
        for path in sorted(glob.glob(os.path.join(self.dir,
                                                  "rank_*.json"))):
            m = _RANK_FILE.search(path)
            if not m:
                continue
            try:
                with open(path) as f:
                    out[int(m.group(1))] = json.load(f)
            except (OSError, ValueError):
                continue
        return out

    def clear(self) -> None:
        """Drop every rank snapshot (between supervisor rounds: a stale
        file from the previous gang must not vouch for — or skew — the
        new one; same rule as ``Heartbeat.clear``)."""
        for path in glob.glob(os.path.join(self.dir, "rank_*.json")):
            try:
                os.remove(path)
            except OSError:
                pass

    # -- the merged views ---------------------------------------------------
    # Every method takes an optional preloaded ``snapshots`` dict so one
    # disk read can feed several views: a /metrics scrape builds the
    # fleet gauges AND the merged registry from the SAME snapshot
    # generation (a rank publishing between two independent reads would
    # otherwise make one response describe two different fleets).

    def merged_registry(self, include_local: bool = True,
                        snapshots: Optional[Dict[int, dict]] = None
                        ) -> MetricsRegistry:
        """One registry over supervisor + all rank snapshots — what
        ``/metrics`` renders."""
        docs = []
        if include_local:
            docs.append(self.registry.to_dict())
        snaps = self.snapshots() if snapshots is None else snapshots
        docs.extend(s.get("registry", {})
                    for _, s in sorted(snaps.items()))
        merged, _ = merge_registry_dicts(docs)
        return merged

    def view(self, snapshots: Optional[Dict[int, dict]] = None) -> dict:
        """The raw merged JSON (the ``/fleet`` route): per-rank steps,
        the straggler signals, and the full gauge/counter merge stats."""
        snaps = self.snapshots() if snapshots is None else snapshots
        _, stats = merge_registry_dicts(
            [snaps[r].get("registry", {}) for r in sorted(snaps)])
        return self._view_doc(snaps, stats)

    def _view_doc(self, snaps: Dict[int, dict], stats: dict) -> dict:
        """Assemble the view from an already-computed merge: callers
        that merged for another purpose (the scrape path) reuse their
        stats instead of paying a second cross-rank merge."""
        ranks = sorted(snaps)
        steps = {r: int(snaps[r].get("step", 0)) for r in ranks}
        doc: Dict[str, Any] = {
            "wall_time": time.time(),
            "ranks": ranks,
            "steps": steps,
            "health": {r: snaps[r].get("health", {}) for r in ranks},
            "gauges": stats["gauges"],
            "counters": stats["counters"],
            "skipped_histograms": stats["skipped_histograms"],
        }
        # per-rank step wall, read straight off each snapshot (NOT the
        # merged stats: a rank missing the gauge would shift a zipped
        # mapping) — the spread is the straggler's wall-clock signature
        walls: Dict[int, float] = {}
        for r in ranks:
            v = snaps[r].get("registry", {}).get("gauges", {}) \
                        .get("perf/step_wall_ms")
            if v is not None:
                v = json_float(v)
                if math.isfinite(v):
                    walls[r] = v
        if steps:
            lo, hi = min(steps.values()), max(steps.values())
            doc["step_skew"] = hi - lo
            doc["slowest_rank"] = self._slowest(steps, walls)
        if walls:
            doc["step_wall_spread_ms"] = (max(walls.values())
                                          - min(walls.values()))
        return doc

    @staticmethod
    def _slowest(steps: Dict[int, int], walls: Dict[int, float]) -> int:
        """The straggler: the rank furthest behind in completed steps;
        ties break to the rank with the largest per-step wall
        (``perf/step_wall_ms``), then to the lowest rank id."""
        lo = min(steps.values())
        behind = sorted(r for r, s in steps.items() if s == lo)
        if len(behind) > 1:
            behind.sort(key=lambda r: (-walls.get(r, 0.0), r))
        return behind[0]

    def _publish_gauges(self, doc: dict,
                        reg: Optional[MetricsRegistry] = None) -> None:
        """Write the ``fleet/*`` straggler family off a view. A signal
        absent from the view RESETS its gauge (unset gauges are skipped
        by snapshot/Prometheus) — after :meth:`clear` between rounds, a
        dead gang's skew/straggler must not read as current."""
        reg = self.registry if reg is None else reg
        reg.gauge("fleet/ranks").set(len(doc["ranks"]))
        if "step_skew" in doc:
            reg.gauge("fleet/step_skew").set(doc["step_skew"])
            reg.gauge("fleet/slowest_rank").set(doc["slowest_rank"])
        else:
            reg.gauge("fleet/step_skew").reset()
            reg.gauge("fleet/slowest_rank").reset()
        if "step_wall_spread_ms" in doc:
            reg.gauge("fleet/step_wall_spread_ms").set(
                doc["step_wall_spread_ms"])
        else:
            reg.gauge("fleet/step_wall_spread_ms").reset()

    def refresh(self, snapshots: Optional[Dict[int, dict]] = None) -> dict:
        """Merge now and publish the ``fleet/*`` straggler family into
        the supervisor registry; returns the raw view."""
        doc = self.view(snapshots)
        self._publish_gauges(doc)
        return doc

    def scrape(self) -> Tuple[dict, MetricsRegistry]:
        """The ``/metrics`` fast path: ONE disk read and ONE cross-rank
        merge producing both views — the raw fleet doc (straggler
        gauges published to the supervisor registry) and the combined
        supervisor+ranks registry, with this scrape's own ``fleet/*``
        values folded in (the supervisor doc was serialized before they
        were computed). ``stat_sources`` keeps the per-rank spread
        stats rank-only while the merged registry carries everything."""
        snaps = self.snapshots()
        docs = [self.registry.to_dict()]
        docs.extend(snaps[r].get("registry", {}) for r in sorted(snaps))
        merged, stats = merge_registry_dicts(
            docs, stat_sources=[False] + [True] * len(snaps))
        doc = self._view_doc(snaps, stats)
        self._publish_gauges(doc)          # the supervisor's canonical copy
        self._publish_gauges(doc, merged)  # this scrape's rendered values
        return doc, merged


# ---------------------------------------------------------------------------
# the /metrics endpoint
# ---------------------------------------------------------------------------

class MetricsServer:
    """Stdlib HTTP server for the Prometheus + fleet views.

    ``render_metrics`` is a zero-arg callable returning Prometheus text
    (e.g. ``aggregator.merged_registry().render_prometheus`` composed,
    or a bare ``registry.render_prometheus`` for single-process runs);
    ``render_fleet`` optionally returns the raw merged dict for
    ``/fleet``. Both run per request, so every scrape is fresh. The
    server lives on a daemon thread; ``close()`` shuts it down
    deterministically. A handler exception returns 500 — nothing in
    this class exits the process (the supervisor's exit discipline holds
    in the server thread too).
    """

    def __init__(self, render_metrics: Callable[[], str],
                 render_fleet: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._render_metrics = render_metrics
        self._render_fleet = render_fleet
        self._host = host
        self._port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (None before :meth:`start`); ``port=0`` asks
        the OS for an ephemeral one."""
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    @property
    def url(self) -> str:
        if self._httpd is None:
            raise RuntimeError("MetricsServer not started")
        return f"http://{self._host}:{self.port}"

    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = outer._render_metrics().encode()
                        self._reply(200, body,
                                    "text/plain; version=0.0.4")
                    elif path == "/fleet" and \
                            outer._render_fleet is not None:
                        doc = _json_safe_tree(outer._render_fleet())
                        self._reply(200,
                                    json.dumps(doc,
                                               allow_nan=False).encode(),
                                    "application/json")
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except Exception as e:  # render failure -> 500, never exit
                    try:
                        self._reply(500, f"{type(e).__name__}: {e}\n"
                                    .encode(), "text/plain")
                    except OSError:
                        pass  # client went away mid-error

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="apex-tpu-torch-metrics")
        self._thread.start()
        return self.port

    def close(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the postmortem
# ---------------------------------------------------------------------------

def _tail(path: str, max_bytes: int) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def _health_nonfinite(health: Dict[str, Any]) -> bool:
    """True when a rank's last health payload shows non-finite values —
    the host-side twin of ``health.payload_nonfinite``, tolerant of the
    strict-JSON string spellings the snapshot stores."""
    for key, value in health.items():
        try:
            v = json_float(value)
        except (TypeError, ValueError):
            continue
        if key.endswith("/nonfinite_count") and v > 0:
            return True
        if key == "amp/overflow_count" and v > 0:
            return True
    return False


@dataclasses.dataclass
class RankForensics:
    """Everything the postmortem knows about one rank at teardown."""

    rank: int
    returncode: Optional[int]          # PRE-teardown (None = still alive;
    #                                    the supervisor's own SIGKILL at
    #                                    teardown must not frame a victim)
    heartbeat_age_s: Optional[float]   # monotonic-derived; None = never beat
    last_step: Optional[int]
    stalled: bool                      # mtime moved, step did not (budget)
    nonfinite: bool                    # last snapshot's health flags
    snapshot_step: Optional[int]       # step of the last fleet snapshot
    log_tail: str

    def to_dict(self) -> dict:
        return _json_safe_tree(dataclasses.asdict(self))


# culprit precedence: a rank whose heart stopped (died, or silent past
# the budget) outranks one that is alive-but-stuck, which outranks one
# whose numbers went bad — because each earlier class CAUSES the later
# symptoms in its peers (a dead rank stalls every survivor inside gloo)
_REASONS = ("heartbeat_dead", "stalled_step", "health_nonfinite")


@dataclasses.dataclass
class PostmortemReport:
    """One gang teardown, reconstructed: per-rank forensics plus the
    likely culprit. ``cause`` is the supervisor's round outcome
    (``exit`` / ``heartbeat`` / ``stall`` / ``timeout``); the culprit is
    chosen rank-side: dead heartbeat > stalled step > health non-finite
    (``culprit_reason`` names which class fired; ``unknown`` when no
    signal distinguishes a rank)."""

    round_index: int
    world_size: int
    cause: str
    culprit_rank: Optional[int]
    culprit_reason: str
    ranks: List[RankForensics]
    wall_time: float

    @classmethod
    def collect(cls, run_dir: str, *, round_index: int, world_size: int,
                cause: str, returncodes: Dict[int, Optional[int]],
                heartbeat_ages: Optional[Dict[int, float]] = None,
                stalled_ranks: Iterable[int] = (),
                heartbeat_timeout_s: float = math.inf,
                log_tail_bytes: int = 4096) -> "PostmortemReport":
        """Harvest the on-disk state (fleet snapshots, heartbeat files,
        per-round worker logs) plus the supervisor's in-memory signals
        (pre-teardown exit codes, monotonic heartbeat ages, the stall
        set) into a report."""
        from apex_tpu_torch.elastic.launch import Heartbeat

        heartbeat_ages = heartbeat_ages or {}
        stalled = set(stalled_ranks)
        snaps = FleetAggregator(run_dir).snapshots()
        ranks = []
        for rank in range(world_size):
            snap = snaps.get(rank, {})
            age = heartbeat_ages.get(rank)
            if age is None:
                age = Heartbeat.age_s(run_dir, rank)
            log = os.path.join(run_dir, "logs",
                               f"round{round_index}_rank{rank}.log")
            ranks.append(RankForensics(
                rank=rank,
                returncode=returncodes.get(rank),
                heartbeat_age_s=age,
                last_step=Heartbeat.last_step(run_dir, rank),
                stalled=rank in stalled,
                nonfinite=_health_nonfinite(snap.get("health", {})),
                snapshot_step=(int(snap["step"]) if "step" in snap
                               else None),
                log_tail=_tail(log, log_tail_bytes)))
        culprit, reason = cls._pick_culprit(ranks, heartbeat_timeout_s)
        return cls(round_index=int(round_index),
                   world_size=int(world_size), cause=str(cause),
                   culprit_rank=culprit, culprit_reason=reason,
                   ranks=ranks, wall_time=time.time())

    @staticmethod
    def _pick_culprit(ranks: List[RankForensics],
                      hb_timeout_s: float
                      ) -> Tuple[Optional[int], str]:
        def dead(r: RankForensics) -> bool:
            if r.returncode not in (None, 0):
                return True  # died on its own before teardown
            return (r.heartbeat_age_s is not None
                    and r.heartbeat_age_s > hb_timeout_s)

        candidates = [r for r in ranks if dead(r)]
        if candidates:
            # the rank that stopped beating FIRST is where the cascade
            # started; a missing age sorts last (it beat or never ran)
            candidates.sort(key=lambda r: (-(r.heartbeat_age_s
                                             if r.heartbeat_age_s
                                             is not None else -1.0),
                                           r.rank))
            return candidates[0].rank, "heartbeat_dead"
        stalled = sorted(r.rank for r in ranks if r.stalled)
        if stalled:
            return stalled[0], "stalled_step"
        bad = sorted(r.rank for r in ranks if r.nonfinite)
        if bad:
            return bad[0], "health_nonfinite"
        return None, "unknown"

    # -- artifacts ----------------------------------------------------------
    def to_dict(self) -> dict:
        doc = {"schema": SNAPSHOT_SCHEMA,
               "round_index": self.round_index,
               "world_size": self.world_size,
               "cause": self.cause,
               "culprit_rank": self.culprit_rank,
               "culprit_reason": self.culprit_reason,
               "wall_time": self.wall_time,
               "ranks": [r.to_dict() for r in self.ranks]}
        return _json_safe_tree(doc)

    def markdown(self) -> str:
        lines = [f"# Gang postmortem — round {self.round_index} "
                 f"(world {self.world_size})",
                 "",
                 f"- **cause**: `{self.cause}`",
                 f"- **likely culprit**: "
                 + (f"rank {self.culprit_rank} "
                    f"(`{self.culprit_reason}`)"
                    if self.culprit_rank is not None
                    else f"none identified (`{self.culprit_reason}`)"),
                 "",
                 "| rank | exit (pre-teardown) | hb age s | last step | "
                 "stalled | non-finite |",
                 "|---|---|---|---|---|---|"]
        fmt = lambda v: "-" if v is None else (f"{v:.1f}"
                                               if isinstance(v, float)
                                               else str(v))
        for r in self.ranks:
            lines.append(
                f"| {r.rank} | {fmt(r.returncode)} "
                f"| {fmt(r.heartbeat_age_s)} | {fmt(r.last_step)} "
                f"| {'yes' if r.stalled else 'no'} "
                f"| {'yes' if r.nonfinite else 'no'} |")
        for r in self.ranks:
            if r.log_tail:
                lines += ["", f"## rank {r.rank} log tail", "```",
                          r.log_tail.rstrip("\n"), "```"]
        return "\n".join(lines) + "\n"

    def write(self, out_dir: str) -> Tuple[str, str]:
        """Write ``round<k>.json`` (strict JSON — non-finite values as
        strings, ``allow_nan=False``) and ``round<k>.md`` into
        ``out_dir``; returns both paths."""
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, f"round{self.round_index}")
        json_path, md_path = base + ".json", base + ".md"
        with open(json_path + ".tmp", "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True,
                      allow_nan=False)
        os.replace(json_path + ".tmp", json_path)
        with open(md_path + ".tmp", "w") as f:
            f.write(self.markdown())
        os.replace(md_path + ".tmp", md_path)
        return json_path, md_path
