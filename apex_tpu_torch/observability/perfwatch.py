"""Performance observatory: bench history, regression watch, model drift.

The port's copy of ``apex_tpu/observability/perfwatch.py``, host-side
Python over JSON lines that imports no torch and nothing of the JAX
package:

- :class:`BenchHistory`: an append-only JSONL store of bench lines
  (full-precision ``raw_value`` beside the 2-decimal display value, the
  config block, attribution extras, git sha and host provenance), with a
  one-shot importer of ``BENCH_r*.json`` bench dumps;
- :class:`RegressionDetector`: per-metric rolling median + MAD thresholds,
  the good direction read from the unit (``tokens/sec`` up is good,
  ``ms``/``bytes`` down), typed :class:`Regression` findings;
- :class:`AttributionDiff`: region-by-region diff of two attribution
  reports (duck typed: report objects, their dicts, or the compact
  ``[{region, modeled_ms, measured_ms}]`` lists a record carries), so a
  flagged regression names the region that moved;
- :func:`drift_series` / :func:`detect_drift_shifts` /
  :func:`publish_drift`: the measured/modeled ratio of each attributed
  line as a series, ``perf/model_drift`` gauges and a two-sided shift
  alert.

CLI: ``python -m apex_tpu_torch.perfwatch [--check|--report|
--import-bench|--selfcheck]``; exit 0 clean, 1 regressions, drift shifts
or a dead selfcheck, 2 usage. The JSONL schema is the literal
``HISTORY_FIELDS`` table, which the writer and the reader both check.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import platform
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["HISTORY_FIELDS", "REQUIRED_FIELDS", "FIELD_NAMES",
           "UNIT_DIRECTION", "DEFAULT_HISTORY", "unit_direction",
           "make_record", "validate_record", "detect_git_sha",
           "host_fingerprint", "BenchHistory", "Regression",
           "RegressionDetector", "RegionDelta", "AttributionDiff",
           "DriftShift", "drift_series", "detect_drift_shifts",
           "publish_drift", "selfcheck", "synthetic_history",
           "render_report", "main"]

# ---------------------------------------------------------------------------
# the JSONL schema: one literal table, one writer, one lint
# ---------------------------------------------------------------------------

DEFAULT_HISTORY = "BENCH_HISTORY.jsonl"

# The history record schema. ``required`` keys appear in EVERY record
# (the base dict literal in :func:`make_record`); ``optional`` keys are
# promoted from the extras when present. This table is the single
# source of truth: the ``ast-bench-history`` lint statically checks the
# writer's literal keys against it, and any on-disk history file against
# both — so a drive-by key rename cannot silently fork the schema.
HISTORY_FIELDS = (
    ("metric", "required"),       # bench line name
    ("value", "required"),        # 2-decimal display value (bench parity)
    ("raw_value", "required"),    # full-precision value (detector input)
    ("unit", "required"),         # bench unit string (direction source)
    ("vs_baseline", "required"),  # the line's own baseline ratio or null
    ("run", "required"),          # round id ("r05", gate leg, ...) or null
    ("source", "required"),       # "bench" | importer filename | caller tag
    ("git_sha", "required"),      # code provenance
    ("host", "required"),         # host fingerprint (cross-host noise)
    ("config", "optional"),         # the line's TrainConfig-shaped block
    ("modeled_step_ms", "optional"),    # modeled roofline lower bound
    ("comm_exposed_ms", "optional"),    # modeled unhidden communication
    ("overlap_efficiency", "optional"),  # hidden-fraction of ICI bytes
    ("step_time_ms", "optional"),   # measured step (drift numerator)
    ("attribution", "optional"),    # per-region [{region, modeled_ms,
                                    #   measured_ms}] (diff input)
    ("extra", "optional"),          # everything else the line carried
)

REQUIRED_FIELDS = frozenset(
    k for k, kind in HISTORY_FIELDS if kind == "required")
FIELD_NAMES = frozenset(k for k, _kind in HISTORY_FIELDS)

# optional keys lifted from a bench line's extras to top-level record
# keys (everything else rides under "extra") — derived from the table so
# the writer cannot drift from the schema
_PROMOTED = tuple(k for k, kind in HISTORY_FIELDS
                  if kind == "optional" and k not in ("config", "extra"))

# unit -> good direction: +1 up-is-good, -1 down-is-good, 0 not a
# performance series (skip lines / error lines / unknown units). The
# exact spellings are the ones bench.py emits; unlisted units fall back
# to suffix inference in :func:`unit_direction`.
UNIT_DIRECTION = {
    "imgs/sec": 1,
    "tokens/sec": 1,
    "percent": 1,     # goodput: fraction of requests meeting the SLO
    "ms": -1,
    "bytes": -1,
    "skipped": 0,
    "error": 0,
}


def unit_direction(unit: str) -> int:
    """+1 when larger is better, -1 when smaller is better, 0 when the
    unit carries no performance direction (the detector skips it)."""
    u = str(unit)
    if u in UNIT_DIRECTION:
        return UNIT_DIRECTION[u]
    if u.endswith("/sec") or u.endswith("/s"):
        return 1
    if u.endswith("ms") or u.endswith("bytes") or u in ("s", "sec"):
        return -1
    return 0


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

_GIT_SHA_CACHE: Dict[str, str] = {}


def _package_root() -> str:
    """The repo root this package is installed from
    (``<repo>/apex_tpu_torch/observability/perfwatch.py``)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def detect_git_sha(repo: Optional[str] = None) -> str:
    """Short HEAD sha of ``repo`` (default: the package's own tree), or
    ``"unknown"`` outside a checkout — provenance must never fail a
    bench run."""
    root = os.path.abspath(repo or _package_root())
    if root not in _GIT_SHA_CACHE:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"], cwd=root,
                capture_output=True, text=True, timeout=10)
            sha = out.stdout.strip() if out.returncode == 0 else ""
        except (OSError, subprocess.SubprocessError):
            sha = ""
        _GIT_SHA_CACHE[root] = sha or "unknown"
    return _GIT_SHA_CACHE[root]


def host_fingerprint() -> str:
    """``node/arch/pyX.Y`` — enough to separate series recorded on
    different hosts (a CPU host and a GPU host must never share a noise
    floor)."""
    return "%s/%s/py%d.%d" % (
        platform.node() or "unknown", platform.machine() or "unknown",
        sys.version_info[0], sys.version_info[1])


# ---------------------------------------------------------------------------
# records + the append-only store
# ---------------------------------------------------------------------------

def make_record(metric: str, value: float, unit: str,
                vs_baseline: Optional[float] = None, *,
                raw_value: Optional[float] = None,
                run: Optional[str] = None, source: str = "bench",
                extras: Optional[dict] = None,
                git_sha: Optional[str] = None,
                host: Optional[str] = None) -> dict:
    """One schema-complete history record.

    ``value`` mirrors bench.py's printed 2-decimal display value;
    ``raw_value`` carries the FULL-PRECISION number (defaults to
    ``value`` before rounding) — the detector always reads
    ``raw_value``, so sub-0.5% deltas survive the display quantization
    that forced ``gpt_decode_goodput`` into percent. Extras named in
    ``HISTORY_FIELDS`` are promoted to top-level keys; the remainder
    rides under ``extra``.
    """
    raw = float(value if raw_value is None else raw_value)
    rec = {
        "metric": str(metric),
        "value": round(float(value), 2),
        "raw_value": raw,
        "unit": str(unit),
        "vs_baseline": None if vs_baseline is None else float(vs_baseline),
        "run": run,
        "source": str(source),
        "git_sha": git_sha if git_sha is not None else detect_git_sha(),
        "host": host if host is not None else host_fingerprint(),
    }
    leftover = dict(extras or {})
    config = leftover.pop("config", None)
    if config is not None:
        rec["config"] = config
    for key in _PROMOTED:
        if key in leftover:
            rec[key] = leftover.pop(key)
    if leftover:
        rec["extra"] = leftover
    return rec


def validate_record(rec: Any) -> None:
    """Raise ``ValueError`` unless ``rec`` matches ``HISTORY_FIELDS``
    (every required key present, no key outside the table)."""
    if not isinstance(rec, dict):
        raise ValueError(f"history record must be a dict, "
                         f"got {type(rec).__name__}")
    missing = sorted(REQUIRED_FIELDS - set(rec))
    unknown = sorted(set(rec) - FIELD_NAMES)
    if missing or unknown:
        raise ValueError(
            f"history record for {rec.get('metric', '?')!r} violates "
            f"HISTORY_FIELDS: missing {missing}, unknown {unknown}")


class BenchHistory:
    """Append-only JSONL store of bench records, in metric/time order.

    ``path=None`` keeps the history in memory (selfchecks, gate legs);
    with a path, every :meth:`append` writes one JSON line — append-only
    by construction, so concurrent readers never see a torn file and
    provenance is never rewritten.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        if path is not None and os.path.exists(path):
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError as e:
                        raise ValueError(
                            f"{path}:{lineno}: not a JSON record: {e}")
                    validate_record(rec)
                    self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def append(self, rec: dict) -> dict:
        validate_record(rec)
        self.records.append(rec)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def record(self, metric: str, value: float, unit: str,
               vs_baseline: Optional[float] = None, **kwargs) -> dict:
        """Build (via :func:`make_record`) and append one record."""
        return self.append(make_record(metric, value, unit, vs_baseline,
                                       **kwargs))

    def metrics(self) -> List[str]:
        """Metric names in first-seen order."""
        seen: Dict[str, None] = {}
        for rec in self.records:
            seen.setdefault(rec["metric"], None)
        return list(seen)

    def series(self, metric: str) -> List[dict]:
        """Every record for ``metric``, in append order."""
        return [r for r in self.records if r["metric"] == metric]

    # -- the one-shot importer ---------------------------------------

    def import_bench_files(self, paths: Optional[Sequence[str]] = None,
                           root: Optional[str] = None) -> int:
        """Ingest historical ``BENCH_r*.json`` bench dumps
        (``{n, cmd, rc, tail, parsed}`` — the metric lines are the
        ``tail`` lines opening with ``{``). Idempotent per file: a
        source filename already present in the history is skipped, so
        re-running the importer never duplicates a round. Returns the
        number of records added. Historical lines predate ``raw_value``,
        so it equals the 2-decimal value there — the detector's noise
        floor covers the quantization."""
        if paths is None:
            root = root or _package_root()
            paths = sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
        seen_sources = {r.get("source") for r in self.records}
        added = 0
        for path in paths:
            base = os.path.basename(path)
            if base in seen_sources:
                continue
            with open(path) as f:
                dump = json.load(f)
            if not isinstance(dump, dict):
                continue
            run = (f"r{int(dump['n']):02d}" if isinstance(
                dump.get("n"), int) else os.path.splitext(base)[0])
            for line in str(dump.get("tail", "")).splitlines():
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(obj, dict) or "metric" not in obj \
                        or "value" not in obj:
                    continue
                extras = {k: v for k, v in obj.items()
                          if k not in ("metric", "value", "unit",
                                       "vs_baseline")}
                self.record(str(obj["metric"]), float(obj["value"]),
                            str(obj.get("unit", "")), obj.get("vs_baseline"),
                            run=run, source=base, extras=extras,
                            git_sha="import", host="import")
                added += 1
        return added


# ---------------------------------------------------------------------------
# the regression detector
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Regression:
    """One direction-adverse shift of a metric beyond its noise."""
    metric: str
    index: int              # position within the metric's series
    run: Optional[str]
    value: float
    baseline: float         # rolling median the point was scored against
    delta_frac: float       # signed (value - baseline) / |baseline|
    threshold_frac: float   # the learned noise floor it exceeded
    unit: str
    direction: int          # +1 up-is-good, -1 down-is-good
    suspect_region: Optional[str] = None
    suspect_delta_ms: Optional[float] = None

    def message(self) -> str:
        good = "up-is-good" if self.direction > 0 else "down-is-good"
        msg = (f"{self.metric}[{self.run or self.index}] = "
               f"{self.value:g} {self.unit}: {self.delta_frac:+.1%} vs "
               f"rolling median {self.baseline:g} "
               f"(threshold ±{self.threshold_frac:.1%}, {good})")
        if self.suspect_region is not None:
            msg += (f"; suspect region {self.suspect_region} "
                    f"({self.suspect_delta_ms:+.3f} ms)")
        return msg


class RegressionDetector:
    """Rolling-median + MAD change detection over a :class:`BenchHistory`.

    Each point is scored against the median of the up-to-``window``
    points since the last accepted level; the threshold is the larger of
    ``mad_scale`` scaled-MADs (``1.4826 * MAD`` estimates sigma for
    normal noise — the floor *learned from the history's own variance*)
    and the ``noise_floor`` relative minimum (timer jitter on a quiet
    series, and the 2-decimal quantization of pre-``raw_value``
    imports). A firing resets the baseline to the new level, so a step
    change fires exactly ONCE instead of once per post-step point, and
    the metric keeps being watched at its new level.
    """

    def __init__(self, window: int = 6, mad_scale: float = 4.0,
                 min_points: int = 3, noise_floor: float = 0.02):
        if window < min_points:
            raise ValueError(f"window {window} < min_points {min_points}")
        self.window = int(window)
        self.mad_scale = float(mad_scale)
        self.min_points = int(min_points)
        self.noise_floor = float(noise_floor)

    def check_series(self, values: Sequence[float], direction: int = -1,
                     two_sided: bool = False
                     ) -> List[Tuple[int, float, float, float]]:
        """``(index, baseline, delta_frac, threshold_frac)`` for every
        firing point. ``two_sided=True`` flags ANY shift beyond the
        threshold regardless of direction (the drift-shift mode)."""
        out = []
        start = 0
        for i in range(len(values)):
            ref = list(values[max(start, i - self.window):i])
            if len(ref) < self.min_points:
                continue
            med = _median(ref)
            if med == 0.0:
                continue
            mad = _median([abs(v - med) for v in ref])
            learned = self.mad_scale * 1.4826 * mad / abs(med)
            thresh = max(learned, self.noise_floor)
            delta = (values[i] - med) / abs(med)
            bad = abs(delta) > thresh if two_sided \
                else direction * delta < -thresh
            if bad:
                out.append((i, med, delta, thresh))
                start = i  # accept the new level; fire once per step
        return out

    def check(self, history: BenchHistory) -> List[Regression]:
        """Typed :class:`Regression` findings over every directional
        metric in the history, with the suspect region attached from an
        :class:`AttributionDiff` when the flagged and a prior record
        both carry per-region attribution."""
        findings = []
        for metric in history.metrics():
            recs = history.series(metric)
            direction = _series_direction(recs)
            if direction == 0:
                continue
            values = [float(r.get("raw_value", r["value"])) for r in recs]
            for i, med, delta, thresh in self.check_series(
                    values, direction=direction):
                suspect = region_delta = None
                after = recs[i].get("attribution")
                before = next((recs[j].get("attribution")
                               for j in range(i - 1, -1, -1)
                               if recs[j].get("attribution")), None)
                if after and before:
                    worst = AttributionDiff(before, after).suspect()
                    if worst is not None:
                        suspect = worst.region
                        region_delta = worst.delta_ms
                findings.append(Regression(
                    metric=metric, index=i, run=recs[i].get("run"),
                    value=values[i], baseline=med, delta_frac=delta,
                    threshold_frac=thresh, unit=str(recs[i]["unit"]),
                    direction=direction, suspect_region=suspect,
                    suspect_delta_ms=region_delta))
        return findings


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty sequence")
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _series_direction(recs: Sequence[dict]) -> int:
    """A series' good direction from its units (the latest record wins —
    a renamed-unit metric is a renamed metric)."""
    for rec in reversed(recs):
        d = unit_direction(rec.get("unit", ""))
        if d != 0:
            return d
    return 0


# ---------------------------------------------------------------------------
# attribution diffs: name the region that moved
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegionDelta:
    """One region's ms movement between two attribution reports."""
    region: str
    before_ms: float
    after_ms: float
    delta_ms: float
    delta_frac: Optional[float]  # None when before_ms == 0
    basis: str                   # "measured" | "modeled"


class AttributionDiff:
    """Region-by-region diff of two attribution reports.

    Accepts report objects with a ``regions`` list (the reference's
    ``AttributionReport``), their ``as_dict()`` forms, or the compact
    ``[{region, modeled_ms, measured_ms}]`` lists a history record
    carries; duck typed, so this module imports no profiler package. Per region the
    diff prefers measured ms (present on both sides) and falls back to
    modeled ms; :meth:`suspect` is the region whose time grew the most.
    """

    def __init__(self, before: Any, after: Any):
        b, a = _region_table(before), _region_table(after)
        self.regions: List[RegionDelta] = []
        for name in list(b) + [n for n in a if n not in b]:
            bm, bmod = b.get(name, (None, None))
            am, amod = a.get(name, (None, None))
            if bm is not None and am is not None:
                basis, x, y = "measured", bm, am
            elif bmod is not None and amod is not None:
                basis, x, y = "modeled", bmod, amod
            else:
                continue
            self.regions.append(RegionDelta(
                region=name, before_ms=x, after_ms=y, delta_ms=y - x,
                delta_frac=(y - x) / x if x else None, basis=basis))
        self.regions.sort(key=lambda d: -abs(d.delta_ms))

    def suspect(self) -> Optional[RegionDelta]:
        """The region that got SLOWER the most, or None when nothing
        grew (the regression is outside the attributed step)."""
        grew = [d for d in self.regions if d.delta_ms > 0]
        return max(grew, key=lambda d: d.delta_ms) if grew else None

    def markdown(self) -> str:
        lines = ["| region | before ms | after ms | delta ms | basis |",
                 "|---|---|---|---|---|"]
        for d in self.regions:
            lines.append(f"| {d.region} | {d.before_ms:.4f} | "
                         f"{d.after_ms:.4f} | {d.delta_ms:+.4f} | "
                         f"{d.basis} |")
        return "\n".join(lines)


def _region_table(report: Any) -> Dict[str, Tuple[Optional[float],
                                                  Optional[float]]]:
    """``{region: (measured_ms, modeled_ms)}`` from any report shape."""
    regions = getattr(report, "regions", None)
    if regions is None:
        regions = report.get("regions", []) if isinstance(report, dict) \
            else report
    out: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
    for r in regions or ():
        if isinstance(r, dict):
            name = r.get("region", r.get("name"))
            measured, modeled = r.get("measured_ms"), r.get("modeled_ms")
        else:
            name = getattr(r, "name", None)
            measured = getattr(r, "measured_ms", None)
            modeled = getattr(r, "modeled_ms", None)
        if name is not None:
            out[str(name)] = (
                None if measured is None else float(measured),
                None if modeled is None else float(modeled))
    return out


# ---------------------------------------------------------------------------
# cost-model drift: measured/modeled as a time series
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftShift:
    """A two-sided shift of a metric's measured/modeled ratio — either
    the code got slower against a stable model, or the model stopped
    pricing the program (both block the autotuner trusting it)."""
    metric: str
    index: int
    run: Optional[str]
    ratio: float
    baseline_ratio: float
    delta_frac: float
    threshold_frac: float

    def message(self) -> str:
        return (f"{self.metric}[{self.run or self.index}] model-drift "
                f"ratio {self.ratio:.3f} shifted {self.delta_frac:+.1%} "
                f"vs rolling median {self.baseline_ratio:.3f} "
                f"(threshold ±{self.threshold_frac:.1%})")


def drift_series(history: BenchHistory
                 ) -> Dict[str, List[Tuple[int, Optional[str], float]]]:
    """``{metric: [(index, run, measured/modeled)]}`` for every record
    carrying both a measured step time (``step_time_ms``, the
    ``step_ms`` extra, or the raw value of an ``ms``-unit line) and the
    modeled ``modeled_step_ms`` roofline. Ratio 1.0 means the model
    prices the program exactly; the ratio's *level* is the systematic
    model gap, its *shifts* are what :func:`detect_drift_shifts`
    alerts on."""
    out: Dict[str, List[Tuple[int, Optional[str], float]]] = {}
    for metric in history.metrics():
        pts = []
        for i, rec in enumerate(history.series(metric)):
            modeled = rec.get("modeled_step_ms")
            measured = rec.get("step_time_ms")
            if measured is None:
                measured = (rec.get("extra") or {}).get("step_ms")
            if measured is None and rec.get("unit") == "ms":
                measured = rec.get("raw_value", rec.get("value"))
            if not modeled or not measured:
                continue
            pts.append((i, rec.get("run"),
                        float(measured) / float(modeled)))
        if pts:
            out[metric] = pts
    return out


def detect_drift_shifts(history: BenchHistory,
                        detector: Optional[RegressionDetector] = None
                        ) -> List[DriftShift]:
    """Two-sided rolling-median + MAD alerts over every drift series.
    Improvements alert too: a ratio suddenly *dropping* means the model
    or the measurement changed, and the autotuner must not silently
    retune against it."""
    det = detector or RegressionDetector()
    findings = []
    for metric, pts in drift_series(history).items():
        ratios = [p[2] for p in pts]
        for i, med, delta, thresh in det.check_series(
                ratios, two_sided=True):
            findings.append(DriftShift(
                metric=metric, index=pts[i][0], run=pts[i][1],
                ratio=ratios[i], baseline_ratio=med, delta_frac=delta,
                threshold_frac=thresh))
    return findings


def publish_drift(history: BenchHistory, registry: Any
                  ) -> Dict[str, float]:
    """Set the latest measured/modeled ratio of every drifting metric as
    a ``perf/model_drift/<metric>`` gauge, plus the single worst ratio
    (largest ``|log ratio|``) as ``perf/model_drift`` — the scalar the
    fleet merge and the autotuner gate watch. Returns the per-metric
    latest ratios."""
    latest: Dict[str, float] = {}
    worst: Optional[float] = None
    for metric, pts in drift_series(history).items():
        ratio = pts[-1][2]
        latest[metric] = ratio
        registry.gauge(f"perf/model_drift/{metric}").set(ratio)
        if ratio > 0 and (worst is None
                          or abs(math.log(ratio)) > abs(math.log(worst))):
            worst = ratio
    if worst is not None:
        registry.gauge("perf/model_drift").set(worst)
    return latest


# ---------------------------------------------------------------------------
# selfcheck: clean history silent, planted regression fires
# ---------------------------------------------------------------------------

# deterministic per-mille wiggle cycle for the synthetic series — well
# inside the detector's noise floor (no Date/random: selfchecks must be
# byte-reproducible)
_WIGGLE = (0.0, 0.002, -0.002, 0.001, -0.001, 0.003, -0.003, 0.002)

_SELFCHECK_REGIONS = (("gpt_embed", 0.4), ("gpt_attention", 3.0),
                      ("gpt_mlp", 2.2), ("gpt_head_loss", 0.9))


def synthetic_history(planted: bool = False,
                      metric: str = "gpt_fast_tokens_per_sec",
                      n: int = 10, drop_frac: float = 0.20
                      ) -> BenchHistory:
    """An in-memory history of ``n`` runs of ``metric`` around a stable
    level (sub-noise-floor wiggle). With ``planted=True`` the LAST run
    drops by ``drop_frac`` and its attribution block shows
    ``gpt_attention`` absorbing the lost time — the detector must name
    both."""
    hist = BenchHistory()
    base_tps, base_step_ms = 100_000.0, 6.5
    for i in range(n):
        wiggle = _WIGGLE[i % len(_WIGGLE)]
        scale = 1.0 + wiggle
        is_drop = planted and i == n - 1
        if is_drop:
            scale = 1.0 - drop_frac
        tps = base_tps * scale
        step_ms = base_step_ms / scale
        lost_ms = step_ms - base_step_ms
        attribution = [
            {"region": name,
             "modeled_ms": ms,
             "measured_ms": round(
                 ms + (lost_ms if name == "gpt_attention" else 0.0), 4)}
            for name, ms in _SELFCHECK_REGIONS]
        hist.record(metric, tps, "tokens/sec", None, run=f"s{i:02d}",
                    source="selfcheck",
                    extras={"modeled_step_ms": base_step_ms,
                            "step_time_ms": round(step_ms, 4),
                            "attribution": attribution},
                    git_sha="selfcheck", host="selfcheck")
    return hist


def selfcheck() -> Tuple[List[Regression], List[Regression]]:
    """``(clean_findings, planted_findings)``: the clean synthetic history must stay silent AND the
    planted 20% drop must fire *with its suspect region attributed*; a
    detector that fires without naming the region is reported dead (the
    attribution-diff wiring rotted)."""
    det = RegressionDetector()
    clean_hist = synthetic_history(planted=False)
    clean: List[Regression] = det.check(clean_hist)
    clean_drift = detect_drift_shifts(clean_hist)
    planted = [r for r in det.check(synthetic_history(planted=True))
               if r.suspect_region is not None]
    return clean + list(clean_drift), planted  # type: ignore[operator]


# ---------------------------------------------------------------------------
# markdown report
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: Sequence[float]) -> str:
    lo, hi = min(values), max(values)
    if hi == lo:
        return _SPARK[3] * len(values)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in values)


def render_report(history: BenchHistory,
                  detector: Optional[RegressionDetector] = None) -> str:
    """The trajectory + drift tables as markdown (``--report``)."""
    det = detector or RegressionDetector()
    regressions = det.check(history)
    shifts = detect_drift_shifts(history, det)
    lines = ["# Performance observatory", "",
             f"{len(history)} record(s), {len(history.metrics())} "
             f"metric(s).", "", "## Trajectory", "",
             "| metric | unit | n | first | last | delta | trend |",
             "|---|---|---|---|---|---|---|"]
    for metric in history.metrics():
        recs = history.series(metric)
        if _series_direction(recs) == 0:
            continue
        vals = [float(r.get("raw_value", r["value"])) for r in recs]
        delta = ((vals[-1] - vals[0]) / abs(vals[0])
                 if vals[0] else float("nan"))
        lines.append(f"| {metric} | {recs[-1]['unit']} | {len(vals)} | "
                     f"{vals[0]:g} | {vals[-1]:g} | {delta:+.1%} | "
                     f"{_sparkline(vals)} |")
    drift = drift_series(history)
    if drift:
        lines += ["", "## Model drift (measured / modeled)", "",
                  "| metric | n | latest ratio | trend |",
                  "|---|---|---|---|"]
        for metric, pts in drift.items():
            ratios = [p[2] for p in pts]
            lines.append(f"| {metric} | {len(ratios)} | "
                         f"{ratios[-1]:.3f} | {_sparkline(ratios)} |")
    lines += ["", "## Findings", ""]
    if not regressions and not shifts:
        lines.append("No regressions, no drift shifts.")
    for r in regressions:
        lines.append(f"- **REGRESSION** {r.message()}")
    for s in shifts:
        lines.append(f"- **DRIFT** {s.message()}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _load_history(args) -> BenchHistory:
    """The history named by ``--history`` when it exists; otherwise an
    in-memory one bootstrapped from the root's ``BENCH_r*.json`` (the
    no-setup path: ``python -m apex_tpu_torch.perfwatch --check`` works on
    a fresh checkout)."""
    path = args.history or os.path.join(args.root, DEFAULT_HISTORY)
    if os.path.exists(path):
        hist = BenchHistory(path)
    else:
        hist = BenchHistory(path if args.import_bench else None)
    if args.import_bench or not hist.records:
        added = hist.import_bench_files(root=args.root)
        if added:
            print(f"perfwatch: imported {added} record(s) from "
                  f"{args.root}/BENCH_r*.json", file=sys.stderr)
    return hist


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.perfwatch",
        description="performance observatory: bench history, regression "
                    "detection, cost-model drift")
    parser.add_argument("--history", default=None,
                        help=f"JSONL history path (default: "
                             f"<root>/{DEFAULT_HISTORY})")
    parser.add_argument("--root", default=_package_root(),
                        help="repo root holding BENCH_r*.json")
    parser.add_argument("--import-bench", action="store_true",
                        help="one-shot import of BENCH_r*.json into the "
                             "history file (idempotent)")
    parser.add_argument("--check", action="store_true",
                        help="detect regressions + drift shifts "
                             "(default action; exit 1 on findings)")
    parser.add_argument("--report", nargs="?", const="-", default=None,
                        metavar="PATH",
                        help="render the markdown trajectory/drift "
                             "report to PATH (default stdout)")
    parser.add_argument("--selfcheck", action="store_true",
                        help="clean synthetic history must stay silent, "
                             "planted 20%% drop must fire with its "
                             "suspect region")
    parser.add_argument("--window", type=int, default=6)
    parser.add_argument("--noise-floor", type=float, default=0.02)
    args = parser.parse_args(argv)

    if args.selfcheck:
        clean, planted = selfcheck()
        for f in clean:
            print(f"FALSE-POSITIVE {f.message()}")
        if not planted:
            print("perfwatch: planted regression did NOT fire — the "
                  "detector is dead")
        ok = not clean and bool(planted)
        if ok:
            print(f"perfwatch selfcheck ok (clean silent, planted fires "
                  f"{len(planted)} finding(s): "
                  f"{planted[0].message()})")
        return 0 if ok else 1

    try:
        hist = _load_history(args)
    except (OSError, ValueError) as e:
        print(f"perfwatch: {e}", file=sys.stderr)
        return 2

    det = RegressionDetector(window=args.window,
                             noise_floor=args.noise_floor)
    if args.report is not None:
        text = render_report(hist, det)
        if args.report == "-":
            sys.stdout.write(text)
        else:
            with open(args.report, "w") as f:
                f.write(text)
            print(f"perfwatch: report written to {args.report}")
        if not args.check:
            return 0

    regressions = det.check(hist)
    shifts = detect_drift_shifts(hist, det)
    for r in regressions:
        print(f"REGRESSION {r.message()}")
    for s in shifts:
        print(f"DRIFT {s.message()}")
    verdict = "clean" if not (regressions or shifts) else \
        f"{len(regressions)} regression(s), {len(shifts)} drift shift(s)"
    print(f"perfwatch: {len(hist)} record(s), "
          f"{len(hist.metrics())} metric(s) -> {verdict}")
    return 0 if not (regressions or shifts) else 1


if __name__ == "__main__":
    raise SystemExit(main())
