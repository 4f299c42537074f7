"""The port's serving observability against the JAX package's, on the CPU.

Modules held here: the registry's export (``names``, ``to_dict``,
``from_dict``, ``render_prometheus``, ``json_safe_float``, ``json_float``),
``RequestRecord.to_dict``, ``RequestTrace`` and ``chrome_request_trace``,
``CrashDump`` and ``decode_attribution``, and ``SLOTracker`` with its
``slo/*`` gauges, flight dump and reporter hook. Every input is made from a
seed with numpy and fed to both packages; the outputs must agree: strings
and JSON documents exactly, floats at 1e-12. A document's ``wall_time``,
``versions`` and Chrome-trace ``metadata.epoch_offset_s`` are read from the
clock and the installation, so they are checked for their type only.
"""

import json
import math

import numpy as np
import pytest

from apex_tpu.observability import health as jax_health
from apex_tpu.observability import registry as jax_registry
from apex_tpu.observability import reqtrace as jax_reqtrace
from apex_tpu.observability import slo as jax_slo
from apex_tpu_torch.observability import health, registry, reqtrace, slo
from apex_tpu_torch.observability import sinks as port_sinks
from apex_tpu_torch.observability import trace as port_trace

SIDES = {"jax": (jax_registry, jax_reqtrace, jax_slo, jax_health),
         "port": (registry, reqtrace, slo, health)}
REASONS = ("length", "eos", "cancelled", "expired", "poisoned", "error",
           "capacity")


def _observe_all(reg_mod, seed=0):
    """A registry holding counters, gauges (finite, NaN, +-inf, one never
    set), a default-bucket histogram and two latency histograms, one with
    samples past the last bound, from ``seed``."""
    rng = np.random.RandomState(seed)
    reg = reg_mod.MetricsRegistry()
    reg.counter("serve/admitted").inc(3)
    reg.counter("serve/generated_tokens").inc(float(rng.randint(1, 1000)))
    reg.counter("9lives").inc(0.5)          # a name starting with a digit
    reg.gauge("serve/queue_depth").set(float(rng.randint(0, 8)))
    reg.gauge("slo/goodput").set(float(rng.rand()))
    reg.gauge("health/abs_max").set(math.inf)
    reg.gauge("health/abs_min").set(-math.inf)
    reg.gauge("health/loss").set(math.nan)
    reg.gauge("never/set")
    h = reg.histogram("serve/ttft_ms", reqtrace.LATENCY_BUCKETS_MS)
    for v in rng.lognormal(3.0, 1.5, size=200):
        h.observe(float(v))
    reg.histogram("serve/e2e_ms", reqtrace.LATENCY_BUCKETS_MS).observe(9e4)
    d = reg.histogram("compile/seconds")
    for v in rng.exponential(2.0, size=20):
        d.observe(float(v))
    reg.histogram("empty/hist")
    return reg


def _both_registries(seed=0):
    return _observe_all(jax_registry, seed), _observe_all(registry, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_prometheus_equal(seed):
    j, p = _both_registries(seed)
    assert p.render_prometheus() == j.render_prometheus()
    assert tuple(p.names()) == tuple(j.names())


def test_render_prometheus_empty_registry():
    assert (registry.MetricsRegistry().render_prometheus()
            == jax_registry.MetricsRegistry().render_prometheus() == "")


@pytest.mark.parametrize("seed", [0, 1])
def test_to_dict_equal_as_strict_json(seed):
    j, p = _both_registries(seed)
    pd, jd = p.to_dict(), j.to_dict()
    assert (json.dumps(pd, allow_nan=False, sort_keys=True)
            == json.dumps(jd, allow_nan=False, sort_keys=True))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_from_dict_round_trips_across_packages(direction):
    j, p = _both_registries(3)
    src, dst_cls = ((j, registry.MetricsRegistry)
                    if direction == "jax_to_port"
                    else (p, jax_registry.MetricsRegistry))
    doc = json.loads(json.dumps(src.to_dict(), allow_nan=False))
    back = dst_cls.from_dict(doc)
    assert back.to_dict() == src.to_dict()
    assert back.render_prometheus() == src.render_prometheus()
    for q in (0.0, 50.0, 95.0, 99.0, 100.0):
        assert (back.histogram("serve/ttft_ms").percentile(q)
                == src.histogram("serve/ttft_ms").percentile(q))


def test_from_dict_rejects_mismatched_counts():
    doc = registry.MetricsRegistry().to_dict()
    doc["histograms"]["h"] = {"bounds": [1.0, 2.0], "counts": [1, 2],
                              "sum": 1.0, "count": 3, "min": 0.5,
                              "max": 3.0}
    with pytest.raises(ValueError, match="counts"):
        registry.MetricsRegistry.from_dict(doc)
    with pytest.raises(ValueError, match="counts"):
        jax_registry.MetricsRegistry.from_dict(doc)


@pytest.mark.parametrize("value", [0.0, -0.0, 1.5, -2.25e-30, 1e308,
                                   math.nan, math.inf, -math.inf])
def test_json_safe_float_and_back(value):
    p, j = registry.json_safe_float(value), jax_registry.json_safe_float(value)
    assert type(p) is type(j)
    if isinstance(p, str):
        assert p == j
    else:
        assert math.copysign(1.0, p) == math.copysign(1.0, j) and p == j
    back_p, back_j = registry.json_float(p), jax_registry.json_float(j)
    assert (math.isnan(back_p) and math.isnan(back_j)) or back_p == back_j
    assert (port_sinks.json_safe_value(value)
            == (p if not isinstance(p, float) else value))


def test_json_safe_metrics_matches_sinks():
    from apex_tpu.observability.sinks import json_safe_metrics
    m = {"a": 1.0, "b": math.nan, "c": math.inf, "d": "text", "e": 3}
    assert port_sinks.json_safe_metrics(m) == json_safe_metrics(m)


def test_trace_metadata_keys():
    from apex_tpu.observability.trace import trace_metadata
    p, j = port_trace.trace_metadata(), trace_metadata()
    assert p.keys() == j.keys() and p["clock"] == j["clock"]
    assert isinstance(p["epoch_offset_s"], float)
    assert isinstance(port_trace.epoch_offset(), float)


# -- request records and the Chrome trace ------------------------------------

def _records(mod, n=12, seed=0):
    """``n`` records with seeded stamps: retired ones in every finish
    reason, one-token ones, one still queued, one mid-flight, with ticks."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = float(rng.rand() * 10)
        r = mod.RequestRecord(request_id=i, prompt_len=int(rng.randint(1, 9)),
                              submit_t=t)
        if i == n - 1:
            out.append(r)                      # still queued
            continue
        r.admit_t = t + float(rng.rand() * 0.1)
        r.slot = int(rng.randint(0, 4))
        r.prefill_done_t = r.first_token_t = r.admit_t + 0.01
        ticks = [r.first_token_t + 0.005 * (k + 1)
                 for k in range(int(rng.randint(0, 5)))]
        r.decode_ts = list(ticks)
        r.generated = 1 + len(ticks)
        r.last_token_t = ticks[-1] if ticks else r.first_token_t
        if i != n - 2:                         # n - 2 is mid-flight
            r.retire_t = r.last_token_t
            r.finish_reason = REASONS[i % len(REASONS)]
        out.append(r)
    return out


def test_request_record_to_dict_equal():
    for rp, rj in zip(_records(reqtrace), _records(jax_reqtrace)):
        assert rp.to_dict() == rj.to_dict()
        json.dumps(rp.to_dict(), allow_nan=False)
        for key in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
            assert getattr(rp, key) == getattr(rj, key)


def test_request_record_nonfinite_stamp_becomes_none():
    for mod in (reqtrace, jax_reqtrace):
        r = mod.RequestRecord(request_id=0, prompt_len=1, submit_t=0.0,
                              admit_t=math.inf)
        assert r.to_dict()["admit_t"] is None
        assert r.to_dict()["queue_wait_ms"] is None


@pytest.mark.parametrize("ticks", [True, False])
def test_chrome_request_trace_equal(ticks, tmp_path):
    p = reqtrace.chrome_request_trace(_records(reqtrace), pid=3, ticks=ticks)
    j = jax_reqtrace.chrome_request_trace(_records(jax_reqtrace), pid=3,
                                          ticks=ticks)
    assert p["traceEvents"] == j["traceEvents"]
    assert p["displayTimeUnit"] == j["displayTimeUnit"]
    assert p["metadata"]["clock"] == j["metadata"]["clock"]
    assert isinstance(p["metadata"]["epoch_offset_s"], float)
    assert isinstance(j["metadata"]["epoch_offset_s"], float)
    json.dumps(p, allow_nan=False)
    trace = reqtrace.RequestTrace(capacity=64)
    for r in _records(reqtrace):
        trace.append(r)
    path = tmp_path / "trace.json"
    trace.write_chrome_trace(path, pid=3, ticks=ticks)
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"] == json.loads(json.dumps(p["traceEvents"]))


def test_request_trace_ring_evicts_oldest():
    for mod in (reqtrace, jax_reqtrace):
        trace = mod.RequestTrace(capacity=4)
        recs = _records(mod, n=7)
        for r in recs:
            trace.append(r)
        assert len(trace) == 4
        assert [r.request_id for r in trace.records()] == [3, 4, 5, 6]
        assert [r.request_id for r in trace.last(2)] == [5, 6]
        assert trace.last(0) == [] and len(trace.last(10)) == 4
        assert [r.request_id for r in trace.drain()] == [3, 4, 5, 6]
        assert len(trace) == 0 and trace.drain() == []
        with pytest.raises(ValueError, match="capacity"):
            mod.RequestTrace(capacity=0)


# -- crash dumps -------------------------------------------------------------

PAYLOAD = {"serve/admitted": 3.0, "health/abs_max": math.inf,
           "health/loss": math.nan, "health/zz_tree/first_nonfinite_leaf": 2.0,
           "amp/overflow_count": 1.0}


def _dump_doc(path):
    with open(path) as f:
        doc = json.load(f)
    return doc, {k: v for k, v in doc.items()
                 if k not in ("wall_time", "versions")}


def test_crash_dump_written_as_the_reference_writes_it(tmp_path):
    reqs = [r.to_dict() for r in _records(reqtrace, n=4)]
    reqs[0]["ttft_ms"] = math.inf
    pd = health.CrashDump.from_payload(7, PAYLOAD, requests=reqs)
    jd = jax_health.CrashDump.from_payload(7, PAYLOAD, requests=reqs)
    assert pd.attribution == jd.attribution == {}
    assert pd.config == jd.config == {}
    pdoc, pcore = _dump_doc(pd.write(tmp_path / "p", prefix="poison_dump"))
    jdoc, jcore = _dump_doc(jd.write(tmp_path / "j", prefix="poison_dump"))
    assert pcore == jcore
    assert pcore["metrics"]["health/abs_max"] == "Infinity"
    assert pcore["requests"][0]["ttft_ms"] == "Infinity"
    assert isinstance(pdoc["wall_time"], float)
    assert {"python", "torch", "numpy", "apex_tpu_torch"} <= set(
        pdoc["versions"])
    assert "jax" not in pdoc["versions"]
    assert (tmp_path / "p" / "poison_dump_step00000007.json").is_file()
    assert pd.to_dict()["step"] == jd.to_dict()["step"] == 7


def test_crash_dump_config_from_a_dataclass():
    import dataclasses
    import pathlib

    @dataclasses.dataclass
    class Policy:
        level: str = "cheap"
        dump_dir: pathlib.Path = pathlib.Path("/x/y")

    dump = health.CrashDump.from_payload(0, {}, Policy())
    assert dump.config == {"level": "cheap", "dump_dir": "/x/y"}


def test_decode_attribution_maps_registered_paths(monkeypatch):
    # fresh tables: a JAX optimizer step traced earlier in the process
    # records its "params" tree in the module-wide one
    monkeypatch.setattr(health, "_LEAF_PATHS", {"grads": ["w0", "w1", "w2"]})
    monkeypatch.setattr(jax_health, "_LEAF_PATHS",
                        {"grads": ("w0", "w1", "w2")})
    payload = {"health/grads/first_nonfinite_leaf": 1.0,
               "health/params/first_nonfinite_leaf": 0.0,
               "health/grads/abs_max": 5.0}
    assert (health.decode_attribution(payload)
            == jax_health.decode_attribution(payload) == {"grads": "w1"})
    clean = {"health/grads/first_nonfinite_leaf": -1.0}
    assert health.decode_attribution(clean) == {}


# -- SLO tracking ------------------------------------------------------------

def test_slo_constants_equal():
    assert slo.LATENCY_METRICS == jax_slo.LATENCY_METRICS
    assert slo.ON_VIOLATION == jax_slo.ON_VIOLATION
    assert slo.FAILED_REASONS == jax_slo.FAILED_REASONS
    assert reqtrace.LATENCY_BUCKETS_MS == jax_reqtrace.LATENCY_BUCKETS_MS


@pytest.mark.parametrize("kw, match", [
    (dict(metric="tbt_ms", quantile=95, threshold_ms=1.0), "metric"),
    (dict(metric="ttft_ms", quantile=100, threshold_ms=1.0), "quantile"),
    (dict(metric="ttft_ms", quantile=0, threshold_ms=1.0), "quantile"),
    (dict(metric="ttft_ms", quantile=95, threshold_ms=0.0), "threshold"),
])
def test_slo_target_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        slo.SLOTarget(**kw)
    with pytest.raises(ValueError, match=match):
        jax_slo.SLOTarget(**kw)


@pytest.mark.parametrize("kw, match", [
    (dict(targets=[]), "at least one"),
    (dict(on_violation="page"), "on_violation"),
    (dict(window=0), "window"),
    (dict(consecutive=0), "consecutive"),
])
def test_slo_tracker_validation(kw, match):
    for name, (reg_mod, _, slo_mod, _) in SIDES.items():
        args = dict(targets=[slo_mod.SLOTarget("ttft_ms", 95, 1.0)],
                    registry=reg_mod.MetricsRegistry())
        args.update(kw)
        targets = args.pop("targets")
        with pytest.raises(ValueError, match=match):
            slo_mod.SLOTracker(targets, **args)


def _latency_records(mod, n, seed):
    """``n`` retired records with seeded latencies around the targets and
    every finish reason; some one-token (no TPOT), some never admitted."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        r = mod.RequestRecord(request_id=i, prompt_len=4, submit_t=0.0)
        reason = REASONS[int(rng.randint(len(REASONS)))]
        if reason in ("expired", "cancelled") and rng.rand() < 0.5:
            r.retire_t = float(rng.rand() * 0.01)    # retired while queued
        else:
            r.admit_t = float(rng.rand() * 0.02)
            r.first_token_t = r.admit_t + float(rng.lognormal(-3.5, 0.8))
            r.generated = int(rng.randint(1, 6))
            r.last_token_t = (r.first_token_t
                              + (r.generated - 1) * float(
                                  rng.lognormal(-4.5, 0.6)))
            r.retire_t = r.last_token_t
        r.finish_reason = reason
        out.append(r)
    return out


def _trackers(window, on_violation="skip", consecutive=1, dump_dir="."):
    out = {}
    for name, (reg_mod, rt_mod, slo_mod, _) in SIDES.items():
        targets = [slo_mod.SLOTarget("ttft_ms", 95, 40.0),
                   slo_mod.SLOTarget("tpot_ms", 99, 12.0),
                   slo_mod.SLOTarget("e2e_ms", 90, 60.0)]
        reg = reg_mod.MetricsRegistry()
        trace = rt_mod.RequestTrace(capacity=16)
        out[name] = (slo_mod.SLOTracker(
            targets, window=window, registry=reg, trace=trace,
            on_violation=on_violation, dump_dir=dump_dir,
            flight_n=8, consecutive=consecutive), reg, trace, rt_mod)
    return out


def _close(a, b, tol=1e-12):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= tol * max(1.0, abs(b))


@pytest.mark.parametrize("window, seed", [(512, 0), (16, 1), (5, 2)])
def test_slo_tracker_readouts_equal(window, seed):
    sides = _trackers(window)
    for name, (tracker, reg, _, _) in sides.items():
        assert math.isnan(tracker.goodput())
        assert math.isnan(tracker.max_burn_rate())
    recs = {name: _latency_records(s[3], 60, seed)
            for name, s in sides.items()}
    for i in range(60):
        for name, (tracker, reg, trace, _) in sides.items():
            tracker.observe(recs[name][i])
            trace.append(recs[name][i])
        tp, tj = sides["port"][0], sides["jax"][0]
        assert _close(tp.goodput(), tj.goodput())
        assert _close(tp.max_burn_rate(), tj.max_burn_rate())
        for a, b in zip(tp.targets, tj.targets):
            assert a.describe() == b.describe()
            assert a.error_budget == b.error_budget
            assert _close(tp.burn_rate(a), tj.burn_rate(b))
            assert _close(tp.window_percentile(a), tj.window_percentile(b))
        assert ([t.describe() for t in tp.violating_targets()]
                == [t.describe() for t in tj.violating_targets()])
        assert sides["port"][1].snapshot() == pytest.approx(
            sides["jax"][1].snapshot(), rel=1e-12, abs=0, nan_ok=True)
    assert set(sides["port"][1].snapshot()) == {
        "slo/goodput", "slo/burn_rate", "slo/violating",
        "slo/window_requests"}


def test_failed_reasons_count_against_goodput():
    for name, (reg_mod, rt_mod, slo_mod, _) in SIDES.items():
        tracker = slo_mod.SLOTracker([slo_mod.SLOTarget("e2e_ms", 95, 1e4)],
                                     registry=reg_mod.MetricsRegistry(),
                                     on_violation="skip")
        for i, reason in enumerate(("length", "expired", "poisoned",
                                    "error", "cancelled")):
            r = rt_mod.RequestRecord(request_id=i, prompt_len=1,
                                     submit_t=0.0, retire_t=0.001)
            r.finish_reason = reason
            tracker.observe(r)
        assert tracker.goodput() == pytest.approx(2.0 / 5.0), name


def test_flight_dump_equal_but_wall_time_and_versions(tmp_path):
    sides = _trackers(32, on_violation="dump")
    docs = {}
    for name, (tracker, reg, trace, rt_mod) in sides.items():
        tracker.dump_dir = str(tmp_path / name)
        for r in _latency_records(rt_mod, 24, 4):
            tracker.observe(r)
            trace.append(r)
        path = tracker.flight_dump(step=5, payload={"x": math.nan})
        assert tracker.dumps == [path]
        docs[name] = _dump_doc(path)[1]
    assert docs["port"] == docs["jax"]
    assert len(docs["port"]["requests"]) == 8


@pytest.mark.parametrize("consecutive", [1, 3])
def test_raise_after_consecutive_violating_reports(consecutive, tmp_path):
    sides = _trackers(8, on_violation="raise", consecutive=consecutive,
                      dump_dir=str(tmp_path))
    for name, (tracker, reg, trace, rt_mod) in sides.items():
        err_cls = (slo.SLOViolationError if name == "port"
                   else jax_slo.SLOViolationError)
        tracker.dump_dir = str(tmp_path / name)
        for r in _latency_records(rt_mod, 8, 5):
            r.first_token_t = 10.0        # every TTFT far over its target
            r.last_token_t = r.retire_t = 10.0 + r.generated
            tracker.observe(r)
            trace.append(r)
        for step in range(consecutive - 1):   # violating, below the streak
            tracker(step, {})
        assert tracker.streak == consecutive - 1 and not tracker.dumps
        with pytest.raises(err_cls, match="SLO violated") as info:
            tracker(consecutive, {"serve/admitted": 8.0})
        assert info.value.dump_path == tracker.dumps[-1]
        assert info.value.dump.config["consecutive"] == consecutive
        assert reg.snapshot()["slo/violations"] == 1.0
        with open(info.value.dump_path) as f:
            json.load(f)
        assert tracker.reporter_hook() is tracker


def test_skip_policy_never_dumps_and_clean_report_resets(tmp_path):
    for name, (tracker, reg, trace, rt_mod) in _trackers(
            8, dump_dir=str(tmp_path)).items():
        for r in _latency_records(rt_mod, 8, 5):
            r.first_token_t = 10.0
            tracker.observe(r)
        tracker(0, {})
        assert tracker.dumps == [] and "slo/violations" not in reg.snapshot()
    sides = _trackers(4, on_violation="dump", consecutive=2,
                      dump_dir=str(tmp_path))
    for name, (tracker, reg, trace, rt_mod) in sides.items():
        tracker.dump_dir = str(tmp_path / name)
        for r in _latency_records(rt_mod, 4, 6):
            r.first_token_t = r.last_token_t = r.retire_t = 10.0
            tracker.observe(r)
        tracker(0, {})
        assert tracker.streak == 1
        for i in range(4):                # a clean window resets the streak
            r = rt_mod.RequestRecord(request_id=100 + i, prompt_len=1,
                                     submit_t=0.0, admit_t=0.0,
                                     first_token_t=0.001, retire_t=0.002)
            r.finish_reason = "length"
            tracker.observe(r)
        tracker(1, {})
        assert tracker.streak == 0 and tracker.dumps == []
