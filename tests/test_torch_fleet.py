"""The port's fleet layer against the JAX package's
``apex_tpu/observability/fleet.py``: snapshots, ``merge_registry_dicts``,
``FleetAggregator``'s view, refresh and scrape, ``PostmortemReport``'s
JSON and markdown on the same files, equal field for field (wall times
aside); ``MetricsServer`` scraped live on localhost."""

import json
import math
import urllib.request

import pytest

from apex_tpu.elastic.launch import Heartbeat as JHeartbeat
from apex_tpu.observability import fleet as J
from apex_tpu.observability.registry import MetricsRegistry as JRegistry
from apex_tpu_torch.elastic.launch import Heartbeat as THeartbeat
from apex_tpu_torch.observability import fleet as T
from apex_tpu_torch.observability.registry import MetricsRegistry as TRegistry


def _fill(reg, rank):
    """Counters, gauges (one NaN on rank 2, one unset), histograms (rank
    3's with other bounds) as a rank's registry might hold them."""
    reg.counter("train/steps").inc(10 + rank)
    reg.counter("ckpt/saves").inc(rank)
    reg.gauge("perf/step_wall_ms").set(100.0 + 7.5 * rank)
    reg.gauge("health/grad_norm").set(math.nan if rank == 2 else 1.5 * rank)
    reg.gauge("never/set")
    bounds = (1.0, 10.0, 100.0) if rank != 3 else (1.0, 5.0)
    h = reg.histogram("ckpt/save_ms", bounds)
    for v in (0.5, 3.0 * (rank + 1), 40.0, 250.0)[:rank + 2]:
        h.observe(v)
    return reg


def _strip(doc):
    """A view, snapshot or postmortem without its wall times (and the
    per-step wall gauge, each package's own clock)."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in ("wall_time", "perf/step_wall_ms")}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _norm(doc):
    """JSON round trip: int keys and NaN as both packages serialize."""
    return json.loads(json.dumps(doc, default=str))


def _publish(mod, registry_cls, run_dir, ranks=4, health=True):
    pubs = []
    for rank in range(ranks):
        reg = _fill(registry_cls(), rank)
        pub = mod.FleetPublisher(str(run_dir), rank=rank, registry=reg)
        if health:
            pub(3 + rank, {"health/nonfinite_count": float(rank == 1),
                           "amp/overflow_count": 0.0, "loss": 1.0})
        pub.publish(5 + rank, force=True)
        pubs.append(pub)
    return pubs


def test_snapshots_match(tmp_path):
    docs = {}
    for name, mod, reg in (("jax", J, JRegistry), ("torch", T, TRegistry)):
        _publish(mod, reg, tmp_path / name)
        docs[name] = mod.FleetAggregator(str(tmp_path / name)).snapshots()
    assert sorted(docs["torch"]) == [0, 1, 2, 3]
    for rank in docs["jax"]:
        j, t = docs["jax"][rank], docs["torch"][rank]
        assert _strip(t) == _strip(j)
        # the step wall gauge is each package's own clock
        assert set(t["registry"]["gauges"]) == set(j["registry"]["gauges"])
    assert T.snapshot_path("/r", 3) == J.snapshot_path("/r", 3)
    assert (T.FLEET_DIR, T.SNAPSHOT_SCHEMA) == (J.FLEET_DIR,
                                                J.SNAPSHOT_SCHEMA)


def _docs():
    return [_fill(JRegistry(), r).to_dict() for r in range(4)]


@pytest.mark.parametrize("sources", [None, [False, True, True, True]])
def test_merge_registry_dicts(sources):
    jm, js = J.merge_registry_dicts(_docs(), stat_sources=sources)
    tm, ts = T.merge_registry_dicts(_docs(), stat_sources=sources)
    assert _norm(ts) == _norm(js)
    assert tm.to_dict() == jm.to_dict()
    assert tm.render_prometheus() == jm.render_prometheus()
    assert ts["skipped_histograms"] == ["ckpt/save_ms[source 3]"]


def test_aggregator_view_refresh_scrape(tmp_path):
    """The same snapshot files read by both aggregators: the view, the
    ``fleet/*`` gauges a refresh writes, and a scrape's merged registry
    with the supervisor's own metrics folded in."""
    _publish(T, TRegistry, tmp_path)
    jsup, tsup = JRegistry(), TRegistry()
    for reg in (jsup, tsup):
        reg.gauge("elastic/world_size").set(4)
        reg.counter("elastic/restarts").inc(1)
    ja = J.FleetAggregator(str(tmp_path), registry=jsup)
    ta = T.FleetAggregator(str(tmp_path), registry=tsup)
    assert _norm(_strip(ta.view())) == _norm(_strip(ja.view()))
    assert _norm(_strip(ta.refresh())) == _norm(_strip(ja.refresh()))
    assert tsup.to_dict() == jsup.to_dict()
    (jv, jm), (tv, tm) = ja.scrape(), ta.scrape()
    assert _norm(_strip(tv)) == _norm(_strip(jv))
    assert tm.render_prometheus() == jm.render_prometheus()
    assert ta.merged_registry().to_dict() == ja.merged_registry().to_dict()
    view = ta.view()
    assert view["steps"] == {0: 5, 1: 6, 2: 7, 3: 8}
    assert view["step_skew"] == 3 and view["slowest_rank"] == 0
    ta.clear()
    assert ta.snapshots() == {}
    assert _norm(_strip(ta.refresh())) == _norm(_strip(ja.refresh()))
    assert tsup.to_dict() == jsup.to_dict()


def test_publisher_throttle_and_step_wall(tmp_path):
    for mod, reg_cls in ((J, JRegistry), (T, TRegistry)):
        reg = reg_cls()
        pub = mod.FleetPublisher(str(tmp_path / mod.__name__), rank=0,
                                 registry=reg, min_interval_s=60.0)
        assert pub.publish(1) is not None
        assert pub.publish(2) is None
        assert pub.publish(3, force=True) is not None
        assert pub.publishes == 2
        assert reg.gauge("perf/step_wall_ms").is_set


def _postmortem_dir(root, hb_cls, health_rank):
    """A gang's leftovers: snapshots (rank ``health_rank`` non-finite),
    heartbeats at steps 4/7/9, and round 2's log tails."""
    for rank in range(3):
        reg = _fill(TRegistry(), rank)
        pub = T.FleetPublisher(str(root), rank=rank, registry=reg)
        pub(1, {"health/nonfinite_count": float(rank == health_rank)})
        pub.publish(4 + rank, force=True)
        hb_cls(str(root), rank).beat((4, 7, 9)[rank])
        (root / "logs").mkdir(exist_ok=True)
        (root / "logs" / f"round2_rank{rank}.log").write_text(
            "".join(f"rank {rank} line {i}\n" for i in range(400)))


@pytest.mark.parametrize("case", [
    dict(returncodes={0: None, 1: -9, 2: 1}, ages={0: 0.5, 1: 3.0, 2: 1.0},
         stalled=(), cause="exit"),
    dict(returncodes={0: None, 1: None, 2: None},
         ages={0: 0.5, 1: 0.2, 2: 0.1}, stalled=(2, 1), cause="stall"),
    dict(returncodes={0: None, 1: None, 2: None}, ages={0: 0.1, 1: 0.2},
         stalled=(), cause="timeout"),
    dict(returncodes={0: 0, 1: 0, 2: None}, ages={0: 0.1, 1: 0.1, 2: 9.0},
         stalled=(), cause="heartbeat", health=-1),
    dict(returncodes={0: 0, 1: 0, 2: 0}, ages={}, stalled=(), cause="exit",
         health=-1),
])
def test_postmortem_report(tmp_path, case):
    """``collect`` over the same directory with the same supervisor
    signals: the culprit, its reason, every rank's forensics, the strict
    JSON and the markdown; ``write`` puts both files in place."""
    _postmortem_dir(tmp_path, THeartbeat, case.get("health", 1))
    kw = dict(round_index=2, world_size=3, cause=case["cause"],
              returncodes=case["returncodes"],
              heartbeat_ages=case["ages"], stalled_ranks=case["stalled"],
              heartbeat_timeout_s=2.0, log_tail_bytes=300)
    j = J.PostmortemReport.collect(str(tmp_path), **kw)
    t = T.PostmortemReport.collect(str(tmp_path), **kw)
    for r in t.ranks + j.ranks:
        if r.rank not in case["ages"]:
            # Heartbeat.age_s reads the clock at each collect
            assert 0.0 <= r.heartbeat_age_s < 60.0
            r.heartbeat_age_s = 0.0
    assert (t.culprit_rank, t.culprit_reason) == (j.culprit_rank,
                                                 j.culprit_reason)
    assert _strip(t.to_dict()) == _strip(j.to_dict())
    assert t.markdown() == j.markdown()
    tj, tm = t.write(str(tmp_path / "pm"))
    with open(tj) as f:
        assert _strip(json.load(f)) == _strip(j.to_dict())
    assert open(tm).read() == j.markdown()
    assert tj.endswith("round2.json") and tm.endswith("round2.md")
    assert JHeartbeat.last_step(str(tmp_path), 2) == 9


def test_metrics_server_live(tmp_path):
    """``/metrics`` and ``/fleet`` answer fresh on every request, an
    unknown route is 404, a failing render 500 (never an exit), and
    nothing listens once closed."""
    reg = TRegistry()
    reg.counter("train/steps").inc(2)
    _publish(T, TRegistry, tmp_path, ranks=2)
    agg = T.FleetAggregator(str(tmp_path), registry=reg)
    box = {"fail": False}

    def render():
        if box["fail"]:
            raise RuntimeError("render broke")
        return agg.scrape()[1].render_prometheus()

    with T.MetricsServer(render, agg.view) as server:
        url = server.url
        text = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=5).read().decode()
        assert "train_steps 23" in text and "fleet_ranks 2" in text
        reg.counter("train/steps").inc(1)
        text = urllib.request.urlopen(f"{url}/metrics?x=1",
                                      timeout=5).read().decode()
        assert "train_steps 24" in text
        doc = json.loads(urllib.request.urlopen(f"{url}/fleet",
                                                timeout=5).read())
        assert doc["ranks"] == [0, 1] and doc["step_skew"] == 1
        assert doc["counters"]["train/steps"]["total"] == 21.0
        for path, code in (("/nope", 404), ("/metrics", 500)):
            box["fail"] = path == "/metrics"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{url}{path}", timeout=5)
            assert e.value.code == code
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{url}/metrics", timeout=0.5)
    with pytest.raises(RuntimeError, match="not started"):
        T.MetricsServer(render).url
