"""The port's performance observatory against the JAX package's, on the
CPU.

The same histories go through both packages' ``perfwatch``: the synthetic
history (clean and with a planted 20% drop), histories written under
``tmp_path`` as JSONL and as ``BENCH_r*.json`` bench dumps (never the
repo's own files), with wiggles, a step change, a drift shift and a unit
with no direction. The records, regressions (with their suspect regions),
drift shifts, published gauges, unit directions, attribution diffs and
the markdown report must be equal, and the CLI must give the reference's
exit codes (0 clean, 1 findings or a dead selfcheck, 2 a history that
does not parse) and the same lines.
"""

import json

import numpy as np
import pytest

from apex_tpu.observability import perfwatch as jpw
from apex_tpu.observability.registry import MetricsRegistry as JReg
from apex_tpu_torch.observability import MetricsRegistry as TReg
from apex_tpu_torch.observability import perfwatch as tpw

SIDES = (jpw, tpw)


def _records(seed=0, n=14):
    """Bench records: a tokens/s series with a 15% drop at run 9 and
    attribution, an ms series with a drift shift, a percent series, a
    skipped line, and a bytes series."""
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        wig = 1.0 + 0.004 * rng.randn()
        drop = 0.85 if i >= 9 else 1.0
        att = [{"region": "attn", "modeled_ms": 2.0,
                "measured_ms": round(2.5 + (0.9 if i >= 9 else 0.0), 4)},
               {"region": "mlp", "modeled_ms": 1.5,
                "measured_ms": round(1.9 + 0.01 * rng.rand(), 4)}]
        recs.append(("gpt_tps", 9.0e4 * wig * drop, "tokens/sec",
                     dict(run=f"r{i:02d}", extras={
                         "modeled_step_ms": 4.0,
                         "step_time_ms": round(4.4 / (wig * drop), 4),
                         "attribution": att, "batch": 8})))
        recs.append(("step_ms", 6.0 * (1.3 if i >= 10 else 1.0) * wig, "ms",
                     dict(run=f"r{i:02d}", extras={"modeled_step_ms": 5.0})))
        recs.append(("goodput", 99.0 + rng.rand(), "percent",
                     dict(run=f"r{i:02d}")))
        recs.append(("skip_me", 0.0, "skipped", dict(run=f"r{i:02d}")))
        recs.append(("peak", 2.0e9 * wig, "bytes", dict(run=f"r{i:02d}")))
    return recs


def _history(mod, path=None):
    hist = mod.BenchHistory(path)
    for metric, value, unit, kw in _records():
        hist.record(metric, value, unit, None, raw_value=value,
                    git_sha="abc", host="h", **kw)
    return hist


def _findings(mod, hist):
    det = mod.RegressionDetector()
    reg = JReg() if mod is jpw else TReg()
    return ([r.message() for r in det.check(hist)],
            [s.message() for s in mod.detect_drift_shifts(hist, det)],
            mod.publish_drift(hist, reg), reg.snapshot(),
            mod.drift_series(hist))


def test_history_findings_and_report_match(tmp_path):
    jh = _history(jpw, str(tmp_path / "j.jsonl"))
    th = _history(tpw, str(tmp_path / "t.jsonl"))
    assert th.records == jh.records
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    got, want = _findings(tpw, th), _findings(jpw, jh)
    assert got == want
    assert got[0] and got[1]        # a regression and a drift shift fire
    assert any("suspect region attn" in m for m in got[0])
    assert tpw.render_report(th) == jpw.render_report(jh)
    # read back from the files
    assert tpw.BenchHistory(str(tmp_path / "t.jsonl")).records == th.records


@pytest.mark.parametrize("planted", [False, True])
def test_synthetic_history_and_selfcheck(planted):
    got = tpw.synthetic_history(planted=planted)
    want = jpw.synthetic_history(planted=planted)
    assert got.records == want.records
    assert [r.message() for r in tpw.RegressionDetector().check(got)] == \
        [r.message() for r in jpw.RegressionDetector().check(want)]
    clean_t, planted_t = tpw.selfcheck()
    clean_j, planted_j = jpw.selfcheck()
    assert [f.message() for f in clean_t] == [f.message() for f in clean_j]
    assert [f.message() for f in planted_t] == \
        [f.message() for f in planted_j]
    assert not clean_t and planted_t


@pytest.mark.parametrize("unit", ["tokens/sec", "imgs/sec", "ms", "bytes",
                                  "percent", "skipped", "error", "ops/s",
                                  "us", "sec", "widgets", ""])
def test_unit_direction(unit):
    assert tpw.unit_direction(unit) == jpw.unit_direction(unit)


def test_attribution_diff_and_record_validation():
    class Region:
        def __init__(self, name, measured, modeled):
            self.name, self.measured_ms, self.modeled_ms = \
                name, measured, modeled

    class Report:
        def __init__(self, regions):
            self.regions = regions

    before = Report([Region("a", 1.0, 0.5), Region("b", 2.0, 1.0),
                     Region("c", None, 3.0)])
    after = {"regions": [{"region": "a", "measured_ms": 1.6,
                          "modeled_ms": 0.5},
                         {"name": "b", "measured_ms": 1.5},
                         {"region": "c", "modeled_ms": 3.5},
                         {"region": "d", "measured_ms": 9.0}]}
    for mod in SIDES:
        diff = mod.AttributionDiff(before, after)
        assert diff.suspect().region == "a"
    t, j = tpw.AttributionDiff(before, after), jpw.AttributionDiff(before,
                                                                   after)
    assert t.markdown() == j.markdown()
    assert [d.__dict__ for d in t.regions] == [d.__dict__ for d in j.regions]
    for bad in ({"metric": "x"}, [1], dict(tpw.make_record(
            "m", 1.0, "ms", git_sha="s", host="h"), surprise=1)):
        with pytest.raises(ValueError) as te:
            tpw.validate_record(bad)
        with pytest.raises(ValueError) as je:
            jpw.validate_record(bad)
        assert str(te.value) == str(je.value)
    assert tpw.HISTORY_FIELDS == jpw.HISTORY_FIELDS


def _bench_dump(path, n, lines):
    tail = "\n".join(["some log line"] + [json.dumps(x) for x in lines]
                     + ["{not json"])
    path.write_text(json.dumps({"n": n, "cmd": "bench", "rc": 0,
                                "tail": tail, "parsed": {}}))


def _bench_root(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    for i in range(1, 8):
        drop = 0.7 if i == 7 else 1.0
        _bench_dump(root / f"BENCH_r{i:02d}.json", i, [
            {"metric": "gpt_tps", "value": round(1.0e5 * drop + i, 2),
             "unit": "tokens/sec", "vs_baseline": 1.1, "batch": 8},
            {"metric": "dec_ms", "value": 27.0 + 0.01 * i, "unit": "ms",
             "vs_baseline": None}])
    return root


def test_import_bench_files_matches(tmp_path):
    root = _bench_root(tmp_path)
    got, want = tpw.BenchHistory(), jpw.BenchHistory()
    assert got.import_bench_files(root=str(root)) == \
        want.import_bench_files(root=str(root)) == 14
    assert got.import_bench_files(root=str(root)) == 0   # idempotent
    assert got.records == want.records


def _cli(mod, argv, capsys):
    code = mod.main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("case", ["selfcheck", "check_planted", "clean",
                                  "report", "bad_history", "import"])
def test_cli_exit_codes_and_lines(case, tmp_path, capsys):
    root = _bench_root(tmp_path)
    clean = tmp_path / "clean.jsonl"
    hist = tpw.BenchHistory(str(clean))
    for i in range(6):
        hist.record("m", 10.0 + 0.01 * (i % 2), "ms", git_sha="s", host="h")
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{\"metric\": \"m\"}\n")
    argv = {"selfcheck": ["--selfcheck"],
            "check_planted": ["--root", str(root), "--history",
                              str(tmp_path / "none.jsonl")],
            "clean": ["--history", str(clean), "--check"],
            "report": ["--history", str(clean), "--report"],
            "bad_history": ["--history", str(bad)],
            "import": ["--root", str(root), "--history",
                       str(tmp_path / "{side}.jsonl"), "--import-bench"],
            }[case]
    results = []
    for mod, side in ((jpw, "jax"), (tpw, "port")):
        args = [a.replace("{side}", side) for a in argv]
        results.append(_cli(mod, args, capsys))
    (jc, jout, jerr), (tc, tout, terr) = results
    assert tc == jc == {"selfcheck": 0, "check_planted": 1, "clean": 0,
                        "report": 0, "bad_history": 2, "import": 1}[case]
    assert tout.replace("apex_tpu_torch", "apex_tpu") == jout
    assert (terr == "") == (jerr == "")
    if case == "import":
        assert (tmp_path / "port.jsonl").read_text() == \
            (tmp_path / "jax.jsonl").read_text()
