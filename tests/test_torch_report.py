"""The port's step reporter, sinks, spans and timers against the JAX
package's, on the CPU.

One scenario runs through each package with ``time.perf_counter`` and
``time.time`` replaced by one fake clock that ticks on every read (reset
before each package's run, so both read the same times): a registry with a
counter and a gauge, a ``Timers`` group whose stops are captured as spans,
in-step metrics reaped from ``record`` calls, a ``StepReporter`` at
interval 2 with a ``JSONLSink``, a ``ChromeTraceSink``, a
``TensorBoardSink`` over a recording writer, two hooks, a FLOP budget (the
``perf/mfu`` gauge, against a stated peak), a memory budget and an
attribution report. The JSONL lines must be equal as dicts, the Chrome
documents equal but for their ``ts`` fields, the writers' calls equal;
hooks run after the sinks and, with the in-step payload alone, on
off-interval steps. Also: ``Timers.log``/``write``, a running timer's
``elapsed``, ``merge_chrome_traces`` (aligned, pid collisions, a missing
offset), ``chrome_trace_events``, ``span_recording``, the null reporter
and ``attach``/``detach``/``get_reporter``, ``device_fence`` on CPU
tensors, and ``profile_trace`` writing a Chrome trace that parses.
"""

import io
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
import apex_tpu.utils.timers as jtimers
import apex_tpu_torch.observability as tobs
import apex_tpu_torch.utils.timers as ttimers


class Clock:
    """Ticks 1.25 ms on every read, from a fixed origin."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        self.t += 0.00125
        return self.t

    def time(self):
        return self.t + 1.7e9


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "perf_counter", c.perf_counter)
    monkeypatch.setattr(time, "time", c.time)
    return c


class Writer:
    def __init__(self):
        self.calls = []
        self.flushed = 0

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, float(value), step))

    def flush(self):
        self.flushed += 1


class Attribution:
    modeled_step_ms = 4.5
    comm_exposed_ms = None
    overlap_efficiency = 0.75


def _scenario(obs, timers_mod, tensor, tmp_path, tag):
    """Six steps through a reporter of ``obs``; everything it wrote."""
    events = []
    jsonl = io.StringIO()
    writer = Writer()
    chrome = tmp_path / f"{tag}.json"
    reg = obs.MetricsRegistry()
    timers = timers_mod.Timers()

    class Tap(obs.JSONLSink):
        def emit(self, step, metrics, spans=()):
            events.append(("sink", step))
            super().emit(step, metrics, spans)

    def hook_a(step, payload):
        events.append(("a", step, sorted(payload)))

    def hook_b(step, payload):
        events.append(("b", step, payload.get("loss")))

    reporter = obs.StepReporter(
        [Tap(jsonl), obs.ChromeTraceSink(chrome, pid=3),
         obs.TensorBoardSink(writer)],
        registry=reg, timers=timers, interval=2, capture_spans=True,
        hooks=[hook_a, hook_b], flops_per_step=2.0e9, peak_flops=1.0e12)
    reporter.attach_memory_budget({
        "peak_hbm_bytes": 10, "temp_bytes": 4, "argument_bytes": 3,
        "output_bytes": 2, "host_temp_bytes": 0})
    reporter.attach_attribution(Attribution())
    payloads = []
    with obs.attach_reporter(reporter):
        assert obs.get_reporter() is reporter
        for step in range(6):
            reg.counter("train/steps").inc()
            reg.gauge("lr").set(1e-3 / (step + 1))
            timers("fwd").start()
            timers("fwd").stop()
            with timers("opt")():
                pass
            if step == 4:
                timers("fwd").start()   # left running: not reported

            def body():
                obs.record("loss", tensor(2.0 - 0.25 * step))
                obs.record("amp/overflow_count", tensor(float(step == 3)),
                           reduce="sum")
                return 0
            _, metrics = obs.reap(body)()
            payloads.append(reporter.report(step, metrics=metrics,
                                            extra={"host/x": step}))
            if step == 4:
                timers("fwd").stop()
    assert not obs.get_reporter()
    with open(chrome) as f:
        doc = json.load(f)
    return {"jsonl": [json.loads(line) for line in
                      jsonl.getvalue().splitlines()],
            "chrome": doc, "writer": writer.calls,
            "flushed": writer.flushed, "events": events,
            "payloads": payloads, "log": timers.log(),
            "spans_on": obs.spans_enabled()}


def _strip_ts(doc):
    return {"traceEvents": [{k: v for k, v in ev.items() if k != "ts"}
                            for ev in doc["traceEvents"]],
            "displayTimeUnit": doc["displayTimeUnit"],
            "metadata": sorted(doc["metadata"])}


def test_reporter_scenario_matches_jax(clock, tmp_path):
    clock.t = 1000.0
    want = _scenario(jobs, jtimers, lambda v: jnp.float32(v), tmp_path,
                     "jax")
    clock.t = 1000.0
    got = _scenario(tobs, ttimers, lambda v: torch.tensor(v), tmp_path,
                    "port")
    assert got["jsonl"] == want["jsonl"]
    assert len(got["jsonl"]) == 3                 # steps 0, 2, 4
    assert "perf/mfu" in got["jsonl"][1]["metrics"]
    assert "time/fwd_ms" not in got["jsonl"][2]["metrics"]  # running
    assert _strip_ts(got["chrome"]) == _strip_ts(want["chrome"])
    assert [ev["ts"] for ev in got["chrome"]["traceEvents"]] == \
        pytest.approx([ev["ts"] for ev in want["chrome"]["traceEvents"]])
    assert got["writer"] == want["writer"] and got["flushed"] == 1
    assert got["events"] == want["events"]
    assert got["payloads"] == want["payloads"]
    assert got["log"] == want["log"]
    assert got["spans_on"] is want["spans_on"] is False
    # hooks after the sinks on reported steps; alone, with the in-step
    # payload, on the others
    ev = got["events"]
    assert ev[:3] == [("sink", 0), ("a", 0, sorted(got["payloads"][0])),
                      ("b", 0, 2.0)]
    assert ev[3] == ("a", 1, ["amp/overflow_count", "loss"])


def test_reporter_without_hooks_reads_nothing_off_interval():
    class Tensorless:
        def as_floats(self):
            raise AssertionError("read on an off-interval step")

    rep = tobs.StepReporter([], registry=tobs.MetricsRegistry(),
                            interval=3)
    assert rep.report(1, metrics=tobs.Metrics({})) is None
    assert rep.report(2, metrics=Tensorless()) is None
    with pytest.raises(ValueError):
        tobs.StepReporter([], interval=0)
    with pytest.raises(ValueError):
        rep.attach_flops_budget(0.0, 1.0)


def test_null_reporter_and_attach():
    null = tobs.get_reporter()
    assert isinstance(null, tobs.NullReporter) and not null
    assert null.report(0, metrics=None) is None
    with null:
        pass
    rep = tobs.StepReporter([], registry=tobs.MetricsRegistry())
    tobs.attach_reporter(rep)
    assert tobs.get_reporter() is rep
    tobs.detach_reporter()
    assert tobs.get_reporter() is null


def test_timers_log_write_and_elapsed(clock):
    logs, writes = [], []
    for mod in (jtimers, ttimers):
        clock.t = 50.0
        timers = mod.Timers()
        for name in ("a", "b"):
            timers(name).start()
            timers(name).stop()
        timers("a").start()
        running = timers("a").elapsed(reset=False)
        assert timers("a").started_
        timers("a").stop()
        w = Writer()
        timers.write(["a", "b"], w, iteration=7, normalizer=2.0)
        writes.append(w.calls)
        logs.append((running, timers.log(["b", "a"], normalizer=4.0)))
    assert logs[1] == logs[0] and writes[1] == writes[0]


def test_span_recording_and_trace_events():
    assert not tobs.spans_enabled()
    with tobs.span_recording():
        timers = ttimers.Timers()
        with timers("x")():
            pass
        spans = tobs.drain_spans()
    assert not tobs.spans_enabled() and ttimers._SPAN_HOOK is None
    assert [s.name for s in spans] == ["x"] and spans[0].end >= spans[0].start
    spans = [tobs.Span("s", 1.0, 1.5), tobs.Span("t", 2.0, 2.25)]
    jspans = [jobs.Span(*s) for s in spans]
    assert tobs.chrome_trace_events(spans, pid=2, tid=1, step=4) == \
        jobs.chrome_trace_events(jspans, pid=2, tid=1, step=4)


def _docs(offsets, pids):
    return [{"traceEvents": [{"name": f"e{i}{j}", "ph": "X", "ts": 10.0 * j,
                              "dur": 1.0, "pid": p}
                             for j, p in enumerate(ps)],
             "metadata": {"clock": "perf_counter", "epoch_offset_s": off}}
            for i, (off, ps) in enumerate(zip(offsets, pids))]


@pytest.mark.parametrize("pids", [([0, 0], [0, 1]), ([0], [5])],
                         ids=["colliding", "apart"])
def test_merge_chrome_traces_matches_jax(pids):
    docs = _docs([1.5, -2.0], pids)
    assert tobs.merge_chrome_traces(docs) == jobs.merge_chrome_traces(docs)
    bad = docs + [{"traceEvents": [], "metadata": {}}]
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match="epoch_offset_s"):
            mod.merge_chrome_traces(bad)


def test_sinks_spell_non_finite_values_as_strict_json(tmp_path):
    buf = io.StringIO()
    sink = tobs.JSONLSink(buf)
    sink.emit(3, {"a": float("nan"), "b": float("inf"), "c": 1.0})
    line = json.loads(buf.getvalue())
    assert line["metrics"] == {"a": "NaN", "b": "Infinity", "c": 1.0}
    path = tmp_path / "log.jsonl"
    with tobs.JSONLSink(path) as s:
        s.emit(0, {"x": 2.0})
    assert json.loads(path.read_text())["step"] == 0
    with pytest.raises(TypeError):
        tobs.TensorBoardSink(object())
    chrome = tobs.ChromeTraceSink(tmp_path / "c.json", counters=["b"])
    chrome.emit(1, {"a": 1.0, "b": float("-inf")}, [tobs.Span("s", 0, 1)])
    chrome.close()
    doc = json.loads((tmp_path / "c.json").read_text())
    assert [e["ph"] for e in doc["traceEvents"]] == ["X", "C"]
    assert doc["traceEvents"][1]["args"] == {"b": "-Infinity"}
    assert tobs.ChromeTraceSink(tmp_path / "d.json").pid == 0


def test_device_fence_and_profile_trace_on_the_cpu(tmp_path):
    ttimers.device_fence({"a": torch.ones(3), "b": [torch.zeros(0)]})
    ttimers.device_fence({})
    with ttimers.profile_trace(str(tmp_path / "prof")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert prof is not None
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert "aten::mm" in names
    # one read of the step's metrics on a reported step
    values = np.arange(3, dtype=np.float32)
    m = tobs.Metrics({f"m{i}": torch.tensor(v) for i, v in
                      enumerate(values)})
    assert tobs.StepReporter([], registry=tobs.MetricsRegistry()).report(
        0, metrics=m) == {f"m{i}": float(v) for i, v in enumerate(values)}
