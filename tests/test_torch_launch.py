"""The port's launcher and supervisor against the JAX package's
``apex_tpu/elastic/launch.py``: the reference's ``TestLocalLauncher``,
``TestProgressStall``, ``TestLauncherPostmortem``, ``TestHeartbeat`` and
``TestCli`` scenarios on the same stub workers (plain Python, no torch),
each run under both launchers and their ``LaunchReport``\\ s compared
field by field (timings aside), with the postmortems and ``elastic/*``
metrics; the live ``/metrics`` scrape over workers publishing through the
port's ``FleetPublisher``; and the exit discipline: no process exit in
``apex_tpu_torch/elastic/`` outside its two chokepoints.

Every wait is bounded: a round by ``round_timeout_s``, the teardown by
``grace_s``, backoffs at 0.05 s and heartbeat budgets at most 1 s."""

import ast
import json
import os
import pathlib
import signal
import sys
import textwrap
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest

from apex_tpu.elastic import launch as JL
from apex_tpu.observability.registry import MetricsRegistry as JRegistry
from apex_tpu_torch.elastic import launch as TL
from apex_tpu_torch.observability.registry import MetricsRegistry as TRegistry
from apex_tpu_torch.parallel import multiproc

REPO = pathlib.Path(__file__).resolve().parent.parent
SIDES = {"jax": (JL, JRegistry), "torch": (TL, TRegistry)}


def _stub_worker(body) -> list:
    """argv of a tiny worker whose body sees RANK/WORLD/RUN (the
    reference test's stub)."""
    src = textwrap.dedent("""\
        import os, sys, time
        RANK = int(os.environ["APEX_TPU_PROCESS_ID"])
        WORLD = int(os.environ["APEX_TPU_NUM_PROCESSES"])
        RUN = os.environ["APEX_TPU_RUN_DIR"]
        """) + textwrap.dedent(body)
    return [sys.executable, "-c", src]


def _both(tmp_path, argv, **kw):
    """The scenario under each launcher: ``{side: (report, registry,
    run_dir)}``."""
    out = {}
    for side, (mod, reg_cls) in SIDES.items():
        reg = reg_cls()
        kw2 = dict(kw)
        kw2.setdefault("num_processes", 2)
        kw2.setdefault("grace_s", 0.3)
        kw2.setdefault("restart_backoff_s", 0.05)
        kw2.setdefault("round_timeout_s", 60.0)
        run_dir = str(tmp_path / side / "run")
        report = mod.LocalLauncher(argv, run_dir=run_dir, registry=reg,
                                   **kw2).run()
        out[side] = (report, reg, run_dir)
    return out


def _report(report, codes=True):
    return (report.succeeded, report.world_size, report.restarts,
            report.shrinks,
            [(r.world_size, r.returncodes if codes else sorted(
                r.returncodes), r.cause, r.postmortem is None)
             for r in report.rounds])


def _postmortem(path):
    with open(path) as f:
        doc = json.load(f)
    doc.pop("wall_time")
    for r in doc["ranks"]:
        r.pop("heartbeat_age_s")
    return doc


def _same(out, keys=("elastic/world_size", "elastic/restarts",
                     "elastic/shrinks"), codes=True):
    """Both launchers' reports equal field by field (the exit codes only
    where ``codes``: a rank the teardown reaches first exits by its
    signal), their postmortems (heartbeat ages aside) and metrics."""
    (jr, jreg, jdir), (tr, treg, tdir) = out["jax"], out["torch"]
    assert _report(tr, codes) == _report(jr, codes)
    for a, b in zip(jr.rounds, tr.rounds):
        if a.postmortem is not None and codes:
            assert _postmortem(b.postmortem) == _postmortem(a.postmortem)
            assert os.path.relpath(b.postmortem, tdir) == \
                os.path.relpath(a.postmortem, jdir)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert {k: ts.get(k) for k in keys} == {k: js.get(k) for k in keys}
    assert sorted(os.listdir(os.path.join(tdir, "logs"))) == \
        sorted(os.listdir(os.path.join(jdir, "logs")))
    return tr, ts


def test_clean_gang_succeeds(tmp_path):
    report, snap = _same(_both(tmp_path, _stub_worker("sys.exit(0)\n")))
    assert report.succeeded and report.world_size == 2
    assert [r.cause for r in report.rounds] == ["ok"]
    assert snap["elastic/world_size"] == 2


def test_transient_failure_restarts_with_backoff(tmp_path):
    """Both ranks fail the first round (each waits, at most 10 s, for the
    other's marker before it exits 3) and succeed the next: one
    same-world restart, no shrink."""
    body = """\
        flag = os.path.join(RUN, f"tried_{RANK}")
        if not os.path.exists(flag):
            open(flag, "w").close()
            other = os.path.join(RUN, f"tried_{1 - RANK}")
            deadline = time.monotonic() + 10.0
            while not os.path.exists(other) and time.monotonic() < deadline:
                time.sleep(0.01)
            sys.exit(3)
        sys.exit(0)
    """
    report, snap = _same(_both(tmp_path, _stub_worker(body),
                               max_restarts=2), codes=False)
    assert report.restarts == 1 and report.shrinks == 0
    assert [r.cause for r in report.rounds] == ["exit", "ok"]
    assert snap["elastic/restarts"] == 1


# the reference's stuck-peer stub, with rank 1 waiting (at most 10 s)
# until rank 0 ignores SIGTERM, so the teardown always needs the SIGKILL
STUCK_PEER = """\
    ready = os.path.join(RUN, "ignoring")
    if WORLD == 2 and RANK == 1:
        deadline = time.monotonic() + 10.0
        while not os.path.exists(ready) and time.monotonic() < deadline:
            time.sleep(0.01)
        sys.exit(9)
    if WORLD == 2:
        import signal
        signal.signal(signal.SIGTERM, signal.SIG_IGN)  # stuck peer
        open(ready, "w").close()
        time.sleep(600)
    sys.exit(0)
"""


def test_permanent_failure_shrinks_and_postmortem_names_the_dead_rank(
        tmp_path):
    """Rank 1 dies at world 2, rank 0 hangs ignoring SIGTERM: teardown
    escalates to SIGKILL, the gang shrinks to world 1 and completes; the
    first round's postmortem blames rank 1 (its pre-teardown exit code),
    not the survivor the supervisor killed."""
    report, snap = _same(_both(tmp_path, _stub_worker(STUCK_PEER),
                               max_restarts=0, min_processes=1))
    assert report.succeeded and report.world_size == 1
    assert report.shrinks == 1
    first = report.rounds[0]
    assert first.cause == "exit" and first.returncodes == {
        0: -signal.SIGKILL, 1: 9}
    pm = json.load(open(first.postmortem))
    assert (pm["culprit_rank"], pm["culprit_reason"]) == (1,
                                                          "heartbeat_dead")
    assert {r["rank"]: r["returncode"] for r in pm["ranks"]} == {0: None,
                                                                 1: 9}
    assert os.path.exists(first.postmortem[:-5] + ".md")
    assert report.rounds[1].postmortem is None
    assert snap["elastic/shrinks"] == 1


def test_heartbeat_timeout_declares_a_hung_rank(tmp_path):
    out = _both(tmp_path, _stub_worker("time.sleep(600)\n"),
                num_processes=1, max_restarts=0, heartbeat_timeout_s=0.6)
    report, snap = _same(out, keys=("elastic/world_size",))
    assert not report.succeeded and report.rounds[0].cause == "heartbeat"
    assert snap["elastic/heartbeat_age_s"] > 0.6
    pm = json.load(open(report.rounds[0].postmortem))
    assert (pm["culprit_rank"], pm["culprit_reason"]) == (0,
                                                          "heartbeat_dead")


def test_worker_heartbeats_keep_the_round_alive(tmp_path):
    """A worker alive past the heartbeat budget lives while it beats and
    its step moves (the stub speaks the on-disk text protocol)."""
    body = """\
        hb = os.path.join(RUN, "hb", f"rank_{RANK}")
        os.makedirs(os.path.dirname(hb), exist_ok=True)
        for k in range(10):
            with open(hb + ".tmp", "w") as f:
                f.write(f"{k} {time.time()}\\n")
            os.replace(hb + ".tmp", hb)
            time.sleep(0.15)
        sys.exit(0)
    """
    out = _both(tmp_path, _stub_worker(body), num_processes=1,
                max_restarts=0, heartbeat_timeout_s=1.0)
    report, _ = _same(out)
    assert report.succeeded
    for side in SIDES:
        assert TL.Heartbeat.last_step(out[side][2], 0) == 9


def test_exhausted_policy_reports_failure_with_forensics(tmp_path):
    """Policy exhaustion is an outcome (a failed report), not a raise, and
    exhausting it at ``min_processes`` counts no shrink. Which of the two
    ranks the teardown reaches before it exits 5 is timing."""
    out = _both(tmp_path, _stub_worker("sys.exit(5)\n"), max_restarts=0,
                min_processes=2)
    report, _ = _same(out, codes=False)
    assert not report.succeeded and report.world_size == 2
    assert report.shrinks == 0
    for side in SIDES:
        codes = out[side][0].rounds[0].returncodes
        assert 5 in codes.values() and set(codes.values()) <= {
            5, -signal.SIGTERM}


def test_beating_but_stuck_rank_is_declared_stalled(tmp_path):
    body = """\
        hb = os.path.join(RUN, "hb", f"rank_{RANK}")
        os.makedirs(os.path.dirname(hb), exist_ok=True)
        for _ in range(200):
            with open(hb + ".tmp", "w") as f:
                f.write(f"7 {time.time()}\\n")  # step NEVER moves
            os.replace(hb + ".tmp", hb)
            time.sleep(0.1)
    """
    out = _both(tmp_path, _stub_worker(body), num_processes=1,
                max_restarts=0, heartbeat_timeout_s=1.0)
    report, _ = _same(out)
    assert report.rounds[0].cause == "stall"
    pm = json.load(open(report.rounds[0].postmortem))
    assert (pm["culprit_rank"], pm["culprit_reason"]) == (0,
                                                          "stalled_step")
    assert pm["ranks"][0]["stalled"] is True


def test_step_free_heartbeats_are_exempt(tmp_path):
    body = """\
        hb = os.path.join(RUN, "hb", f"rank_{RANK}")
        os.makedirs(os.path.dirname(hb), exist_ok=True)
        for _ in range(10):
            with open(hb + ".tmp", "w") as f:
                f.write("alive\\n")  # no step field
            os.replace(hb + ".tmp", hb)
            time.sleep(0.15)
        sys.exit(0)
    """
    report, _ = _same(_both(tmp_path, _stub_worker(body), num_processes=1,
                            max_restarts=0, heartbeat_timeout_s=1.0))
    assert report.succeeded


@pytest.mark.parametrize("kw", [dict(num_processes=0),
                                dict(num_processes=2, min_processes=3),
                                dict(num_processes=2, max_restarts=-1)])
def test_validation(tmp_path, kw):
    msgs = []
    for mod, reg in SIDES.values():
        with pytest.raises(ValueError) as e:
            mod.LocalLauncher(["x"], run_dir=str(tmp_path), registry=reg(),
                              **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_env_block_is_multiprocs(tmp_path):
    """Each rank's env: the multiproc block (coordinator, world, rank,
    devices a rank, run dir) over the supervisor's, with ``env`` on
    top."""
    body = """\
        import json
        keys = [k for k in os.environ if k.startswith("APEX_TPU_")]
        with open(os.path.join(RUN, f"env_{RANK}.json"), "w") as f:
            json.dump({k: os.environ[k] for k in keys + ["EXTRA"]}, f)
    """
    out = _both(tmp_path, _stub_worker(body), devices_per_process=2,
                env={"EXTRA": "x"})
    _same(out)
    for side in SIDES:
        for rank in range(2):
            with open(os.path.join(out[side][2], f"env_{rank}.json")) as f:
                env = json.load(f)
            coord = env.pop(multiproc.ENV_COORDINATOR)
            assert coord.startswith("127.0.0.1:")
            assert env == {multiproc.ENV_NUM_PROCESSES: "2",
                           multiproc.ENV_PROCESS_ID: str(rank),
                           multiproc.ENV_LOCAL_DEVICES: "2",
                           multiproc.ENV_RUN_DIR: out[side][2],
                           "EXTRA": "x"}


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def test_supervisor_age_is_monotonic_not_wallclock(tmp_path):
    launcher = TL.LocalLauncher(["x"], num_processes=1,
                                run_dir=str(tmp_path / "run"),
                                registry=TRegistry())
    hb = TL.Heartbeat(str(tmp_path / "run"), 0)
    hb.beat(1)
    past = time.time() - 9999.0
    os.utime(hb.path, (past, past))
    fake = [SimpleNamespace(poll=lambda: None)]
    seen = {}
    started = time.monotonic()
    assert launcher._heartbeat_age(fake, started, seen) == 0.0
    assert launcher._heartbeat_age(fake, started, seen) < 5.0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heartbeat_files_read_alike(tmp_path, writer, monkeypatch):
    """A beat by either package reads the same in both: age, last step
    (JSON first, the text protocol as the fallback), the env's rank,
    ``clear``."""
    hb_cls = SIDES[writer][0].Heartbeat
    hb = hb_cls(str(tmp_path), rank=1)
    for mod, _ in SIDES.values():
        assert mod.Heartbeat.age_s(str(tmp_path), 1) is None
        assert mod.Heartbeat.age_s(str(tmp_path), 1, default=7.0) == 7.0
    hb.beat(12)
    doc = json.load(open(hb.path + ".json"))
    assert doc["schema"] == TL.Heartbeat.SCHEMA == JL.Heartbeat.SCHEMA
    assert doc["step"] == 12 and not os.path.exists(hb.path + ".json.tmp")
    with open(hb.path) as f:
        assert f.read().split()[0] == "12"
    for mod, _ in SIDES.values():
        assert mod.Heartbeat.last_step(str(tmp_path), 1) == 12
        assert 0.0 <= mod.Heartbeat.age_s(str(tmp_path), 1) < 5.0
    os.remove(hb.path + ".json")
    with open(hb.path, "w") as f:
        f.write("9 1690000000.0\n")
    for mod, _ in SIDES.values():
        assert mod.Heartbeat.last_step(str(tmp_path), 1) == 9
    hb_cls.clear(str(tmp_path))
    for mod, _ in SIDES.values():
        assert mod.Heartbeat.last_step(str(tmp_path), 1) is None
    monkeypatch.setenv(multiproc.ENV_PROCESS_ID, "3")
    hb_cls(str(tmp_path)).beat(1)
    assert TL.Heartbeat.last_step(str(tmp_path), 3) == 1


# ---------------------------------------------------------------------------
# the CLI surfaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,code", [
    (["-n", "2", "--max-restarts", "0", "--", sys.executable, "-c",
      "pass"], 0),
    (["-n", "1", "--max-restarts", "0", "--", sys.executable, "-c",
      "import sys; sys.exit(7)"], 1),
    (["-n", "1", "--", sys.executable, "-c", "import sys; sys.exit(0)",
      "--", "kept"], 0),
])
def test_launch_cli(tmp_path, argv, code):
    for name, main in (("jax", JL.main), ("torch", TL.main),
                       ("multiproc", multiproc.main)):
        run = str(tmp_path / name)
        assert main(argv[:2] + ["--run-dir", run] + argv[2:]) == code


def test_launch_cli_as_a_module(tmp_path):
    """``python -m apex_tpu_torch.elastic.launch`` exits with the gang's
    code through ``_supervisor_exit``."""
    import subprocess
    for code, want in (("0", 0), ("4", 1)):
        run = subprocess.run(
            [sys.executable, "-m", "apex_tpu_torch.elastic.launch", "-n",
             "1", "--max-restarts", "0", "--run-dir", str(tmp_path / code),
             "--", sys.executable, "-c", f"import sys; sys.exit({code})"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
            capture_output=True, text=True, timeout=120)
        assert run.returncode == want, run.stderr
    with pytest.raises(SystemExit):
        TL.main(["-n", "1"])  # no worker command


def test_live_scrape_serves_merged_registry(tmp_path):
    """``metrics_port=0``: while the gang runs, ``/metrics`` serves the
    supervisor's ``elastic/*`` merged with each rank's snapshot published
    through the port's ``FleetPublisher`` (counters summed), ``/fleet``
    the merged JSON; nothing listens once ``run`` returns."""
    body = f"""\
        sys.path.insert(0, {str(REPO)!r})
        from apex_tpu_torch.observability.fleet import FleetPublisher
        from apex_tpu_torch.observability.registry import MetricsRegistry
        reg = MetricsRegistry()
        reg.counter("train/steps").inc(1)
        hb = os.path.join(RUN, "hb", f"rank_{{RANK}}")
        os.makedirs(os.path.dirname(hb), exist_ok=True)
        with open(hb + ".tmp", "w") as f:
            f.write(f"1 {{time.time()}}\\n")
        os.replace(hb + ".tmp", hb)
        FleetPublisher(RUN, rank=RANK, registry=reg).publish(1, force=True)
        time.sleep(1.5)
        sys.exit(0)
    """
    launcher = TL.LocalLauncher(
        _stub_worker(body), num_processes=2, min_processes=2,
        max_restarts=0, grace_s=1.0, heartbeat_timeout_s=60.0,
        round_timeout_s=60.0, run_dir=str(tmp_path / "run"),
        registry=TRegistry(), metrics_port=0, fleet_refresh_s=0.1)
    box = {}
    th = threading.Thread(target=lambda: box.update(report=launcher.run()))
    th.start()
    scrape = fleet_doc = None
    try:
        deadline = time.monotonic() + 60.0
        while th.is_alive() and time.monotonic() < deadline:
            port = launcher.bound_metrics_port
            if port is not None:
                try:
                    text = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=2).read().decode()
                    if ("train_steps 2" in text
                            and "elastic_world_size 2" in text):
                        scrape = text
                        fleet_doc = json.loads(urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/fleet",
                            timeout=2).read())
                        break
                except OSError:
                    pass
            time.sleep(0.05)
    finally:
        th.join(timeout=90)
    assert not th.is_alive() and box["report"].succeeded
    assert scrape is not None, "the merged families never appeared"
    assert "fleet_ranks 2" in scrape
    assert fleet_doc["counters"]["train/steps"]["total"] == 2.0
    assert fleet_doc["step_skew"] == 0
    with pytest.raises(OSError):
        urllib.request.urlopen(
            f"http://127.0.0.1:{launcher.bound_metrics_port}/metrics",
            timeout=0.5)


# ---------------------------------------------------------------------------
# the exit discipline
# ---------------------------------------------------------------------------

EXITS = {("sys", "exit"), ("os", "_exit")}
# (file, the function a process exit may sit in)
CHOKEPOINTS = {("elastic/launch.py", "_supervisor_exit"),
               ("utils/autoresume.py", "request_resume")}


def _exits(source: str):
    """``(function, line)`` of every ``sys.exit``/``os._exit``/bare
    ``exit``/``quit`` call in a module's source."""
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Call):
                f = child.func
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and (f.value.id, f.attr) in EXITS) or (
                        isinstance(f, ast.Name)
                        and f.id in ("exit", "quit", "_exit")):
                    out.append((name, child.lineno))
            visit(child, name)

    visit(ast.parse(source), None)
    return out


def test_process_exits_only_at_the_two_chokepoints():
    port = REPO / "apex_tpu_torch"
    files = sorted((port / "elastic").glob("*.py")) + [
        port / "utils" / "autoresume.py"]
    found = {}
    for path in files:
        rel = path.relative_to(port).as_posix()
        for fn, line in _exits(path.read_text()):
            found.setdefault((rel, fn), []).append(line)
    assert set(found) == CHOKEPOINTS, found
    # the scan finds a planted exit, in a function and at module level
    planted = "import sys\ndef f():\n    sys.exit(1)\nos._exit(2)\n"
    assert _exits(planted) == [("f", 3), (None, 4)]
