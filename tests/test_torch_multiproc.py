"""The port's multi-process bootstrap and auto-resume against the JAX
package's: ``parallel/multiproc.py``'s env protocol (``process_env``,
``initialize_from_env``, ``process_id``, ``process_count`` on the same
env dicts, the validation), ``any_process`` at world 1 and on two gloo
ranks, the torch bootstrap in a child process and in a two-worker gang
under the port's launcher; ``utils/autoresume.py``'s cases
(``tests/test_autoresume.py``) on both classes."""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

import _torch_elastic_ranks as R
from apex_tpu.parallel import multiproc as J
from apex_tpu.utils.autoresume import AutoResume as JAutoResume
from apex_tpu_torch.parallel import multiproc as T
from apex_tpu_torch.utils import AutoResume as TAutoResume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_names_are_the_references():
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_LOCAL_DEVICES", "ENV_RUN_DIR"):
        assert getattr(T, name) == getattr(J, name)
    assert set(T.__all__) == set(J.__all__)
    assert [f.name for f in T.ProcessInfo.__dataclass_fields__.values()][
        :5] == list(J.ProcessInfo.__dataclass_fields__)


@pytest.mark.parametrize("args,kw", [
    ((0, 1, "127.0.0.1:5555"), {}),
    ((1, 2, "127.0.0.1:5555"), dict(local_devices=4, run_dir="/r")),
    ((3, 4, "h:1"), dict(local_devices=0, run_dir="")),
    ((2, 3, "h:2"), dict(run_dir="/x/y")),
])
def test_process_env_and_the_readers(monkeypatch, args, kw):
    """The same env block, and the same rank and world read back."""
    env = T.process_env(*args, **kw)
    assert env == J.process_env(*args, **kw)
    for name in (T.ENV_COORDINATOR, T.ENV_NUM_PROCESSES, T.ENV_PROCESS_ID,
                 T.ENV_LOCAL_DEVICES, T.ENV_RUN_DIR):
        monkeypatch.delenv(name, raising=False)
    assert (T.process_id(), T.process_count()) == (0, 1)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert T.process_id() == J.process_id() == args[0]
    assert T.process_count() == J.process_count() == args[1]


def test_initialize_from_env_is_a_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv(T.ENV_COORDINATOR, raising=False)
    assert T.initialize_from_env() is None
    assert J.initialize_from_env() is None


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("fn", [
    lambda m: m.process_env(2, 2, "x:1"),
    lambda m: m.initialize(None, 2, 0),
    lambda m: m.initialize("x:1", 2, 5),
    lambda m: m.initialize("x:1", 2, -1),
])
def test_validation_matches(fn):
    ref = _message(lambda: fn(J))
    assert ref is not None and _message(lambda: fn(T)) == ref


def test_any_process_single_world():
    assert T.any_process(True) is True
    assert T.any_process(False) is False
    assert J.any_process(1) is True


def test_any_process_over_two_gloo_ranks():
    from apex_tpu_torch.parallel._spawn import RankPool
    with RankPool(2, device="cpu") as pool:
        for flags in ([0, 0], [0, 1], [1, 0], [1, 1]):
            assert pool.run(R.any_process, flags, timeout=60) == \
                [any(flags)] * 2


CHILD = textwrap.dedent("""\
    import json, sys
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.parallel import multiproc
    out = {}
    try:
        multiproc.initialize(None, 1, 0)
    except RuntimeError as e:
        out["cuda"] = str(e)
    info = multiproc.initialize(sys.argv[1], 1, 0, run_dir="/r",
                                device="cpu")
    out.update(backend=info.backend, device=info.device,
               pg=dist.get_backend(), world=dist.get_world_size(),
               id=multiproc.process_id(), count=multiproc.process_count(),
               any=multiproc.any_process(True))
    dist.destroy_process_group()
    print(json.dumps(out))
    """)


def test_initialize_brings_up_torch_distributed():
    """In a child: ``"cuda"`` without a card raises (no CPU carry-on);
    with a coordinator at world 1 on the CPU, a gloo group over tcp."""
    import socket
    if __import__("torch").cuda.is_available():
        pytest.skip("the no-card case needs a machine without a card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run = subprocess.run(
        [sys.executable, "-c", CHILD, f"127.0.0.1:{port}"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert "no CUDA card" in out["cuda"]
    assert out == dict(out, backend="gloo", device="cpu", pg="gloo",
                       world=1, id=0, count=1, any=True)


WORKER = textwrap.dedent("""\
    import json, os, sys
    import torch.distributed as dist
    from apex_tpu_torch.parallel import multiproc
    info = multiproc.initialize_from_env(device="cpu")
    flag = multiproc.any_process(info.process_id == 1)
    none = multiproc.any_process(False)
    out = dict(rank=info.process_id, world=info.num_processes,
               backend=info.backend, run_dir=info.run_dir,
               dist=(dist.get_rank(), dist.get_world_size()),
               flag=flag, none=none)
    path = os.path.join(info.run_dir, f"out_{info.process_id}.json")
    with open(path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    """)


def test_a_gang_of_two_torch_workers(tmp_path):
    """The port's launcher hands two torch workers the env block; each
    joins the gloo world over the coordinator and ORs a flag only rank 1
    raised."""
    from apex_tpu_torch.elastic import LocalLauncher
    from apex_tpu_torch.observability.registry import MetricsRegistry
    run_dir = str(tmp_path / "run")
    report = LocalLauncher(
        [sys.executable, "-c", WORKER], num_processes=2, run_dir=run_dir,
        max_restarts=0, grace_s=1.0, heartbeat_timeout_s=120.0,
        round_timeout_s=120.0, env={"PYTHONPATH": REPO},
        registry=MetricsRegistry()).run()
    assert report.succeeded, open(os.path.join(
        run_dir, "logs", "round0_rank0.log")).read()[-2000:]
    for rank in range(2):
        with open(os.path.join(run_dir, f"out_{rank}.json")) as f:
            out = json.load(f)
        assert out == {"rank": rank, "world": 2, "backend": "gloo",
                       "run_dir": run_dir, "dist": [rank, 2],
                       "flag": True, "none": False}


def test_main_delegates_to_the_launcher(tmp_path):
    assert T.main(["-n", "1", "--run-dir", str(tmp_path), "--",
                   sys.executable, "-c", "import sys; sys.exit(0)"]) == 0


# ---------------------------------------------------------------------------
# AutoResume: tests/test_autoresume.py's cases, on both classes
# ---------------------------------------------------------------------------

CLASSES = pytest.mark.parametrize("AR", [JAutoResume, TAutoResume],
                                  ids=["jax", "torch"])


@pytest.fixture
def clean_env(monkeypatch):
    monkeypatch.delenv("APEX_TPU_TERMINATE", raising=False)


@CLASSES
def test_sigterm_latches(clean_env, AR):
    with AR(interval=1) as ar:
        assert not ar.termination_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert ar.termination_requested()
        assert ar.termination_requested(step=3)


@CLASSES
def test_env_var_any_nonempty_and_latch(clean_env, monkeypatch, AR):
    with AR(interval=1, install_sigterm_handler=False) as ar:
        monkeypatch.setenv("APEX_TPU_TERMINATE", "")
        assert not ar.termination_requested()
        monkeypatch.setenv("APEX_TPU_TERMINATE", " ")
        assert ar.termination_requested()
        monkeypatch.delenv("APEX_TPU_TERMINATE")
        assert ar.termination_requested()


@CLASSES
def test_hook_polled_on_interval_only(clean_env, AR):
    calls = []

    def hook():
        calls.append(1)
        return False

    with AR(interval=5, hook=hook, install_sigterm_handler=False) as ar:
        for step in range(1, 10):
            ar.termination_requested(step)
        assert len(calls) == 1
        ar.termination_requested()
        assert len(calls) == 2


@CLASSES
def test_hook_firing_once_is_latched(clean_env, AR):
    fired = iter([True])
    with AR(interval=1, hook=lambda: next(fired, False),
            install_sigterm_handler=False) as ar:
        assert ar.termination_requested(step=4)
        assert ar.termination_requested(step=5)
        assert ar.termination_requested()


@CLASSES
def test_handler_chaining_and_close_restores(clean_env, AR):
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        ar = AR(interval=1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert ar.termination_requested()
        assert seen == [signal.SIGTERM]
        ar.close()
        assert signal.getsignal(signal.SIGTERM) is not ar._on_sigterm
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM, signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


@CLASSES
def test_context_manager_restores_handler(clean_env, AR):
    before = signal.getsignal(signal.SIGTERM)
    with AR(interval=1) as ar:
        assert signal.getsignal(signal.SIGTERM) == ar._on_sigterm
    assert signal.getsignal(signal.SIGTERM) == before


@CLASSES
def test_interval_validation_and_request_resume(clean_env, AR):
    with pytest.raises(ValueError):
        AR(interval=0)
    with AR(interval=1, install_sigterm_handler=False) as ar:
        with pytest.raises(SystemExit) as e:
            ar.request_resume(3)
    assert e.value.code == 3
