"""The port's elastic run loop against the JAX package's.

- a toy trainer of the reference's shape (``tests/test_elastic.py``'s
  ``ToyTrainer`` without its RNG noise: bf16 weights and an fp32
  counter) driven by both packages' ``ElasticRunner`` over both packages'
  data iterators: the same losses (1e-6), ``FitResult`` fields, data
  cursor, checkpoint steps and ``host.json`` sidecar, keys and values;
  preemption, the torn final checkpoint, the in-flight drain, the env
  var, the restart after completion and the metrics;
- the two-signal drain on both;
- ``FaultPlan.before_step``'s signals against the reference's;
- the port's ``GPTHybridTrainer`` (2 layers, hidden 32) preempted and
  resumed bit for bit against a straight run, the ZeRO bucket-bytes
  restore guard, the model-axis refusal, and a dp 2 -> dp 1 ZeRO shrink
  on gloo ranks (the reference's ``TestSimulatedShrink``): the flat
  content element-identical, the post-shrink losses within the
  reference's 2e-3 of an uninterrupted dp 1 run, and the sidecar's
  world the one the reference's runner records for that trainer.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_elastic_ranks as R
from apex_tpu import elastic as J
from apex_tpu.checkpoint import all_steps as j_all_steps
from apex_tpu.observability.registry import MetricsRegistry as JRegistry
from apex_tpu_torch import elastic as T
from apex_tpu_torch.checkpoint import all_steps, torn_steps
from apex_tpu_torch.observability.registry import MetricsRegistry

W0 = np.random.RandomState(0).randn(8).astype(np.float32)
DATA = np.random.RandomState(3).randn(64, 8).astype(np.float32)
TOL_LOSS = 1e-6


class JaxToy:
    """The reference's ToyTrainer without the noise: bf16 weights pulled
    toward each batch, an fp32 step counter."""

    def init_state(self, key):
        return (jnp.asarray(W0).astype(jnp.bfloat16),
                jnp.zeros((), jnp.float32))

    def jit_train_step(self):
        @jax.jit
        def step(w, opt, x):
            w32 = w.astype(jnp.float32)
            loss = jnp.mean((w32 - x) ** 2)
            return loss, (w32 - 0.1 * (w32 - x)).astype(jnp.bfloat16), \
                opt + 1.0

        return step


class TorchToy:
    def init_state(self, generator):
        return (torch.from_numpy(W0).to(torch.bfloat16),
                torch.zeros((), dtype=torch.float32))

    def jit_train_step(self):
        def step(w, opt, x):
            w32 = w.float()
            loss = ((w32 - x) ** 2).mean()
            return loss, (w32 - 0.1 * (w32 - x)).to(torch.bfloat16), \
                opt + 1.0

        return step


def _fetch(idx):
    return (np.take(DATA, idx, axis=0).mean(0),)


SIDES = {
    "jax": dict(mod=J, toy=JaxToy, registry=JRegistry,
                data=lambda: J.PrefetchingIterator(
                    J.ShardedIndexIterator(64, 4, seed=11), _fetch,
                    depth=2),
                fit=lambda r, n: r.fit(n, key=jax.random.PRNGKey(0))),
    "torch": dict(mod=T, toy=TorchToy, registry=MetricsRegistry,
                  data=lambda: T.PrefetchingIterator(
                      T.ShardedIndexIterator(64, 4, seed=11), _fetch,
                      depth=2, device="cpu"),
                  fit=lambda r, n: r.fit(n)),
}


def _run(side, directory, total, *, plan=None, save_interval=1,
         keep_last=4, registry=None, **kw):
    s = SIDES[side]
    it = s["data"]()
    reg = registry if registry is not None else s["registry"]()
    losses = {}
    on_step = kw.pop("on_step", None)

    def record(k, loss):
        losses[k] = float(loss)
        if on_step is not None:
            on_step(k, loss)

    plan = s["mod"].FaultPlan.from_json(plan.to_json()) if plan else None
    runner = s["mod"].ElasticRunner(
        s["toy"](), it, str(directory), save_interval=save_interval,
        keep_last=keep_last, fault_plan=plan, exit_on_preempt=False,
        registry=reg, on_step=record, **kw)
    res = s["fit"](runner, total)
    return res, it, losses, reg


def _fields(res):
    return (res.step, res.preempted, res.restored_from, res.resharded)


def _weights(state):
    w = state[0]
    if isinstance(w, torch.Tensor):
        return w.float().numpy(), float(state[1])
    return np.asarray(w.astype(jnp.float32)), float(state[1])


def _bits(state):
    return [x.detach().reshape(-1).view(torch.uint8).numpy().tobytes()
            for x in state]


def _sidecars(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name, "host.json")
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)
    return out


def _same_run(a, b):
    """Two sides' ``_run`` outputs agree: fields, losses, weights,
    counter, cursor."""
    (ra, ita, la, _), (rb, itb, lb, _) = a, b
    assert _fields(ra) == _fields(rb)
    assert la.keys() == lb.keys()
    for k in la:
        assert abs(la[k] - lb[k]) <= TOL_LOSS, (k, la[k], lb[k])
    assert (ra.loss is None) == (rb.loss is None)
    if ra.loss is not None:
        assert abs(ra.loss - rb.loss) <= TOL_LOSS
    wa, ca = _weights(ra.state)
    wb, cb = _weights(rb.state)
    np.testing.assert_allclose(wa, wb, rtol=2 ** -7)
    assert ca == cb
    assert ita.state_dict() == itb.state_dict()


@pytest.mark.parametrize("fp32_on_disk", [True, False])
def test_preempt_resume_against_the_reference(tmp_path, fp32_on_disk):
    """3 steps + a SIGTERM + restore + 3 == 6 straight, on both packages,
    with the same losses, fields, cursors, checkpoint steps and
    sidecars; the port's resumed state bit for bit its straight one."""
    runs = {}
    for side in SIDES:
        d = tmp_path / side
        ref = _run(side, d / "ref", 6, fp32_on_disk=fp32_on_disk)
        first = _run(side, d / "run", 6, fp32_on_disk=fp32_on_disk,
                     plan=T.FaultPlan(sigterm_at_step=3))
        second = _run(side, d / "run", 6, fp32_on_disk=fp32_on_disk)
        assert first[0].preempted and first[0].step == 3
        assert second[0].restored_from == 3 and second[0].step == 6
        runs[side] = (ref, first, second)
    for j, t in zip(runs["jax"], runs["torch"]):
        _same_run(j, t)
    assert _bits(runs["torch"][2][0].state) == _bits(runs["torch"][0][0]
                                                     .state)
    assert runs["torch"][2][1].consumed == 6
    for sub in ("ref", "run"):
        assert all_steps(str(tmp_path / "torch" / sub)) == \
            j_all_steps(str(tmp_path / "jax" / sub))
        assert _sidecars(tmp_path / "torch" / sub) == \
            _sidecars(tmp_path / "jax" / sub)


def test_torn_final_checkpoint_falls_back_loudly(tmp_path):
    """The preemption save's COMMITTED marker lost: both restores warn,
    fall back to step 2 and end where a straight run does."""
    plan = T.FaultPlan(sigterm_at_step=3, save_errors={2: 1},
                       tear_after_step=3)
    out = {}
    for side in SIDES:
        d = tmp_path / side
        ref = _run(side, d / "ref", 5)
        first = _run(side, d / "run", 5, plan=plan)
        assert first[0].preempted and first[0].step == 3
        assert torn_steps(str(d / "run")) == [3]
        with pytest.warns(UserWarning, match="torn"):
            second = _run(side, d / "run", 5)
        assert second[0].restored_from == 2
        assert first[3].snapshot()["ckpt/retries"] == 1
        out[side] = (ref, second)
    _same_run(out["jax"][1], out["torch"][1])
    assert _bits(out["torch"][1][0].state) == _bits(out["torch"][0][0].state)


def test_preempt_drains_inflight_save(tmp_path):
    """A save in flight when the preemption lands is drained: every
    committed step restores, the last one the preemption's."""
    from apex_tpu_torch.checkpoint import restore_checkpoint
    plan = T.FaultPlan(sigterm_at_step=3, slow_save_s=0.1)
    res, _, _, _ = _run("torch", tmp_path, 6, plan=plan)
    assert res.preempted
    from apex_tpu_torch.elastic.runner import _tree
    for s in all_steps(str(tmp_path)):
        _, host = restore_checkpoint(str(tmp_path), _tree(res.state),
                                     step=s)
        assert host["step"] == s
    assert all_steps(str(tmp_path))[-1] == 3


@pytest.mark.parametrize("side", list(SIDES))
def test_env_var_termination_is_a_preemption(tmp_path, monkeypatch, side):
    monkeypatch.delenv("APEX_TPU_TERMINATE", raising=False)
    calls = {"n": 0}

    def trip(k, loss):
        calls["n"] += 1
        if calls["n"] == 3:
            monkeypatch.setenv("APEX_TPU_TERMINATE", "now")

    res, _, _, _ = _run(side, tmp_path, 10, on_step=trip)
    assert res.preempted and res.step == 3


def test_restart_after_completion_never_rewrites_the_checkpoint(tmp_path):
    """A fit that restores at N and runs no further step saves nothing:
    the COMMITTED marker and ``ckpt/saves`` stay as they were."""
    reg = MetricsRegistry()
    _run("torch", tmp_path, 3, save_interval=10, keep_last=1, registry=reg)
    marker = tmp_path / "step_00000003" / "COMMITTED"
    mtime = marker.stat().st_mtime_ns
    saves = reg.snapshot()["ckpt/saves"]
    res, _, _, _ = _run("torch", tmp_path, 3, save_interval=10, keep_last=1,
                        registry=reg)
    assert res.restored_from == 3 and res.step == 3
    assert reg.snapshot()["ckpt/saves"] == saves
    assert marker.stat().st_mtime_ns == mtime


def test_completed_run_reports_the_reference_metrics(tmp_path):
    """``ckpt/saves``, ``train/steps`` and, after a restore,
    ``resume/resumes`` and ``resume/restored_step`` as the reference
    counts them."""
    snaps = {}
    for side in SIDES:
        reg = SIDES[side]["registry"]()
        d = tmp_path / side
        res, _, _, _ = _run(side, d, 4, save_interval=2, keep_last=2,
                            registry=reg)
        assert not res.preempted and res.loss is not None
        _run(side, d, 4, save_interval=2, registry=reg)
        snaps[side] = reg.snapshot()
    keys = ("ckpt/saves", "ckpt/retries", "train/steps", "resume/resumes",
            "resume/restored_step", "ckpt/inflight")
    assert {k: snaps["torch"].get(k) for k in keys} == \
        {k: snaps["jax"].get(k) for k in keys}
    assert snaps["torch"]["resume/resumes"] == 1
    assert snaps["torch"]["resume/restored_step"] == 4


def test_validation_and_unported_guard(tmp_path):
    with pytest.raises(ValueError):
        T.ElasticRunner(TorchToy(), SIDES["torch"]["data"](), str(tmp_path),
                        save_interval=0)
    runner = T.ElasticRunner(TorchToy(), SIDES["torch"]["data"](),
                             str(tmp_path), registry=MetricsRegistry())
    with pytest.raises(NotImplementedError, match="A7b"):
        runner.fit(2, no_recompile=True)


@pytest.mark.parametrize("side", list(SIDES))
def test_second_sigterm_during_drain_raises(tmp_path, side):
    """The first SIGTERM drains; a second one while the slowed final save
    is written raises ``DrainInterrupt``, the handlers restored and step
    2's save the first the hook saw."""
    mod = SIDES[side]["mod"]
    plan = mod.FaultPlan(sigterm_at_step=2, slow_save_s=0.3)
    fired = []

    def hook(step, attempt):
        if not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)
        plan.on_save_attempt(step, attempt)

    ck = mod.AsyncCheckpointer(str(tmp_path), registry=SIDES[side][
        "registry"](), fault_hook=hook)
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(mod.DrainInterrupt, match="second termination"):
        _run(side, tmp_path, 6, save_interval=10, plan=plan,
             checkpointer=ck)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert fired == [2]
    ck.drain()


@pytest.mark.parametrize("side", list(SIDES))
def test_single_sigterm_stays_graceful(tmp_path, side):
    plan = T.FaultPlan(sigterm_at_step=2, slow_save_s=0.1)
    res, _, _, _ = _run(side, tmp_path, 6, save_interval=10, plan=plan)
    assert res.preempted and res.step == 2
    assert all_steps(str(tmp_path)) == [2]


@pytest.mark.parametrize("pid,step,kills", [
    ("0", 3, []), ("1", 2, []), ("1", 3, [signal.SIGKILL])])
def test_before_step_signals_match_the_reference(monkeypatch, pid, step,
                                                 kills):
    """``kill_process`` SIGKILLs only the named rank at its step, and
    ``sigterm_at_step`` SIGTERMs; both packages deliver the same."""
    from apex_tpu.parallel import multiproc as jmp
    got = {}
    for side, mod in (("jax", J), ("torch", T)):
        sent = []
        monkeypatch.setattr(os, "kill",
                            lambda p, s, sent=sent: sent.append((p, s)))
        monkeypatch.setenv(jmp.ENV_PROCESS_ID, pid)
        mod.FaultPlan(kill_process={1: 3}).before_step(step)
        mod.FaultPlan(sigterm_at_step=step).before_step(step)
        mod.FaultPlan(sigterm_at_step=step + 1).before_step(step)
        got[side] = sent
    want = [(os.getpid(), s) for s in kills] + [(os.getpid(),
                                                 signal.SIGTERM)]
    assert got["torch"] == got["jax"] == want


# ---------------------------------------------------------------------------
# GPTHybridTrainer under the runner, on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def test_gpt_preempt_resume_bit_for_bit(pools, tmp_path):
    """The port's GPT (2 layers, hidden 32) under ``ElasticRunner``: 3
    steps, a SIGTERM, a fresh runner to 6, against 6 straight: the
    losses, the params, optimizer state and loss scale (sha256) and the
    data cursor bit for bit."""
    (out,) = pools.run(1, R.preempt_resume, str(tmp_path))
    ref, first, second = out["ref"], out["first"], out["second"]
    assert first["preempted"] and first["step"] == 3
    assert second["restored_from"] == 3 and second["step"] == 6
    assert not second["resharded"]
    assert second["losses"] == {k: v for k, v in ref["losses"].items()
                                if k > 3}
    assert second["digest"] == ref["digest"]
    assert second["cursor"] == ref["cursor"]
    assert second["metrics"]["resume/resumes"] == 1


def test_zero_bucket_bytes_restore_guard(pools, tmp_path):
    (msg,) = pools.run(1, R.bucket_guard, str(tmp_path))
    assert msg is not None and "bucket_bytes" in msg


def test_dp2_to_dp1_shrink_matches_uninterrupted(pools, tmp_path):
    """ZeRO at dp 2 for 2 steps (bucket-major, 512-byte buckets), then a
    dp 1 runner on the same directory: it reshards (``resharded``,
    ``resume/reshards``), the master's natural vector element-identical
    to dp 2's, and steps 3-4 within the reference's 2e-3 of an
    uninterrupted dp 1 run; the sidecar's world the reference runner's
    for the same mesh and layout."""
    import shutil

    from apex_tpu_torch.elastic import reshard
    run = str(tmp_path / "run")
    dp2 = pools.run(2, R.gpt_fit, run, 2, True, 512)
    total = dp2[0]["flat_total"]
    master2 = np.concatenate([o["master"] for o in dp2])
    # the restored master alone: a copy of the directory fitted to step 2
    peek = str(tmp_path / "peek")
    shutil.copytree(run, peek)
    (restored,) = pools.run(1, R.gpt_fit, peek, 2, True, 512)
    assert restored["resharded"] and restored["restored_from"] == 2
    np.testing.assert_array_equal(
        reshard.to_natural(restored["master"], total, 1, 512),
        reshard.to_natural(master2, total, 2, 512))
    (shrunk,) = pools.run(1, R.gpt_fit, run, 4, True, 512)
    assert shrunk["resharded"] and shrunk["restored_from"] == 2
    assert shrunk["metrics"]["resume/reshards"] == 1
    (ref,) = pools.run(1, R.gpt_fit, str(tmp_path / "ref"), 4, True, 512)
    for k in (3, 4):
        assert abs(shrunk["losses"][k] - ref["losses"][k]) <= \
            2e-3 * max(1.0, abs(ref["losses"][k]))

    # the sidecar's world: what the reference's runner records for a
    # trainer of this mesh and flat layout
    from types import SimpleNamespace as NS
    got = _sidecars(tmp_path / "run")["step_00000002"]["host_state"]
    stub = NS(mesh=NS(shape={"data": 2, "pipe": 1, "tensor": 1,
                             "context": 1}), is_zero=True,
              opt=NS(_layout=NS(total=total), bucket_bytes=512))
    want = J.ElasticRunner(stub, None, str(tmp_path / "jax"),
                           registry=JRegistry())._world_meta()
    assert got["world"] == want
    assert got["data"] == dp2[0]["cursor"] == {
        "consumed": 2, "seed": 9, "num_hosts": 1, "global_batch": R.GB_ROWS}


def test_model_axis_change_is_refused(pools, tmp_path):
    run = str(tmp_path / "run")
    pools.run(1, R.gpt_fit, run, 1)
    (msg,) = pools.run(1, R.model_axis_refused, run)
    assert msg is not None and "only the data axis" in msg
