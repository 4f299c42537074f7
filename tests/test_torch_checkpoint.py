"""The port's checkpointing (``apex_tpu_torch.checkpoint``, the
asynchronous writer of ``apex_tpu_torch.elastic.ckpt``, the fault plan's
checkpoint hooks and the serving ``CheckpointWatcher``) against the JAX
package's on the CPU.

- the directory protocol: the port's ``all_steps``, ``torn_steps``,
  ``latest_step`` and ``read_host_state`` on a directory the JAX package
  wrote give JAX's answers; the same saves, tears and ``keep``/
  ``keep_last`` pruning in both packages give the same step lists, the
  same ``host.json`` bytes, the same torn-step warning and the same
  errors (the arrays differ by design: orbax there, per-rank
  ``torch.save`` files here, so neither reads the other's arrays);
- a bridged JAX state (a small GPT's params, Adam moments and step, the
  loss-scale state) with the RNG tracker's generator states, saved and
  restored by the port, is bit for bit itself and the JAX arrays, fp32
  and bf16, with and without ``fp32_on_disk``; a bf16 save restores into
  an fp32 target widened exactly;
- bitwise resume: a small GPT (bf16 compute, fp32 params, ``FusedAdam``,
  ``DynamicLossScale``, the tracker's dropout stream at steps 1 and 4) for
  5 steps straight against 3 steps, a save, a fresh model, optimizer,
  scaler and tracker restored, and 2 more: every loss and every leaf
  bit for bit;
- ``AsyncCheckpointer`` under ``FaultPlan(save_errors=..., tear_after_step
  =...)``: the ``ckpt/*`` metrics, the retries' backoff schedule, the
  steps left committed and torn, and a failure re-raised by ``drain``,
  all equal to the JAX checkpointer's; ``host_snapshot`` owns its copies;
- the watcher on one bridged fp32 engine in each package: ``poll`` is a
  no-op without a checkpoint, swaps in the newest committed step once
  (``serve/swaps`` 1), ignores a torn newer one, and the greedy stream
  after the swap equals JAX's and that of an engine built on the new
  weights.

Tolerance: none; every comparison is exact.
"""

import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from apex_tpu import checkpoint as J
from apex_tpu.elastic.ckpt import AsyncCheckpointer as JAsync
from apex_tpu.elastic.faults import FaultPlan as JPlan
from apex_tpu.models import GPTConfig as JCfg, GPTModel as JGPT
from apex_tpu.observability.registry import MetricsRegistry as JRegistry
from apex_tpu_torch import checkpoint as T
from apex_tpu_torch._bridge import (_to_numpy, optimizer_state_from_jax,
                                    params_from_jax)
from apex_tpu_torch.elastic import (AsyncCheckpointer, FaultPlan,
                                    host_snapshot, snapshot_nbytes)
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import MetricsRegistry

SIZES = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=16)


def _x(v):
    return {"x": jnp.full(2, float(v))}


def _tear(path):
    os.remove(os.path.join(path, "COMMITTED"))


def _protocol(mod, root, save, leaf):
    """The same saves, tears and pruning through ``mod``: the step lists,
    host.json of step 3, the torn-step warning and the errors, with the
    directory's name replaced."""
    d = str(root)
    for s in (1, 2, 3):
        save(d, leaf(s), s, host_state={"consumed_samples": 8 * s},
             keep=2)
    _tear(save(d, leaf(4), 4))
    out = {"all": mod.all_steps(d), "torn": mod.torn_steps(d),
           "latest": mod.latest_step(d), "host": mod.read_host_state(d),
           "host2": mod.read_host_state(d, 2)}
    with open(os.path.join(d, "step_00000003", "host.json"), "rb") as f:
        out["host.json"] = f.read()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod.restore_checkpoint(d, leaf(0))
    # (orbax adds warnings of its own)
    out["warnings"] = [str(w.message).replace(d, "<dir>") for w in caught
                       if w.category is UserWarning
                       and "torn" in str(w.message)]
    errors = []
    for call in (lambda: mod.read_host_state(d, 4),
                 lambda: mod.restore_checkpoint(d, leaf(0), step=4),
                 lambda: save(d, leaf(5), 5, keep=1, keep_last=2),
                 lambda: save(d, leaf(5), 5, keep_last=0)):
        with pytest.raises((FileNotFoundError, ValueError)) as err:
            call()
        errors.append((err.type, str(err.value).replace(d, "<dir>")))
    out["errors"] = errors
    only = os.path.join(d, "only_torn")
    _tear(save(only, leaf(7), 7))
    with pytest.warns(UserWarning, match="torn"):
        with pytest.raises(FileNotFoundError) as err:
            mod.restore_checkpoint(only, leaf(0))
    out["only_torn"] = str(err.value).replace(d, "<dir>")
    return out


def test_directory_protocol_matches_jax(tmp_path):
    want = _protocol(J, tmp_path / "jax", J.save_checkpoint, _x)
    got = _protocol(T, tmp_path / "port", T.save_checkpoint,
                    lambda v: {"x": torch.full((2,), float(v))})
    assert got == want
    assert want["all"] == [2, 3] and want["torn"] == [4]


def test_port_reads_a_directory_jax_wrote(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        J.save_checkpoint(d, _x(s), s, host_state={"world": {"dp": s}},
                          keep_last=2)
    _tear(J.save_checkpoint(d, _x(9), 9))
    for fn in ("all_steps", "torn_steps", "latest_step", "read_host_state"):
        assert getattr(T, fn)(d) == getattr(J, fn)(d), fn
    assert T.read_host_state(d, 2) == J.read_host_state(d, 2)
    for mod in (T, J):
        with pytest.raises(FileNotFoundError, match="not committed"):
            mod.read_host_state(d, 9)


@functools.lru_cache(maxsize=None)
def _jax_state(dtype):
    """A small JAX GPT's params in ``dtype``, Adam moments after a step
    and the loss-scale state, as numpy."""
    from apex_tpu.amp.scaler import DynamicLossScale
    from apex_tpu.optimizers import FusedAdam
    jm = JGPT(JCfg(**SIZES))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                    jm.init(jax.random.PRNGKey(0)))
    opt = FusedAdam(lr=1e-3)
    grads = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 0.5), params)
    params, st = jax.jit(opt.step)(grads, opt.init(params), params)
    ls = DynamicLossScale(init_scale=2.0 ** 10).init()
    return jax.tree_util.tree_map(np.asarray, (params, st, ls))


def _bits(tree):
    return [(str(t.dtype), t.shape, _to_numpy(t).tobytes()) if isinstance(
        t, torch.Tensor) else t for t in tree_leaves(tree)]


@pytest.mark.parametrize("fp32_on_disk", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridged_jax_state_round_trips_bit_for_bit(tmp_path, dtype,
                                                   fp32_on_disk):
    from apex_tpu_torch.amp.scaler import LossScaleState
    from apex_tpu_torch.optimizers import AdamState
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        RNGStatesTracker)
    jp, jst, jls = _jax_state(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    cfg = GPTConfig(**SIZES)
    params = params_from_jax(jp, cfg)
    jmoments = optimizer_state_from_jax(jst, AdamState)
    tracker = RNGStatesTracker(device="cpu")
    tracker.add("model-parallel-rng", 7)
    tracker.make_key("model-parallel-rng")
    state = {"params": params, "opt": jmoments,
             "ls": LossScaleState(*(torch.from_numpy(np.array(a))
                                    for a in jls)),
             "rng": tracker.get_states()}
    T.save_checkpoint(str(tmp_path), state, 1, fp32_on_disk=fp32_on_disk)
    got, _ = T.restore_checkpoint(str(tmp_path), state)
    assert _bits(got) == _bits(state)
    for name, t in got["params"].items():
        assert t.dtype == params[name].dtype
    # the restored leaves are the JAX arrays' bits
    np.testing.assert_array_equal(
        _to_numpy(got["params"]["final_ln.weight"]),
        np.asarray(jp["final_ln"]["weight"]).view(
            np.uint16 if dtype == "bfloat16" else np.float32))
    np.testing.assert_array_equal(got["ls"].loss_scale.numpy(), jls[0])
    t2 = RNGStatesTracker(device="cpu")
    t2.set_states(got["rng"])
    a = torch.randn(4, generator=tracker.make_key("model-parallel-rng"))
    b = torch.randn(4, generator=t2.make_key("model-parallel-rng"))
    assert torch.equal(a, b)


def test_bf16_save_restores_into_an_fp32_target(tmp_path):
    w = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    T.save_checkpoint(str(tmp_path), {"w": w}, 0)
    got, _ = T.restore_checkpoint(
        str(tmp_path), {"w": torch.empty(3, device="meta")})
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], w.float())
    with pytest.raises(ValueError, match="is \\(3,\\)"):
        T.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4)})



@pytest.mark.parametrize("fp32_on_disk", [True, False])
def test_numpy_leaves_round_trip(tmp_path, fp32_on_disk):
    state = {"h": np.array([1.5, -2.25, 65504.0], np.float16),
             "i": np.arange(6, dtype=np.int64).reshape(2, 3),
             "s": np.float32(0.125), "t": torch.arange(3)}
    T.save_checkpoint(str(tmp_path), state, 0, fp32_on_disk=fp32_on_disk)
    got, _ = T.restore_checkpoint(str(tmp_path), state)
    for k in ("h", "i", "s"):
        assert type(got[k]) is type(state[k]), k
        assert got[k].dtype == state[k].dtype, k
        np.testing.assert_array_equal(got[k], state[k])
    assert torch.equal(got["t"], state["t"])


# -- bitwise resume ----------------------------------------------------------

def _trainer(seed=0):
    from apex_tpu_torch.amp import DynamicLossScale
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        RNGStatesTracker)
    cfg = GPTConfig(compute_dtype=torch.bfloat16, hidden_dropout=0.1,
                    attention_dropout=0.1, **SIZES)
    model = GPTModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    params = dict(model.named_parameters())
    opt, scaler = FusedAdam(lr=1e-3), DynamicLossScale(init_scale=2.0 ** 8)
    tracker = RNGStatesTracker(device="cpu")
    tracker.add("model-parallel-rng", 1234)
    return {"model": model, "params": params, "opt": opt,
            "scaler": scaler, "tracker": tracker,
            "state": {"params": params, "opt": opt.init(params),
                      "ls": scaler.init(device="cpu"),
                      "rng": tracker.get_states()}}


def _step(tr, tokens, dropout: bool):
    from apex_tpu_torch.amp import all_finite
    st = tr["state"]
    gen = tr["tracker"].make_key("model-parallel-rng") if dropout else None
    for p in tr["params"].values():
        p.grad = None
    loss = tr["model"].loss(tokens, tokens, generator=gen)
    (loss * st["ls"].loss_scale).backward()
    grads = tr["scaler"].unscale(
        st["ls"], {n: p.grad for n, p in tr["params"].items()})
    finite = all_finite(grads)
    st["ls"] = tr["scaler"].update(st["ls"], finite)
    tr["opt"].step(grads, st["opt"], tr["params"], grads_finite=finite)
    st["rng"] = tr["tracker"].get_states()
    return loss.detach()


DROPOUT_STEPS = (1, 4)


def test_gpt_resume_is_bit_for_bit(tmp_path):
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, SIZES["vocab_size"], (4, 16)))
    straight = _trainer()
    want = [_step(straight, tokens, i in DROPOUT_STEPS) for i in range(5)]
    run = _trainer()
    got = [_step(run, tokens, i in DROPOUT_STEPS) for i in range(3)]
    T.save_checkpoint(str(tmp_path), run["state"], 3,
                      host_state={"step": 3})
    fresh = _trainer(seed=1)
    restored, host = T.restore_checkpoint(str(tmp_path), fresh["state"])
    assert host == {"step": 3}
    with torch.no_grad():
        for n, p in fresh["params"].items():
            p.copy_(restored["params"][n])
    fresh["state"] = dict(restored, params=fresh["params"])
    fresh["tracker"].set_states(restored["rng"])
    got += [_step(fresh, tokens, i in DROPOUT_STEPS) for i in range(3, 5)]
    assert [float(x) for x in got] == [float(x) for x in want]
    assert _bits(fresh["state"]) == _bits(straight["state"])


# -- the asynchronous checkpointer --------------------------------------------

def _async_run(cls, plan_cls, registry, d, leaf):
    plan = plan_cls(save_errors={2: 2}, tear_after_step=3)
    ck = cls(d, keep_last=3, retry_backoff_s=1e-3, host_id=3,
             registry=registry, fault_hook=plan.on_save_attempt,
             after_save=plan.after_save)
    schedule = [ck._backoff_sleep_s(2, a) for a in (1, 2, 3)]
    for s in (1, 2, 3):
        ck.save(leaf(s), s, host_state={"step": s})
    ck.drain()
    snap = registry.snapshot()
    out = {"metrics": {k: v for k, v in snap.items()
                       if k.startswith("ckpt/") and "save_ms" not in k},
           "saves_ms": snap.get("ckpt/save_ms_count"),
           "schedule": schedule, "last": ck.last_saved_step,
           "all": T.all_steps(d), "torn": T.torn_steps(d)}
    bad = cls(os.path.join(d, "bad"), max_retries=1, retry_backoff_s=1e-3,
              registry=registry,
              fault_hook=plan_cls(save_errors={1: 5}).on_save_attempt)
    bad.save(leaf(1), 1)
    with pytest.raises(OSError) as err:
        bad.drain()
    out["error"] = (str(err.value), str(err.value.__cause__))
    bad.drain()          # the error is raised once
    return out


def test_async_checkpointer_matches_jax(tmp_path):
    jreg, treg = JRegistry(), MetricsRegistry()
    want = _async_run(JAsync, JPlan, jreg, str(tmp_path / "jax"),
                      lambda v: {"x": jnp.full(4, float(v))})
    got = _async_run(AsyncCheckpointer, FaultPlan, treg,
                     str(tmp_path / "port"),
                     lambda v: {"x": torch.full((4,), float(v))})
    assert got == want
    assert want["metrics"]["ckpt/retries"] == 2
    assert want["all"] == [1, 2] and want["torn"] == [3]


def test_host_snapshot_owns_its_copies():
    live = {"w": torch.arange(6.0), "n": 3,
            "g": torch.Generator().manual_seed(1).get_state()}
    snap = host_snapshot(live)
    live["w"].add_(1.0)
    assert torch.equal(snap["w"], torch.arange(6.0)) and snap["n"] == 3
    assert snap["w"].untyped_storage().data_ptr() != \
        live["w"].untyped_storage().data_ptr()
    assert snapshot_nbytes(snap) == 6 * 4 + snap["g"].numel()


# -- the serving watcher -------------------------------------------------------

ENGINE = dict(max_seqs=2, max_len=16, prefill_len=8)


def _greedy(engine, prompts, steps=6):
    toks = np.array([engine.prefill(p, s) for s, p in enumerate(prompts)],
                    np.int64)
    out = [toks.tolist()]
    temps, active = np.zeros(len(prompts), np.float32), np.ones(
        len(prompts), bool)
    for _ in range(steps):
        toks = np.asarray(engine.decode(toks, temps, active)).astype(
            np.int64)
        out.append(toks.tolist())
    return out


def test_checkpoint_watcher_matches_jax(tmp_path):
    from apex_tpu.serving import ServingEngine as JEngine
    from apex_tpu.serving import watch_checkpoints as jwatch
    from apex_tpu_torch.serving import ServingEngine, watch_checkpoints
    jm = JGPT(JCfg(compute_dtype=jnp.float32, **SIZES))
    old, new = (jm.init(jax.random.PRNGKey(s)) for s in (0, 1))
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)

    def port_engine(tree):
        return ServingEngine(
            GPTModel(cfg, device="cpu"),
            params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg),
            cache_dtype=torch.float32, device="cpu", **ENGINE)

    je = JEngine(jm, old, cache_dtype=jnp.float32, **ENGINE)
    pe = port_engine(old)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jreg, treg = JRegistry(), MetricsRegistry()
    jw, tw = jwatch(je, jd, registry=jreg), watch_checkpoints(
        pe, td, registry=treg)
    assert jw.step is None and tw.step is None and jw.poll() is tw.poll()
    J.save_checkpoint(jd, new, 5)
    T.save_checkpoint(td, params_from_jax(
        jax.tree_util.tree_map(np.asarray, new), cfg), 5)
    assert jw.poll() == tw.poll() == 5
    assert jw.poll() is None and tw.poll() is None
    _tear(J.save_checkpoint(jd, old, 6))
    _tear(T.save_checkpoint(td, pe.model.state_dict(), 6))
    assert jw.poll() is None and tw.poll() is None
    assert treg.snapshot()["serve/swaps"] == jreg.snapshot()[
        "serve/swaps"] == 1
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    stream = _greedy(pe, prompts)
    assert stream == _greedy(je, prompts) == _greedy(port_engine(new),
                                                     prompts)
    assert json.loads(open(os.path.join(td, "step_00000005", "host.json"))
                      .read())["step"] == 5
