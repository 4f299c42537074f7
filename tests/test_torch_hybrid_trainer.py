"""The port's ``GPTHybridTrainer`` on gloo ranks against the JAX
package's ``GPTHybridTrainer`` on the CPU devices.

The configuration is ``tests/test_remat_policy.py::_trainer_cfg``'s:
vocab 64, hidden 32, 4 layers, 4 heads, seq 8, 2 microbatches of 2 a data
rank, Adam at lr 1e-2, ``opt_level="O0"`` (fp32). The JAX trainer's
``init_state`` is cut for each rank by ``_bridge.hybrid_state_from_jax``
(the rank bodies are in ``tests/_torch_pp_ranks.py``), and the ranks'
states are restacked into the JAX layout by
``_bridge.stack_hybrid_state``.

- tp 2 x pp 2 x dp 2 (eight ranks): three steps' losses at 1e-5, the
  step's metrics (``pipeline/*``, ``amp/*``), and the params after step 0
  by the rule of queue item C-2 (ROADMAP.md): at 5e-5 where the JAX
  grad of the loss on the whole batch stays above 1e-6 of its leaf's
  largest, within lr elsewhere (Adam's first step moves an element by
  about lr times the sign of its grad, and a grad at rounding level has
  no sign to agree on); every data and pipeline replica of a parameter
  equal;
- tp 2 x pp 2 (four ranks) the same, and with the shared grads left
  unsummed over the pipeline (a planted error) the check fails: the
  stages' embedding replicas step on half their grads;
- ZeRO-1 against the replicated Adam trainer at pp 2 x dp 2 (the
  reference's 3e-6, ``tests/test_dp_overlap.py:357-372``);
- sequence parallelism with the ring overlap at pp 1 (tp 2 x dp 2)
  against the JAX trainer, its ``tp/*`` metrics equal, and at pp > 1 the
  reference's refusal;
- a NaN in one rank's grads skips the step on every rank;
- donation, the queue items' refusals (A7a, A7b), and the bridge's round
  trip bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_pp_ranks as R
from apex_tpu import config as jcfg
from apex_tpu.models import GPTConfig as JCfg, GPTModel as JGPT
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch import _bridge
from apex_tpu_torch.models import GPTConfig

LR = 1e-2
GRAD_FLOOR = 1e-6
TOL_LOSS, TOL_STEADY, TOL_ZERO = 1e-5, 5e-5, 3e-6


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _cfg(tp, pp, dp, **model):
    """``_trainer_cfg``'s config at these sizes, as a dict both packages
    read, and its batch."""
    M, mb, seq = 2, 2, 8
    d = {"model": dict(name="gpt", vocab_size=64, hidden_size=32,
                       num_layers=4, num_attention_heads=4,
                       max_position_embeddings=seq, **model),
         "parallel": dict(tensor_model_parallel_size=tp,
                          pipeline_model_parallel_size=pp),
         "batch": dict(global_batch_size=M * mb * dp, micro_batch_size=mb),
         "optimizer": dict(name="adam", lr=LR, weight_decay=0.0),
         "opt_level": "O0"}
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (M, dp * mb, seq))
    targets = rng.randint(0, 64, (M, dp * mb, seq))
    return d, tokens, targets


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# XLA's CPU runtime runs independent collectives of one device at once,
# and the JAX trainer's step (a tensor-group all-reduce beside the
# pipeline's collective permute) then deadlocks now and then in the
# rendezvous and aborts the process (seen in about half of the runs at
# eight devices). So the JAX trainer runs in a child process whose XLA
# schedules its collectives in one order and waits up to 300 s (not 40)
# for a slow device thread on a busy host, and a child that still aborts
# in a rendezvous is run again.
CHILD_XLA_FLAGS = ("--xla_cpu_enable_concurrency_optimized_scheduler=false "
                   "--xla_cpu_collective_call_terminate_timeout_seconds=300")
CHILD_TRIES = 3


def _jax_run(*args, **kwargs):
    """:func:`_jax_trainer_run` in a child process (see
    ``CHILD_XLA_FLAGS``)."""
    import os
    import pathlib
    import pickle
    import subprocess
    import sys
    import tempfile
    tests = pathlib.Path(__file__).resolve().parent
    code = ("import os, pickle, sys\n"
            f"os.environ['XLA_FLAGS'] = {CHILD_XLA_FLAGS!r}\n"
            "from apex_tpu.utils.hostmesh import force_virtual_cpu_devices\n"
            "force_virtual_cpu_devices(8)\n"
            "import test_torch_hybrid_trainer as T\n"
            "args, kwargs = pickle.load(open(sys.argv[1], 'rb'))\n"
            "out = T._jax_trainer_run(*args, **kwargs)\n"
            "pickle.dump(out, open(sys.argv[2], 'wb'))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tests.parent), str(tests)]))
    with tempfile.TemporaryDirectory(prefix="jax_trainer_") as tmp:
        src, dst = f"{tmp}/args.pkl", f"{tmp}/out.pkl"
        with open(src, "wb") as f:
            pickle.dump((args, kwargs), f)
        for _ in range(CHILD_TRIES):
            run = subprocess.run([sys.executable, "-c", code, src, dst],
                                 env=env, capture_output=True, text=True,
                                 timeout=600)
            if run.returncode == 0:
                with open(dst, "rb") as f:
                    return pickle.load(f)
            if "rendezvous" not in run.stderr:
                break
    raise RuntimeError(f"the JAX trainer's child failed "
                       f"({run.returncode}):\n{run.stderr[-4000:]}")


def _jax_trainer_run(cfg_dict, tokens, targets, steps, world,
                     metrics=False):
    """The JAX trainer from ``PRNGKey(0)``: its initial (stage, shared),
    the losses, the state after step 0 and after the last step, each
    step's metrics, and the grad of the loss on the whole batch at the
    initial params (in the trainer's layout)."""
    from apex_tpu.training import GPTHybridTrainer
    from apex_tpu.transformer import parallel_state
    cfg = jcfg.TrainConfig.from_dict(cfg_dict)
    mesh = cfg.initialize_mesh(devices=jax.devices()[:world])
    try:
        tr = GPTHybridTrainer(cfg, mesh)
        state = tr.init_state(jax.random.PRNGKey(0))
        init = _np(state[:2])
        step = jax.jit(tr.train_step_with_metrics if metrics
                       else tr.train_step)
        losses, after0, mets = [], None, []
        for i in range(steps):
            out = step(*state, jnp.asarray(tokens), jnp.asarray(targets))
            losses.append(float(out[0]))
            state = out[1:5]
            if metrics:
                mets.append(out[5].as_floats())
            if i == 0:
                after0 = _np(state[:2])
        grads = _whole_batch_grads(cfg, tr, init, tokens, targets)
        return init, losses, after0, _np(state[:2]), mets, grads
    finally:
        parallel_state.destroy_model_parallel()


def _whole_batch_grads(cfg, tr, init, tokens, targets):
    """``jax.grad`` of ``GPTModel.loss`` on the whole batch (every
    microbatch of every data rank) at the initial params, under
    ``shard_map`` over the tensor axis, cut into the trainer's layout."""
    tp = cfg.parallel.tensor_model_parallel_size
    model = JGPT(dataclasses.replace(tr.model.cfg, sequence_parallel=False,
                                     tp_comm_overlap=False))
    stage_stack, shared = init
    L = cfg.model.num_layers
    layers = jax.tree_util.tree_map(
        lambda a: a.reshape(L, *a.shape[2:]), stage_stack)
    params = {"embedding": shared["embedding"], "layers": layers,
              "final_ln": shared["final_ln"]}
    specs = model.param_specs(params)
    tok = jnp.asarray(tokens.reshape(-1, tokens.shape[-1]))
    tgt = jnp.asarray(targets.reshape(-1, targets.shape[-1]))
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tensor",))
    grads = jax.jit(shard_map(
        lambda p: jax.grad(lambda q: model.loss(q, tok, tgt))(p),
        mesh=mesh, in_specs=(specs,), out_specs=specs))(params)
    grads = _np(grads)
    pp = cfg.parallel.pipeline_model_parallel_size
    stack = jax.tree_util.tree_map(
        lambda a: a.reshape(pp, L // pp, *a.shape[1:]), grads["layers"])
    return stack, {"embedding": grads["embedding"],
                   "final_ln": grads["final_ln"]}


def _restack(outs, which, cfg_dict, data_rank=0):
    """The JAX layout of the ranks' ``which`` state (of one data rank)."""
    par = cfg_dict["parallel"]
    pp, tp = par["pipeline_model_parallel_size"], \
        par["tensor_model_parallel_size"]
    states = [[None] * tp for _ in range(pp)]
    for o in outs:
        p, t, d = o["coords"]
        if d == data_rank:
            states[p][t] = tuple({k: torch.from_numpy(v) for k, v in
                                  sd.items()} for sd in o[which])
    return _bridge.stack_hybrid_state(
        states, GPTConfig(num_layers=cfg_dict["model"]["num_layers"]), pp,
        tp)


def _param_errors(got, want, grads):
    """The worst ``|port - JAX|`` over the elements whose whole-batch
    grad is above ``GRAD_FLOOR`` of its leaf's largest, and over the
    rest."""
    steady, floor = 0.0, 0.0
    for (path, w), g, jg in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(grads)):
        jg = np.abs(np.asarray(jg, np.float32))
        keep = jg > GRAD_FLOOR * jg.max()
        diff = np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32))
        steady = max(steady, float(diff[keep].max(initial=0.0)))
        floor = max(floor, float(diff[~keep].max(initial=0.0)))
    return steady, floor


def _replicas_equal(outs):
    """Every data replica of a rank's state, and every pipeline replica
    of the shared params (per tensor rank), equal bit for bit."""
    by = {}
    for o in outs:
        p, t, d = o["coords"]
        by[(p, t, d)] = o["last"]
    for (p, t, d), (stage, shared) in by.items():
        ref_stage, _ = by[(p, t, 0)]
        _, ref_shared = by[(0, t, 0)]
        for k, v in stage.items():
            np.testing.assert_array_equal(v, ref_stage[k], err_msg=k)
        for k, v in shared.items():
            np.testing.assert_array_equal(v, ref_shared[k], err_msg=k)


def _check_against_jax(outs, jax_run, cfg_dict):
    _, j_losses, j_after0, _, _, grads = jax_run
    for o in outs:
        np.testing.assert_allclose(o["losses"], j_losses, rtol=0,
                                   atol=TOL_LOSS)
    got = _restack(outs, "after0", cfg_dict)
    return _param_errors(got, j_after0, grads)


def test_trainer_tp2_pp2_dp2_matches_jax(pools):
    cfg_dict, tokens, targets = _cfg(2, 2, 2)
    jr = _jax_run(cfg_dict, tokens, targets, 3, 8, metrics=True)
    outs = pools.run(8, R.trainer_steps, cfg_dict, jr[0], tokens, targets, 3,
                     None, True, timeout=300)
    steady, floor = _check_against_jax(outs, jr, cfg_dict)
    assert steady <= TOL_STEADY, steady
    assert floor <= LR, floor
    _replicas_equal(outs)
    assert all(o["step"] == 3 for o in outs)
    j_mets = jr[4]
    for o in outs:
        for got, want in zip(o["metrics"], j_mets):
            for key in ("pipeline/num_microbatches", "pipeline/ticks",
                        "pipeline/bubble_fraction", "amp/loss_scale",
                        "amp/overflow_count", "amp/skipped_steps"):
                # means over the eight ranks, summed in another order
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                           err_msg=key)


@pytest.mark.parametrize("plant", [None, "unsummed_shared"],
                         ids=["correct", "planted"])
def test_trainer_tp2_pp2_check_catches_unsummed_shared_grads(pools, plant):
    """At tp 2 x pp 2 the port holds to the JAX trainer; with the shared
    grads left unsummed over the pipeline the same check fails."""
    cfg_dict, tokens, targets = _cfg(2, 2, 1)
    jr = _jax_trainer_tp2_pp2()
    outs = pools.run(4, R.trainer_steps, cfg_dict, jr[0], tokens, targets, 2,
                     plant, timeout=300)
    if plant is None:
        steady, floor = _check_against_jax(outs, jr, cfg_dict)
        assert steady <= TOL_STEADY and floor <= LR, (steady, floor)
        _replicas_equal(outs)
        return
    got = _restack(outs, "after0", cfg_dict)
    steady, _ = _param_errors(got, jr[2], jr[5])
    assert steady > 100 * TOL_STEADY, steady


@functools.lru_cache(maxsize=None)
def _jax_trainer_tp2_pp2():
    cfg_dict, tokens, targets = _cfg(2, 2, 1)
    return _jax_run(cfg_dict, tokens, targets, 2, 4)


def test_trainer_zero_matches_replicated_adam(pools):
    """ZeRO-1 (bucketed, 1 KiB) against replicated Adam at pp 2 x dp 2,
    from one seed, three steps: losses and params within 3e-6."""
    cfg_dict, tokens, targets = _cfg(1, 2, 2)
    ref = pools.run(4, R.trainer_seeded, cfg_dict, 0, tokens, targets, 3,
                    timeout=300)
    zero = dict(cfg_dict, optimizer=dict(cfg_dict["optimizer"], zero=1),
                ddp_bucket_bytes=1024)
    got = pools.run(4, R.trainer_seeded, zero, 0, tokens, targets, 3,
                    timeout=300)
    for a, b in zip(ref, got):
        assert a["coords"] == b["coords"]
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=TOL_ZERO,
                                   atol=TOL_ZERO)
        for i in (0, 1):
            for k, v in a["last"][i].items():
                np.testing.assert_allclose(b["last"][i][k], v, rtol=TOL_ZERO,
                                           atol=TOL_ZERO, err_msg=k)


def test_trainer_sequence_parallel_overlap_at_pp1_matches_jax(pools):
    """Sequence parallelism with the ring overlap at tp 2 x dp 2 (pp 1):
    losses and params against the JAX trainer, and the ``tp/*`` metrics
    the step records (M passes a step) equal to JAX's."""
    cfg_dict, tokens, targets = _cfg(2, 1, 2, sequence_parallel=True,
                                     tp_comm_overlap=True)
    jr = _jax_run(cfg_dict, tokens, targets, 2, 4, metrics=True)
    outs = pools.run(4, R.trainer_steps, cfg_dict, jr[0], tokens, targets, 2,
                     None, True, timeout=300)
    steady, floor = _check_against_jax(outs, jr, cfg_dict)
    assert steady <= TOL_STEADY and floor <= LR, (steady, floor)
    _replicas_equal(outs)
    for o in outs:
        for got, want in zip(o["metrics"], jr[4]):
            for key in ("tp/collective_bytes", "tp/overlap_chunks"):
                assert got[key] == want[key], (key, got[key], want[key])


def test_trainer_refusals(pools):
    """Sequence parallelism at pp 2 raises as the reference does; a
    health policy at level "full" builds, and an unknown health level
    raises the reference's ``ValueError``; the donation self-check,
    ``attribution_report`` and ``ddp_bucket_bytes="auto"`` name A7b; a
    config whose pipeline size is not the mesh's raises."""
    cfg_dict, _, _ = _cfg(2, 2, 1)
    out = pools.run(4, R.trainer_refusals, cfg_dict)[0]
    assert out["health"] is None, out["health"]
    assert out["health_cfg"][0] == "ValueError" and \
        "level must be one of" in out["health_cfg"][1], out["health_cfg"]
    for case in ("verify_donation", "attribution", "auto"):
        assert out[case][0] == "NotImplementedError" and "A7b" in \
            out[case][1], out[case]
    assert out["pp"][0] == "ValueError"
    sp, _, _ = _cfg(2, 2, 1, sequence_parallel=True)
    got = pools.run(4, R._trainer_error, sp)[0]
    from apex_tpu.training import GPTHybridTrainer
    from apex_tpu.transformer import parallel_state
    jc = jcfg.TrainConfig.from_dict(sp)
    mesh = jc.initialize_mesh(devices=jax.devices()[:4])
    try:
        with pytest.raises(NotImplementedError) as e:
            GPTHybridTrainer(jc, mesh)
    finally:
        parallel_state.destroy_model_parallel()
    assert got == ("NotImplementedError", str(e.value))


def test_trainer_nan_on_one_rank_skips_every_rank(pools):
    cfg_dict, tokens, targets = _cfg(2, 2, 1)
    for nan_rank in (0, 3):
        outs = pools.run(4, R.trainer_nan, cfg_dict, 0, tokens, targets,
                         nan_rank, timeout=300)
        for o in outs:
            assert o["kept"] and o["step"] == 0, o
            assert o["scale"] == (256.0, 128.0), o


def test_trainer_donation(pools):
    cfg_dict, tokens, targets = _cfg(1, 2, 2)
    for o in pools.run(4, R.trainer_donation, cfg_dict, 0, tokens, targets,
                       timeout=300):
        assert o == {"kept": True, "moved": True, "in_place": True,
                     "same_loss": True}, o


@pytest.mark.parametrize("tp,pp,chunks", [(2, 2, 1), (1, 4, 1), (2, 2, 2)],
                         ids=["tp2_pp2", "pp4", "tp2_pp2_v2"])
def test_bridge_round_trip_bit_for_bit(tp, pp, chunks):
    """The JAX trainer's state (and an Adam state over it) cut for every
    rank and restacked: equal bit for bit."""
    from apex_tpu.optimizers import AdamState as JAdamState
    sizes = dict(vocab_size=64, hidden_size=32, num_layers=8,
                 num_attention_heads=4, max_position_embeddings=8)
    jm = JGPT(JCfg(tensor_model_parallel_size=tp, **sizes))
    params = _np(jm.init(jax.random.PRNGKey(tp + pp)))
    L, lead = sizes["num_layers"], ((chunks, pp) if chunks > 1 else (pp,))
    stack = jax.tree_util.tree_map(
        lambda a: a.reshape(*lead, L // (pp * chunks), *a.shape[1:]),
        params["layers"])
    shared = {"embedding": params["embedding"],
              "final_ln": params["final_ln"]}
    rng = np.random.RandomState(0)
    noise = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.randn(*a.shape).astype(np.float32), t)
    opt = JAdamState(step=np.int32(3), exp_avg=(noise(stack), noise(shared)),
                     exp_avg_sq=(noise(stack), noise(shared)))
    cfg = GPTConfig(tensor_model_parallel_size=tp, **sizes)
    cut = [[_bridge.hybrid_state_from_jax(stack, shared, cfg, pp, p, t,
                                          chunks, opt_state=opt)
            for t in range(tp)] for p in range(pp)]
    for what, pick in (("params", lambda c: (c[0], c[1])),
                       ("exp_avg", lambda c: c[2].exp_avg),
                       ("exp_avg_sq", lambda c: c[2].exp_avg_sq)):
        back = _bridge.stack_hybrid_state(
            [[pick(c) for c in row] for row in cut], cfg, pp, tp, chunks)
        want = {"params": (stack, shared), "exp_avg": opt.exp_avg,
                "exp_avg_sq": opt.exp_avg_sq}[what]
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
    assert all(int(c[2].step) == 3 for row in cut for c in row)
    # a rank's stage holds its chunks' layers by the global stage law
    stage, _ = cut[1][0][:2]
    per = L // (pp * chunks)
    names = {f"{j}.qkv.weight" if chunks == 1 else f"{c}.{j}.qkv.weight"
             for c in range(chunks) for j in range(per)}
    assert names <= set(stage)
    layers = _bridge.pipeline_layers(L, pp, 1, chunks)
    np.testing.assert_array_equal(
        stage[min(names)].numpy(),
        params["layers"]["qkv"]["weight"][layers[0][0]][0])
