"""Port ``scaled_value_and_grad``, in-step telemetry, ``fp16_utils`` and
the transformer ``GradScaler`` vs the JAX package on the CPU.

- ``scaled_value_and_grad`` on a small MLP (a parameter the loss does not
  read included): value, aux, grads, the finite flag and the new scale
  state against the JAX function, with and without aux, at a 2**12
  scale, a static scale, bf16 ``grad_dtype`` and a forced overflow (a
  3e38 scale over targets 1e3 larger); through
  ``torch.func.functional_call`` on a module; nothing left in ``.grad``;
  ``axis_names`` that are not bound raising ``ValueError`` (the reduction
  itself across ranks: ``tests/test_torch_sync_dist.py``);
- ``ingraph``: ``record`` with no collector open evaluates nothing,
  ``collecting``/``reap``, sum and overwrite modes, the errors,
  ``recorded_names``, ``aggregate``, ``Metrics.as_floats``;
- ``amp/loss_scale``, ``amp/overflow_count``, ``amp/skipped_steps`` and
  ``optim/grad_norm`` under ``reap`` around a step (``scaled_value_and_
  grad`` then ``FusedAdam.step``) against the JAX values, clean and
  overflowing, dynamic and static; with no collector, the step's aten
  calls (counted with a ``TorchDispatchMode``, as
  ``tests/test_torch_resilience.py`` counts them) and host reads equal
  those of the same step with ``record`` removed;
- ``FP16_Optimizer`` over fp16 params and a 4-step trajectory with an
  overflow (master, model params in place, Adam state, scale state), the
  network casts and ``prep_param_lists``/``master_params_to_model_params``;
- ``GradScaler``: a trajectory with an overflow against the JAX scaler's
  arithmetic, ``all_finite_synced`` at one device, and the raise over a
  process group of two with no model-parallel axes bound.

Tolerances: 1e-6 relative on fp32 values and grads (summation order
only), 1e-5 on the grad norm's square root; scale states and finite flags
exactly; fp16 model params exactly (the same fp32 master, one rounding).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import apex_tpu.amp as jamp
import apex_tpu.fp16_utils as jfp16
from apex_tpu.observability import ingraph as jingraph
from apex_tpu.optimizers import FusedAdam as JaxAdam
import apex_tpu_torch.amp as tamp
import apex_tpu_torch.fp16_utils as tfp16
from apex_tpu_torch.observability import ingraph
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.amp import GradScaler

SHAPES = {"w1": (6, 8), "b1": (8,), "w2": (8, 3), "unused": (4,)}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 0.5).astype(np.float32)
            for k, s in SHAPES.items()}


def _data(seed=1, kind="dynamic"):
    """Inputs and targets; for ``kind="overflow"`` targets 1e3 larger, so
    that at the 3e38 scale the scaled grads overflow fp32."""
    rng = np.random.RandomState(seed)
    big = 1e3 if kind == "overflow" else 1.0
    return (rng.randn(5, 6).astype(np.float32),
            (rng.randn(5, 3) * big).astype(np.float32))


def _jax_loss(p, x, y, aux=False):
    pred = jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]
    loss = jnp.mean((pred - y) ** 2)
    return (loss, {"pred": pred}) if aux else loss


def _torch_loss(p, x, y, aux=False):
    pred = torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]
    loss = torch.mean((pred - y) ** 2)
    return (loss, {"pred": pred}) if aux else loss


def _leaf_params(np_params):
    return {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in np_params.items()}


def _close(got, ref, rtol=1e-6):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32), ref, rtol=rtol,
        atol=rtol * max(float(np.abs(ref).max(initial=0.0)), 1.0))


def _scalers(kind):
    if kind == "static":
        return jamp.StaticLossScale(8.0), tamp.StaticLossScale(8.0)
    init = 3e38 if kind == "overflow" else 2.0 ** 12
    return (jamp.DynamicLossScale(init_scale=init),
            tamp.DynamicLossScale(init_scale=init))


CASES = [("dynamic", False, "float32"), ("dynamic", True, "float32"),
         ("static", True, "float32"), ("overflow", False, "float32"),
         ("dynamic", False, "bfloat16")]


@pytest.mark.parametrize("kind,aux,grad_dtype", CASES)
def test_scaled_value_and_grad_matches_jax(kind, aux, grad_dtype):
    params = _params()
    x, y = _data(kind=kind)
    jscale, tscale = _scalers(kind)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[grad_dtype]
    jstep = jamp.scaled_value_and_grad(
        lambda p, x, y: _jax_loss(p, x, y, aux), jscale, has_aux=aux,
        grad_dtype=jdt)
    tstep = tamp.scaled_value_and_grad(
        lambda p, x, y: _torch_loss(p, x, y, aux), tscale, has_aux=aux,
        grad_dtype=tdt)
    jv, jaux, jg, jfin, jst = jstep(
        jscale.init(), jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x), jnp.asarray(y))
    tp = _leaf_params(params)
    tv, taux, tg, tfin, tst = tstep(tscale.init(device="cpu"), tp,
                                    torch.from_numpy(x), torch.from_numpy(y))
    _close(tv, jv)
    assert not tv.requires_grad
    if aux:
        _close(taux["pred"], jaux["pred"])
        assert not taux["pred"].requires_grad
    else:
        assert taux is None and jaux is None
    assert bool(tfin) == bool(jfin) == (kind != "overflow")
    assert float(tst.loss_scale) == float(jst.loss_scale)
    assert int(tst.unskipped) == int(jst.unskipped)
    for k in SHAPES:
        assert tg[k].dtype == torch.float32    # promoted, as JAX promotes
        if kind == "overflow":
            assert not torch.isfinite(tg[k]).all() or k == "unused"
        else:
            _close(tg[k], jg[k])
    assert torch.equal(tg["unused"], torch.zeros(4))
    assert all(p.grad is None for p in tp.values())


def test_scaled_value_and_grad_through_functional_call():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Tanh(),
                                torch.nn.Linear(4, 2))
    x = torch.randn(7, 6)
    params = dict(model.named_parameters())
    scaler = tamp.DynamicLossScale(init_scale=2.0 ** 10)
    step = tamp.scaled_value_and_grad(
        lambda p, x: torch.func.functional_call(model, p, (x,)).pow(2)
        .mean(), scaler)
    value, _, grads, finite, state = step(scaler.init(device="cpu"), params,
                                          x)
    model(x).pow(2).mean().backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-6,
                                   atol=1e-7)
    assert bool(finite) and int(state.unskipped) == 1


def test_axis_names_raise():
    step = tamp.scaled_value_and_grad(lambda p: p["a"].sum(),
                                      tamp.DynamicLossScale(),
                                      axis_names="data")
    scaler = tamp.DynamicLossScale()
    with pytest.raises(ValueError, match="not bound"):
        step(scaler.init(device="cpu"),
             {"a": torch.ones(2, requires_grad=True)})
    with pytest.raises(ValueError, match="not bound"):
        tamp.all_finite({"a": torch.ones(2)}, axis_names=("tensor",))
    assert bool(tamp.all_finite({"a": torch.ones(2)}, axis_names=None))
    assert bool(tamp.all_finite({"a": torch.ones(2)}, axis_names=()))


# ---------------------------------------------------------------------------
# ingraph
# ---------------------------------------------------------------------------

def test_record_without_collector_evaluates_nothing():
    called = []
    assert not ingraph.recording()
    ingraph.record("x", lambda: called.append(1) or 1.0)
    ingraph.record("x", 1.0, reduce="not-a-mode")   # not even validated
    assert called == [] and ingraph.recorded_names() == ()


def test_collecting_and_reap():
    with ingraph.collecting() as col:
        assert ingraph.recording()
        ingraph.record("n", torch.tensor(2.0), reduce="sum")
        ingraph.record("n", 3, reduce="sum")
        ingraph.record("g", lambda: torch.tensor(1.0))
        ingraph.record("g", torch.tensor(4.0, dtype=torch.float64))
        assert ingraph.recorded_names() == ("n", "g")
        with ingraph.collecting():
            assert ingraph.recorded_names() == ()
        with pytest.raises(ValueError, match="previously recorded"):
            ingraph.record("n", 1.0, reduce="max")
        with pytest.raises(ValueError, match="scalars"):
            ingraph.record("v", torch.ones(2))
        with pytest.raises(ValueError, match="unknown reduction"):
            ingraph.record("v", 1.0, reduce="median")
        m = col.freeze()
    assert not ingraph.recording()
    assert m.as_floats() == {"n": 5.0, "g": 4.0}
    assert m.modes == {"n": "sum", "g": "mean"}
    assert m["g"].dtype == torch.float32 and "n" in m and len(m) == 2
    out, m2 = ingraph.reap(lambda a: ingraph.record("a", a) or a + 1)(2.0)
    assert out == 3.0 and m2.as_floats() == {"a": 2.0}
    assert ingraph.aggregate(m2, None) is m2 and ingraph.aggregate(m2, ())
    with pytest.raises(ValueError, match="not bound"):
        ingraph.aggregate(m2, "data")
    assert ingraph.Metrics().as_floats() == {}


def _jax_step(jscale, params, x, y, lr=1e-2):
    opt = JaxAdam(lr=lr)

    def step(p, ls):
        v, _, g, fin, ls = jamp.scaled_value_and_grad(_jax_loss, jscale)(
            ls, p, x, y)
        p, _ = opt.step(g, opt.init(p), p, grads_finite=fin)
        return p, ls

    return jingraph.reap(step)(params, jscale.init())


def _torch_step(tscale, params, x, y, lr=1e-2):
    opt = FusedAdam(lr=lr)
    state = opt.init(params)

    def step(ls):
        v, _, g, fin, ls = tamp.scaled_value_and_grad(_torch_loss, tscale)(
            ls, params, x, y)
        opt.step(g, state, params, grads_finite=fin)
        return ls

    return step


@pytest.mark.parametrize("kind", ["dynamic", "static", "overflow"])
def test_step_metrics_match_jax(kind):
    params = _params(2)
    x, y = _data(3, kind)
    jscale, tscale = _scalers(kind)
    (jp, jls), jm = _jax_step(jscale, jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    tp = _leaf_params(params)
    ls, tm = ingraph.reap(_torch_step(tscale, tp, torch.from_numpy(x),
                                      torch.from_numpy(y)))(
        tscale.init(device="cpu"))
    names = ("amp/loss_scale", "amp/overflow_count", "amp/skipped_steps",
             "optim/grad_norm")
    assert set(tm.values) == set(jm.values) == set(names)
    assert tm.modes == {k: jm.modes[k] for k in names}
    got, want = tm.as_floats(), jm.as_floats()
    for k in names[:3]:
        assert got[k] == want[k], k
    assert got["amp/loss_scale"] == float(ls.loss_scale)
    if kind == "overflow":
        assert got["amp/overflow_count"] == 1.0
        assert not np.isfinite(got["optim/grad_norm"])
    else:
        assert abs(got["optim/grad_norm"] / want["optim/grad_norm"] - 1) \
            <= 1e-5
        for k in SHAPES:
            _close(tp[k], jp[k])


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


_HOST_READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__",
               "__index__")


def _count(monkeypatch, fn):
    reads = collections.Counter()
    with monkeypatch.context() as m:
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def wrapped(self, *a, _orig=orig, _name=name, **kw):
                reads[_name] += 1
                return _orig(self, *a, **kw)

            m.setattr(torch.Tensor, name, wrapped)
        with CountOps() as mode:
            fn()
    return mode.ops, reads


def test_telemetry_costs_nothing_with_no_collector(monkeypatch):
    x, y = (torch.from_numpy(a) for a in _data(4))
    scaler = tamp.DynamicLossScale(init_scale=2.0 ** 12)

    def counted():
        params = _leaf_params(_params(5))
        step = _torch_step(scaler, params, x, y)
        ls = scaler.init(device="cpu")
        return _count(monkeypatch, lambda: step(ls))

    with_record = counted()
    with monkeypatch.context() as m:
        m.setattr(ingraph, "record", lambda *a, **k: None)
        without = counted()
    assert with_record == without
    assert sum(with_record[1].values()) == 0      # no host read either
    # and a collector does add the telemetry's ops
    with ingraph.collecting():
        on = counted()
    assert sum(on[0].values()) > sum(with_record[0].values())


# ---------------------------------------------------------------------------
# fp16_utils and GradScaler
# ---------------------------------------------------------------------------

def test_network_casts_and_param_lists():
    params = _params(6)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    half = tfp16.network_to_half(tp)
    ref = jfp16.network_to_half(jax.tree_util.tree_map(jnp.asarray, params))
    for k in SHAPES:
        assert half[k].dtype == torch.float16 and ref[k].dtype == jnp.float16
        np.testing.assert_array_equal(half[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))
    assert tfp16.convert_network(tp, torch.bfloat16)["w1"].dtype == \
        torch.bfloat16
    model, master = tfp16.prep_param_lists(tp)
    assert model is tp
    for k in SHAPES:
        assert master[k].dtype == torch.float32
        assert master[k].data_ptr() != tp[k].data_ptr()    # a copy
        assert torch.equal(master[k], tp[k])
    master["w1"].add_(1.0)
    out = tfp16.master_params_to_model_params(half, master)
    assert out is half and half["w1"].dtype == torch.float16
    assert torch.equal(half["w1"], master["w1"].half())
    assert tfp16.LossScaler is tamp.StaticLossScale
    assert tfp16.DynamicLossScaler is tamp.DynamicLossScale


def test_fp16_optimizer_trajectory_matches_jax():
    params = _params(7)
    half_np = {k: np.asarray(jnp.asarray(v, jnp.float16), np.float32)
               for k, v in params.items()}
    jparams = {k: jnp.asarray(v, jnp.float16) for k, v in half_np.items()}
    tparams = {k: torch.from_numpy(v.copy()).half()
               for k, v in half_np.items()}
    kw = dict(dynamic_loss_scale=True, init_scale=2.0 ** 8,
              growth_interval=2)
    jopt = jfp16.FP16_Optimizer(JaxAdam(lr=1e-2), **kw)
    topt = tfp16.FP16_Optimizer(FusedAdam(lr=1e-2), **kw)
    jst, tst = jopt.init(jparams), topt.init(tparams)
    assert tst[0]["w1"].dtype == torch.float32
    assert tst[2].loss_scale.device == tparams["w1"].device
    rng = np.random.RandomState(8)
    for i in range(4):
        g = {k: (rng.randn(*s) * 256).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == 2:
            g["b1"][0] = np.inf
        jg = {k: jnp.asarray(v, jnp.float16) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.asarray(v, np.float32)).half()
              for k, v in jg.items()}
        jparams, jst = jopt.step(jg, jst, jparams)
        out, tst = topt.step(tg, tst, tparams)
        assert out is tparams
        for k in SHAPES:
            assert tparams[k].dtype == torch.float16
            np.testing.assert_array_equal(tparams[k].float().numpy(),
                                          np.asarray(jparams[k], np.float32))
            _close(tst[0][k], jst[0][k])
            _close(tst[1].exp_avg[k], jst[1].exp_avg[k])
        assert int(tst[1].step) == int(jst[1].step)
        assert float(tst[2].loss_scale) == float(jst[2].loss_scale), i
        assert int(tst[2].unskipped) == int(jst[2].unskipped), i
    scaled = topt.scale_loss(tst, torch.tensor(1.5))
    assert float(scaled) == 1.5 * float(tst[2].loss_scale)


def test_grad_scaler_trajectory_matches_jax():
    kw = dict(init_scale=2.0 ** 4, growth_factor=4.0, backoff_factor=0.25,
              growth_interval=2)
    jinner = jamp.DynamicLossScale(**kw)    # the JAX GradScaler's arithmetic
    scaler = GradScaler(**kw)
    assert scaler.model_parallel_axes == ("tensor", "pipe")
    jst, tst = jinner.init(), scaler.init(device="cpu")
    rng = np.random.RandomState(9)
    for i in range(6):
        g = rng.randn(3, 2).astype(np.float32)
        if i in (2, 3):
            g[1, 1] = np.nan
        jfin = jamp.all_finite({"g": jnp.asarray(g)})
        tfin = scaler.all_finite_synced({"g": torch.from_numpy(g)})
        assert bool(tfin) == bool(jfin) == (i not in (2, 3))
        _close(scaler.unscale(tst, {"g": torch.from_numpy(g)})["g"],
               jinner.unscale(jst, {"g": jnp.asarray(g)})["g"])
        _close(scaler.scale(tst, torch.from_numpy(g)),
               jinner.scale(jst, jnp.asarray(g)))
        jst, tst = jinner.update(jst, jfin), scaler.update(tst, tfin)
        assert float(tst.loss_scale) == float(jst.loss_scale), i
        assert int(tst.unskipped) == int(jst.unskipped), i


def test_grad_scaler_raises_over_a_process_group(monkeypatch):
    scaler = GradScaler()
    grads = {"g": torch.ones(2)}
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    assert bool(scaler.all_finite_synced(grads))
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="not bound"):
        scaler.all_finite_synced(grads)
