"""Port FusedNovoGrad, FusedAdagrad, LARC and TrainConfig's new optimizer
branches vs the JAX package on the CPU.

- ``FusedNovoGrad``: 5-step fp32 trajectories at ``norm_type`` 2 and 0, in
  both moment modes, with ``init_zero``, weight decay, ``grad_averaging``
  and ``bias_correction`` off: params, the momentum and the per-tensor
  norm EMA each step;
- ``FusedAdagrad`` in L2 and decoupled (``adagrad_w_mode``) mode;
  ``FlatOptimizer(FusedAdagrad)`` bit for bit equal to the per-leaf
  optimizer, and to the JAX ``FlatOptimizer(FusedAdagrad)``;
- ``larc_transform_grads`` (clip on and off, weight decay, a zero param
  and a zero grad left untouched) and ``LARC(FusedSGD)``,
  ``LARC(FusedAdam)`` trajectories, the inner decay restored after;
- the bridge for ``NovoGradState`` and ``AdagradState``, bit for bit;
- ``TrainConfig.build_optimizer`` for ``lamb``, ``novograd`` and
  ``adagrad`` (flat and not) against the JAX config's;
- no optimizer step of this slice reads a value back to the host (no
  ``aten._local_scalar_dense`` under a dispatch mode).

Tolerance: 1e-6 of each leaf's largest magnitude (or 1e-6 below 1): the
reference's arithmetic, the norms summed in another order; the flat tier
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from apex_tpu import config as jcfg
from apex_tpu.optimizers import FlatOptimizer as JaxFlat
from apex_tpu.optimizers import FusedAdagrad as JaxAdagrad
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.optimizers import FusedNovoGrad as JaxNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.optimizers import LARC as JaxLARC
from apex_tpu.optimizers import larc_transform_grads as jax_larc
from apex_tpu_torch import config as tcfg
from apex_tpu_torch._bridge import optimizer_state_from_jax
from apex_tpu_torch.optimizers import (LARC, AdagradState, FlatOptimizer,
                                       FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedMixedPrecisionLamb,
                                       FusedNovoGrad, FusedSGD,
                                       NovoGradState, larc_transform_grads)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2), "d": (4,)}
STEPS = 5
TOL = 1e-6


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.randn(*s) * scale, np.float32)
            for k, s in SHAPES.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_tree(got, ref, rtol=TOL, what=""):
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(
            got[k].detach().float().numpy(), r, rtol=rtol,
            atol=rtol * max(float(np.abs(r).max(initial=0.0)), 1.0),
            err_msg=f"{what} {k}")


def _run(jopt, opt, seed=0, mult=1.0, check_state=None, **step_kw):
    rng = np.random.RandomState(seed)
    p0 = _tree(rng)
    jp = _j(p0)
    jst = jopt.init(jp)
    tp = _t(p0)
    st = opt.init(tp)
    for i in range(STEPS):
        g = _tree(rng, mult)
        jp, jst = jopt.step(_j(g), jst, jp, **step_kw)
        opt.step(_t(g), st, tp, **step_kw)
        _assert_tree(tp, jp, what=f"params step {i}")
        if check_state is not None:
            check_state(st, jst, i)
    return tp, st


NOVOGRAD_CASES = {
    "l2": dict(),
    "linf": dict(norm_type=0),
    "l2_reg_inside": dict(reg_inside_moment=True, weight_decay=0.01),
    "linf_reg_inside": dict(norm_type=0, reg_inside_moment=True,
                            weight_decay=0.01),
    "l2_decay": dict(weight_decay=0.01),
    "init_zero": dict(init_zero=True),
    "linf_init_zero": dict(norm_type=0, init_zero=True, weight_decay=0.01),
    "no_averaging": dict(grad_averaging=False),
    "no_bias_correction": dict(bias_correction=False, norm_type=0),
}


@pytest.mark.parametrize("case", list(NOVOGRAD_CASES))
def test_novograd_trajectory_matches_jax(case):
    kw = dict(lr=0.01, **NOVOGRAD_CASES[case])

    def check(st, jst, i):
        _assert_tree(st.exp_avg, jst.exp_avg, what=f"m step {i}")
        _assert_tree(st.exp_avg_sq, jst.exp_avg_sq, what=f"v step {i}")
        assert all(v.shape == () for v in st.exp_avg_sq.values())

    _run(JaxNovoGrad(**kw), FusedNovoGrad(**kw), check_state=check)


def test_novograd_refusals():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)
    with pytest.raises(RuntimeError, match="l2/inf"):
        FusedNovoGrad(norm_type=1)


@pytest.mark.parametrize("w_mode", [False, True])
def test_adagrad_trajectory_matches_jax(w_mode):
    kw = dict(lr=0.05, weight_decay=0.01, adagrad_w_mode=w_mode)

    def check(st, jst, i):
        _assert_tree(st.sum_sq, jst.sum_sq, what=f"h step {i}")

    _run(JaxAdagrad(**kw), FusedAdagrad(**kw), check_state=check)


@pytest.mark.parametrize("w_mode", [False, True])
def test_flat_adagrad_bit_for_bit(w_mode):
    kw = dict(lr=0.05, weight_decay=0.01, adagrad_w_mode=w_mode)
    rng = np.random.RandomState(5)
    p0 = _tree(rng)
    leaf, flat = _t(p0), _t(p0)
    lopt, fopt = FusedAdagrad(**kw), FlatOptimizer(FusedAdagrad(**kw))
    lst, fst = lopt.init(leaf), fopt.init(flat)
    jopt = JaxFlat(JaxAdagrad(**kw))
    jp = _j(p0)
    jst = jopt.init(jp)
    for i in range(STEPS):
        g = _tree(rng)
        lopt.step(_t(g), lst, leaf)
        fopt.step(_t(g), fst, flat)
        jp, jst = jopt.step(_j(g), jst, jp)
        for k in SHAPES:
            assert torch.equal(leaf[k], flat[k]), (i, k)
        _assert_tree(flat, jp, what=f"flat vs JAX flat step {i}")
    # the persistent tier: one pass over the flat buffers
    popt = FlatOptimizer(FusedAdagrad(**kw))
    fs = popt.init_flat(_t(p0))
    rng = np.random.RandomState(5)
    _tree(rng)
    for _ in range(STEPS):
        g = _t(_tree(rng))
        popt.flat_step(torch.cat([g[k].reshape(-1) for k in SHAPES]), fs)
    for k, v in popt.params_of(fs).items():
        assert torch.equal(v, leaf[k]), k


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_larc_transform_matches_jax(clip, wd):
    rng = np.random.RandomState(6)
    p, g = _tree(rng), _tree(rng, 0.1)
    p["b"] = np.zeros(SHAPES["b"], np.float32)      # untouched: ||p|| == 0
    g["c"] = np.zeros(SHAPES["c"], np.float32)      # untouched: ||g|| == 0
    want = jax_larc(_j(g), _j(p), 0.1, 0.02, clip, 1e-8, weight_decay=wd)
    got = larc_transform_grads(_t(g), _t(p), 0.1, 0.02, clip, 1e-8,
                               weight_decay=wd)
    _assert_tree(got, want, what="larc")
    assert np.array_equal(got["b"].numpy(), g["b"])
    assert np.array_equal(got["c"].numpy(), g["c"])
    bf = larc_transform_grads(_t(g, torch.bfloat16), _t(p), 0.1)
    assert all(v.dtype == torch.bfloat16 for v in bf.values())


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_larc_wrapper_trajectory_matches_jax(inner):
    if inner == "sgd":
        jin = JaxSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
        pin = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    else:
        jin = JaxAdam(lr=1e-3, weight_decay=1e-2)
        pin = FusedAdam(lr=1e-3, weight_decay=1e-2)
    _run(JaxLARC(jin), LARC(pin), seed=7, mult=0.5)
    assert pin.weight_decay == (1e-4 if inner == "sgd" else 1e-2)


def test_bridge_novograd_and_adagrad_states():
    rng = np.random.RandomState(8)
    p0 = _tree(rng)
    for jopt, cls in ((JaxNovoGrad(lr=0.01), NovoGradState),
                      (JaxAdagrad(lr=0.01), AdagradState)):
        jp = _j(p0)
        jst = jopt.init(jp)
        for _ in range(2):
            jp, jst = jopt.step(_j(_tree(rng)), jst, jp)
        st = optimizer_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jst), cls, like=p0)
        assert int(st.step) == 2
        for a, b in zip(tree_leaves(st[1:]),
                        jax.tree_util.tree_leaves(jst[1:])):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name,flat", [("lamb", False), ("lamb", True),
                                       ("novograd", False),
                                       ("adagrad", False), ("adagrad", True)])
def test_build_optimizer_new_names_match_jax(name, flat):
    kw = dict(name=name, lr=3e-3, weight_decay=0.05, betas=(0.8, 0.95),
              eps=1e-6, flat=flat)
    opt = tcfg.TrainConfig(optimizer=tcfg.OptimizerConfig(
        **kw)).build_optimizer()
    ref = jcfg.TrainConfig(optimizer=jcfg.OptimizerConfig(
        **kw)).build_optimizer()
    assert isinstance(opt, FlatOptimizer) == flat
    if flat:
        opt, ref = opt.inner, ref.inner
    want = {"lamb": FusedLAMB, "novograd": FusedNovoGrad,
            "adagrad": FusedAdagrad}[name]
    assert type(opt) is want and type(ref).__name__ == want.__name__
    assert vars(opt) == vars(ref)


@pytest.mark.parametrize("make", [
    lambda: FusedLAMB(lr=0.01), lambda: FusedMixedPrecisionLamb(lr=0.01),
    lambda: FusedNovoGrad(lr=0.01), lambda: FusedNovoGrad(norm_type=0),
    lambda: FusedAdagrad(), lambda: FlatOptimizer(FusedAdagrad()),
    lambda: LARC(FusedSGD(lr=0.1, momentum=0.9)),
    lambda: LARC(FusedAdam())],
    ids=["lamb", "mp_lamb", "novograd", "novograd_linf", "adagrad",
         "flat_adagrad", "larc_sgd", "larc_adam"])
def test_steps_read_nothing_back_to_the_host(make):
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostRead(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            assert func is not torch.ops.aten._local_scalar_dense.default, \
                "a host read inside the step"
            return func(*args, **(kwargs or {}))

    rng = np.random.RandomState(9)
    opt = make()
    tp = _t(_tree(rng))
    st = opt.init(tp)
    with NoHostRead():
        for _ in range(2):
            opt.step(_t(_tree(rng)), st, tp, grads_finite=torch.tensor(True))
    assert int(st.step) == 2
