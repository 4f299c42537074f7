"""Port FusedSGD, the flat layout and FlatOptimizer vs the JAX package on
the CPU, and a ``bench.py::bench_headline``-style trajectory.

- ``FusedSGD`` over momentum, dampening, nesterov and the weight-decay
  order, with a fused ``scale``, three steps (the first seeds the
  momentum), params and buffers against the JAX ``FusedSGD``; its
  ``ValueError``;
- the layout: ``build_layout``'s memo (one object per structure,
  ``layout_cache_stats``), ``ravel``/``unravel`` against the JAX ones with
  padding;
- ``FlatOptimizer`` bit for bit equal to the optimizer it wraps (SGD and
  Adam, bf16 leaves, an overflow skip) and to the JAX ``FlatOptimizer``;
  its persistent-flat tier (views, one flat grad, ``flat_step``);
- three ``bench_headline`` steps of a small ResNet (fp32, 8 x 40 x 40
  images; ``FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9,
  weight_decay=1e-4))``, ``DynamicLossScale(2**12)``, the unscale fused
  into ``step(scale=1 / loss_scale)``) against the JAX step as bench.py
  composes it: each step from the JAX state before it, and the port's own
  trajectory, also with a NaN image at step 1 (an overflow: skipped,
  the scale halved).

Tolerances: the optimizer's arithmetic is the reference's, but XLA's CPU
code may contract a multiply and an add into one rounding: 1e-7 relative
on SGD params and buffers (fp32's unit roundoff is 6e-8); the flat tier
against the unflattened optimizer is compared bit for bit. A headline step
from a JAX state holds the loss at 1e-5 and params, BN statistics and
momenta at 1e-5 of each leaf's largest magnitude (or 1e-5 below 1), the
step count and scale exactly; the free-running trajectory, losses at 1e-5
then 1e-4 and the final state at 5e-3 (see its test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.amp.scaler import all_finite as jax_all_finite
from apex_tpu.models import ResNet50 as JaxResNet
from apex_tpu.models import ResNetConfig as JaxResNetConfig
from apex_tpu.optimizers import FlatOptimizer as JaxFlat
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.optimizers._flatten import build_layout as jax_layout
from apex_tpu.optimizers._flatten import ravel as jax_ravel
from apex_tpu.optimizers._flatten import unravel as jax_unravel
from apex_tpu_torch._bridge import (resnet_params_from_jax,
                                    resnet_params_to_numpy)
from apex_tpu_torch.amp import DynamicLossScale, LossScaleState, all_finite
from apex_tpu_torch.models import ResNet50, ResNetConfig
from apex_tpu_torch.optimizers import (FlatOptimizer, FusedAdam, FusedSGD,
                                       SGDState)
from apex_tpu_torch.optimizers._flatten import (build_layout,
                                                clear_layout_cache,
                                                layout_cache_stats, ravel,
                                                unravel)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2), "d": ()}


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.randn(*s) * scale, np.float32)
            for k, s in SHAPES.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _assert_tree(got, ref, rtol=1e-7, what=""):
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(
            got[k].detach().float().numpy(), r, rtol=rtol,
            atol=rtol * max(float(np.abs(r).max(initial=0.0)), 1.0),
            err_msg=f"{what} {k}")


SGD_CASES = [dict(momentum=0.0), dict(momentum=0.9),
             dict(momentum=0.9, dampening=0.1),
             dict(momentum=0.9, nesterov=True),
             dict(momentum=0.9, wd_after_momentum=True),
             dict(momentum=0.9, nesterov=True, wd_after_momentum=True),
             dict(momentum=0.0, wd_after_momentum=True)]


@pytest.mark.parametrize("case", SGD_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_fused_sgd_matches_jax(case):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    kw = dict(lr=0.05, weight_decay=1e-2, **case)
    jopt, opt = JaxSGD(**kw), FusedSGD(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = _t(params)
    st = opt.init(tp)
    for i in range(3):
        g = _tree(rng, 4.0)
        scale = 0.25 if i == 1 else 1.0
        jp, jst = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), jst, jp,
                            scale=scale)
        out, st2 = opt.step(_t(g), st, tp,
                            scale=torch.tensor(scale) if i else scale)
        assert out is tp and st2 is st
        _assert_tree(tp, jp, what=f"params step {i}")
        _assert_tree(st.momentum_buf, jst.momentum_buf, what=f"buf {i}")
        assert int(st.step) == int(jst.step) == i + 1


def test_fused_sgd_nesterov_needs_momentum():
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(momentum=0.9, dampening=0.1, nesterov=True)


def test_fused_sgd_bf16_params_keep_their_dtype():
    rng = np.random.RandomState(1)
    params = _tree(rng)
    g = _tree(rng)
    jopt = JaxSGD(lr=0.1, momentum=0.9)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    jp, _ = jopt.step(jax.tree_util.tree_map(jnp.asarray, g),
                      jopt.init(jp), jp)
    opt = FusedSGD(lr=0.1, momentum=0.9)
    tp = _t({k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
             for k, v in params.items()}, torch.bfloat16)
    opt.step(_t(g), opt.init(tp), tp)
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    _assert_tree(tp, {k: np.asarray(v, np.float32) for k, v in jp.items()},
                 rtol=0)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def test_layout_is_memoized_per_structure():
    clear_layout_cache()
    tree = _t(_tree(np.random.RandomState(2)))
    a = build_layout(tree)
    b = build_layout({k: v.clone() for k, v in tree.items()})
    assert a is b and layout_cache_stats() == {"hits": 1, "misses": 1}
    c = build_layout(tree, chunks=4)
    assert c is not a and c.padded % 4 == 0 and c.padded >= c.total
    d = build_layout({**tree, "b": torch.zeros(8)})
    assert d is not a and layout_cache_stats()["misses"] == 3
    clear_layout_cache()
    assert layout_cache_stats() == {"hits": 0, "misses": 0}


@pytest.mark.parametrize("chunks", [1, 4])
def test_ravel_unravel_match_jax(chunks):
    rng = np.random.RandomState(3)
    tree = _tree(rng)
    jl = jax_layout(tree, chunks)
    lay = build_layout(_t(tree), chunks)
    assert (lay.sizes, lay.offsets, lay.total, lay.padded, lay.chunk) == (
        jl.sizes, jl.offsets, jl.total, jl.padded, jl.chunk)
    flat = ravel(_t(tree), lay)
    assert torch.equal(flat, torch.from_numpy(np.asarray(jax_ravel(tree,
                                                                   jl))))
    back = unravel(flat, lay)
    ref = jax_unravel(jax_ravel(tree, jl), jl)
    for k in tree:
        assert np.array_equal(back[k].numpy(), np.asarray(ref[k]))
        assert back[k].data_ptr() >= flat.data_ptr()  # a view of flat
    with pytest.raises(ValueError, match="tree structure"):
        ravel({"a": torch.zeros(5, 3)}, lay)


# ---------------------------------------------------------------------------
# FlatOptimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_flat_optimizer_bit_equal_to_the_wrapped_one(inner):
    rng = np.random.RandomState(4)
    params = _tree(rng)
    make = ((lambda: FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
            if inner == "sgd" else (lambda: FusedAdam(lr=1e-2,
                                                      weight_decay=0.01)))
    flat, plain = FlatOptimizer(make()), make()
    fp, pp = _t(params), _t(params)
    fst, pst = flat.init(fp), plain.init(pp)
    for i in range(4):
        g = _t(_tree(rng))
        if i == 2:
            g["b"][3] = float("inf")
        fin = all_finite(g)
        kw = {"scale": torch.tensor(0.5)} if inner == "sgd" else {}
        flat.step(g, fst, fp, grads_finite=fin, **kw)
        plain.step(g, pst, pp, grads_finite=fin, **kw)
        for k in params:
            assert torch.equal(fp[k], pp[k]), (i, k)
    assert int(fst.step) == int(pst.step) == 3
    # the flat state is the wrapped optimizer's over the flat vector
    ref = ravel(pst.momentum_buf if inner == "sgd" else pst.exp_avg,
                build_layout(pp))
    assert torch.equal(fst.momentum_buf if inner == "sgd" else fst.exp_avg,
                       ref)


def test_flat_optimizer_matches_jax_flat_with_bf16_leaves():
    rng = np.random.RandomState(5)
    params = _tree(rng)
    params["b"] = np.asarray(jnp.asarray(params["b"], jnp.bfloat16),
                             np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "b" else jnp.float32)
          for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if k == "b" else torch.float32)
        for k, v in params.items()}
    jopt = JaxFlat(JaxSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    opt = FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    jst, st = jopt.init(jp), opt.init(tp)
    for _ in range(3):
        g = _tree(rng)
        jp, jst = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), jst, jp,
                            scale=0.5)
        opt.step(_t(g), st, tp, scale=0.5)
    assert tp["b"].dtype == torch.bfloat16
    _assert_tree(tp, {k: np.asarray(v, np.float32) for k, v in jp.items()})
    np.testing.assert_allclose(st.momentum_buf.numpy(),
                               np.asarray(jst.momentum_buf), rtol=1e-7,
                               atol=1e-7)


def test_persistent_flat_tier():
    rng = np.random.RandomState(6)
    params = _t(_tree(rng))
    target = _t(_tree(rng))
    opt = FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9))
    fstate = opt.init_flat(params)
    flat = fstate.flat_params.requires_grad_()
    views = opt.unflatten(flat)
    for k, v in views.items():      # views of the resident buffer
        assert v._base is flat or v.data_ptr() >= flat.data_ptr()
    loss = sum(((views[k] - target[k]) ** 2).sum() for k in views)
    (g,) = torch.autograd.grad(loss, flat)
    assert g.shape == flat.shape
    # the compat tier on the same grads gives the same values
    compat = FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9))
    tree = {k: v.clone() for k, v in params.items()}
    grads = {k: 2 * (params[k] - target[k]) for k in params}
    compat.step(grads, compat.init(tree), tree)
    out = opt.flat_step(g, fstate)
    assert out is fstate and int(fstate.inner_state.step) == 1
    got = opt.params_of(fstate)
    for k in tree:
        assert torch.equal(got[k], tree[k]), k
    skipped = opt.flat_step(g, fstate, grads_finite=torch.tensor(False))
    assert int(skipped.inner_state.step) == 1
    with pytest.raises(ValueError, match="init_flat"):
        FlatOptimizer(FusedSGD()).unflatten(flat)


# ---------------------------------------------------------------------------
# bench_headline's step, small
# ---------------------------------------------------------------------------

SMALL = dict(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8)
HEADLINE_STEPS = 3
HEADLINE_BATCH = 8
HEADLINE_LEAVES = 53
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4


@functools.lru_cache(maxsize=None)
def _jax_headline(nan_step):
    """bench_headline's step (bench.py:271-310) on a small fp32 ResNet,
    ``HEADLINE_STEPS`` times, and the state before and after each step:
    ``(params, bn, momentum tree, opt step, scale, unskipped)`` and the
    step's ``(loss, finite)``. The weights come from a seeded numpy draw in
    the JAX init's layout; with ``nan_step`` that step's images hold a
    NaN, so it overflows."""
    jm = JaxResNet(JaxResNetConfig(compute_dtype=jnp.float32, **SMALL))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "conv" in name:
            return (rng.randn(*s.shape) * (2.0 / (s.shape[0] * s.shape[1]
                                                  * s.shape[3])) ** 0.5
                    ).astype(s.dtype)
        if s.dtype == np.int32:
            return np.zeros((), np.int32)
        if "fc" in name or "bias" in name or "running_mean" in name:
            return (0.1 * rng.randn(*s.shape)).astype(s.dtype)
        return np.ones(s.shape, s.dtype)

    params, bn = (jax.tree_util.tree_map_with_path(leaf, t) for t in shapes)
    x = rng.randn(HEADLINE_BATCH, 40, 40, 3).astype(np.float32)
    xs = [x] * HEADLINE_STEPS
    if nan_step is not None:
        xs[nan_step] = x.copy()
        xs[nan_step][1, 2, 3, 0] = np.nan
    labels = rng.randint(0, 10, HEADLINE_BATCH)
    opt = JaxFlat(JaxSGD(lr=LR, momentum=MOMENTUM, weight_decay=WD))
    scaler = JaxScale(init_scale=2.0 ** 12)

    def loss_fn(p, s, x, scale):
        logits, new_bn = jm(p, s, x, training=True)
        onehot = jax.nn.one_hot(labels, 10)
        loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return loss * scale, (loss, new_bn)

    @jax.jit
    def step(p, s, o, ls, x):
        grads, (loss, new_bn) = jax.grad(loss_fn, has_aux=True)(
            p, s, x, ls.loss_scale)
        finite = jax_all_finite(grads)
        new_ls = scaler.update(ls, finite)
        p, o = opt.step(grads, o, p, grads_finite=finite,
                        scale=1.0 / ls.loss_scale)
        return p, new_bn, o, new_ls, loss, finite

    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    p, s, o, ls = params, bn, opt.init(params), scaler.init()
    states, outs = [], []
    for i in range(HEADLINE_STEPS + 1):
        states.append((np_tree(p), np_tree(s),
                       np_tree(jax_unravel(o.momentum_buf, opt._layout)),
                       int(o.step), float(ls.loss_scale), int(ls.unskipped)))
        if i == HEADLINE_STEPS:
            break
        p, s, o, ls, loss, finite = step(p, s, o, ls, jnp.asarray(xs[i]))
        outs.append((float(loss), bool(finite)))
    return xs, labels, states, outs


class _Headline:
    """The port's bench_headline step on a small fp32 ResNet loaded from a
    JAX state: ``FlatOptimizer(FusedSGD)``, ``DynamicLossScale(2**12)``,
    the unscale fused into ``opt.step``."""

    def __init__(self, state, labels):
        params, bn, buf, step, scale, unskipped = state
        self.model = ResNet50(ResNetConfig(compute_dtype=torch.float32,
                                           **SMALL), device="cpu")
        self.model.load_state_dict(resnet_params_from_jax(params, bn))
        self.named = dict(self.model.named_parameters())
        self.opt = FlatOptimizer(FusedSGD(lr=LR, momentum=MOMENTUM,
                                          weight_decay=WD))
        fresh = self.opt.init(self.named)
        bufs = resnet_params_from_jax(buf, {})
        bufs = {n: bufs[n] for n in self.named}   # the flat layout's order
        self.opt_state = SGDState(
            step=torch.tensor(step, dtype=torch.int32),
            momentum_buf=ravel(bufs, build_layout(bufs)))
        assert fresh.momentum_buf.shape == self.opt_state.momentum_buf.shape
        self.scaler = DynamicLossScale(init_scale=2.0 ** 12)
        self.ls = LossScaleState(torch.tensor(scale),
                                 torch.tensor(unskipped, dtype=torch.int32))
        self.labels = torch.from_numpy(labels)

    def step(self, x):
        for p in self.named.values():
            p.grad = None
        loss = F.cross_entropy(self.model(torch.from_numpy(x)), self.labels)
        (loss * self.ls.loss_scale).backward()
        grads = {n: p.grad for n, p in self.named.items()}
        finite = all_finite(grads)
        new_ls = self.scaler.update(self.ls, finite)
        self.opt.step(grads, self.opt_state, self.named, grads_finite=finite,
                      scale=1.0 / self.ls.loss_scale)
        self.ls = new_ls
        return float(loss.detach()), bool(finite)

    def assert_state(self, ref, rel, what):
        params, bn, buf, step, scale, unskipped = ref
        got_p, got_s = resnet_params_to_numpy(self.model.state_dict())
        lay = build_layout(self.named)
        got_buf, _ = resnet_params_to_numpy(
            unravel(self.opt_state.momentum_buf, lay))
        pairs = list(zip(jax.tree_util.tree_leaves_with_path(
            (params, bn, buf)), jax.tree_util.tree_leaves(
            (got_p, got_s, got_buf))))
        assert len(pairs) == 2 * HEADLINE_LEAVES + 3 * 17
        for (path, want), got in pairs:
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(
                np.asarray(got, np.float32), want, rtol=0,
                atol=rel * max(float(np.nanmax(np.abs(want), initial=0.0)),
                               1.0),
                err_msg=f"{what} {jax.tree_util.keystr(path)}")
        assert int(self.opt_state.step) == step, what
        assert float(self.ls.loss_scale) == scale, what
        assert int(self.ls.unskipped) == unskipped, what


def _same_loss(got, want, tol):
    return (np.isnan(got) and np.isnan(want)) or abs(got - want) <= tol


@pytest.mark.parametrize("nan_step", [None, 1])
def test_headline_steps_match_jax_from_each_jax_state(nan_step):
    """Each step from the JAX state before it: the loss, the finite flag,
    and params, BN statistics, momenta, step count and scale after it."""
    xs, labels, states, outs = _jax_headline(nan_step)
    for i, (loss_ref, finite_ref) in enumerate(outs):
        run = _Headline(states[i], labels)
        loss, finite = run.step(xs[i])
        assert _same_loss(loss, loss_ref, 1e-5) and finite == finite_ref, i
        run.assert_state(states[i + 1], 1e-5, f"step {i}")


@pytest.mark.parametrize("nan_step", [None, 1])
def test_headline_trajectory_matches_jax(nan_step):
    """The port's own three steps from the JAX init. A max-pool window
    whose two largest values differ by less than the frameworks' rounding
    can send its gradient to the other one, which moves the stem conv's
    gradient by that pixel's patch: over three steps the stem conv drifts
    to 1.4e-3 of its largest magnitude and its momentum to 2.3e-3 (every
    other leaf ~1e-5; from each JAX state, the steps hold at 1e-5), so the
    final state is held at 5e-3 of each leaf's largest magnitude."""
    xs, labels, states, outs = _jax_headline(nan_step)
    run = _Headline(states[0], labels)
    for i, (loss_ref, finite_ref) in enumerate(outs):
        loss, finite = run.step(xs[i])
        assert _same_loss(loss, loss_ref, 1e-4 if i else 1e-5), i
        assert finite == finite_ref, i
    assert [f for _, f in outs] == [i != nan_step
                                    for i in range(HEADLINE_STEPS)]
    run.assert_state(states[-1], 5e-3, "after the trajectory")


def test_tree_unzip_matches_jax():
    from apex_tpu.optimizers._base import tree_unzip as jax_unzip
    from apex_tpu_torch.optimizers._base import tree_unzip
    from torch.utils._pytree import tree_flatten
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), torch.ones(3)]}
    _, spec = tree_flatten(tree)
    out = {"a": (1, 2, 3), "b": [(4, 5, 6), (7, 8, 9)]}
    jtree = jax.tree_util.tree_map(np.asarray, {"a": np.zeros(2),
                                                "b": [np.ones(1),
                                                      np.ones(3)]})
    ref = jax_unzip(out, jax.tree_util.tree_structure(jtree), 3)
    assert tree_unzip(out, spec, 3) == ref
    _, empty = tree_flatten({})
    assert tree_unzip({}, empty, 2) == ({}, {})
