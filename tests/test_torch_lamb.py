"""Port FusedLAMB and FusedMixedPrecisionLamb vs the JAX package on the
CPU.

- ``FusedLAMB``: 5-step fp32 trajectories from the same seeded params and
  grads, over the global-norm clip on and off, both moment modes,
  ``use_nvlamb``, ``weight_decay`` 0, ``grad_scale`` (a float and a 0-d
  tensor), ``grad_averaging`` and ``bias_correction`` off, with an all-zero
  leaf (the trust ratio's ``lr`` fallback): params and both moments each
  step;
- ``FusedMixedPrecisionLamb`` over bf16 params fed grads scaled by a
  ``grad_scale``: fp32 masters, moments and the regenerated bf16 params;
  its masters equal ``FusedLAMB`` on the fp32 params fed the unscaled
  grads;
- a skipped step (``grads_finite`` false) keeps params and state, the step
  count included; the AMSGrad refusal;
- the bridge: a JAX ``LAMBState`` and ``MixedPrecisionLambState`` become
  the port's bit for bit, and a step from them matches JAX's next step.

Tolerance: the arithmetic is the reference's, but the norms (the clip's
and the trust ratio's) sum in another order and XLA's CPU code may fuse a
multiply and an add: 1e-6 of each leaf's largest magnitude (or 1e-6
below 1); bf16 params at one bf16 ulp (2**-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxMPLamb
from apex_tpu_torch._bridge import optimizer_state_from_jax
from apex_tpu_torch.optimizers import (FusedLAMB, FusedMixedPrecisionLamb,
                                       LAMBState, MixedPrecisionLambState)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2), "d": (4,), "z": (3,)}
STEPS = 5
TOL = 1e-6


def _tree(rng, scale=1.0):
    tree = {k: np.asarray(rng.randn(*s) * scale, np.float32)
            for k, s in SHAPES.items()}
    tree["z"] = np.zeros(SHAPES["z"], np.float32)
    return tree


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _assert_tree(got, ref, rtol=TOL, what=""):
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(
            got[k].detach().float().numpy(), r, rtol=rtol,
            atol=rtol * max(float(np.abs(r).max(initial=0.0)), 1.0),
            err_msg=f"{what} {k}")


LAMB_CASES = {
    "clip": dict(grad_mult=10.0),
    "no_clip": dict(grad_mult=0.01),
    "l2_mode": dict(adam_w_mode=False, grad_mult=10.0),
    "nvlamb": dict(use_nvlamb=True, weight_decay=0.0),
    "no_decay": dict(weight_decay=0.0),
    "grad_scale": dict(grad_scale=8.0, grad_mult=10.0),
    "grad_scale_tensor": dict(grad_scale="tensor", grad_mult=10.0),
    "no_averaging": dict(grad_averaging=False, adam_w_mode=False),
    "no_bias_correction": dict(bias_correction=False, use_nvlamb=True),
    "max_norm_2": dict(max_grad_norm=2.0, grad_mult=3.0),
}


@pytest.mark.parametrize("case", list(LAMB_CASES))
def test_fused_lamb_trajectory_matches_jax(case):
    kw = dict(LAMB_CASES[case])
    mult = kw.pop("grad_mult", 1.0)
    gs = kw.pop("grad_scale", 1.0)
    kw = dict(dict(lr=0.01, weight_decay=0.01), **kw)
    jopt, opt = JaxLAMB(**kw), FusedLAMB(**kw)
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    jp = _j(p0)
    jst = jopt.init(jp)
    tp = _t(p0)
    st = opt.init(tp)
    for i in range(STEPS):
        g = _tree(rng, mult)
        g["z"] = rng.randn(*SHAPES["z"]).astype(np.float32) * mult
        scale = 8.0 if gs == "tensor" else gs
        jp, jst = jopt.step(_j(g), jst, jp, grad_scale=scale)
        out, st2 = opt.step(_t(g), st, tp, grad_scale=(
            torch.tensor(8.0) if gs == "tensor" else gs))
        assert out is tp and st2 is st
        _assert_tree(tp, jp, what=f"{case} params step {i}")
        _assert_tree(st.exp_avg, jst.exp_avg, what=f"{case} m step {i}")
        _assert_tree(st.exp_avg_sq, jst.exp_avg_sq, what=f"{case} v {i}")
        assert int(st.step) == int(jst.step) == i + 1


def test_fused_lamb_zero_param_takes_lr():
    """An all-zero leaf's trust ratio falls back to lr, as JAX's: one
    step moves it by exactly ``lr * update``."""
    rng = np.random.RandomState(1)
    p0 = _tree(rng)
    g = _tree(rng)
    g["z"] = np.full(SHAPES["z"], 0.5, np.float32)
    jopt, opt = JaxLAMB(lr=0.1), FusedLAMB(lr=0.1)
    jp, _ = jopt.step(_j(g), jopt.init(_j(p0)), _j(p0))
    tp = _t(p0)
    opt.step(_t(g), opt.init(tp), tp)
    _assert_tree(tp, jp, what="zero leaf")
    assert float(tp["z"].abs().max()) > 0


def test_mixed_precision_lamb_matches_jax_and_fp32_lamb():
    rng = np.random.RandomState(2)
    p0 = _tree(rng)
    kw = dict(lr=0.01, weight_decay=0.01)
    jopt, opt, ref = JaxMPLamb(**kw), FusedMixedPrecisionLamb(**kw), \
        FusedLAMB(**kw)
    jp = _j(p0, jnp.bfloat16)
    jst = jopt.init(jp)
    tp = _t(p0, torch.bfloat16)
    st = opt.init(tp)
    assert all(st.master_params[k].data_ptr() != tp[k].data_ptr()
               for k in tp)
    # the fp32 LAMB on the masters' starting values, fed unscaled grads
    rp = {k: v.float().clone() for k, v in tp.items()}
    rst = ref.init(rp)
    scale = 1024.0
    for i in range(STEPS):
        g = _tree(rng, 4.0)
        g_scaled = {k: (v * scale).astype(np.float32) for k, v in g.items()}
        jp, jst = jopt.step(_j(g_scaled, jnp.bfloat16), jst, jp,
                            grad_scale=scale)
        opt.step(_t(g_scaled, torch.bfloat16), st, tp,
                 grad_scale=torch.tensor(scale))
        _assert_tree(st.master_params, jst.master_params,
                     what=f"masters step {i}")
        _assert_tree(st.exp_avg, jst.exp_avg, what=f"m step {i}")
        _assert_tree(st.exp_avg_sq, jst.exp_avg_sq, what=f"v step {i}")
        _assert_tree(tp, jp, rtol=2 ** -8, what=f"bf16 params step {i}")
        for k in tp:
            assert tp[k].dtype == torch.bfloat16
            assert torch.equal(tp[k], st.master_params[k].to(torch.bfloat16))
        # fp32 LAMB over the same (bf16-rounded, unscaled) grads
        ref.step({k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
                  .float() for k, v in g_scaled.items()}, rst, rp,
                 grad_scale=scale)
        _assert_tree(st.master_params, {k: v.numpy() for k, v in rp.items()},
                     what=f"masters vs fp32 LAMB step {i}")


def test_skipped_step_keeps_params_and_state():
    rng = np.random.RandomState(3)
    p0 = _tree(rng)
    for opt in (FusedLAMB(lr=0.01), FusedMixedPrecisionLamb(lr=0.01)):
        tp = _t(p0)
        st = opt.init(tp)
        opt.step(_t(_tree(rng)), st, tp)
        before = [t.clone() for t in
                  torch.utils._pytree.tree_leaves((tp, st))]
        g = _t(_tree(rng))
        g["a"][0, 0] = float("inf")
        opt.step(g, st, tp, grads_finite=torch.tensor(False))
        after = torch.utils._pytree.tree_leaves((tp, st))
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(st.step) == 1


def test_amsgrad_raises():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)


def test_bridge_lamb_states_bit_for_bit_and_step_on():
    rng = np.random.RandomState(4)
    p0 = _tree(rng)
    jopt = JaxLAMB(lr=0.02)
    jp = _j(p0)
    jst = jopt.init(jp)
    for _ in range(2):
        jp, jst = jopt.step(_j(_tree(rng)), jst, jp)
    like = {k: None for k in ("z", "a", "d", "c", "b")}   # another order
    st = optimizer_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                  LAMBState, like=like)
    assert list(st.exp_avg) == list(like)
    assert st.step.dtype == torch.int32 and int(st.step) == 2
    for k in SHAPES:
        assert np.array_equal(st.exp_avg[k].numpy(), np.asarray(
            jst.exp_avg[k]))
        assert np.array_equal(st.exp_avg_sq[k].numpy(), np.asarray(
            jst.exp_avg_sq[k]))
    tp = {k: torch.from_numpy(np.array(jp[k])) for k in like}
    g = _tree(rng)
    jp, jst = jopt.step(_j(g), jst, jp)
    FusedLAMB(lr=0.02).step({k: torch.from_numpy(g[k]) for k in like}, st,
                            tp)
    _assert_tree(tp, jp, what="step from the bridged state")

    mp = JaxMPLamb(lr=0.02)
    jb = _j(p0, jnp.bfloat16)
    mst = mp.init(jb)
    _, mst = mp.step(_j(_tree(rng), jnp.bfloat16), mst, jb)
    pst = optimizer_state_from_jax(jax.tree_util.tree_map(np.asarray, mst),
                                   MixedPrecisionLambState)
    for k in SHAPES:
        for field in ("master_params", "exp_avg", "exp_avg_sq"):
            assert np.array_equal(getattr(pst, field)[k].numpy(), np.asarray(
                getattr(mst, field)[k])), (field, k)
