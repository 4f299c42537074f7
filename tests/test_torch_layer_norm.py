"""Port LayerNorm/RMSNorm vs the JAX package on the CPU.

- the plain twins of the CUDA kernels (``_ln_fwd_plain``, ``_ln_bwd_plain``)
  against the JAX Pallas kernels ``_pallas.ln_fwd``/``ln_bwd`` called
  directly (interpret mode): LayerNorm and RMSNorm, with and without weight
  and bias, fp32, bf16 and mixed dtypes, 64 rows of 128 and 768;
- every public function and module against its JAX twin with
  ``use_pallas=True``, forward and ``jax.grad``;
- the ``use_kernel`` contract and the card default.

Inputs come from numpy with a seed; both sides see the same rounded
values. Tolerances: fp32 outputs 1e-6 absolute at unit scale, that is
1e-6 of the output's largest magnitude when it is above 1 (affine outputs
reach ~13 here, where one fp32 ulp is 9.5e-7; the two sides sum the
statistics in different orders, and the plain twins read at most 2.5e-7
of the largest magnitude); fp32 grads 1e-5 of the leaf's largest
magnitude; bf16 results one bf16 ulp of the reference value (both sides
round one fp32 result once, which can fall on the two sides of a rounding
point) on top of the fp32 tolerance (an element that cancels to near 0,
as dx can, keeps the fp32 sums' absolute error: 1.2e-7 was read on a dx
of ~1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

# the modules (the packages export a function of the same name)
jln = importlib.import_module("apex_tpu.normalization.fused_layer_norm")
jpl = importlib.import_module("apex_tpu.normalization._pallas")
pln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")

ROWS = 64
EPS = 1e-5
# (x dtype, weight dtype, output taken from "x" or "w")
DTYPES = {"fp32": ("float32", "float32", "x"),
          "bf16": ("bfloat16", "bfloat16", "x"),
          "mixed": ("bfloat16", "float32", "w")}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr, dtype):
    """The same rounded values as a JAX array and a torch tensor."""
    j = jnp.asarray(arr, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, ref, dtype: str, grad: bool = False, what=""):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    atol = 1e-5 * max(scale, 1e-30) if grad else 1e-6 * max(scale, 1.0)
    if dtype == "bfloat16":
        mag = np.maximum(np.abs(ref), 1e-30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        bad = np.abs(got - ref) > ulp + atol
        assert not bad.any(), (f"{what}: {int(bad.sum())} elements beyond "
                               f"one bf16 ulp, max diff "
                               f"{np.abs(got - ref).max()}")
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                   err_msg=what)


def _inputs(seed, h, x_dt, w_dt):
    rng = np.random.RandomState(seed)
    x = rng.randn(ROWS, h) * 2 + 0.5
    w = rng.randn(h)
    b = rng.randn(h)
    dy = rng.randn(ROWS, h)
    return _pair(x, x_dt), _pair(w, w_dt), _pair(b, w_dt), dy


AFFINE = ["weight_bias", "weight", "none"]
TWIN_CASES = [(rms, affine, dt, h)
              for rms in (False, True) for affine in AFFINE
              for dt in DTYPES for h in (128, 768)
              if not (affine == "none" and dt == "mixed")]


@pytest.mark.parametrize("rms,affine,dtype,h", TWIN_CASES)
def test_plain_twins_match_pallas_kernels(rms, affine, dtype, h):
    x_dt, w_dt, out_from = DTYPES[dtype]
    (jx, tx), (jw, tw), (jb, tb), dy = _inputs(h + rms, h, x_dt, w_dt)
    has_w, has_b = affine != "none", affine == "weight_bias"
    jw, tw = (jw, tw) if has_w else (None, None)
    jb, tb = (jb, tb) if has_b else (None, None)
    out_dt = w_dt if out_from == "w" else x_dt

    j_out, j_mean, j_inv = jpl.ln_fwd(jx, jw, jb, eps=EPS, rms=rms,
                                      out_dtype=JDT[out_dt])
    out, mean, inv = pln._ln_fwd_plain(tx, tw, tb, EPS, rms, TDT[out_dt])
    assert out.dtype == TDT[out_dt]
    assert mean.shape == inv.shape == (ROWS, 1)
    assert mean.dtype == inv.dtype == torch.float32
    _assert_close(out, j_out, out_dt, what="out")
    _assert_close(mean, j_mean, "float32", what="mean")
    np.testing.assert_allclose(_f32(inv), _f32(j_inv), rtol=1e-6)

    # the backward on identical inputs: the JAX forward's statistics
    jdy, tdy = _pair(dy, out_dt)
    j_mean_t, j_inv_t = (torch.from_numpy(np.array(a)) for a in
                         (j_mean, j_inv))
    j_dx, j_dw, j_db = jpl.ln_bwd(
        jdy, jx, j_mean, j_inv, jw, rms=rms, has_bias=has_b,
        x_dtype=JDT[x_dt], w_dtype=JDT[w_dt] if has_w else None)
    dx, dw, db = pln._ln_bwd_plain(tdy, tx, j_mean_t, j_inv_t, tw, rms,
                                   has_b)
    assert dx.dtype == TDT[x_dt]
    _assert_close(dx, j_dx, x_dt, grad=True, what="dx")
    if has_w:
        assert dw.dtype == TDT[w_dt]
        _assert_close(dw, j_dw, w_dt, grad=True, what="dweight")
    else:
        assert dw is None and j_dw is None
    if has_b:
        _assert_close(db, j_db, w_dt, grad=True, what="dbias")
    else:
        assert db is None and j_db is None


# (name, has weight, has bias, rms, mixed)
FUNCTIONS = [("fused_layer_norm_affine", True, True),
             ("fused_layer_norm", False, False),
             ("fused_rms_norm_affine", True, False),
             ("fused_rms_norm", False, False),
             ("mixed_dtype_fused_layer_norm_affine", True, True),
             ("mixed_dtype_fused_rms_norm_affine", True, False)]


def _fn_dtypes(name):
    return ["mixed", "fp32"] if name.startswith("mixed") else ["fp32",
                                                              "bf16"]


FN_CASES = [(f, dt) for f in FUNCTIONS for dt in _fn_dtypes(f[0])]


def _grads_both(jfn, tfn, leaves, dy, out_dt):
    """Forward and grads of ``sum(out * dy)`` on both sides."""
    jleaves = [j for j, _ in leaves]
    tleaves = [t.clone().requires_grad_() for _, t in leaves]

    def jloss(*args):
        out = jfn(*args)
        return jnp.sum(out.astype(jnp.float32) * dy), out

    (_, j_out), j_grads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(jleaves))), has_aux=True)(*jleaves)
    out = tfn(*tleaves)
    (out.float() * torch.from_numpy(dy).float()).sum().backward()
    assert out.dtype == TDT[out_dt]
    return out, j_out, [t.grad for t in tleaves], j_grads


@pytest.mark.parametrize("fn,dtype", FN_CASES,
                         ids=[f"{f[0]}-{d}" for f, d in FN_CASES])
def test_functions_match_jax(fn, dtype):
    name, has_w, has_b = fn
    x_dt, w_dt, out_from = DTYPES[dtype]
    if name.startswith("mixed"):
        out_from = "w"
    (jx, tx), (jw, tw), (jb, tb), dy = _inputs(7, 768, x_dt, w_dt)
    jfun, tfun = getattr(jln, name), getattr(pln, name)
    leaves = [(jx, tx)] + ([(jw, tw)] if has_w else []) + \
        ([(jb, tb)] if has_b else [])

    def jfn(*args):
        return jfun(*args, 768, eps=EPS, use_pallas=True)

    def tfn(*args):
        return tfun(*args, 768, eps=EPS)

    out_dt = w_dt if out_from == "w" else x_dt
    out, j_out, grads, j_grads = _grads_both(jfn, tfn, leaves, dy, out_dt)
    _assert_close(out, j_out, out_dt, what=f"{name} out")
    for (what, g), jg in zip(zip(("dx", "dweight", "dbias"), grads),
                             j_grads):
        leaf_dt = x_dt if what == "dx" else w_dt
        assert g.dtype == TDT[leaf_dt]
        _assert_close(g, jg, leaf_dt, grad=True, what=f"{name} {what}")


MODULES = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


@pytest.mark.parametrize("cls", MODULES)
@pytest.mark.parametrize("affine", [True, False])
def test_modules_match_jax(cls, affine):
    mixed = cls.startswith("Mixed")
    x_dt, w_dt, _ = DTYPES["mixed" if mixed else "fp32"]
    shape = (4, 32)
    rng = np.random.RandomState(11)
    jx, tx = _pair(rng.randn(16, *shape) * 3 - 1, x_dt)
    dy = rng.randn(16, *shape)
    jm = getattr(jln, cls)(shape, eps=1e-6, elementwise_affine=affine,
                           param_dtype=JDT[w_dt])
    tm = getattr(pln, cls)(shape, eps=1e-6, elementwise_affine=affine,
                           param_dtype=TDT[w_dt], device="cpu")
    params = jm.init()
    assert sorted(params) == sorted(n for n, _ in tm.named_parameters())
    for name in params:    # random parameters on both sides
        j, t = _pair(rng.randn(*shape), w_dt)
        params[name] = j
        with torch.no_grad():
            getattr(tm, name).copy_(t)
    names = sorted(params)

    def jloss(x, ps):
        out = jm(ps, x, use_pallas=True)
        return jnp.sum(out.astype(jnp.float32) * dy), out

    (_, j_out), (j_dx, j_dps) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jx, params)
    x = tx.clone().requires_grad_()
    out = tm(x)
    (out.float() * torch.from_numpy(dy).float()).sum().backward()
    out_dt = w_dt if (mixed and affine) else x_dt
    assert out.dtype == TDT[out_dt] and out.shape == tx.shape
    _assert_close(out, j_out, out_dt, what=f"{cls} out")
    _assert_close(x.grad, j_dx, x_dt, grad=True, what=f"{cls} dx")
    for n in names:
        _assert_close(getattr(tm, n).grad, j_dps[n], w_dt, grad=True,
                      what=f"{cls} d{n}")


def test_use_kernel_true_on_cpu_raises():
    x = torch.zeros(4, 16)
    w = torch.ones(16)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        pln.fused_layer_norm_affine(x, w, w, 16, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        pln.fused_rms_norm(x, 16, use_kernel=True)
    m = pln.FusedLayerNorm(16, device="cpu", use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        m(x)
    # use_kernel=False and None both run the plain twins on the CPU
    a = pln.fused_layer_norm_affine(x + 1, w, w, 16, use_kernel=False)
    assert torch.equal(a, pln.fused_layer_norm_affine(x + 1, w, w, 16))


def test_kernel_wrappers_refuse_cpu_tensors():
    before = dict(_kernels.LAUNCHES)
    x = torch.zeros(4, 16)
    stats = torch.zeros(4, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.ln_fwd(x, None, None, 1e-5, False, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.ln_bwd(x, x, stats, stats, None, False, False)
    assert _kernels.LAUNCHES == before


def test_norm_modules_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for cls in MODULES:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            getattr(pln, cls)(8)
        m = getattr(pln, cls)(8, device="cpu")
        assert all(p.device.type == "cpu" for p in m.parameters())


def test_normalized_shape_must_match_the_input_tail():
    with pytest.raises(ValueError, match="normalized_shape"):
        pln.fused_layer_norm(torch.zeros(2, 3, 8), (4, 8))
