"""Port ``multi_tensor_apply`` and ``_native`` vs the JAX package on the
CPU.

- ``flatten``/``unflatten`` with ``ravel_pytree``'s semantics: one dtype
  (the inverse takes any buffer), mixed dtypes promoted (fp32 + bf16 +
  int32; bf16 + fp16 to fp32) and cast back, the dtype refusal, an empty
  tree;
- ``multi_tensor_scale`` and ``multi_tensor_axpby`` (bf16 and fp32
  leaves, an int leaf passed through, ``out_dtype``) with their finite
  flags, also with an injected ``inf`` and with a finite input whose
  scaled output overflows;
- ``tree_per_tensor_norms`` (L2, and L-inf at ``ord=0``),
  ``tree_global_norm``, ``multi_tensor_l2norm(per_tensor=)``; the
  optimizers' ``tensor_norms`` against fp64 on a long tensor;
  ``multi_tensor_applier``; ``optimizers._base`` takes its
  ``tree_global_norm`` from here;
- the native ``flatten``/``unflatten``/``gather_rows`` bit for bit
  against ``apex_tpu._native``, with the same errors, through the built
  library and through the numpy path.

Tolerance: values bit for bit where both sides round the same fp32
operations (scale, axpby, flatten); norms at 1e-6 relative (sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._native as jnative
from apex_tpu.multi_tensor_apply import flatten as jflatten
from apex_tpu.multi_tensor_apply import multi_tensor_axpby as jaxpby
from apex_tpu.multi_tensor_apply import multi_tensor_l2norm as jl2norm
from apex_tpu.multi_tensor_apply import multi_tensor_scale as jscale
from apex_tpu.multi_tensor_apply import tree_global_norm as jglobal
from apex_tpu.multi_tensor_apply import tree_per_tensor_norms as jnorms
from apex_tpu_torch import _native
from apex_tpu_torch._bridge import _to_numpy, _to_torch
from apex_tpu_torch.multi_tensor_apply import (flatten,
                                               multi_tensor_applier,
                                               multi_tensor_axpby,
                                               multi_tensor_l2norm,
                                               multi_tensor_scale,
                                               tensor_norms,
                                               tree_global_norm,
                                               tree_per_tensor_norms,
                                               unflatten)
from apex_tpu_torch.optimizers import _base

NORM_TOL = 1e-6


def _np_tree(seed=0, dtypes=("float32",) * 3):
    rng = np.random.RandomState(seed)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    out = {}
    for (k, s), dt in zip(shapes.items(), dtypes):
        v = (rng.randn(*s) * 3).astype(np.float32)
        out[k] = v.astype(jnp.dtype(dt)) if dt != "int32" else \
            (v * 10).astype(np.int32)
    return out


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: _to_torch(v) for k, v in tree.items()}


def _bits(t):
    """The raw bytes of a tensor or an array."""
    arr = _to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(arr).view(np.uint8)


@pytest.mark.parametrize("dtypes", [("float32",) * 3,
                                    ("float32", "bfloat16", "int32"),
                                    ("bfloat16", "float16", "bfloat16"),
                                    ("bfloat16",) * 3])
def test_flatten_matches_ravel_pytree(dtypes):
    tree = _np_tree(1, dtypes)
    jflat, junravel = jflatten(_jtree(tree))
    flat, unravel = flatten(_ttree(tree))
    assert str(flat.dtype).split(".")[-1] == str(jflat.dtype)
    assert np.array_equal(_bits(flat), _bits(jflat))
    back, jback = unflatten(flat, unravel), junravel(jflat)
    for k in tree:
        assert back[k].dtype == _to_torch(np.asarray(jback[k])).dtype
        assert np.array_equal(_bits(back[k]), _bits(jback[k])), k
    if len(set(dtypes)) > 1:
        with pytest.raises(TypeError, match="expected dtype"):
            unravel(flat.to(torch.float64))
    else:   # one dtype: the inverse takes a buffer of any dtype
        assert unravel(flat.to(torch.float64))["a"].dtype == torch.float64


def test_flatten_empty_tree():
    flat, unravel = flatten({})
    jflat, _ = jflatten({})
    assert flat.shape == (0,) and flat.dtype == torch.float32
    assert jflat.dtype == jnp.float32 and unravel(flat) == {}


@pytest.mark.parametrize("poison", [None, "inf", "overflow"])
def test_scale_and_axpby_match_jax_with_flags(poison):
    x = _np_tree(2, ("float32", "bfloat16", "float32"))
    y = _np_tree(3, ("float32", "bfloat16", "float32"))
    scale = 0.125
    if poison == "inf":
        x["a"][1, 2] = np.inf
    if poison == "overflow":   # finite in, inf out: the flag is on outputs
        x["b"] = np.full(5, 3e38, np.float32).astype(jnp.bfloat16)
        scale = 4.0
    jout, jflag = jscale(_jtree(x), scale)
    out, flag = multi_tensor_scale(_ttree(x), torch.tensor(scale))
    assert bool(flag) == bool(jflag) == (poison is None)
    for k in x:
        assert out[k].dtype == _ttree(x)[k].dtype
        assert np.array_equal(_bits(out[k]), _bits(jout[k])), k
    jout, jflag = jaxpby(2.0, _jtree(x), -0.5, _jtree(y))
    out, flag = multi_tensor_axpby(2.0, _ttree(x), -0.5, _ttree(y))
    assert bool(flag) == bool(jflag)
    for k in x:
        assert np.array_equal(_bits(out[k]), _bits(jout[k])), k
    jout, _ = jaxpby(2.0, _jtree(x), -0.5, _jtree(y), out_dtype=jnp.float32)
    out, _ = multi_tensor_axpby(2.0, _ttree(x), -0.5, _ttree(y),
                                out_dtype=torch.float32)
    for k in x:
        assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k


def test_scale_passes_int_leaves_through():
    x = _np_tree(4, ("float32", "int32", "bfloat16"))
    out, flag = multi_tensor_scale(_ttree(x), 3.0)
    assert bool(flag)
    assert out["b"].dtype == torch.int32
    assert np.array_equal(out["b"].numpy(), x["b"])


def test_norms_match_jax():
    x = _np_tree(5, ("float32", "bfloat16", "float32"))
    x["c"][0, 1, 1] = -50.0
    for ord_ in (2, 0):
        want = jnorms(_jtree(x), ord=ord_)
        got = tree_per_tensor_norms(_ttree(x), ord=ord_)
        for k in x:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=NORM_TOL)
            assert got[k].dtype == torch.float32 and got[k].shape == ()
    np.testing.assert_allclose(float(tree_global_norm(_ttree(x))),
                               float(jglobal(_jtree(x))), rtol=NORM_TOL)
    g, per = multi_tensor_l2norm(_ttree(x), per_tensor=True)
    jg, jper = jl2norm(_jtree(x), per_tensor=True)
    np.testing.assert_allclose(float(g), float(jg), rtol=NORM_TOL)
    for k in x:
        np.testing.assert_allclose(float(per[k]), float(jper[k]),
                                   rtol=NORM_TOL)
    assert float(multi_tensor_l2norm({})) == float(jl2norm({})) == 0.0
    assert _base.tree_global_norm is tree_global_norm


def test_tensor_norms_stay_accurate_on_long_tensors():
    """The optimizers' per-tensor norms against fp64 at 3 M elements, where
    the CPU's ``linalg.vector_norm`` is ~4e-5 off; L-inf exactly."""
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(3_000_000, generator=gen) * 1e-3,
          torch.randn(17, 5, generator=gen)]
    got = tensor_norms(xs)
    for g, x in zip(got, xs):
        assert abs(float(g) / float(x.double().norm()) - 1) <= NORM_TOL
    inf = tensor_norms(xs, ord=0)
    assert [float(v) for v in inf] == [float(x.abs().max()) for x in xs]


def test_applier_calls_the_op():
    got = multi_tensor_applier(lambda xs, ys, a: [x * a + y for x, y in
                                                   zip(xs, ys)],
                               torch.zeros(1), [[torch.ones(2)],
                                                [torch.ones(2)]], 3.0)
    assert torch.equal(got[0], torch.full((2,), 4.0))
    assert multi_tensor_applier.available


def _arrays():
    rng = np.random.RandomState(6)
    return [rng.randn(3, 4).astype(np.float32),
            rng.randint(0, 100, (7,)).astype(np.int16),
            rng.randn(2, 2, 3).astype(np.float64),
            np.zeros((0,), np.float32)]


@pytest.fixture(params=["library", "numpy"])
def native(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(_native, "_LIB", None)
        monkeypatch.setattr(_native, "_TRIED", True)
        assert not _native.native_available()
    else:
        assert _native.native_available()   # g++ builds it here
    return _native


def test_native_matches_reference_bit_for_bit(native):
    arrays = _arrays()
    flat = native.flatten(arrays)
    want = jnative.flatten(arrays)
    assert flat.dtype == np.uint8 and np.array_equal(flat, want)
    back = native.unflatten(flat, arrays)
    for a, b, c in zip(back, jnative.unflatten(want, arrays), arrays):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    src = np.arange(60, dtype=np.float32).reshape(10, 2, 3)
    idx = [9, 0, 3, 3]
    assert np.array_equal(native.gather_rows(src, idx),
                          jnative.gather_rows(src, idx))
    assert native.gather_rows(src, []).shape == (0, 2, 3)
    # non-contiguous inputs are made contiguous first
    assert np.array_equal(native.flatten([src[:, 0]]),
                          jnative.flatten([src[:, 0]]))


def test_native_errors_match_reference(native):
    arrays = _arrays()
    short = native.flatten(arrays)[:-1]
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="too small"):
            mod.unflatten(short, arrays)
        with pytest.raises(ValueError, match="1-D"):
            mod.gather_rows(np.zeros((3, 2)), [[0]])
        with pytest.raises(IndexError, match="out of range"):
            mod.gather_rows(np.zeros((3, 2)), [3])
        with pytest.raises(IndexError, match="out of range"):
            mod.gather_rows(np.zeros((3, 2)), [-1])


def test_native_builds_into_the_build_directory():
    assert _native.native_available()
    path = _native._library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "apex_tpu_torch"
    assert not (path.parent.parent / "_native" / "_flatten.so").exists()
