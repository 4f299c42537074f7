"""Port amp policies and O1 cast lists vs the JAX package on the CPU.

- ``get_policy``: every preset at bf16 and fp16 half dtypes, lower-case
  names, keyword overrides, a ``Policy`` passed through, and the error
  text of an unknown level;
- ``cast_to_compute``/``cast_to_param``/``cast_to_output``/
  ``cast_floating`` over a tree of fp32, bf16 and int32 tensors and a
  Python scalar, and ``with_policy``, against the JAX casts;
- ``o1_context``: every registered op of the default tables called under
  the context in both packages (the reference's ``jnp``/``jax.lax``/
  ``jax.nn`` name against the port's torch name), the output dtype equal
  and the values within bf16's rounding for the half class (2**-7
  relative: the two frameworks accumulate bf16 products in other orders)
  and 1e-6 relative for the fp32 and promote classes (fp32 math on the same
  rounded inputs); nesting, restoring on exit and on an exception,
  ``disable_casts`` and a user registration.
"""

import types

import jax
import jax.numpy as jnp
import jax.scipy.special
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import apex_tpu.amp as jamp
import apex_tpu_torch.amp as tamp
from apex_tpu_torch.amp import lists as tlists

HALVES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "") if isinstance(
        dtype, torch.dtype) else jnp.dtype(dtype).name


def _fields(pol):
    return (pol.name, _name(pol.param_dtype), _name(pol.compute_dtype),
            _name(pol.output_dtype), pol.keep_norms_fp32, pol.loss_scale,
            pol.uses_master_weights, pol.uses_dynamic_scaling)


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "o2"])
def test_get_policy_presets_match_jax(level, half):
    jdt, tdt = HALVES[half]
    assert _fields(tamp.get_policy(level, half_dtype=tdt)) == _fields(
        jamp.get_policy(level, half_dtype=jdt))


def test_get_policy_overrides_and_errors():
    over = dict(loss_scale=128.0, keep_norms_fp32=False)
    got = tamp.get_policy("O1", **over)
    assert _fields(got) == _fields(jamp.get_policy("O1", **over))
    assert tamp.get_policy(got) is got
    assert tamp.get_policy(got, name="mine").name == "mine"
    got = tamp.get_policy("O3", compute_dtype=torch.float32)
    assert got.compute_dtype == torch.float32 and got.uses_master_weights
    with pytest.raises(ValueError) as port_err:
        tamp.get_policy("O4")
    with pytest.raises(ValueError) as ref_err:
        jamp.get_policy("O4")
    assert str(port_err.value) == str(ref_err.value)
    assert tamp.O2().replace(loss_scale="dynamic").uses_dynamic_scaling


def _mixed_tree():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 4).astype(np.float32)
    h = np.asarray(jnp.asarray(rng.randn(4), jnp.bfloat16), np.float32)
    i = rng.randint(0, 9, 5).astype(np.int32)
    jt = {"w": jnp.asarray(w), "h": jnp.asarray(h, jnp.bfloat16),
          "i": jnp.asarray(i), "s": 0.5}
    tt = {"w": torch.from_numpy(w), "h": torch.from_numpy(h).bfloat16(),
          "i": torch.from_numpy(i), "s": 0.5}
    return jt, tt


def _assert_same_tree(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], float):
            assert got[k] == ref[k]
            continue
        assert _name(got[k].dtype) == _name(ref[k].dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_casts_match_jax(level):
    jpol, tpol = jamp.get_policy(level), tamp.get_policy(level)
    jt, tt = _mixed_tree()
    for fn in ("cast_to_compute", "cast_to_param", "cast_to_output"):
        _assert_same_tree(getattr(tamp, fn)(tt, tpol),
                          getattr(jamp, fn)(jt, jpol))
    _assert_same_tree(tamp.cast_floating(tt, torch.float16),
                      jamp.cast_floating(jt, jnp.float16))
    same = tamp.cast_floating(tt, torch.float32)
    assert same["w"] is tt["w"]       # no copy when the dtype already fits


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_with_policy_matches_jax(level):
    rng = np.random.RandomState(1)
    w = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(2, 4).astype(np.float32)
    ref = jamp.with_policy(lambda p, x: x @ p["w"], jamp.get_policy(level))(
        {"w": jnp.asarray(w)}, jnp.asarray(x))
    got = tamp.with_policy(lambda p, x: x @ p["w"], tamp.get_policy(level))(
        {"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert _name(got.dtype) == _name(ref.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2 ** -7,
                               atol=1e-2)
    raw = tamp.with_policy(lambda p, x: x.dtype, tamp.get_policy(level),
                           cast_inputs=False)({}, torch.from_numpy(x))
    assert raw == torch.float32


# ---------------------------------------------------------------------------
# O1 cast lists
# ---------------------------------------------------------------------------

def _arr(rng, shape, positive=False, small=False):
    x = rng.randn(*shape)
    if positive:
        x = np.abs(x) + 0.5
    if small:
        x = x * 0.3 + 1.0
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


# name: (category, inputs(rng) -> numpy arrays, the JAX call, the torch call)
OPS = {
    "matmul": ("half", lambda r: (_arr(r, (3, 4)), _arr(r, (4, 5))),
               lambda a, b: jnp.matmul(a, b),
               lambda a, b: torch.matmul(a, b)),
    "dot": ("half", lambda r: (_arr(r, (6,)), _arr(r, (6,))),
            lambda a, b: jnp.dot(a, b), lambda a, b: torch.dot(a, b)),
    "vdot": ("half", lambda r: (_arr(r, (6,)), _arr(r, (6,))),
             lambda a, b: jnp.vdot(a, b), lambda a, b: torch.vdot(a, b)),
    "inner": ("half", lambda r: (_arr(r, (3, 4)), _arr(r, (5, 4))),
              lambda a, b: jnp.inner(a, b), lambda a, b: torch.inner(a, b)),
    "tensordot": ("half", lambda r: (_arr(r, (3, 4)), _arr(r, (4, 2))),
                  lambda a, b: jnp.tensordot(a, b, axes=1),
                  lambda a, b: torch.tensordot(a, b, dims=1)),
    "einsum": ("half", lambda r: (_arr(r, (3, 4)), _arr(r, (4, 2))),
               lambda a, b: jnp.einsum("ij,jk->ik", a, b),
               lambda a, b: torch.einsum("ij,jk->ik", a, b)),
    "conv": ("half", lambda r: (_arr(r, (2, 3, 6, 6)), _arr(r, (4, 3, 3, 3))),
             lambda x, w: jax.lax.conv_general_dilated(x, w, (1, 1),
                                                       "VALID"),
             lambda x, w: F.conv2d(x, w)),
    **{name: ("float", lambda r, kw=kw: (_arr(r, (3, 5), **kw),),
              lambda a, name=name: getattr(jnp, name)(a),
              lambda a, name=name: getattr(torch, name)(a))
       for name, kw in (("exp", {}), ("expm1", {}),
                        ("log", {"positive": True}),
                        ("log10", {"positive": True}),
                        ("log1p", {"positive": True}), ("log2",
                                                        {"positive": True}),
                        ("cosh", {}), ("sinh", {}), ("sum", {}),
                        ("prod", {"small": True}))},
    "power": ("float", lambda r: (_arr(r, (3, 5)),),
              lambda a: jnp.power(a, 2.0), lambda a: torch.pow(a, 2.0)),
    "cumsum": ("float", lambda r: (_arr(r, (3, 5)),),
               lambda a: jnp.cumsum(a, axis=1),
               lambda a: torch.cumsum(a, dim=1)),
    "cumprod": ("float", lambda r: (_arr(r, (3, 5), small=True),),
                lambda a: jnp.cumprod(a, axis=1),
                lambda a: torch.cumprod(a, dim=1)),
    "norm": ("float", lambda r: (_arr(r, (3, 5)),),
             lambda a: jnp.linalg.norm(a), lambda a: torch.linalg.norm(a)),
    "softmax": ("float", lambda r: (_arr(r, (3, 5)),),
                lambda a: jax.nn.softmax(a, axis=-1),
                lambda a: F.softmax(a, dim=-1)),
    "log_softmax": ("float", lambda r: (_arr(r, (3, 5)),),
                    lambda a: jax.nn.log_softmax(a, axis=-1),
                    lambda a: F.log_softmax(a, dim=-1)),
    "softplus": ("float", lambda r: (_arr(r, (3, 5)),),
                 lambda a: jax.nn.softplus(a), lambda a: F.softplus(a)),
    "erf": ("float", lambda r: (_arr(r, (3, 5)),),
            lambda a: jax.scipy.special.erf(a), lambda a: torch.erf(a)),
    **{name: ("promote", lambda r: (_arr(r, (3, 5)), _arr(r, (3, 5))),
              lambda a, b, jn=jn: getattr(jnp, jn)(a, b),
              lambda a, b, name=name: getattr(torch, name)(a, b))
       for name, jn in (("add", "add"), ("sub", "subtract"),
                        ("mul", "multiply"), ("true_divide", "true_divide"),
                        ("eq", "equal"))},
    "cat": ("promote", lambda r: (_arr(r, (3, 5)), _arr(r, (2, 5))),
            lambda a, b: jnp.concatenate([a, b]),
            lambda a, b: torch.cat([a, b])),
    "stack": ("promote", lambda r: (_arr(r, (3, 5)), _arr(r, (3, 5))),
              lambda a, b: jnp.stack([a, b]),
              lambda a, b: torch.stack([a, b])),
}


@pytest.mark.parametrize("op", list(OPS))
def test_o1_context_op_matches_jax(op):
    category, make, jax_call, torch_call = OPS[op]
    arrays = make(np.random.RandomState(list(OPS).index(op)))
    # half: fp32 inputs; float: bf16 inputs; promote: bf16 and fp32
    dts = {"half": ("float32",) * 2, "float": ("bfloat16",),
           "promote": ("bfloat16", "float32")}[category]
    jargs = [jnp.asarray(a, dt) for a, dt in zip(arrays, dts)]
    targs = [torch.from_numpy(a.copy()).to(getattr(torch, dt))
             for a, dt in zip(arrays, dts)]
    with jamp.o1_context():
        ref = jax_call(*jargs)
    with tamp.o1_context():
        got = torch_call(*targs)
    want_dtype = {"half": "bfloat16", "float": "float32",
                  "promote": "bool" if op == "eq" else "float32"}[category]
    assert _name(ref.dtype) == want_dtype
    assert _name(got.dtype) == want_dtype
    tol = 2 ** -7 if category == "half" else 1e-6
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1.0))
    # outside the context the op runs un-cast again
    out = torch_call(*targs)
    if category == "float":
        assert out.dtype == torch.bfloat16


def test_o1_context_nests_and_restores():
    orig = (torch.matmul, F.softmax, torch.cat)
    a = torch.randn(2, 3)
    with tamp.o1_context():
        wrapped = torch.matmul
        assert wrapped is not orig[0]
        with tamp.o1_context(torch.float16):
            assert torch.matmul is wrapped      # the outer wrapper stays
            assert torch.matmul(a, a.t()).dtype == torch.bfloat16
            with tamp.disable_casts():
                assert not tamp.casts_are_enabled()
                assert torch.matmul(a, a.t()).dtype == torch.float32
            assert tamp.casts_are_enabled()
        assert torch.matmul is wrapped
    assert (torch.matmul, F.softmax, torch.cat) == orig
    with pytest.raises(RuntimeError, match="boom"):
        with tamp.o1_context():
            raise RuntimeError("boom")
    assert (torch.matmul, F.softmax, torch.cat) == orig
    assert torch.matmul(a, a.t()).dtype == torch.float32


def test_user_registration(monkeypatch):
    # a copy of the registry, and of its built flag: defaults built into
    # the copy here must be built again afterwards
    monkeypatch.setattr(tlists, "_REGISTRY", list(tlists._REGISTRY))
    monkeypatch.setattr(tlists, "_DEFAULTS_BUILT", tlists._DEFAULTS_BUILT)
    mod = types.SimpleNamespace(
        twice=lambda x: x * 2, widen=lambda x: x.sum(),
        join=lambda a, b: torch.cat([a.reshape(-1), b.reshape(-1)]))
    tamp.register_half_function(mod, "twice")
    tamp.register_float_function(mod, "widen")
    tamp.register_promote_function(mod, "join")
    x = torch.ones(3)
    with tamp.o1_context(torch.float16):
        assert mod.twice(x).dtype == torch.float16
        assert mod.widen(x.half()).dtype == torch.float32
        assert mod.join(x.half(), x.bfloat16()).dtype == torch.float32
        assert mod.twice(3.0) == 6.0      # scalars keep their type
    assert mod.twice(x).dtype == torch.float32
