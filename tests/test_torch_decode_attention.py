"""Port decode attention vs the JAX package's decode kernel on the CPU.

The JAX side runs ``decode_attention(use_pallas=True)``, its Pallas kernel
in interpret mode, at T = 128; the port's CPU path is the plain version of
its CUDA kernel. Inputs come from numpy with a seed.

Tolerances: fp32 1e-5 (summation order); bf16 0.05 (both sides compute in
fp32 and round the output to bf16, one ulp at |x| < 4 is <= 0.016); int8
caches dequantize the same int8 values against the same scales, so they
are held to the fp32 tolerance when q is fp32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pcache = importlib.import_module("apex_tpu_torch.serving.cache")

B, H, T, D = 4, 2, 128, 64
LENGTHS = np.array([0, 1, 77, 128], np.int32)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


def _inputs(seed, cache, q_len=None):
    rng = np.random.RandomState(seed)
    qshape = (B, H, D) if q_len is None else (B, H, q_len, D)
    qdt = "bfloat16" if cache == "bfloat16" else "float32"
    jq, tq = _both(rng.randn(*qshape), qdt)
    kf = rng.randn(B, H, T, D).astype(np.float32)
    vf = rng.randn(B, H, T, D).astype(np.float32)
    extra_j, extra_t = {}, {}
    if cache == "int8":
        kq, ks = pcache._quantize(torch.from_numpy(kf))
        vq, vs = pcache._quantize(torch.from_numpy(vf))
        jk, jv = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy())
        tk, tv = kq, vq
        extra_j = {"k_scale": jnp.asarray(ks.numpy()),
                   "v_scale": jnp.asarray(vs.numpy())}
        extra_t = {"k_scale": ks, "v_scale": vs}
    else:
        jk, tk = _both(kf, cache)
        jv, tv = _both(vf, cache)
    return (jq, jk, jv, extra_j), (tq, tk, tv, extra_t), qdt, rng


@pytest.mark.parametrize("with_new", [False, True])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_matches_jax_kernel(cache, with_new):
    (jq, jk, jv, ej), (tq, tk, tv, et), qdt, rng = _inputs(0, cache)
    if with_new:
        jkn, tkn = _both(rng.randn(B, H, D), qdt)
        jvn, tvn = _both(rng.randn(B, H, D), qdt)
        ej = dict(ej, k_new=jkn, v_new=jvn)
        et = dict(et, k_new=tkn, v_new=tvn)
    ref = jfa.decode_attention(jq, jk, jv, jnp.asarray(LENGTHS),
                               use_pallas=True, **ej)
    out = pfa.decode_attention(tq, tk, tv, torch.from_numpy(LENGTHS), **et)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = 5e-2 if qdt == "bfloat16" else 1e-5
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol)
    if not with_new:
        assert np.all(_f32(out)[0] == 0)      # empty prefix: exactly zero
    elif qdt == "float32":
        # empty prefix + current token: softmax over one position
        np.testing.assert_array_equal(_f32(out)[0], _f32(et["v_new"])[0])


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_decode_multi_row_matches_jax_kernel(cache):
    (jq, jk, jv, _), (tq, tk, tv, _), qdt, _ = _inputs(1, cache, q_len=4)
    ref = jfa.decode_attention(jq, jk, jv, jnp.asarray(LENGTHS),
                               use_pallas=True)
    out = pfa.decode_attention(tq, tk, tv, torch.from_numpy(LENGTHS))
    assert out.shape == (B, H, 4, D)
    tol = 5e-2 if qdt == "bfloat16" else 1e-5
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_decode_plain_lse_matches_jax_kernel(cache):
    (jq, jk, jv, ej), (tq, tk, tv, et), _, _ = _inputs(2, cache, q_len=3)
    n = B * H
    lengths_bh = np.repeat(LENGTHS, H)
    jsc = ((ej["k_scale"].reshape(n, T), ej["v_scale"].reshape(n, T))
           if cache == "int8" else (None, None))
    tsc = ((et["k_scale"].reshape(n, T), et["v_scale"].reshape(n, T))
           if cache == "int8" else (None, None))
    j_out, j_lse = jfa._decode_pallas(
        jq.reshape(n, 3, D), jk.reshape(n, T, D), jv.reshape(n, T, D),
        jnp.asarray(lengths_bh), *jsc, scale=D ** -0.5, block_k=T)
    out, lse = pfa._decode_plain(tq.reshape(n, 3, D), tk.reshape(n, T, D),
                                 tv.reshape(n, T, D),
                                 torch.from_numpy(lengths_bh), *tsc)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    j_lse = np.asarray(j_lse)[..., 0]
    empty = lengths_bh == 0
    assert np.all(lse.numpy()[empty] == -np.inf)
    assert np.all(j_lse[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], j_lse[~empty], atol=1e-5)


def test_merge_current_matches_jax():
    rng = np.random.RandomState(3)
    arrs = [rng.randn(B, H, D).astype(np.float32) for _ in range(4)]
    lse = np.array([[-np.inf, 0.5], [1.0, 2.0], [3.0, -1.0], [0.0, 0.0]],
                   np.float32)
    ref = jfa._merge_current(*(jnp.asarray(a) for a in arrs[:1]),
                             jnp.asarray(lse),
                             *(jnp.asarray(a) for a in arrs[1:]), 0.125,
                             jnp.float32)
    out = pfa._merge_current(torch.from_numpy(arrs[0]),
                             torch.from_numpy(lse),
                             *(torch.from_numpy(a) for a in arrs[1:]), 0.125,
                             torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_decode_argument_errors():
    z = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="k_scale"):
        pfa.decode_attention(z[:, :, 0], z.to(torch.int8), z.to(torch.int8),
                             torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="cache shapes"):
        pfa.decode_attention(z[:, :, 0, :32], z, z,
                             torch.zeros(1, dtype=torch.int32))
    # the verify rows' in-flight keys and values must have q's shape
    with pytest.raises(ValueError, match="k_new shape"):
        pfa.decode_attention(z[:, :, :2], z, z,
                             torch.zeros(1, dtype=torch.int32),
                             k_new=z[:, :, :3], v_new=z[:, :, :2])
    with pytest.raises(ValueError, match="k_cast shape"):
        pfa.decode_attention(z[:, :, :2], z, z,
                             torch.zeros(1, dtype=torch.int32),
                             k_new=z[:, :, :2], v_new=z[:, :, :2],
                             k_cast=z[:, :, 0])
