"""Every head dim the reference's decode kernels take, on the CPU.

The reference's paged decode kernel takes any ``d % 8 == 0``
(``supports_paged``), and so does its dense decode route
(``supports_flash``, ``sq == 1``). The port's two decode kernels take
every multiple of 8 from 8 to 256 (``_kernels.decode_dim_ok``;
``csrc/decode.cuh`` splits a row over lanes of 8 elements, 4 in fp32 up to
d 128, and masks the lanes past ``d``). A CUDA kernel cannot run here, so
the port's two decode functions run their plain versions, held against the
JAX package's Pallas ``_decode_pallas`` and ``_paged_decode_pallas`` in
interpret mode on the same numpy inputs at d 8, 16, 24, 40, 96 and 256
(lane groups of 1, 2, 4, 8 and 16 lanes with idle ones, and the widest),
fp32 and int8 caches, ``q_len`` 1 and 3, one slot empty.

Tolerances: fp32 1e-5 absolute on out and lse (sums of up to 256 products
and 128 positions in another order); the empty slot gives out 0 and lse
-inf exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pcache = importlib.import_module("apex_tpu_torch.serving.cache")

B, H, T, BS = 2, 2, 128, 16
LENGTHS = np.array([0, 77], np.int32)
TOL = 1e-5
DIMS = (8, 16, 24, 40, 96, 256)


def _cache(rng, shape, cache):
    """fp32 values and the port's/JAX's copies: ``(torch (x, scale),
    jax (x, scale))``, scales None for fp32."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if cache == "int8":
        xq, sc = pcache._quantize(x)
        return (xq, sc), (jnp.asarray(xq.numpy()), jnp.asarray(sc.numpy()))
    return (x, None), (jnp.asarray(x.numpy()), None)


def _check(out, lse, j_out, j_lse):
    empty = np.repeat(LENGTHS == 0, H)
    np.testing.assert_allclose(out, j_out, atol=TOL)
    assert np.all(out[empty] == 0) and np.all(j_out[empty] == 0)
    assert np.all(lse[empty] == -np.inf) and np.all(j_lse[empty] == -np.inf)
    np.testing.assert_allclose(lse[~empty], j_lse[~empty], atol=TOL)


def test_decode_dim_ok():
    """Every multiple of 8 from 8 to 256 is taken; nothing else."""
    assert all(_kernels.decode_dim_ok(d) for d in range(8, 257, 8))
    assert not any(_kernels.decode_dim_ok(d) for d in (0, 4, 12, 264, -8))
    assert [d for d in range(0, 300) if _kernels.decode_dim_ok(d)] == list(
        range(8, 257, 8))


@pytest.mark.parametrize("q_len", [1, 3])
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_dense_decode_dims_match_jax_kernel(d, cache, q_len):
    rng = np.random.RandomState(d + q_len)
    q = rng.randn(B, H, q_len, d).astype(np.float32)
    (k, ks), (jk, jks) = _cache(rng, (B, H, T, d), cache)
    (v, vs), (jv, jvs) = _cache(rng, (B, H, T, d), cache)
    lengths = torch.from_numpy(LENGTHS)
    out = pfa.decode_attention(torch.from_numpy(q), k, v, lengths,
                               k_scale=ks, v_scale=vs)
    n = B * H
    p_out, p_lse = pfa._decode_plain(
        torch.from_numpy(q).reshape(n, q_len, d), k.reshape(n, T, d),
        v.reshape(n, T, d), lengths.repeat_interleave(H),
        None if ks is None else ks.reshape(n, T),
        None if vs is None else vs.reshape(n, T))
    assert torch.equal(out.reshape(n, q_len, d), p_out)
    rs = (lambda x: None if x is None else x.reshape(n, T))
    j_out, j_lse = jfa._decode_pallas(
        jnp.asarray(q.reshape(n, q_len, d)), jk.reshape(n, T, d),
        jv.reshape(n, T, d), jnp.asarray(np.repeat(LENGTHS, H)), rs(jks),
        rs(jvs), scale=d ** -0.5, block_k=T)
    _check(p_out.numpy(), p_lse.numpy(), np.asarray(j_out),
           np.asarray(j_lse)[..., 0])


@pytest.mark.parametrize("q_len", [1, 3])
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_paged_decode_dims_match_jax_kernel(d, cache, q_len):
    rng = np.random.RandomState(100 + d + q_len)
    n_table = T // BS
    nb = B * n_table + 1
    q = rng.randn(B, H, q_len, d).astype(np.float32)
    (kp, ks), (jk, jks) = _cache(rng, (nb, H, BS, d), cache)
    (vp, vs), (jv, jvs) = _cache(rng, (nb, H, BS, d), cache)
    tables = (rng.permutation(nb - 1)[: B * n_table] + 1).reshape(
        B, n_table).astype(np.int32)
    tt, lengths = torch.from_numpy(tables), torch.from_numpy(LENGTHS)
    out = pfa.paged_decode_attention(torch.from_numpy(q), kp, vp, tt,
                                     lengths, k_scale=ks, v_scale=vs)
    p_out, p_lse = pfa._paged_decode_plain(
        torch.from_numpy(q).reshape(B * H, q_len, d), kp, vp, tt, lengths,
        ks, vs)
    assert torch.equal(out.reshape(B * H, q_len, d), p_out)
    j_out, j_lse = jfa._paged_decode_pallas(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(LENGTHS),
        jks, jvs, scale=d ** -0.5, mean_context=None)
    _check(p_out.numpy(), p_lse.numpy(),
           np.asarray(j_out).reshape(B * H, q_len, d),
           np.asarray(j_lse).reshape(B * H, q_len))
