"""Port attention vs the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``
at tile-aligned shapes); the port's CPU path is the plain version of its
CUDA kernels. Inputs come from numpy with a seed.

Tolerances: fp32 1e-5 (the two sides sum in different orders); bf16 0.05
on outputs of magnitude ~1 (a few bf16 ulps: the JAX kernel rounds the
unnormalized probabilities to bf16 before the P V product, the plain
version the normalized ones); lse is fp32 on both sides.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, h, sq, sk, d, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    # the exact same rounded values on both sides
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtype])
          for a in jx]
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.astype(jnp.float32))


CASES = [  # (causal, sq, sk)
    (True, 128, 128), (False, 128, 128), (True, 128, 256),
    (False, 128, 256), (True, 256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_flash_attention_matches_jax_kernel(causal, sq, sk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, 1, 2, sq, sk, 64, dtype)
    ref = jfa.flash_attention(jq, jk, jv, causal=causal, use_pallas=True)
    out = pfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == TDT[dtype] and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype])


@pytest.mark.parametrize("causal,sq,sk", CASES)
def test_flash_fwd_plain_out_and_lse_match_jax_kernel(causal, sq, sk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 2, sq, sk, 64, "float32")
    scale = 0.125
    j_out, j_lse = jfa._fwd_pallas(
        jq.reshape(2, sq, 64), jk.reshape(2, sk, 64), jv.reshape(2, sk, 64),
        None, None, None, 2, scale=scale, causal=causal, block_q=sq,
        block_k=sk, dropout_rate=0.0)
    out, lse = pfa._flash_fwd_plain(tq.reshape(2, sq, 64),
                                    tk.reshape(2, sk, 64),
                                    tv.reshape(2, sk, 64), causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    j_lse = np.asarray(j_lse)[..., 0]
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], atol=1e-5)
    if causal and sq > sk:
        # rows that see no key: exactly 0 out and +inf lse on both sides
        masked = sq - sk
        assert np.all(out.numpy()[:, :masked] == 0)
        assert np.all(lse.numpy()[:, :masked] == np.inf)


def test_mha_reference_kv_length_and_segments_match_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 3, 2, 16, 24, 16, "float32")
    lengths = np.array([0, 5, 24], np.int32)
    ref = jfa.mha_reference(jq, jk, jv, kv_length=jnp.asarray(lengths))
    out = pfa.mha_reference(tq, tk, tv, kv_length=torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert np.all(out.numpy()[0] == 0)  # no valid key: exactly zero
    rng = np.random.RandomState(3)
    q_ids = np.sort(rng.randint(0, 3, (3, 16)), axis=1).astype(np.int32)
    kv_ids = np.sort(rng.randint(0, 3, (3, 24)), axis=1).astype(np.int32)
    ref = jfa.mha_reference(jq, jk, jv, causal=True,
                            segment_ids=(jnp.asarray(q_ids),
                                         jnp.asarray(kv_ids)))
    out = pfa.mha_reference(tq, tk, tv, causal=True,
                            segment_ids=(torch.from_numpy(q_ids),
                                         torch.from_numpy(kv_ids)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bias_runs_on_plain_path_and_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(4, 2, 2, 8, 8, 16, "float32")
    bias = np.random.RandomState(5).randn(2, 1, 1, 8).astype(np.float32)
    ref = jfa.mha_reference(jq, jk, jv, bias=jnp.asarray(bias), causal=True)
    out = pfa.flash_attention(tq, tk, tv, bias=torch.from_numpy(bias),
                              causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_interleaved_segments_need_pairs_for_cross_attention():
    q = torch.zeros(1, 1, 4, 8)
    k = torch.zeros(1, 1, 6, 8)
    with pytest.raises(ValueError, match="segment_ids"):
        pfa.mha_reference(q, k, k, segment_ids=torch.zeros(1, 4))
