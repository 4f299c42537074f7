"""Port KV cache vs the JAX package's ``KVCache``: prompt writes, appends
with frozen cursors and saturation, and int8 quantization. Writes are
stores of identically rounded values, so the two caches must agree
exactly, bf16 and int8 included."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving.cache import KVCache as JaxKVCache
from apex_tpu.serving.cache import cache_bytes_per_slot as jax_bytes
from apex_tpu.serving.cache import store_roundtrip as jax_roundtrip
from apex_tpu_torch.serving import KVCache, cache_bytes_per_slot
from apex_tpu_torch.serving import store_roundtrip

pcache = importlib.import_module("apex_tpu_torch.serving.cache")
jcache = importlib.import_module("apex_tpu.serving.cache")

L, S, H, T, D = 2, 3, 2, 4, 8
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def _assert_same(jc, pc):
    for name in ("k", "v", "lengths") + (("k_scale", "v_scale")
                                         if pc.quantized else ()):
        a = np.asarray(getattr(jc, name).astype(jnp.float32)
                       if name in ("k", "v") else getattr(jc, name))
        b = getattr(pc, name)
        b = (b.float() if name in ("k", "v") else b).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_writes_match_jax_with_saturation_and_frozen_cursors(dtype):
    rng = np.random.RandomState(0)
    jc = JaxKVCache.create(L, S, H, T, D, dtype=JDT[dtype])
    pc = KVCache.create(L, S, H, T, D, dtype=TDT[dtype], device="cpu")
    _assert_same(jc, pc)
    # slot 0 fills the whole window (saturated); slot 1 holds 2 of 3
    for slot, P, true_len in ((0, T, T), (1, 3, 2)):
        k = rng.randn(L, H, P, D).astype(np.float32)
        v = rng.randn(L, H, P, D).astype(np.float32)
        jc = jc.write_prompt(jnp.asarray(k), jnp.asarray(v), slot, true_len)
        pc.write_prompt(torch.from_numpy(k), torch.from_numpy(v), slot,
                        true_len)
        _assert_same(jc, pc)
    # slot 2 stays inactive: its cursor is frozen at 0 and its garbage
    # lands at position 0 each step; slot 1 runs into saturation
    active = np.array([True, True, False])
    for step in range(4):
        kn = rng.randn(L, S, H, D).astype(np.float32)
        vn = rng.randn(L, S, H, D).astype(np.float32)
        act = None if step == 3 else active
        jc = jc.append(jnp.asarray(kn), jnp.asarray(vn),
                       None if act is None else jnp.asarray(act))
        pc.append(torch.from_numpy(kn), torch.from_numpy(vn),
                  None if act is None else torch.from_numpy(act))
        _assert_same(jc, pc)
    assert pc.lengths.tolist() == [T, T, 1]


def test_quantize_and_roundtrip_match_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(5, 3, 16) * rng.choice([1e-3, 1.0, 50.0], (5, 3, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                          # all-zero row: the scale floor
    x[1, 0, :2] = [127.0 * 0.5, -127.0]    # exact half: round half to even
    jq, js = jcache._quantize(jnp.asarray(x))
    tq, ts = pcache._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    for quantized, jdt, tdt in ((True, jnp.int8, torch.int8),
                                (False, jnp.bfloat16, torch.bfloat16)):
        a = jax_roundtrip(jnp.asarray(x), jdt, quantized)
        b = store_roundtrip(torch.from_numpy(x), tdt, quantized)
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_bytes_per_slot_match_jax(dtype):
    assert cache_bytes_per_slot(12, 12, 1024, 64, TDT[dtype]) == \
        jax_bytes(12, 12, 1024, 64, JDT[dtype])


def test_writes_are_in_place():
    pc = KVCache.create(L, S, H, T, D, dtype=torch.bfloat16, device="cpu")
    ptrs = [t.data_ptr() for t in (pc.k, pc.v, pc.lengths)]
    pc.write_prompt(torch.ones(L, H, 2, D), torch.ones(L, H, 2, D), 1, 2)
    pc.append(torch.ones(L, S, H, D), torch.ones(L, S, H, D))
    assert [t.data_ptr() for t in (pc.k, pc.v, pc.lengths)] == ptrs
    assert pc.lengths.tolist() == [1, 3, 1]
