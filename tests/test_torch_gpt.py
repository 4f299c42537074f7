"""Port GPT vs the JAX package's GPT on the CPU, on the same weights (the
JAX ``GPTModel.init`` pytree through the bridge): the dense forward, the
KV-cached prefill (logits and cache) and 8 teacher-forced decode steps.

Tiny config: 2 layers, hidden 64, 4 heads, vocab 97, 128 positions. The
JAX side runs jitted, with its Pallas kernels in interpret mode (the
sequence is 128); the port runs its plain CPU path. Tolerances: fp32
compute 1e-4 on logits and 1e-5 on cached K/V (reduction order only);
bf16 compute 0.05 (bf16 rounds at other places in the two frameworks;
cf. the 0.05 bf16 tolerance of the JAX package's own parity tests).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.serving import KVCache as JaxKVCache
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import KVCache

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=128)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2, 5e-2)}
S, T = 3, 128


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jdt, tdt, _, _ = DTYPES[dtype]
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jdt, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = GPTConfig(compute_dtype=tdt, **SIZES)
    pm = GPTModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return jm, jp, pm


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, SIZES["vocab_size"], shape)


def _prefill(jm, jp, pm, jc, pc, slot, n, seed):
    prompt = np.zeros((1, T), np.int64)
    prompt[0, :n] = _tokens(seed, n)
    jl, jc = jax.jit(functools.partial(jm.forward, slot=slot, prompt_len=n),
                     )(jp, jnp.asarray(prompt), kv_cache=jc)
    with torch.no_grad():
        pl, _ = pm.forward(torch.from_numpy(prompt), kv_cache=pc, slot=slot,
                           prompt_len=n)
    return jl, pl, jc


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_forward_logits_match_jax(dtype):
    jm, jp, pm = _models(dtype)
    tok = _tokens(0, (2, T))
    ref = jax.jit(jm.__call__)(jp, jnp.asarray(tok))
    with torch.no_grad():
        out = pm(torch.from_numpy(tok))
    assert out.dtype == torch.float32 and out.shape == (2, T, 97)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_logits_and_cache_match_jax(dtype):
    jm, jp, pm = _models(dtype)
    jdt, tdt, tol, ctol = DTYPES[dtype]
    jc = JaxKVCache.create(2, S, 4, T, 16, dtype=jdt)
    pc = KVCache.create(2, S, 4, T, 16, dtype=tdt, device="cpu")
    jl, pl, jc = _prefill(jm, jp, pm, jc, pc, slot=1, n=50, seed=1)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=tol)
    np.testing.assert_allclose(_f32(pc.k), _f32(jc.k), atol=ctol)
    np.testing.assert_allclose(_f32(pc.v), _f32(jc.v), atol=ctol)
    assert pc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [0, 50,
                                                                       0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_steps_match_jax(dtype):
    """Two slots prefilled, one idle; 8 decode steps fed the same
    (teacher-forced) tokens on both sides."""
    jm, jp, pm = _models(dtype)
    jdt, tdt, tol, _ = DTYPES[dtype]
    jc = JaxKVCache.create(2, S, 4, T, 16, dtype=jdt)
    pc = KVCache.create(2, S, 4, T, 16, dtype=tdt, device="cpu")
    _, _, jc = _prefill(jm, jp, pm, jc, pc, slot=0, n=30, seed=2)
    _, _, jc = _prefill(jm, jp, pm, jc, pc, slot=2, n=7, seed=3)
    active = np.array([True, False, True])
    step = jax.jit(lambda p, t, c, a: jm.forward(p, t, kv_cache=c,
                                                 active=a))
    for i in range(8):
        tok = _tokens(10 + i, (S, 1))
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(active))
        with torch.no_grad():
            pl, _ = pm.forward(torch.from_numpy(tok), kv_cache=pc,
                               active=torch.from_numpy(active))
        assert pl.shape == (S, 97)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=tol,
                                   err_msg=f"decode step {i}")
    assert pc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [38, 0,
                                                                       15]


def test_last_logit_only_is_the_prompt_row():
    _, _, pm = _models("float32")
    prompt = torch.from_numpy(_tokens(4, (1, 16)))
    pc = KVCache.create(2, 1, 4, 32, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        full, _ = pm.forward(prompt, kv_cache=pc, slot=0, prompt_len=9)
        last, _ = pm.forward(prompt, kv_cache=pc, slot=0, prompt_len=9,
                             last_logit_only=True)
    assert last.shape == (1, 1, 97)
    torch.testing.assert_close(last[0, 0], full[0, 8], atol=1e-5, rtol=0)


def test_prefill_argument_errors():
    _, _, pm = _models("float32")
    pc = KVCache.create(2, 1, 4, 8, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="per-request"):
        pm.forward(torch.zeros(2, 4, dtype=torch.long), kv_cache=pc, slot=0)
    with pytest.raises(ValueError, match="exceeds cache max_len"):
        pm.forward(torch.zeros(1, 9, dtype=torch.long), kv_cache=pc, slot=0)
    with pytest.raises(ValueError, match="outside the written window"):
        pm.forward(torch.zeros(1, 4, dtype=torch.long), kv_cache=pc, slot=0,
                   prompt_len=5)
    with pytest.raises(ValueError, match="decode tokens"):
        pm.forward(torch.zeros(1, 2, dtype=torch.long), kv_cache=pc)
