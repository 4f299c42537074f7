"""Port serving vs the JAX package's serving on the CPU, same weights.

``ServingEngine`` greedy token streams and ``SlotScheduler.run``
completions must EQUAL the JAX engine's at fp32 compute (tiny GPT:
2 layers, hidden 64, 4 heads, vocab 97; prefill window and max_len 128,
so the JAX engine runs its Pallas kernels in interpret mode). Greedy is
an exact argmax over logits that agree to ~1e-6, so any difference would
be a real one. Sampling and the metric family are checked on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.observability.registry import MetricsRegistry as JaxRegistry
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import ServingEngine as JaxEngine
from apex_tpu.serving import SlotScheduler as JaxScheduler
from apex_tpu.serving.sampling import _mask_top_k as jax_mask_top_k
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import (Request, ServingEngine, SlotScheduler,
                                    sample_tokens)

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(max_seqs=3, max_len=128, prefill_len=128)


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jax.tree_util.tree_map(np.asarray, jp)


def _port_engine():
    cfg = GPTConfig(compute_dtype=torch.float32, **SIZES)
    return ServingEngine(GPTModel(cfg, device="cpu"),
                         params_from_jax(_weights()[2], cfg),
                         cache_dtype=torch.float32, device="cpu", **ENGINE)


def _engines():
    jm, jp, _ = _weights()
    return (JaxEngine(jm, jp, cache_dtype=jnp.float32, **ENGINE),
            _port_engine())


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 97, n).tolist()


def test_engine_greedy_streams_equal_jax():
    je, pe = _engines()
    prompts = [_prompt(1, 5), _prompt(2, 128), _prompt(3, 40)]
    tokens = np.zeros(3, np.int64)
    for slot, p in enumerate(prompts):
        a, b = je.prefill(p, slot), pe.prefill(p, slot)
        assert a == b, f"slot {slot} first token"
        tokens[slot] = a
    temps = np.zeros(3, np.float32)
    active = np.array([True, False, True])   # slot 1 sits at capacity
    for step in range(10):
        a = je.decode(tokens, temps, active)
        b = pe.decode(tokens, temps, active)
        np.testing.assert_array_equal(a[active], b[active],
                                      err_msg=f"decode step {step}")
        tokens = b.astype(np.int64)
    assert pe.cache.lengths.tolist() == np.asarray(
        je.cache.lengths).tolist() == [15, 128, 50]
    pe.release_slot(0)
    assert pe.cache.lengths.tolist()[0] == 0


def test_scheduler_completions_equal_jax():
    je, pe = _engines()
    specs = [(_prompt(10, 3), 5), (_prompt(11, 60), 8),
             (_prompt(12, 128), 3),            # retires at capacity
             (_prompt(13, 1), 12), (_prompt(14, 20), 6)]
    # an eos token this stream really emits: request 3's third token
    probe = _port_engine()
    only = np.array([True, False, False])
    tok = probe.prefill(specs[3][0], 0)
    for _ in range(2):
        tok = int(probe.decode(np.array([tok, 0, 0]),
                               np.zeros(3, np.float32), only)[0])
    eos = tok
    jreg, preg = JaxRegistry(), MetricsRegistry()
    jdone = JaxScheduler(je, registry=jreg).run(
        [JaxRequest(prompt=p, max_new_tokens=m,
                    eos_token=eos if i == 3 else None)
         for i, (p, m) in enumerate(specs)])
    psched = SlotScheduler(pe, registry=preg)
    pdone = psched.run([Request(prompt=p, max_new_tokens=m,
                                eos_token=eos if i == 3 else None)
                        for i, (p, m) in enumerate(specs)])
    assert sorted(pdone) == sorted(jdone) == list(range(len(specs)))
    for rid in jdone:
        assert pdone[rid].tokens == jdone[rid].tokens, rid
        assert pdone[rid].finish_reason == jdone[rid].finish_reason, rid
    reasons = [pdone[i].finish_reason for i in range(len(specs))]
    assert reasons == ["length", "length", "capacity", "eos", "length"]
    assert pdone[3].tokens[-1] == eos and eos not in pdone[3].tokens[:-1]
    for name in ("serve/admitted", "serve/retired", "serve/decode_steps",
                 "serve/generated_tokens", "serve/prefill_tokens"):
        assert preg.counter(name).value == jreg.counter(name).value, name
    for c in pdone.values():
        assert c.queue_wait_ms is not None and c.ttft_ms >= c.queue_wait_ms
        assert c.e2e_ms >= c.ttft_ms
    assert preg.histogram("serve/ttft_ms").count == len(specs)
    assert psched.pending == 0 and sorted(psched.free) == [0, 1, 2]


def test_sampling_greedy_top_k_and_seeded_draws():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(4, 97).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = sample_tokens(logits, gen, torch.zeros(4))
    assert greedy.dtype == torch.int32
    assert greedy.tolist() == logits.argmax(-1).tolist()
    # top_k=1 is exactly greedy at any temperature
    assert sample_tokens(logits, gen, torch.ones(4), top_k=1).tolist() == \
        greedy.tolist()
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    a = sample_tokens(logits, torch.Generator().manual_seed(5), temps, 5)
    b = sample_tokens(logits, torch.Generator().manual_seed(5), temps, 5)
    assert a.tolist() == b.tolist()
    assert a[0] == greedy[0] and a[2] == greedy[2]
    top5 = set(torch.topk(logits[1], 5).indices.tolist())
    draws = [int(sample_tokens(logits, torch.Generator().manual_seed(s),
                               temps, 5)[1]) for s in range(40)]
    assert set(draws) <= top5 and len(set(draws)) > 1


@pytest.mark.parametrize("top_k", [0, 1, 7])
def test_mask_top_k_matches_jax(top_k):
    from apex_tpu_torch.serving.sampling import _mask_top_k
    x = np.random.RandomState(top_k).randn(3, 50).astype(np.float32)
    a = np.asarray(jax_mask_top_k(jnp.asarray(x), top_k))
    b = _mask_top_k(torch.from_numpy(x), top_k).numpy()
    np.testing.assert_array_equal(a, b)


def test_sampling_frequencies_follow_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(4000, 1)
    toks = sample_tokens(logits, torch.Generator().manual_seed(1),
                         torch.ones(4000))
    freq = np.bincount(toks.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.03)


def test_swap_params_checks_and_copies_in_place():
    pe = _port_engine()
    sd = {k: v.clone() for k, v in pe.model.state_dict().items()}
    ptr = pe.model.final_ln.weight.data_ptr()
    sd["final_ln.weight"] = sd["final_ln.weight"] * 2
    pe.swap_params(sd)
    assert pe.swaps == 1 and pe.model.final_ln.weight.data_ptr() == ptr
    assert float(pe.model.final_ln.weight[0]) == 2.0
    with pytest.raises(ValueError, match="served as"):
        pe.swap_params(dict(sd, **{"final_ln.bias": torch.zeros(3)}))
    with pytest.raises(ValueError, match="names differ"):
        pe.swap_params({k: v for k, v in sd.items() if k != "final_ln.bias"})


def test_engine_and_scheduler_argument_errors():
    pe = _port_engine()
    assert pe.bytes_per_slot() == 2 * 2 * 4 * 16 * 4 * 128
    with pytest.raises(ValueError, match="empty prompt"):
        pe.prefill([], 0)
    with pytest.raises(ValueError, match="exceeds the prefill window"):
        pe.prefill([1] * 129, 0)
    with pytest.raises(ValueError, match="out of range"):
        pe.prefill([1], 3)
    sched = SlotScheduler(pe, registry=MetricsRegistry())
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request(prompt=[1], max_new_tokens=0))
    rid = sched.submit(Request(prompt=[1], request_id=7))
    assert rid == 7
    with pytest.raises(ValueError, match="already in flight"):
        sched.submit(Request(prompt=[2], request_id=7))
