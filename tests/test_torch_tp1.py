"""The port's tp=1 transformer pieces against the JAX package on the CPU:
the RNG tracker and ``model_parallel_seed``, ``checkpoint`` with dropout,
``vocab_parallel_cross_entropy``, the enums and the utils.

- the tracker's semantics, the reference's ``test_rng_tracker_semantics``
  cases on generators (forks differ, ``set_states`` replays, tensor ranks
  differ, ``add`` of a name that exists and ``make_key`` of one that does
  not raise), the seeds ``seed`` and ``seed + 2718 + tensor_rank``, and
  distinct default streams per ``data_rank``;
- ``checkpoint`` around a GPT layer with hidden and attention dropout from
  a forked generator: the loss and every grad bit for bit equal to the
  unwrapped layer's from the same generator state, and a re-fork gives
  new masks;
- ``vocab_parallel_cross_entropy`` against the JAX function run under a
  one-device ``tensor`` mesh, fp32 and bf16 logits, smoothing 0 and 0.1:
  the loss and the grads of a weighted sum within 1e-6 of the largest
  magnitude (fp32 math, sums in another order), and tp > 1 refused;
- the four enums' members and ``transformer/utils.py``'s functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer import enums as jenums
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer import utils as jutils
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.transformer import enums, tensor_parallel as tp, utils
from apex_tpu_torch.transformer.tensor_parallel import random as prandom

TOL = 1e-6


def _draw(gen, n=8):
    return torch.rand(n, generator=gen)


def test_rng_tracker_semantics():
    tp.model_parallel_seed(1234, tensor_rank=0, device="cpu")
    tracker = tp.get_rng_tracker()
    states0 = tracker.get_states()
    with tracker.fork() as gen_a:
        a = _draw(gen_a)
    with tracker.fork() as gen_b:
        b = _draw(gen_b)
    assert not torch.equal(a, b)
    tracker.set_states(states0)
    with tracker.fork() as gen_a2:
        assert torch.equal(_draw(gen_a2), a)
    tp.model_parallel_seed(1234, tensor_rank=1, device="cpu")
    with tp.get_rng_tracker().fork() as gen_r1:
        assert not torch.equal(_draw(gen_r1), a)
    with pytest.raises(Exception):
        tp.get_rng_tracker().add("default", 1)
    with pytest.raises(Exception):
        tp.get_rng_tracker().make_key("nonexistent")


def test_seeds_and_data_ranks():
    name = prandom._MODEL_PARALLEL_RNG_TRACKER_NAME
    tp.model_parallel_seed(1234, tensor_rank=3, device="cpu")
    states = tp.get_rng_tracker().states_
    assert states["default"].initial_seed() == 1234
    assert states[name].initial_seed() == 1234 + 2718 + 3
    draws = []
    for rank in (None, 0, 1, 2):
        tp.model_parallel_seed(1234, data_rank=rank, device="cpu")
        draws.append(_draw(tp.get_rng_tracker().make_key("default")))
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    tp.model_parallel_seed(1234, data_rank=1, device="cpu")
    assert torch.equal(_draw(tp.get_rng_tracker().make_key("default")),
                       draws[2])
    # a generator passed to add is the stream itself
    tracker = prandom.RNGStatesTracker(device="cpu")
    g = torch.Generator().manual_seed(5)
    tracker.add("mine", g)
    assert tracker.states_["mine"] is g


def test_streams_default_to_the_card():
    """The tracker and ``model_parallel_seed`` run on the card unless the
    caller asks for the CPU; with no card, making a stream raises."""
    assert prandom.RNGStatesTracker().device.type == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.model_parallel_seed(1234)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prandom.RNGStatesTracker().add("default", 1)


def _layer_run(model, x, gen, wrap):
    lp = model.layers[0]
    fn = (lambda h, g: model._layer(lp, h, 77, g))
    if wrap:
        fn = tp.checkpoint(fn)
    xx = x.clone().requires_grad_(True)
    out = fn(xx, gen)
    loss = (out.float() ** 2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in lp.named_parameters()}
    for p in lp.parameters():
        p.grad = None
    return loss.detach(), xx.grad, grads, gen.get_state()


def test_checkpoint_with_dropout_bit_for_bit():
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_attention_heads=4, max_position_embeddings=32,
                    hidden_dropout=0.2, attention_dropout=0.2,
                    compute_dtype=torch.float32)
    model = GPTModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    tp.model_parallel_seed(1234, device="cpu")
    tracker = tp.get_rng_tracker()
    states = tracker.get_states()
    with tracker.fork() as gen:
        plain = _layer_run(model, x, gen, wrap=False)
    tracker.set_states(states)
    with tracker.fork() as gen:
        ckpt = _layer_run(model, x, gen, wrap=True)
    assert torch.equal(plain[0], ckpt[0])
    assert torch.equal(plain[1], ckpt[1])
    for name in plain[2]:
        assert torch.equal(plain[2][name], ckpt[2][name]), name
    assert torch.equal(plain[3], ckpt[3])     # the generator ends alike
    with tracker.fork() as gen:
        again = _layer_run(model, x, gen, wrap=True)
    assert not torch.equal(again[0], plain[0])


def _jax_ce(logits, target, w, smoothing):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("tensor",))

    def total(lg):
        loss = shard_map(
            lambda l, t: jtp.vocab_parallel_cross_entropy(l, t, smoothing),
            mesh=mesh, in_specs=(P(None, None, "tensor"), P()),
            out_specs=P())(lg, jnp.asarray(target))
        return jnp.sum(loss * w), loss

    (_, loss), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        logits)
    return np.asarray(loss), np.asarray(grad.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(dtype, smoothing):
    rng = np.random.RandomState(4)
    logits = (rng.randn(5, 7, 32) * 3).astype(np.float32)
    target = rng.randint(0, 32, (5, 7))
    w = rng.randn(5, 7).astype(np.float32)
    want, jgrad = _jax_ce(jnp.asarray(logits, getattr(jnp, dtype)), target,
                          w, smoothing)
    x = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_(True)
    loss = tp.vocab_parallel_cross_entropy(x, torch.tensor(target),
                                           smoothing)
    assert loss.dtype == torch.float32 and loss.shape == (5, 7)
    (loss * torch.tensor(w)).sum().backward()
    limit = TOL * max(1.0, float(np.abs(want).max()))
    assert np.abs(loss.detach().numpy() - want).max() <= limit
    limit = TOL * max(1.0, float(np.abs(jgrad).max()))
    if dtype == "bfloat16":
        # the grad is rounded to the logits' bf16 (one ulp, 2**-8)
        limit += 2.0 ** -8 * float(np.abs(jgrad).max())
    assert np.abs(x.grad.float().numpy() - jgrad).max() <= limit
    # tp > 1 needs the tensor group of an installed mesh
    with pytest.raises(ValueError, match="'tensor' is not bound"):
        tp.vocab_parallel_cross_entropy(x, torch.tensor(target),
                                        world_size=2)


def test_enums_and_utils():
    for name in enums.__all__:
        got = {m.name: m.value for m in getattr(enums, name)}
        assert got == {m.name: m.value for m in getattr(jenums, name)}
    x = np.random.RandomState(0).randn(3, 12).astype(np.float32)
    parts = utils.split_tensor_along_last_dim(torch.tensor(x), 3)
    want = jutils.split_tensor_along_last_dim(jnp.asarray(x), 3)
    assert len(parts) == len(want) == 3
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert utils.divide(12, 4) == jutils.divide(12, 4) == 3
    with pytest.raises(AssertionError):
        utils.divide(10, 4)
    for rank in range(4):
        assert (utils.VocabUtility.vocab_range_from_global_vocab_size(
            32, rank, 4) == jutils.VocabUtility.
            vocab_range_from_global_vocab_size(32, rank, 4))
