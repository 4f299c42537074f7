"""Weight bridge: the JAX ``GPTModel.init`` pytree to the port's state dict
and back, bit for bit, for fp32 and bf16 leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
from apex_tpu_torch.models import GPTConfig, GPTModel

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=16)


def _jax_params(dtype):
    model = JaxGPT(JaxGPTConfig(params_dtype=dtype, **SIZES))
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_round_trip_is_bit_exact(jdtype, tdtype):
    tree = _jax_params(jdtype)
    cfg = GPTConfig(params_dtype=tdtype, **SIZES)
    sd = params_from_jax(tree, cfg)
    assert all(t.dtype == tdtype for t in sd.values())
    # bf16 leaves come back as their bits; view them as JAX's bf16
    back = jax.tree_util.tree_map(
        lambda x: x.view(jnp.bfloat16) if x.dtype == np.uint16 else x,
        params_to_numpy(sd, cfg))
    flat_a, tree_a = jax.tree_util.tree_flatten(tree)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_state_dict_loads_strict_and_keeps_values(jdtype, tdtype):
    tree = _jax_params(jdtype)
    cfg = GPTConfig(params_dtype=tdtype, **SIZES)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    # qkv keeps the JAX (3h, h) out-by-in layout of layer 1, shard 0
    np.testing.assert_array_equal(
        _bits(tree["layers"]["qkv"]["weight"][1, 0]),
        _bits(model.layers[1].qkv.weight.detach().view(
            torch.int16 if tdtype == torch.bfloat16 else torch.int32)
            .numpy()))
    assert model.embedding.word.weight.shape == (97, 32)
    assert model.embedding.position.shape == (16, 32)


def test_bf16_leaves_without_extension_dtype_come_back_as_bits():
    tree = _jax_params(jnp.bfloat16)
    cfg = GPTConfig(params_dtype=torch.bfloat16, **SIZES)
    back = params_to_numpy(params_from_jax(tree, cfg), cfg)
    assert back["final_ln"]["weight"].dtype == np.uint16
    np.testing.assert_array_equal(back["embedding"]["position"],
                                  _bits(tree["embedding"]["position"]))


def test_tp_shard_dim_must_be_one():
    """A tp = 1 model takes shard 0 of a stacked leaf; a rank past the
    stack raises."""
    tree = _jax_params(jnp.float32)
    word = tree["embedding"]["word"]["weight"]
    tree["embedding"]["word"]["weight"] = np.concatenate([word, word + 1])
    sd = params_from_jax(tree, GPTConfig(**SIZES))
    np.testing.assert_array_equal(sd["embedding.word.weight"].numpy(),
                                  word[0])
    with pytest.raises(ValueError, match="no shard 1"):
        params_from_jax(_jax_params(jnp.float32), GPTConfig(**SIZES),
                        tp_rank=1)


def test_init_law_follows_reference():
    """The port's own init (CPU generator): N(0, 0.02) for embeddings,
    qkv and fc1, N(0, 0.02/sqrt(2L)) for proj and fc2, zero biases, unit
    LayerNorm; one seed gives one set of weights."""
    cfg = GPTConfig(vocab_size=512, hidden_size=64, num_layers=8,
                    num_attention_heads=4, max_position_embeddings=64)
    a = GPTModel(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = GPTModel(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    out_std = 0.02 / np.sqrt(2 * cfg.num_layers)
    w = torch.cat([lp.proj.weight.flatten() for lp in a.layers])
    assert abs(float(w.std()) - out_std) < 0.05 * out_std
    assert abs(float(a.embedding.word.weight.std()) - 0.02) < 1e-3
    assert float(a.layers[0].qkv.bias.abs().max()) == 0.0
    assert float(a.layers[0].ln1.weight.min()) == 1.0
