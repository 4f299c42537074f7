"""The port's ``ExpertParallelMLP`` on gloo ranks against the JAX
package's under ``shard_map``.

The rank bodies live in ``tests/_torch_cp_ranks.py``; the JAX side runs
over ``Mesh(jax.devices()[:ep], ("expert",))`` with the reference's
``tests/test_expert_parallel.py`` as the guide. The same JAX ``init``
tree reaches both (``_bridge.moe_params_from_jax`` cuts a rank's experts):

- at ep 2 and 4: each rank's output, the mean aux loss and the grads of
  the router (summed over the ranks, the JAX router's grad) and of the
  rank's experts under ``sum(out**2) + 0.01 * mean(aux)``, against the
  JAX layer's; and the reference's dense check (per-shard top-1 routing
  in float64 numpy, no drops) on the port's output;
- capacity drops: at capacity factor 0.25 the tokens the port drops are
  the rows of the JAX output that are exactly zero, and every output
  row equals JAX's;
- a bf16 input at ep 2.

Tolerances: fp32 output and grads 1e-5 relative and 1e-6 absolute
against JAX (the same fp32 math, GEMM sums in another order), the
reference's 2e-4 / 2e-5 against its float64 dense check; bf16 2e-2 (a
bf16 rounding of the slots, the expert outputs and the result).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cp_ranks as R
from apex_tpu.transformer.expert_parallel import ExpertParallelMLP as JEP
from apex_tpu.utils.compat import shard_map

AUX_W = 0.01
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _jax(layer, params, x, ep):
    """The JAX layer's output, mean aux and parameter grads."""
    mesh = Mesh(np.array(jax.devices()[:ep]), ("expert",))
    espec = {"router": {"weight": P()},
             "experts": jax.tree_util.tree_map(lambda _: P("expert"),
                                               params["experts"])}

    def loss(params, x):
        def inner(params, x):
            out, aux = layer(params, x)
            aux = jax.lax.pmean(aux, "expert")
            return (jax.lax.psum(jnp.sum(out.astype(jnp.float32) ** 2),
                                 "expert") + AUX_W * aux), (out, aux)
        return shard_map(inner, mesh=mesh, in_specs=(espec, P("expert")),
                         out_specs=(P(), (P("expert"), P())))(params, x)

    (_, (out, aux)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, x)
    return np.asarray(out, np.float32), float(aux), _np(g)


def _run(pools, ep, sizes, seed, tokens, dtype="float32"):
    layer = JEP(**sizes, axis_name="expert")
    params = layer.init(jax.random.PRNGKey(seed))
    x = np.random.RandomState(seed).randn(ep * tokens, sizes[
        "hidden_size"]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _jax(layer, params, jnp.asarray(x, jdt), ep)
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    outs = pools.run(ep, R.moe, ep, _np(params), x, sizes, AUX_W, dtype)
    return layer, params, x, outs, want


def _dense_reference(params, x_shards):
    """Per-shard top-1 routing applied densely in float64 (no capacity
    drops): the reference's check."""
    Wg = np.asarray(params["router"]["weight"], np.float64)
    e = {k: np.asarray(v, np.float64) for k, v in params["experts"].items()}
    outs = []
    for xs in x_shards:
        xs = np.asarray(xs, np.float64)
        logits = xs @ Wg.T
        gates = np.exp(logits - logits.max(-1, keepdims=True))
        gates /= gates.sum(-1, keepdims=True)
        out = np.zeros_like(xs)
        for i, ex in enumerate(gates.argmax(-1)):
            h1 = xs[i] @ e["wi"][ex].T + e["bi"][ex]
            h1 = 0.5 * h1 * (1 + np.tanh(np.sqrt(2 / np.pi)
                                         * (h1 + 0.044715 * h1 ** 3)))
            out[i] = gates[i, ex] * (h1 @ e["wo"][ex].T + e["bo"][ex])
        outs.append(out)
    return np.concatenate(outs)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_matches_jax_values_and_grads(pools, ep):
    sizes = dict(hidden_size=16, ffn_hidden_size=32, num_experts=8,
                 capacity_factor=8.0)
    _, params, x, outs, (out, aux, g) = _run(pools, ep, sizes, ep, 12)
    rtol, atol = TOL["float32"]
    got = np.concatenate([o["out"] for o in outs])
    np.testing.assert_allclose(got, out, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.mean([o["aux"] for o in outs]), aux,
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(sum(o["router"] for o in outs),
                               g["router"]["weight"], rtol=rtol, atol=atol)
    for k in ("wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(
            np.concatenate([o["experts"][k] for o in outs]),
            g["experts"][k], rtol=rtol, atol=atol, err_msg=k)
    assert all(o["dropped"] == 0 for o in outs)
    dense = _dense_reference(_np(params), np.split(x, ep))
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-5)
    assert float(np.abs(g["router"]["weight"]).max()) > 0


def test_moe_capacity_drops_tokens_as_jax(pools):
    ep = 4
    sizes = dict(hidden_size=8, ffn_hidden_size=16, num_experts=4,
                 capacity_factor=0.25)
    _, _, _, outs, (out, _, _) = _run(pools, ep, sizes, 1, 16)
    rtol, atol = TOL["float32"]
    got = np.concatenate([o["out"] for o in outs])
    np.testing.assert_allclose(got, out, rtol=rtol, atol=atol)
    zero_rows = [int(np.all(r == 0.0, axis=-1).sum())
                 for r in np.split(out, ep)]
    assert [o["dropped"] for o in outs] == zero_rows
    assert sum(zero_rows) > 0.2 * len(out)
    assert all(o["capacity"] == 1 for o in outs)


def test_moe_bf16_matches_jax(pools):
    sizes = dict(hidden_size=16, ffn_hidden_size=32, num_experts=4,
                 capacity_factor=1.25)
    _, _, _, outs, (out, aux, g) = _run(pools, 2, sizes, 3, 16, "bfloat16")
    rtol, atol = TOL["bfloat16"]
    got = np.concatenate([o["out"] for o in outs])
    np.testing.assert_allclose(got, out, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.mean([o["aux"] for o in outs]), aux,
                               rtol=rtol, atol=atol)
    for k in ("wi", "wo"):
        np.testing.assert_allclose(
            np.concatenate([o["experts"][k] for o in outs]),
            g["experts"][k], rtol=rtol, atol=atol, err_msg=k)


def test_moe_init_places_on_card_unless_cpu_asked():
    import torch
    from apex_tpu_torch.transformer.expert_parallel import (
        ExpertParallelMLP)
    sizes = dict(hidden_size=8, ffn_hidden_size=16, num_experts=4)
    layer = ExpertParallelMLP(**sizes)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            layer.init(torch.Generator().manual_seed(0))
    got = layer.init(torch.Generator().manual_seed(0), device="cpu")
    want = JEP(**sizes).init(jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.device.type,
                                               t.dtype), got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (shape, dev, dt), w in zip(jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda s: isinstance(s, tuple)),
            jax.tree_util.tree_leaves(want)):
        assert shape == w.shape and dev == "cpu" and dt == torch.float32
