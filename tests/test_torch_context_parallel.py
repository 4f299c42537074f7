"""The port's context-parallel attention on gloo ranks against the JAX
package's under ``shard_map``.

The rank bodies live in ``tests/_torch_cp_ranks.py`` (one pool a context
size a module); the JAX side runs over ``Mesh(jax.devices()[:cp],
("context",))``, the reference's ``tests/test_context_parallel.py`` the
guide:

- ``ring_attention`` at cp 2 and 4, causal and not, remat on and off,
  fp32 and bf16: each rank's output shard and the grads of its q/k/v
  shards under ``sum(out * dy)`` against the JAX ring's;
- ``ulysses_attention`` (the port's flash twin inside) against the JAX
  Ulysses (the JAX flash op inside), values and grads, and the
  ``ValueError`` of a head count the group does not divide;
- ``TrainConfig`` at cp 2 (tp 2, four ranks): the mesh's context, tensor
  and data groups equal the JAX package's, and the GPT builds with cp 1's
  parameter shapes.

Tolerances: fp32 2e-5 absolute and relative, the reference's own limit
against its dense attention (the same fp32 math, sums in another order);
bf16 3e-2, the reference's bf16 limit (one bf16 rounding of the output
and of each grad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_cp_ranks as R
from apex_tpu.transformer import context_parallel as jcp
from apex_tpu.utils.compat import shard_map

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPEC = P(None, None, "context", None)


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _qkv(b=2, h=4, s=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))


def _jax(fn, cp, q, k, v, dy, dtype):
    """The JAX ``fn`` under ``shard_map``: the output and the q/k/v grads
    of ``sum(out * dy)``."""
    mesh = Mesh(np.array(jax.devices()[:cp]), ("context",))
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))

    def loss(q, k, v):
        def inner(q, k, v, dy):
            out = fn(q, k, v)
            return jax.lax.psum(jnp.sum(out.astype(jnp.float32) * dy),
                                "context"), out
        return shard_map(inner, mesh=mesh, in_specs=(SPEC,) * 4,
                         out_specs=(P(), SPEC))(q, k, v, jnp.asarray(dy))

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    return [np.asarray(x, np.float32) for x in (out,) + tuple(grads)]


def _joined(outs):
    """The ranks' (out, dq, dk, dv) shards joined along the sequence."""
    return [np.concatenate([o[i] for o in outs], axis=2) for i in range(4)]


def _close(got, want, dtype):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("cp,causal,remat,dtype", [
    (2, False, True, "float32"), (2, True, False, "float32"),
    (4, True, True, "float32"), (4, False, False, "float32"),
    (2, True, True, "bfloat16"), (4, True, False, "bfloat16")])
def test_ring_attention_matches_jax(pools, cp, causal, remat, dtype):
    q, k, v, dy = _qkv(seed=cp + 2 * causal)
    outs = pools.run(cp, R.attention, "ring", cp, q, k, v, dy, causal,
                     remat, dtype)
    want = _jax(lambda q, k, v: jcp.ring_attention(
        q, k, v, "context", causal=causal, remat=remat), cp, q, k, v, dy,
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    _close(_joined(outs), want, dtype)


@pytest.mark.parametrize("cp,causal", [(2, True), (4, False)])
def test_ulysses_attention_matches_jax(pools, cp, causal):
    q, k, v, dy = _qkv(seed=10 + cp)
    outs = pools.run(cp, R.attention, "ulysses", cp, q, k, v, dy, causal)
    want = _jax(lambda q, k, v: jcp.ulysses_attention(
        q, k, v, "context", causal=causal), cp, q, k, v, dy, jnp.float32)
    _close(_joined(outs), want, "float32")


def test_ulysses_heads_must_divide_cp(pools):
    q = _qkv(b=1, h=3, s=16, d=8)[0]
    msgs = pools.run(2, R.ulysses_heads_error, 2, q)
    mesh = Mesh(np.array(jax.devices()[:2]), ("context",))
    with pytest.raises(ValueError) as err:
        shard_map(lambda q: jcp.ulysses_attention(q, q, q, "context"),
                  mesh=mesh, in_specs=(SPEC,), out_specs=SPEC)(
                      jnp.asarray(q))
    assert msgs == [str(err.value)] * 2


def test_train_config_at_cp2_builds_with_the_reference_groups(pools):
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu_torch import config as tcfg
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(vocab_size=64, hidden_size=32, num_layers=2,
                               num_attention_heads=4,
                               max_position_embeddings=16),
        parallel=tcfg.ParallelConfig(tensor_model_parallel_size=2,
                                     context_parallel_size=2))
    outs = pools.run(4, R.config_cp, cfg.to_dict())
    jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                  context_parallel_size=2,
                                  devices=jax.devices()[:4])
    try:
        want = {"context": jps.get_context_parallel_groups(),
                "tensor": jps.get_tensor_model_parallel_groups(),
                "data": jps.get_data_parallel_groups()}
    finally:
        jps.destroy_model_parallel()
    assert want["context"] == [[0, 2], [1, 3]]
    for r, out in enumerate(outs):
        for axis in ("context", "tensor", "data"):
            assert [list(g) for g in out[axis]] == want[axis], axis
        assert tuple(out["cp"]) == (2, (r // 2) % 2)
        assert out["shapes"]["layers.0.fc1.weight"] == (64, 32)
