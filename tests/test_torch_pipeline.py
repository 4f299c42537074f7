"""The port's pipeline schedules on gloo ranks against the JAX package's
under ``shard_map``.

The rank bodies live in ``tests/_torch_pp_ranks.py`` (one pool a
pipeline size a module); the JAX side runs over ``Mesh(jax.devices()[:S],
("pipe",))``. A toy stage ``tanh(x @ w + b)`` (d 8, 5 microbatches of 2
rows, an MSE head) and GPT through ``pipeline_fns`` (the reference's
``tests/test_transformer_parallel.py`` tests of the pipelined embedding
and tied head as the guide):

- the hops: ``rotate_forward``/``rotate_backward`` and their grads
  against the JAX rotations; two tensors a hop; an empty hop posts
  nothing; a receive whose peer never sends fails the call by the
  pool's limit;
- ``pipelined_apply`` against the JAX ``pipelined_apply`` at pp 2 and 4,
  and interleaved at 2 chunks;
- 1F1B (``memory_efficient`` True and False) at pp 2 and 4, and the
  interleaved schedule at 2 chunks a rank, against the JAX schedules:
  the loss at 1e-6 and every grad leaf at 1e-6, every rank's loss the
  same; the ``pipeline/*`` metrics equal to JAX's; ``forward_only``;
- no pipelining (plain and the pipelined call shape, with the ``remat``
  flag) and the dispatcher against JAX's, in one process;
- the in-flight bound: at M 4 and 8 a stage holds at most ``pp -
  stage_rank`` live microbatch outputs under 1F1B (counted by weakrefs
  in a test stage function), chunk ``c`` at most ``2(L - c * pp) - 1``
  interleaved, and every microbatch under the all-forward order;
- GPT with the pipelined embedding and tied head at pp 2 and 4 and
  interleaved (pp 2, 2 chunks) against the JAX model's loss and grads on
  one device (1e-6), the tied embedding's grad with both stages'
  contributions on every rank; the remat policies on the stages bit for
  bit the plain stages; the stage split's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_pp_ranks as R
from apex_tpu.models import GPTConfig as JCfg, GPTModel as JGPT
from apex_tpu.observability import ingraph as jingraph
from apex_tpu.transformer.pipeline_parallel import p2p_communication as jp2p
from apex_tpu.transformer.pipeline_parallel import schedules as jsc
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.transformer.pipeline_parallel import schedules as tsc

D, M_TOY = 8, 5
TOL_LOSS, TOL_GRAD = 1e-6, 1e-6
GPT_SIZES = dict(vocab_size=64, hidden_size=32, num_attention_heads=4,
                 max_position_embeddings=8)


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("pipe",))


def _toy(L, seed=0, M=M_TOY):
    rng = np.random.RandomState(seed)
    return ((rng.randn(L, D, D) * 0.3).astype(np.float32),
            (rng.randn(L, D) * 0.1).astype(np.float32),
            rng.randn(M, 2, D).astype(np.float32),
            rng.randn(M, 2, D).astype(np.float32))


def _jstage(p, x, g):
    return jnp.tanh(x @ p["w"] + p["b"])


def _by_device(a, S, V):
    """``(L, ...)`` global stages -> ``(S, V, ...)``: device d's chunk c is
    global stage ``c * S + d``."""
    return np.stack([np.stack([a[c * S + d] for c in range(V)])
                     for d in range(S)])


def _jax_schedule(S, V, ws, bs, micro, targets, mode):
    """The JAX schedule (or ``pipelined_apply``) under ``shard_map``: the
    loss (or outputs), grads ``(S, V, ...)`` and the aggregated
    ``pipeline/*`` metrics."""
    tg = jnp.asarray(targets)

    def loss_fn(y, m):
        t = jax.lax.dynamic_index_in_dim(tg, m, 0, keepdims=False)
        return jnp.mean((y - t) ** 2)

    def inner(w, b, mb):
        p = {"w": w[0], "b": b[0]}            # (V, ...) this device's chunks

        def body():
            if mode == "apply":
                return jsc.pipelined_apply(_jstage, p, mb, num_chunks=V), p
            if V == 1:
                p1 = jax.tree_util.tree_map(lambda a: a[0], p)
                loss, g = jsc.forward_backward_pipelining_without_interleaving(
                    _jstage, mb, p1, loss_fn=loss_fn,
                    memory_efficient=mode == "1f1b")
                return loss, jax.tree_util.tree_map(lambda a: a[None], g)
            return jsc.forward_backward_pipelining_with_interleaving(
                _jstage, mb, p, loss_fn=loss_fn, num_model_chunks=V,
                memory_efficient=mode == "1f1b")

        (out, g), metrics = jingraph.reap(body)()
        return (out, jax.tree_util.tree_map(lambda a: a[None], g),
                jingraph.aggregate(metrics, "pipe"))

    ws_d = jnp.asarray(_by_device(ws, S, V))
    bs_d = jnp.asarray(_by_device(bs, S, V))
    out, g, metrics = jax.jit(shard_map(
        inner, mesh=_mesh(S), in_specs=(P("pipe"), P("pipe"), P()),
        out_specs=(P(), P("pipe"), P())))(ws_d, bs_d, jnp.asarray(micro))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, g), \
        metrics.as_floats()


# -- the hops -------------------------------------------------------------------

@pytest.mark.parametrize("pp", [2, 4])
def test_hops_match_the_jax_rotations(pools, pp):
    rng = np.random.RandomState(pp)
    x = rng.randn(pp, 3, 5).astype(np.float32)
    w = rng.randn(pp, 3, 5).astype(np.float32)

    def inner(x, w):
        f, fvjp = jax.vjp(jp2p.rotate_forward, x)
        b, bvjp = jax.vjp(jp2p.rotate_backward, x)
        return f, fvjp(w)[0], b, bvjp(w)[0]

    jf, jfg, jb, jbg = jax.jit(shard_map(
        inner, mesh=_mesh(pp), in_specs=(P("pipe"), P("pipe")),
        out_specs=(P("pipe"),) * 4))(x, w)
    outs = pools.run(pp, R.hops, pp, x, w)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["forward"][0], np.asarray(jf)[r])
        np.testing.assert_array_equal(out["forward"][1], np.asarray(jfg)[r])
        np.testing.assert_array_equal(out["backward"][0], np.asarray(jb)[r])
        np.testing.assert_array_equal(out["backward"][1],
                                      np.asarray(jbg)[r])
        a, b = out["pair"]
        np.testing.assert_array_equal(a, x[(r - 1) % pp])
        assert b.dtype == np.float64
        np.testing.assert_array_equal(b, w[(r - 1) % pp].astype(np.float64))
        assert out["empty"] == []


def test_a_hop_with_no_peer_fails_by_the_limit(pools):
    from apex_tpu_torch.parallel._spawn import RankError
    with pytest.raises(RankError, match="did not finish hang"):
        pools(2).run(R.hang, 2, timeout=4)


# -- pipelined_apply and the schedules -----------------------------------------------

@pytest.mark.parametrize("pp,chunks", [(2, 1), (4, 1), (2, 2)],
                         ids=["pp2", "pp4", "pp2_v2"])
def test_pipelined_apply_matches_jax(pools, pp, chunks):
    ws, bs, micro, targets = _toy(pp * chunks, seed=10 + pp)
    want, _, j_metrics = _jax_schedule(pp, chunks, ws, bs, micro, targets,
                                       "apply")
    for out, _, metrics in pools.run(pp, R.schedules, pp, chunks, ws, bs,
                                     micro, targets, "apply"):
        np.testing.assert_allclose(out, want, rtol=0, atol=TOL_GRAD)
        assert metrics == j_metrics


SCHEDULES = [(2, 1, "1f1b"), (2, 1, "allfwd"), (4, 1, "1f1b"),
             (4, 1, "allfwd"), (2, 2, "1f1b"), (2, 2, "allfwd"),
             (4, 2, "1f1b")]


@pytest.mark.parametrize("pp,chunks,mode", SCHEDULES,
                         ids=[f"pp{p}_v{c}_{d}" for p, c, d in SCHEDULES])
def test_schedules_match_jax(pools, pp, chunks, mode):
    """Loss (1e-6, the same on every rank), each rank's chunk grads
    (1e-6) and the ``pipeline/*`` metrics against the JAX schedule."""
    ws, bs, micro, targets = _toy(pp * chunks, seed=pp + 3 * chunks)
    j_loss, j_grads, j_metrics = _jax_schedule(pp, chunks, ws, bs, micro,
                                               targets, mode)
    outs = pools.run(pp, R.schedules, pp, chunks, ws, bs, micro, targets,
                     mode)
    assert len({float(o[0]) for o in outs}) == 1
    for r, (loss, grads, metrics) in enumerate(outs):
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                                   atol=TOL_LOSS)
        for c in range(chunks):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    grads[c][leaf], j_grads[leaf][r, c], rtol=0,
                    atol=TOL_GRAD, err_msg=f"rank {r} chunk {c} {leaf}")
        assert metrics == j_metrics, (metrics, j_metrics)


def test_forward_only_matches_jax(pools):
    ws, bs, micro, targets = _toy(2, seed=21)
    j_loss, _, _ = _jax_schedule(2, 1, ws, bs, micro, targets, "1f1b")
    for loss, grads in pools.run(2, R.forward_only, 2, ws, bs, micro,
                                 targets):
        assert grads is None
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=0,
                                   atol=TOL_LOSS)


def test_no_pipelining_and_the_dispatcher_match_jax():
    """``forward_backward_no_pipelining`` on the whole toy model, and with
    the pipelined call shape (``loss_fn``, under the ``full`` remat flag),
    against JAX's; the dispatcher picks the same schedules."""
    import torch
    ws, bs, micro, targets = _toy(3, seed=5)

    def jfull(p, mb):
        x, t = mb
        for g in range(3):
            x = _jstage({"w": p["w"][g], "b": p["b"][g]}, x, g)
        return jnp.mean((x - t) ** 2)

    def tfull(p, mb):
        x, t = mb
        for g in range(3):
            x = R.stage_fn({"w": p["w"][g], "b": p["b"][g]}, x, g)
        return torch.mean((x - t) ** 2)

    jp = {"w": jnp.asarray(ws), "b": jnp.asarray(bs)}
    j_loss, j_grads = jsc.forward_backward_no_pipelining(
        jfull, (jnp.asarray(micro), jnp.asarray(targets)), jp,
        grad_scale=4.0)
    tp = {"w": R._t(ws, True), "b": R._t(bs, True)}
    t_loss, t_grads = tsc.forward_backward_no_pipelining(
        tfull, (R._t(micro), R._t(targets)), tp, grad_scale=4.0)
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=TOL_LOSS)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(t_grads[leaf].numpy(),
                                   np.asarray(j_grads[leaf]), atol=TOL_GRAD)

    # the pipelined call shape at pp = 1: one stage, the head apart
    jtg, ttg = jnp.asarray(targets), R._t(targets)
    p1 = {"w": ws[0], "b": bs[0]}
    j_loss, j_grads = jsc.get_forward_backward_func(None, 1)(
        _jstage, jnp.asarray(micro), jax.tree_util.tree_map(jnp.asarray, p1),
        loss_fn=lambda y, m: jnp.mean((y - jtg[m]) ** 2), remat=True)
    t_loss, t_grads = tsc.get_forward_backward_func(None, 1)(
        R.stage_fn, R._t(micro), {k: R._t(v, True) for k, v in p1.items()},
        loss_fn=lambda y, m: torch.mean((y - ttg[m]) ** 2), remat=True)
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=TOL_LOSS)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(t_grads[leaf].numpy(),
                                   np.asarray(j_grads[leaf]), atol=TOL_GRAD)
    f_loss, f_grads = tsc.forward_backward_no_pipelining(
        tfull, (R._t(micro), R._t(targets)), tp, forward_only=True)
    assert f_grads is None
    np.testing.assert_allclose(float(f_loss), float(jsc.
                               forward_backward_no_pipelining(
                                   jfull, (jnp.asarray(micro),
                                           jnp.asarray(targets)), jp,
                                   forward_only=True)[0]), atol=TOL_LOSS)
    with pytest.raises(ValueError, match="single model chunk"):
        tsc.forward_backward_no_pipelining(
            R.stage_fn, R._t(micro), tp, loss_fn=lambda y, m: y.sum(),
            num_model_chunks=2)
    for args in ((None, 1), (None, 4), (2, 4)):
        want = jsc.get_forward_backward_func(*args).__name__
        assert tsc.get_forward_backward_func(*args).__name__ == want


# -- the in-flight bound ----------------------------------------------------------------

@pytest.mark.parametrize("pp,M", [(2, 4), (2, 8), (4, 4), (4, 8)],
                         ids=["pp2_M4", "pp2_M8", "pp4_M4", "pp4_M8"])
def test_1f1b_holds_at_most_pp_minus_rank_microbatches(pools, pp, M):
    ws, bs, micro, targets = _toy(pp, seed=M, M=M)
    most = pools.run(pp, R.inflight, pp, 1, ws, bs, micro, targets, True)
    assert [m[0] for m in most] == [min(pp - r, M) for r in range(pp)]
    # the all-forward order keeps every microbatch until its backward
    most = pools.run(pp, R.inflight, pp, 1, ws, bs, micro, targets, False)
    assert [m[0] for m in most] == [M] * pp


@pytest.mark.parametrize("M", [4, 8])
def test_interleaved_holds_the_reference_bound_per_chunk(pools, M):
    pp, V = 2, 2
    L = pp * V
    ws, bs, micro, targets = _toy(L, seed=M, M=M)
    most = pools.run(pp, R.inflight, pp, V, ws, bs, micro, targets, True)
    for r, chunks in enumerate(most):
        for c, n in enumerate(chunks):
            assert n == min(2 * (L - (c * pp + r)) - 1, M), (r, c, n)
            assert n <= 2 * (L - c * pp) - 1


# -- GPT through pipeline_fns ------------------------------------------------------------

def _gpt_case(num_layers, M, seed):
    cfg = JCfg(num_layers=num_layers, compute_dtype=jnp.float32,
               use_flash=False, **GPT_SIZES)
    model = JGPT(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 64, (M, 2, 8))
    targets = rng.randint(0, 64, (M, 2, 8))

    def ref_loss(p):
        return jnp.mean(jax.vmap(lambda tok, tgt: model.loss(p, tok, tgt))(
            jnp.asarray(tokens), jnp.asarray(targets)))

    loss, grads = jax.jit(jax.value_and_grad(ref_loss))(params)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return np_tree, tokens, targets, float(loss), jax.tree_util.tree_map(
        np.asarray, grads)


def _layer_grad(grads, layer: int, name: str):
    """The JAX grad of layer ``layer``'s ``name`` (``qkv.weight`` ...) in
    the port's layout (the tensor shard dim dropped)."""
    mod, leaf = name.split(".")
    g = grads["layers"][mod][leaf][layer]
    return g[0] if mod in ("qkv", "proj", "fc1", "fc2") else g


@pytest.mark.parametrize("pp,chunks", [(2, 1), (4, 1), (2, 2)],
                         ids=["pp2", "pp4", "pp2_v2"])
def test_gpt_pipeline_matches_the_one_device_model(pools, pp, chunks):
    """Loss and every grad against the JAX model's mean loss over the
    microbatches on one device; the tied embedding's grad (the first
    stage's lookup and the last stage's head) the same on every rank."""
    L = 2 * pp * chunks
    tree, tokens, targets, j_loss, j_grads = _gpt_case(L, 4, seed=pp + chunks)
    outs = pools.run(pp, R.gpt_pipeline, pp, chunks,
                     dict(GPT_SIZES, num_layers=L), tree, tokens, targets)
    per = L // (pp * chunks)
    shared_want = {
        ("embedding", "word.weight"): j_grads["embedding"]["word"]["weight"][0],
        ("embedding", "position"): j_grads["embedding"]["position"],
        ("final_ln", "weight"): j_grads["final_ln"]["weight"],
        ("final_ln", "bias"): j_grads["final_ln"]["bias"]}
    for r, (loss, stage_grads, shared) in enumerate(outs):
        np.testing.assert_allclose(float(loss), j_loss, rtol=0, atol=TOL_LOSS)
        for c, grads in enumerate(stage_grads):
            for name, g in grads.items():
                j, leaf = name.split(".", 1)
                layer = (c * pp + r) * per + int(j)
                np.testing.assert_allclose(
                    g, _layer_grad(j_grads, layer, leaf), rtol=0,
                    atol=TOL_GRAD, err_msg=f"rank {r} chunk {c} {name}")
        for (mod, leaf), want in shared_want.items():
            np.testing.assert_allclose(shared[mod][leaf], want, rtol=0,
                                       atol=TOL_GRAD,
                                       err_msg=f"rank {r} {mod}.{leaf}")
    emb = [o[2]["embedding"]["word.weight"] for o in outs]
    assert all(np.array_equal(emb[0], e) for e in emb)


def test_gpt_pipeline_remat_policies_are_bit_for_bit_the_plain_stages(pools):
    tree, tokens, targets, _, _ = _gpt_case(4, 4, seed=7)
    sizes = dict(GPT_SIZES, num_layers=4)
    plain = pools.run(2, R.gpt_pipeline, 2, 1, sizes, tree, tokens, targets)
    for remat in ("full", "selective"):
        got = pools.run(2, R.gpt_pipeline, 2, 1, sizes, tree, tokens, targets,
                        remat)
        for a, b in zip(plain, got):
            assert float(a[0]) == float(b[0]), remat
            for ga, gb in zip(jax.tree_util.tree_leaves(a[1:]),
                              jax.tree_util.tree_leaves(b[1:])):
                np.testing.assert_array_equal(ga, gb, err_msg=remat)


def test_gpt_stage_split_refusals_match_jax(pools):
    """A stage count that does not divide the layers, and sequence
    parallelism across stages, raise as the reference does."""
    sizes = dict(GPT_SIZES, num_layers=4)
    got = pools.run(2, R.gpt_stage_refusals, sizes)[0]
    jm = JGPT(JCfg(**sizes))
    with pytest.raises(ValueError) as e:
        jm.stage_fn(3)
    assert got["indivisible"] == ("ValueError", str(e.value))
    jsp = JGPT(JCfg(tensor_model_parallel_size=2, sequence_parallel=True,
                    **sizes))
    with pytest.raises(NotImplementedError) as e:
        jsp.stage_fn(2)
    assert got["sp"] == ("NotImplementedError", str(e.value))
