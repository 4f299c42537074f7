"""The port's tensor-parallel pieces on gloo ranks against the JAX
package's under ``shard_map``.

The same seeded numpy inputs go through the JAX functions in
``shard_map`` over a one-axis ``("tensor",)`` mesh of ``jax.devices()[:tp]``
and through the port's on ``tp`` gloo ranks
(``apex_tpu_torch.parallel._spawn``, one pool a world size for the
module; the rank bodies are in ``tests/_torch_tp_ranks.py``), at tp 2
and 4, following the reference's own tests
(``tests/test_tp_mappings.py``, ``test_transformer_parallel.py:85-255``,
``test_collective_matmul.py:45-375``, ``test_context_parallel.py:97``):

- the four mappings and the three sequence-parallel regions, forward and
  backward, under one objective ``sum(out * seed)``: a seed stacked by
  rank where the output varies by rank (the JAX objective ``psum``-ed),
  one seed where it is replicated; their refusals of indivisible dims;
- Column -> Row pairs (plain, sequence-parallel, ring-overlapped),
  ``gather_output``, ``input_is_parallel=False``, ``skip_bias_add`` and
  the embedding: values and every grad, the Row bias's full grad on each
  copy; each layer's ``init`` giving the tp = 1 weights cut up;
- ``all_gather_matmul`` and ``matmul_reduce_scatter`` forward and
  backward, ``partial_add``'s grad, and the overlapped pair against the
  fused one bit for bit at tp 2 in fp32;
- vocab-parallel cross-entropy with and without smoothing;
- ``broadcast_data`` (float, int, bool; a ``datatype`` cast);
- the memory buffers (no ranks: they hold no collective).

fp32 throughout. Limits: 1e-6 absolute on values and grads of magnitude
up to ~10 (gloo's ring adds the ranks' terms in another order than XLA's
``psum``: a few ulps), 1e-5 where a ring primitive's grads sum a
sequence of products, the cross-entropy's 1e-5 of ``tests/
test_torch_tp1.py``; the broadcast exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from apex_tpu.transformer import context_parallel as jcp
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.tensor_parallel import memory as jmem
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch.transformer.tensor_parallel import memory as tmem

TOL = 1e-6
TOL_CE = 1e-5
WORLDS = [2, 4]
VAR = P("tensor")   # a leaf stacked by rank on axis 0


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]), ("tensor",))


def _sm(fn, tp, in_specs, out_specs):
    return shard_map(fn, mesh=_mesh(tp), in_specs=in_specs,
                     out_specs=out_specs)


def _local(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _stacked(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


# -- the mappings -------------------------------------------------------------

def _mapping_inputs(tp, rng):
    b, s, n = 2, 4 * tp, 3 * tp
    inputs, seeds = {}, {}
    shapes = {"copy": (b, s, n), "reduce": (b, s, n), "scatter": (b, s, n),
              "gather": (b, s, 3), "sp_scatter": (b, s, n),
              "sp_gather": (b, 4, n), "sp_gather_invariant": (b, 4, n),
              "sp_reduce_scatter": (b, s, n)}
    out_shapes = {"copy": (b, s, n), "reduce": (b, s, n),
                  "scatter": (b, s, 3), "gather": (b, s, 3 * tp),
                  "sp_scatter": (b, 4, n), "sp_gather": (b, s, n),
                  "sp_gather_invariant": (b, s, n),
                  "sp_reduce_scatter": (b, 4, n)}
    for name, (stacked_in, stacked_seed) in R.MAPPINGS.items():
        shape = shapes[name]
        inputs[name] = rng.randn(*((tp,) + shape if stacked_in
                                   else shape)).astype(np.float32)
        oshape = out_shapes[name]
        seeds[name] = rng.randn(*((tp,) + oshape if stacked_seed
                                  else oshape)).astype(np.float32)
    return inputs, seeds


def _jax_mappings(tp, inputs, seeds):
    fns = {
        "copy": jtp.copy_to_tensor_model_parallel_region,
        "reduce": jtp.reduce_from_tensor_model_parallel_region,
        "scatter": jtp.scatter_to_tensor_model_parallel_region,
        "gather": jtp.gather_from_tensor_model_parallel_region,
        "sp_scatter": lambda x: jcp.scatter_to_sequence_parallel_region(
            x, "tensor", seq_axis=1),
        "sp_gather": lambda x: jcp.gather_from_sequence_parallel_region(
            x, "tensor", seq_axis=1),
        "sp_gather_invariant": lambda x:
            jcp.gather_from_sequence_parallel_region(
                x, "tensor", seq_axis=1, invariant=True),
        "sp_reduce_scatter": lambda x:
            jcp.reduce_scatter_to_sequence_parallel_region(
                x, "tensor", seq_axis=1),
    }
    in_specs = ({k: VAR if R.MAPPINGS[k][0] else P() for k in inputs},
                {k: VAR if R.MAPPINGS[k][1] else P() for k in seeds})

    def inner(xs, sd):
        # a varying output's objective sums over the ranks; a replicated
        # one's is counted once (pmean of equal values)
        total, outs = 0.0, {}
        for name, fn in fns.items():
            x = xs[name][0] if R.MAPPINGS[name][0] else xs[name]
            seed = sd[name][0] if R.MAPPINGS[name][1] else sd[name]
            out = fn(x)
            red = jax.lax.psum if R.MAPPINGS[name][1] else jax.lax.pmean
            total = total + red(jnp.sum(out * seed), "tensor")
            outs[name] = out[None]
        return total, outs

    def loss(xs, sd):
        total, outs = _sm(inner, tp, in_specs,
                          (P(), {k: VAR for k in fns}))(xs, sd)
        return total, outs

    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        inputs, seeds)
    return outs, grads


@pytest.mark.parametrize("tp", WORLDS)
def test_mappings_and_sp_regions_match_jax(pools, tp):
    inputs, seeds = _mapping_inputs(tp, np.random.RandomState(tp))
    j_outs, j_grads = _jax_mappings(tp, inputs, seeds)
    outs = pools.run(tp, R.mappings, tp, inputs, seeds)
    for r, (out, grads) in enumerate(outs):
        for name in R.MAPPINGS:
            _close(out[name], np.asarray(j_outs[name])[r])
            want = np.asarray(j_grads[name])
            _close(grads[name], want[r] if R.MAPPINGS[name][0] else want)


@pytest.mark.parametrize("tp", WORLDS)
def test_mappings_refuse_indivisible_dims(pools, tp):
    texts = pools.run(tp, R.refusals, tp)
    for scatter, sp, ring in texts:
        assert "not divisible" in scatter and "last dim" in scatter
        assert "not divisible" in sp
        assert "not divisible" in ring


def test_regions_need_an_installed_mesh():
    from apex_tpu_torch.transformer import tensor_parallel as tpm
    from apex_tpu_torch.transformer.context_parallel import (
        gather_from_sequence_parallel_region)
    with pytest.raises(ValueError, match="not bound"):
        tpm.copy_to_tensor_model_parallel_region(torch.ones(2))
    with pytest.raises(ValueError, match="not bound"):
        gather_from_sequence_parallel_region(torch.ones(2, 2), "tensor", 1)


# -- the layers ---------------------------------------------------------------

def _pair_params(tp, h, seed=0):
    col = jtp.ColumnParallelLinear(h, 2 * h, gather_output=False,
                                   world_size=tp)
    row = jtp.RowParallelLinear(2 * h, h, input_is_parallel=True,
                                world_size=tp)
    cp = col.init(jax.random.PRNGKey(seed))
    rp = row.init(jax.random.PRNGKey(seed + 1))
    rng = np.random.RandomState(seed)
    cp["bias"] = cp["bias"] + jnp.asarray(
        rng.randn(*cp["bias"].shape), jnp.float32) * 0.1
    # every rank's bias copy the same value, as init makes them
    rp["bias"] = rp["bias"] + jnp.asarray(rng.randn(h), jnp.float32)
    return (jax.tree_util.tree_map(np.asarray, cp),
            jax.tree_util.tree_map(np.asarray, rp))


def _jax_pair(tp, mode, cp, rp, x, dy, h):
    sp, ov = mode != "plain", mode == "overlap"
    kw = dict(world_size=tp, sequence_parallel=sp, seq_axis=1,
              tp_comm_overlap=ov)
    col = jtp.ColumnParallelLinear(h, 2 * h, gather_output=False, **kw)
    row = jtp.RowParallelLinear(2 * h, h, input_is_parallel=True, **kw)
    specs = {"weight": VAR, "bias": VAR}
    xspec = P(None, "tensor", None) if sp else P()

    def inner(cp, rp, x, dy):
        y, _ = col(cp, x)
        out, _ = row(rp, y)
        red = jax.lax.psum if sp else jax.lax.pmean
        return red(jnp.sum(out * dy), "tensor"), out

    def loss(cp, rp, x, dy):
        return _sm(inner, tp, (specs, specs, xspec, xspec),
                   (P(), xspec))(cp, rp, x, dy)

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(cp, rp, x, dy)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("tp", WORLDS)
@pytest.mark.parametrize("mode", ["plain", "sp", "overlap"])
def test_column_row_pair_matches_jax(pools, tp, mode):
    h, b, s = 8, 2, 4 * tp
    cp, rp = _pair_params(tp, h)
    rng = np.random.RandomState(tp)
    x = rng.randn(b, s, h).astype(np.float32)
    dy = rng.randn(b, s, h).astype(np.float32)
    j_out, (g_col, g_row, g_x) = _jax_pair(tp, mode, cp, rp, x, dy, h)
    sp = mode != "plain"
    shard = (lambda a: np.stack(np.split(a, tp, axis=1))) if sp else (
        lambda a: a)
    outs = pools.run(tp, R.layer_pair, tp, mode, cp, rp, shard(x),
                     shard(dy), h)
    for r, (out, g) in enumerate(outs):
        _close(out, shard(j_out)[r] if sp else j_out)
        _close(g["x"], shard(g_x)[r] if sp else g_x)
        _close(g["col_w"], g_col["weight"][r])
        _close(g["col_b"], g_col["bias"][r])
        _close(g["row_w"], g_row["weight"][r])
        # each bias copy gets the full gradient: the sum of dy over the
        # positions (a tp-th of it would be the naked fold's)
        _close(g["row_b"], g_row["bias"][r])
        _close(g["row_b"], dy.sum(axis=(0, 1)), tol=1e-5)


@pytest.mark.parametrize("tp", WORLDS)
def test_gathered_column_scattered_row_and_skip_bias_match_jax(pools, tp):
    h_in, h_out = 4 * tp, 4 * tp
    rng = np.random.RandomState(10 + tp)
    col = jtp.ColumnParallelLinear(h_in, h_out, gather_output=True,
                                   world_size=tp)
    row = jtp.RowParallelLinear(h_in, h_out, input_is_parallel=False,
                                world_size=tp)
    cp = jax.tree_util.tree_map(np.asarray, col.init(jax.random.PRNGKey(3)))
    rp = jax.tree_util.tree_map(np.asarray, row.init(jax.random.PRNGKey(4)))
    cp["bias"] = rng.randn(*cp["bias"].shape).astype(np.float32)
    rp["bias"] = np.tile(rng.randn(h_out).astype(np.float32), (tp, 1))
    x = rng.randn(2, 5, h_in).astype(np.float32)
    dyc = rng.randn(2, 5, h_out).astype(np.float32)
    dyr = rng.randn(2, 5, h_out).astype(np.float32)
    skip = jtp.ColumnParallelLinear(h_in, h_out, gather_output=True,
                                    skip_bias_add=True, world_size=tp)
    specs = {"weight": VAR, "bias": VAR}

    def inner(cp, rp, xc, xr):
        yc, _ = col(cp, xc)
        yr, _ = row(rp, xr)
        ys, bias = skip(cp, xc)
        total = jnp.sum(yc * dyc) + jnp.sum(yr * dyr)
        # the gathered outputs are typed varying: out by rank
        return jax.lax.pmean(total, "tensor"), _stacked((yc, yr, ys, bias))

    def loss(cp, rp, xc, xr):
        return _sm(inner, tp, (specs, specs, P(), P()),
                   (P(), (VAR,) * 4))(cp, rp, xc, xr)

    (_, (yc, yr, ys, bias)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(cp, rp, x, x)
    g_col, g_row, g_xc, g_xr = grads
    outs = pools.run(tp, R.layer_gathered, tp, cp, rp, x, dyc, dyr)
    for r, o in enumerate(outs):
        _close(o["col"], np.asarray(yc)[r])
        _close(o["row"], np.asarray(yr)[r])
        _close(o["skip"], np.asarray(ys)[r])
        _close(o["skip_bias"], np.asarray(bias)[r])
        _close(o["x_col"], g_xc)
        _close(o["x_row"], g_xr)
        _close(o["col_w"], np.asarray(g_col["weight"])[r])
        _close(o["col_b"], np.asarray(g_col["bias"])[r])
        _close(o["row_w"], np.asarray(g_row["weight"])[r])
        _close(o["row_b"], np.asarray(g_row["bias"])[r])


@pytest.mark.parametrize("tp", WORLDS)
def test_vocab_parallel_embedding_matches_jax(pools, tp):
    vocab, h = 16 * tp, 8
    emb = jtp.VocabParallelEmbedding(vocab, h, world_size=tp)
    w = np.asarray(emb.init(jax.random.PRNGKey(5))["weight"])
    rng = np.random.RandomState(tp)
    ids = rng.randint(0, vocab, (3, 7))
    dy = rng.randn(3, 7, h).astype(np.float32)

    def inner(p, ids):
        out = emb({"weight": p}, ids)
        return jnp.sum(out * dy), out

    def loss(p, ids):
        return _sm(inner, tp, (VAR, P()), (P(), P()))(p, ids)

    (_, j_out), j_grad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(w, jnp.asarray(ids))
    outs = pools.run(tp, R.embedding, tp, w, ids, dy)
    for r, (out, grad) in enumerate(outs):
        _close(out, j_out)
        _close(grad, np.asarray(j_grad)[r])


@pytest.mark.parametrize("tp", WORLDS)
def test_init_gives_the_tp1_weights_cut_up(pools, tp):
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    out_size, in_size, vocab = 4 * tp, 8 * tp, 16 * tp
    whole = {}
    for name, layer in (
            ("col", ColumnParallelLinear(in_size, out_size, device="cpu")),
            ("row", RowParallelLinear(in_size, out_size, device="cpu")),
            ("emb", VocabParallelEmbedding(vocab, in_size, device="cpu"))):
        layer.init(torch.Generator().manual_seed(7))
        whole[name] = layer.weight.detach().numpy()
    shards = pools.run(tp, R.init_shards, tp, out_size, in_size, vocab, 7)
    for dim, name in ((0, "col"), (1, "row"), (0, "emb")):
        np.testing.assert_array_equal(
            np.concatenate([s[name] for s in shards], axis=dim),
            whole[name])


# -- the ring collective matmuls ----------------------------------------------

@pytest.mark.parametrize("tp", WORLDS)
def test_ring_primitives_match_jax(pools, tp):
    rng = np.random.RandomState(20 + tp)
    b, s_loc, din, dout = 2, 3, 8, 8
    x_ag = rng.randn(tp, b, s_loc, din).astype(np.float32)
    w_ag = rng.randn(tp, dout // 2, din).astype(np.float32)
    dy_ag = rng.randn(tp, b, tp * s_loc, dout // 2).astype(np.float32)
    x_rs = rng.randn(tp, b, tp * s_loc, din // 2).astype(np.float32)
    w_rs = rng.randn(tp, dout, din // 2).astype(np.float32)
    add = rng.randn(dout).astype(np.float32)
    dy_rs = rng.randn(tp, b, s_loc, dout).astype(np.float32)

    def inner(xa, wa, da, xr, wr, a, dr):
        ya = jtp.all_gather_matmul(xa[0], wa[0], "tensor", 1)
        yr = jtp.matmul_reduce_scatter(xr[0], wr[0], a, "tensor", 1)
        total = jnp.sum(ya * da[0]) + jnp.sum(yr * dr[0])
        return jax.lax.psum(total, "tensor"), (ya[None], yr[None])

    def loss(xa, wa, xr, wr, a):
        return _sm(inner, tp, (VAR, VAR, VAR, VAR, VAR, P(), VAR),
                   (P(), (VAR, VAR)))(xa, wa, dy_ag, xr, wr, a, dy_rs)

    (_, (ya, yr)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            x_ag, w_ag, x_rs, w_rs, add)
    g_xa, g_wa, g_xr, g_wr, g_add = (np.asarray(g) for g in grads)
    outs = pools.run(tp, R.ring_primitives, tp, x_ag, w_ag, dy_ag, x_rs,
                     w_rs, add, dy_rs)
    for r, o in enumerate(outs):
        _close(o["ag"], np.asarray(ya)[r])
        _close(o["rs"], np.asarray(yr)[r], tol=1e-5)
        _close(o["ag_x"], g_xa[r], tol=1e-5)
        _close(o["ag_w"], g_wa[r], tol=1e-5)
        _close(o["rs_x"], g_xr[r], tol=1e-5)
        _close(o["rs_w"], g_wr[r], tol=1e-5)
        # partial_add's grad: the full-sequence sum of dy on every rank;
        # JAX's is the total over the ranks' identical terms
        _close(o["rs_add"], g_add / tp, tol=1e-5)


def test_overlap_pair_equals_the_fused_pair_bit_for_bit(pools):
    tp, h, b, s = 2, 16, 2, 8
    cp, rp = _pair_params(tp, h, seed=5)
    rng = np.random.RandomState(5)
    x = np.stack(np.split(rng.randn(b, s, h).astype(np.float32), tp, 1))
    dy = np.stack(np.split(rng.randn(b, s, h).astype(np.float32), tp, 1))
    same = pools.run(tp, R.ring_against_fused, tp, x, cp, rp, dy, h)
    for r, flags in enumerate(same):
        assert all(flags.values()), (r, flags)


# -- cross-entropy, broadcast, buffers ----------------------------------------

@pytest.mark.parametrize("tp", WORLDS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(pools, tp, smoothing):
    rng = np.random.RandomState(30 + tp)
    vocab = 8 * tp
    logits = (rng.randn(3, 5, vocab) * 3).astype(np.float32)
    target = rng.randint(0, vocab, (3, 5))
    weight = rng.randn(3, 5).astype(np.float32)
    stacked = np.stack(np.split(logits, tp, axis=-1))

    def inner(lg, t):
        loss = jtp.vocab_parallel_cross_entropy(lg[0], t, smoothing)
        return jnp.sum(loss * weight), loss

    def total(lg, t):
        return _sm(inner, tp, (VAR, P()), (P(), P()))(lg, t)

    (_, j_loss), j_grad = jax.jit(jax.value_and_grad(
        total, has_aux=True))(stacked, jnp.asarray(target))
    outs = pools.run(tp, R.cross_entropy, tp, stacked, target, weight,
                     smoothing)
    for r, (loss, grad) in enumerate(outs):
        _close(loss, j_loss, TOL_CE)
        _close(grad, np.asarray(j_grad)[r], TOL_CE)


@pytest.mark.parametrize("tp", WORLDS)
@pytest.mark.parametrize("datatype", [None, "float32"])
def test_broadcast_data_matches_jax(pools, tp, datatype):
    rng = np.random.RandomState(tp)
    data = {"tokens": rng.randint(0, 100, (tp, 2, 5)),
            "mask": rng.rand(tp, 2, 5) > 0.5,
            "weights": rng.randn(tp, 3).astype(np.float32)}
    jdt = None if datatype is None else getattr(jnp, datatype)

    def inner(d):
        out = jtp.broadcast_data(sorted(d), _local(d), jdt)
        return _stacked(out)

    j_out = jax.jit(_sm(inner, tp, ({k: VAR for k in data},),
                        {k: VAR for k in data}))(data)
    outs = pools.run(tp, R.broadcast, tp, data, datatype)
    for r, got in enumerate(outs):
        for k in data:
            value, dtype = got[k]
            want = np.asarray(j_out[k])[r]
            np.testing.assert_array_equal(value, want.astype(value.dtype))
            np.testing.assert_array_equal(value, np.asarray(
                data[k][0], want.dtype).astype(value.dtype))
            # JAX's ints are int32 (no x64), the port keeps int64
            kind = {"bool": "bool", "float32": "float32"}
            assert dtype == "torch." + kind.get(str(want.dtype), "int64")


def test_memory_buffers_match_jax():
    buf = tmem.allocate_mem_buff("acts", 24, torch.float32, device="cpu")
    ref = jmem.allocate_mem_buff("acts", 24, jnp.float32)
    a = buf.add((2, 3))
    assert tuple(a.shape) == np.asarray(ref.add((2, 3))).shape
    assert torch.equal(a, torch.zeros(2, 3))
    # a view of the flat buffer, zero-filled again when handed out
    a.fill_(5.0)
    assert torch.equal(buf.get_data()[:6], torch.full((6,), 5.0))
    assert buf.numel_in_use() == ref.numel_in_use() == 6
    assert buf.is_in_use() and ref.is_in_use()
    with pytest.raises(RuntimeError, match="overflow"):
        buf.add((5, 4))
    with pytest.raises(RuntimeError, match="overflow"):
        ref.add((5, 4))
    buf.reset()
    ref.reset()
    assert not buf.is_in_use() and not ref.is_in_use()
    assert torch.equal(buf.add((6,)), torch.zeros(6))
    ring = tmem.RingMemBuffer("ring", 3, 8, torch.bfloat16, device="cpu")
    jring = jmem.RingMemBuffer("ring", 3, 8, jnp.bfloat16)
    got = [ring.get_next_buffer() for _ in range(4)]
    want = [jring.get_next_buffer() for _ in range(4)]
    assert [b.name for b in got] == [b.name for b in want]
    assert got[3] is got[0] and not got[0].is_in_use()
    assert got[1].add((8,)).dtype == torch.bfloat16
    if not torch.cuda.is_available():   # the card by default
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmem.MemoryBuffer("card", 4, torch.float32)
