"""The position split of the port's ``paged_decode_attention`` kernel, on
the CPU.

``csrc/paged_decode_attention.cu`` runs the split body of
``csrc/decode.cuh`` over a block pool: slot-head ``n = slot * heads +
head`` splits its live prefix ``[0, len)`` (``len`` the slot's cursor
clamped to the table's span ``n_table * block_size``) over
``_kernels.decode_splits(n, span, q_len)`` blocks with the chunk bounds and
the fixed-order merge of the dense kernel (``test_torch_decode_split.py``),
and reads position ``t`` of a chunk from pool row ``(tables[slot, j] *
heads + head) * block_size + t - j * block_size``, ``j = t // block_size``
taken by ``FastDiv``'s multiply-high on ``_kernels._fast_div``'s constants.
A CUDA kernel cannot run here, so :func:`_paged_split_model` mirrors that
in torch (recording the table entries each chunk reads) and is held
against the port's plain twin ``_paged_decode_plain`` and the JAX
package's ``_paged_decode_pallas`` in interpret mode on the same numpy
inputs, at block sizes 1, 16, 48 and 128, ``q_len`` 1, 3 and 5, fp32 and
int8 pools, with cursors that leave chunks empty, end chunks inside blocks
and pass the table's span.

Tolerances: fp32 1e-5 absolute on out and lse (the chunks' sums and the
merge add the same terms in another order); an empty prefix gives out 0
and lse -inf exactly, in all three.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels
from test_torch_decode_split import _chunks, _merge, _partial

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pcache = importlib.import_module("apex_tpu_torch.serving.cache")

SLOTS, H, D = 4, 2, 32
TOL = 1e-5
# (block size, table entries a slot): a span of 192 positions (3 chunks a
# slot-head), 256 at 128-token blocks (4 chunks)
TABLES = {1: 192, 16: 12, 48: 4, 128: 2}


def _entry(t, block_size):
    """``t // block_size`` as ``csrc/decode.cuh::FastDiv`` takes it."""
    magic, shift = _kernels._fast_div(block_size)
    return t if magic == 0 else (t * magic >> 32) >> shift


def _paged_split_model(q, k_pool, v_pool, tables, lengths, k_scale=None,
                       v_scale=None, scale=None, reads=None):
    """The kernel's arithmetic on its layout, in fp32: ``q (n, q_len, d)``
    with ``n = slots * heads``, pools ``(num_blocks, heads, block_size,
    d)``, ``tables (slots, n_table)``, ``lengths (slots,)`` -> ``(out,
    lse)``. Each chunk appends ``(slot, len, entries read)`` to ``reads``."""
    n, q_len, d = q.shape
    _, heads, bs, _ = k_pool.shape
    span = tables.shape[1] * bs
    scale = d ** -0.5 if scale is None else scale
    splits = _kernels.decode_splits(n, span, q_len)
    quantized = k_pool.dtype == torch.int8
    out = torch.zeros(n, q_len, d)
    lse = torch.zeros(n, q_len)
    for i in range(n):
        slot, head = divmod(i, heads)
        length = max(0, min(int(lengths[slot]), span))
        parts = []
        for begin, end in _chunks(length, splits):
            t = torch.arange(begin, end)
            j = _entry(t, bs)
            if reads is not None:
                reads.append((slot, length, sorted(set(j.tolist()))))
            blocks = tables[slot].long()[j]
            off = t - j * bs
            kd, vd = k_pool[blocks, head, off].float(), \
                v_pool[blocks, head, off].float()
            if quantized:
                kd = kd * k_scale[blocks, head, off][:, None]
                vd = vd * v_scale[blocks, head, off][:, None]
            parts.append(_partial(q[i], kd, vd, scale))
        out[i], lse[i] = _merge(parts)
    return out.to(q.dtype), lse


def _cursors(span):
    """An empty slot, 2 positions (an empty chunk after full ones), 150
    (chunk edges inside blocks, chunks that cross blocks) and a cursor past
    the table's span."""
    return np.array([0, 2, 150, span + 7], np.int32)


def _inputs(seed, block_size, q_len, pool):
    rng = np.random.RandomState(seed)
    n_table = TABLES[block_size]
    nb = SLOTS * n_table + 3
    q = rng.randn(SLOTS * H, q_len, D).astype(np.float32)
    kf = rng.randn(nb, H, block_size, D).astype(np.float32)
    vf = rng.randn(nb, H, block_size, D).astype(np.float32)
    tables = (rng.permutation(nb - 1)[: SLOTS * n_table] + 1).reshape(
        SLOTS, n_table).astype(np.int32)
    if pool == "int8":
        (kq, ks), (vq, vs) = (pcache._quantize(torch.from_numpy(x))
                              for x in (kf, vf))
        return q, (kq, vq, ks, vs), tables
    return q, (torch.from_numpy(kf), torch.from_numpy(vf), None, None), \
        tables


def test_cursors_cover_the_split_cases():
    """At every block size the cursors give an empty slot, an empty chunk
    after full ones, chunks that start and end inside a block and chunks
    that cross blocks, and a cursor past the span (clamped to it)."""
    for bs, n_table in TABLES.items():
        span = n_table * bs
        splits = _kernels.decode_splits(SLOTS * H, span, 1)
        assert splits == span // 64
        bounds = [_chunks(min(int(c), span), splits)
                  for c in _cursors(span)]
        assert bounds[0] == [(0, 0)] * splits
        assert any(b == e for b, e in bounds[1][1:])
        inner = [(b, e) for b, e in bounds[2] if e > b]
        if bs > 1:
            assert any(b % bs and e % bs for b, e in inner)
        assert any(b // bs != (e - 1) // bs for b, e in inner)
        assert bounds[3][-1][1] == span


@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("q_len", [1, 3, 5])
@pytest.mark.parametrize("block_size", sorted(TABLES))
def test_paged_split_matches_plain_and_jax_kernel(block_size, q_len, pool):
    q, (k, v, ks, vs), tables = _inputs(block_size + q_len, block_size,
                                        q_len, pool)
    span = TABLES[block_size] * block_size
    lengths = _cursors(span)
    tq, tt, tl = (torch.from_numpy(x) for x in (q, tables, lengths))
    reads = []
    out, lse = _paged_split_model(tq, k, v, tt, tl, ks, vs, reads=reads)
    p_out, p_lse = pfa._paged_decode_plain(tq, k, v, tt, tl, ks, vs)
    np.testing.assert_allclose(out.numpy(), p_out.numpy(), atol=TOL)
    empty = np.repeat(lengths == 0, H)
    for got in (lse.numpy(), p_lse.numpy()):
        assert np.all(got[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], p_lse.numpy()[~empty],
                               atol=TOL)
    assert np.all(out.numpy()[empty] == 0)
    # no chunk reads a table entry at or past its slot's ceil(len / bs)
    for slot, length, entries in reads:
        assert all(0 <= j < -(-length // block_size) for j in entries)

    sc = ((jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()))
          if ks is not None else (None, None))
    j_out, j_lse = jfa._paged_decode_pallas(
        jnp.asarray(q.reshape(SLOTS, H, q_len, D)), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(tables), jnp.asarray(lengths),
        *sc, scale=D ** -0.5, mean_context=None)
    j_out = np.asarray(j_out).reshape(SLOTS * H, q_len, D)
    j_lse = np.asarray(j_lse).reshape(SLOTS * H, q_len)
    np.testing.assert_allclose(out.numpy(), j_out, atol=TOL)
    assert np.all(j_lse[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], j_lse[~empty], atol=TOL)


@pytest.mark.parametrize("n,span,q_len,want", [
    (96, 1024, 1, 4),     # the paged serving path: 8 slots x 12 heads,
                          # 8 blocks of 128
    (12, 1024, 1, 16),    # one slot
    (96, 1024, 5, 4),     # verify rows, 2 row groups a slot-head
    (16, 288, 1, 4),      # chip_smoke.py's 48-token blocks
    (8, 140, 2, 2),       # and its 1-token blocks
    (4, 96, 3, 1),        # its head-dim phase: one chunk
])
def test_paged_splits(n, span, q_len, want):
    """The paged kernel takes the dense kernel's split rule over the
    table's span: chunks of about 256 positions, more blocks up to two
    waves of the 132 SMs where the grid is small, never a chunk under 64
    positions."""
    assert _kernels.decode_splits(n, span, q_len) == want


@pytest.mark.parametrize("block_size", [1, 2, 3, 16, 48, 128])
def test_chunk_table_range(block_size):
    """Chunk ``[begin, end)`` reads the table entries ``[begin // bs,
    ceil(end / bs))`` and no other: never one at or past ``ceil(len /
    bs)``; the chunks of a slot-head read its live entries, each chunk's
    a run, in order."""
    for length in range(0, 300, 7):
        live = -(-length // block_size)
        for splits in (1, 2, 3, 4, 7, 16):
            seen = []
            for begin, end in _chunks(length, splits):
                if begin == end:
                    continue
                entries = sorted({_entry(t, block_size)
                                  for t in range(begin, end)})
                assert entries == list(range(begin // block_size,
                                             -(-end // block_size)))
                assert entries[-1] < live
                seen += entries
            assert sorted(set(seen)) == list(range(live))


@pytest.mark.parametrize("divisor", [1, 2, 3, 5, 7, 16, 48, 100, 128, 1000,
                                     (1 << 20) + 3, (1 << 30) + 1])
def test_fast_div(divisor):
    """``csrc/decode.cuh::FastDiv`` on ``_kernels._fast_div``'s constants
    is ``//`` for every position a table can span (below 2**31): near
    each multiple of the divisor and at random."""
    magic, shift = _kernels._fast_div(divisor)
    assert 0 <= magic < 1 << 32 and 0 <= shift < 31
    rng = np.random.RandomState(divisor % 1000)
    mult = np.unique(np.minimum(rng.randint(0, (1 << 31) // divisor + 1,
                                            2000), (1 << 31) // divisor))
    xs = np.concatenate([mult * divisor - 1, mult * divisor,
                         mult * divisor + 1, rng.randint(0, 1 << 31, 2000),
                         np.arange(4096), [(1 << 31) - 1]]).astype(np.int64)
    xs = xs[(xs >= 0) & (xs < 1 << 31)]
    assert np.array_equal(_entry(xs, divisor), xs // divisor)
