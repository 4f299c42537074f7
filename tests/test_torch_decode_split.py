"""The position split of the port's ``decode_attention`` kernel, on the CPU.

``csrc/decode_attention.cu`` splits each slot-head's live prefix
``[0, len)`` over ``_kernels.decode_splits(n, T, q_len)`` blocks: block
``c`` takes ``[c * ceil(len / S), ...)``, writes its fp32 partial ``(m, l,
acc)`` (``m = -1e30``, ``l = 0``, ``acc = 0`` for a chunk with no
position), and the last block to arrive merges the ``S`` partials in the
fixed order ``c = 0 .. S - 1`` with the two-way logsumexp merge. A CUDA
kernel cannot run here, so :func:`_split_model` mirrors those chunk bounds
and that merge in torch, and is held against the port's plain twin
``_decode_plain`` and the JAX package's ``_decode_kernel`` (its Pallas call
in interpret mode, as ``tests/test_torch_decode_attention.py`` runs it) on
the same inputs from numpy.

Tolerances: fp32 1e-5 absolute on out and lse (the chunks' sums and the
merge add the same terms in another order); an empty prefix gives out 0
and lse -inf exactly, in all three.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
pcache = importlib.import_module("apex_tpu_torch.serving.cache")

H, T, D = 2, 256, 64
NEG_INF = -1e30        # csrc/common.cuh::kNegInf, an empty chunk's m
TOL = 1e-5


def _chunks(length: int, splits: int):
    """The kernel's chunk bounds: block ``c`` of a slot-head whose cursor
    is ``length`` takes ``[begin, end)``."""
    chunk = -(-length // splits)
    bounds = []
    for c in range(splits):
        begin = min(length, c * chunk)
        bounds.append((begin, min(length, begin + chunk)))
    return bounds


def _split_model(q, k, v, lengths, k_scale=None, v_scale=None, scale=None):
    """The kernel's arithmetic on its layout, in fp32: ``q (n, q_len,
    d)``, ``k``/``v`` ``(n, T, d)``, ``lengths (n,)`` -> ``(out, lse)``."""
    n, q_len, d = q.shape
    t_max = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    splits = _kernels.decode_splits(n, t_max, q_len)
    quantized = k.dtype == torch.int8
    kd = pfa._dequant(k, k_scale) if quantized else k.float()
    vd = pfa._dequant(v, v_scale) if quantized else v.float()
    out = torch.zeros(n, q_len, d)
    lse = torch.full((n, q_len), -math.inf)
    for i in range(n):
        length = max(0, min(int(lengths[i]), t_max))
        out[i], lse[i] = _merge([
            _partial(q[i], kd[i, begin:end], vd[i, begin:end], scale)
            for begin, end in _chunks(length, splits)])
    return out.to(q.dtype), lse


def _partial(q, k, v, scale):
    """One chunk's fp32 partial ``(m, l, acc)`` of ``q (q_len, d)`` over
    its keys and values ``(len, d)``: ``(-1e30, 0, 0)`` with none."""
    q_len, d = q.shape
    if not len(k):
        return (torch.full((q_len,), NEG_INF), torch.zeros(q_len),
                torch.zeros(q_len, d))
    s = (q.float() @ k.T) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=-1), p @ v


def _merge(parts):
    """The chunks' partials merged in the fixed order ``c = 0 .. S - 1``
    -> ``(out (q_len, d), lse (q_len,))``: out 0 and lse -inf where no
    chunk holds a position."""
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    tot_l = torch.zeros_like(mx)
    tot_acc = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        a = torch.exp(m - mx)
        tot_l = tot_l + l * a
        tot_acc = tot_acc + acc * a[:, None]
    empty = tot_l == 0
    safe_l = torch.where(empty, 1.0, tot_l)
    return (torch.where(empty[:, None], 0.0, tot_acc / safe_l[:, None]),
            torch.where(empty, -math.inf, mx + torch.log(safe_l)))


# cursors of the five slots: 0, 1, one under S, one S does not divide, T
CURSORS = np.array([0, 1, 3, 103, T], np.int32)


def _inputs(seed: int, q_len: int, cache: str):
    rng = np.random.RandomState(seed)
    b = len(CURSORS)
    n = b * H
    q = rng.randn(n, q_len, D).astype(np.float32)
    kf = rng.randn(n, T, D).astype(np.float32)
    vf = rng.randn(n, T, D).astype(np.float32)
    lengths = np.repeat(CURSORS, H)
    if cache == "int8":
        kq, ks = pcache._quantize(torch.from_numpy(kf))
        vq, vs = pcache._quantize(torch.from_numpy(vf))
        return q, (kq, vq, ks, vs), lengths
    return q, (torch.from_numpy(kf), torch.from_numpy(vf), None, None), \
        lengths


def test_cursors_cover_the_split_cases():
    """The test's cursors hit every case of the chunk bounds: an empty
    prefix, one position, fewer positions than chunks (empty chunks after
    full ones), a length the split does not divide, and the whole cache."""
    splits = _kernels.decode_splits(len(CURSORS) * H, T, 1)
    assert splits == 4
    assert 1 < CURSORS[2] < splits and CURSORS[3] % splits
    for length in CURSORS:
        chunks = _chunks(int(length), splits)
        assert chunks[0][0] == 0 and chunks[-1][1] == length
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(e - b <= -(-length // splits) for b, e in chunks)
    assert _chunks(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]


@pytest.mark.parametrize("q_len", [1, 4, 9])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_split_merge_matches_plain_and_jax_kernel(cache, q_len):
    q, (k, v, ks, vs), lengths = _inputs(10 + q_len, q_len, cache)
    tq = torch.from_numpy(q)
    tl = torch.from_numpy(lengths)
    out, lse = _split_model(tq, k, v, tl, ks, vs)
    p_out, p_lse = pfa._decode_plain(tq, k, v, tl, ks, vs)
    np.testing.assert_allclose(out.numpy(), p_out.numpy(), atol=TOL)
    empty = lengths == 0
    for got in (lse.numpy(), p_lse.numpy()):
        assert np.all(got[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], p_lse.numpy()[~empty],
                               atol=TOL)
    assert np.all(out.numpy()[empty] == 0)

    sc = ((jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())) if ks is not None
          else (None, None))
    j_out, j_lse = jfa._decode_pallas(
        jnp.asarray(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(lengths), *sc, scale=D ** -0.5, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL)
    j_lse = np.asarray(j_lse)[..., 0]
    assert np.all(j_lse[empty] == -np.inf)
    np.testing.assert_allclose(lse.numpy()[~empty], j_lse[~empty], atol=TOL)


@pytest.mark.parametrize("q_len", [1, 4, 9])
def test_split_merge_bf16_query(q_len):
    """A bf16 query over a bf16 cache: the model rounds its output to bf16
    once, at the end, as the kernel's merge does; held to the plain twin
    within one bf16 ulp (2**-7 relative) plus 1e-3."""
    rng = np.random.RandomState(30 + q_len)
    n = len(CURSORS) * H
    q, k, v = (torch.from_numpy(rng.randn(n, s, D).astype(np.float32))
               .to(torch.bfloat16) for s in (q_len, T, T))
    lengths = torch.from_numpy(np.repeat(CURSORS, H))
    out, lse = _split_model(q, k, v, lengths)
    p_out, p_lse = pfa._decode_plain(q, k, v, lengths)
    assert out.dtype == torch.bfloat16
    diff = (out.float() - p_out.float()).abs()
    assert bool((diff <= 1e-3 + 2 ** -7 * p_out.float().abs()).all())
    fin = torch.isfinite(p_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert float((lse[fin] - p_lse[fin]).abs().max()) <= TOL


@pytest.mark.parametrize("n,t_max,q_len,want", [
    (96, 1024, 1, 4),     # the dense serving path: 8 slots x 12 heads
    (12, 1024, 1, 16),    # one slot: chunks of 64
    (96, 1024, 9, 4),
    (16, 256, 9, 4),      # chip_smoke's q_len 9 case
    (10, 256, 1, 4),      # this file's inputs
    (4, 200, 1, 3),       # under 256 positions, raised to fill the card
    (4, 63, 1, 1),        # under 64 positions: one chunk
])
def test_decode_splits(n, t_max, q_len, want):
    """Chunks of about 256 positions, more blocks up to two waves of the
    132 SMs where the grid is small, never a chunk under 64 positions."""
    splits = _kernels.decode_splits(n, t_max, q_len)
    assert splits == want
    assert splits == 1 or t_max / splits >= 64
    groups = n if q_len == 1 else n * -(-q_len // 4)  # row groups of 4
    if splits > -(-t_max // 256):     # raised to fill the card
        assert groups * (splits - 1) < 2 * 132


@pytest.mark.parametrize("length,splits,want", [
    (0, 4, [(0, 0)] * 4),
    (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),     # empty chunks after full
    (65, 16, [(5 * c, 5 * c + 5) for c in range(13)] + [(65, 65)] * 3),
    (144, 4, [(0, 36), (36, 72), (72, 108), (108, 144)]),  # a serving cursor
    (17, 4, [(0, 5), (5, 10), (10, 15), (15, 17)]),        # and its shortest
    (1024, 16, [(64 * c, 64 * c + 64) for c in range(16)]),
])
def test_chunk_bounds(length, splits, want):
    """Every block takes an equal share ``ceil(len / S)`` of the live
    prefix, the last ones what is left (possibly nothing), also at the
    dense serving path's short cursors (``chip_smoke.py::SERVE_CURSORS``),
    where no floor of live positions a chunk applies: the chunks cover
    ``[0, len)`` in order."""
    got = _chunks(length, splits)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
