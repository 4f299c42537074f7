"""The segment-id tile-skip predicate of the tensor-core flash kernels, on
the CPU.

``flash_fwd`` and ``flash_bwd_dkv`` in bf16 skip a (q tile, key tile) pair
whose per-64-position id ranges are disjoint
(``apex_tpu_torch/csrc/mma.cuh::tiles_meet``); the same predicate in
Python is ``apex_tpu_torch.ops.flash_attention._tiles_meet``, over the
ranges ``apex_tpu_torch._kernels.seg_tile_ranges`` gives the kernels.
Skipping is exact only if no skipped pair holds a visible score. Held
here:

- every (row, col) that the JAX package's ``mha_reference`` leaves visible
  lies in a tile pair the predicate keeps, for random, packed,
  non-monotone and ragged-length ids, causal and not, sq != sk (visible
  means a positive probability: with q = k = 0 every visible score of a
  row gets ``1 / count`` and every masked one 0, and v = I reads them
  out);
- the plain path (out, dq, dk, dv and a learned bias's gradient) with the
  skipped pairs also masked equals the plain path without, bit for bit;
- on the long-context path's ids (``chip_smoke.py::long_inputs``: four
  packed documents in each of 8 rows of 4096, ``RandomState(0)`` after
  q, k, v and dy), the kernels compute 7283 of the 16640 causal tile
  pairs (0.4377), beside the 0.4038 of causal pairs the ids leave
  visible.

The bf16 ``flash_bwd_dq`` body walks, for each 64-row q tile, the key
tiles from 0 to the causal diagonal (offset ``sk - sq``), skips those whose
ids never meet the q tile's, and within a visited tile skips a warp's 16
rows when they lie past ``sq`` or above the whole tile
(``csrc/flash_bwd.cu::flash_bwd_dq_mma_kernel``). :func:`_dq_computed`
models that loop; every score ``mha_reference`` leaves visible must lie in
what it computes, at the shapes above and at the cross, ragged and
fully masked shapes of ``chip_smoke.py::check_flash_train``.

Beside it, the wrappers' alignment rule for the bf16 (tensor-core)
inputs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TILE = _kernels.ID_TILE


def _packed(rng, b: int, s: int, docs: int = 4) -> np.ndarray:
    """``chip_smoke.py::packed_ids``' recipe: ids counting up at ``docs -
    1`` cut points a row."""
    ids = np.zeros((b, s), np.int32)
    for row in range(b):
        for cut in rng.choice(np.arange(1, s), docs - 1, replace=False):
            ids[row, cut:] += 1
    return ids


def _ids(kind: str, rng, b: int, s: int) -> np.ndarray:
    if kind == "random":              # few ids, scattered
        return rng.randint(0, 3, size=(b, s)).astype(np.int32)
    if kind == "packed":
        return _packed(rng, b, s)
    if kind == "non-monotone":        # packed runs whose ids jump around
        perm = rng.permutation(8).astype(np.int32)
        return perm[_packed(rng, b, s, docs=6)]
    # ragged: packed, then a padding id past a random length per row
    ids = _packed(rng, b, s, docs=3)
    for row in range(b):
        ids[row, rng.randint(s // 2, s):] = 99
    return ids


def _visible_jax(q_ids, kv_ids, causal: bool) -> np.ndarray:
    """``(b, sq, sk)`` bool: the scores ``mha_reference`` leaves visible."""
    b, sq = q_ids.shape
    sk = kv_ids.shape[1]
    q = jnp.zeros((b, 1, sq, sk), jnp.float32)
    k = jnp.zeros((b, 1, sk, sk), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(sk, dtype=jnp.float32), (b, 1, sk, sk))
    p = jfa.mha_reference(q, k, v, causal=causal,
                          segment_ids=(jnp.asarray(q_ids),
                                       jnp.asarray(kv_ids)))
    return np.asarray(p)[:, 0] > 0


def _kept(q_ids, kv_ids, sq: int, sk: int) -> torch.Tensor:
    """``(b, sq, sk)`` bool: the scores in tile pairs the kernels keep."""
    meet = pfa._tiles_meet(q_ids, kv_ids)
    rows = torch.arange(sq) // TILE
    cols = torch.arange(sk) // TILE
    return meet[:, rows][:, :, cols]


SHAPES = [(128, 128), (100, 200), (200, 130), (256, 320)]


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["random", "packed", "non-monotone",
                                  "ragged"])
def test_visible_scores_lie_in_kept_tile_pairs(kind, causal, sq, sk):
    rng = np.random.RandomState(sq + 3 * sk + 7 * causal + len(kind))
    b = 3
    kv_ids = _ids(kind, rng, b, sk)
    q_ids = kv_ids if sq == sk else _ids(kind, rng, b, sq)
    visible = _visible_jax(q_ids, kv_ids, causal)
    kept = _kept(torch.from_numpy(q_ids), torch.from_numpy(kv_ids), sq,
                 sk).numpy()
    assert visible.any()
    assert not (visible & ~kept).any()


def _dq_computed(q_ids, kv_ids, sq: int, sk: int,
                 causal: bool) -> np.ndarray:
    """``(b, sq, sk)`` bool: the scores the bf16 dq body computes. Per q
    tile, key tiles ``0 .. ceil(kv_end / 64)`` with ``kv_end = min(sk, q0
    + 64 + sk - sq)`` under the causal mask (none if it is not positive),
    those whose id ranges meet the q tile's (all without ids); in each, a
    warp's 16 rows unless they start past ``sq`` or every one of them lies
    above the tile (``j0 > w0 + 15 + offset``)."""
    b = 1 if q_ids is None else q_ids.shape[0]
    offset = sk - sq
    meet = (None if q_ids is None else
            pfa._tiles_meet(torch.from_numpy(q_ids),
                            torch.from_numpy(kv_ids)).numpy())
    out = np.zeros((b, sq, sk), bool)
    for q_tile in range(-(-sq // TILE)):
        q0 = q_tile * TILE
        kv_end = min(sk, q0 + TILE + offset) if causal else sk
        for j in range(-(-kv_end // TILE) if kv_end > 0 else 0):
            j0 = j * TILE
            for w0 in range(q0, q0 + TILE, 16):
                if w0 >= sq or (causal and j0 > w0 + 15 + offset):
                    continue
                keep = (np.ones(b, bool) if meet is None
                        else meet[:, q_tile, j])
                out[keep, w0:w0 + 16, j0:j0 + TILE] = True
    return out


DQ_SHAPES = SHAPES + [(64, 200), (100, 100), (96, 40)]


@pytest.mark.parametrize("sq,sk", DQ_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["none", "packed", "non-monotone",
                                  "ragged"])
def test_dq_loop_visits_every_visible_score(kind, causal, sq, sk):
    """The dq body's key-tile loop (from 0 to the causal diagonal, the
    ragged edges, the id skip) reaches every score ``mha_reference``
    leaves visible."""
    rng = np.random.RandomState(2 * sq + 5 * sk + causal + len(kind))
    b = 2
    if kind == "none":
        q_ids = kv_ids = None
        jq = np.zeros((b, sq), np.int32)
        jk = np.zeros((b, sk), np.int32)
    else:
        kv_ids = _ids(kind, rng, b, sk)
        q_ids = kv_ids if sq == sk else _ids(kind, rng, b, sq)
        jq, jk = q_ids, kv_ids
    visible = _visible_jax(jq, jk, causal)
    computed = _dq_computed(q_ids, kv_ids, sq, sk, causal)
    assert visible.any()
    assert not (visible & ~computed).any()


def test_predicate_mirrors_the_ranges():
    """``_tiles_meet`` is the kernels' test on the ranges they are given:
    a pair meets iff its two (min, max) ranges overlap; a partial last
    tile's range is that of its real positions."""
    ids = torch.tensor([[0] * 70 + [1] * 60 + [3] * 3])
    rng = _kernels.seg_tile_ranges(ids)
    assert rng.dtype == torch.int32
    assert rng.tolist() == [[[0, 0], [0, 1], [1, 3]]]
    q_ids = torch.tensor([[5] * 64 + [2] * 64])
    meet = pfa._tiles_meet(q_ids, ids)
    assert meet.tolist() == [[[False, False, False], [False, False, True]]]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["packed", "non-monotone"])
def test_masking_skipped_pairs_changes_nothing(kind, causal, monkeypatch):
    """The plain path with the skipped tile pairs masked as well gives the
    same out, dq, dk, dv and learned-bias gradient, bit for bit."""
    rng = np.random.RandomState(21 + causal)
    b, h, s, d = 2, 2, 320, 32
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(1, h, 1, s)).astype(np.float32))
    ids = torch.from_numpy(_ids(kind, rng, b, s))
    kept = _kept(ids, ids, s, s)
    assert not kept.all()             # some pair is skipped

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        out = pfa.flash_attention(*leaves[:3], bias=leaves[3], causal=causal,
                                  bias_requires_grad=True, segment_ids=ids,
                                  dropout_rate=0.1, dropout_seed=5,
                                  use_kernel=False)
        out.backward(w)
        return [out.detach()] + [t.grad for t in leaves]

    want = run()
    plain_visible = pfa._visible

    def skipping(n, sq, sk, causal, segments, device):
        valid = plain_visible(n, sq, sk, causal, segments, device)
        q_ids, kv_ids = segments
        nb = q_ids.shape[0]
        keep = _kept(q_ids, kv_ids, sq, sk)[:, None].expand(
            nb, n // nb, sq, sk).reshape(n, sq, sk)
        return valid & keep

    monkeypatch.setattr(pfa, "_visible", skipping)
    got = run()
    for name, g, w_ in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert torch.equal(g, w_), name


def test_long_path_kept_share():
    """The tile pairs the kernels compute on the long-context path's ids:
    the ids drawn as ``chip_smoke.py::long_inputs`` draws them, after
    q, k, v and dy of ``(8, 12, 4096, 64)`` from ``RandomState(0)`` (drawn
    here a batch-head at a time: the same stream)."""
    b, h, s, d = 8, 12, 4096, 64
    rng = np.random.RandomState(0)
    for _ in range(4 * b * h):
        rng.randn(s * d)
    ids = torch.from_numpy(_packed(rng, b, s))
    tiles = s // TILE
    causal = torch.tril(torch.ones(tiles, tiles, dtype=torch.bool))
    kept = int((pfa._tiles_meet(ids, ids) & causal).sum())
    causal_tiles = b * int(causal.sum())
    assert (kept, causal_tiles) == (7283, 16640)
    counts = [np.unique(row, return_counts=True)[1] for row in ids.numpy()]
    visible = h * sum(int((c * (c + 1) // 2).sum()) for c in counts)
    assert visible == 325253232
    assert round(kept / causal_tiles, 4) == 0.4377
    assert round(visible / (b * h * s * (s + 1) // 2), 4) == 0.4038


def test_bf16_inputs_must_be_16_byte_aligned():
    """The tensor-core bodies stage bf16 rows with 16-byte cp.async copies:
    a bf16 input that does not start 16-byte aligned raises (nothing falls
    back); fp32 inputs, which the SIMT bodies take, are not held to it."""
    base = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:2 * 64 * 64].view(2, 64, 64)
    shifted = base[1:1 + 2 * 64 * 64].view(2, 64, 64)
    assert aligned.data_ptr() % 16 == 0
    _kernels._check_aligned("flash_fwd", aligned, aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kernels._check_aligned("flash_fwd", aligned, shifted)
    fp32 = torch.zeros(2 * 64 * 64 + 1)[1:].view(2, 64, 64)
    _kernels._check_aligned("flash_bwd_dkv", fp32)
    with pytest.raises(ValueError, match="flash_bwd_dq: bf16 inputs"):
        _kernels._check_aligned("flash_bwd_dq", aligned, shifted)


@pytest.mark.parametrize("shift", ["q", "k", "v", "do"])
def test_flash_bwd_dq_checks_alignment_before_launch(shift, monkeypatch):
    """``flash_bwd_dq`` holds its bf16 q, k, v and do to the alignment rule
    before it builds or launches anything (the device checks, which need
    the card, are stubbed out here)."""
    monkeypatch.setattr(_kernels, "_check_common", lambda *a: None)

    def no_build():
        raise RuntimeError("reached the build")

    monkeypatch.setattr(_kernels, "build", no_build)
    base = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    tensors = {name: base[:2 * 64 * 64].view(2, 64, 64)
               for name in ("q", "k", "v", "do")}
    stats = (torch.zeros(2, 64), torch.zeros(2, 64))
    with pytest.raises(RuntimeError, match="reached the build"):
        _kernels.flash_bwd_dq(*tensors.values(), *stats, True, 0.125)
    tensors[shift] = base[1:1 + 2 * 64 * 64].view(2, 64, 64)
    with pytest.raises(ValueError, match="flash_bwd_dq: bf16 inputs must"):
        _kernels.flash_bwd_dq(*tensors.values(), *stats, True, 0.125)


def test_kernel_path_computes_tile_ranges_once(monkeypatch):
    """On the kernels, one forward computes the ids' tile ranges once and
    hands the same tensors to ``flash_fwd`` and to the backward's
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the wrappers are replaced by
    their plain twins here, which record what they were given; the
    autograd function is called as ``flash_attention`` calls it on the
    card, on its ``(n, s, d)`` layout)."""
    rng = np.random.RandomState(31)
    b, h, s, d = 2, 2, 192, 32
    q, k, v = (torch.from_numpy(rng.randn(b * h, s, d).astype(np.float32))
               .requires_grad_() for _ in range(3))
    ids = torch.from_numpy(_ids("packed", rng, b, s))
    made, given = [], {}
    real_ranges = _kernels.seg_tile_ranges

    def counted_ranges(t, tile=TILE):
        made.append(real_ranges(t, tile))
        return made[-1]

    def recording(name, plain):
        def run(*args, tile_ranges=None, **kw):
            given[name] = tile_ranges
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(_kernels, "seg_tile_ranges", counted_ranges)
    for name, plain in (("flash_fwd", pfa._flash_fwd_plain),
                        ("flash_bwd_dq", pfa._flash_bwd_dq_plain),
                        ("flash_bwd_dkv", pfa._flash_bwd_dkv_plain)):
        monkeypatch.setattr(_kernels, name, recording(name, plain))
    out = pfa._FlashAttention.apply(q, k, v, None, ids, ids, True,
                                    d ** -0.5, 0.0, None, True, False)
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert len(made) == 2             # the q ids' and the kv ids'
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert len(given[name]) == 2
        assert all(a is b for a, b in zip(given[name], made)), name
    assert torch.equal(made[0], real_ranges(ids))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_given_tile_ranges_must_match_the_ids(bad):
    """Tile ranges a caller passes are held to their ids' shape and to
    int32 before a kernel would read them."""
    ids = torch.zeros(2, 130, dtype=torch.int32)
    good = _kernels.seg_tile_ranges(ids)
    assert tuple(good.shape) == (2, 3, 2)
    ptrs, held = _kernels._rng_args((ids, ids), (good, good))
    assert held[0] is good and ptrs[0] == good.data_ptr()
    wrong = good[:, :2].contiguous() if bad == "shape" else good.long()
    with pytest.raises(ValueError, match="tile ranges"):
        _kernels._rng_args((ids, ids), (good, wrong))
