"""The folded dbias of the port's flash backward, and ``ln_bwd``'s grid, on
the CPU.

For bf16 inputs and a learned bias without query rows ``(bb, hb, 1, sk)``
the bias's gradient is folded into ``flash_bwd_dkv``'s launch: its
tensor-core body sums each key's score cotangent ``ds`` over the rows of a
batch-head into an ``(n, sk)`` fp32 partial, and a second launch sums the
partials of the batch-heads that share a bias slice in the order
``r = 0..R-1`` of ``_kernels._dbias_split``. ``_fold_model`` is that
arithmetic in plain torch. It is held against ``_flash_dbias_plain`` (the
standalone kernel's twin) and against the JAX package's Pallas
``_dbias_kernel`` (``flash_attention(..., use_pallas=True)`` in interpret
mode, as ``tests/test_torch_flash_dbias.py`` runs it) at the four row
shapes, causal and not, with segment ids and dropout. The route rule
``_kernels.dbias_folds`` is held to its cases, the autograd backward to
the route it picks, and ``_kernels.ln_bwd_ctas`` to its grid.

Inputs come from numpy with a seed, b 2, h 3, s 96-128, d 32-64, scaled as
the JAX dbias test scales them (q, k, v 0.3, bias 0.1). Tolerance: fp32
2e-5 absolute, as ``tests/test_torch_flash_dbias.py`` (dbias values of
magnitude up to ~1, sums of up to 3 x 128 score cotangents in different
orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = 2e-5
B, H = 2, 3
ROW_SHAPES = [(B, H, 1), (1, H, 1), (B, 1, 1), (1, 1, 1)]
RATE, SEED = 0.3, 987654321


def _packed(rng, b: int, s: int, docs: int = 3) -> np.ndarray:
    """``(b, s)`` int32 ids counting up at ``docs - 1`` cut points a row."""
    ids = np.zeros((b, s), np.int32)
    for row in range(b):
        for cut in rng.choice(np.arange(1, s), docs - 1, replace=False):
            ids[row, cut:] += 1
    return ids


def _fold_model(q, k, v, do, lse, delta, causal, scale, rate=0.0, seed=None,
                bias=None, segments=None):
    """The folded dbias as the kernels take it: per (batch-head, key), the
    unrounded ``ds`` summed over the rows (``flash_bwd_dkv``'s body); then
    per kept slice ``g`` of the bias, the partials of batch-heads ``g *
    g_stride + r * r_stride`` added in the order ``r = 0..R-1`` (the
    second launch, ``csrc/flash_dbias.cu``)."""
    _, ds = pfa._recompute_p_ds(q, k, v, do, lse, delta, causal, scale,
                                rate, seed, bias, segments)
    n, sk = ds.shape[0], ds.shape[-1]
    part = ds.sum(dim=1)
    kept, reduced, g_stride, r_stride = _kernels._dbias_split(bias, n)
    db = torch.zeros(kept, sk)
    for g in range(kept):
        for r in range(reduced):
            db[g] += part[g * g_stride + r * r_stride]
    return db.view(bias.shape)


def _case(seed: int, bias_rows, s: int, d: int, with_ids: bool):
    """Seeded numpy inputs: q, k, v, w ``(B, H, s, d)``, the bias
    ``bias_rows + (s,)`` and, with ``with_ids``, packed ids ``(B, s)``."""
    rng = np.random.RandomState(seed)
    q, k, v = (0.3 * rng.randn(B, H, s, d).astype(np.float32)
               for _ in range(3))
    w = rng.randn(B, H, s, d).astype(np.float32)
    bias = (0.1 * rng.randn(*bias_rows, s)).astype(np.float32)
    ids = _packed(rng, B, s) if with_ids else None
    return q, k, v, w, bias, ids


def _model_dbias(q, k, v, w, bias, ids, causal, rate, plain=False):
    """The fold model's dbias (or ``_flash_dbias_plain``'s, with
    ``plain``) on the port's layout, from the plain forward's lse and
    ``delta = rowsum(w * out)``."""
    s, d = q.shape[2], q.shape[3]
    q3, k3, v3, do3 = (torch.from_numpy(x).reshape(B * H, s, d)
                       for x in (q, k, v, w))
    bias4 = torch.from_numpy(bias)
    segs = None if ids is None else (torch.from_numpy(ids),) * 2
    seed = SEED if rate else None
    scale = d ** -0.5
    out, lse = pfa._flash_fwd_plain(q3, k3, v3, causal, scale, rate, seed,
                                    bias=bias4, segments=segs)
    delta = (do3 * out).sum(dim=-1)
    fn = pfa._flash_dbias_plain if plain else _fold_model
    return fn(q3, k3, v3, do3, lse, delta, causal, scale, rate, seed,
              bias=bias4, segments=segs)


@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_rows", ROW_SHAPES)
def test_fold_model_matches_the_standalone_twin(bias_rows, causal,
                                                with_ids):
    """The fold's two stages sum the same score cotangents as
    ``_flash_dbias_plain`` (ids and dropout 0.3 together)."""
    q, k, v, w, bias, ids = _case(41 + 2 * causal + with_ids, bias_rows, 96,
                                  32, with_ids)
    rate = RATE if with_ids else 0.0
    got = _model_dbias(q, k, v, w, bias, ids, causal, rate)
    want = _model_dbias(q, k, v, w, bias, ids, causal, rate, plain=True)
    assert got.shape == bias.shape and want.abs().max() > 1e-3
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("bias_rows", ROW_SHAPES)
def test_fold_model_matches_jax_kernels(bias_rows, with_ids):
    """The fold model against the JAX Pallas dbias kernel at every row
    shape, causal; with ids, dropout 0.3 too."""
    q, k, v, w, bias, ids = _case(53 + with_ids, bias_rows, 128, 64,
                                  with_ids)
    rate = RATE if with_ids else 0.0
    kw = dict(causal=True, bias_requires_grad=True)
    if with_ids:
        kw.update(segment_ids=ids, dropout_rate=rate, dropout_seed=SEED)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    j_db = jax.grad(lambda b: jnp.sum(jfa.flash_attention(
        jq, jk, jv, bias=b, use_pallas=True, **kw) * w))(jnp.asarray(bias))
    got = _model_dbias(q, k, v, w, bias, ids, True, rate)
    assert np.abs(np.asarray(j_db)).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(j_db), atol=TOL)


@pytest.mark.parametrize("shape,dtype,folds", [
    ((1, 12, 1, 4096), torch.bfloat16, True),    # the long path's ALiBi row
    ((1, 12, 1, 512), torch.bfloat16, True),
    ((16, 1, 1, 512), torch.bfloat16, True),     # a learned padding mask
    ((1, 1, 1, 64), torch.bfloat16, True),
    ((1, 12, 512, 512), torch.bfloat16, False),  # tables: flash_dbias
    ((2, 12, 512, 512), torch.bfloat16, False),
    ((1, 12, 1, 4096), torch.float32, False),    # fp32: flash_dbias
    ((1, 12, 512, 512), torch.float32, False),
])
def test_route_rule(shape, dtype, folds):
    assert _kernels.dbias_folds(shape, dtype) is folds


def _recording_kernels(monkeypatch):
    """Replace the four flash wrappers by their plain twins (the fold by
    ``_fold_model``), recording which ran; returns the record."""
    ran = []

    def twin(name, plain):
        def run(*args, tile_ranges=None, need_dbias=False, **kw):
            ran.append(name + (" fold" if need_dbias else ""))
            out = plain(*args, **kw)
            return (*out, _fold_model(*args, **kw)) if need_dbias else out
        return run

    for name, plain in (("flash_fwd", pfa._flash_fwd_plain),
                        ("flash_bwd_dq", pfa._flash_bwd_dq_plain),
                        ("flash_bwd_dkv", pfa._flash_bwd_dkv_plain),
                        ("flash_dbias", pfa._flash_dbias_plain)):
        monkeypatch.setattr(_kernels, name, twin(name, plain))
    return ran


@pytest.mark.parametrize("dtype,bias_rows,folds", [
    (torch.bfloat16, (1, H, 1), True),
    (torch.bfloat16, (1, H, 64), False),
    (torch.float32, (1, H, 1), False),
])
def test_backward_takes_the_routed_kernel(monkeypatch, dtype, bias_rows,
                                          folds):
    """On the kernels the autograd backward folds a bf16 row bias's
    gradient into ``flash_bwd_dkv`` and calls ``flash_dbias`` for a table
    or fp32 (the wrappers replaced by recording twins, the function called
    as ``flash_attention`` calls it on the card), and the gradient is the
    twins' either way."""
    ran = _recording_kernels(monkeypatch)
    q, k, v, w, bias, _ = _case(67, bias_rows, 64, 32, False)
    q3, k3, v3 = (torch.from_numpy(x).reshape(B * H, 64, 32).to(dtype)
                  for x in (q, k, v))
    bias4 = torch.from_numpy(bias).requires_grad_()
    out = pfa._FlashAttention.apply(q3, k3, v3, bias4, None, None, True,
                                    32 ** -0.5, 0.0, None, True, True)
    do = torch.from_numpy(w).reshape(B * H, 64, 32).to(dtype)
    (out.float() * do.float()).sum().backward()
    assert ran == ["flash_fwd", "flash_bwd_dq"] + (
        ["flash_bwd_dkv fold"] if folds else ["flash_bwd_dkv", "flash_dbias"])
    want = pfa._flash_dbias_plain(
        q3, k3, v3, do, *_stats(q3, k3, v3, do, bias4.detach()), True,
        32 ** -0.5, bias=bias4.detach())
    torch.testing.assert_close(bias4.grad, want, atol=TOL, rtol=0)


def _stats(q3, k3, v3, do, bias):
    """The plain forward's lse and ``delta = rowsum(do * out)``."""
    out, lse = pfa._flash_fwd_plain(q3, k3, v3, True, 32 ** -0.5, bias=bias)
    return lse, (do.float() * out.float()).sum(dim=-1)


@pytest.mark.parametrize("n,h,max_blocks,ctas", [
    (8192, 768, 264, 264),      # the GPT/BERT path: 2 x 132 SMs
    (8192, 768, 396, 396),      # 2 x 198 SMs
    (100, 768, 264, 13),        # fewer rows than a wave: 8 a block
    (1001, 1024, 264, 126),     # the row kernel's widest rows
    (1024, 16384, 264, 264),    # wide rows: a block a row
    (7, 4104, 264, 7),
])
def test_ln_bwd_grid(n, h, max_blocks, ctas):
    assert _kernels.ln_bwd_ctas(n, h, max_blocks) == ctas
