"""Port fused softmax and the xentropy class vs the JAX package on the
CPU.

- ``scaled_upper_triang_masked_softmax`` at ``sq == sk`` and ``sq < sk``
  (the rule ``col > row + (sk - sq)``), fp32 and bf16 inputs;
- ``scaled_masked_softmax`` with a padding mask holding a fully masked
  row (uniform, as the ``-10000`` fill gives, not zero and not NaN);
- ``FusedScaleMaskSoftmax``: causal, padding, the ``mask_func`` fallback
  branch in fp32 and in half, its refusals, and its predicates
  ``is_kernel_available`` and ``get_batch_per_block`` over a grid of
  sizes, equal to the JAX dispatcher's;
- ``SoftmaxCrossEntropyLoss.apply`` (smoothing, ``padding_idx``,
  ``half_to_float``, bf16 logits): losses and the logits' grads.

Tolerance: 1e-6 absolute on fp32 probabilities (in [0, 1]); bf16 outputs
within one bf16 ulp (2**-8 relative, as both round the same fp32 values);
losses and grads 1e-6 of their largest magnitude.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import FusedScaleMaskSoftmax as JaxFSMS
from apex_tpu.ops import SoftmaxCrossEntropyLoss as JaxXent
from apex_tpu.ops import scaled_masked_softmax as jax_masked
from apex_tpu.ops import scaled_upper_triang_masked_softmax as jax_causal
from apex_tpu.ops.fused_softmax import AttnMaskType as JaxMaskType
from apex_tpu_torch.ops import (AttnMaskType, FusedScaleMaskSoftmax,
                                SoftmaxCrossEntropyLoss,
                                scaled_masked_softmax,
                                scaled_upper_triang_masked_softmax)

TOL = 1e-6


def _close(got, want, dtype=torch.float32):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-30)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _scores(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 12)])
def test_causal_softmax_matches_jax(dtype, sq, sk):
    x = _scores((6, sq, sk))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_causal(jnp.asarray(x, jd), 0.125)
    got = scaled_upper_triang_masked_softmax(torch.from_numpy(x).to(dtype),
                                             0.125)
    assert got.dtype == dtype
    _close(got, want, dtype)
    # a dropped score is ~exp(-10000): exactly 0 in fp32
    col = np.arange(sk)[None, :] > np.arange(sq)[:, None] + (sk - sq)
    assert not got.float().numpy()[:, col].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_softmax_fully_masked_row_is_uniform(dtype):
    x = _scores((2, 3, 8, 16), 1)
    mask = np.zeros((2, 1, 8, 16), bool)
    mask[0, :, :, 10:] = True       # padding past key 10
    mask[1, :, 3, :] = True         # a fully masked row
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_masked(jnp.asarray(x, jd), jnp.asarray(mask), 0.5)
    got = scaled_masked_softmax(torch.from_numpy(x).to(dtype),
                                torch.from_numpy(mask), 0.5)
    _close(got, want, dtype)
    row = got[1, :, 3].float()
    assert torch.allclose(row, torch.full_like(row, 1 / 16), atol=TOL)
    assert torch.isfinite(got.float()).all()
    _close(scaled_masked_softmax(torch.from_numpy(x), None),
           jax_masked(jnp.asarray(x), None))


def _mask_func(x, mask):
    return x.masked_fill(mask, -1e4) if isinstance(x, torch.Tensor) else \
        jnp.where(mask, -1e4, x)


DISPATCH = {
    "causal_bf16": dict(input_in_bf16=True, attn_mask_type="causal",
                        scale=0.125),
    "padding_fp32": dict(attn_mask_type="padding", scale=0.5),
    "padding_bf16_no_scale": dict(input_in_bf16=True,
                                  attn_mask_type="padding"),
    "mask_func_fallback_bf16": dict(input_in_bf16=True,
                                    attn_mask_type="padding",
                                    scaled_masked_softmax_fusion=False,
                                    mask_func=True, scale=2.0),
    "mask_func_fallback_fp32": dict(attn_mask_type="padding",
                                    scaled_masked_softmax_fusion=False,
                                    mask_func=True),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatcher_matches_jax(case):
    kw = dict(DISPATCH[case])
    kind = kw.pop("attn_mask_type")
    use_mask_func = kw.pop("mask_func", False)
    bf16 = kw.get("input_in_bf16", False)
    dtype = torch.bfloat16 if bf16 else torch.float32
    jd = jnp.bfloat16 if bf16 else jnp.float32
    x = _scores((2, 3, 16, 16), 2)
    mask = np.zeros((2, 1, 16, 16), bool)
    mask[1, :, :, 9:] = True
    jm = JaxFSMS(attn_mask_type=getattr(JaxMaskType, kind),
                 mask_func=_mask_func if use_mask_func else None, **kw)
    pm = FusedScaleMaskSoftmax(attn_mask_type=getattr(AttnMaskType, kind),
                               mask_func=_mask_func if use_mask_func
                               else None, **kw)
    want = jm(jnp.asarray(x, jd), jnp.asarray(mask))
    got = pm(torch.from_numpy(x).to(dtype), torch.from_numpy(mask))
    assert got.dtype == dtype
    _close(got, want, dtype)


def test_dispatcher_refusals():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=0.5)
    causal = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)
    with pytest.raises(ValueError, match="self attention"):
        causal(torch.zeros(1, 1, 4, 8), None)
    with pytest.raises(ValueError, match="b, np, sq, sk"):
        causal(torch.zeros(4, 8), None)


def test_dispatcher_predicates_match_jax():
    for fp16, kind, fusion in itertools.product(
            (False, True), ("padding", "causal"), (False, True)):
        jm = JaxFSMS(input_in_fp16=fp16, attn_mask_type=getattr(
            JaxMaskType, kind), scaled_masked_softmax_fusion=fusion)
        pm = FusedScaleMaskSoftmax(input_in_fp16=fp16, attn_mask_type=getattr(
            AttnMaskType, kind), scaled_masked_softmax_fusion=fusion)
        for b, np_, sq, sk in itertools.product((1, 4), (3, 8),
                                                (4, 16, 18, 128),
                                                (8, 17, 64, 384, 2048, 4096)):
            for mask in (None, True):
                assert pm.is_kernel_available(mask, b, np_, sq, sk) == \
                    jm.is_kernel_available(mask, b, np_, sq, sk)
            assert pm.get_batch_per_block(sq, sk, b, np_) == \
                JaxFSMS.get_batch_per_block(sq, sk, b, np_)


@pytest.mark.parametrize("smoothing,padding_idx,half_to_float,bf16", [
    (0.0, 0, False, False), (0.1, 1, False, False), (0.1, None, True, False),
    (0.1, 1, True, True), (0.0, 0, False, True)])
def test_xentropy_class_matches_jax(smoothing, padding_idx, half_to_float,
                                    bf16):
    rng = np.random.RandomState(3)
    logits = (rng.randn(12, 40) * 2).astype(np.float32)
    labels = rng.randint(0, 40, 12).astype(np.int32)
    labels[[2, 7]] = 1 if padding_idx is None else padding_idx
    dy = rng.randn(12).astype(np.float32)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    dtype = torch.bfloat16 if bf16 else torch.float32

    def jloss(lg):
        out = JaxXent.apply(lg, jnp.asarray(labels), smoothing, padding_idx,
                            half_to_float)
        return jnp.sum(out.astype(jnp.float32) * dy), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits, jd))
    tl = torch.from_numpy(logits).to(dtype).requires_grad_()
    out = SoftmaxCrossEntropyLoss.apply(tl, torch.from_numpy(labels),
                                        smoothing, padding_idx,
                                        half_to_float)
    assert out.dtype == (torch.float32 if half_to_float else dtype)
    (out.float() * torch.from_numpy(dy)).sum().backward()
    for got, want in ((out, jout), (tl.grad, jg)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        tol = (2 ** -8 * np.abs(want) if got.dtype == torch.bfloat16
               else 0) + TOL * max(1.0, float(np.abs(want).max()))
        assert (np.abs(got.detach().float().numpy() - want) <= tol).all()
