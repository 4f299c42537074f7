"""Port ``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` vs the JAX
package on the CPU, and the port's ``supports_flash``/``supports_paged``.

Each case builds the JAX module once, draws its parameters with
``init``, hands them to the port module through the bridge
(``module_params_from_jax``, bit for bit), and runs the same seeded
sequence-first inputs through both: the JAX attention core is
``flash_attention``'s Pallas kernels in interpret mode (T 128 is tile
aligned, so ``use_pallas`` picks them, as the JAX tests run them), the
port's the plain twins of the flash kernels. Cases: self attention with
norm-add, the key padding mask and biases; causal; causal with norm-add,
the padding mask and dropout 0.1; encoder-decoder (sq 64 against sk 128)
with norm-add, the mask and biases, and with dropout. Dropout draws the
seed JAX's ``_dropout_seed`` draws from the key and hands the port that
int. Compared: the output and the grads of ``sum(out * w)`` with respect
to the inputs and every parameter.

Tolerance: 1e-5 of each tensor's largest magnitude (1e-5 absolute below
1) on outputs and grads: fp32, sums in other orders, the bias grads sums
over the T x B rows.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import EncdecMultiheadAttn as JaxEncdec
from apex_tpu.ops import SelfMultiheadAttn as JaxSelf
from apex_tpu.ops import supports_flash as jax_supports_flash
from apex_tpu_torch._bridge import module_params_from_jax
from apex_tpu_torch.ops import (EncdecMultiheadAttn, SelfMultiheadAttn,
                                supports_flash, supports_paged)

jmha = importlib.import_module("apex_tpu.ops.multihead_attn")
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

TOL = 1e-5
E, HEADS, B, T, TQ = 64, 4, 2, 128, 64

CASES = {
    "self_norm_add_mask_bias": dict(kind="self", norm=True, mask=True,
                                    bias=True),
    "self_causal": dict(kind="self", causal=True),
    "self_causal_norm_add_mask_dropout": dict(kind="self", norm=True,
                                              mask=True, causal=True,
                                              dropout=0.1),
    "encdec_norm_add_mask_bias": dict(kind="encdec", norm=True, mask=True,
                                      bias=True),
    "encdec_dropout": dict(kind="encdec", mask=True, dropout=0.1),
}


@functools.lru_cache(maxsize=None)
def _jax_module(kind, norm, bias, dropout):
    cls = JaxSelf if kind == "self" else JaxEncdec
    jm = cls(E, HEADS, dropout=dropout, bias=bias, include_norm_add=norm)
    params = jm.init(jax.random.PRNGKey(0))
    if bias:   # non-zero biases and norm affine, so each is exercised
        rng = np.random.RandomState(1)
        params = jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype)
            if x.ndim == 1 else x, params)
    return jm, params


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _inputs(kind):
    rng = np.random.RandomState(2)
    x = rng.randn(TQ if kind == "encdec" else T, B, E).astype(np.float32)
    kv = rng.randn(T, B, E).astype(np.float32)
    lengths = np.array([T, 77])
    mask = np.arange(T)[None, :] >= lengths[:, None]      # True at padding
    w = rng.randn(*x.shape).astype(np.float32)
    return x, kv, mask, w


@pytest.mark.parametrize("case", list(CASES))
def test_attention_module_matches_jax(case):
    c = CASES[case]
    kind, norm, bias = c["kind"], c.get("norm", False), c.get("bias", False)
    rate, causal = c.get("dropout", 0.0), c.get("causal", False)
    jm, jparams = _jax_module(kind, norm, bias, rate)
    x, kv, mask, w = _inputs(kind)
    jmask = jnp.asarray(mask) if c.get("mask") else None
    rng_key = jax.random.PRNGKey(3) if rate else None
    seed = (int(jmha._dropout_seed(rng_key)) if rate else None)

    def jloss(params, x, kv):
        if kind == "self":
            out = jm(params, x, key_padding_mask=jmask,
                     attn_mask_causal=causal, dropout_rng=rng_key)
        else:
            out = jm(params, x, kv, key_padding_mask=jmask,
                     dropout_rng=rng_key)
        return jnp.sum(out * w), out

    (_, jout), (jg, jgx, jgkv) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jparams, jnp.asarray(x),
                                                 jnp.asarray(kv))

    cls = SelfMultiheadAttn if kind == "self" else EncdecMultiheadAttn
    pm = cls(E, HEADS, dropout=rate, bias=bias, include_norm_add=norm,
             device="cpu")
    sd = module_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(sd) == set(dict(pm.named_parameters()))
    pm.load_state_dict(sd)
    tx = torch.from_numpy(x).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    tmask = torch.from_numpy(mask) if c.get("mask") else None
    if kind == "self":
        out = pm(tx, key_padding_mask=tmask, attn_mask_causal=causal,
                 dropout_seed=seed)
    else:
        out = pm(tx, tkv, key_padding_mask=tmask, dropout_seed=seed)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), jout, "out")
    _close(tx.grad.numpy(), jgx, "d input")
    if kind == "encdec":
        _close(tkv.grad.numpy(), jgkv, "d key_value")
    want = module_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)


def test_dropout_changes_the_output_and_needs_the_seed():
    pm = SelfMultiheadAttn(E, HEADS, dropout=0.5, device="cpu").init(
        torch.Generator().manual_seed(0))
    x = torch.randn(T, B, E, generator=torch.Generator().manual_seed(1))
    plain = pm(x)
    a, b = pm(x, dropout_seed=7), pm(x, dropout_seed=7)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    assert not torch.allclose(a, pm(x, dropout_seed=8))


def test_init_draws_xavier_uniform_from_the_generator():
    pm = EncdecMultiheadAttn(E, HEADS, bias=True, include_norm_add=True,
                             device="cpu").init(
        torch.Generator().manual_seed(0))
    again = EncdecMultiheadAttn(E, HEADS, bias=True, include_norm_add=True,
                                device="cpu").init(
        torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(pm.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
    bound = (6.0 / (E + 2 * E)) ** 0.5
    top = float(pm.kv.weight.detach().abs().max())
    assert 0.9 * bound < top <= bound
    assert not pm.q.bias.detach().any()
    assert torch.equal(pm.lyr_nrm.weight, torch.ones(E))
    with pytest.raises(ValueError, match="divide"):
        SelfMultiheadAttn(E, 5, device="cpu")


def test_supports_flash_and_paged():
    for d in range(1, 300):
        want = d % 8 == 0 and 8 <= d <= 256
        assert supports_flash(100, 37, d, 64, 128) == want, d
        assert supports_paged(16, d) == want, d
        for sq, sk, bq, bk in ((1, 256, 1, 128), (256, 256, 128, 128),
                               (64, 384, 64, 128)):
            # every shape the reference's Pallas path takes, the port's
            # kernels take up to their widest head dim
            if jax_supports_flash(sq, sk, d, bq, bk) and d <= 256:
                assert supports_flash(sq, sk, d, bq, bk), (sq, sk, d)
    assert not supports_flash(0, 8, 64, 64, 128)
    assert supports_paged(1, 64) and supports_paged(48, 128)
    assert not supports_paged(0, 64)
    # the reference's interpret-mode rule on this CPU takes any d >= 1
    assert jfa.supports_paged(16, 4) and not supports_paged(16, 4)
