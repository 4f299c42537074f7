"""The port's RNN-T transducer joint and loss against the JAX package's on
the CPU.

- ``transducer_loss`` and its closed-form backward against
  ``apex_tpu.ops.transducer.transducer_loss`` and ``jax.grad`` through its
  ``custom_vjp``, with upstream weights on each sequence's loss: both
  blank indices, ragged lengths, T above and below U, zero grads outside
  the valid region; a bf16 input (the loss in bf16, the gradient the
  reference's fp32 one rounded once to bf16);
- the recursion's sequential steps: ``T + U`` anti-diagonals each way
  (counted through ``torch.logaddexp``), never ``T * U``;
- ``transducer_joint`` with ``relu`` and with lengths, and its dropout's
  semantics (keep rate, scaling, zeroed padded cells, determinism from a
  generator), the module wrappers and their refusals.

Tolerances are the reference's own against its naive oracle
(``tests/test_transducer.py``): loss rtol 1e-5, grads rtol 1e-4 and atol
1e-6, fp32. The joint is one add (and a ReLU): equal to 1e-6. A bf16
loss within one bf16 ulp (2**-8 relative) of the reference's, the bf16
gradient within one bf16 ulp of the reference's fp32 gradient plus 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import transducer as jt
from apex_tpu_torch.ops import transducer as pt
from apex_tpu_torch.ops import (TransducerJoint, TransducerLoss,
                                transducer_joint, transducer_loss)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_ULP = 2.0 ** -8


def _case(seed, B, T, U, V, blank_idx, f_len, y_len):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, U + 1, V).astype(np.float32) * 2.0
    pool = [v for v in range(V) if v != blank_idx]
    label = rng.choice(pool, (B, U)).astype(np.int32)
    w = rng.randn(B).astype(np.float32)
    return (x, label, np.asarray(f_len, np.int32),
            np.asarray(y_len, np.int32), w)


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_loss_grad(xj, label, f_len, y_len, w, blank_idx):
    def total(xx):
        loss = jt.transducer_loss(xx, label, f_len, y_len, blank_idx)
        return jnp.sum(w * loss.astype(jnp.float32)), loss
    (_, loss), grad = jax.value_and_grad(total, has_aux=True)(xj)
    return loss, grad


def _jax(x, label, f_len, y_len, w, blank_idx, dtype=jnp.float32):
    loss, grad = _jax_loss_grad(jnp.asarray(x, dtype), jnp.asarray(label),
                                jnp.asarray(f_len), jnp.asarray(y_len),
                                jnp.asarray(w), blank_idx)
    return np.asarray(loss.astype(jnp.float32)), np.asarray(
        grad.astype(jnp.float32))


def _port(x, label, f_len, y_len, w, blank_idx, dtype=torch.float32):
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    loss = transducer_loss(xt, torch.tensor(label).long(),
                           torch.tensor(f_len).long(),
                           torch.tensor(y_len).long(), blank_idx)
    (loss.float() * torch.tensor(w)).sum().backward()
    return loss, xt.grad


CASES = [
    # seed, B, T, U, V, blank, f_len, y_len
    (0, 2, 4, 3, 6, 0, [4, 3], [3, 2]),
    (0, 2, 4, 3, 6, 3, [4, 3], [3, 2]),
    (1, 3, 9, 4, 7, 0, [9, 5, 7], [4, 1, 3]),
    (2, 3, 3, 8, 5, 4, [3, 2, 3], [8, 6, 2]),
    (3, 2, 12, 12, 9, 0, [12, 6], [12, 11]),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"s{c[0]}-T{c[2]}-U{c[3]}-blank{c[5]}"
                              for c in CASES])
def test_loss_and_grad_match_jax(case):
    seed, B, T, U, V, blank, fl, yl = case
    x, label, f_len, y_len, w = _case(seed, B, T, U, V, blank, fl, yl)
    j_loss, j_grad = _jax(x, label, f_len, y_len, w, blank)
    loss, grad = _port(x, label, f_len, y_len, w, blank)
    assert loss.dtype == torch.float32 and loss.shape == (B,)
    np.testing.assert_allclose(loss.detach().numpy(), j_loss, rtol=LOSS_RTOL)
    assert grad.dtype == torch.float32
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_grad_zero_outside_valid_region():
    x, label, f_len, y_len, w = _case(1, 2, 5, 3, 5, 0, [3, 5], [2, 3])
    _, g = _port(x, label, f_len, y_len, np.ones(2, np.float32), 0)
    g = g.numpy()
    assert np.all(g[0, 3:] == 0.0)
    assert np.all(g[0, :, 3:] == 0.0)
    assert np.all(g[1, :, 4:] == 0.0)
    assert np.any(g[0, :3, :3] != 0.0)


def test_bf16_input_matches_jax():
    x, label, f_len, y_len, w = _case(4, 3, 7, 5, 8, 0, [7, 4, 6],
                                      [5, 2, 4])
    j_loss, j_grad = _jax(x, label, f_len, y_len, w, 0, jnp.bfloat16)
    loss, grad = _port(x, label, f_len, y_len, w, 0, torch.bfloat16)
    assert loss.dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
    got = loss.detach().float().numpy()
    assert (np.abs(got - j_loss) <= BF16_ULP * np.abs(j_loss)).all()
    g = grad.float().numpy()
    assert (np.abs(g - j_grad) <= BF16_ULP * np.abs(j_grad) + 1e-6).all()


def test_recursion_takes_t_plus_u_steps(monkeypatch):
    """alpha takes one log-add-exp a diagonal after the first, beta two a
    diagonal: (T + U) diagonals, not T * (U + 1) cells."""
    B, T, U, V = 2, 11, 6, 5
    x, label, f_len, y_len, _ = _case(5, B, T, U, V, 0, [11, 8], [6, 3])
    calls = [0]
    real = torch.logaddexp

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pt.torch, "logaddexp", counted)
    pt.transducer_loss(torch.tensor(x), torch.tensor(label).long(),
                       torch.tensor(f_len).long(),
                       torch.tensor(y_len).long())
    K = T + U
    assert calls[0] == (K - 1) + 2 * K


def _joint_inputs(seed, B=2, T=4, U=3, H=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H).astype(np.float32),
            rng.randn(B, U, H).astype(np.float32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("lengths", [False, True])
def test_joint_matches_jax(relu, lengths):
    f, g = _joint_inputs(3)
    f_len = np.asarray([4, 2], np.int32) if lengths else None
    g_len = np.asarray([3, 1], np.int32) if lengths else None
    want = jt.transducer_joint(
        jnp.asarray(f), jnp.asarray(g),
        None if f_len is None else jnp.asarray(f_len),
        None if g_len is None else jnp.asarray(g_len), relu=relu)
    got = transducer_joint(
        torch.tensor(f), torch.tensor(g),
        None if f_len is None else torch.tensor(f_len),
        None if g_len is None else torch.tensor(g_len), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if lengths:
        assert np.all(got.numpy()[1, 2:] == 0.0)
        assert np.all(got.numpy()[1, :, 1:] == 0.0)


def test_joint_dropout_semantics():
    B, T, U, H = 2, 16, 9, 64
    f, g = _joint_inputs(4, B, T, U, H)
    f_len, g_len = torch.tensor([16, 10]), torch.tensor([9, 5])
    rate = 0.25
    plain = transducer_joint(torch.tensor(f), torch.tensor(g), f_len, g_len,
                             relu=True)
    gen = torch.Generator().manual_seed(0)
    h = transducer_joint(torch.tensor(f), torch.tensor(g), f_len, g_len,
                         relu=True, dropout_rate=rate, generator=gen)
    again = transducer_joint(torch.tensor(f), torch.tensor(g), f_len, g_len,
                             relu=True, dropout_rate=rate,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(h, again)
    valid = plain != 0
    kept = (h != 0) & valid
    share = kept.sum().item() / valid.sum().item()
    assert abs(share - (1 - rate)) < 0.02, share
    torch.testing.assert_close(h[kept], plain[kept] / (1 - rate), rtol=0,
                               atol=0)
    assert torch.all(h[1, 10:] == 0) and torch.all(h[1, :, 5:] == 0)
    with pytest.raises(ValueError):
        transducer_joint(torch.tensor(f), torch.tensor(g), dropout_rate=0.1)


def test_module_wrappers():
    f, g = _joint_inputs(5)
    joint = TransducerJoint(relu=True, dropout=True, dropout_prob=0.5)
    h = joint(torch.tensor(f), torch.tensor(g),
              generator=torch.Generator().manual_seed(1))
    assert h.shape == (2, 4, 3, 8)
    assert torch.equal(TransducerJoint(relu=True)(torch.tensor(f),
                                                  torch.tensor(g)),
                       torch.relu(torch.tensor(f)[:, :, None]
                                  + torch.tensor(g)[:, None]))
    with pytest.raises(NotImplementedError):
        TransducerJoint(pack_output=True)
    with pytest.raises(NotImplementedError):
        TransducerLoss(packed_input=True)
    x, label, f_len, y_len, w = _case(*CASES[0])
    out = TransducerLoss()(torch.tensor(x), torch.tensor(label).long(),
                           torch.tensor(f_len), torch.tensor(y_len))
    want, _ = _jax(x, label, f_len, y_len, w, 0)
    np.testing.assert_allclose(out.numpy(), want, rtol=LOSS_RTOL)
