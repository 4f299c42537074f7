"""The port's RNN family (``apex_tpu_torch.RNN``) against the JAX package's
``apex_tpu.RNN`` on the CPU.

Weights come from the JAX ``init`` through
``_bridge.rnn_params_from_jax``. Every cell kind (LSTM, GRU, ReLU, Tanh,
mLSTM), one and two layers, bidirectional, the ``output_size``
projection and ``batch_first``: the outputs and the final states, and the
gradients of ``sum(out * w_out) + sum(h * w_h) (+ sum(c * w_c))`` with
respect to every weight and the input. Then a bf16 input over fp32
weights against the JAX bf16 run, dropout's semantics between stacked
layers, ``init``, ``init_hidden``, the refusals and the bridge's round
trip.

Tolerances: fp32 outputs, states and grads within 1e-5 of each tensor's
largest magnitude (1e-5 absolute below 1): the same products in fp32,
summed in another order. bf16: ``h`` and ``c`` are rounded to bf16 after
every step in both packages, and XLA's fp32 ``tanh`` on the CPU differs
from torch's in the last bits of most values, so a rounding can flip
(2**-8 relative) and the recurrence carries it on: within 4 bf16 ulps of
each tensor's largest magnitude (half an ulp seen).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import RNN as JRNN
from apex_tpu_torch import RNN as PRNN
from apex_tpu_torch._bridge import rnn_params_from_jax, rnn_params_to_numpy

TOL = 1e-5
BF16_TOL = 4 * 2.0 ** -8
T, B, I, H = 6, 3, 5, 8

CASES = [
    # kind, layers, bidirectional, output_size, batch_first
    ("lstm", 1, False, None, False),
    ("lstm", 2, True, None, True),
    ("lstm", 2, False, 4, False),
    ("gru", 2, True, None, False),
    ("relu", 2, False, None, True),
    ("tanh", 1, True, None, False),
    ("mlstm", 2, False, None, False),
    ("mlstm", 1, True, 4, True),
]
FACTORY = {"lstm": "LSTM", "gru": "GRU", "relu": "ReLU", "tanh": "Tanh",
           "mlstm": "mLSTM"}


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    limit = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _models(kind, layers, bidi, out_size, batch_first):
    kw = dict(bidirectional=bidi, output_size=out_size,
              batch_first=batch_first)
    jm = getattr(JRNN, FACTORY[kind])(I, H, layers, **kw)
    pm = getattr(PRNN, FACTORY[kind])(I, H, layers, device="cpu", **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pm.load_state_dict(rnn_params_from_jax(params))
    return jm, pm, params


def _weights(jm, x_shape, seed=1):
    rng = np.random.RandomState(seed)
    T_, B_ = (x_shape[1], x_shape[0]) if jm.batch_first else x_shape[:2]
    out_w = rng.randn(*x_shape[:2], jm.out_size * (2 if jm.bidirectional
                                                   else 1))
    n = jm.num_layers * (2 if jm.bidirectional else 1)
    h_w = rng.randn(n, B_, jm.out_size)
    c_w = rng.randn(n, B_, jm.hidden_size)
    return [a.astype(np.float32) for a in (out_w, h_w, c_w)]


def _jax_run(jm, params, x, ws):
    @functools.partial(jax.jit)
    def run(params, x):
        def loss(params, x):
            out, hid = jm(params, x)
            h, c = hid if jm.n_states == 2 else (hid, None)
            total = jnp.sum(out.astype(jnp.float32) * ws[0]) + jnp.sum(
                h.astype(jnp.float32) * ws[1])
            if c is not None:
                total = total + jnp.sum(c.astype(jnp.float32) * ws[2])
            return total, (out, h, c)
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    return run(params, x)


def _port_run(pm, x, ws):
    xt = x.clone().requires_grad_(True)
    out, hid = pm(xt)
    h, c = hid if pm.n_states == 2 else (hid, None)
    total = (out.float() * torch.tensor(ws[0])).sum() + (
        h.float() * torch.tensor(ws[1])).sum()
    if c is not None:
        total = total + (c.float() * torch.tensor(ws[2])).sum()
    total.backward()
    return out, h, c, xt.grad


def _x(case, seed=2):
    shape = (B, T, I) if case[4] else (T, B, I)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(str(v) for v in c) for c in CASES])
def test_fp32_outputs_states_and_grads(case):
    jm, pm, params = _models(*case)
    x = _x(case)
    ws = _weights(jm, x.shape)
    (jg, jgx), (jout, jh, jc) = _jax_run(jm, params, jnp.asarray(x), ws)
    out, h, c, gx = _port_run(pm, torch.tensor(x), ws)
    _close(out, jout, TOL, "out")
    _close(h, jh, TOL, "h")
    if c is not None:
        _close(c, jc, TOL, "c")
    _close(gx, jgx, TOL, "dx")
    for name, p in pm.named_parameters():
        layer, leaf = name.split(".")
        _close(p.grad, jg[layer][leaf], TOL, name)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[7]],
                         ids=["lstm", "gru", "mlstm"])
def test_bf16_input_matches_jax_bf16(case):
    jm, pm, params = _models(*case)
    x = _x(case, seed=3)
    jout, jhid = jax.jit(jm.__call__)(params, jnp.asarray(x, jnp.bfloat16))
    out, hid = pm(torch.tensor(x).bfloat16())
    assert out.dtype == torch.bfloat16
    _close(out, jout, BF16_TOL, "out")
    if pm.n_states == 2:
        _close(hid[0], jhid[0], BF16_TOL, "h")
        _close(hid[1], jhid[1], BF16_TOL, "c")
        assert hid[1].dtype == torch.bfloat16
    else:
        _close(hid, jhid, BF16_TOL, "h")


def test_dropout_between_layers_only():
    x = torch.tensor(_x(CASES[0]))
    two = PRNN.LSTM(I, H, 2, dropout=0.5, device="cpu")
    two.init(torch.Generator().manual_seed(0))
    plain, _ = two(x)
    again, _ = two(x, generator=None)
    assert torch.equal(plain, again)          # no generator: eval mode
    a, _ = two(x, generator=torch.Generator().manual_seed(5))
    b, _ = two(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    one = PRNN.LSTM(I, H, 1, dropout=0.5, device="cpu")
    one.init(torch.Generator().manual_seed(0))
    # no layer follows the last: dropout never applies to the output
    assert torch.equal(one(x)[0],
                       one(x, generator=torch.Generator().manual_seed(5))[0])


def test_init_names_shapes_and_bounds():
    for kind in FACTORY:
        proj = None if kind == "gru" else 4
        jm = getattr(JRNN, FACTORY[kind])(I, H, 2, bidirectional=True,
                                          output_size=proj)
        pm = getattr(PRNN, FACTORY[kind])(I, H, 2, bidirectional=True,
                                          output_size=proj, device="cpu")
        pm.init(torch.Generator().manual_seed(0))
        ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        want = {f"{layer}.{leaf}": tuple(v.shape)
                for layer, leaves in ref.items()
                for leaf, v in leaves.items()}
        got = {n: tuple(p.shape) for n, p in pm.state_dict().items()}
        assert got == want, kind
        bound = 1.0 / H ** 0.5
        for p in pm.parameters():
            assert float(p.detach().abs().max()) <= bound
        h0 = pm.init_hidden(B)
        jh0 = jm.init_hidden(B)
        if pm.n_states == 2:
            assert h0[0].shape == jh0[0].shape and h0[1].shape == jh0[1].shape
        else:
            assert h0.shape == jh0.shape


def test_refusals_and_bridge_round_trip():
    with pytest.raises(ValueError):
        PRNN.GRU(I, H, 1, output_size=4, device="cpu")
    with pytest.raises(ValueError):
        PRNN.ApexRNN("lstmx", I, H, device="cpu")
    params = jax.device_get(JRNN.mLSTM(I, H, 2, bidirectional=True).init(
        jax.random.PRNGKey(4)))
    back = rnn_params_to_numpy(rnn_params_from_jax(params))
    assert back.keys() == params.keys()
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          np.asarray(params[layer][leaf]))
