"""Port training path vs the JAX package on the CPU.

- softmax cross-entropy (loss and grad; smoothing, the default
  ``padding_idx=0``, ``half_to_float``) and LayerNorm grads against JAX;
- ``GPTModel.loss`` and every grad leaf against ``jax.grad`` of the JAX
  ``GPTModel.loss`` on the same weights (the JAX ``init`` pytree through the
  bridge; the port's grads back through ``params_to_numpy``), fp32 and bf16
  compute;
- ``FusedAdam`` and ``DynamicLossScale`` step by step against JAX, with a
  forced overflow: params and state kept, the scale halved;
- a 5-step fp32 train trajectory of the tiny GPT against the JAX step
  composed as ``bench.py::_gpt_train_step`` composes it;
- train-mode dropout: inverted dropout's contract, and GPT dropout keyed
  by a generator.

Tiny config: 2 layers, hidden 64, 4 heads, vocab 97, 128 positions; the JAX
side runs its Pallas flash kernels in interpret mode. Tolerances: fp32 1e-5
on losses and 1e-6 (absolute, on values up to ~0.2) on grads and optimizer
state (summation order only), 5e-5 on params after 5 Adam steps (see the
trajectory test); bf16 compute 3% of each leaf's largest
magnitude (bf16 rounds at other places in the two frameworks: a few bf16
ulps, one ulp being 0.4%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.amp.scaler import all_finite as jax_all_finite
from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.normalization import fused_layer_norm_affine as jax_ln
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
from apex_tpu_torch.amp import DynamicLossScale, all_finite, select_tree
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops import dropout, softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=128)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEQ = 128


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(got, ref, rel=None, atol=1e-6):
    """Every leaf of the JAX-layout tree ``got`` against ``ref``: ``atol``,
    or ``rel`` times the leaf's largest magnitude."""
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for key in path:
            g = g[key.key]
        r = np.asarray(r, np.float32)
        tol = atol if rel is None else rel * max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(g, np.float32), r, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# (d) cross-entropy and LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [0, None])
def test_xentropy_loss_and_grad_match_jax(smoothing, padding_idx):
    rng = np.random.RandomState(0)
    logits = rng.randn(12, 33).astype(np.float32) * 3
    labels = rng.randint(0, 33, 12).astype(np.int32)
    labels[:3] = 0    # rows that the default padding_idx zeroes
    g = rng.randn(12).astype(np.float32)

    def jax_fn(x):
        losses = jax_xent(x, labels, smoothing, padding_idx)
        return jnp.sum(losses * g), losses

    (_, j_losses), j_grad = jax.value_and_grad(jax_fn, has_aux=True)(logits)
    x = torch.from_numpy(logits).requires_grad_()
    losses = softmax_cross_entropy_loss(x, torch.from_numpy(labels),
                                        smoothing, padding_idx)
    losses.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(losses), np.asarray(j_losses), atol=1e-5)
    np.testing.assert_allclose(_np(x.grad), np.asarray(j_grad), atol=1e-6)
    if padding_idx == 0:
        assert (losses[:3] == 0).all() and (x.grad[:3] == 0).all()


def test_xentropy_half_to_float_on_bf16_logits():
    rng = np.random.RandomState(1)
    logits = jnp.asarray(rng.randn(8, 40), jnp.bfloat16)
    labels = rng.randint(1, 40, 8).astype(np.int32)
    ref = jax_xent(logits, labels, half_to_float=True)
    x = torch.from_numpy(_np(logits).copy()).to(torch.bfloat16)
    out = softmax_cross_entropy_loss(x, torch.from_numpy(labels),
                                     half_to_float=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    low = softmax_cross_entropy_loss(x, torch.from_numpy(labels))
    assert low.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_grads_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(3, 5, 48) * 2 + 0.5, jdt)
    w = jnp.asarray(rng.randn(48), jdt)
    b = jnp.asarray(rng.randn(48), jdt)
    dy = rng.randn(3, 5, 48).astype(np.float32)

    def jax_fn(x, w, b):
        out = jax_ln(x, w, b, 48, use_pallas=False)
        return jnp.sum(out.astype(jnp.float32) * dy), out

    (_, j_out), j_grads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(x, w, b)
    leaves = [torch.from_numpy(_np(a).copy()).to(tdt).requires_grad_()
              for a in (x, w, b)]
    out = fused_layer_norm_affine(*leaves, 48)
    (out.float() * torch.from_numpy(dy)).sum().backward()
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(out), _np(j_out), atol=tol)
    for t, jg in zip(leaves, j_grads):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(_np(t.grad), _np(jg),
                                   atol=tol * max(1.0, np.abs(_np(jg)).max()))


# ---------------------------------------------------------------------------
# (e) GPT loss and every grad leaf
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(dtype):
    jdt, tdt = DTYPES[dtype]
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jdt, **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = GPTConfig(compute_dtype=tdt, **SIZES)
    return jm, jp, cfg


def _port_model(cfg, jp):
    pm = GPTModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return pm


def _tokens(seed, shape=(2, SEQ)):
    return np.random.RandomState(seed).randint(0, SIZES["vocab_size"], shape)


def _port_grads(pm, cfg):
    return params_to_numpy({n: p.grad for n, p in pm.named_parameters()},
                           cfg)


@pytest.mark.parametrize("dtype,masked", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", False)])
def test_gpt_loss_and_every_grad_leaf_match_jax(dtype, masked):
    jm, jp, cfg = _models(dtype)
    tok = _tokens(0)
    mask = (np.random.RandomState(1).rand(*tok.shape) > 0.3).astype(
        np.float32) if masked else None
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tok), jnp.asarray(tok),
                          loss_mask=None if mask is None else
                          jnp.asarray(mask))))(jp)
    pm = _port_model(cfg, jp)
    loss = pm.loss(torch.from_numpy(tok), torch.from_numpy(tok),
                   loss_mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert all(p.grad is not None for p in pm.parameters())
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
        _assert_trees_close(_port_grads(pm, cfg), j_grads, atol=1e-6)
    else:
        np.testing.assert_allclose(loss.item(), float(j_loss), atol=3e-2)
        _assert_trees_close(_port_grads(pm, cfg), j_grads, rel=3e-2)


def test_tied_head_grad_reaches_the_embedding_from_both_uses():
    _, jp, cfg = _models("float32")
    pm = _port_model(cfg, jp)
    tok = torch.from_numpy(_tokens(2, (1, 16)))
    w = pm.embedding.word.weight
    pm.loss(tok, tok).backward()
    both = w.grad.clone()
    # the same loss with the lookup cut off from the graph: the head alone
    pm.zero_grad()
    x = (w.detach()[tok] + pm.embedding.position[:16]).to(cfg.compute_dtype)
    logits = pm.logits(pm.transform(x))
    softmax_cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                               tok.reshape(-1), padding_idx=None,
                               half_to_float=True).mean().backward()
    head = w.grad
    fed = torch.zeros(SIZES["vocab_size"], dtype=torch.bool)
    fed[tok.flatten()] = True
    assert head[~fed].abs().sum() > 0          # the head reaches every row
    assert torch.equal(both[~fed], head[~fed])
    assert (both[fed] - head[fed]).abs().max() > 1e-4   # and the lookup


# ---------------------------------------------------------------------------
# (f) FusedAdam and DynamicLossScale, step by step
# ---------------------------------------------------------------------------

def _adam_tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(5, 7).astype(np.float32),
            "b": {"x": rng.randn(3).astype(np.float32)}}


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_and_loss_scale_step_by_step_with_overflow(adam_w_mode):
    kw = dict(lr=1e-2, weight_decay=0.1, adam_w_mode=adam_w_mode)
    jopt, popt = JaxAdam(**kw), FusedAdam(**kw)
    jsc = JaxScale(init_scale=2.0 ** 4, growth_interval=2)
    psc = DynamicLossScale(init_scale=2.0 ** 4, growth_interval=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _adam_tree(0))
    params = jax.tree_util.tree_map(torch.from_numpy, _adam_tree(0))
    jstate, state = jopt.init(jparams), popt.init(params)
    jls, ls = jsc.init(), psc.init(device="cpu")
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda a: a * float(jls.loss_scale), _adam_tree(10 + step))
        if step == 3:     # a forced overflow: this step must be skipped
            grads["w"][0, 0] = np.inf
        jg = jsc.unscale(jls, jax.tree_util.tree_map(jnp.asarray, grads))
        jfin = jax_all_finite(jg, observe=None)
        jls = jsc.update(jls, jfin)
        jparams, jstate = jopt.step(jg, jstate, jparams, grads_finite=jfin)

        before = jax.tree_util.tree_map(lambda t: t.clone(), params)
        step_before = int(state.step)
        pg = psc.unscale(ls, jax.tree_util.tree_map(torch.from_numpy, grads))
        fin = all_finite(pg)
        ls = psc.update(ls, fin)
        params, state = popt.step(pg, state, params, grads_finite=fin)

        assert bool(fin) == bool(jfin) == (step != 3)
        assert float(ls.loss_scale) == float(jls.loss_scale)
        assert int(ls.unskipped) == int(jls.unskipped)
        assert int(state.step) == int(jstate.step)
        _assert_trees_close(jax.tree_util.tree_map(_np, params), jparams)
        _assert_trees_close(jax.tree_util.tree_map(_np, state.exp_avg),
                            jstate.exp_avg)
        _assert_trees_close(jax.tree_util.tree_map(_np, state.exp_avg_sq),
                            jstate.exp_avg_sq)
        if step == 3:
            assert int(state.step) == step_before
            for a, b in zip(jax.tree_util.tree_leaves(params),
                            jax.tree_util.tree_leaves(before)):
                assert torch.equal(a, b)
    # the overflow halved the scale; clean pairs of steps doubled it
    assert float(ls.loss_scale) == 2.0 ** 4 * 2 * 0.5 * 2


def test_select_tree_and_all_finite():
    a = {"x": torch.ones(2), "y": [torch.zeros(1)]}
    b = {"x": torch.full((2,), 5.0), "y": [torch.ones(1)]}
    assert torch.equal(select_tree(torch.tensor(False), a, b)["x"], b["x"])
    assert torch.equal(select_tree(torch.tensor(True), a, b)["y"][0],
                       a["y"][0])
    assert bool(all_finite(a))
    assert not bool(all_finite({"x": torch.tensor([1.0, float("nan")])}))
    assert bool(all_finite({"i": torch.tensor([1])}))   # no float leaf


# ---------------------------------------------------------------------------
# (g) a 5-step fp32 train trajectory
# ---------------------------------------------------------------------------

def test_five_step_fp32_trajectory_matches_jax():
    jm, jp, cfg = _models("float32")
    tokens = _tokens(3)
    jopt, jsc = JaxAdam(lr=1e-3), JaxScale(init_scale=2.0 ** 12)
    jstate, jls = jopt.init(jp), jsc.init()
    jtok = jnp.asarray(tokens)

    @jax.jit
    def jstep(params, opt_state, ls):     # bench.py::_gpt_train_step
        def loss_fn(p):
            return jm.loss(p, jtok, jtok) * ls.loss_scale
        scaled, grads = jax.value_and_grad(loss_fn)(params)
        grads = jsc.unscale(ls, grads)
        finite = all_finite_j(grads)
        new_ls = jsc.update(ls, finite)
        params, opt_state = jopt.step(grads, opt_state, params,
                                      grads_finite=finite)
        return params, opt_state, new_ls, scaled / ls.loss_scale

    all_finite_j = functools.partial(jax_all_finite, observe=None)
    pm = _port_model(cfg, jp)
    params = dict(pm.named_parameters())
    popt, psc = FusedAdam(lr=1e-3), DynamicLossScale(init_scale=2.0 ** 12)
    state, ls = popt.init(params), psc.init(device="cpu")
    ttok = torch.from_numpy(tokens)
    for _ in range(5):
        jp, jstate, jls, jloss = jstep(jp, jstate, jls)
        pm.zero_grad(set_to_none=True)
        loss = pm.loss(ttok, ttok)
        (loss * ls.loss_scale).backward()
        grads = psc.unscale(ls, {n: p.grad for n, p in params.items()})
        finite = all_finite(grads)
        ls = psc.update(ls, finite)
        popt.step(grads, state, params, grads_finite=finite)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert int(state.step) == int(jstate.step) == 5
    # Adam divides each grad by its own running rms, so a grad at rounding
    # level (where the two sides' reduction orders differ in relative
    # terms) moves its element by up to ~lr: hold params to 5% of lr
    _assert_trees_close(params_to_numpy(pm.state_dict(), cfg), jp,
                        atol=5e-5)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_contract():
    x = torch.ones(2000)
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    assert dropout(x, 0.3) is x            # no generator: eval mode
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.05
    y2 = dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)              # keyed by the generator
    with pytest.raises(ValueError, match="outside"):
        dropout(x, 1.0, torch.Generator())


def test_dropout_generator_must_share_the_input_device():
    """The mask is drawn where the input lies: a generator on another
    device raises instead of building the mask there and copying it."""
    x = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="share a device"):
        dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert dropout(x, 0.0, torch.Generator()) is x


def test_gpt_train_mode_dropout_is_keyed_by_the_generator():
    import dataclasses
    _, jp, cfg = _models("float32")
    cfg = dataclasses.replace(cfg, hidden_dropout=0.1, attention_dropout=0.1)
    pm = _port_model(cfg, jp)
    tok = torch.from_numpy(_tokens(4, (1, 32)))
    with torch.no_grad():
        eval_a, eval_b = pm.loss(tok, tok), pm.loss(tok, tok)
        a = pm.loss(tok, tok, generator=torch.Generator().manual_seed(1))
        b = pm.loss(tok, tok, generator=torch.Generator().manual_seed(1))
        c = pm.loss(tok, tok, generator=torch.Generator().manual_seed(2))
    assert float(eval_a) == float(eval_b)
    assert float(a) == float(b) and float(a) != float(c)
    assert float(a) != float(eval_a)
    loss = pm.loss(tok, tok, generator=torch.Generator().manual_seed(1))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters())
