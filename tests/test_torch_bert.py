"""Port BERT vs the JAX package on the CPU.

- the weight bridge: a JAX ``BertModel.init`` pytree through
  ``params_from_jax`` and back through ``params_to_numpy``, bit for bit,
  fp32 and bf16 leaves;
- ``BertModel.loss`` with an attention mask, token types, a loss mask and
  binary labels, and every grad leaf, against the JAX ``loss`` and
  ``jax.grad`` at fp32; the JAX side runs with ``use_flash=True``, its
  Pallas flash kernels in interpret mode with the padding mask as their
  broadcast bias, the port's CPU path the plain twins of the CUDA kernels;
- a 3-step ``FusedAdam`` + ``DynamicLossScale`` fp32 trajectory;
- the padding mask: changing a padded token leaves the real positions'
  logits unchanged.

Tiny config: vocab 128, hidden 64, 2 layers, 4 heads, seq 128. Inputs come
from ``np.random.RandomState``: lengths in 64-128, token types split at a
drawn point, a Bernoulli 0.15 loss mask over the real tokens. Tolerances
as ``tests/test_torch_train.py``: fp32 1e-5 on losses, 1e-6 absolute on
grads (summation order only), 5e-5 on params after the Adam steps (Adam
divides each grad by its own running rms, so a grad at rounding level
moves its element by up to ~lr).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.amp.scaler import all_finite as jax_all_finite
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
from apex_tpu_torch.amp import DynamicLossScale, all_finite
from apex_tpu_torch.models import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedAdam

SIZES = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=128)
SEQ = 128


def _assert_trees_close(got, ref, atol):
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(r, np.float32), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _models():
    jm = JaxBert(JaxBertConfig(compute_dtype=jnp.float32, use_flash=True,
                               **SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = BertConfig(compute_dtype=torch.float32, **SIZES)
    return jm, jp, cfg


def _port_model(cfg, jp):
    pm = BertModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return pm


def _batch(seed, b=2):
    """The pretraining batch: tokens, MLM labels, loss mask, token types,
    attention mask and binary labels, as numpy arrays."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(SEQ // 2, SEQ + 1, b)
    lengths[0] = SEQ
    pos = np.arange(SEQ)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int32)
    split = rng.randint(1, lengths)
    types = (pos >= split[:, None]).astype(np.int32) * mask
    tokens = rng.randint(0, SIZES["vocab_size"], (b, SEQ)).astype(np.int32)
    labels = rng.randint(0, SIZES["vocab_size"], (b, SEQ)).astype(np.int32)
    loss_mask = ((rng.rand(b, SEQ) < 0.15) & (mask > 0)).astype(np.float32)
    binary = rng.randint(0, 2, b).astype(np.int32)
    return tokens, labels, loss_mask, types, mask, binary


def _torch_batch(batch):
    tokens, labels, loss_mask, types, mask, binary = (
        torch.from_numpy(a) for a in batch)
    return dict(tokens=tokens.long(), lm_labels=labels.long(),
                loss_mask=loss_mask, token_types=types.long(),
                attention_mask=mask, binary_labels=binary.long())


def _jax_loss(jm, batch):
    tokens, labels, loss_mask, types, mask, binary = map(jnp.asarray, batch)

    def loss(p):
        return jm.loss(p, tokens, labels, loss_mask=loss_mask,
                       token_types=types, attention_mask=mask,
                       binary_labels=binary)
    return loss


def test_bridge_round_trip_is_bit_exact():
    jm, jp, cfg = _models()
    for dtype in (jnp.float32, jnp.bfloat16):
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(dtype)),
                                      jp)
        sd = params_from_jax(tree, cfg)
        pm = BertModel(cfg, device="cpu")
        assert set(sd) == set(pm.state_dict())
        back = params_to_numpy(sd, cfg)
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            got = back
            for key in path:
                got = got[key.key]
            raw = leaf.view(np.uint16) if dtype == jnp.bfloat16 else leaf
            np.testing.assert_array_equal(got, raw,
                                          jax.tree_util.keystr(path))
    assert tuple(sd["lm_head.bias"].shape) == (SIZES["vocab_size"],)


def test_bert_loss_and_every_grad_leaf_match_jax():
    jm, jp, cfg = _models()
    batch = _batch(0)
    j_loss, j_grads = jax.jit(jax.value_and_grad(_jax_loss(jm, batch)))(jp)
    pm = _port_model(cfg, jp)
    loss = pm.loss(**_torch_batch(batch))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert all(p.grad is not None for p in pm.parameters())
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    grads = params_to_numpy({n: p.grad for n, p in pm.named_parameters()},
                            cfg)
    _assert_trees_close(grads, j_grads, atol=1e-6)


def test_three_step_fp32_trajectory_matches_jax():
    jm, jp, cfg = _models()
    batch = _batch(1)
    loss_fn = _jax_loss(jm, batch)
    jopt, jsc = JaxAdam(lr=1e-3), JaxScale(init_scale=2.0 ** 12)
    jstate, jls = jopt.init(jp), jsc.init()
    all_finite_j = functools.partial(jax_all_finite, observe=None)

    @jax.jit
    def jstep(params, opt_state, ls):
        scaled, grads = jax.value_and_grad(
            lambda p: loss_fn(p) * ls.loss_scale)(params)
        grads = jsc.unscale(ls, grads)
        finite = all_finite_j(grads)
        params, opt_state = jopt.step(grads, opt_state, params,
                                      grads_finite=finite)
        return params, opt_state, jsc.update(ls, finite), \
            scaled / ls.loss_scale

    pm = _port_model(cfg, jp)
    params = dict(pm.named_parameters())
    popt, psc = FusedAdam(lr=1e-3), DynamicLossScale(init_scale=2.0 ** 12)
    state, ls = popt.init(params), psc.init(device="cpu")
    tb = _torch_batch(batch)
    for _ in range(3):
        jp, jstate, jls, jloss = jstep(jp, jstate, jls)
        pm.zero_grad(set_to_none=True)
        loss = pm.loss(**tb)
        (loss * ls.loss_scale).backward()
        grads = psc.unscale(ls, {n: p.grad for n, p in params.items()})
        finite = all_finite(grads)
        ls = psc.update(ls, finite)
        popt.step(grads, state, params, grads_finite=finite)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    _assert_trees_close(params_to_numpy(pm.state_dict(), cfg), jp,
                        atol=5e-5)


def test_padded_tokens_do_not_reach_the_real_positions():
    _, jp, cfg = _models()
    pm = _port_model(cfg, jp)
    tb = _torch_batch(_batch(2))
    mask = tb["attention_mask"]
    row = 1
    length = int(mask[row].sum())
    assert length < SEQ
    changed = tb["tokens"].clone()
    changed[row, length:] = (changed[row, length:] + 1) % SIZES["vocab_size"]
    with torch.no_grad():
        a = pm(tb["tokens"], tb["token_types"], mask)
        b = pm(changed, tb["token_types"], mask)
        unmasked = pm(changed, tb["token_types"])
        ref = pm(tb["tokens"], tb["token_types"])
    torch.testing.assert_close(a[row, :length], b[row, :length], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    # without the mask the same change does reach them
    assert (unmasked[row, :length] - ref[row, :length]).abs().max() > 1e-3
