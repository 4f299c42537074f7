"""The port's ASP 2:4 sparsity (``apex_tpu_torch.contrib.sparsity``) against
the JAX package's ``apex_tpu.contrib.sparsity`` on the CPU.

- ``mn_1d_mask`` and ``compute_sparse_masks`` bit for bit, ties included
  (zeros, repeated magnitudes, signs of equal magnitude), fp32 and bf16;
- the default whitelist's leaves of a small GPT against the JAX tree's,
  through ``_bridge.params_from_jax``'s name map, and the masks of every
  leaf bit for bit through the same map;
- the permutation search, exhaustive and greedy, the same permutation and
  efficacies as the reference for the same seed; ``permuted_mn_1d_mask``
  bit for bit on a stacked ``(L, out, in)`` array;
- the masked optimizer's 5-step ``FusedAdam`` trajectory (and a sixth
  step forced to overflow) against the JAX one, every pruned entry exactly
  0 after each step;
- masks through a ``torch.save`` round trip (the reference's checkpoint
  test goes through ``apex_tpu.checkpoint``; the port's checkpoint files
  are ``torch.save`` files too, ``tests/test_torch_checkpoint.py``), the
  lazy ``contrib.sparsity``, ``ASP.prune`` in place and ``permute=True``.

Tolerance: masks and permutations exact; the trajectory within 1e-6 of
each tensor's largest magnitude (fp32 Adam on the same grads, whose fp32
sums run in another order).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.sparsity import asp as jasp
from apex_tpu.contrib.sparsity import permutation as jperm
from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch._bridge import params_from_jax
from apex_tpu_torch.contrib.sparsity import asp as pasp
from apex_tpu_torch.contrib.sparsity import permutation as pperm
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

TOL = 1e-6
GPT_SIZES = dict(vocab_size=96, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=64)


def _tied(shape, seed, dtype=np.float32):
    """Random weights with ties: zeros, repeated magnitudes and equal
    magnitudes of opposite sign inside groups of 4."""
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    flat = w.reshape(-1)
    flat[rng.rand(flat.size) < 0.15] = 0.0
    rep = rng.rand(flat.size) < 0.2
    flat[rep] = np.round(flat[rep])
    flat[8:12] = (0.5, -0.5, 0.5, 0.0)
    flat[12:16] = 0.0
    return w.astype(dtype)


@pytest.mark.parametrize("shape", [(7, 32), (3, 4, 16), (2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mn_1d_mask_bit_for_bit(shape, dtype):
    w = _tied(shape, seed=len(shape))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    pw = torch.tensor(w).to(getattr(torch, dtype))
    want = np.asarray(jasp.mn_1d_mask(jw))
    got = pasp.mn_1d_mask(pw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy().reshape(-1, 4).sum(-1) == 2)
    with pytest.raises(ValueError):
        pasp.mn_1d_mask(torch.ones(4, 6))


def test_reference_example():
    w = torch.tensor([[0.1, -0.9, 0.5, 0.01, 4.0, 1.0, -2.0, 3.0]])
    assert pasp.mn_1d_mask(w).tolist() == [[False, True, True, False,
                                             True, False, False, True]]


def _jax_tree(seed=0):
    """A nested tree with whitelisted and blocked leaves of each kind."""
    return {"dense": {"weight": _tied((16, 32), seed),
                      "bias": _tied((32,), seed + 1)},
            "ln": {"weight": _tied((4, 32), seed + 2)},
            "tiny": _tied((4, 8), seed + 3),
            "conv": [_tied((3, 3, 8, 16), seed + 4)],
            "ids": np.arange(32, dtype=np.int32).reshape(2, 16)}


def test_compute_sparse_masks_and_apply_bit_for_bit():
    tree = _jax_tree()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jasp.compute_sparse_masks(jt)
    pt = {"dense": {k: torch.tensor(v) for k, v in tree["dense"].items()},
          "ln": {"weight": torch.tensor(tree["ln"]["weight"])},
          "tiny": torch.tensor(tree["tiny"]),
          "conv": [torch.tensor(tree["conv"][0])],
          "ids": torch.tensor(tree["ids"])}
    got = pasp.compute_sparse_masks(pt)
    assert pasp.sparse_parameter_paths(pt) == ["dense.weight", "conv.0"]
    for (gm, wm) in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    pruned = pasp.apply_masks(pt, got)
    jpruned = jasp.apply_masks(jt, want)
    np.testing.assert_array_equal(pruned["dense"]["weight"].numpy(),
                                  np.asarray(jpruned["dense"]["weight"]))
    assert torch.equal(pruned["ids"], pt["ids"])
    # prune in place, through the workflow object
    asp = pasp.ASP()
    assert asp.prune(pt, got) is pt
    np.testing.assert_array_equal(pt["dense"]["weight"].numpy(),
                                  np.asarray(jpruned["dense"]["weight"]))


def _gpt_params(seed=0):
    """The JAX GPT tree's layout (``eval_shape`` of its init) filled with
    seeded numpy draws, cheaper than the JAX init op by op."""
    jm = JaxGPT(JaxGPTConfig(**GPT_SIZES))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _port_names(jax_path: str, num_layers: int):
    """The port's state-dict names of a JAX GPT leaf path."""
    keys = [k.strip("[]'") for k in jax_path.split("][")]
    if keys[0] == "layers":
        return [f"layers.{i}.{'.'.join(keys[1:])}" for i in range(num_layers)]
    return [".".join(keys)]


def test_whitelist_and_masks_on_gpt_match_the_jax_tree():
    params = _gpt_params()
    cfg = GPTConfig(**GPT_SIZES)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    named = dict(model.named_parameters())
    jpaths = jasp.sparse_parameter_paths(params)
    want = sorted(n for p in jpaths for n in _port_names(p, cfg.num_layers))
    got = sorted(pasp.sparse_parameter_paths(named))
    assert got == want
    assert got == sorted(f"layers.{i}.{n}.weight" for i in range(2)
                         for n in ("qkv", "proj", "fc1", "fc2"))
    jmasks = jax.tree_util.tree_map(
        np.asarray, jasp.compute_sparse_masks(
            jax.tree_util.tree_map(jnp.asarray, params)))
    want_masks = params_from_jax(jmasks, cfg)
    masks = pasp.compute_sparse_masks(named)
    assert masks.keys() == want_masks.keys()
    for name, m in masks.items():
        assert torch.equal(m, want_masks[name]), name


def _adversarial(rows, c, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.rand(rows, c) * 0.1
    w[:, :4] += 10.0
    return w.astype(np.float32)


@pytest.mark.parametrize("method,w", [
    ("exhaustive", np.abs(np.random.RandomState(3).randn(16, 8))),
    ("greedy", _adversarial(32, 16)),
    ("greedy", np.random.RandomState(4).randn(600, 32)),
], ids=["exhaustive", "greedy-adversarial", "greedy-subsampled"])
def test_permutation_search_matches_reference(method, w):
    want = jperm.search_channel_permutation(w, method=method, seed=3)
    got = pperm.search_channel_permutation(torch.tensor(w), method=method,
                                           seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[2] >= got[1]


def test_permuted_mask_on_a_stacked_array_bit_for_bit():
    w = np.stack([_adversarial(8, 32, seed=s) for s in range(3)])
    w[1] = -w[1]
    want = np.asarray(jperm.permuted_mn_1d_mask(jnp.asarray(w)))
    got = pperm.permuted_mn_1d_mask(torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)
    base = pasp.mn_1d_mask(torch.tensor(w))
    kept = lambda m: float((torch.tensor(w).abs() * m).sum())  # noqa: E731
    assert kept(got) > kept(base)
    masks = pasp.ASP(permute=True).compute_sparse_masks(
        {"w": torch.tensor(w[0]), "bias": torch.zeros(32)})
    assert bool(masks["bias"].all())
    np.testing.assert_array_equal(
        masks["w"].numpy(),
        np.asarray(jperm.permuted_mn_1d_mask(jnp.asarray(w[0]))))


def test_masked_optimizer_trajectory_matches_jax():
    rng = np.random.RandomState(1)
    w0 = rng.randn(32, 32).astype(np.float32) * 0.5
    b0 = rng.randn(32).astype(np.float32)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randn(64, 32).astype(np.float32)

    jparams = {"b": jnp.asarray(b0), "w": jnp.asarray(w0)}
    jmasks = jasp.compute_sparse_masks(jparams)
    jopt = jasp.ASP().init_optimizer_for_pruning(JaxAdam(lr=1e-2), jmasks)
    jparams = jasp.apply_masks(jparams, jmasks)
    jstate = jopt.init(jparams)

    def jloss(p):
        return jnp.mean((jnp.asarray(x) @ p["w"] + p["b"]
                         - jnp.asarray(y)) ** 2)

    params = {"b": torch.tensor(b0), "w": torch.tensor(w0)}
    asp = pasp.ASP()
    masks = asp.compute_sparse_masks(params)
    opt = asp.init_optimizer_for_pruning(FusedAdam(lr=1e-2), masks)
    asp.prune(params, masks)
    state = opt.init(params)
    pruned = ~masks["w"]
    assert int(pruned.sum()) == 32 * 16
    for step in range(6):
        overflow = step == 5
        g = jax.grad(jloss)(jparams)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = ((torch.tensor(x) @ leaves["w"] + leaves["b"]
                 - torch.tensor(y)) ** 2).mean()
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        if overflow:
            g = {"b": g["b"], "w": g["w"].at[0, :].set(jnp.nan)}
            grads["w"][0, :] = float("nan")
        finite = torch.tensor(not overflow)
        before = {k: v.clone() for k, v in params.items()}
        jparams, jstate = jopt.step(g, jstate, jparams,
                                    grads_finite=jnp.asarray(not overflow))
        params, state = opt.step(grads, state, params, grads_finite=finite)
        for k in params:
            want = np.asarray(jparams[k])
            limit = TOL * max(1.0, float(np.abs(want).max()))
            assert np.abs(params[k].numpy() - want).max() <= limit, (step, k)
        assert torch.all(params["w"][pruned] == 0)
        assert torch.all(grads["w"][pruned] == 0)
        if overflow:
            for k in params:
                assert torch.equal(params[k], before[k])
        w = params["w"].reshape(32, 8, 4)
        assert torch.all((w != 0).sum(-1) <= 2)


def test_masks_survive_torch_save_and_lazy_import():
    import apex_tpu_torch

    sparsity = apex_tpu_torch.contrib.sparsity
    params = {"w": torch.tensor(_tied((16, 16), 2))}
    masks = sparsity.compute_sparse_masks(params)
    buf = io.BytesIO()
    torch.save({"params": params, "masks": masks}, buf)
    buf.seek(0)
    back = torch.load(buf)
    assert back["masks"]["w"].dtype == torch.bool
    assert torch.equal(back["masks"]["w"], masks["w"])
    assert torch.equal(sparsity.apply_masks(back["params"],
                                            back["masks"])["w"],
                       sparsity.apply_masks(params, masks)["w"])
