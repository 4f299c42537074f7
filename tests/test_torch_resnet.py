"""Port ResNet-50 path vs the JAX package on the CPU: batch norm and the
model.

- ``sync_batch_norm`` in training and eval, with a residual ``z``, the
  fused ReLU, ``apply_dtype`` bf16 and both channel axes: the output, the
  new running statistics (the unbiased variance, the momentum as written,
  the count) and, at fp32, the grads of x, weight, bias and z against
  ``jax.vjp``; ``SyncBatchNorm``'s buffers updated in place; the
  statistics' backward saves only x (the memory trap);
- XLA ``"SAME"`` padding (``_same_pads`` against ``lax.padtype_to_pads``),
  the space-to-depth stem against the plain stem;
- a small ResNet (stages (1, 1, 1, 1), width 8, 10 classes, 4 x 40 x 40
  images: stride-2 3x3 convs over 10 (pads (0, 1)), 5 and 3 (pads (1,
  1))) from the JAX ``init`` through the bridge: logits, the new BN state
  and every grad leaf at fp32, with ``stem_space_to_depth`` off and on;
  eval mode; bf16 compute's logits, loss and BN state;
- bf16 compute's grads no farther from fp32 compute's than the
  reference's are from its own (0.33 against 0.35 of the fp32 norm here),
  the head's bias grad within 0.05 in both;
- the bridge round trip, and the full ResNet-50's parameter count and
  leaves.

Tolerances: fp32 1e-5 on logits, losses and BN state; grads 1e-5, or
1e-5 of a leaf's largest magnitude where that passes 1 (summation order
only: the worst leaf's error reads ~1.9e-6 on values up to 0.16); bf16
compute 3% of the logits' largest magnitude (the two frameworks round
bf16 convs at other places: 2% here), and the logits and the loss no
farther from the fp32 model's than twice the JAX bf16 model's distance
(the JAX bf16 loss is 0.0048 from the fp32 one, the port's 0.0035).
bf16 grads are not compared:
BN's backward cancels its terms, so a bf16 rounding moves a grad leaf by
up to ~50% of its fp32 value in both packages alike at this size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.models import ResNet50 as JaxResNet
from apex_tpu.models import ResNetConfig as JaxResNetConfig
from apex_tpu.parallel.sync_batchnorm import BatchNormState as JaxBNState
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as jax_bn
from apex_tpu_torch._bridge import (resnet_params_from_jax,
                                    resnet_params_to_numpy)
from apex_tpu_torch.models import ResNet50, ResNetConfig
from apex_tpu_torch.models.resnet import _same_pads
from apex_tpu_torch.parallel import (BatchNormState, SyncBatchNorm,
                                     sync_batch_norm)

SMALL = dict(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8)
BATCH, IMG = 4, 40
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_rel(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    tol = rel * max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol,
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# sync_batch_norm
# ---------------------------------------------------------------------------

def _bn_inputs(channel_axis, dtype, seed=0):
    rng = np.random.RandomState(seed)
    shape = (4, 6, 5, 5) if channel_axis == 1 else (4, 5, 5, 6)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    z = rng.randn(*shape).astype(np.float32)
    w = (rng.rand(6) + 0.5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    st = (rng.randn(6).astype(np.float32), (rng.rand(6) + 0.5)
          .astype(np.float32), np.int32(3))
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    return x, z, w, b, st, jx, torch.from_numpy(_np(jx).copy()).to(tdt)


@pytest.mark.parametrize("channel_axis", [1, -1])
@pytest.mark.parametrize("apply", [None, "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_sync_batch_norm_matches_jax(training, residual, apply,
                                     channel_axis):
    dtype = apply or "float32"
    x, z, w, b, st, jx, tx = _bn_inputs(channel_axis, dtype)
    jdt, tdt = DTYPES[dtype]
    kw = dict(training=training, momentum=0.1, eps=1e-5,
              channel_axis=channel_axis, fuse_relu=residual)
    ref, ref_st = jax_bn(
        jx, jnp.asarray(w), jnp.asarray(b),
        JaxBNState(*map(jnp.asarray, st)),
        z=jnp.asarray(z, jdt) if residual else None,
        apply_dtype=None if apply is None else jdt, **kw)
    out, new_st = sync_batch_norm(
        tx, torch.from_numpy(w), torch.from_numpy(b),
        BatchNormState(*(torch.as_tensor(s) for s in st)),
        z=torch.from_numpy(z).to(tdt) if residual else None,
        apply_dtype=None if apply is None else tdt, **kw)
    assert out.dtype == tdt and tuple(out.shape) == jx.shape
    tol = 1e-5 if apply is None else 2 ** -7 * float(np.abs(_np(ref)).max())
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=0)
    for got, want in zip(new_st[:2], ref_st[:2]):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    assert int(new_st.num_batches_tracked) == int(ref_st.num_batches_tracked)


@pytest.mark.parametrize("residual", [False, True])
def test_sync_batch_norm_grads_match_jax(residual):
    x, z, w, b, st, _, _ = _bn_inputs(1, "float32", seed=1)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    state = JaxBNState(*map(jnp.asarray, st))

    def fn(x, w, b, z):
        return jax_bn(x, w, b, state, z=z if residual else None,
                      fuse_relu=residual)[0]

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w, b, z)))
    ref = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b, z)]
    out, _ = sync_batch_norm(
        args[0], args[1], args[2],
        BatchNormState(*(torch.as_tensor(s) for s in st)),
        z=args[3] if residual else None, fuse_relu=residual)
    out.backward(torch.from_numpy(g))
    for name, a, r in zip("xwbz", args, ref):
        got = a.grad if a.grad is not None else torch.zeros_like(a)
        _close_rel(_np(got), r, what=name)


def test_sync_batch_norm_module_updates_buffers_in_place():
    x, _, w, b, _, _, _ = _bn_inputs(1, "float32", seed=3)
    bn = SyncBatchNorm(6, device="cpu")
    assert int(bn.num_batches_tracked) == 0
    buf = bn.running_mean
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    out = bn(torch.from_numpy(x))
    ref, ref_st = jax_bn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         JaxBNState(jnp.zeros(6), jnp.ones(6),
                                    jnp.asarray(0, jnp.int32)))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    assert bn.running_mean is buf and int(bn.num_batches_tracked) == 1
    np.testing.assert_allclose(_np(bn.running_var),
                               np.asarray(ref_st.running_var), atol=1e-6)
    bn.eval()
    ref_eval, _ = jax_bn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         ref_st, training=False)
    np.testing.assert_allclose(_np(bn(torch.from_numpy(x))),
                               np.asarray(ref_eval), atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    free = SyncBatchNorm(6, track_running_stats=False, device="cpu").eval()
    before = free.running_mean.clone()
    free(torch.from_numpy(x))
    assert torch.equal(free.running_mean, before)


def test_sync_batch_norm_axis_raises():
    """An axis that is not bound (no parallel state here) raises at the
    call; the module and the model take the axis at construction (the
    reduction across ranks: ``tests/test_torch_sync_dist.py``)."""
    x = torch.zeros(2, 3, 4, 4)
    st = BatchNormState(torch.zeros(3), torch.ones(3), torch.tensor(0))
    with pytest.raises(ValueError, match="not bound"):
        sync_batch_norm(x, None, None, st, axis_name="data")
    with pytest.raises(ValueError, match="not bound"):
        SyncBatchNorm(3, axis_name="data", device="cpu")(x)
    model = ResNet50(ResNetConfig(bn_axis_name="data", **SMALL),
                     device="cpu")
    with pytest.raises(ValueError, match="not bound"):
        model(torch.zeros(2, 40, 40, 3))


def test_statistics_save_only_the_input():
    """The memory trap: in the bf16 apply path nothing the size of x is
    saved in fp32, and the statistics' function saves x itself."""
    x = torch.randn(8, 16, 6, 6).to(torch.bfloat16).requires_grad_()
    st = BatchNormState(torch.zeros(16), torch.ones(16), torch.tensor(0))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = sync_batch_norm(x, torch.ones(16), torch.zeros(16), st,
                                 fuse_relu=True, apply_dtype=torch.bfloat16)
    big = [t for t in saved if t.numel() == x.numel()]
    assert big and all(t.dtype == torch.bfloat16 for t in big)
    assert any(t.data_ptr() == x.data_ptr() for t in big)
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# padding and the stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k,stride", [(56, 3, 2), (7, 3, 2), (10, 3, 2),
                                           (5, 3, 2), (56, 1, 2), (56, 3, 1),
                                           (3, 3, 2), (224, 7, 2)])
def test_same_pads_match_xla(size, k, stride):
    ref = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert _same_pads(size, k, stride) == tuple(ref)


def test_space_to_depth_stem_equals_plain():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32)).to(
        memory_format=torch.channels_last)
    w = torch.from_numpy((rng.randn(16, 3, 7, 7) * 0.1).astype(np.float32))
    plain = ResNet50(ResNetConfig(compute_dtype=torch.float32, **SMALL),
                     device="cpu")
    s2d = ResNet50(ResNetConfig(compute_dtype=torch.float32,
                                stem_space_to_depth=True, **SMALL),
                   device="cpu")
    a = plain._stem_conv(w, x)
    b = s2d._stem_conv(w, x)
    assert a.shape == b.shape == (2, 16, 32, 32)
    np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _np_init(jm, rng):
    """Seeded numpy weights in the JAX ``init`` trees' layout (its shapes
    from ``eval_shape``; the JAX ``init`` itself costs seconds of op by op
    random draws): the reference's conv and head laws, BN scales and
    shifts and running statistics moved off their initial values so that
    every term shows."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "conv" in name:
            fan_out = s.shape[0] * s.shape[1] * s.shape[3]
            return (rng.randn(*s.shape) * (2.0 / fan_out) ** 0.5).astype(
                s.dtype)
        if "fc" in name:
            return (rng.uniform(-1, 1, s.shape) * 0.1).astype(s.dtype)
        if s.dtype == np.int32:
            return np.asarray(rng.randint(0, 5), np.int32)
        base = 1.0 if ("weight" in name or "running_var" in name) else 0.0
        return (base + 0.2 * rng.rand(*s.shape)).astype(s.dtype)

    return tuple(jax.tree_util.tree_map_with_path(leaf, t) for t in shapes)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype: str, s2d: bool):
    jdt = DTYPES[dtype][0]
    jm = JaxResNet(JaxResNetConfig(compute_dtype=jdt,
                                   stem_space_to_depth=s2d, **SMALL))
    rng = np.random.RandomState(0)
    params, state = _np_init(jm, rng)
    x = rng.randn(BATCH, IMG, IMG, 3).astype(np.float32)
    labels = rng.randint(0, SMALL["num_classes"], BATCH)

    def loss_fn(p, s, training):
        logits, ns = jm(p, s, jnp.asarray(x), training=training)
        onehot = jax.nn.one_hot(labels, SMALL["num_classes"])
        loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        return loss, (logits, ns)

    train = jax.jit(jax.value_and_grad(lambda p, s: loss_fn(p, s, True),
                                       has_aux=True))
    return params, state, x, labels, train(params, state), jm


def _port_model(dtype: str, s2d: bool, params, state):
    model = ResNet50(ResNetConfig(compute_dtype=DTYPES[dtype][1],
                                  stem_space_to_depth=s2d, **SMALL),
                     device="cpu")
    model.load_state_dict(resnet_params_from_jax(params, state))
    return model


@pytest.mark.parametrize("s2d", [False, True])
def test_small_resnet_fp32_matches_jax(s2d):
    params, state, x, labels, ((loss_ref, (logits_ref, st_ref)), g_ref), _ \
        = _jax_model("float32", s2d)
    model = _port_model("float32", s2d, params, state)
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), np.asarray(logits_ref),
                               atol=1e-5)
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-5
    _, st = resnet_params_to_numpy(dict(model.named_buffers()))
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(st_ref),
                                jax.tree_util.tree_leaves(st)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    grads, _ = resnet_params_to_numpy({n: p.grad for n, p in
                                       model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(g_ref)
    assert len(leaves) == len(list(model.parameters()))
    for path, ref in leaves:
        got = grads
        for key in path:
            got = got[key.key]
        _close_rel(got, ref, what=jax.tree_util.keystr(path))


def test_small_resnet_eval_matches_jax():
    params, state, x, _, _, jm = _jax_model("float32", False)
    logits_ref = jax.jit(lambda p, s: jm(p, s, jnp.asarray(x),
                                         training=False)[0])(params, state)
    model = _port_model("float32", False, params, state).eval()
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(_np(logits), np.asarray(logits_ref),
                               atol=1e-5)
    assert all(torch.equal(b, before[n]) for n, b in model.named_buffers())


def test_small_resnet_bf16_forward_matches_jax():
    params, state, x, labels, ((loss_ref, (logits_ref, st_ref)), _), _ = \
        _jax_model("bfloat16", False)
    model = _port_model("bfloat16", False, params, state)
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    ref = np.asarray(logits_ref)
    np.testing.assert_allclose(_np(logits), ref,
                               atol=0.03 * float(np.abs(ref).max()))
    # and no farther from the fp32 model than twice the JAX bf16 model is
    (loss32, (logits32, _)), _ = _jax_model("float32", False)[4]
    logits32 = np.asarray(logits32)
    assert (np.abs(_np(logits) - logits32).max()
            <= 2 * np.abs(ref - logits32).max())
    loss = F.cross_entropy(logits.detach(), torch.from_numpy(labels))
    assert (abs(float(loss) - float(loss32))
            <= 2 * abs(float(loss_ref) - float(loss32)) + 1e-5)
    _, st = resnet_params_to_numpy(dict(model.named_buffers()))
    for name in ("stem", "b1_0"):
        node = st[name]["bn"] if name == "stem" else st[name]["bn2"]
        ref_node = (st_ref[name]["bn"] if name == "stem"
                    else st_ref[name]["bn2"])
        for got, want in zip(node, ref_node):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(
                np.asarray(got, np.float32), want,
                atol=0.03 * max(float(np.abs(want).max()), 1.0))


def test_bridge_round_trip_is_exact():
    params, state = _jax_model("float32", True)[:2]
    sd = resnet_params_from_jax(params, state)
    assert sd["stem.conv"].shape == (8, 3, 7, 7)
    assert sd["b1_0.bn1.num_batches_tracked"].dtype == torch.int64
    p2, s2 = resnet_params_to_numpy(sd)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(p2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(s2)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_full_resnet50_matches_the_reference_layout():
    jm = JaxResNet(JaxResNetConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    model = ResNet50(ResNetConfig(), device="cpu")
    sd = model.state_dict()
    from_ref = resnet_params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes[0]),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes[1]))
    assert set(from_ref) == set(sd)
    assert all(tuple(from_ref[k].shape) == tuple(sd[k].shape) for k in sd)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes[0])) == 25557032
    assert len(list(model.parameters())) == 161


def test_init_law():
    model = ResNet50(ResNetConfig(**SMALL), device="cpu").init(
        torch.Generator().manual_seed(0))
    again = ResNet50(ResNetConfig(**SMALL), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    w = model.b3_0.conv2
    std = (2.0 / (w.shape[0] * 9)) ** 0.5
    assert abs(float(w.detach().std()) / std - 1) < 0.1
    bound = 1 / model.feat_ch ** 0.5
    assert float(model.fc.weight.abs().max()) <= bound
    assert float(model.fc.bias.abs().max()) == 0.0
    assert float(model.b0_0.bn3.running_var.min()) == 1.0


def _port_grads(dtype):
    params, state, x, labels = _jax_model(dtype, False)[:4]
    model = _port_model(dtype, False, params, state)
    F.cross_entropy(model(torch.from_numpy(x)),
                    torch.from_numpy(labels)).backward()
    grads, _ = resnet_params_to_numpy({n: p.grad for n, p in
                                       model.named_parameters()})
    return grads


def _gap(got, ref, leaf=None):
    """``||got - ref|| / ||ref||`` over every leaf as one vector, or over
    the head's ``leaf``."""
    leaves = jax.tree_util.tree_leaves
    pairs = (zip(leaves(got), leaves(ref)) if leaf is None
             else [(got["fc"][leaf], ref["fc"][leaf])])
    num = den = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


def test_bf16_grads_stray_from_fp32_as_far_as_the_reference():
    """bf16 compute's grads against fp32 compute's from the same weights,
    in each package: the BN body's grads are rounding-dominated in both
    (their distance from fp32 is of the order of the fp32 grads' norm), so
    the port's distance must stay within 1.5x the reference's, and the
    head's bias grad, the batch mean of softmax - onehot, close in both
    (the limits ``chip_smoke.py::train_resnet`` states for its O0 leg)."""
    jax32 = _jax_model("float32", False)[4][1]
    jax16 = _jax_model("bfloat16", False)[4][1]
    port32, port16 = _port_grads("float32"), _port_grads("bfloat16")
    ref_gap, gap = _gap(jax16, jax32), _gap(port16, port32)
    assert 0.05 < ref_gap and gap <= 1.5 * ref_gap, (gap, ref_gap)
    assert _gap(port16, port32, "bias") <= 0.05
    assert _gap(jax16, jax32, "bias") <= 0.05
