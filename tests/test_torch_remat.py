"""Activation remat on the port's GPT and BERT (``apex_tpu_torch/remat.py``)
against the JAX package's (``apex_tpu/remat.py``) on the CPU.

- The policy object: validation, ``resolve`` over every spelling, the
  legacy bool's warning, ``uses_names``, ``save_names`` and the models'
  ``remat_names`` checks raise the same exception types and give the same
  policy as the JAX package's (the cases of ``tests/test_remat_policy.py``).
- Numbers against JAX: for ``none``, ``full``, ``selective``, ``offload``
  and ``selective`` with ``names=("qkv_out",)``, the loss and every grad
  leaf of GPT and of BERT against the JAX model's ``loss`` and
  ``jax.grad`` under the same policy, on the same weights (the JAX ``init``
  through the bridge), at ``tests/test_torch_train.py``'s fp32 tolerance
  (1e-5 on the loss, 1e-6 absolute on grads up to ~0.2: summation order
  only).
- Numbers against the port's own ``none``: every policy's loss and grads
  equal bit for bit, with and without hidden and attention dropout from
  one explicit generator, which ends where ``none`` leaves it; the flash
  op's in-kernel dropout under each wrap.
- What is recomputed, counted with a ``TorchDispatchMode`` and the plain
  flash forward's calls: ``none`` and ``full`` call no tag and ``none``
  runs the aten ops of the unwrapped layers; ``full`` runs each layer's
  forward again (its GEMMs, the flash forward); ``selective`` and
  ``offload`` run no GEMM and no flash forward again, and ``offload``
  moves the kept set through host copies.
- The tag registry: every tag literal in ``apex_tpu_torch/`` is in
  ``CHECKPOINT_NAMES``, and every registry name is emitted.

Sizes: 2 layers, hidden 64, 4 heads, vocab 128, seq 32, fp32; the JAX
models are built once a module.
"""

import ast
import dataclasses
import importlib
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import remat as jremat
from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu_torch import remat as premat
from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
from apex_tpu_torch.models import BertConfig, BertModel, GPTConfig, GPTModel
from apex_tpu_torch.models import gpt as pgpt

pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

SIZES = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32)
SEQ = 32
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)
POLICIES = {"none": "none", "full": "full", "selective": "selective",
            "offload": "offload", "selective_qkv": ("qkv_out",)}
PKG = pathlib.Path(premat.__file__).resolve().parent


def _policy(mod, key):
    """The policy ``key`` names, as ``mod`` (either package's remat)
    spells it."""
    value = POLICIES[key]
    if isinstance(value, tuple):
        return mod.RematPolicy(mode="selective", names=value)
    return value


# ---------------------------------------------------------------------------
# the policy object, against the JAX package's
# ---------------------------------------------------------------------------

def _outcome(fn):
    """``fn()``'s result as comparable data, or the type of what it
    raised."""
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = fn()
    except Exception as err:                  # noqa: BLE001
        return type(err)
    warned = [w.category for w in seen]
    if isinstance(got, (jremat.RematPolicy, premat.RematPolicy)):
        got = (got.mode, got.names, got.save_names, got.uses_names,
               got.offload_src, got.offload_dst)
    return got, warned


POLICY_CASES = {
    "default": lambda m: m.RematPolicy(),
    "mode_full": lambda m: m.RematPolicy(mode="full"),
    "mode_offload": lambda m: m.RematPolicy(mode="offload"),
    "bad_mode": lambda m: m.RematPolicy(mode="everything"),
    "unregistered_name": lambda m: m.RematPolicy(mode="selective",
                                                 names=("rogue",)),
    "names_need_name_mode": lambda m: m.RematPolicy(mode="full",
                                                    names=("qkv_out",)),
    "names_to_tuple": lambda m: m.RematPolicy(mode="selective",
                                              names=["qkv_out", "ln_out"]),
    "selective_default_save": lambda m: m.RematPolicy(mode="selective"),
    "resolve_none": lambda m: m.RematPolicy.resolve(None),
    "resolve_false": lambda m: m.RematPolicy.resolve(False),
    "resolve_true": lambda m: m.RematPolicy.resolve(True),
    "resolve_str": lambda m: m.RematPolicy.resolve("selective"),
    "resolve_policy": lambda m: m.RematPolicy.resolve(
        m.RematPolicy(mode="offload", names=("flash_ctx",))),
    "resolve_float": lambda m: m.RematPolicy.resolve(3.14),
    "legacy_true": lambda m: m.RematPolicy.resolve(None, legacy_bool=True,
                                                   owner="X"),
    "legacy_false": lambda m: m.RematPolicy.resolve(None,
                                                    legacy_bool=False),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_object_matches_jax(case):
    fn = POLICY_CASES[case]
    assert _outcome(lambda: fn(premat)) == _outcome(lambda: fn(jremat))


def test_registry_and_save_list_match_jax():
    assert premat.CHECKPOINT_NAMES == jremat.CHECKPOINT_NAMES
    assert premat.SELECTIVE_SAVE == jremat.SELECTIVE_SAVE
    policy = premat.RematPolicy(mode="selective")
    assert policy.save_names == premat.SELECTIVE_SAVE
    with pytest.raises(ValueError, match="CHECKPOINT_NAMES"):
        premat.tag(torch.zeros(1), "rogue")


def test_resolve_returns_the_same_object():
    p = premat.RematPolicy(mode="offload")
    assert premat.RematPolicy.resolve(p) is p
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert premat.RematPolicy.resolve(None,
                                          legacy_bool=False).mode == "none"


CONFIG_CASES = {
    "names_without_name_policy": dict(remat_policy="full",
                                      remat_names=("qkv_out",)),
    "names_with_selective": dict(remat_policy="selective",
                                 remat_names=("qkv_out", "flash_ctx")),
    "conflicting_lists": dict(remat_names=("qkv_out",)),
    "same_lists": dict(remat_names=("ln_out",)),
    "legacy_bool": dict(remat=True),
    "policy_beats_legacy": dict(remat=True, remat_policy="selective"),
    "default": dict(),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_resolution_matches_jax(case):
    kw = dict(CONFIG_CASES[case])
    small = dict(SIZES, num_layers=1)

    def build(cfg_cls, model_cls, mod, **extra):
        if case in ("conflicting_lists", "same_lists"):
            kw["remat_policy"] = mod.RematPolicy(mode="selective",
                                                 names=("ln_out",))
        return model_cls(cfg_cls(**small, **kw), **extra).remat_policy

    got = _outcome(lambda: build(GPTConfig, GPTModel, premat, device="cpu"))
    want = _outcome(lambda: build(JaxGPTConfig, JaxGPT, jremat))
    assert got == want


# ---------------------------------------------------------------------------
# numbers against the JAX package
# ---------------------------------------------------------------------------

def _tokens(seed, shape=(2, SEQ)):
    return np.random.RandomState(seed).randint(0, SIZES["vocab_size"],
                                               shape)


def _assert_trees_close(got, ref, atol):
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(r, np.float32), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX GPT's params, batch, and loss and grads under each policy."""
    tok = _tokens(0)
    params = None
    out = {}
    for key in POLICIES:
        jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32,
                                 remat_policy=_policy(jremat, key),
                                 **SIZES))
        if params is None:
            params = jm.init(jax.random.PRNGKey(0))
        out[key] = jax.jit(jax.value_and_grad(
            lambda p, jm=jm: jm.loss(p, jnp.asarray(tok),
                                     jnp.asarray(tok))))(params)
    return params, tok, out


@pytest.fixture(scope="module")
def jax_bert():
    """JAX BERT's params, batch, and loss and grads under each policy."""
    rng = np.random.RandomState(1)
    tokens = _tokens(1)
    labels = _tokens(2)
    mask = (np.arange(SEQ)[None] < np.array([[SEQ], [21]])).astype(np.int32)
    types = (np.arange(SEQ)[None] >= 11).astype(np.int32) * mask
    loss_mask = ((rng.rand(2, SEQ) < 0.3) & (mask > 0)).astype(np.float32)
    binary = np.array([0, 1], np.int32)
    batch = (tokens, labels, loss_mask, types, mask, binary)
    params = None
    out = {}
    for key in POLICIES:
        jm = JaxBert(JaxBertConfig(compute_dtype=jnp.float32,
                                   remat_policy=_policy(jremat, key),
                                   **SIZES))
        if params is None:
            params = jm.init(jax.random.PRNGKey(1))
        t, lab, lm, ty, am, bl = map(jnp.asarray, batch)
        out[key] = jax.jit(jax.value_and_grad(
            lambda p, jm=jm: jm.loss(p, t, lab, loss_mask=lm, token_types=ty,
                                     attention_mask=am, binary_labels=bl)))(
            params)
    return params, batch, out


def _gpt(key, params, **extra):
    cfg = GPTConfig(compute_dtype=torch.float32,
                    remat_policy=_policy(premat, key), **SIZES, **extra)
    pm = GPTModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return pm


def _bert(key, params, **extra):
    cfg = BertConfig(compute_dtype=torch.float32,
                     remat_policy=_policy(premat, key), **SIZES, **extra)
    pm = BertModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return pm


def _bert_kw(batch):
    tokens, labels, loss_mask, types, mask, binary = (
        torch.from_numpy(np.asarray(a)) for a in batch)
    return dict(tokens=tokens.long(), lm_labels=labels.long(),
                loss_mask=loss_mask, token_types=types.long(),
                attention_mask=mask, binary_labels=binary.long())


def _grads(pm):
    return params_to_numpy({n: p.grad for n, p in pm.named_parameters()},
                           pm.cfg)


@pytest.mark.parametrize("key", list(POLICIES))
def test_gpt_policy_matches_jax(key, jax_gpt):
    params, tok, out = jax_gpt
    j_loss, j_grads = out[key]
    pm = _gpt(key, params)
    assert pm.remat_policy.mode == (
        "selective" if key == "selective_qkv" else key)
    t = torch.from_numpy(tok)
    loss = pm.loss(t, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    _assert_trees_close(_grads(pm), j_grads, atol=1e-6)


@pytest.mark.parametrize("key", list(POLICIES))
def test_bert_policy_matches_jax(key, jax_bert):
    params, batch, out = jax_bert
    j_loss, j_grads = out[key]
    pm = _bert(key, params)
    loss = pm.loss(**_bert_kw(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    _assert_trees_close(_grads(pm), j_grads, atol=1e-6)


# ---------------------------------------------------------------------------
# every policy against the port's own none, bit for bit
# ---------------------------------------------------------------------------

def _step(pm, loss_fn, seed=None):
    """One forward and backward: ``(loss, {name: grad}, the generator's
    state after)``."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss = loss_fn(pm, gen)
    loss.backward()
    return (loss.detach(), {n: p.grad.clone()
                            for n, p in pm.named_parameters()},
            None if gen is None else gen.get_state())


def _assert_bitwise(got, want, what):
    assert torch.equal(got[0], want[0]), f"{what}: loss"
    for name in want[1]:
        assert torch.equal(got[1][name], want[1][name]), f"{what}: {name}"
    if want[2] is not None:
        assert torch.equal(got[2], want[2]), f"{what}: generator state"


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_every_policy_equals_none_bit_for_bit(model, dropout, jax_gpt,
                                              jax_bert):
    extra = DROPOUT if dropout else {}
    seed = 5 if dropout else None
    if model == "gpt":
        params, tok, _ = jax_gpt
        t = torch.from_numpy(tok)
        build = _gpt

        def loss_fn(pm, gen):
            return pm.loss(t, t, generator=gen)
    else:
        params, batch, _ = jax_bert
        kw = _bert_kw(batch)
        build = _bert

        def loss_fn(pm, gen):
            return pm.loss(**kw, generator=gen)
    base = _step(build("none", params, **extra), loss_fn, seed)
    for key in POLICIES:
        if key != "none":
            _assert_bitwise(_step(build(key, params, **extra), loss_fn,
                                  seed), base, f"{model} {key}")


def test_flash_inkernel_dropout_bit_identical():
    """The flash op's counter-hash dropout under each policy's wrap: the
    grads equal the unwrapped op's bit for bit (a flipped mask bit would
    move an entry by O(grad))."""
    rng = np.random.RandomState(0)
    q, k, v, dy = (torch.from_numpy(rng.randn(1, 2, 128, 16).astype(
        np.float32)) for _ in range(4))

    def f(q, k, v):
        out = pfa.flash_attention(q, k, v, causal=True, dropout_rate=0.3,
                                  dropout_seed=7, checkpoint_names=True)
        return (out * dy).sum()

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves).backward()
        return [x.grad for x in leaves]

    base = grads(f)
    for mode in ("full", "selective", "offload"):
        got = grads(premat.RematPolicy(mode=mode).wrap(f))
        for b, g in zip(base, got):
            assert torch.equal(b, g), mode


# ---------------------------------------------------------------------------
# what is recomputed
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """The aten ops run under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))

    def gemms(self) -> int:
        return sum(op.startswith(("aten.mm.", "aten.bmm.", "aten.addmm."))
                   for op in self.ops)


@pytest.fixture
def counted(monkeypatch):
    """Counts of the plain flash forward's calls and of tag calls, both
    patched in before a model is built."""
    calls = {"flash": 0, "tag": 0}
    flash, tag = pfa._flash_fwd_plain, premat.tag

    def flash_counted(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    def tag_counted(x, name):
        calls["tag"] += 1
        return tag(x, name)
    monkeypatch.setattr(pfa, "_flash_fwd_plain", flash_counted)
    monkeypatch.setattr(pfa, "tag", tag_counted)
    monkeypatch.setattr(pgpt, "_remat_tag", tag_counted)
    return calls


def _recompute_counts(key, params, tok, counted):
    """``(tag calls, flash forwards in the forward, in the backward, GEMMs
    in the forward, in the backward)`` of one step under ``key``."""
    pm = _gpt(key, params)
    t = torch.from_numpy(tok)
    fwd = _Ops()
    with fwd:
        loss = pm.loss(t, t)
    tags, flash_fwd = counted["tag"], counted["flash"]
    bwd = _Ops()
    with bwd:
        loss.backward()
    return (tags, flash_fwd, counted["flash"] - flash_fwd, fwd.gemms(),
            bwd.gemms())


def test_none_runs_the_unwrapped_forward(jax_gpt, counted):
    """``none`` calls no tag, and its forward runs exactly the aten ops of
    the layers called one by one without a wrap."""
    params, tok, _ = jax_gpt
    pm = _gpt("none", params)
    t = torch.from_numpy(tok)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            plain = _Ops()
            with plain:
                x = pm.embed(t)
                for lp in pm.layers:
                    x = pm._layer(lp, x)
                pm.logits(pm._ln(pm.final_ln, x))
            wrapped = _Ops()
            with wrapped:
                pm(t)
        assert wrapped.ops == plain.ops, grad
    assert counted["tag"] == 0


def test_recompute_by_policy(jax_gpt, counted):
    params, tok, _ = jax_gpt
    layers = SIZES["num_layers"]
    counted["tag"] = counted["flash"] = 0
    none = _recompute_counts("none", params, tok, counted)
    counted["tag"] = counted["flash"] = 0
    full = _recompute_counts("full", params, tok, counted)
    # none and full call no tag; each runs one flash forward a layer
    assert none[0] == full[0] == 0
    assert none[1] == full[1] == layers and none[2] == 0
    # full: each layer's forward again in the backward, flash and GEMMs
    # (PyTorch's recompute stops at the layer's last saved tensor, the
    # inputs of fc2's GEMM, before that GEMM runs)
    assert full[2] == layers
    per_layer = (none[3] - 1) // layers        # the tied head is one GEMM
    assert (none[4] + layers * (per_layer - 1) <= full[4]
            <= none[4] + layers * per_layer), (none, full)
    for key in ("selective", "offload"):
        counted["tag"] = counted["flash"] = 0
        before = dict(premat.HOST_COPIES)
        got = _recompute_counts(key, params, tok, counted)
        # 8 tags a layer (ln1, qkv, ctx, lse, proj, ln2, fc1, fc2) and
        # the final LayerNorm's
        assert got[0] == 8 * layers + 1, key
        # no flash forward and no GEMM again
        assert got[1] == layers and got[2] == 0, key
        assert got[3] == none[3] and got[4] == none[4], key
        copies = {k: premat.HOST_COPIES[k] - before[k] for k in before}
        if key == "offload":
            # the kept tags the backward reads went to the host and back
            assert copies["to_host"] > 0 and copies["to_device"] > 0
        else:
            assert copies == {"to_host": 0, "to_device": 0}
    # a save-list without the flash residuals runs the flash forward again
    counted["tag"] = counted["flash"] = 0
    qkv = _recompute_counts("selective_qkv", params, tok, counted)
    assert qkv[2] == layers and none[4] < qkv[4] < full[4]


def test_tag_outside_a_region_is_free():
    """Outside a name-based region ``tag`` returns its argument and runs
    no aten op."""
    x = torch.randn(3)
    with _Ops() as seen:
        assert premat.tag(x, "qkv_out") is x
    assert seen.ops == []


def test_default_generator_draws_replay_under_every_policy():
    """A random op without a generator (the default CPU generator) inside
    a wrapped function: every policy gives ``none``'s grads and leaves the
    default generator where ``none`` leaves it."""
    x = torch.randn(16, 8)

    def f(x):
        keep = torch.rand(x.shape) >= 0.5
        h = premat.tag(torch.where(keep, x * 3.0, 0.0), "qkv_out")
        return (h.tanh() * torch.rand(x.shape)).sum()

    def run(mode):
        torch.manual_seed(11)
        leaf = x.clone().requires_grad_()
        premat.RematPolicy(mode=mode).wrap(f)(leaf).backward()
        return leaf.grad, torch.get_rng_state()

    base = run("none")
    for mode in ("full", "selective", "offload"):
        got = run(mode)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1],
                                                            base[1]), mode


def test_offload_keeps_host_copies_unpinned_on_the_cpu():
    """On the CPU the offloaded tags are host copies that are not pinned
    (pinning needs a card)."""
    made = []
    empty_like = torch.empty_like

    def spy(*a, **kw):
        out = empty_like(*a, **kw)
        made.append((kw.get("device"), out.is_pinned()))
        return out
    policy = premat.RematPolicy(mode="offload")
    x = torch.randn(4, 8, requires_grad=True)

    def f(x):
        h = premat.tag(x * 2.0, "qkv_out")
        return (h.exp() * 3.0).sum()
    torch.empty_like = spy
    try:
        policy.wrap(f)(x).backward()
    finally:
        torch.empty_like = empty_like
    assert made and all(dev == "cpu" and not pinned for dev, pinned in made)
    torch.testing.assert_close(x.grad, 6.0 * (2.0 * x.detach()).exp())


# ---------------------------------------------------------------------------
# the tag registry
# ---------------------------------------------------------------------------

TAG_CALLEES = ("tag", "_tag", "_remat_tag")


def _tag_sites():
    """``(file, line, name)`` of every tag call in the package whose
    name argument is a string literal; a call whose name is not a literal
    is ``(file, line, None)``."""
    sites = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or len(node.args) != 2:
                continue
            fn = node.func
            callee = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if callee not in TAG_CALLEES:
                continue
            arg = node.args[1]
            name = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            sites.append((path.relative_to(PKG), node.lineno, name))
    return sites


def test_tag_registry():
    sites = _tag_sites()
    # the registry's own tag call (region.keep's caller) takes a variable
    literal = [s for s in sites if s[2] is not None]
    assert not [s for s in sites if s[2] is None
                and str(s[0]) != "remat.py"], sites
    orphans = [s for s in literal if s[2] not in premat.CHECKPOINT_NAMES]
    assert not orphans, orphans
    emitted = {s[2] for s in literal}
    assert set(premat.CHECKPOINT_NAMES) <= emitted, \
        set(premat.CHECKPOINT_NAMES) - emitted
