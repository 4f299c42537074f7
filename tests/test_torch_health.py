"""The port's numerics watchdog against the JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through
``apex_tpu.observability.health`` and ``apex_tpu_torch.observability.
health``:

- ``tensor_stats`` leaf by leaf on fp32, bf16 and fp16 trees with planted
  NaN, inf and subnormal values (nested dicts in unsorted insertion order,
  lists, a named tuple, an ``OrderedDict``, an empty and an integer leaf):
  the paths and finite and underflow counts exact, the largest magnitudes
  exact (NaN where JAX reads NaN), sums of squares and ``l2`` at rtol 1e-6;
- the observers: ``observe_tree``'s payload and its ``#2`` suffix,
  ``leaf_paths`` and ``decode_attribution`` equal; its gates (no policy,
  level off, a level below ``min_level``, no collector: no aten call, a
  ``TorchDispatchMode`` counts them); ``all_finite`` and
  ``FusedAdam.step`` with the gates shut adding no aten call, and an
  observed step at cheap and full reading no tensor back to the host;
  ``HealthConfig``'s ``ValueError``s; ``HealthMonitor`` at skip, dump and
  raise with ``consecutive`` 1 and 2 over one payload sequence (the same
  streaks, raises and dumps, minus wall time and versions), and the
  amp-overflow-only trigger;
- replica agreement on two gloo ranks (one pool for the module, the rank
  bodies in ``tests/_torch_health_ranks.py``) against ``shard_map`` over
  two devices: agreeing replicas read 0 and a perturbed rank reads JAX's
  value at rtol 1e-6; ``allreduce_grads`` at level "full" records
  ``health/ddp_grads/replica_divergence`` 0 (per leaf and bucketed, and
  nothing over subgroups or at "cheap"); the hybrid trainer at dp 2 reads
  0 for its params and synced grads at "full", and its losses are the
  same bits at off, cheap and full;
- the GPT step of ``bench.py::_gpt_train_step`` (fp32, 2 layers, FusedAdam,
  DynamicLossScale) at "cheap" and "full": the ``health/*`` payload against
  the JAX step's at rtol 1e-5, counts exact, and the same leaf named (as
  its path in each package, mapped through ``_bridge``) for an overflow
  planted in layer 1's first MLP weight.
"""

import collections
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_dist_ranks as DR
import _torch_health_ranks as R
from apex_tpu.amp.scaler import DynamicLossScale as JaxScale
from apex_tpu.amp.scaler import all_finite as jax_all_finite
from apex_tpu.models import GPTConfig as JaxGPTConfig, GPTModel as JaxGPT
from apex_tpu.observability import health as jh
from apex_tpu.observability import ingraph as jing
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch._bridge import params_from_jax, params_to_numpy
from apex_tpu_torch.amp import DynamicLossScale, all_finite
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import health as th
from apex_tpu_torch.observability import ingraph as ting
from apex_tpu_torch.optimizers import FusedAdam

NT = collections.namedtuple("NT", "scale shift")
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "float16": (np.float32, jnp.float16, torch.float16)}
RTOL = 1e-6
GPT_RTOL = 1e-5


@pytest.fixture(scope="module")
def pools():
    p = DR.Pools()
    yield p
    p.close()


def _values(rng, shape, dtype: str, plant: bool):
    """Seeded values with planted NaN, +-inf, tiny values and zeros: fp16
    subnormals; for bf16 and fp32 values just above the smallest normal,
    since XLA's CPU flushes fp32 subnormals to zero, and a bf16 subnormal
    is one once widened (the port's bf16 count is held to numpy's in
    ``test_bf16_subnormals_count``)."""
    x = rng.randn(*shape).astype(np.float32) * 3
    if plant and x.size >= 6:
        flat = x.reshape(-1)
        tiny = float(np.finfo(np.float16).tiny)
        low = (tiny / 4, -tiny / 8) if dtype == "float16" else (
            2 * float(np.finfo(np.float32).tiny),
            -4 * float(np.finfo(np.float32).tiny))
        idx = rng.choice(flat.size, 6, replace=False)
        flat[idx] = [np.nan, np.inf, -np.inf, *low, 0.0]
    return x


def _tree(dtype: str, seed: int = 0):
    """A numpy tree: keys inserted unsorted, nested lists and tuples, a
    named tuple, an OrderedDict, an empty leaf and an integer leaf."""
    rng = np.random.RandomState(seed)
    v = functools.partial(_values, rng, dtype=dtype)
    return {
        "w": v((7, 5), plant=True),
        "b": [v((5,), plant=False), v((3, 4), plant=True)],
        "a": {"z": v((9,), plant=True), "c": v((0, 3), plant=False),
              "n": NT(v((4,), plant=False), v((2, 3), plant=True))},
        "o": collections.OrderedDict(y=v((6,), plant=True),
                                     b=v((2,), plant=False)),
        "steps": np.arange(4, dtype=np.int32),
    }


def _to_jax(tree, jdt):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jdt if a.dtype == np.float32 else a.dtype),
        tree)


def _to_torch(tree, tdt):
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(tdt) if t.is_floating_point() else t
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _to_torch(x, tdt))
                                       for k, x in tree.items())
    if isinstance(tree, dict):
        return {k: _to_torch(x, tdt) for k, x in tree.items()}
    if isinstance(tree, NT):
        return NT(*(_to_torch(x, tdt) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(x, tdt) for x in tree)
    return one(tree)


def _both(dtype: str, seed: int = 0):
    _, jdt, tdt = DTYPES[dtype]
    tree = _tree(dtype, seed)
    return _to_jax(tree, jdt), _to_torch(tree, tdt)


def _np(x):
    return np.asarray(x.detach().double() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float64))


def _same_float(got: float, want: float, rtol: float = 0.0) -> None:
    if math.isnan(want):
        assert math.isnan(got), (got, want)
    elif math.isinf(want) or rtol == 0.0:
        assert got == want, (got, want)
    else:
        assert got == pytest.approx(want, rel=rtol, abs=1e-30), (got, want)


def _same_payload(got: dict, want: dict, rtol: float = RTOL,
                  exact=("nonfinite_count", "first_nonfinite_leaf",
                         "abs_max")) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _same_float(got[k], w, 0.0 if k.endswith(exact) else rtol)


# -- tensor_stats -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tensor_stats_leaf_by_leaf(dtype):
    jtree, ttree = _both(dtype)
    js, ts = jh.tensor_stats(jtree), th.tensor_stats(ttree)
    assert ts.paths == js.paths
    assert ts.sizes == js.sizes and ts.half_mask == js.half_mask
    np.testing.assert_array_equal(_np(ts.finite_count),
                                  np.asarray(js.finite_count))
    np.testing.assert_array_equal(_np(ts.underflow_count),
                                  np.asarray(js.underflow_count))
    np.testing.assert_array_equal(_np(ts.abs_max), np.asarray(js.abs_max,
                                                               np.float64))
    np.testing.assert_allclose(_np(ts.sq_sum), np.asarray(js.sq_sum),
                               rtol=RTOL)
    assert ts.finite_count.dtype == torch.int64
    if dtype == "float16":
        assert int(ts.underflow_count.sum()) > 0
    for view in ("nonfinite_count", "first_nonfinite_index",
                 "abs_max_total", "l2", "underflow_fraction"):
        _same_float(float(getattr(ts, view)()), float(getattr(js, view)()),
                    RTOL if view in ("l2", "underflow_fraction") else 0.0)
    assert th.tensor_stats({"i": torch.arange(3)}) is None


def test_bf16_subnormals_count():
    """bf16 values below its smallest normal, nonzero, count as underflow
    (numpy's count of the same values); zeros and NaN do not."""
    rng = np.random.RandomState(4)
    tiny = float(np.finfo(np.float32).tiny)
    x = rng.randn(64).astype(np.float32)
    x[:10] = tiny * rng.uniform(0.01, 0.99, 10)
    x[10:12] = [0.0, np.nan]
    t = torch.from_numpy(x).to(torch.bfloat16)
    back = t.float().numpy()
    want = int(np.sum((back != 0) & (np.abs(back) < tiny)))
    stats = th.tensor_stats({"x": t})
    assert int(stats.underflow_count[0]) == want > 0
    assert float(stats.underflow_fraction()) == pytest.approx(want / 64)


def test_counts_past_2_24_elements():
    """One NaN in a leaf of more than 2**24 elements counts, and an index
    past it is found."""
    big = torch.zeros(2 ** 24 + 3, dtype=torch.bfloat16)
    big[-1] = float("nan")
    stats = th.tensor_stats({"a": torch.ones(2), "b": big})
    assert int(stats.finite_count[1]) == 2 ** 24 + 2
    assert float(stats.nonfinite_count()) == 1.0
    assert float(stats.first_nonfinite_index()) == 1.0


# -- the observers ------------------------------------------------------------------

def _observe_twice(mod, ing, tree, level="cheap"):
    with mod.activate(mod.HealthConfig(level=level)):
        def body(t):
            mod.observe_tree(t, "grads")
            mod.observe_tree(t, "grads")
            return 0
        _, metrics = ing.reap(body)(tree)
    return metrics.as_floats()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_observe_tree_payload_suffix_and_attribution(dtype):
    jtree, ttree = _both(dtype, seed=1)
    want = _observe_twice(jh, jing, jtree)
    got = _observe_twice(th, ting, ttree)
    assert "health/grads#2/first_nonfinite_leaf" in got
    _same_payload(got, want)
    for name in ("grads", "grads#2"):
        assert th.leaf_paths(name) == jh.leaf_paths(name)
    assert th.decode_attribution(got) == jh.decode_attribution(want)
    assert th.decode_attribution(got)["grads"] == "['a']['n'].shift"


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count(fn):
    with CountOps() as c:
        fn()
    return c.ops


@pytest.mark.parametrize("gate", ["no policy", "off", "below min_level",
                                  "no collector"])
def test_observers_touch_nothing_with_a_gate_shut(gate):
    _, tree = _both("float32")
    level = {"no policy": None, "off": "off", "below min_level": "cheap",
             "no collector": "full"}[gate]
    cfg = None if level is None else th.HealthConfig(level=level)

    def run():
        with th.activate(cfg):
            if gate == "no collector":
                th.observe_tree(tree, "grads")
                th.observe_replica_agreement(tree, "data")
                return
            with ting.collecting() as col:
                th.observe_tree(tree, "grads", min_level="full")
                th.observe_replica_agreement(tree, "data")
            assert not col.freeze().values

    assert _count(run) == {}


def test_all_finite_and_optimizer_add_nothing_below_their_level():
    """With a collector open: ``all_finite`` under no policy or level off
    makes the aten calls of ``all_finite(observe=None)``, and the
    optimizer's step at "cheap" those it makes under no policy."""
    _, tree = _both("float32")
    grads = {"x": tree["w"].nan_to_num(), "y": tree["b"][1].nan_to_num()}
    bare = _count(lambda: all_finite(grads, observe=None))
    for cfg in (None, th.HealthConfig(level="off")):
        def run():
            with th.activate(cfg), ting.collecting():
                all_finite(grads)
        assert _count(run) == bare
    counts = {}
    for level in (None, "cheap"):
        params = {k: v.clone() for k, v in grads.items()}
        opt = FusedAdam(lr=1e-3)
        state = opt.init(params)

        def run():
            with th.activate(level and th.HealthConfig(level=level)), \
                    ting.collecting():
                opt.step(grads, state, params)
        counts[level] = _count(run)
    assert counts[None] == counts["cheap"]


_HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
               "__float__", "__index__")


@pytest.mark.parametrize("level", ["cheap", "full"])
def test_an_observed_step_reads_nothing_back(level, monkeypatch):
    """The watchdog's step (``all_finite``, the scale update and the
    optimizer's step with the skip) reads no tensor back to the host: the
    counts, maxima and first index stay tensors until the reporter's one
    read."""
    _, tree = _both("float32")
    grads = {"x": tree["w"], "y": tree["b"][1], "z": tree["a"]["z"]}
    params = {k: torch.ones_like(v) for k, v in grads.items()}
    opt, scaler = FusedAdam(lr=1e-3), DynamicLossScale(init_scale=2.0)
    state, ls = opt.init(params), scaler.init(device="cpu")
    reads = collections.Counter()
    with monkeypatch.context() as m:
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def wrapped(self, *a, _orig=orig, _name=name, **kw):
                reads[_name] += 1
                return _orig(self, *a, **kw)

            m.setattr(torch.Tensor, name, wrapped)
        with th.activate(th.HealthConfig(level=level)), \
                ting.collecting() as col:
            finite = all_finite(grads)
            scaler.update(ls, finite)
            opt.step(grads, state, params, grads_finite=finite)
            metrics = col.freeze()
    assert not reads, reads
    payload = metrics.as_floats()
    assert payload["health/grads/nonfinite_count"] == 9.0    # 3 a leaf
    assert th.decode_attribution(payload)["grads"] == "['x']"


@pytest.mark.parametrize("kw", [dict(level="basic"),
                                dict(on_nonfinite="ignore"),
                                dict(consecutive=0)])
def test_health_config_errors(kw):
    with pytest.raises(ValueError) as want:
        jh.HealthConfig(**kw)
    with pytest.raises(ValueError) as got:
        th.HealthConfig(**kw)
    assert str(got.value) == str(want.value)


PAYLOADS = [  # (step, payload) a report
    (0, {"health/grads/nonfinite_count": 0.0,
         "health/grads/first_nonfinite_leaf": -1.0}),
    (1, {"health/grads/nonfinite_count": 3.0,
         "health/grads/first_nonfinite_leaf": 2.0,
         "health/grads/abs_max": math.inf}),
    (2, {"health/grads/nonfinite_count": 0.0,
         "health/grads/first_nonfinite_leaf": -1.0}),
    (3, {"amp/overflow_count": 1.0}),          # amp's count alone
    (4, {"health/grads/nonfinite_count": 1.0,
         "health/grads/first_nonfinite_leaf": 0.0,
         "health/grads/abs_max": math.nan}),
    (5, {"health/grads/nonfinite_count": 0.0}),
]


def _monitor_run(mod, cfg_kw, dump_dir):
    """Every payload through a monitor; per report ``(streak, raised)``,
    and the dumps' documents minus wall time and versions."""
    # the grads' paths, as an observed tree leaves them
    tree = {"b": np.ones(2, np.float32), "a": np.ones(3, np.float32),
            "c": [np.ones(1, np.float32)]}
    if mod is th:
        tree = _to_torch(tree, torch.float32)
    with mod.activate(mod.HealthConfig(level="cheap")):
        (jing if mod is jh else ting).reap(
            lambda t: mod.observe_tree(t, "grads"))(tree)
    mon = mod.HealthConfig(dump_dir=str(dump_dir), **cfg_kw).reporter_hook()
    trail = []
    for step, payload in PAYLOADS:
        try:
            mon(step, payload)
            trail.append((mon.streak, None))
        except mod.NonFiniteError as e:
            trail.append((mon.streak, (str(e).split(";")[0],
                                       e.dump.attribution)))
    docs = []
    for path in mon.dumps:
        with open(path) as f:
            doc = json.load(f)
        doc.pop("wall_time"), doc.pop("versions")
        doc["config"].pop("dump_dir")
        docs.append((path.rsplit("/", 1)[-1], doc))
    return trail, docs


@pytest.mark.parametrize("on_nonfinite", list(th.ON_NONFINITE))
@pytest.mark.parametrize("consecutive", [1, 2])
def test_health_monitor_matches_jax(on_nonfinite, consecutive, tmp_path):
    kw = dict(on_nonfinite=on_nonfinite, consecutive=consecutive)
    want = _monitor_run(jh, kw, tmp_path / "jax")
    got = _monitor_run(th, kw, tmp_path / "port")
    assert got == want
    trail, docs = got
    if on_nonfinite == "skip":
        assert not docs
    else:
        assert docs
    if on_nonfinite == "raise" and consecutive == 1:
        assert trail[1][1] == ("non-finite values at step 1 (grads -> "
                               "['c'][0])", {"grads": "['c'][0]"})
        # the amp count alone fires, unattributed
        assert trail[3][1][0] == "non-finite values at step 3 " \
                                 "(unattributed)"


def test_payload_nonfinite_matches_jax():
    for _, payload in PAYLOADS + [(9, {"health/x/nonfinite_count": -0.0,
                                       "amp/overflow_count": 0.0})]:
        assert th.payload_nonfinite(payload) == jh.payload_nonfinite(payload)


# -- replica agreement on two ranks -------------------------------------------------

def _replica_tree(perturb: float, seed: int = 3):
    rng = np.random.RandomState(seed)
    one = {"w": rng.randn(6, 5).astype(np.float32),
           "b": rng.randn(7).astype(np.float32) * 100}
    stacked = {k: np.stack([v, v]) for k, v in one.items()}
    stacked["w"][1, 2, 3] += perturb
    stacked["b"][1, 0] -= 3 * perturb
    return stacked


def _jax_divergence(stacked):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def inner(tree):
        tree = jax.tree_util.tree_map(lambda a: a[0], tree)
        return jh.check_replica_agreement(tree, "data")[None]

    specs = (jax.tree_util.tree_map(lambda _: P("data"), stacked),)
    return np.asarray(jax.jit(shard_map(inner, mesh=mesh, in_specs=specs,
                                        out_specs=P("data")))(stacked))


@pytest.mark.parametrize("perturb", [0.0, 1e-3, 0.5])
def test_check_replica_agreement_matches_shard_map(pools, perturb):
    stacked = _replica_tree(perturb)
    want = _jax_divergence(stacked)
    got = pools.run(2, R.replica_divergence, stacked)
    if perturb == 0.0:
        assert got == [0.0, 0.0] and list(want) == [0.0, 0.0]
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert min(got) > 0.0


@pytest.mark.parametrize("kw", [{}, {"bucket_bytes": 64},
                                {"axis_index_groups": [[0], [1]]}],
                         ids=["per_leaf", "bucketed", "subgroups"])
def test_ddp_grads_replica_agreement(pools, kw):
    stacked = _replica_tree(0.25)
    outs = pools.run(2, R.ddp_health, stacked, kw)
    key = "health/ddp_grads/replica_divergence"
    for out in outs:
        assert key not in out["cheap"]
        if "axis_index_groups" in kw:
            assert key not in out["full"]
        else:
            assert out["full"][key] == 0.0


def test_hybrid_trainer_health_levels(pools):
    """dp 2, tp = pp = 1: at "full" the params and the synced grads read
    0 divergence, "cheap" and "full" add the grads' keys, "full" the
    optimizer's; the losses are the same bits at every level."""
    M, mb, seq = 1, 2, 8
    cfg = {"model": dict(name="gpt", vocab_size=64, hidden_size=32,
                         num_layers=2, num_attention_heads=4,
                         max_position_embeddings=seq),
           "batch": dict(global_batch_size=2 * mb, micro_batch_size=mb),
           "optimizer": dict(name="adam", lr=1e-3, weight_decay=0.0),
           "opt_level": "O0"}
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (M, 2 * mb, seq))
    targets = rng.randint(0, 64, (M, 2 * mb, seq))
    outs = pools.run(2, R.trainer_health, cfg, tokens, targets, 2,
                     timeout=300)
    for out in outs:
        assert out["world"] == 2
        off, cheap, full = (out[k] for k in ("off", "cheap", "full"))
        np.testing.assert_array_equal(cheap[0], off[0])
        np.testing.assert_array_equal(full[0], off[0])
        for p_off, p_cheap, p_full in zip(off[1], cheap[1], full[1]):
            assert not [k for k in p_off if k.startswith("health/")]
            health = {k for k in p_cheap if k.startswith("health/")}
            assert health == {f"health/grads/{m}" for m in (
                "nonfinite_count", "abs_max", "l2", "underflow_frac",
                "first_nonfinite_leaf")}
            assert p_cheap["health/grads/nonfinite_count"] == 0.0
            assert p_cheap["health/grads/first_nonfinite_leaf"] == -1.0
            assert p_full["health/params/replica_divergence"] == 0.0
            assert p_full["health/ddp_grads/replica_divergence"] == 0.0
            for tree in ("optim_grads", "params"):
                assert p_full[f"health/{tree}/nonfinite_count"] == 0.0


# -- the GPT step ---------------------------------------------------------------------

GPT_SIZES = dict(vocab_size=64, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=16)
PLANT_LAYER, PLANT_LEAF = 1, "fc1"
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _gpt():
    jm = JaxGPT(JaxGPTConfig(compute_dtype=jnp.float32, use_flash=False,
                             **GPT_SIZES))
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(5).randint(0, GPT_SIZES["vocab_size"],
                                              (2, 16))
    return jm, jp, GPTConfig(compute_dtype=torch.float32, **GPT_SIZES), \
        tokens


def _jax_step_payload(level: str, plant: bool) -> dict:
    """One step of the JAX GPT composed as ``bench.py::_gpt_train_step``,
    reaped under the policy (activated while it traces)."""
    jm, jp, _, tokens = _gpt()
    jopt, jsc = JaxAdam(lr=LR), JaxScale(init_scale=2.0 ** 12)
    jtok = jnp.asarray(tokens)
    big = jnp.float32(3e38)

    def body(params, opt_state, ls):
        def loss_fn(p):
            loss = jm.loss(p, jtok, jtok)
            if plant:
                w = p["layers"][PLANT_LEAF]["weight"][PLANT_LAYER]
                loss = loss + jnp.sum(w) * (big * big)
            return loss * ls.loss_scale
        grads = jax.grad(loss_fn)(params)
        grads = jsc.unscale(ls, grads)
        finite = jax_all_finite(grads)
        new_ls = jsc.update(ls, finite)
        return jopt.step(grads, opt_state, params, grads_finite=finite), \
            new_ls

    @jax.jit
    def step(params, opt_state, ls):
        with jh.activate(jh.HealthConfig(level=level)):
            return jing.reap(body)(params, opt_state, ls)

    _, metrics = step(jp, jopt.init(jp), jsc.init())
    return metrics.as_floats()


def _port_step_payload(level: str, plant: bool) -> dict:
    jm, jp, cfg, tokens = _gpt()
    pm = GPTModel(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp), cfg))
    params = dict(pm.named_parameters())
    opt, scaler = FusedAdam(lr=LR), DynamicLossScale(init_scale=2.0 ** 12)
    state, ls = opt.init(params), scaler.init(device="cpu")
    tok = torch.from_numpy(tokens)
    with th.activate(th.HealthConfig(level=level)), \
            ting.collecting() as col:
        loss = pm.loss(tok, tok)
        if plant:
            w = params[f"layers.{PLANT_LAYER}.{PLANT_LEAF}.weight"]
            loss = loss + w.sum() * (torch.tensor(3e38) * 3e38)
        (loss * ls.loss_scale).backward()
        grads = scaler.unscale(ls, {n: p.grad for n, p in params.items()})
        finite = all_finite(grads)
        scaler.update(ls, finite)
        opt.step(grads, state, params, grads_finite=finite)
        return col.freeze().as_floats()


def _jax_path_of(port_name: str) -> str:
    """The JAX GPT leaf that holds port parameter ``port_name``, through
    ``_bridge.params_to_numpy``."""
    _, _, cfg, _ = _gpt()
    pm = GPTModel(cfg, device="cpu")
    sd = {n: torch.zeros_like(p) for n, p in pm.state_dict().items()}
    sd[port_name] = torch.ones_like(sd[port_name])
    tree = params_to_numpy(sd, cfg)
    hits = [jax.tree_util.keystr(path) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree) if np.any(leaf)]
    assert len(hits) == 1, hits
    return hits[0]


@pytest.mark.parametrize("level", ["cheap", "full"])
def test_gpt_step_health_payload_matches_jax(level):
    want = _jax_step_payload(level, plant=False)
    got = _port_step_payload(level, plant=False)
    health = sorted(k for k in got if k.startswith("health/"))
    trees = {"cheap": ["grads"], "full": ["grads", "optim_grads",
                                          "params"]}[level]
    assert sorted({k.split("/")[1] for k in health}) == sorted(trees)
    _same_payload({k: got[k] for k in health},
                  {k: want[k] for k in want if k.startswith("health/")},
                  rtol=GPT_RTOL, exact=("nonfinite_count",
                                        "first_nonfinite_leaf"))
    assert got["health/grads/first_nonfinite_leaf"] == -1.0


def test_gpt_step_planted_overflow_names_the_same_leaf():
    want = _jax_step_payload("cheap", plant=True)
    got = _port_step_payload("cheap", plant=True)
    _, _, cfg, _ = _gpt()
    n = cfg.hidden_size * 4 * cfg.hidden_size
    assert got["health/grads/nonfinite_count"] == \
        want["health/grads/nonfinite_count"] == float(n)
    assert got["amp/overflow_count"] == want["amp/overflow_count"] == 1.0
    _same_float(got["health/grads/l2"], want["health/grads/l2"], GPT_RTOL)
    assert got["health/grads/abs_max"] == math.inf
    port_name = f"layers.{PLANT_LAYER}.{PLANT_LEAF}.weight"
    assert th.decode_attribution(got) == {"grads": f"[{port_name!r}]"}
    assert jh.decode_attribution(want) == {"grads": _jax_path_of(port_name)}


def test_tree_stats_views():
    """``TreeStats`` keeps the reference's fields and aggregate views."""
    _, tree = _both("float32")
    stats = th.tensor_stats(tree)
    assert not dataclasses.is_dataclass(stats)
    assert stats.num_leaves == len(stats.paths) == 9
    assert stats.total_size == sum(stats.sizes)
    assert repr(stats) == f"TreeStats(9 leaves, {stats.total_size} elements)"
