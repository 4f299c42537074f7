"""The port's cost model and runtime counters against the JAX package's
arithmetic, on the CPU.

- ``mfu`` equal to the reference's for the same inputs (NaN where the
  time or the peak is not positive); ``DeviceSpec``'s milliseconds and the
  ``APEX_TPU_PEAK_FLOPS``/``_HBM_GBPS``/``_ICI_GBPS`` overrides as the
  reference applies them (the name's suffix, a value that is not positive
  raising), the H100 row matched by a device-name prefix, the CPU's
  H100-class default, and no TPU row;
- ``flops_budget`` of a 2-layer GPT's forward and backward on the CPU's
  plain path within 5% of the analytic count of ``bench.py`` (6N + 12 L d
  seq a token), and the reference's duck type (``cost_analysis()``) read
  as the reference reads it; ``memory_budget`` None on the CPU and the
  reference's reading of a ``memory_analysis()`` object;
- the compile counters on real ``torch.compile(backend="eager")``
  compiles (a new shape compiles again, a cached one does not), one
  installation counting once, an uninstalled registry frozen, a
  kernel-library build counted through ``_kernels.BUILD_LISTENERS``, and
  ``sample_memory_stats`` empty on the CPU as the reference's is.
"""

import math

import numpy as np
import pytest
import torch

from apex_tpu.observability import costs as jcosts
from apex_tpu.observability import runtime as jruntime
from apex_tpu_torch import _kernels
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.observability import costs, runtime

H100 = "NVIDIA H100 80GB HBM3"


class Device:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("flops,t,peak", [
    (6.5e14, 0.25, 989.4e12), (1e9, 1e-3, 197e12), (1e9, 0.0, 1e12),
    (1e9, -1.0, 1e12), (1e9, 1.0, 0.0), (0.0, 1.0, 1e12)])
def test_mfu_matches_the_reference(flops, t, peak):
    got, want = costs.mfu(flops, t, peak), jcosts.mfu(flops, t, peak)
    assert (math.isnan(got) and math.isnan(want)) or got == want


def test_default_peak_is_the_h100s():
    assert costs.peak_flops() == costs.DEFAULT_PEAK_FLOPS == 989.4e12
    assert costs.mfu(989.4e12, 1.0) == 1.0
    assert costs.peak_flops(Device(H100)) == 989.4e12
    assert costs.peak_flops("cpu") == costs.DEFAULT_PEAK_FLOPS
    assert costs.device_spec(Device(H100)) == costs.DEVICE_SPECS[H100]
    spec = costs.device_spec()
    assert spec.name == "unknown (H100-class assumed)"
    assert (spec.peak_flops, spec.hbm_gbps, spec.ici_gbps) == (
        989.4e12, 3350.0, 450.0)
    assert not [k for k in list(costs.PEAK_BF16_FLOPS)
                + list(costs.DEVICE_SPECS) if "TPU" in k]


@pytest.mark.parametrize("env", [
    {}, {"APEX_TPU_PEAK_FLOPS": "5e14"},
    {"APEX_TPU_HBM_GBPS": "2000", "APEX_TPU_ICI_GBPS": "300"},
    {"APEX_TPU_PEAK_FLOPS": "1e15", "APEX_TPU_HBM_GBPS": "1500.5",
     "APEX_TPU_ICI_GBPS": "25"}])
def test_device_spec_overrides_match_the_reference(env, monkeypatch):
    for k in ("APEX_TPU_PEAK_FLOPS", "APEX_TPU_HBM_GBPS",
              "APEX_TPU_ICI_GBPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = costs.device_spec(Device(H100))
    base = jcosts.DeviceSpec(H100, 989.4e12, 3350.0, 450.0)
    ref = jcosts.device_spec(Device("TPU v4"))   # the reference's override
    want = jcosts.DeviceSpec(
        H100 + (" (env-tuned)" if env else ""),
        float(env.get("APEX_TPU_PEAK_FLOPS", base.peak_flops)),
        float(env.get("APEX_TPU_HBM_GBPS", base.hbm_gbps)),
        float(env.get("APEX_TPU_ICI_GBPS", base.ici_gbps)))
    assert (got.name, got.peak_flops, got.hbm_gbps, got.ici_gbps) == (
        want.name, want.peak_flops, want.hbm_gbps, want.ici_gbps)
    assert ref.name.endswith(" (env-tuned)") == bool(env)
    for k, v in env.items():
        field = {"APEX_TPU_PEAK_FLOPS": "peak_flops",
                 "APEX_TPU_HBM_GBPS": "hbm_gbps",
                 "APEX_TPU_ICI_GBPS": "ici_gbps"}[k]
        assert getattr(ref, field) == getattr(got, field) == float(v)
    for x in (1e12, 3.3e9, 0.0):
        assert got.compute_ms(x) == want.compute_ms(x)
        assert got.hbm_ms(x) == want.hbm_ms(x)
        assert got.comm_ms(x) == want.comm_ms(x)


@pytest.mark.parametrize("bad", ["0", "-3"])
def test_device_spec_refuses_a_bad_override(bad, monkeypatch):
    monkeypatch.setenv("APEX_TPU_HBM_GBPS", bad)
    for fn in (lambda: costs.device_spec(), lambda: jcosts.device_spec(
            Device("TPU v4"))):
        with pytest.raises(ValueError, match="APEX_TPU_HBM_GBPS"):
            fn()


def test_flops_budget_of_a_gpt_step_near_the_analytic_count():
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=64,
                    compute_dtype=torch.float32, use_kernel=False)
    model = GPTModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch, seq = 2, 64
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq)))

    def step():
        model.zero_grad(set_to_none=True)
        model.loss(tokens, tokens).backward()

    counted = costs.flops_budget(step)
    n_params = sum(p.numel() for p in model.parameters())
    analytic = batch * seq * (6.0 * n_params
                              + 12.0 * cfg.num_layers * cfg.hidden_size * seq)
    assert counted == pytest.approx(analytic, rel=0.05), counted / analytic
    assert costs.flops_budget(lambda: torch.ones(3) + 1) is None


class Compiled:
    def __init__(self, cost=None, memory=None, raises=False):
        self._cost, self._memory, self._raises = cost, memory, raises

    def cost_analysis(self):
        if self._raises:
            raise RuntimeError("no analysis")
        return self._cost

    def memory_analysis(self):
        if self._raises:
            raise RuntimeError("no analysis")
        return self._memory


class Memory:
    argument_size_in_bytes = 100
    output_size_in_bytes = 20
    temp_size_in_bytes = 300
    alias_size_in_bytes = 10
    generated_code_size_in_bytes = 5
    host_temp_size_in_bytes = None


@pytest.mark.parametrize("compiled", [
    Compiled(cost={"flops": 12.5}), Compiled(cost=[{"flops": 7.0}]),
    Compiled(cost={"flops": 0.0}), Compiled(cost={"flops": float("nan")}),
    Compiled(cost={}), Compiled(raises=True), Compiled(memory=Memory()),
    Compiled(memory=None)])
def test_duck_typed_budgets_read_as_the_reference(compiled):
    assert costs.flops_budget(compiled) == jcosts.flops_budget(compiled)
    assert costs.memory_budget(compiled) == jcosts.memory_budget(compiled)


def test_memory_budget_is_none_off_the_card():
    assert costs.memory_budget(lambda x: x * 2, torch.ones(4)) is None
    assert costs.memory_budget(lambda: None) is None


@pytest.fixture
def registry():
    runtime.reset_compile_listeners()
    reg = MetricsRegistry()
    yield reg
    runtime.reset_compile_listeners()


def _counts(reg):
    snap = reg.to_dict()
    return (snap["counters"].get("torch/traces", 0.0),
            snap["counters"].get("torch/compiles", 0.0),
            snap["histograms"]["torch/compile_seconds"]["count"])


def test_compile_counters_on_real_compiles(registry):
    import torch._dynamo
    torch._dynamo.reset()
    assert runtime.install_compile_listeners(registry) is registry
    runtime.install_compile_listeners(registry)     # counts once
    other = runtime.install_compile_listeners(MetricsRegistry())

    @torch.compile(backend="eager")
    def f(x):
        return torch.sin(x) * 2 + 1

    f(torch.ones(3))
    assert _counts(registry) == (1.0, 1.0, 1)
    f(torch.ones(3))                               # cached
    assert _counts(registry) == (1.0, 1.0, 1)
    f(torch.ones(5, 2))                            # a new shape
    traces, compiles, observed = _counts(registry)
    assert traces == compiles == observed == 2
    assert _counts(other) == _counts(registry)
    assert runtime.uninstall_compile_listeners(registry)
    assert not runtime.uninstall_compile_listeners(registry)
    f(torch.ones(7, 3, 2))
    assert _counts(registry) == (2.0, 2.0, 2)
    assert _counts(other)[1] == 3.0
    torch._dynamo.reset()


def test_a_kernel_library_build_counts_as_a_compile(registry):
    runtime.install_compile_listeners(registry)
    assert _kernels.BUILD_LISTENERS.count(runtime._on_compiled) == 1
    for listener in list(_kernels.BUILD_LISTENERS):
        listener(42.5)
    assert _counts(registry) == (0.0, 1.0, 1)
    hist = registry.to_dict()["histograms"]["torch/compile_seconds"]
    assert hist["sum"] == 42.5


def test_memory_stats_empty_on_the_cpu():
    reg = MetricsRegistry()
    assert runtime.sample_memory_stats(reg) == {}
    assert not reg.to_dict()["gauges"]
    from apex_tpu.observability.registry import MetricsRegistry as JReg
    assert jruntime.sample_memory_stats(JReg()) == {}
