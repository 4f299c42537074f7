"""Port ``TrainConfig`` vs the JAX package on the CPU, mirroring
``tests/test_data_and_config.py``'s config tests at one device.

- ``to_dict`` equal to the JAX config's for the defaults and a custom
  tree, a JSON round trip through both packages' ``from_dict`` (tuples
  restored);
- the builders: the policy and the scaler against the JAX ones for every
  opt level and half dtype; GPT, BERT and ResNet-50 with the config's
  sizes and the policy's dtypes; an fp32 GPT built by each package from
  the same weights gives the same loss (1e-5); FusedAdam/AdamW/SGD with
  the config's hyperparameters, ``flat=True`` wrapping;
- the errors: the reference's ``ValueError`` for unknown names, a bad
  ``zero`` and ZeRO on SGD, and sequence parallelism or its overlap at
  tp = 1 (both packages); ``NotImplementedError`` naming the queue item
  for what is not ported (``ddp_bucket_bytes="auto"`` under ZeRO and
  fastpath); what has been ported since builds: a GPT at tp 2 on two gloo
  ranks, at pp and cp 2, the health policy, microbatches, samplers. ZeRO, ``fastpath`` and the
  mesh themselves: ``tests/test_torch_zero.py`` and
  ``tests/test_torch_parallel_state.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import config as jcfg
from apex_tpu_torch import config as tcfg
from apex_tpu_torch._bridge import params_to_numpy
from apex_tpu_torch.amp import DynamicLossScale, NoOpLossScale
from apex_tpu_torch.models import BertModel, GPTModel, ResNet50
from apex_tpu_torch.optimizers import FlatOptimizer, FusedAdam, FusedSGD

GPT_SMALL = dict(name="gpt", vocab_size=128, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=16)


def _both(**kw):
    """The same config built by each package, sub-configs from ``kw``."""
    def build(mod):
        sub = {"model": mod.ModelConfig, "parallel": mod.ParallelConfig,
               "batch": mod.BatchConfig, "optimizer": mod.OptimizerConfig}
        return mod.TrainConfig(**{k: sub[k](**v) if k in sub else v
                                  for k, v in kw.items()})
    return build(jcfg), build(tcfg)


CUSTOM = dict(model=dict(GPT_SMALL, remat_policy="selective",
                         remat_names=("qkv_out",)),
              parallel=dict(tensor_model_parallel_size=1),
              batch=dict(global_batch_size=16, micro_batch_size=4,
                         rampup_batch_size=(4, 4, 100)),
              optimizer=dict(name="adamw", lr=3e-4, flat=True,
                             betas=(0.8, 0.99)),
              opt_level="O2", seed=7)


@pytest.mark.parametrize("kw", [{}, CUSTOM], ids=["defaults", "custom"])
def test_to_dict_matches_jax_and_round_trips(kw):
    jc, tc = _both(**kw)
    assert tc.to_dict() == jc.to_dict()
    d = json.loads(json.dumps(tc.to_dict()))
    back = tcfg.TrainConfig.from_dict(d)
    assert back == tc
    assert tcfg.TrainConfig.from_dict(json.loads(json.dumps(
        jc.to_dict()))) == tc
    assert jcfg.TrainConfig.from_dict(d) == jc
    if kw:
        assert back.optimizer.betas == (0.8, 0.99)
        assert back.batch.rampup_batch_size == (4, 4, 100)
        assert back.model.remat_names == ("qkv_out",)


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_policy_and_scaler_match_jax(level, half):
    jc, tc = _both(opt_level=level, half_dtype=half)
    jp, tp = jc.build_policy(), tc.build_policy()
    assert (tp.name, tp.loss_scale, tp.keep_norms_fp32) == (
        jp.name, jp.loss_scale, jp.keep_norms_fp32)
    for f in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(tp, f)).replace("torch.", "") == \
            jnp.dtype(getattr(jp, f)).name
    assert type(tc.build_scaler()).__name__ == \
        type(jc.build_scaler()).__name__
    if tp.loss_scale == "dynamic":
        assert isinstance(tc.build_scaler(), DynamicLossScale)
    else:
        assert isinstance(tc.build_scaler(), NoOpLossScale)


def test_build_model_gpt_matches_jax():
    jc, tc = _both(model=GPT_SMALL, opt_level="O0")
    jm, tm = jc.build_model(), tc.build_model(device="cpu")
    assert isinstance(tm, GPTModel)
    assert tm.cfg.compute_dtype == torch.float32
    assert tm.cfg.params_dtype == torch.float32
    tm.init(torch.Generator().manual_seed(0))
    params = params_to_numpy(tm.state_dict(), tm.cfg)
    tokens = np.random.RandomState(0).randint(0, 128, (2, 16))
    ref = float(jax.jit(jm.loss)(params, jnp.asarray(tokens),
                                 jnp.asarray(tokens)))
    t = torch.from_numpy(tokens)
    assert abs(float(tm.loss(t, t).detach()) - ref) <= 1e-5
    o2 = tcfg.TrainConfig(model=tcfg.ModelConfig(**GPT_SMALL))
    assert o2.build_model(device="cpu").cfg.compute_dtype == torch.bfloat16


def test_build_model_bert_and_resnet():
    tc = tcfg.TrainConfig(model=tcfg.ModelConfig(
        **dict(GPT_SMALL, name="bert")))
    bert = tc.build_model(device="cpu")
    assert isinstance(bert, BertModel) and bert.cfg.hidden_size == 32
    assert bert.cfg.compute_dtype == torch.bfloat16
    tc = tcfg.TrainConfig(model=tcfg.ModelConfig(name="resnet50",
                                                 num_classes=10),
                          opt_level="O3")
    rn = tc.build_model(device="cpu")
    assert isinstance(rn, ResNet50) and rn.fc.weight.shape == (10, 2048)
    assert rn.cfg.params_dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tc.build_model()


@pytest.mark.parametrize("name,flat", [("adam", False), ("adamw", True),
                                       ("sgd", False), ("sgd", True)])
def test_build_optimizer(name, flat):
    tc = tcfg.TrainConfig(optimizer=tcfg.OptimizerConfig(
        name=name, lr=3e-3, weight_decay=0.05, betas=(0.8, 0.95), eps=1e-6,
        momentum=0.7, flat=flat))
    opt = tc.build_optimizer()
    if flat:
        assert isinstance(opt, FlatOptimizer)
        opt = opt.inner
    if name == "sgd":
        assert isinstance(opt, FusedSGD)
        assert (opt.lr, opt.momentum, opt.weight_decay) == (3e-3, 0.7, 0.05)
    else:
        assert isinstance(opt, FusedAdam)
        assert (opt.lr, opt.beta1, opt.beta2, opt.eps, opt.weight_decay,
                opt.adam_w_mode) == (3e-3, 0.8, 0.95, 1e-6, 0.05,
                                     name == "adamw")
    params = {"w": torch.ones(3, requires_grad=True)}
    state = (tc.build_optimizer()).init(params)
    assert state is not None


def test_errors_match_the_reference():
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.TrainConfig(optimizer=mod.OptimizerConfig(
                name="sgd", zero=True)).build_optimizer()
        with pytest.raises(ValueError):
            mod.TrainConfig(model=mod.ModelConfig(name="vgg")).build_model()
        with pytest.raises(ValueError, match="unknown optimizer"):
            mod.TrainConfig(optimizer=mod.OptimizerConfig(
                name="rmsprop")).build_optimizer()
        with pytest.raises(ValueError, match="unsupported zero"):
            mod._zero_enabled("2")
        assert mod._zero_enabled("off") is False
        assert mod._zero_enabled("1") is True


@pytest.mark.parametrize("make,item", [
    (lambda: tcfg.TrainConfig(optimizer=tcfg.OptimizerConfig(
        name="adam", zero=1), ddp_bucket_bytes="auto").build_optimizer(),
     "A7b"),
    (lambda: tcfg.TrainConfig(optimizer=tcfg.OptimizerConfig(
        name="lamb", zero=1), ddp_bucket_bytes="auto").build_optimizer(),
     "A7b"),
    (None, "tp builds"),
    (None, "pp builds"),
    (None, "cp builds"),
    (None, "sequence_parallel requires tp > 1"),
    (None, "tp_comm_overlap requires sequence_parallel=True"),
    (lambda: tcfg.TrainConfig().fastpath().build_optimizer(), "A7b"),
    (None, "health builds"),
    (None, "microbatches build"),
    (None, "sampler builds"),
], ids=["zero", "lamb", "tp", "pp", "cp", "sp",
        "overlap", "fastpath", "health", "microbatches", "sampler"])
def test_unported_pieces_raise_naming_their_queue_item(make, item, request):
    """What is not ported raises ``NotImplementedError`` naming its queue
    item. Tensor and sequence parallelism are ported: at tp 2 the GPT
    builds on two CPU gloo ranks with its shards, and sequence parallelism
    or its overlap at tp = 1 raise the reference's ``ValueError``, in both
    packages. Pipelines are ported: at pp 2 the GPT builds with every
    layer (the trainer cuts a rank's stage), and the microbatch
    calculator and the samplers build as the JAX package's do
    (``tests/test_torch_microbatches.py`` holds them to it). Context
    parallelism is ported: at cp 2 the GPT builds with cp 1's parameters
    (only the mesh gains the context axis, as in the reference;
    ``tests/test_torch_context_parallel.py`` holds the groups to JAX's).
    The health policy is ported: ``build_health`` gives the JAX config's
    ``HealthConfig`` fields, and a bad level raises its ``ValueError``."""
    case = request.node.callspec.id
    if case == "tp":
        _tp2_builds()
    elif case == "pp":
        model = tcfg.TrainConfig(
            model=tcfg.ModelConfig(vocab_size=64, hidden_size=32,
                                   num_layers=4, num_attention_heads=4,
                                   max_position_embeddings=16),
            parallel=tcfg.ParallelConfig(pipeline_model_parallel_size=2)
        ).build_model(device="cpu")
        assert len(model.layers) == 4
    elif case == "cp":
        def build(cp):
            return tcfg.TrainConfig(
                model=tcfg.ModelConfig(vocab_size=64, hidden_size=32,
                                       num_layers=2, num_attention_heads=4,
                                       max_position_embeddings=16),
                parallel=tcfg.ParallelConfig(context_parallel_size=cp)
            ).build_model(device="cpu")
        shapes = [{n: tuple(p.shape) for n, p in build(cp).named_parameters()}
                  for cp in (2, 1)]
        assert shapes[0] == shapes[1] and len(shapes[0]) > 0
    elif case == "health":
        for kw in ({}, dict(health_level="full", health_on_nonfinite="raise",
                            health_consecutive=3, health_dump_dir="d")):
            got = tcfg.TrainConfig(**kw).build_health()
            want = jcfg.TrainConfig(**kw).build_health()
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for mod in (jcfg, tcfg):
            with pytest.raises(ValueError, match="level must be one of"):
                mod.TrainConfig(health_level="basic").build_health()
    elif case == "microbatches":
        got = tcfg.TrainConfig().build_microbatch_calculator(2)
        want = jcfg.TrainConfig().build_microbatch_calculator(2)
        assert (type(got).__name__, got.get()) == (type(want).__name__,
                                                   want.get())
    elif case == "sampler":
        got = tcfg.TrainConfig().build_sampler(64, 0, 0, 2)
        want = jcfg.TrainConfig().build_sampler(64, 0, 0, 2)
        assert list(got) == list(want)
    elif case in ("sp", "overlap"):
        flag = {"sp": "sequence_parallel", "overlap": "tp_comm_overlap"}
        for mod in (jcfg, tcfg):
            c = mod.TrainConfig(model=mod.ModelConfig(**{flag[case]: True}))
            with pytest.raises(ValueError, match=item):
                c.build_model() if mod is jcfg else c.build_model(
                    device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=item):
            make()


def _tp2_builds():
    import _torch_tp_ranks as R
    from apex_tpu_torch.parallel._spawn import RankPool, children_alive
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(vocab_size=64, hidden_size=32, num_layers=2,
                               num_attention_heads=4,
                               max_position_embeddings=16),
        parallel=tcfg.ParallelConfig(tensor_model_parallel_size=2))
    pool = RankPool(2, device="cpu")
    try:
        outs = pool.run(R.config_build, cfg.to_dict(), 1 << 20)
    finally:
        pids = pool.pids()
        pool.close()
    assert not children_alive(pids)
    for out in outs:
        tp, sp, ov, shapes = out["config"]
        assert (tp, sp, ov) == (2, False, False)
        assert shapes["layers.0.fc1.weight"] == (64, 32)
        assert shapes["layers.0.fc2.weight"] == (32, 64)
