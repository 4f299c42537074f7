"""The port's GPT and BERT at tensor parallelism on gloo ranks against the
JAX package's under ``shard_map``.

A 2-layer, hidden-64, 4-head GPT (vocab 128, 16 positions, fp32 compute,
dropout 0) from one JAX ``init`` runs on ``tp`` gloo ranks
(``tests/_torch_tp_ranks.py``), each loading its shards through
``_bridge.params_from_jax(tree, cfg, tp_rank)``, and in the JAX package
under ``shard_map`` over a ``("tensor",)`` mesh with the model's
``param_specs`` (the reference's ``tests/test_models.py:56``, ``:307``
and ``tests/test_collective_matmul.py:332``, ``:484``):

- plain TP, SP and SP with ``tp_comm_overlap`` at tp 2 and 4: the loss
  at 1e-5 and every grad leaf, the ranks' grads
  joined by ``_bridge.stack_tp_params``, at 1e-6 (the one-device limits
  of ``tests/test_torch_train.py``); the LayerNorm grads come back summed
  over the group and ``sp_grad_sync`` hands them back untouched;
- the ``tp/*`` metrics of the overlap leg equal to JAX's;
- BERT's masked-LM loss and grads at tp 2 (``tests/test_models.py:255``);
- dropout at tp 2: the ranks' attention seeds differ; the hidden masks
  are the same on every rank without SP and differ with it;
- a rank's ``init`` from a seed equal to ``_bridge.split_tp_state`` of
  the tp = 1 model's, at tp 2 and 4;
- ``TrainConfig`` and ``fastpath`` building at tp 2;
- the refusals: heads or widths the group does not divide, overlap
  without SP, SP at tp 1, BERT under SP, and the serving legs at tp > 1;
- a NaN in rank 1's grads skips the step on both ranks and halves the
  scale (``all_finite`` over the tensor group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from apex_tpu.models import BertConfig as JBertCfg, BertModel as JBert
from apex_tpu.models import GPTConfig as JCfg, GPTModel as JGPT
from apex_tpu.observability import ingraph as jingraph
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch._bridge import stack_tp_params
from apex_tpu_torch.models import BertConfig, GPTConfig

SIZES = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=16)
TOL_LOSS, TOL_GRAD = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _mesh(tp):
    return Mesh(np.array(jax.devices()[:tp]), ("tensor",))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leg(tp, leg, params, tokens):
    sp, ov = R.LEGS[leg]
    model = JGPT(JCfg(tensor_model_parallel_size=tp, sequence_parallel=sp,
                      tp_comm_overlap=ov, compute_dtype=jnp.float32,
                      **SIZES))
    specs = model.param_specs(params)

    def inner(params, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: model.loss(p, tokens, tokens))(params)
        return jax.lax.pmean(loss, "tensor"), grads

    loss, grads = jax.jit(shard_map(inner, mesh=_mesh(tp),
                                    in_specs=(specs, P()),
                                    out_specs=(P(), specs)))(params, tokens)
    return float(loss), _np_tree(grads)


def _jax_metrics(tp, params, tokens):
    model = JGPT(JCfg(tensor_model_parallel_size=tp, sequence_parallel=True,
                      tp_comm_overlap=True, compute_dtype=jnp.float32,
                      **SIZES))
    specs = model.param_specs(params)

    def inner(params, tokens):
        _, metrics = jingraph.reap(
            lambda: model.loss(params, tokens, tokens))()
        return jingraph.aggregate(metrics, "tensor")

    metrics = jax.jit(shard_map(inner, mesh=_mesh(tp),
                                in_specs=(specs, P()),
                                out_specs=P()))(params, tokens)
    return metrics.as_floats()


def _assert_grads(got_by_rank, want, cfg):
    got = stack_tp_params([{k: torch.from_numpy(v) for k, v in g.items()}
                           for g in got_by_rank], cfg)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL_GRAD,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("tp,legs", [(2, ("plain", "sp", "overlap")),
                                     (4, ("plain", "sp", "overlap"))],
                         ids=["tp2", "tp4"])
def test_gpt_legs_match_jax(pools, tp, legs):
    jp = JGPT(JCfg(tensor_model_parallel_size=tp, compute_dtype=jnp.float32,
                   **SIZES)).init(jax.random.PRNGKey(2))
    tokens = np.random.RandomState(2).randint(0, SIZES["vocab_size"],
                                              (2, 16))
    tree = _np_tree(jp)
    outs = pools.run(tp, R.gpt_legs, tp, SIZES, tree, tokens, legs,
                     timeout=300)
    cfg = GPTConfig(tensor_model_parallel_size=tp, **SIZES)
    for leg in legs:
        j_loss, j_grads = _jax_leg(tp, leg, jp, jnp.asarray(tokens))
        for loss, _, _, synced in (o[leg] for o in outs):
            np.testing.assert_allclose(float(loss), j_loss, atol=TOL_LOSS)
            assert synced
        _assert_grads([o[leg][1] for o in outs], j_grads, cfg)
        metrics = [o[leg][2] for o in outs]
        if leg == "overlap":
            want = _jax_metrics(tp, jp, jnp.asarray(tokens))
            for m in metrics:
                assert m == {k: want[k] for k in m}, (m, want)
                assert set(m) == {"tp/overlap_chunks", "tp/collective_bytes"}
        else:
            assert all(not m for m in metrics)


@pytest.mark.parametrize("tp", [2, 4])
def test_init_and_split_tp_state_cut_the_tp1_weights_alike(pools, tp):
    """A rank's ``init`` from a seed equals ``split_tp_state`` of the tp = 1
    model's from that seed (the law the card's ``tp_gpt`` leans on)."""
    for differ in pools.run(tp, R.init_against_split, tp, SIZES, 4):
        assert differ == []


def test_bert_mlm_head_at_tp2_matches_jax(pools):
    tp = 2
    sizes = dict(vocab_size=64, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=16,
                 add_pooler=False, add_binary_head=True)
    jm = JBert(JBertCfg(tensor_model_parallel_size=tp,
                        compute_dtype=jnp.float32, **sizes))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (2, 16))
    labels = rng.randint(0, 64, (2, 16))
    mask = (rng.rand(2, 16) > 0.3).astype(np.float32)
    specs = {
        "embedding": {"word": {"weight": P("tensor")}, "position": P(),
                      "tokentype": P()},
        "final_ln": {"weight": P(), "bias": P()},
        "layers": jax.tree_util.tree_map(
            lambda p: P(None, "tensor") if p.ndim >= 3 else P(),
            jp["layers"]),
        "lm_head": {"dense": {"weight": P(), "bias": P()},
                    "ln": {"weight": P(), "bias": P()},
                    "bias": P("tensor")},
    }

    def inner(params, tokens, labels, mask):
        loss, grads = jax.value_and_grad(lambda p: jm.loss(
            p, tokens, labels, loss_mask=mask))(params)
        return jax.lax.pmean(loss, "tensor"), grads

    j_loss, j_grads = jax.jit(shard_map(
        inner, mesh=_mesh(tp), in_specs=(specs, P(), P(), P()),
        out_specs=(P(), specs)))(jp, tokens, labels, mask)
    outs = pools.run(tp, R.bert_loss, tp, sizes, _np_tree(jp), tokens,
                     labels, mask)
    for loss, _ in outs:
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   atol=TOL_LOSS)
    _assert_grads([g for _, g in outs], _np_tree(j_grads),
                  BertConfig(tensor_model_parallel_size=tp, **sizes))


@pytest.mark.parametrize("leg", ["plain", "sp"])
def test_dropout_streams_at_tp2(pools, leg):
    (seeds0, masks0), (seeds1, masks1) = pools.run(2, R.dropout_streams, 2,
                                                   SIZES, leg)
    L = SIZES["num_layers"]
    assert len(seeds0) == len(seeds1) == L
    # the heads are sharded: each rank's attention dropout its own
    assert all(a != b for a, b in zip(seeds0, seeds1))
    # embedding dropout, then two hidden masks a layer
    assert len(masks0) == len(masks1) == 1 + 2 * L
    same = [np.array_equal(a, b) for a, b in zip(masks0, masks1)]
    if leg == "plain":
        assert all(same)        # replicated activations: one stream
    else:
        assert not any(same)    # sequence shards: a stream a rank
    assert all(0.3 < m.mean() < 0.7 for m in masks0 + masks1)


def test_train_config_and_fastpath_build_at_tp2(pools):
    from apex_tpu_torch import config as tcfg
    cfg = tcfg.TrainConfig(
        model=tcfg.ModelConfig(**SIZES),
        parallel=tcfg.ParallelConfig(tensor_model_parallel_size=2),
        optimizer=tcfg.OptimizerConfig(name="adam"))
    outs = pools.run(2, R.config_build, cfg.to_dict(), 1 << 20)
    h, ffn, v = 64, 256, 128
    for out in outs:
        for what, flags in (("config", (2, False, False)),
                            ("fastpath", (2, True, True))):
            tp, sp, ov, shapes = out[what]
            assert (tp, sp, ov) == flags, what
            assert shapes["embedding.word.weight"] == (v // 2, h)
            assert shapes["layers.0.qkv.weight"] == (3 * h // 2, h)
            assert shapes["layers.0.qkv.bias"] == (3 * h // 2,)
            assert shapes["layers.1.proj.weight"] == (h, h // 2)
            assert shapes["layers.1.proj.bias"] == (h,)
            assert shapes["layers.0.fc1.weight"] == (ffn // 2, h)
            assert shapes["layers.0.fc2.weight"] == (h, ffn // 2)
            assert shapes["final_ln.weight"] == (h,)


def test_refusals_at_tp2(pools):
    out = pools.run(2, R.gpt_refusals, 2, SIZES)[0]
    assert out["heads"] == ("ValueError", "heads must divide tp size")
    assert out["width"][0] == "AssertionError"
    assert out["overlap"][0] == "ValueError"
    assert "requires sequence_parallel=True" in out["overlap"][1]
    assert out["sp_tp1"] == ("ValueError",
                             "sequence_parallel requires tp > 1")
    assert out["bert_sp"][0] == "ValueError"
    for leg in ("prefill", "decode", "verify", "engine"):
        kind, text = out[leg]
        assert kind == "NotImplementedError" and "tp=2" in text, leg


def test_a_nan_on_one_rank_skips_the_step_on_both(pools):
    tp = 2
    jp = JGPT(JCfg(tensor_model_parallel_size=tp, compute_dtype=jnp.float32,
                   **SIZES)).init(jax.random.PRNGKey(3))
    tokens = np.random.RandomState(3).randint(0, 128, (2, 16))
    outs = pools.run(tp, R.skip_on_nan, tp, SIZES, _np_tree(jp), tokens)
    for finite, scale, new_scale, kept, step in outs:
        assert not finite and kept and step == 0
        assert new_scale == 0.5 * scale
