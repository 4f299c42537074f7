"""The port's microbatch calculators, pipeline utilities, Megatron
samplers and the ``TrainConfig.build_*`` methods of both against the JAX
package's (the reference's ``tests/test_data_and_config.py`` and
``tests/test_transformer_parallel.py`` as the guide):

- the constant and ramped calculators: the batch size and microbatch
  count after every update of a consumed-samples walk, ``state_dict``
  and ``load_state_dict``, the messages of the refusals;
- the global calculator's set, get, update and destroy;
  ``get_kth_microbatch``, ``listify_model``, ``unwrap_model``;
  ``report_memory`` on the CPU (no stats invented);
  ``get_ltor_masks_and_position_ids`` bit for bit for every flag
  combination; ``average_losses_across_data_parallel_group`` and
  ``calc_params_l2_norm`` on four gloo ranks (tp 2, dp 2) against JAX
  under ``shard_map``;
- the sequential and shuffled samplers: the same indices per rank, epoch
  and resume point, and the same refusals;
- ``TrainConfig.build_microbatch_calculator`` and ``build_sampler``.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_pp_ranks as R
from apex_tpu import config as jcfg
from apex_tpu.transformer import _data as jdata
from apex_tpu.transformer.pipeline_parallel import microbatches as jmb
from apex_tpu.transformer.pipeline_parallel import utils as jutils
from apex_tpu.utils.compat import shard_map
from apex_tpu_torch import config as tcfg
from apex_tpu_torch.transformer import _data as tdata
from apex_tpu_torch.transformer.pipeline_parallel import microbatches as tmb
from apex_tpu_torch.transformer.pipeline_parallel import utils as tutils


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _walk(calc, samples, check=True):
    out = []
    for consumed in samples:
        calc.update(consumed, check)
        out.append((calc.get(), calc.get_current_global_batch_size(),
                    calc.state_dict()))
    return out


CALCULATORS = [(None, 64, 4, 2), (None, 48, 2, 3), ([8, 8, 64], 64, 4, 2),
               ([16, 16, 100], 96, 8, 1), ([4, 4, 37], 32, 2, 2)]


@pytest.mark.parametrize("rampup,gbs,mbs,dp", CALCULATORS,
                         ids=["const", "const_dp3", "ramp", "ramp_dp1",
                              "ramp_uneven"])
def test_calculators_match_jax(rampup, gbs, mbs, dp):
    j = jmb.build_num_microbatches_calculator(0, rampup, gbs, mbs, dp)
    t = tmb.build_num_microbatches_calculator(0, rampup, gbs, mbs, dp)
    assert type(t).__name__ == type(j).__name__
    assert (t.get(), t.get_current_global_batch_size()) == (
        j.get(), j.get_current_global_batch_size())
    samples = [0, 1, 7, 8, 15, 16, 31, 32, 40, 63, 64, 65, 99, 100, 101,
               500]
    check = rampup is None or rampup[0] % (mbs * dp) == 0 == (
        rampup[1] % (mbs * dp))
    assert _walk(t, samples, check) == _walk(j, samples, check)
    fresh = tmb.build_num_microbatches_calculator(0, rampup, gbs, mbs, dp)
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict() == j.state_dict()


@pytest.mark.parametrize("args", [
    (0, [1, 2], 8, 2, 1), (0, None, 10, 4, 2), (0, [16, 5, 10], 32, 4, 1),
    (0, [64, 8, 10], 32, 4, 1)], ids=["format", "indivisible",
                                      "increment", "start"])
def test_calculator_refusals_match_jax(args):
    errs = []
    for mod in (jmb, tmb):
        with pytest.raises((ValueError, AssertionError)) as e:
            mod.build_num_microbatches_calculator(*args)
        errs.append((e.type, str(e.value)))
    assert errs[0] == errs[1]


def test_rampup_consistency_check_matches_jax():
    for mod in (jmb, tmb):
        calc = mod.build_num_microbatches_calculator(0, [6, 6, 12], 24, 4, 1)
        with pytest.raises(AssertionError, match="not divisible"):
            calc.update(0, True)


def test_global_calculator_and_slicing_match_jax():
    batch = np.arange(4 * 3 * 5).reshape(12, 5)
    for mod in (jutils, tutils):
        mod.destroy_microbatch_calculator()
    try:
        for mod in (jutils, tutils):
            mod.setup_microbatch_calculator(0, [4, 4, 40], 12, 2, 2)
            with pytest.raises(RuntimeError, match="already initialized"):
                mod.setup_microbatch_calculator(0, None, 12, 2, 2)
        for consumed in (0, 10, 20, 41):
            jutils.update_num_microbatches(consumed, True)
            tutils.update_num_microbatches(consumed, True)
            assert (tutils.get_num_microbatches(),
                    tutils.get_current_global_batch_size(),
                    tutils.get_micro_batch_size()) == (
                jutils.get_num_microbatches(),
                jutils.get_current_global_batch_size(),
                jutils.get_micro_batch_size())
        for k in range(6):
            got = tutils.get_kth_microbatch(
                {"x": torch.from_numpy(batch)}, k)["x"].numpy()
            want = jutils.get_kth_microbatch({"x": jnp.asarray(batch)}, k)
            np.testing.assert_array_equal(got, np.asarray(want["x"]))
    finally:
        for mod in (jutils, tutils):
            mod.destroy_microbatch_calculator()
    for mod in (jutils, tutils):
        with pytest.raises(RuntimeError, match="not initialized"):
            mod.get_num_microbatches()
    model = object()
    assert tutils.listify_model(model) == jutils.listify_model(model)
    assert tutils.listify_model([model]) == [model]
    assert tutils.unwrap_model(model) is model


def test_report_memory_says_the_stats_are_absent_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = tutils.report_memory("step 3")
    assert report == "[step 3] memory (MB)\n  cpu: memory_stats unavailable"
    assert buf.getvalue().strip() == report


@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (True, True, True)],
                         ids=["plain", "pos", "attn", "loss", "all"])
def test_ltor_masks_bit_for_bit(flags):
    rng = np.random.RandomState(sum(flags) + 3 * flags[0])
    data = rng.randint(0, 6, (3, 17))
    data[0, :3] = 1                     # EODs in a row
    data[1, -1] = 1                     # an EOD last
    for eod in (1, 9):                  # 9: no EOD at all
        want = jutils.get_ltor_masks_and_position_ids(
            jnp.asarray(data), eod, *flags)
        got = tutils.get_ltor_masks_and_position_ids(
            torch.from_numpy(data), eod, *flags)
        for g, w in zip(got, want):
            assert g.dtype == {np.dtype(bool): torch.bool,
                               np.dtype(np.float32): torch.float32,
                               np.dtype(np.int32): torch.int32}[
                np.asarray(w).dtype]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_utils_match_jax(pools):
    """The loss average over the data group and the parameters' norm over
    the tensor group at tp 2 x dp 2 (four ranks)."""
    rng = np.random.RandomState(4)
    losses = rng.rand(2, 3).astype(np.float32)          # by data rank
    tree = {"a": rng.randn(2, 5, 3).astype(np.float32),  # by tensor rank
            "b": rng.randn(2, 7).astype(np.float32)}
    outs = pools.run(4, R.group_utils, 2, 1, losses, tree)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "tensor"))

    def inner(losses, tree):
        avg = jutils.average_losses_across_data_parallel_group(
            list(losses[0]))
        norm = jutils.calc_params_l2_norm(
            jax.tree_util.tree_map(lambda v: v[0], tree))
        return avg, norm

    avg, norm = jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P("data"), P("tensor")),
        out_specs=(P(), P())))(losses, tree)
    for got_avg, got_norm in outs:
        np.testing.assert_allclose(got_avg, np.asarray(avg), rtol=1e-7)
        np.testing.assert_allclose(float(got_norm), float(norm), rtol=1e-6)


# -- the samplers -----------------------------------------------------------------

@pytest.mark.parametrize("total,consumed,lmb,dp,drop_last", [
    (64, 0, 4, 2, True), (64, 24, 4, 2, True), (10, 0, 4, 1, False),
    (70, 8, 3, 3, False), (33, 9, 2, 4, True)],
    ids=["dp2", "resume", "tail", "dp3_tail", "dp4_resume"])
def test_sequential_sampler_matches_jax(total, consumed, lmb, dp, drop_last):
    for rank in range(dp):
        args = (total, consumed, lmb, rank, dp, drop_last)
        got = list(tdata.MegatronPretrainingSampler(*args))
        assert got == list(jdata.MegatronPretrainingSampler(*args))
        assert len(tdata.MegatronPretrainingSampler(*args)) == total


@pytest.mark.parametrize("total,consumed,lmb,dp", [
    (64, 0, 4, 2), (64, 24, 4, 2), (100, 150, 4, 2), (97, 300, 3, 4),
    (48, 47, 8, 1)], ids=["epoch0", "resume", "epoch1", "epoch3", "late"])
def test_random_sampler_matches_jax(total, consumed, lmb, dp):
    """The same indices per rank at each epoch and resume point, and the
    same consumed count afterwards."""
    for rank in range(dp):
        t = tdata.MegatronPretrainingRandomSampler(total, consumed, lmb,
                                                    rank, dp)
        j = jdata.MegatronPretrainingRandomSampler(total, consumed, lmb,
                                                    rank, dp)
        assert list(t) == list(j)
        assert t.epoch == j.epoch
        assert t.consumed_samples == j.consumed_samples
        # a second pass starts where the first left off: the next epoch
        assert list(t) == list(j)
        t.local_minibatch_size = j.local_minibatch_size = 2
        assert (t.local_minibatch_times_data_parallel_size
                == j.local_minibatch_times_data_parallel_size)


@pytest.mark.parametrize("cls,args", [
    ("MegatronPretrainingSampler", (0, 0, 4, 0, 1)),
    ("MegatronPretrainingSampler", (8, 8, 4, 0, 1)),
    ("MegatronPretrainingSampler", (8, 0, 0, 0, 1)),
    ("MegatronPretrainingSampler", (8, 0, 4, 0, 0)),
    ("MegatronPretrainingSampler", (8, 0, 4, 2, 2)),
    ("MegatronPretrainingRandomSampler", (0, 0, 4, 0, 1)),
    ("MegatronPretrainingRandomSampler", (8, 0, 4, 3, 2))],
    ids=["empty", "consumed", "minibatch", "dp0", "rank", "random_empty",
         "random_rank"])
def test_sampler_refusals_match_jax(cls, args):
    errs = []
    for mod in (jdata, tdata):
        with pytest.raises(RuntimeError) as e:
            getattr(mod, cls)(*args)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the TrainConfig build methods -----------------------------------------------------

@pytest.mark.parametrize("rampup", [None, (16, 16, 64)], ids=["const", "ramp"])
def test_config_build_methods_match_jax(rampup):
    kw = dict(batch=dict(global_batch_size=64, micro_batch_size=4,
                         rampup_batch_size=rampup))
    jc = jcfg.TrainConfig.from_dict(kw)
    tc = tcfg.TrainConfig.from_dict(kw)
    jcalc, tcalc = (c.build_microbatch_calculator(2) for c in (jc, tc))
    assert type(tcalc).__name__ == type(jcalc).__name__
    samples = [0, 16, 32, 48, 64, 80]
    assert _walk(tcalc, samples) == _walk(jcalc, samples)
    for shuffle in (False, True):
        for rank in range(2):
            js = jc.build_sampler(200, 64, rank, 2, shuffle=shuffle)
            ts = tc.build_sampler(200, 64, rank, 2, shuffle=shuffle)
            assert type(ts).__name__ == type(js).__name__
            assert ts.local_minibatch_size == js.local_minibatch_size == 32
            assert list(ts) == list(js)
