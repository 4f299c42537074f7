"""The port's ZeRO reshard (``apex_tpu_torch.elastic.reshard``) against the
JAX package's ``apex_tpu.elastic.reshard``, and a ZeRO run resumed across
world sizes on gloo ranks.

- every function (``flat_grid``, ``shard_permutation``, ``to_natural``,
  ``from_natural``, ``reshard_flat``, ``reshard_zero_state``) bit for bit
  against JAX's on the same arrays, over several (total, dp_old ->
  dp_new, bucket_bytes, pp, tp), numpy in and tensors in (a tensor comes
  back a tensor), and the same ``ValueError`` for a wrong shape;
- four ranks of ZeRO-1 Adam (``DistributedFusedAdam``, 64-byte buckets)
  take 2 steps and save (``apex_tpu_torch.checkpoint``); two ranks read
  the four shards as one global array, check its natural vectors against
  the four ranks' state and JAX's ``to_natural``, reshard it to dp 2 and
  take 2 more steps: the params, master and moments bit for bit those of
  4 steps straight at dp 2. The grads are the same on every rank and
  multiples of 1/64 (so the group's sum and its 1/dp scale are exact at
  dp 2 and 4, and the two runs do the same arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_ranks as R
from apex_tpu.elastic import reshard as J
from apex_tpu.optimizers import ZeroAdamState as JZero
from apex_tpu_torch.elastic import reshard as T
from apex_tpu_torch.optimizers import ZeroAdamState as TZero

CASES = [(37, 4, 2, 64, 1, 1), (1000, 2, 4, 128, 2, 1),
         (513, 3, 1, None, 1, 2), (91, 1, 3, 0, 2, 2),
         (4096, 8, 2, 1024, 1, 1), (300, 4, 4, 64, 2, 2)]
FIELDS = ("master", "exp_avg", "exp_avg_sq")


@pytest.fixture(scope="module")
def pools():
    from _torch_dist_ranks import Pools
    p = Pools()
    yield p
    p.close()


def _global(total, dp, bb, pp, tp, seed):
    padded, _ = J.flat_grid(total, dp, bb)
    return np.random.RandomState(seed).randn(pp * tp * padded).astype(
        np.float32)


@pytest.mark.parametrize("total,dp_old,dp_new,bb,pp,tp", CASES)
def test_reshard_functions_bit_for_bit(total, dp_old, dp_new, bb, pp, tp):
    assert T.flat_grid(total, dp_old, bb) == J.flat_grid(total, dp_old, bb)
    np.testing.assert_array_equal(T.shard_permutation(total, dp_old, bb),
                                  J.shard_permutation(total, dp_old, bb))
    x = _global(total, dp_old, bb, pp, tp, total)
    padded, _ = J.flat_grid(total, dp_old, bb)
    col = x[:padded]
    for arg in (col, torch.from_numpy(col)):
        nat = T.to_natural(arg, total, dp_old, bb)
        assert isinstance(nat, type(arg))
        np.testing.assert_array_equal(np.asarray(nat),
                                      J.to_natural(col, total, dp_old, bb))
    nat = col[:total]
    for arg in (nat, torch.from_numpy(nat.copy())):
        np.testing.assert_array_equal(
            np.asarray(T.from_natural(arg, dp_new, bb)),
            J.from_natural(nat, dp_new, bb))
    kw = dict(total=total, dp_old=dp_old, dp_new=dp_new, bucket_bytes=bb,
              pp=pp, tp=tp)
    want = J.reshard_flat(x, **kw)
    np.testing.assert_array_equal(T.reshard_flat(x, **kw), want)
    got = T.reshard_flat(torch.from_numpy(x), **kw)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    # a re-bucketed grid
    kw2 = dict(kw, bucket_bytes_new=256)
    np.testing.assert_array_equal(T.reshard_flat(x, **kw2),
                                  J.reshard_flat(x, **kw2))
    # the state: flat leaves resharded, step and stamp passed through
    leaves = {f: _global(total, dp_old, bb, pp, tp, i)
              for i, f in enumerate(FIELDS)}
    jst = JZero(step=jnp.asarray(3, jnp.int32), bucket_stamp=bb or 0,
                **{f: jnp.asarray(v) for f, v in leaves.items()})
    tst = TZero(step=torch.tensor(3, dtype=torch.int32),
                bucket_stamp=bb or 0,
                **{f: torch.from_numpy(v) for f, v in leaves.items()})
    jr, tr = J.reshard_zero_state(jst, **kw), T.reshard_zero_state(tst, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      getattr(jr, f))
    assert int(tr.step) == 3 and tr.bucket_stamp == (bb or 0)


def test_reshard_refuses_a_wrong_shape_as_jax():
    x = np.zeros(10, np.float32)
    msgs = []
    for mod in (J, T):
        with pytest.raises(ValueError) as err:
            mod.reshard_flat(x, total=37, dp_old=4, dp_new=2,
                             bucket_bytes=64)
        msgs.append(str(err.value))
        with pytest.raises(ValueError):
            mod.to_natural(x, 37, 4, 64)
        with pytest.raises(ValueError):
            mod.flat_grid(0, 2, None)
    assert msgs[0] == msgs[1]


def test_zero_resume_from_dp4_into_dp2(pools, tmp_path):
    rng = np.random.RandomState(0)
    params = {"b": rng.randn(11).astype(np.float32),
              "w": rng.randn(6, 11).astype(np.float32)}
    grads = {k: (np.round(rng.randn(*v.shape) * 64) / 64).astype(np.float32)
             for k, v in params.items()}
    bb = 64
    saved = pools.run(4, R.zero_save, str(tmp_path), params, grads, 2, bb)
    outs = pools.run(2, R.zero_resume, str(tmp_path), params, grads, 2, bb,
                     4)
    total = sum(v.size for v in params.values())
    for f in FIELDS:
        glob = np.concatenate([s[f] for s in saved])
        want = J.to_natural(glob, total, 4, bb)
        for o in outs:
            np.testing.assert_array_equal(o["natural"][f], want)
    for o in outs:
        assert o["step"] == 2
        (rp, rst), (sp, sst) = o["resumed"], o["straight"]
        for k in params:
            np.testing.assert_array_equal(rp[k], sp[k])
        for a, b in zip(rst, sst):
            np.testing.assert_array_equal(a, b)
