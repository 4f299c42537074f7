"""The port's ``parallel_state`` against the JAX package's.

- The layout is index math: for (tp, pp, cp, dp) in {(1,1,1,4),
  (2,1,1,2), (1,2,1,2), (1,1,2,2)} (and larger worlds), every group list
  (tensor, data, context, pipeline, embedding) and ``get_rank_info`` are
  equal to the reference's on ``jax.devices()[:world]``, bit for bit,
  with no rank spawned (the port's mesh sizes stand in); so is the node
  (DCN) grid of ``_dcn_device_grid`` over the same device objects, and
  its refusals.
- On 4 gloo ranks (``apex_tpu_torch.parallel._spawn``) the real groups:
  for each of the four layouts every rank's coordinates, stage
  predicates and next/previous stage equal the reference's coordinates
  of the same device in its mesh, each of its four process groups holds
  the reference's group for that rank, and one all-reduce over each
  group sums exactly those ranks; with two nodes of two ranks
  (``LOCAL_WORLD_SIZE``) and pp 2 the groups follow the DCN grid;
  ``TrainConfig.initialize_mesh`` lays out the same groups.
- Without parallel state, and for an unknown axis name, ``resolve_axis``
  raises ``ValueError`` as an unbound axis does in the reference.
"""

import jax
import numpy as np
import pytest

import _torch_dist_ranks as R
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch.transformer import parallel_state as tps

LAYOUTS = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2)]   # (tp, pp, cp)
LAYOUT_IDS = ["dp4", "tp2", "pp2", "cp2"]


@pytest.fixture(scope="module")
def pools():
    p = R.Pools()
    yield p
    p.close()


class _SizedMesh:
    """A stand-in for the port's DeviceMesh: the sizes alone."""

    def __init__(self, shape):
        self.shape = shape

    def size(self, dim):
        return self.shape[dim]


def _reference(tp, pp, cp, world, **kw):
    jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        tp, pp, context_parallel_size=cp, devices=jax.devices()[:world], **kw)
    out = {"tensor": jps.get_tensor_model_parallel_groups(),
           "data": jps.get_data_parallel_groups(),
           "context": jps.get_context_parallel_groups(),
           "pipe": jps.get_pipeline_model_parallel_groups(),
           "embedding": jps.get_embedding_ranks(),
           "info": jps.get_rank_info(),
           "grid": np.vectorize(lambda d: d.id)(mesh.devices)}
    jps.destroy_model_parallel()
    return out


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("tp,pp,cp", LAYOUTS + [(2, 2, 1), (2, 1, 2)],
                         ids=LAYOUT_IDS + ["tp2pp2", "tp2cp2"])
def test_group_lists_equal_the_reference(monkeypatch, tp, pp, cp, world):
    ref = _reference(tp, pp, cp, world)
    dp = world // (tp * pp * cp)
    monkeypatch.setattr(tps, "_MESH", _SizedMesh((pp, dp, cp, tp)))
    assert tps.get_tensor_model_parallel_groups() == ref["tensor"]
    assert tps.get_data_parallel_groups() == ref["data"]
    assert tps.get_context_parallel_groups() == ref["context"]
    assert tps.get_pipeline_model_parallel_groups() == ref["pipe"]
    assert tps.get_embedding_ranks() == ref["embedding"]
    assert tps.get_rank_info() == ref["info"]
    np.testing.assert_array_equal(
        np.arange(world).reshape(pp, dp, cp, tp), ref["grid"])


class _Dev:
    def __init__(self, id, process_index):
        self.id, self.process_index = id, process_index


@pytest.mark.parametrize("nodes,tp,pp,cp", [
    (2, 1, 1, 1), (2, 2, 1, 1), (2, 1, 2, 1), (2, 1, 1, 2), (4, 1, 2, 1),
    (2, 2, 2, 1)])
def test_dcn_grid_equals_the_reference(nodes, tp, pp, cp):
    world = 8
    # ranks a node in an order the grid must sort
    devs = [_Dev(i, i // (world // nodes)) for i in reversed(range(world))]
    dp = world // (tp * pp * cp)
    ids = np.vectorize(lambda d: d.id)
    np.testing.assert_array_equal(
        ids(tps._dcn_device_grid(devs, tp, pp, cp, dp)),
        ids(jps._dcn_device_grid(devs, tp, pp, cp, dp)))


@pytest.mark.parametrize("devs,sizes", [
    ([_Dev(0, 0), _Dev(1, 0), _Dev(2, 1)], (1, 1, 1, 3)),  # uneven nodes
    ([_Dev(i, i // 2) for i in range(6)], (1, 1, 1, 6)),   # dp 6, 3 nodes ok
    ([_Dev(i, i // 2) for i in range(4)], (4, 1, 1, 1)),   # tp across nodes
    ([_Dev(i, i // 1) for i in range(4)], (1, 1, 1, 4)),
])
def test_dcn_grid_refusals_equal_the_reference(devs, sizes):
    tp, pp, cp, dp = sizes
    outcomes = []
    for mod in (tps, jps):
        try:
            grid = mod._dcn_device_grid(devs, tp, pp, cp, dp)
            outcomes.append(np.vectorize(lambda d: d.id)(grid).tolist())
        except RuntimeError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def _coords(grid, rank):
    (p, d, c, t), = np.argwhere(grid == rank)
    return int(p), int(d), int(c), int(t)


@pytest.mark.parametrize("tp,pp,cp", LAYOUTS, ids=LAYOUT_IDS)
def test_process_groups_on_four_ranks(pools, tp, pp, cp):
    ref = _reference(tp, pp, cp, 4)
    outs = pools.run(4, R.layout, tp, pp, cp)
    dp = 4 // (tp * pp * cp)
    for rank, got in enumerate(outs):
        p, d, c, t = _coords(ref["grid"], rank)
        assert got["sizes"] == (tp, pp, cp, dp)
        assert got["ranks"] == (t, p, c, d)
        assert got["first"] == (p == 0) and got["last"] == (p == pp - 1)
        assert got["next"] == (p + 1) % pp and got["prev"] == (p - 1) % pp
        assert got["info"] == ref["info"]
        for axis in ("tensor", "data", "context", "pipe"):
            mine = [g for g in ref[axis] if rank in g]
            assert len(mine) == 1 and got["members"][axis] == mine[0], axis
            assert got[f"sum_{axis}"] == float(sum(mine[0])), axis
            assert got["lists"][axis] == ref[axis]
        assert got["lists"]["embedding"] == ref["embedding"]


def test_process_groups_follow_the_dcn_grid(pools):
    devs = [_Dev(i, i // 2) for i in range(4)]
    grid = np.vectorize(lambda d: d.id)(jps._dcn_device_grid(devs, 1, 2, 1,
                                                             2))
    assert (grid != np.arange(4).reshape(grid.shape)).any()
    outs = pools.run(4, R.layout, 1, 2, 1, 2)
    for rank, got in enumerate(outs):
        p, d, _, _ = _coords(grid, rank)
        assert got["ranks"] == (0, p, 0, d)
        assert got["members"]["pipe"] == sorted(grid[:, d, 0, 0].tolist())
        assert got["members"]["data"] == sorted(grid[p, :, 0, 0].tolist())
        assert got["sum_data"] == float(grid[p, :, 0, 0].sum())


def test_config_initialize_mesh(pools):
    from apex_tpu import config as jcfg
    from apex_tpu_torch import config as tcfg

    cfg = tcfg.TrainConfig(parallel=tcfg.ParallelConfig(
        tensor_model_parallel_size=2))
    jc = jcfg.TrainConfig(parallel=jcfg.ParallelConfig(
        tensor_model_parallel_size=2))
    jmesh = jc.initialize_mesh(devices=jax.devices()[:4])
    groups = jps.get_data_parallel_groups()
    info = jps.get_rank_info()
    jps.destroy_model_parallel()
    assert dict(jmesh.shape) == {"pipe": 1, "data": 2, "context": 1,
                                 "tensor": 2}
    outs = pools.run(4, R.config_mesh, cfg.to_dict())
    for rank, (members, got_info) in enumerate(outs):
        assert members == next(g for g in groups if rank in g)
        assert tuple(got_info) == info


@pytest.mark.parametrize("axis", ["data", "tensor", "nonexistent_axis", 3])
def test_unbound_axes_raise(axis):
    tps.destroy_model_parallel()
    with pytest.raises(ValueError):
        tps.resolve_axis(axis)
    with pytest.raises(RuntimeError, match="not initialized"):
        tps.get_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tps.initialize_model_parallel()
