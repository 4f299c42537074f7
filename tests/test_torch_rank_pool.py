"""The rank pool the port's distributed tests and ``chip_smoke.py`` run
on (``apex_tpu_torch.parallel._spawn.RankPool``): gloo ranks over a
``FileStore``, results by rank, a rank's exception reported with the pool
left open, and a rank that never joins a collective failing the call
within its limit, the pool killed and no child left behind; the default
device is the card; subgroups are made anew in a new world."""

import time

import numpy as np
import pytest

import _torch_dist_ranks as R
from apex_tpu_torch.parallel._spawn import RankError, RankPool, children_alive


@pytest.fixture(scope="module")
def pids():
    seen = []
    yield seen
    assert not children_alive(seen), "a rank outlived its test module"


def test_results_come_back_by_rank(pids):
    with RankPool(3, device="cpu") as pool:
        mine = pool.pids()
        pids += mine
        assert pool.run(R.whoami) == [(r, 3, "gloo") for r in range(3)]
        with pytest.raises(RankError, match="raised on rank 1"):
            pool.run(R.raise_on, 1)
        assert pool.alive
        assert pool.run(R.raise_on, 5) == [0, 1, 2]
    assert not pool.alive and not children_alive(mine)


def test_a_rank_that_never_joins_fails_the_call_in_time(pids):
    pool = RankPool(2, device="cpu", pg_timeout=300.0)
    mine = pool.pids()
    pids += mine
    t0 = time.monotonic()
    with pytest.raises(RankError, match="did not finish .* within 3 s"):
        pool.run(R.skip_the_collective, 1, timeout=3.0)
    assert time.monotonic() - t0 < 30.0
    assert not pool.alive
    assert not children_alive(mine)
    with pytest.raises(RankError, match="closed"):
        pool.run(R.whoami)


def test_the_default_is_the_card(monkeypatch):
    """With no device named the ranks go to the card; with no card that
    raises before any rank starts, and never falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RankPool(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RankPool(2, backend="gloo")


def test_subgroups_are_made_anew_in_a_new_world(pids, tmp_path):
    """``axis_index_groups`` subgroups are cached per default process
    group: after ``destroy_process_group`` and a new
    ``init_process_group`` the same groups are made again, not taken
    from the dead world."""
    with RankPool(2, device="cpu") as pool:
        pids += pool.pids()
        outs = pool.run(R.subgroups_in_a_new_world,
                        str(tmp_path / "store"), timeout=60.0)
    for before, after, ranks in outs:
        np.testing.assert_array_equal(before, [3.0, 3.0])
        np.testing.assert_array_equal(after, [30.0, 30.0])
        assert ranks == [0, 1]
