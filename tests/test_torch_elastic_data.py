"""The port's resumable data pipeline against the JAX package's
``apex_tpu/elastic/data.py``: ``ShardedIndexIterator``'s indices bit
for bit over seeds, epochs, ``num_hosts`` 1-4 and every host, its
cursor, ``reseek`` and stream-identity errors; ``PrefetchingIterator``'s
stream and ``consumed``; ``token_batch_fetcher``'s arrays."""

import numpy as np
import pytest
import torch

from apex_tpu.elastic import data as J
from apex_tpu_torch.elastic import data as T


@pytest.mark.parametrize("seed", [0, 1, 11, 2 ** 31 + 5])
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_indices_bit_for_bit(seed, num_hosts, shuffle):
    """Every host's indices of every batch over three epochs (the epoch
    key mixed in), and the iteration order, equal the reference's."""
    total, gb = 50, 12
    for host in range(num_hosts):
        kw = dict(seed=seed, host_id=host, num_hosts=num_hosts,
                  shuffle=shuffle)
        ref = J.ShardedIndexIterator(total, gb, **kw)
        port = T.ShardedIndexIterator(total, gb, **kw)
        assert port.batches_per_epoch == ref.batches_per_epoch == 4
        for k in range(3 * ref.batches_per_epoch + 1):
            np.testing.assert_array_equal(port.batch_indices(k),
                                          ref.batch_indices(k))
        for _ in range(5):
            np.testing.assert_array_equal(next(port), next(ref))
        assert port.state_dict() == ref.state_dict()


def test_hosts_partition_the_global_batch():
    full = T.ShardedIndexIterator(64, 8, seed=2).batch_indices(3)
    parts = [T.ShardedIndexIterator(64, 8, seed=2, host_id=h,
                                    num_hosts=2).batch_indices(3)
             for h in range(2)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("state", [
    {"consumed": 2, "seed": 10},
    {"consumed": 2, "seed": 9, "global_batch": 10},
    {"consumed": 2, "seed": 9, "num_hosts": 2},
    {"consumed": 2, "seed": 9, "num_hosts": 1, "global_batch": 5},
    {"consumed": 4},
])
def test_load_state_dict_and_its_errors(state):
    """The same state loads, or fails with the same message, in both."""
    ref = J.ShardedIndexIterator(50, 5, seed=9)
    port = T.ShardedIndexIterator(50, 5, seed=9)
    assert _error(lambda: port.load_state_dict(state)) == \
        _error(lambda: ref.load_state_dict(state))
    assert port.consumed == ref.consumed
    np.testing.assert_array_equal(next(port), next(ref))


@pytest.mark.parametrize("state", [
    {"consumed": 3, "seed": 7, "num_hosts": 4, "global_batch": 8},
    {"consumed": 3, "seed": 8, "num_hosts": 4, "global_batch": 8},
    {"consumed": 3, "seed": 7, "num_hosts": 4, "global_batch": 16},
])
def test_reseek_and_its_errors(state):
    """A cursor saved under 4 hosts re-sliced for 2: the global sequence
    goes on where it stopped; the stream identity is still checked."""
    for host in range(2):
        ref = J.ShardedIndexIterator(64, 8, seed=7, host_id=host,
                                     num_hosts=2)
        port = T.ShardedIndexIterator(64, 8, seed=7, host_id=host,
                                      num_hosts=2)
        assert _error(lambda: port.reseek(state)) == \
            _error(lambda: ref.reseek(state))
        assert port.consumed == ref.consumed
        np.testing.assert_array_equal(next(port), next(ref))


def test_validation_messages():
    for args, kw in (((4, 8), {}), ((64, 9), dict(num_hosts=2)),
                     ((64, 8), dict(host_id=2, num_hosts=2)),
                     ((64, 0), {})):
        ref = _error(lambda: J.ShardedIndexIterator(*args, seed=0, **kw))
        assert ref is not None
        assert _error(lambda: T.ShardedIndexIterator(*args, seed=0,
                                                     **kw)) == ref
    for mod in (J, T):
        with pytest.raises(ValueError, match="depth"):
            mod.PrefetchingIterator(mod.ShardedIndexIterator(8, 4, seed=0),
                                    lambda i: i, depth=0)
        with pytest.raises(ValueError, match="fetch got"):
            mod.token_batch_fetcher(np.zeros((8, 9)), 2, 2, 8)(np.arange(3))
        with pytest.raises(ValueError, match="dataset must be"):
            mod.token_batch_fetcher(np.zeros((8, 8)), 2, 2, 8)


def test_token_batch_fetcher_values():
    data = np.random.RandomState(0).randint(0, 32, (64, 10))
    ref = J.token_batch_fetcher(data, 2, 3, 8)
    port = T.token_batch_fetcher(data, 2, 3, 8)
    idx = np.random.RandomState(1).permutation(64)[:6]
    for r, p in zip(ref(idx), port(idx)):
        assert isinstance(p, torch.Tensor) and p.dtype == torch.int64
        assert tuple(p.shape) == (2, 3, 8)
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetching_stream_and_cursor(depth):
    """The prefetched stream is the reference's batch for batch; the
    cursor counts consumed batches while the sampler runs ahead; a fresh
    pipeline loaded from the cursor yields the next batch; ``reseek``
    after a host-grid change too."""
    data = np.random.RandomState(0).randint(0, 32, (64, 9))

    def both(num_hosts=1, host=0):
        return [mod.PrefetchingIterator(
            mod.ShardedIndexIterator(64, 4, seed=1, host_id=host,
                                     num_hosts=num_hosts),
            mod.token_batch_fetcher(data, 2, 2 // num_hosts, 8),
            depth=depth, **({"device": "cpu"} if mod is T else {}))
            for mod in (J, T)]

    ref, port = both()
    for _ in range(4):
        r, p = next(ref), next(port)
        for a, b in zip(r, p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    state = port.state_dict()
    assert state == ref.state_dict()
    assert state["consumed"] == port.consumed == 4
    assert port.sampler.consumed == ref.sampler.consumed == 4 + depth
    ref2, port2 = both()
    port2.load_state_dict(state)
    ref2.load_state_dict(state)
    np.testing.assert_array_equal(next(port2)[0].numpy(),
                                  np.asarray(next(ref2)[0]))
    ref3, port3 = both(num_hosts=2, host=1)
    with pytest.raises(ValueError, match="num_hosts"):
        port3.load_state_dict(state)
    port3.reseek(state)
    ref3.reseek(state)
    assert port3.consumed == ref3.consumed == 4
    np.testing.assert_array_equal(next(port3)[1].numpy(),
                                  np.asarray(next(ref3)[1]))
    assert port3.num_hosts == 2


def test_prefetch_device_defaults_to_the_card():
    """``device`` defaults to the card; without one it raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cpu"):
        T.PrefetchingIterator(T.ShardedIndexIterator(8, 4, seed=0),
                              lambda i: (i,))
