"""The port's copies of the metrics registry and the request record behave
as the JAX package's originals on the same inputs (exact: both are plain
Python float arithmetic in the same order)."""

import math

import numpy as np
import pytest

from apex_tpu.observability import registry as jreg
from apex_tpu.observability.reqtrace import (LATENCY_BUCKETS_MS as J_BUCKETS,
                                             RequestRecord as JRecord)
from apex_tpu_torch.observability import registry as preg
from apex_tpu_torch.observability import (LATENCY_BUCKETS_MS, RequestRecord,
                                          get_registry)


def test_latency_buckets_equal():
    assert LATENCY_BUCKETS_MS == J_BUCKETS
    assert preg.log_buckets(1.0, 100.0, 5) == jreg.log_buckets(1.0, 100.0, 5)


@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 99, 100])
def test_histogram_percentiles_equal(q):
    samples = np.random.RandomState(0).lognormal(2.0, 1.0, 500)
    hp = preg.Histogram("x", LATENCY_BUCKETS_MS)
    hj = jreg.Histogram("x", J_BUCKETS)
    for s in samples:
        hp.observe(s)
        hj.observe(s)
    assert hp.percentile(q) == hj.percentile(q)
    assert hp.snapshot() == hj.snapshot()


def test_registry_snapshot_equal_and_kinds_enforced():
    rp, rj = preg.MetricsRegistry(), jreg.MetricsRegistry()
    for r in (rp, rj):
        r.counter("serve/admitted").inc(3)
        r.gauge("serve/queue_depth").set(2)
        r.gauge("never_set")
        r.histogram("serve/ttft_ms", LATENCY_BUCKETS_MS).observe(12.5)
    assert rp.snapshot() == rj.snapshot()
    assert "never_set" not in rp.snapshot()
    with pytest.raises(TypeError, match="already registered"):
        rp.gauge("serve/admitted")
    rp.reset()
    assert rp.counter("serve/admitted").value == 0.0
    assert math.isnan(rp.gauge("serve/queue_depth").value)
    assert get_registry() is get_registry()


def test_request_record_latencies_equal():
    kw = dict(request_id=1, prompt_len=4, submit_t=10.0, admit_t=10.5,
              first_token_t=10.75, last_token_t=11.75, retire_t=12.0,
              generated=5)
    p, j = RequestRecord(**kw), JRecord(**kw)
    for name in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
        assert getattr(p, name) == getattr(j, name), name
    assert RequestRecord(request_id=2, prompt_len=1, submit_t=0.0,
                         generated=1).tpot_ms is None
