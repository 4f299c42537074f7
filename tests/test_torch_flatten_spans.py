"""The span and segment helpers of the port's flat layout against the JAX
package's ``apex_tpu/optimizers/_flatten.py``, bit for bit.

- ``bucket_bounds`` equal to the reference's for layouts built at 1, 2, 3
  and 4 shards and bucket sizes from 4 bytes to past the whole vector
  (and ``None``, and the refusal of 0);
- ``ravel_span`` equal to the reference's for every bucket of those grids
  over a tree with fp32, bf16, scalar and zero-size leaves and a padding
  tail, and ``unravel_parts`` of the pieces equal to the reference's leaf
  by leaf, dtypes included; the errors of both;
- ``ravel_span`` reads no leaf outside its span (those leaves are objects
  that raise when touched), so the full flat vector is never built;
- ``segment_ids`` equal to the reference's, and ``span_segment_ids`` equal
  to its slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import _flatten as jf
from apex_tpu_torch.optimizers import _flatten as tf


def _trees(seed=3):
    """The same tree for each package; keys in sorted order (JAX flattens
    a dict sorted, torch as inserted)."""
    rng = np.random.RandomState(seed)
    leaves = {"h": rng.randn(9).astype(np.float32),        # as bf16
              "s": np.asarray(1.5, np.float32),
              "w": rng.randn(7, 5).astype(np.float32),
              "z": np.zeros((0,), np.float32)}
    jt = {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
          for k, v in leaves.items()}
    tt = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h"
                                    else torch.float32)
          for k, v in leaves.items()}
    return jt, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_bucket_bounds_equal_the_reference(chunks):
    jt, tt = _trees()
    jl, tl = jf.build_layout(jt, chunks), tf.build_layout(tt, chunks)
    assert (tl.sizes, tl.offsets, tl.total, tl.padded, tl.chunk) == (
        jl.sizes, jl.offsets, jl.total, jl.padded, jl.chunk)
    for bb in (None, 4, 8, 12, 40, 64, 1 << 20):
        assert tf.bucket_bounds(tl, bb) == jf.bucket_bounds(jl, bb), bb
    for mod, lay in ((tf, tl), (jf, jl)):
        with pytest.raises(ValueError, match="positive"):
            mod.bucket_bounds(lay, 0)


@pytest.mark.parametrize("chunks,bucket_bytes", [
    (4, 16), (4, 40), (2, 12), (3, 24), (1, None), (4, 1 << 20)])
def test_spans_equal_the_reference(chunks, bucket_bytes):
    jt, tt = _trees()
    jl, tl = jf.build_layout(jt, chunks), tf.build_layout(tt, chunks)
    bounds = tf.bucket_bounds(tl, bucket_bytes)
    tparts = [tf.ravel_span(tt, tl, o, n) for o, n in bounds]
    jparts = [jf.ravel_span(jt, jl, o, n) for o, n in bounds]
    for t, j in zip(tparts, jparts):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_np(t), _np(j))
    np.testing.assert_array_equal(_np(torch.cat(tparts)),
                                  _np(jf.ravel(jt, jl)))
    got = tf.unravel_parts(tparts, bounds, tl)
    want = jf.unravel_parts(jparts, bounds, jl)
    for k in jt:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_span_errors_match_the_reference():
    jt, tt = _trees()
    for mod, tree in ((tf, tt), (jf, jt)):
        lay = mod.build_layout(tree, 4)
        flat = mod.ravel(tree, lay)
        with pytest.raises(ValueError, match="outside"):
            mod.ravel_span(tree, lay, lay.padded - 2, 4)
        with pytest.raises(ValueError, match="parts"):
            mod.unravel_parts([flat[:4]], ((0, 4), (4, lay.padded - 4)), lay)
        with pytest.raises(ValueError, match="cover"):
            mod.unravel_parts([flat[:4]], ((0, 4),), lay)
        with pytest.raises(ValueError, match="tile"):
            mod.unravel_parts([flat[:4], flat[8:]],
                              ((0, 4), (8, lay.padded - 8)), lay)


class _Untouchable:
    """A leaf that raises on any attribute read: a span that reads it
    fails."""

    def __getattr__(self, name):
        raise AssertionError(f"a leaf outside the span was read ({name})")


def test_ravel_span_reads_only_the_leaves_it_covers():
    _, tt = _trees()
    lay = tf.build_layout(tt, 4)
    flat = tf.ravel(tt, lay)
    for off, n in tf.bucket_bounds(lay, 16):
        tree = {k: v if lay.offsets[i] < off + n
                and off < lay.offsets[i] + lay.sizes[i] else _Untouchable()
                for i, (k, v) in enumerate(tt.items())}
        np.testing.assert_array_equal(
            _np(tf.ravel_span(tree, lay, off, n)), _np(flat[off:off + n]))


@pytest.mark.parametrize("chunks", [1, 4])
def test_segment_ids_equal_the_reference(chunks):
    jt, tt = _trees()
    jl, tl = jf.build_layout(jt, chunks), tf.build_layout(tt, chunks)
    ids = tf.segment_ids(tl)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jf.segment_ids(jl)))
    for off, n in tf.bucket_bounds(tl, 12):
        np.testing.assert_array_equal(
            tf.span_segment_ids(tl, off, n).numpy(), ids[off:off + n].numpy())
    ids[0] = 99          # a copy each call: the cached map stays
    assert int(tf.segment_ids(tl)[0]) == 0
