"""The port's flash kernels at every head dim the reference takes, on the
CPU.

``_kernels.flash_width(d)`` is the body width the CUDA kernels run head dim
``d`` at (d rounded up to a multiple of 16 at or below 128, of 32 above),
and the one rule the checks, the launches and these tests read. The
kernels themselves run only on the card (``chip_smoke.py`` holds them to
their plain versions at every d from 8 to 256); here the plain versions of
the three flash kernels (``_flash_fwd_plain``, ``_flash_bwd_dq_plain``,
``_flash_bwd_dkv_plain``) are held to the JAX package's Pallas forward and
backward (``_fwd_pallas``, ``_bwd_pallas``) in interpret mode, as its own
tests run them on the CPU, at head dims off the old 32/64/128 set: the
output, the logsumexp, dq, dk and dv, fp32, 1e-5 absolute (values and
grads of magnitude ~1 summed in different orders). Inputs ``(1, 2, 64,
d)`` come from numpy with a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels

jfa = importlib.import_module("apex_tpu.ops.flash_attention")
pfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

TOL = 1e-5
B, H, S = 1, 2, 64
DIMS = (8, 16, 24, 40, 80, 96, 136, 200, 256)


def _expected_width(d: int) -> int:
    step = 16 if d <= 128 else 32
    return (d + step - 1) // step * step


def test_flash_width_rule():
    """Every d from 1 to 300: the width of the rule, never below d, or
    ``NotImplementedError`` off ``d % 8 == 0`` and past 256."""
    for d in range(1, 301):
        if d % 8 or d > 256:
            with pytest.raises(NotImplementedError, match=f"head dim {d}"):
                _kernels.flash_width(d)
            continue
        w = _kernels.flash_width(d)
        assert w == _expected_width(d) and w >= d, d
        assert w % 16 == 0 and (d <= 128 or w % 32 == 0) and w - d < 32, d


def test_width_groups_match_the_sources():
    """Every width the rule gives lies in exactly one group of
    ``_FLASH_PARTS``, and the groups are ``csrc/flash_width.cuh``'s."""
    widths = sorted({_kernels.flash_width(d) for d in range(8, 257, 8)})
    parts = _kernels._FLASH_PARTS
    assert sorted(w for part in parts for w in part) == widths
    src = (_kernels._CSRC / "flash_width.cuh").read_text()
    for i, part in enumerate(parts):
        listed = f"#if APEX_FLASH_PART == {i}" if i == 0 else \
            f"#elif APEX_FLASH_PART == {i}"
        block = src.split(listed, 1)[1].split("\n", 2)[1]
        assert block.strip() == ("using Part = List<"
                                 + ", ".join(map(str, part)) + ">;")


@pytest.mark.parametrize("d", [4, 12, 264])
def test_check_rejects_unsupported_head_dims(d):
    """The kernels' shared check raises ``NotImplementedError`` on a d the
    bodies do not take, whatever device the tensors lie on; no launch."""
    q = torch.zeros(2, 8, d)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match=f"head dim {d}"):
        _kernels._check_attention("flash_fwd", q, q, q)
    assert _kernels.LAUNCHES == before


def test_cpu_tensors_never_reach_a_kernel():
    """The wrappers refuse CPU tensors at a new head dim before any check
    of the width; the autograd function runs the plain versions on the
    CPU and launches nothing."""
    q = torch.zeros(2, 8, 80)
    rows = torch.zeros(2, 8)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.125)
    x = torch.randn(1, 2, 8, 80, requires_grad=True)
    pfa.flash_attention(x, x, x, causal=True).sum().backward()
    assert _kernels.LAUNCHES == before


def _jax_flash(q, k, v, do, causal, bias=None, ids=None):
    """The JAX package's Pallas forward and backward (interpret mode) on
    ``(b * h, s, d)`` inputs: ``(out, lse, dq, dk, dv)``."""
    d = q.shape[-1]
    q3, k3, v3, do3 = (jnp.asarray(x.reshape(B * H, S, d))
                       for x in (q, k, v, do))
    seed = jnp.zeros((2,), jnp.float32)
    bias4 = None if bias is None else jnp.asarray(bias)
    segs = None
    if ids is not None:
        seg = jnp.asarray(ids, jnp.float32).reshape(B, 1, S)
        segs = (seg, seg)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=S, block_k=S,
              dropout_rate=0.0)
    out, lse = jfa._fwd_pallas(q3, k3, v3, bias4, seed, segs, H, **kw)
    delta = jnp.sum(do3 * out, axis=-1, keepdims=True)
    dq, dk, dv = jfa._bwd_pallas(q3, k3, v3, bias4, seed, segs, H, do3, lse,
                                 delta, **kw)
    return tuple(np.asarray(x) for x in (out, lse[..., 0], dq, dk, dv))


def _port_flash(q, k, v, do, causal, bias=None, ids=None):
    """The port's plain versions of the three flash kernels on the same
    inputs: ``(out, lse, dq, dk, dv)``."""
    d = q.shape[-1]
    q3, k3, v3, do3 = (torch.from_numpy(x.reshape(B * H, S, d))
                       for x in (q, k, v, do))
    kw = dict(bias=None if bias is None else torch.from_numpy(bias),
              segments=None if ids is None else
              (torch.from_numpy(ids),) * 2)
    out, lse = pfa._flash_fwd_plain(q3, k3, v3, causal, d ** -0.5, **kw)
    delta = (do3 * out).sum(-1)
    args = (q3, k3, v3, do3, lse, delta, causal, d ** -0.5)
    dq = pfa._flash_bwd_dq_plain(*args, **kw)
    dk, dv = pfa._flash_bwd_dkv_plain(*args, **kw)
    return tuple(x.numpy() for x in (out, lse, dq, dk, dv))


def _inputs(d: int, seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, d).astype(np.float32) for _ in range(4)]


def _assert_same(port, ref, what):
    for name, p, r in zip(("out", "lse", "dq", "dk", "dv"), port, ref):
        np.testing.assert_allclose(p, r, atol=TOL, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_plain_flash_matches_jax_pallas(d, causal):
    q, k, v, do = _inputs(d, d + causal)
    _assert_same(_port_flash(q, k, v, do, causal),
                 _jax_flash(q, k, v, do, causal), f"d {d}, causal {causal}")


@pytest.mark.parametrize("kind", ["padding_bias", "segment_ids"])
def test_plain_flash_matches_jax_pallas_d16_masks(kind):
    """d 16 (``examples/gpt_serve.py``'s head dim) with BERT's padding bias
    and with packed segment ids."""
    q, k, v, do = _inputs(16, 7)
    bias = ids = None
    if kind == "padding_bias":
        keep = np.arange(S) < 41
        bias = np.where(keep, 0.0, -10000.0).astype(np.float32)[None, None,
                                                                None, :]
    else:
        ids = np.repeat(np.arange(3), [20, 30, 14]).astype(np.int32)[None]
    _assert_same(_port_flash(q, k, v, do, True, bias, ids),
                 _jax_flash(q, k, v, do, True, bias, ids), kind)
