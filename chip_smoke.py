#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc`` (the kernels are built from ``apex_tpu_torch/csrc`` on
first use); without a card, or without the package beside it, it exits
non-zero and prints no result. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels, timed;
3. each kernel against its plain PyTorch version on the card, element by
   element and by relative norm, with the max abs error and the share of
   the limit used (the limits are stated and derived below the imports):
   ``flash_fwd`` at the serving prefill
   shape; ``flash_fwd`` with dropout, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` at the training shape (96 x 1024 x 1024, d 64,
   causal, bf16) and at ragged, cross, non-causal, fp32 d 128, fully masked
   and dropout 0.1 cases, and the dropout mask read back from the kernel
   bit for bit; ``decode_attention`` at the serving path's shapes and at
   int8 and multi-row cases. Kernel, plain and library (SDPA forward, and
   SDPA backward for the dQ/dK/dV pair: yardsticks only, the port never
   calls SDPA) device times under ``torch.profiler``, beside the bound;
4. GPT-small (vocab 32768, hidden 768, 12 layers, 12 heads, 1024
   positions; random weights from a seed) served at full width: a
   ``ServingEngine`` (8 slots, max_len 1024, prefill window 128, bf16
   cache) under a ``SlotScheduler`` with 16 requests of mixed prompt
   lengths, 32 new tokens each, half greedy. Launch counts are set to 0
   just before the run and read just after: ``flash_fwd`` must run 12
   times per prefill and ``decode_attention`` 12 times per decode step.
   Then prefill and decode-step times, and a teacher-forced check of the
   kernel path's logits against the plain path's on the card;
5. GPT-small trained at full width, the twin of
   ``bench.py::_gpt_train_step`` (batch 8 x 1024 tokens, bf16 compute,
   ``FusedAdam(lr=1e-4)``, ``DynamicLossScale(init_scale=2**12)``): launch
   counts reset around each step, which must launch ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` 12 times each; step time,
   tokens/s, each step's loss, a profile of one step; then the plain path
   from the same state dict, whose losses and step-0 grads must agree;
   then one step of each path with train-mode dropout (hidden and
   attention, 0.1, a generator on the card), which must agree too;
6. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# tolerances, kernel vs plain on identical inputs, element by element:
# |kernel - plain| <= atol + rtol * |plain|, and over a whole output
# ||kernel - plain|| / ||plain|| <= the relative-norm limit. bf16
# outputs: both versions accumulate in fp32 and round once to bf16, so
# they differ by one bf16 ulp (at most 2**-7 of the value) where their
# fp32 sums fall on two sides of a rounding point; the backward kernels'
# fp32 sums differ by summation order only (under 1e-7 here). flash_fwd's
# also differ by the rounding of each probability to bf16 (unit roundoff
# 2**-9) before the P V product: the kernel rounds the unnormalized ones
# (as the TPU kernel does), the plain version the normalized ones, so
# their sums differ by at most 2**-8 * sum_j p_j |v_j|, the plain version
# run on |v| in fp32, which the check adds to atol element by element
# (``fwd_slack``). fp32 outputs: summation order only. Every lse: fp32,
# absolute.
BF16_TOL = (1e-3, 2 ** -7, 1e-2)     # (atol, rtol, relative norm)
FP32_TOL = (1e-5, 1e-5, 1e-5)
FWD_P_ROUNDING = 1.05 * 2 ** -8      # 5% over 2**-8 for fp32 summation
TOL_LSE = 1e-4
# teacher-forced GPT-small logits, kernel path vs plain path: bf16
# activations whose attention outputs differ by a few ulps per layer,
# carried through 12 residual layers and the tied head (|logit| ~ 1)
TOL_LOGITS = 0.1
# GPT-small training, kernel path vs plain path from one state dict: the
# per-step losses (~9-10, a mean over 8192 tokens; they differed by at
# most 1.4e-4 on an H100), and step 0's unscaled grads, leaf by leaf, as
# ||kernel - plain|| / ||plain|| (0.011 at the worst leaf, the tied
# embedding, 0.003 at the median one): bf16 attention outputs that differ
# by an ulp here and there, through 12 layers forward and back
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 2e-2
TRAIN_STEPS = 4
TRAIN_COMPARE_STEPS = 3

# attention at the training shape: (batch x heads, seq, seq, head dim)
TRAIN_BH = (8, 12)
TRAIN_ATTN = (96, 1024, 1024, 64)
TRAIN_DROPOUT = 0.1
REPLACES = {"flash_fwd": "apex_tpu/ops/flash_attention.py:222",
            "flash_bwd_dq": "apex_tpu/ops/flash_attention.py:340",
            "flash_bwd_dkv": "apex_tpu/ops/flash_attention.py:411",
            "decode_attention": "apex_tpu/ops/flash_attention.py:1021"}

PROMPT_LENS = [1, 128, 17, 64, 100, 5, 33, 128, 77, 2, 90, 45, 120, 9, 60,
               127]
NEW_TOKENS = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take for bf16 work: bytes over HBM
    bandwidth vs operations over the bf16 tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def tol_for(torch, dtype):
    return BF16_TOL if dtype == torch.bfloat16 else FP32_TOL


def close(torch, pairs, tol, slack=None) -> tuple:
    """Max abs error over ``(kernel, plain)`` pairs, and the largest share
    of a limit that any element or output uses (at most 1 passes): of the
    element-wise ``atol + slack + rtol * |plain|`` (``slack`` a tensor
    like the plain output, or None) and of the relative-norm limit."""
    atol, rtol, rel = tol
    err = share = 0.0
    for got, want in pairs:
        if not want.numel():
            continue
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        limit = atol + rtol * w.abs()
        if slack is not None:
            limit = limit + slack
        err = max(err, float(diff.max()))
        share = max(share, float((diff / limit).max()),
                    float(diff.norm() / w.norm().clamp(min=1e-30)) / rel)
    return err, share


def fwd_slack(torch, fa, q, k, v, causal, scale, rate=0.0, seed=None):
    """``flash_fwd``'s extra element-wise slack on bf16 outputs:
    ``FWD_P_ROUNDING * sum_j p_j |v_j|`` (see the tolerances above)."""
    if v.dtype != torch.bfloat16:
        return None
    pv, _ = fa._flash_fwd_plain(q.float(), k.float(), v.abs().float(),
                                causal, scale, rate, seed)
    return FWD_P_ROUNDING * pv


def compare_lse(torch, lse_k, lse_p, tol: float, what: str) -> float:
    inf_k, inf_p = torch.isinf(lse_k), torch.isinf(lse_p)
    check(bool((inf_k == inf_p).all()), f"{what}: infinite lse rows differ")
    check(bool((lse_k[inf_k] == lse_p[inf_p]).all()),
          f"{what}: infinite lse signs differ")
    fin = ~inf_k
    err = max_err(torch, lse_k[fin], lse_p[fin])
    check(err <= tol, f"{what}: lse err {err:.3g} > {tol}")
    return err


def device_ms(torch, fn, iters: int = 10, show: str = "") -> float:
    """Device time per call of ``fn``: the kernels it launches, summed under
    ``torch.profiler`` over ``iters`` calls. Kernel, plain and library
    calls are all timed so, since a call's host dispatch can outlast its
    kernels (CUDA events around back-to-back calls would then time the
    host). With ``show``, prints the kernels that took the most time, so
    the backend is on record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total), reverse=True)
    if show:
        print(f"{show} ran: " + "; ".join(
            f"{key[:60]} {t / 1e3 / iters:.4f} ms" for t, key in kernels[:4]))
    return sum(t for t, _ in kernels) / 1e3 / iters


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def check_flash(torch, fa, kern, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [  # (name, n, sq, sk, d, causal, dtype)
        ("prefill path (1x12, 128, 128, d64) causal bf16", 12, 128, 128, 64,
         True, torch.bfloat16),
        ("ragged sq=sk=100 causal bf16", 6, 100, 100, 64, True,
         torch.bfloat16),
        ("cross sq=64 < sk=200 causal bf16", 6, 64, 200, 64, True,
         torch.bfloat16),
        ("cross sq=64 < sk=200 non-causal bf16", 6, 64, 200, 64, False,
         torch.bfloat16),
        ("fp32 d128 causal", 4, 128, 128, 128, True, torch.float32),
        ("fp32 d128 non-causal", 4, 96, 160, 128, False, torch.float32),
        ("fully masked rows sq=96 > sk=40 causal fp32", 4, 96, 40, 64, True,
         torch.float32),
    ]
    worst = 0.0
    for name, n, sq, sk, d, causal, dt in cases:
        q, k, v = (rand((n, s, d), dt) for s in (sq, sk, sk))
        scale = d ** -0.5
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        tol = tol_for(torch, dt)
        err, share = close(torch, [(out_k, out_p)], tol,
                           fwd_slack(torch, fa, q, k, v, causal, scale))
        check(share <= 1, f"flash_fwd {name}: out err {err:.3g}, "
                          f"{share:.3g} x the limit {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        if sq > sk and causal:
            masked = sq - sk
            check(bool((out_k[:, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[:, :masked]).all()),
                  "flash_fwd: fully masked rows are not 0 / +inf")
        print(f"flash_fwd  {name}: max_abs_err out {err:.3g}, {share:.3g} x "
              f"the limit {tol}; lse {lerr:.3g} (tol {TOL_LSE})")
        if n == 12:
            worst = max(worst, err)

    # timing at the prefill path shape
    n, s, d = 12, 128, 64
    q, k, v = (rand((n, s, d), torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    ms = device_ms(torch, lambda: kern.flash_fwd(q, k, v, True, scale))
    plain_ms = device_ms(torch,
                         lambda: fa._flash_fwd_plain(q, k, v, True, scale))
    q4, k4, v4 = (t.view(1, n, s, d) for t in (q, k, v))
    lib_ms = device_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True))
    pairs = s * (s + 1) // 2           # visible (row, col) pairs per head
    ops = 2 * 2 * pairs * d * n        # QK^T and PV, causal half only
    nbytes = nbytes_of(q, k, v, q) + n * s * 4   # q k v in, o + lse out
    b_ms, b_by = bound(nbytes, ops)
    print(f"flash_fwd  prefill path timing: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}) [{card}]")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "apex_tpu/ops/flash_attention.py:222",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_decode(torch, fa, cache_mod, kern, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S, H, T, d = 8, 12, 1024, 64
    n = S * H
    path_lengths = torch.tensor([0, 1, 513, 1024, 7, 300, 1000, 64],
                                dtype=torch.int32, device="cuda")
    cases = []
    cases.append(("decode path (8x12, T 1024, d64) bf16",
                  rand((n, 1, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H)))
    kq, ks = cache_mod._quantize(rand((n, T, d)))
    vq, vs = cache_mod._quantize(rand((n, T, d)))
    cases.append(("int8 cache with scales, bf16 q", rand((n, 1, d),
                                                         torch.bfloat16),
                  kq, vq, ks, vs, path_lengths.repeat_interleave(H)))
    cases.append(("q_len=4 bf16", rand((n, 4, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H)))
    lens9 = torch.tensor([0, 3, 77, 256], dtype=torch.int32, device="cuda")
    cases.append(("q_len=9 fp32 d128", rand((16, 9, 128)),
                  rand((16, 256, 128)), rand((16, 256, 128)), None, None,
                  lens9.repeat_interleave(4)))
    worst = 0.0
    for name, q, k, v, ksc, vsc, lengths in cases:
        scale = q.shape[-1] ** -0.5
        out_k, lse_k = kern.decode_attention(q, k, v, lengths, ksc, vsc,
                                             scale)
        out_p, lse_p = fa._decode_plain(q, k, v, lengths, ksc, vsc, scale)
        torch.cuda.synchronize()
        tol = tol_for(torch, q.dtype)
        err, share = close(torch, [(out_k, out_p)], tol)
        check(share <= 1, f"decode_attention {name}: out err {err:.3g}, "
                          f"{share:.3g} x the limit {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE,
                           f"decode_attention {name}")
        empty = lengths == 0
        check(bool((out_k[empty] == 0).all())
              and bool((lse_k[empty] == float("-inf")).all()),
              "decode_attention: empty rows are not 0 / -inf")
        print(f"decode_attention {name}: max_abs_err out {err:.3g}, "
              f"{share:.3g} x the limit {tol}; lse {lerr:.3g} "
              f"(tol {TOL_LSE})")
        if q.shape[1] == 1 and k.dtype == torch.bfloat16:
            worst = max(worst, err)

    # timing: every slot at the full 1024-position prefix
    q = rand((n, 1, d), torch.bfloat16)
    k = rand((n, T, d), torch.bfloat16)
    v = rand((n, T, d), torch.bfloat16)
    full = torch.full((n,), T, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    ms = device_ms(torch, lambda: kern.decode_attention(q, k, v, full, None,
                                                        None, scale))
    plain_ms = device_ms(torch, lambda: fa._decode_plain(q, k, v, full, None,
                                                         None, scale))
    q4, k4, v4 = q.view(S, H, 1, d), k.view(S, H, T, d), v.view(S, H, T, d)
    lib_ms = device_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q4, k4, v4))
    live = int(full.sum())             # positions the lengths make live
    nbytes = 2 * live * d * 2 + nbytes_of(q, q, full) + n * 4
    ops = 2 * 2 * live * d
    b_ms, b_by = bound(nbytes, ops)
    print(f"decode_attention path timing (8 slots x 1024): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
    return {"name": "decode_attention", "route": "cuda",
            "source": "apex_tpu_torch/csrc/decode_attention.cu",
            "replaces": "apex_tpu/ops/flash_attention.py:1021",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_flash_train(torch, fa, kern, card: str):
    """flash_fwd with dropout, flash_bwd_dq and flash_bwd_dkv against their
    plain versions: the training shape and the edge cases; the dropout
    mask read back from the kernel bit for bit; timing at the training
    shape. Returns the rows of the three kernels."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the mask itself: with q = k = 0 every visible probability is 1 / sk,
    # and v = I (sk = d) puts entry (row, col) of the dropped probabilities
    # in out[row, col], so out > 0 iff the kernel kept (row, col)
    n, sq, d = 8, 256, 64
    zeros = torch.zeros((n, sq, d), device="cuda")
    eye = torch.eye(d, device="cuda").expand(n, d, d).contiguous()
    for seed in (1234, -7):
        out, _ = kern.flash_fwd(zeros, zeros[:, :d].contiguous(), eye,
                                False, 1.0, TRAIN_DROPOUT, seed)
        keep = fa._keep_mask(seed, n, sq, d, TRAIN_DROPOUT, "cuda")
        check(bool(((out > 0) == keep).all()),
              f"flash_fwd dropout mask differs from dropout_keep_mask "
              f"(seed {seed})")
    print(f"flash_fwd  dropout mask (rate {TRAIN_DROPOUT}, seeds 1234, -7, "
          f"8x256x64): equal to dropout_keep_mask bit for bit")

    cases = [  # (name, n, sq, sk, d, causal, dtype, rate)
        ("training path (8x12, 1024, 1024, d64) causal bf16",
         *TRAIN_ATTN, True, torch.bfloat16, 0.0),
        ("training shape, dropout 0.1, causal bf16",
         *TRAIN_ATTN, True, torch.bfloat16, TRAIN_DROPOUT),
        ("ragged sq=sk=100 causal bf16", 6, 100, 100, 64, True,
         torch.bfloat16, 0.0),
        ("cross sq=64 < sk=200 causal bf16", 6, 64, 200, 64, True,
         torch.bfloat16, 0.0),
        ("cross sq=64 < sk=200 non-causal bf16", 6, 64, 200, 64, False,
         torch.bfloat16, 0.0),
        ("ragged sq=sk=100 causal fp32, dropout 0.1", 6, 100, 100, 64, True,
         torch.float32, TRAIN_DROPOUT),
        ("fp32 d128 causal, dropout 0.1", 4, 128, 128, 128, True,
         torch.float32, TRAIN_DROPOUT),
        ("fp32 d128 non-causal sq=96 < sk=160", 4, 96, 160, 128, False,
         torch.float32, 0.0),
        ("fully masked rows sq=96 > sk=40 causal fp32", 4, 96, 40, 64, True,
         torch.float32, 0.0),
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, n, sq, sk, d, causal, dt, rate in cases:
        q, k, v = (rand((n, s, d), dt) for s in (sq, sk, sk))
        do = rand((n, sq, d), dt)
        scale = d ** -0.5
        seed = 20240 if rate else None
        tol = tol_for(torch, dt)
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale, rate, seed)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale, rate,
                                           seed)
        torch.cuda.synchronize()
        errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol, fwd_slack(
            torch, fa, q, k, v, causal, scale, rate, seed))}
        compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        # the backward pair on identical inputs: the plain forward's
        # output and lse
        delta = (do.float() * out_p.float()).sum(dim=-1)
        args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed)
        dq_k = kern.flash_bwd_dq(*args)
        dk_k, dv_k = kern.flash_bwd_dkv(*args)
        dq_p = fa._flash_bwd_dq_plain(*args)
        dk_p, dv_p = fa._flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        errs["flash_bwd_dq"] = close(torch, [(dq_k, dq_p)], tol)
        errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)],
                                      tol)
        for kname, (err, share) in errs.items():
            check(share <= 1, f"{kname} {name}: err {err:.3g}, {share:.3g} "
                              f"x the limit {tol}")
        if sq > sk and causal:
            masked = sq - sk
            check(bool((out_k[:, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[:, :masked]).all())
                  and bool((dq_k[:, :masked] == 0).all()),
                  "fully masked rows: out, lse or dq not 0 / +inf / 0")
        print(f"flash train {name}: max_abs_err, share of the limit "
              f"{tol}: " + ", ".join(
                  f"{kname[6:]} {err:.3g}, {share:.3g}"
                  for kname, (err, share) in errs.items()))
        if (n, sq, sk, d) == TRAIN_ATTN:
            for kname, (err, _) in errs.items():
                worst[kname] = max(worst[kname], err)
        del q, k, v, do, out_k, out_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p

    # timing at the training shape, bf16 causal, no dropout (the bench
    # step's path)
    n, sq, sk, d = TRAIN_ATTN
    q, k, v, do = (rand((n, s, d), torch.bfloat16) for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    out, lse = kern.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, True, scale)
    kernel = {"flash_fwd": lambda: kern.flash_fwd(q, k, v, True, scale),
              "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args),
              "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args)}
    plain_fn = {"flash_fwd": lambda: fa._flash_fwd_plain(q, k, v, True,
                                                         scale),
                "flash_bwd_dq": lambda: fa._flash_bwd_dq_plain(*args),
                "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_plain(*args)}
    ms = {name: device_ms(torch, fn, iters=20) for name, fn in kernel.items()}
    plain = {name: device_ms(torch, fn, iters=5)
             for name, fn in plain_fn.items()}
    b, h = TRAIN_BH
    q4, k4, v4, do4 = (t.view(b, h, -1, d) for t in (q, k, v, do))
    lib_fwd = device_ms(torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True))
    # one SDPA backward (dQ, dK and dV together) on the same tensors
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True),
        show="SDPA backward")
    del qg, kg, vg, sdpa_out
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    pairs = n * (sq * (sq + 1) // 2)   # visible (row, col) pairs, causal
    row_bytes = n * sq * 4             # one fp32 value per row
    tile = nbytes_of(q)
    work = {  # bytes (each input read once, each output written once), ops
        "flash_fwd": (4 * tile + row_bytes, 2 * 2 * pairs * d),
        "flash_bwd_dq": (5 * tile + 2 * row_bytes, 3 * 2 * pairs * d),
        "flash_bwd_dkv": (6 * tile + 2 * row_bytes, 4 * 2 * pairs * d)}
    rows = []
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        b_ms, b_by = bound(*work[kname])
        print(f"{kname} training-shape timing (96 x 1024 x 1024, d64, causal"
              f" bf16): kernel {ms[kname]:.4f} ms, plain {plain[kname]:.4f} "
              f"ms, SDPA {'fwd' if kname == 'flash_fwd' else 'bwd (dq+dk+dv)'}"
              f" {library[kname]:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{work[kname][0] / 1e6:.1f} MB, {work[kname][1] / 1e9:.2f} "
              f"GFLOP) [{card}]")
        rows.append({"name": kname, "route": "cuda",
                     "source": ("apex_tpu_torch/csrc/flash_fwd.cu"
                                if kname == "flash_fwd" else
                                "apex_tpu_torch/csrc/flash_bwd.cu"),
                     "replaces": REPLACES[kname], "max_abs_err": worst[kname],
                     "ms": ms[kname], "plain_ms": plain[kname],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library[kname]})
    return rows


# ---------------------------------------------------------------------------
# phase 4: GPT-small serving
# ---------------------------------------------------------------------------

def serve(torch, kern, card: str):
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import Request, ServingEngine, SlotScheduler

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    model = GPTModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))

    def engine(m):
        return ServingEngine(m, max_seqs=8, max_len=1024, prefill_len=128,
                             cache_dtype=torch.bfloat16, rng_seed=0,
                             device="cuda")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    requests = [Request(prompt=p, max_new_tokens=NEW_TOKENS,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i, p in enumerate(prompts)]
    eng = engine(model)
    sched = SlotScheduler(eng)
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    L = cfg.num_layers
    check(len(done) == len(requests), f"{len(done)} of {len(requests)} "
                                      "requests completed")
    for c in done.values():
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length",
              f"request {c.request_id}: {len(c.tokens)} tokens, "
              f"{c.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"request {c.request_id}: token outside the vocab")
    check(launches["flash_fwd"] == L * len(requests),
          f"flash_fwd launches {launches['flash_fwd']} != {L} x "
          f"{len(requests)} prefills")
    check(launches["decode_attention"] == L * sched.steps,
          f"decode_attention launches {launches['decode_attention']} != "
          f"{L} x {sched.steps} decode steps")
    tokens = sum(len(c.tokens) for c in done.values())
    print(f"serving: {len(done)} requests, {sched.steps} decode steps, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
          f"launches {launches} [{card}]")

    # step times: a full prefill window, then decode with all 8 slots live
    window = prompts[1]
    prefill_ms = 1e3 * _host_time(torch, lambda: eng.prefill_logits(window,
                                                                    0), 10)
    for slot in range(eng.max_seqs):
        eng.prefill_logits(window, slot)
    toks = np.zeros(eng.max_seqs, np.int64)
    decode_ms = 1e3 * _host_time(torch, lambda: eng.decode_logits(toks), 20)
    print(f"serving: prefill (128 tokens) {prefill_ms:.3f} ms, decode step "
          f"(8 slots) {decode_ms:.3f} ms [{card}]")
    profile_step(torch, "prefill (128 tokens)",
                 lambda: eng.prefill_logits(window, 0), card)
    profile_step(torch, "decode step (8 slots)",
                 lambda: eng.decode_logits(toks), card)

    # teacher-forced: the kernel path vs the plain path on the card
    plain = GPTModel(dataclasses.replace(cfg, use_kernel=False),
                     device="cuda")
    plain.load_state_dict(model.state_dict())
    ek, ep = engine(model), engine(plain)
    worst = 0.0
    for slot in range(ek.max_seqs):
        p = prompts[slot]
        lk, lp = ek.prefill_logits(p, slot), ep.prefill_logits(p, slot)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (cfg.vocab_size,), "prefill logits not finite/shaped")
        worst = max(worst, max_err(torch, lk, lp))
        toks[slot] = int(lk.argmax())
    for _ in range(4):
        lk, lp = ek.decode_logits(toks), ep.decode_logits(toks)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (ek.max_seqs, cfg.vocab_size), "decode logits not finite")
        worst = max(worst, max_err(torch, lk, lp))
        toks = lk.argmax(dim=-1).cpu().numpy()
    check(worst <= TOL_LOGITS, f"teacher-forced logits err {worst:.3g} > "
                               f"{TOL_LOGITS}")
    print(f"serving: teacher-forced logits kernel vs plain, prefill + 4 "
          f"decode steps: max_abs_err {worst:.4g} (tol {TOL_LOGITS})")
    return launches


# ---------------------------------------------------------------------------
# phase 5: GPT-small training
# ---------------------------------------------------------------------------

def grad_rel(torch, got: dict, want: dict) -> tuple:
    """The worst leaf's ``||got - want|| / ||want||`` over two name ->
    grad maps, and the leaf's name."""
    return max((float((got[n] - w).norm() / w.norm().clamp(min=1e-30)), n)
               for n, w in want.items())


def train(torch, kern, card: str):
    """GPT-small training steps at full width, the twin of
    ``bench.py::_gpt_train_step``: ``GPTModel.loss``, backward of the
    scaled loss, unscale, ``all_finite``, ``DynamicLossScale.update``,
    ``FusedAdam.step`` with the skip. Each step launches each flash kernel
    once per layer. Then the plain path (``use_kernel=False``) takes the
    same steps from the same state dict: the losses and step 0's grads are
    compared. Last, one step of each path with train-mode dropout. Returns
    the launch counts of the kernel path's steps."""
    import numpy as np
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init

    def trainer(use_kernel: bool, rate: float = 0.0):
        model = GPTModel(dataclasses.replace(
            cfg, use_kernel=use_kernel, hidden_dropout=rate,
            attention_dropout=rate), device="cuda")
        model.load_state_dict(init_state)
        params = dict(model.named_parameters())
        opt = FusedAdam(lr=1e-4)
        opt_state = opt.init(params)
        scaler = DynamicLossScale(init_scale=2.0 ** 12)
        carry = {"ls": scaler.init(device="cuda")}
        gen = torch.Generator(device="cuda").manual_seed(0) if rate else None

        def step():
            ls = carry["ls"]
            for p in params.values():
                p.grad = None
            loss = model.loss(tokens, tokens, generator=gen)
            (loss * ls.loss_scale).backward()
            grads = scaler.unscale(ls, {n: p.grad for n, p in params.items()})
            finite = all_finite(grads)
            carry["ls"] = scaler.update(ls, finite)
            opt.step(grads, opt_state, params, grads_finite=finite)
            return loss.detach(), finite, grads

        return step

    L = cfg.num_layers
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def check_counts(counts: dict, what: str) -> None:
        for name in flash:
            check(counts[name] == L, f"{what}: {name} launched "
                                     f"{counts[name]} times, not {L}")
        check(counts["decode_attention"] == 0,
              f"{what} launched decode_attention")

    step = trainer(True)
    launches = {name: 0 for name in kern.LAUNCHES}
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, finite, grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check_counts(counts, f"train step {i}")
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"train step {i}: loss {float(loss)} or grads not finite")
        for name, n in counts.items():
            launches[name] += n
        losses.append(float(loss))
        if i == 0:
            grads0 = grads
        del grads
        print(f"train step {i}: loss {losses[-1]:.6f}, {1e3 * times[-1]:.3f} "
              f"ms (host clock, synchronized), launches {counts} [{card}]")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_n = batch * seq
    print(f"train: GPT-small (batch {batch} x seq {seq}, bf16 compute, fp32 "
          f"params), median step {1e3 * steady:.3f} ms after the first "
          f"({1e3 * times[0]:.3f} ms), {tokens_n / steady:.1f} tokens/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB [{card}]")
    profile_step(torch, "train step (8 x 1024 tokens)", step, card, iters=2,
                 top=12)
    del step
    torch.cuda.empty_cache()

    # the plain path from the same state dict: no kernel launch, the same
    # losses, and step 0's grads leaf by leaf
    plain = trainer(False)
    kern.reset_launches()
    worst = 0.0
    for i in range(TRAIN_COMPARE_STEPS):
        loss, finite, grads = plain()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"plain train step {i}: loss or grads not finite")
        err = abs(float(loss) - losses[i])
        worst = max(worst, err)
        print(f"train step {i}: plain-path loss {float(loss):.6f}, kernel "
              f"path {losses[i]:.6f}, |diff| {err:.3g}")
        if i == 0:
            g_err, g_leaf = grad_rel(torch, grads0, grads)
        del grads
    del plain, grads0
    torch.cuda.empty_cache()
    check(sum(kern.LAUNCHES.values()) == 0, "the plain path launched kernels")
    check(worst <= TOL_TRAIN_LOSS, f"train loss kernel vs plain {worst:.3g} "
                                   f"> {TOL_TRAIN_LOSS}")
    check(g_err <= TOL_TRAIN_GRAD, f"step 0 grads kernel vs plain: {g_leaf} "
                                   f"{g_err:.3g} > {TOL_TRAIN_GRAD}")
    print(f"train: losses kernel path vs plain path over "
          f"{TRAIN_COMPARE_STEPS} steps: max |diff| {worst:.4g} (tol "
          f"{TOL_TRAIN_LOSS}); step 0's unscaled grads, worst leaf "
          f"{g_leaf}: ||kernel - plain|| / ||plain|| {g_err:.4g} (tol "
          f"{TOL_TRAIN_GRAD})")

    # train-mode dropout, hidden and attention, generator on the card: one
    # step of each path from the same state dict and generator seed. Both
    # draw the hidden masks alike and take the attention masks from the
    # counter hash, so they see the same masks
    ran = {}
    for use_kernel in (True, False):
        drop = trainer(use_kernel, TRAIN_DROPOUT)
        torch.cuda.synchronize()
        kern.reset_launches()
        loss, finite, grads = drop()
        torch.cuda.synchronize()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"dropout train step (use_kernel={use_kernel}): loss "
              f"{float(loss)} or grads not finite")
        ran[use_kernel] = (float(loss), grads, dict(kern.LAUNCHES))
        del drop, grads
        torch.cuda.empty_cache()
    (loss_k, grads_k, counts), (loss_p, grads_p, counts_p) = ran[True], \
        ran[False]
    check_counts(counts, "dropout train step")
    check(sum(counts_p.values()) == 0, "the plain path launched kernels")
    for name, n in counts.items():
        launches[name] += n
    err = abs(loss_k - loss_p)
    g_err, g_leaf = grad_rel(torch, grads_k, grads_p)
    del ran, grads_k, grads_p
    check(loss_k != losses[0], "dropout left the step-0 loss unchanged")
    check(err <= TOL_TRAIN_LOSS, f"dropout train loss kernel vs plain "
                                 f"{err:.3g} > {TOL_TRAIN_LOSS}")
    check(g_err <= TOL_TRAIN_GRAD, f"dropout grads kernel vs plain: {g_leaf}"
                                   f" {g_err:.3g} > {TOL_TRAIN_GRAD}")
    print(f"train: dropout {TRAIN_DROPOUT} (hidden and attention), one step:"
          f" loss kernel path {loss_k:.6f}, plain path {loss_p:.6f}, |diff| "
          f"{err:.3g} (tol {TOL_TRAIN_LOSS}); grads, worst leaf {g_leaf}: "
          f"{g_err:.4g} (tol {TOL_TRAIN_GRAD}); launches {counts}")
    return launches


def profile_step(torch, what: str, fn, card: str, iters: int = 5,
                 top: int = 8) -> None:
    """Device busy time of ``fn`` under ``torch.profiler`` against its host
    wall time, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # device-side entries only: the kernels themselves, not the host ops
    # that launched them (whose device time would count them twice)
    rows = [(e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"profile {what}: wall {wall_ms:.3f} ms (under the profiler), "
          f"device busy {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}%, "
          f"{launches:.0f} device launches [{card}]")
    for key, ms, count in rows[:top]:
        print(f"profile {what}:   {ms:8.4f} ms  x{count:<5.0f} {key[:90]}")


def _host_time(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        sys.exit(2)
    from apex_tpu_torch import _kernels as kern
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    cache_mod = importlib.import_module("apex_tpu_torch.serving.cache")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {card}")

    _, build_s = kern.build()
    print(f"build: kernels built in {build_s:.1f} s ({', '.join(kern.SOURCES)})")

    print(f"kernel vs plain: limits (atol, rtol, relative norm) bf16 "
          f"{BF16_TOL}, fp32 {FP32_TOL}, flash_fwd's bf16 atol plus "
          f"{FWD_P_ROUNDING:.4g} x sum_j p_j |v_j|; lse {TOL_LSE}")
    prefill_row = check_flash(torch, fa, kern, card)
    fwd_row, dq_row, dkv_row = check_flash_train(torch, fa, kern, card)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"],
                                 prefill_row["max_abs_err"])
    rows = [fwd_row, check_decode(torch, fa, cache_mod, kern, card), dq_row,
            dkv_row]
    serving = serve(torch, kern, card)
    training = train(torch, kern, card)
    print(f"launches on the main paths: serving {serving}, training "
          f"({TRAIN_STEPS} steps, then one with dropout) {training}")
    for row in rows:
        row["launches"] = serving[row["name"]] + training[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
