#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc`` (the kernels are built from ``apex_tpu_torch/csrc`` on
first use); without a card, or without the package beside it, it exits
non-zero and prints no result. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels, timed;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at ragged, cross, fp32, int8 and multi-row
   cases, with the max abs error beside its tolerance; kernel, plain and
   library (SDPA, a yardstick only: the port never calls it) times;
4. GPT-small (vocab 32768, hidden 768, 12 layers, 12 heads, 1024
   positions; random weights from a seed) served at full width: a
   ``ServingEngine`` (8 slots, max_len 1024, prefill window 128, bf16
   cache) under a ``SlotScheduler`` with 16 requests of mixed prompt
   lengths, 32 new tokens each, half greedy. Launch counts are set to 0
   just before the run and read just after: ``flash_fwd`` must run 12
   times per prefill and ``decode_attention`` 12 times per decode step.
   Then prefill and decode-step times, and a teacher-forced check of the
   kernel path's logits against the plain path's on the card;
5. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` last.
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

# tolerances, kernel vs plain on identical inputs. bf16 outputs: both
# versions accumulate in fp32 and round once to bf16, but the flash kernel
# rounds the unnormalized probabilities to bf16 before the P V product
# (as the TPU kernel does) where the plain version rounds the normalized
# ones: a few bf16 ulps at |out| ~ 1 (one ulp is 2**-7). fp32 outputs and
# every lse: summation order only.
TOL_BF16 = 2e-2
TOL_FP32 = 1e-4
# teacher-forced GPT-small logits, kernel path vs plain path: bf16
# activations whose attention outputs differ by a few ulps per layer,
# carried through 12 residual layers and the tied head (|logit| ~ 1)
TOL_LOGITS = 0.1

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


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def compare_lse(torch, lse_k, lse_p, tol: float, what: str) -> float:
    inf_k, inf_p = torch.isinf(lse_k), torch.isinf(lse_p)
    check(bool((inf_k == inf_p).all()), f"{what}: infinite lse rows differ")
    check(bool((lse_k[inf_k] == lse_p[inf_p]).all()),
          f"{what}: infinite lse signs differ")
    fin = ~inf_k
    err = max_err(torch, lse_k[fin], lse_p[fin])
    check(err <= tol, f"{what}: lse err {err:.3g} > {tol}")
    return err


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
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        err = max_err(torch, out_k, out_p)
        check(err <= tol, f"flash_fwd {name}: out err {err:.3g} > {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_FP32, f"flash_fwd {name}")
        if sq > sk and causal:
            masked = sq - sk
            check(bool((out_k[:, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[:, :masked]).all()),
                  "flash_fwd: fully masked rows are not 0 / +inf")
        print(f"flash_fwd  {name}: max_abs_err out {err:.3g} (tol {tol}), "
              f"lse {lerr:.3g} (tol {TOL_FP32})")
        if n == 12:
            worst = max(worst, err)

    # timing at the prefill path shape
    n, s, d = 12, 128, 64
    q, k, v = (rand((n, s, d), torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    ms = time_ms(torch, lambda: kern.flash_fwd(q, k, v, True, scale))
    plain_ms = time_ms(torch,
                       lambda: fa._flash_fwd_plain(q, k, v, True, scale))
    q4, k4, v4 = (t.view(1, n, s, d) for t in (q, k, v))
    lib_ms = time_ms(torch, lambda: torch.nn.functional
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
                  path_lengths.repeat_interleave(H), TOL_BF16))
    kq, ks = cache_mod._quantize(rand((n, T, d)))
    vq, vs = cache_mod._quantize(rand((n, T, d)))
    cases.append(("int8 cache with scales, bf16 q", rand((n, 1, d),
                                                         torch.bfloat16),
                  kq, vq, ks, vs, path_lengths.repeat_interleave(H),
                  TOL_BF16))
    cases.append(("q_len=4 bf16", rand((n, 4, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H), TOL_BF16))
    lens9 = torch.tensor([0, 3, 77, 256], dtype=torch.int32, device="cuda")
    cases.append(("q_len=9 fp32 d128", rand((16, 9, 128)),
                  rand((16, 256, 128)), rand((16, 256, 128)), None, None,
                  lens9.repeat_interleave(4), TOL_FP32))
    worst = 0.0
    for name, q, k, v, ksc, vsc, lengths, tol in cases:
        scale = q.shape[-1] ** -0.5
        out_k, lse_k = kern.decode_attention(q, k, v, lengths, ksc, vsc,
                                             scale)
        out_p, lse_p = fa._decode_plain(q, k, v, lengths, ksc, vsc, scale)
        torch.cuda.synchronize()
        err = max_err(torch, out_k, out_p)
        check(err <= tol, f"decode_attention {name}: out err {err:.3g} > "
                          f"{tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_FP32,
                           f"decode_attention {name}")
        empty = lengths == 0
        check(bool((out_k[empty] == 0).all())
              and bool((lse_k[empty] == float("-inf")).all()),
              "decode_attention: empty rows are not 0 / -inf")
        print(f"decode_attention {name}: max_abs_err out {err:.3g} "
              f"(tol {tol}), lse {lerr:.3g} (tol {TOL_FP32})")
        if q.shape[1] == 1 and k.dtype == torch.bfloat16:
            worst = max(worst, err)

    # timing: every slot at the full 1024-position prefix
    q = rand((n, 1, d), torch.bfloat16)
    k = rand((n, T, d), torch.bfloat16)
    v = rand((n, T, d), torch.bfloat16)
    full = torch.full((n,), T, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    ms = time_ms(torch, lambda: kern.decode_attention(q, k, v, full, None,
                                                      None, scale))
    plain_ms = time_ms(torch, lambda: fa._decode_plain(q, k, v, full, None,
                                                       None, scale))
    q4, k4, v4 = q.view(S, H, 1, d), k.view(S, H, T, d), v.view(S, H, T, d)
    lib_ms = time_ms(torch, lambda: torch.nn.functional
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


def profile_step(torch, what: str, fn, card: str, iters: int = 5) -> None:
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
    for key, ms, count in rows[:8]:
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

    rows = [check_flash(torch, fa, kern, card),
            check_decode(torch, fa, cache_mod, kern, card)]
    launches = serve(torch, kern, card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
