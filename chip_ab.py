#!/usr/bin/env python3
"""The port's flash kernels of this tree against another tree's, on one
CUDA card, in turns: the same bits, and the device time of each.

Run from the repository root on a machine with a card and ``nvcc``::

    python3 chip_ab.py OTHER/apex_tpu_torch

where ``OTHER`` holds another version of the package, for example a parent
commit unpacked with ``git archive <commit> apex_tpu_torch | tar -x -C
OTHER`` into a directory ``.gitignore`` lists. The other tree's
``_kernels.py`` is loaded by its path as a second module and both
libraries are built at once (two threads). Each case runs the other tree's
kernel and this tree's in turns (other, this, this, other): CUDA events
around back-to-back calls after a warm-up, and whether the outputs are
equal bit for bit. The cases are GPT's attention shape (96 x 1024 x 1024,
d 64, causal) in bf16 (the tensor-core bodies) and fp32 (the SIMT bodies)
for ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``, and in bf16
``flash_bwd_dkv`` with the folded dbias of a ``(1, 12, 1, 1024)`` row
bias. A line reads ``OUTSIDE 3%`` where this tree's two times differ from
the other's by more than 3%. The card's name and power limit come first.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import threading
import time

CASE = (96, 1024, 64)   # batch-heads, sequence, head dim
TOLERANCE = 0.03        # this tree's time over the other's, in turns


def load_other(path: str):
    spec = importlib.util.spec_from_file_location("other_kernels",
                                                  f"{path}/_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def event_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: python3 chip_ab.py OTHER/apex_tpu_torch (on a CUDA "
              "card)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ".")
    from apex_tpu_torch import _kernels as this
    other = load_other(sys.argv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {card}", flush=True)
    t0 = time.perf_counter()
    builds = [threading.Thread(target=m.build) for m in (other, this)]
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    other.build()     # raises here if a build failed in its thread
    this.build()
    print(f"both trees built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def turns(name, call, iters):
        times = {"other": [], "this": []}
        outs = {}
        for who in ("other", "this", "this", "other"):
            fn = call(other if who == "other" else this)
            times[who].append(event_ms(torch, fn, iters))
            outs[who] = fn()
        torch.cuda.synchronize()
        a, b = outs["other"], outs["this"]
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        ratio = sum(times["this"]) / sum(times["other"])
        verdict = "within" if abs(ratio - 1) <= TOLERANCE else "OUTSIDE"
        print(f"{name}: other {['%.4f' % t for t in times['other']]} ms, "
              f"this {['%.4f' % t for t in times['this']]} ms, this / other "
              f"{ratio:.4f} ({verdict} {TOLERANCE:.0%}); outputs equal bit "
              f"for bit: {same} [{card}]", flush=True)

    n, s, d = CASE
    scale = d ** -0.5
    for dtype, body in ((torch.bfloat16, "bf16 mma.sync"),
                        (torch.float32, "fp32 SIMT")):
        q, k, v, do = (rand((n, s, d), dtype) for _ in range(4))
        out, lse = this.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, True, scale)
        shape = f"{n} x {s} x {s}, d {d}, causal, {body}"
        iters = 20 if dtype == torch.bfloat16 else 5
        turns(f"flash_fwd {shape}",
              lambda m: (lambda: m.flash_fwd(q, k, v, True, scale)), iters)
        turns(f"flash_bwd_dq {shape}",
              lambda m: (lambda: m.flash_bwd_dq(*args)), iters)
        turns(f"flash_bwd_dkv {shape}",
              lambda m: (lambda: m.flash_bwd_dkv(*args)), iters)
        if dtype == torch.bfloat16:
            bias = rand((1, 12, 1, s), torch.float32)
            out, lse = this.flash_fwd(q, k, v, True, scale, bias=bias)
            delta = (do.float() * out.float()).sum(-1)
            fargs = (q, k, v, do, lse, delta, True, scale)
            turns(f"flash_bwd_dkv with the folded dbias, (1, 12, 1, {s}) "
                  f"bias, {shape}",
                  lambda m: (lambda: m.flash_bwd_dkv(
                      *fargs, bias=bias, need_dbias=True)), iters)
        del q, k, v, do, out, lse, delta, args


if __name__ == "__main__":
    main()
