#!/usr/bin/env python3
"""The port's two decode kernels of one checkout, on one CUDA card: the
bits and times that ``chip_smoke.py`` reads, so that two checkouts (a
parent commit unpacked with ``git archive`` and the working tree) can be
held side by side in one run.

    python3 scripts/decode_compare.py TREE [TREE ...]

runs each TREE in a process of its own, in the order given (give them in
turns, as ``parent new new parent``: the card's clock drifts). Each
process puts TREE's ``apex_tpu_torch`` first on the path, builds its
kernels and, with the functions of this checkout's ``chip_smoke.py``,
prints: the build's seconds; ptxas's registers and spills of the decode
kernels' instances whose q and cache are both bf16 or both fp32, by
their mangled template arguments (from the build's log: the first process
of a TREE builds it); ``decode_attention``'s checks and the sha256
of its outputs over ``chip_smoke.py``'s dense cases (``check_decode``),
with its times at d 64 (``decode_timings``); both kernels' times at 8
slots x 12 heads x 1024 positions at d 128 in bf16; and
``paged_decode_attention``'s times at d 64 beside the dense kernel's
(``paged_timings``). It imports nothing of JAX.
"""

import importlib
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_tree(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import apex_tpu_torch
    from apex_tpu_torch import _kernels as kern
    if not Path(apex_tpu_torch.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        sys.exit(f"imported {apex_tpu_torch.__file__}, not {tree}'s")
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    cache_mod = importlib.import_module("apex_tpu_torch.serving.cache")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    _, build_s = kern.build()
    print(f"=== {tree}: kernels built in {build_s:.1f} s [{card}]",
          flush=True)
    for blk in kern.build_log().split("Compiling entry function")[1:]:
        name = re.search(r"\d+((?:paged_)?decode_kernel)I"
                         r"(13__nv_bfloat16S\d*_|ff)(\w+?)EEv", blk)
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        if name and regs and spill:
            dtype = "fp32" if name.group(2) == "ff" else "bf16"
            print(f"ptxas {name.group(1)}<{dtype}, {name.group(3)}>: "
                  f"{regs.group(1)} registers, spill {spill.group(1)}/"
                  f"{spill.group(2)} bytes")
    cs.check_decode(torch, fa, cache_mod, kern, card)

    gen = torch.Generator(device="cuda").manual_seed(9)
    S, H, T, d, nb, bs = 8, 12, 1024, 128, 65, 128
    n = S * H
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((n, 1, d), (n, T, d), (n, T, d)))
    kp, vp = (torch.randn((nb, H, bs, d), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    tables = (torch.randperm(nb - 1, device="cuda")[: S * T // bs] + 1).view(
        S, T // bs).to(torch.int32)
    full = torch.full((n,), T, dtype=torch.int32, device="cuda")
    dense_ms = cs.device_ms(torch, lambda: kern.decode_attention(
        q, k, v, full, None, None, d ** -0.5))
    paged_ms = cs.device_ms(torch, lambda: kern.paged_decode_attention(
        q, kp, vp, tables, full[:S], None, None, d ** -0.5))
    b_ms, b_by = cs.bound(2 * n * T * d * 2 + 2 * n * d * 2, 4 * n * T * d)
    print(f"d 128, 8 slots x 1024 bf16: decode_attention {dense_ms:.4f} ms, "
          f"paged_decode_attention {paged_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}) [{card}]", flush=True)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(4))
    cs.paged_timings(torch, fa, kern, card, (perm[: S * 8] + 1).view(S, 8)
                     .to(device="cuda", dtype=torch.int32))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_tree(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        done = subprocess.run([sys.executable, __file__, "--one", tree])
        if done.returncode:
            sys.exit(f"{tree}: exit {done.returncode}")


if __name__ == "__main__":
    main()
