#!/usr/bin/env python3
"""Where a block of the sparse GEVM/HVP kernels spends its time, on one CUDA card.

    python3 tools/sparse_phase_clocks.py

Builds an instrumented copy of photon_ml_tpu_torch/csrc/fused_sparse.cu
(into the git-ignored photon_ml_tpu_torch/_build/phase_clocks/) in which
thread 0 of every block records clock64() and %globaltimer at each phase
boundary: start, after the staged loads, after the margins, after the loss
terms, after the column phase, after the row sums. The records go to the
kernel's row-values buffer, whose own writes the copy drops. Runs both
kernels at chip_smoke.py's phase-8 shapes (logistic, f32) and prints, per
kernel and shape, the median cycles of each phase over the blocks and when
the blocks started and ended (ns from the first start). The instrumented
kernel is for reading only; its results are not checked.

A one-off diagnostic, not part of any check: the copy is made by finding
five lines of fused_sparse.cu as text (ANCHORS and LAST_LINE below) and by
reusing the test-only row-values buffer, so it stops with a message after
an edit to those lines and must then be re-anchored to the new source.
Its readings hold only for the kernel source it ran on.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("load", "margins", "loss", "columns", "sums")
# the marks go before (or, for the loss terms' end, after) these lines
ANCHORS = ("  // 4. margins", "  // 5. loss terms", "  constexpr int nrv = kHvp ? 1 : 2;\n",
           "  // 7. row sums")
LAST_LINE = "    if (lane == 0) (u < nl ? sum_a : sum_b)[e0 + u % nl] = acc;\n  }\n"


def mark(i: int) -> str:
    return ("  if (threadIdx.x == 0) { long long g; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); "
            f"clocks[blockIdx.x * 16 + {i}] = clock64(); clocks[blockIdx.x * 16 + 8 + {i}] = g; }}\n")


def instrumented(src: str) -> str:
    src = src.replace("  if (rows_out != nullptr) {", "  if (false) {", 1)
    src = src.replace("  // 1. start the copies",
                      "  long long* clocks = reinterpret_cast<long long*>(rows_out);\n"
                      + mark(0) + "  // 1. start the copies", 1)
    for i, anchor in enumerate(ANCHORS, start=1):
        if anchor not in src:
            raise SystemExit(f"the kernel source no longer has {anchor!r}")
        cut = anchor + mark(i) if anchor.startswith("  constexpr") else mark(i) + anchor
        src = src.replace(anchor, cut, 1)
    if LAST_LINE not in src:
        raise SystemExit("the kernel source no longer ends its row sums as expected")
    return src.replace(LAST_LINE, LAST_LINE + "  __syncthreads();\n" + mark(5), 1)


def main() -> None:
    import torch

    import chip_smoke as cs
    from photon_ml_tpu_torch import native_build
    from photon_ml_tpu_torch.ops import fused_sparse as fs
    from photon_ml_tpu_torch.ops import losses

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = os.path.join(native_build.BUILD_DIR, "phase_clocks")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(native_build.CSRC_DIR, "losses.cuh"), out_dir)
    with open(os.path.join(native_build.CSRC_DIR, fs.SOURCE)) as f:
        src = instrumented(f.read())
    with open(os.path.join(out_dir, fs.SOURCE), "w") as f:
        f.write(src)
    lib = ctypes.CDLL(native_build.build(fs.SOURCE, csrc_dir=out_dir))
    fs._configure(lib)
    fs._library = lambda: lib
    print(cs.card_line(), flush=True)
    loss = losses.logistic
    for label, e, m, d, kmax, full in cs.SPARSE_TIME_SHAPES:
        slab, y, wt, off, w, v, vshift = cs.sparse_inputs(torch, fs, loss, e, m, d, kmax, cs.SEED,
                                                          full=full)
        for kind in ("gevm", "hvp"):
            buf = torch.zeros((2 if kind == "gevm" else 1, e, m), device="cuda")
            if kind == "gevm":
                call = lambda: fs.sparse_gevm_kernel(loss, slab, y, wt, off, w, row_values=buf)
            else:
                call = lambda: fs.sparse_hvp_kernel(loss, slab, y, wt, off, w, v, vshift,
                                                    row_values=buf)
            plan = slab._kernel_launch(kind).plan
            if buf.numel() < 32 * plan.blocks:  # 16 int64 a block
                raise SystemExit(f"{label} {kind}: the row-values buffer cannot hold the clocks")
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            raw = buf.view(-1).view(torch.int64)[:plan.blocks * 16].view(plan.blocks, 16).cpu()
            clk, gt = raw[:, :8], raw[:, 8:]
            med = {p: statistics.median((clk[:, i + 1] - clk[:, i]).tolist())
                   for i, p in enumerate(PHASES)}
            t0 = int(gt[:, 0].min())
            starts, ends = gt[:, 0] - t0, gt[:, 5] - t0
            print(f"{label} {kind}: {plan.blocks} blocks of {plan.lanes_per_block} lanes; median "
                  "cycles a block: " + ", ".join(f"{p} {v:.0f}" for p, v in med.items())
                  + f", all {statistics.median((clk[:, 5] - clk[:, 0]).tolist()):.0f}; blocks "
                  f"started at 0..{int(starts.max())} ns (median {int(starts.median())}), ended "
                  f"at {int(ends.min())}..{int(ends.max())} ns (median {int(ends.median())})",
                  flush=True)


if __name__ == "__main__":
    main()
