#!/usr/bin/env python3
"""Time the sparse GEVM and HVP calls of two checkouts of this repo in turns, on one CUDA card.

    python3 tools/compare_sparse_checkouts.py OTHER_CHECKOUT [--out FILE]

OTHER_CHECKOUT is the root of another checkout of this repo, for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>`` into
a git-ignored directory. Each checkout's ``photon_ml_tpu_torch`` is imported
in a process of its own, which builds that checkout's kernels into its own
``_build/``; the processes run in the order other, this, this, other.

Each process makes chip_smoke.py's phase-8 inputs (logistic, f32, the full
width and the GAME driver's slab shape) and times, by chip_smoke.py's three
readings (per-launch CUDA events, CUDA-graph replay, the host clock), the
calls the solvers make (``fused_value_grad_parts``, ``fused_hvp_parts``) and
the kernel wrappers alone (``sparse_gevm_kernel``, ``sparse_hvp_kernel``).
It counts one call's device kernels with torch.profiler and reports the
bytes of the slab's column tables. Nothing else of a checkout is used, so
any two checkouts whose sparse module keeps these functions' signatures can
be compared.

Prints the card's name and power limit, one line per process, kernel and
shape, and the medians of each checkout's two processes; ``--out`` writes
every reading as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = ("ms", "graph_ms", "host_ms")


def table_bytes(slab) -> int:
    """Bytes of the slab's column tables as its checkout builds them: the
    packed tables (``kernel_tables``) or ``column_order``'s (perm,
    col_start)."""
    if hasattr(slab, "kernel_tables"):
        return slab.kernel_tables().nbytes
    return sum(t.numel() * t.element_size() for t in slab.column_order())


def time_checkout(root: str) -> dict:
    """Every reading of ``root``'s sparse calls, in this process."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, root)  # ahead of this repo, which chip_smoke put first
    from photon_ml_tpu_torch.ops import fused_sparse as fs
    from photon_ml_tpu_torch.ops import losses

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(fs.__file__))))
    if os.path.realpath(pkg_root) != os.path.realpath(root):
        raise SystemExit(f"imported {fs.__file__}, not the sparse module of {root}")
    loss = losses.logistic
    out = {}
    for label, e, m, d, kmax, full in cs.SPARSE_TIME_SHAPES:
        slab, y, wt, off, w, v, vshift = cs.sparse_inputs(torch, fs, loss, e, m, d, kmax, cs.SEED,
                                                          full=full)
        fns = {
            "gevm": lambda: fs.fused_value_grad_parts(loss, slab, y, wt, off, w),
            "gevm kernel": lambda: fs.sparse_gevm_kernel(loss, slab, y, wt, off, w),
            "hvp": lambda: fs.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift),
            "hvp kernel": lambda: fs.sparse_hvp_kernel(loss, slab, y, wt, off, w, v, vshift),
        }
        res = {"table_bytes": table_bytes(slab)}
        for name, fn in fns.items():
            fn()  # builds the slab's tables and plan outside the readings
            kernels = cs.launches_of_one_call(torch, fn)[0]
            res[name] = {"ms": cs.time_ms(torch, fn), "graph_ms": cs.graph_ms(torch, fn),
                         "host_ms": cs.host_ms(torch, fn), "device_kernels_per_call": len(kernels)}
        out[label] = res
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--out", help="write every reading to this JSON file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(time_checkout(os.path.abspath(args.other))), flush=True)
        return

    import chip_smoke as cs

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    roots = {"other": os.path.abspath(args.other), "this": REPO}
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), roots[who], "--child"],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{who} ({roots[who]}) failed:\n{proc.stdout}\n{proc.stderr}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[who].append(run)
        for label, res in run.items():
            for name in ("gevm", "gevm kernel", "hvp", "hvp kernel"):
                r = res[name]
                print(f"{who}: {label} {name}: events {r['ms']:.5f} ms, graph {r['graph_ms']:.5f} "
                      f"ms, host {r['host_ms']:.5f} ms, {r['device_kernels_per_call']} device "
                      f"kernel(s) a call; column tables {res['table_bytes']} B", flush=True)
    for label in runs["this"][0]:
        for name in ("gevm", "gevm kernel", "hvp", "hvp kernel"):
            med = {who: {key: statistics.median(run[label][name][key] for run in runs[who])
                         for key in READINGS} for who in runs}
            print(f"median of two processes, {label} {name}: "
                  + "; ".join(f"{key} other {med['other'][key]:.5f} this {med['this'][key]:.5f} "
                              f"(other / this {med['other'][key] / med['this'][key]:.2f})"
                              for key in READINGS), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "roots": roots, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
