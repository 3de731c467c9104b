#!/usr/bin/env python3
"""What the device rung loop costs a plain slab family, on one CUDA card.

    python3 tools/plain_device_loop_cost.py

On chip_smoke.py phase 21 (a)'s problem (E=1024 M=64 D=2048 K=16, f32,
logistic, L2 0.5; LBFGS 60 iterations at 1e-7 and TRON's defaults) it
solves ``RandomEffectCoordinate.update`` with each slab family (``pallas``,
the kernels; ``segment`` and ``scatter``, the plain formulations) one-shot,
through the host chunk loop at chunk 8 and through the device rung loop at
chunk 8 (its first solve captures the rung graphs, the next three replay
them). A rung of R lanes transposes a plain family on the full slab (the
lanes' rows in place among zero rows, ``SlabLanes.rmatvec``), so its cost
does not shrink with R. Prints one line a (family, optimizer, way): the
walls of three solves (the device loop's capture apart), the lane-iterations
executed against the one-shot solve's, and whether the result is bitwise
the one-shot solve's. Needs a card: without one it says so and exits 1.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ("pallas", "segment", "scatter")
REPS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the device loop captures CUDA graphs; nothing measured")
        return 1
    import chip_smoke as cs
    from photon_ml_tpu_torch import native_build
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.device import enable_determinism
    from photon_ml_tpu_torch.ops import fused_sparse
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, solve_stats
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    enable_determinism()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pool.submit(native_build.build, fused_sparse.SOURCE).result()
    print(f"card: {cs.card_line()}", flush=True)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 17)
    x = cs.skewed_stack(torch, cs.E_RE, cs.M_RE, cs.D_RE, 16, g, dev)
    w_true = 0.4 * torch.randn((cs.E_RE, cs.D_RE), device=dev, generator=g)
    z = torch.matmul(x, w_true.unsqueeze(-1)).squeeze(-1)
    y = (torch.sigmoid(z) > torch.rand(z.shape, device=dev, generator=g)).float()
    ds = cs.re_dataset(torch, x, y)
    resid = torch.zeros((cs.E_RE * cs.M_RE,), device=dev)
    configs = {"LBFGS": OptimizerConfig(max_iterations=60, tolerance=1e-7),
               "TRON": OptimizerConfig.tron_default()}
    ways = {"one-shot": None, "host": SolveSchedule(cs.SCHED_CHUNK),
            "device": SolveSchedule(cs.SCHED_CHUNK, loop="device")}
    print(f"E={cs.E_RE} M={cs.M_RE} D={cs.D_RE} K=16 chunk {cs.SCHED_CHUNK}", flush=True)
    for family in FAMILIES:
        for opt, cfg in configs.items():
            base = None
            for way, schedule in ways.items():
                coord = RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION,
                                               OptimizerType(opt), cfg,
                                               RegularizationContext.l2(0.5),
                                               sparse_kernel=family, solve_schedule=schedule)
                if family == "pallas":
                    coord.slab.kernel_tables()
                walls, capture, rec = [], None, None
                for rep in range(REPS + (1 if way == "device" else 0)):
                    solve_stats.reset()
                    cs.sync(torch)
                    t0 = time.perf_counter()
                    _, res = coord.update(resid, coord.initial_coefficients())
                    cs.sync(torch)
                    wall = time.perf_counter() - t0
                    if way == "device" and rep == 0:
                        capture = wall
                    else:
                        walls.append(wall)
                    if schedule is not None:
                        rec = solve_stats.snapshot()[-1]
                if base is None:
                    base = res
                same = cs.bitwise_results(torch, res, base)
                print(f"{family:8s} {opt:5s} {way:8s}: walls "
                      + " ".join(f"{w:.4f}" for w in walls) + " s"
                      + ("" if capture is None else f" (capturing solve {capture:.4f} s)")
                      + ("" if rec is None else
                         f", lane-iterations {rec.executed} of {rec.baseline}")
                      + f", bitwise the one-shot solve: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
