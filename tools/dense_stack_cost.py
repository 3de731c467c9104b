"""What the dense random-effect stack's contraction costs, in two checkouts
on one card: chip_smoke.py phase 20 (c)'s unbucketed GAME driver run (its
train stage) and the one-shot solves of phase 21 (f)'s dense stacks (three
calls each, LBFGS and TRON).

    python3 tools/dense_stack_cost.py OTHER_CHECKOUT

runs OTHER_CHECKOUT and this tree in turns (other, this, this, other), each
in its own process, on phase 20's data written once, and prints one
``COST {json}`` line a run. Each checkout builds its own kernels. Needs a
CUDA card.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(root, data, label):
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from photon_ml_tpu_torch import native_build
    from photon_ml_tpu_torch.device import enable_determinism
    from photon_ml_tpu_torch.ops import fused_glm, fused_sparse

    enable_determinism()
    if not os.path.abspath(fused_sparse.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {fused_sparse.__file__}, not {root}'s")
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(native_build.build, s) for s in (fused_glm.SOURCE,
                                                              fused_sparse.SOURCE)]
        builds += [pool.submit(native_build.build_host, s, libs) for s, libs in (
            ("avro_decoder.cpp", ("-lz",)), ("libsvm_parser.cpp", ()), ("pmix_store.cpp", ()))]
        for f in builds:
            f.result()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not os.path.isdir(os.path.join(data, "train")):
        cs.write_game_avro(data, cs.SKEW_USERS, cs.SEED + 20,
                           rows_per_user=cs.skewed_rows(cs.SKEW_USERS, cs.SKEW_SEED))
    out = {"label": label}
    argv = ["--train-input-dirs", os.path.join(data, "train"), "--validate-input-dirs",
            os.path.join(data, "validate"), "--device", "cuda",
            "--output-dir", os.path.join(data, "out-" + label)] + cs.GAME_FLAGS
    _, wall, _, stages, _ = cs.run_game_training(torch, fused_sparse, argv, "pallas")
    out["20c"] = {"wall_s": wall, "stages_s": stages}

    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    for name, e, m, d in cs.DENSE_STACK_SHAPES:
        (x, y, off, wt), w0 = cs.dense_stack_problem(torch, "cuda", e, m, d, cs.SEED + e + d)
        for opt in ("LBFGS", "TRON"):
            cfg = (OptimizerConfig.tron_default() if opt == "TRON"
                   else OptimizerConfig(max_iterations=60, tolerance=1e-7))
            kw = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[opt],
                      optimizer_config=cfg, regularization=RegularizationContext.l2(0.5))
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = entity_lane_fns(**kw)[0](x, y, off, wt, w0)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[f"21f {name} {opt}"] = {"walls_s": walls, "iters": int(res.iterations.max())}
    print("COST " + json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--one":
        one(*sys.argv[2:5])
        return
    other = os.path.abspath(sys.argv[1])
    data = tempfile.mkdtemp(prefix="dense_stack_cost_")
    for label, root in (("other1", other), ("this1", HERE), ("this2", HERE),
                        ("other2", other)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, data,
                            label], capture_output=True, text=True)
        print("\n".join(line for line in r.stdout.splitlines() if line.startswith("COST")),
              flush=True)
        if r.returncode:
            raise SystemExit(f"{label} exited {r.returncode}: {r.stderr[-3000:]}")


if __name__ == "__main__":
    main()
