#!/usr/bin/env python3
"""Smoke run of photon_ml_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the main path's shapes, times it, then
drives the port's main path at full width: ``train_glm_grid`` on a dense
N=262144 x D=512 bf16 batch (the repo's dense configuration, bench.py:58),
and ``cli.glm_driver.main`` end to end on a generated LIBSVM train/validate
pair. Every phase prints on its own lines; any failed check exits non-zero.
The last lines are the card's name and power limit, one JSON object per
kernel, and ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA card is available or the
package is not beside this script. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 20260729
N_FULL, D_FULL = 262144, 512
LAMBDAS = (10.0, 1.0, 0.1)
# the card's published peaks (NVIDIA H100 SXM data sheet), for the name torch
# reports: memory bytes/s and fp32 CUDA-core flop/s
CARD = "H100 80GB HBM3"
MEM_RATE, FP32_RATE = 3.35e12, 67e12
# kernel-vs-plain shapes: the main path's (N, D), a ragged N, an odd D, and
# wider D that take the 4-, 8- and 16-column instantiations of stage 1
CHECK_SHAPES = ((N_FULL, D_FULL), (N_FULL - 37, D_FULL), (65536, D_FULL),
                (N_FULL, 65), (N_FULL - 37, 65), (65536, 65),
                (32768, 1000), (32768, 2048), (32771, 4096))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]




def time_ms(torch, fn, runs: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` launches enqueued back to
    back (CUDA events around each), after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def make_inputs(torch, loss, n, d, dtype, seed):
    """Kernel inputs on the card: X ~ N(0, 1), labels fit for the loss,
    nonzero offsets, and 1 row in 13 with weight 0 and an offset that makes
    the loss overflow (the mask must zero it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), device="cuda", generator=g).to(dtype)
    if loss.name == "POISSON":
        y = torch.poisson(torch.full((n,), 1.5, device="cuda"), generator=g)
    elif loss.name == "SQUARED":
        y = torch.randn((n,), device="cuda", generator=g)
    else:
        y = (torch.rand((n,), device="cuda", generator=g) < 0.5).float()
    wt = torch.rand((n,), device="cuda", generator=g) + 0.5
    off = 0.1 * torch.randn((n,), device="cuda", generator=g)
    wt[::13] = 0.0
    off[::13] = 1e4
    w = 0.03 * torch.randn((d,), device="cuda", generator=g)
    return x, y, wt, off, w


def sum_abs_d(torch, loss, x, y, wt, off, w):
    """sum_i |d_i|, the scale of sum_i d_i: the sum of a balanced label set's
    d is near 0, so its error is measured against the sum of magnitudes."""
    z = x.float() @ w.to(x.dtype).float() + off
    keep = wt > 0.0
    d = torch.where(keep, wt * loss.d1(z, y), torch.zeros_like(z))
    return float(d.abs().sum())


def phase_kernel_vs_plain(torch, fused_glm, losses):
    """Phase 3: kernel against plain at the main path's shapes, f32 and bf16,
    all four losses, ragged N, an odd D and wide D; all three outputs held
    against the plain version; two kernel runs bitwise equal."""
    say("== phase 3: kernel against its plain version")
    max_abs_err = 0.0
    cases = 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
        for n, d in CHECK_SHAPES:
            for loss in (losses.logistic, losses.squared, losses.poisson, losses.smoothed_hinge):
                args = (loss,) + make_inputs(torch, loss, n, d, dtype, SEED + n + d)
                got = fused_glm.fused_value_grad_kernel(*args)
                again = fused_glm.fused_value_grad_kernel(*args)
                want = fused_glm.fused_value_grad_parts_plain(*args)
                torch.cuda.synchronize()
                check(all(torch.isfinite(t).all() for t in got), f"non-finite kernel output {loss.name} {n}x{d}")
                val_err = abs(got[0].item() - want[0].item()) / abs(want[0].item())
                grad_err = (torch.linalg.vector_norm(got[1] - want[1])
                            / torch.linalg.vector_norm(want[1])).item()
                sd_err = abs(got[2].item() - want[2].item()) / (
                    abs(want[2].item()) + sum_abs_d(torch, *args))
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                max_abs_err = max(max_abs_err, *(float((a - b).abs().max()) for a, b in zip(got, want)))
                say(f"  {str(dtype)[6:]:8s} N={n:6d} D={d:4d} {loss.name:14s} "
                    f"value rel err {val_err:.3e}  |dgrad|/|grad| {grad_err:.3e}  "
                    f"sum-d err {sd_err:.3e}  bitwise repeat {same}")
                check(val_err <= tol and grad_err <= tol and sd_err <= tol,
                      f"kernel disagrees with plain beyond {tol}: {dtype} {loss.name} N={n} D={d}")
                check(same, f"two kernel runs differ: {dtype} {loss.name} N={n} D={d}")
                cases += 1
    say(f"  {cases} cases within tolerance (value and gradient relative error, and sum-d error "
        f"over |sum d| + sum |d|, <= 1e-5 f32, <= 1e-3 bf16); max |kernel - plain| over all "
        f"outputs {max_abs_err:.3e}")
    return max_abs_err


def phase_times(torch, fused_glm, losses):
    """Phase 4: kernel and plain times at N=262144, D=512 beside the bound."""
    say("== phase 4: times at N=262144, D=512 (logistic), median of 30 runs, CUDA events")
    mem_rate, flop_rate = MEM_RATE, FP32_RATE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = (losses.logistic,) + make_inputs(torch, losses.logistic, N_FULL, D_FULL, dtype, SEED)
        kernel_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
        plain_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_parts_plain(*args))
        kernel_ms2 = time_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
        item = args[1].element_size()
        nbytes = N_FULL * D_FULL * item + 12 * N_FULL + 4 * D_FULL + 4 * (D_FULL + 2)
        flops = 4 * N_FULL * D_FULL
        bytes_ms, ops_ms = nbytes / mem_rate * 1e3, flops / flop_rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        ms = statistics.median([kernel_ms, kernel_ms2])
        name = str(dtype)[6:]
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "share_of_bound": bound_ms / ms,
            "ms_runs": [kernel_ms, kernel_ms2],
        }
        say(f"  {name:8s} kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms   plain two-pass {plain_ms:.4f} ms "
            f"(context only)   bound {bound_ms:.4f} ms = {nbytes} B / {mem_rate / 1e12:.2f} TB/s "
            f"({CARD}; ops bound {ops_ms:.4f} ms)   share of bound {bound_ms / ms:.3f}")
    return out


def phase_train_grid(torch, fused_glm, kernel_ms):
    """Phase 5: train_glm_grid at full width through the kernel; each
    lambda's final objective against a solve whose objective is plain."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.training import train_glm_grid
    from photon_ml_tpu_torch.types import TaskType

    say(f"== phase 5: train_glm_grid N={N_FULL} D={D_FULL} bf16 storage, logistic, L2, "
        f"lambdas {list(LAMBDAS)}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((N_FULL, D_FULL), device="cuda", generator=g)
    x[:, -1] = 1.0  # intercept column
    w_true = torch.randn((D_FULL,), device="cuda", generator=g) / D_FULL ** 0.5
    y = (torch.rand((N_FULL,), device="cuda", generator=g) < torch.sigmoid(x @ w_true)).float()
    batch = GLMBatch.create(DenseFeatures(x.to(torch.bfloat16)), y)
    del x
    norm = NormalizationContext.identity()
    problem = GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION,
                                     regularization=RegularizationContext.l2(1.0))

    def plain_grid():  # the same warm-start chain, objective on the plain path
        w, values = torch.zeros((D_FULL,), device="cuda"), []
        for lam in sorted(LAMBDAS, reverse=True):
            model, res = problem.run(batch, norm, init_coefficients=w, reg_weight=lam)
            w = model.coefficients.means
            values.append(float(res.value))
        return values

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # plain, kernel, kernel, plain: the first plain run also warms up
    plain_values, plain_s0 = timed(plain_grid)
    fused_glm.fused_value_grad_kernel.launches = 0
    trained, kernel_s0 = timed(lambda: train_glm_grid(problem, batch, norm, LAMBDAS))
    launches = fused_glm.fused_value_grad_kernel.launches
    check(launches > 0, "train_glm_grid did not launch the fused kernel")
    _, kernel_s1 = timed(lambda: train_glm_grid(problem, batch, norm, LAMBDAS))
    before = fused_glm.fused_value_grad_kernel.launches
    _, plain_s1 = timed(plain_grid)
    check(fused_glm.fused_value_grad_kernel.launches == before,
          "the plain-objective solve launched the kernel")
    for lam, res, pv in zip(trained.weights, trained.results, plain_values):
        fv = float(res.value)
        say(f"  lambda={lam:g}: kernel objective {fv:.6f} ({int(res.iterations)} iterations, "
            f"reason {int(res.reason)})  plain objective {pv:.6f}  rel diff {abs(fv - pv) / abs(pv):.2e}")
        check(np.isfinite(fv) and abs(fv - pv) <= 1e-2 * abs(pv) + 2e-3,
              f"lambda={lam}: kernel-path objective {fv} vs plain {pv} beyond solver tolerance")
        check(bool(torch.isfinite(res.coefficients).all()), f"lambda={lam}: non-finite coefficients")
    kernel_s = min(kernel_s0, kernel_s1)
    say(f"  kernel launches {launches} over {len(LAMBDAS)} solves "
        f"({launches / len(LAMBDAS):.1f} per solve, 1 per value_and_grad)")
    say(f"  grid wall, in turns: plain {plain_s0:.4f} s, kernel {kernel_s0:.4f} s, "
        f"kernel {kernel_s1:.4f} s, plain {plain_s1:.4f} s")
    say(f"  kernel device time {launches} x {kernel_ms:.4f} ms = {launches * kernel_ms / 1e3:.4f} s, "
        f"{launches * kernel_ms / 1e3 / kernel_s:.3f} of the kernel-path grid wall")
    return launches


def _write_libsvm(path, n, d, nnz, w_true, rng):
    cols = np.sort(np.stack([rng.choice(d, size=nnz, replace=False) for _ in range(n)]), axis=1)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    z = (vals * w_true[cols]).sum(1)
    labels = np.where(rng.random(n) < 1.0 / (1.0 + np.exp(-z)), 1, -1)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{labels[i]} " + " ".join(f"{c + 1}:{v:.4f}" for c, v in zip(cols[i], vals[i])) + "\n")


def phase_driver(torch, fused_glm, workdir):
    """Phase 6: glm_driver.main end to end on a generated LIBSVM pair."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem

    n_train, n_val, d, nnz = 65536, 8192, 511, 32
    say(f"== phase 6: glm_driver.main on LIBSVM train {n_train} x {d} (+ intercept), "
        f"validate {n_val}, ~{nnz} non-zeros per row, LBFGS, L2, STANDARDIZATION, 3 lambdas")
    rng = np.random.default_rng(SEED)
    w_true = rng.normal(size=d).astype(np.float32) * 0.5
    t0 = time.perf_counter()
    for name, n in (("train", n_train), ("validate", n_val)):
        os.makedirs(os.path.join(workdir, name))
        _write_libsvm(os.path.join(workdir, name, "part-00000.txt"), n, d, nnz, w_true, rng)
    say(f"  data written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "out")
    argv = [
        "--training-data-directory", os.path.join(workdir, "train"),
        "--validating-data-directory", os.path.join(workdir, "validate"),
        "--output-directory", out, "--task", "LOGISTIC_REGRESSION",
        "--input-file-format", "LIBSVM", "--feature-dimension", str(d),
        "--regularization-weights", ",".join(f"{lam:g}" for lam in LAMBDAS),
        "--optimizer", "LBFGS", "--regularization-type", "L2",
        "--normalization-type", "STANDARDIZATION", "--compute-variance", "true",
    ]
    torch.cuda.synchronize()
    fused_glm.fused_value_grad_kernel.launches = 0
    t0 = time.perf_counter()
    driver = glm_driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_glm.fused_value_grad_kernel.launches
    check(launches > 0, "glm_driver did not launch the fused kernel")
    check(driver.device.type == "cuda" and driver.train_batch.labels.is_cuda, "driver ran off the card")
    check(driver.train_batch.dim == d + 1, f"batch width {driver.train_batch.dim} != {d + 1}")
    outputs = sorted(os.listdir(os.path.join(out, "output")))
    best = sorted(os.listdir(os.path.join(out, "best")))
    check(len(outputs) == len(LAMBDAS) and len(best) == 1, f"model output {outputs} / {best}")
    for lam, model in driver.models:
        check(bool(torch.isfinite(model.coefficients.means).all()), f"lambda={lam}: non-finite model")
        check(model.coefficients.means.shape == (d + 1,), "model width")
    auc = driver.validation_metrics[driver.best_reg_weight]["Area under ROC"]
    say(f"  validation AUC {auc:.6f} at best lambda={driver.best_reg_weight:g}; "
        f"output/ {outputs}, best/ {best}; kernel launches {launches}; wall {wall:.2f} s")
    check(auc > 0.5, f"validation AUC {auc} <= 0.5")

    # the same solves with the plain objective on the card, as the reference
    plain = GLMOptimizationProblem(driver.problem.task, optimizer_config=driver.problem.optimizer_config,
                                   regularization=driver.problem.regularization)
    w = torch.zeros((d + 1,), device="cuda")
    for lam, res in zip(driver.trained.weights, driver.trained.results):
        model, ref = plain.run(driver.train_batch, driver.norm, init_coefficients=w, reg_weight=lam)
        w = model.coefficients.means
        fv, pv = float(res.value), float(ref.value)
        say(f"  lambda={lam:g}: driver objective {fv:.6f}  plain-objective solve {pv:.6f}")
        check(abs(fv - pv) <= 1e-2 * abs(pv) + 2e-3, f"lambda={lam}: driver objective off the plain solve")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from photon_ml_tpu_torch import native_build
    from photon_ml_tpu_torch.ops import fused_glm, losses

    say("== phase 1: device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    check(CARD in name, f"{name}: the bound's peaks are known only for the {CARD}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"  nvidia-smi: {card}")
    say(f"  torch {torch.__version__} (CUDA {torch.version.cuda}) on {name}, "
        f"{torch.cuda.device_count()} device(s); TF32 off for matmul and cuDNN")

    say("== phase 2: build the kernel library from csrc/")
    t0 = time.perf_counter()
    path = native_build.build(fused_glm.SOURCE)
    say(f"  {os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))} built in "
        f"{time.perf_counter() - t0:.2f} s")
    log = native_build.build_logs.get("fused_glm", "").splitlines()
    regs = [line.split("Used ")[1].split(" registers")[0] for line in log if "registers" in line]
    spills = sum(1 for line in log if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
    say(f"  ptxas: registers per kernel {regs}; kernels with spills or stack: {spills}")

    max_abs_err = phase_kernel_vs_plain(torch, fused_glm, losses)
    times = phase_times(torch, fused_glm, losses)
    grid_launches = phase_train_grid(torch, fused_glm, times["bfloat16"]["ms"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        driver_launches = phase_driver(torch, fused_glm, workdir)

    bf16 = times["bfloat16"]
    kernels = [{
        "name": "fused_glm_value_grad",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_glm.cu",
        "replaces": "photon_ml_tpu/ops/fused_glm.py:223",
        "also_replaces": ["photon_ml_tpu/ops/fused_glm.py:350"],
        "launches": driver_launches,
        "launches_train_glm_grid": grid_launches,
        "max_abs_err": max_abs_err,
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
        "shape": f"N={N_FULL} D={D_FULL} bf16",
        "f32": times["float32"],
    }]
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
