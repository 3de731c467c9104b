#!/usr/bin/env python3
"""Smoke run of photon_ml_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels and its host libraries (the native Avro
decoder, LIBSVM parser and off-heap index store of ``native/``) from the
sources in this checkout (one compiler per source, all started together),
holds each kernel against its plain PyTorch version at the main paths'
shapes and times it, then drives the port's main paths at full width:

  * dense GLM training: ``train_glm_grid`` on a dense N=262144 x D=512 bf16
    batch (the repo's dense configuration, bench.py:58), and
    ``cli.glm_driver.main`` end to end on a generated LIBSVM train/validate
    pair of 262144 training rows, parsed by the native loader (the fused
    value+gradient kernel);
  * GAME training: ``RandomEffectCoordinate.update`` with LBFGS and with
    TRON on the sparse-race configuration (E=1024 entities x M=64 rows,
    D=2048, bench.py:2556-2627; the sparse GEVM and HVP kernels), and
    ``cli.game_training_driver.main`` end to end on generated Avro data of
    bench.py's GAME configuration (bench.py:2338-2350), every file read by
    the native Avro decoder;
  * GAME ingest: ``read_game_data`` on the validation rows natively and
    through the Python row loop, byte-equal, rows/s both ways;
  * GAME scoring: ``cli.game_scoring_driver.main`` on the trained model,
    device scoring against the host oracle and the training driver's AUC,
    the scoring gather timed against its bytes bound;
  * off-heap index maps: ``cli.feature_indexing`` (OFFHEAP, 8 partitions),
    then training and scoring with ``--offheap-indexmap-dir``;
  * RANDOM projection: one random-effect update on the card against the
    same update on the CPU;
  * checkpoints and preemption: the GAME driver with ``--checkpoint-dir``,
    stopped (a subprocess exiting 75) and resumed, async, and restarted
    in-process, every model byte-equal to the uninterrupted run's;
  * sparse fixed effects: ``cli.glm_driver.main`` on bench.py:59's
    sparse-wide data (N=131072, D=2^20) and the GAME driver with a 2^17-wide
    fixed shard, twice on the card (byte-equal) and once on the CPU, with the
    wide matvec and transposes timed against their bytes bound.

Deterministic algorithms are on from the start (``device.enable_determinism``).
Every phase prints on its own lines; any failed check exits non-zero. The
last lines are a JSON object of the sparse and checkpoint phases' numbers,
the card's name and power limit, one JSON object listing the kernels, and
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA card is available or the
package is not beside this script. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

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
# how every kernel's time is read (both methods, for every kernel)
MS_METHOD = ("ms: median of 30 per-launch CUDA-event readings (host launch time between "
             "calls included); graph_ms: median of 30 CUDA-graph replays of 20 launches, "
             "per launch; host_ms (sparse kernels): host clock over 200 calls enqueued back "
             "to back, per call")


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


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host time of one call of ``fn``: ``calls`` calls enqueued back to
    back on the host's clock, before the closing synchronize (the launch
    path's own cost, where it exceeds the device's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def graph_ms(torch, fn, reps: int = 20, runs: int = 30) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph, the graph replayed ``runs`` times between CUDA events,
    each replay's time divided by ``reps`` (the host's launch time between
    back-to-back calls stays out of the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s_, e_ in zip(starts, ends):
        s_.record()
        graph.replay()
        e_.record()
    torch.cuda.synchronize()
    return statistics.median(s_.elapsed_time(e_) for s_, e_ in zip(starts, ends)) / reps


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
    """Phase 4: kernel and plain times at N=262144, D=512 beside the bound;
    the kernel by both methods (per-launch CUDA events, CUDA-graph replay)."""
    say("== phase 4: times at N=262144, D=512 (logistic): median of 30 per-launch CUDA-event "
        "readings; graph: median of 30 CUDA-graph replays of 20 launches")
    mem_rate, flop_rate = MEM_RATE, FP32_RATE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = (losses.logistic,) + make_inputs(torch, losses.logistic, N_FULL, D_FULL, dtype, SEED)
        kernel_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
        plain_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_parts_plain(*args))
        kernel_ms2 = time_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
        graph = graph_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
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
            "ms_runs": [kernel_ms, kernel_ms2], "graph_ms": graph,
            "share_of_bound_graph": bound_ms / graph,
        }
        say(f"  {name:8s} kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms (graph {graph:.4f} ms)   "
            f"plain two-pass {plain_ms:.4f} ms (context only)   bound {bound_ms:.4f} ms = {nbytes} B "
            f"/ {mem_rate / 1e12:.2f} TB/s ({CARD}; ops bound {ops_ms:.4f} ms)   share of bound "
            f"{bound_ms / ms:.3f} (graph {bound_ms / graph:.3f})")
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
    say(f"  kernel device time {launches} x {kernel_ms:.4f} ms (graph reading) = "
        f"{launches * kernel_ms / 1e3:.4f} s, "
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
    """Phase 6: glm_driver.main end to end on a generated LIBSVM pair; the
    native loader must parse every file."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io import libsvm
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem

    n_train, n_val, d, nnz = N_FULL, 8192, 511, 32
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
    libsvm.parse_counts.update(native_files=0, python_files=0)
    t0 = time.perf_counter()
    driver = glm_driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_glm.fused_value_grad_kernel.launches
    check(launches > 0, "glm_driver did not launch the fused kernel")
    check(libsvm.parse_counts == {"native_files": 2, "python_files": 0},
          f"LIBSVM files by parser {libsvm.parse_counts}: the native loader must read both")
    say(f"  LIBSVM files parsed natively: {libsvm.parse_counts['native_files']}, by the "
        f"Python parser: {libsvm.parse_counts['python_files']}; driver stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(driver.timer.totals.items())))
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


# --- GAME training: the sparse-slab GEVM and HVP kernels -------------------

# the sparse-race configuration (bench.py:2556-2627): E entities x M rows,
# D columns; 85% of rows carry 1-4 non-zeros, 15% carry 8-16
E_RE, M_RE, D_RE = 1024, 64, 2048
# the GAME driver's data (bench.py:2338-2350): users x 8-16 rows each,
# d_fixed=32, d_random=8, 15% of labels flipped
GAME_USERS, GAME_D_FIXED, GAME_D_RANDOM = 20000, 32, 8
GAME_AUC_FLOOR = 0.6
# kernel-vs-plain cases: (E, M, D, largest row nnz, every slot filled): the
# full width, a ragged M, K=1, an odd D, a wide D, the GAME driver's slab
# (one lane per user, up to 12 training rows, 8 features and the intercept,
# every row dense); besides, D=4096 with 10 lanes per block (w and v read
# through __ldg), lanes that straddle the packed blocks' edge (30 lanes per
# block, the last block holds 10), and lanes too large to stage (slab and
# row values in device memory, 32-bit slot positions)
SPARSE_CASES = ((E_RE, M_RE, D_RE, 16, False), (E_RE, 37, D_RE, 16, False),
                (E_RE, M_RE, D_RE, 1, False), (E_RE, M_RE, 65, 9, False),
                (256, M_RE, 4096, 16, False), (256, 12, 4096, 9, False),
                (1000, 7, 300, 5, False), (4, 40000, 64, 4, False),
                (GAME_USERS, 12, GAME_D_RANDOM + 1, GAME_D_RANDOM + 1, True))
# phase 8's shapes: the full width, and the GAME driver's slab
SPARSE_TIME_SHAPES = (("full width", E_RE, M_RE, D_RE, 16, False),
                      ("driver shape", GAME_USERS, 12, GAME_D_RANDOM + 1, GAME_D_RANDOM + 1, True))
SPARSE_TOL = 1e-5  # f32 and bf16 values alike: both sides compute in f32


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def skewed_stack(torch, e, m, d, max_nnz, gen, dev, full=False):
    """(E, M, D) dense stack; a row carries 1-4 non-zeros with probability
    0.85, else 8-max_nnz (1 when max_nnz is 1), at random columns; with
    ``full`` every row carries max_nnz."""
    small = torch.randint(1, 5, (e, m), device=dev, generator=gen)
    large = torch.randint(8, max(max_nnz, 8) + 1, (e, m), device=dev, generator=gen)
    nnz = torch.where(torch.rand((e, m), device=dev, generator=gen) < 0.85, small, large)
    nnz = torch.full_like(nnz, max_nnz) if full else torch.clamp(nnz, max=max_nnz)
    cols = torch.topk(torch.rand((e, m, d), device=dev, generator=gen), max_nnz, dim=-1).indices
    vals = torch.randn((e, m, max_nnz), device=dev, generator=gen)
    vals = torch.where(torch.arange(max_nnz, device=dev) < nnz[..., None], vals, torch.zeros_like(vals))
    return torch.zeros((e, m, d), device=dev).scatter_(-1, cols, vals)


def sparse_inputs(torch, fused_sparse, loss, e, m, d, max_nnz, seed, dev="cuda", full=False):
    """Slab and row vectors for one kernel check: labels fit for the loss,
    nonzero offsets and vshift, and 1 row in 13 with weight 0 and an offset
    that makes the loss overflow (the mask must zero it)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    slab = fused_sparse.build_sparse_slab(skewed_stack(torch, e, m, d, max_nnz, g, dev, full),
                                          kernel="pallas")
    if loss.name == "POISSON":
        y = torch.poisson(torch.full((e, m), 1.5, device=dev), generator=g)
    elif loss.name == "SQUARED":
        y = torch.randn((e, m), device=dev, generator=g)
    else:
        y = (torch.rand((e, m), device=dev, generator=g) < 0.5).float()
    wt = torch.rand((e, m), device=dev, generator=g) + 0.5
    off = 0.1 * torch.randn((e, m), device=dev, generator=g)
    wt.view(-1)[::13] = 0.0
    off.view(-1)[::13] = 1e4
    w = 0.1 * torch.randn((e, d), device=dev, generator=g)
    v = torch.randn((e, d), device=dev, generator=g)
    vshift = torch.randn((e,), device=dev, generator=g)
    return slab, y, wt, off, w, v, vshift


def hold_sparse(torch, fused_sparse, loss, slab, y, wt, off, w, v, vshift, label):
    """Both sparse kernels (through their wrappers) against the plain
    version on the same inputs: loss sums, gradient and HVP by relative
    error, sum d and sum c by error over |sum| + sum |.|, all within
    SPARSE_TOL; two runs bitwise equal; the kernels' sums bitwise
    tree_row_sum of their own row values. Returns max |kernel - plain| per
    kernel."""
    got = fused_sparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
    again = fused_sparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
    hvp = fused_sparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
    hvp_again = fused_sparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
    want = fused_sparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w)
    want_hvp = fused_sparse.fused_hvp_parts_plain(loss, slab, y, wt, off, w, v, vshift)
    sync(torch)
    check(all(torch.isfinite(t).all() for t in got + hvp), f"non-finite sparse kernel output {label}")
    z = slab.matvec(w) + off
    keep = wt > 0
    zero = torch.zeros_like(z)
    d_abs = torch.where(keep, wt * loss.d1(z, y), zero).abs().sum(-1)
    c_abs = (torch.where(keep, wt * loss.d2(z, y), zero)
             * (slab.matvec(v) + vshift[:, None])).abs().sum(-1)
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))
    over = lambda a, b, s: float(((a - b).abs() / (b.abs() + s).clamp_min(1e-30)).max())
    errs = {
        "loss": rel(got[0], want[0]), "grad": rel(got[1], want[1]),
        "sum-d": over(got[2], want[2], d_abs), "hvp": rel(hvp[0], want_hvp[0]),
        "sum-c": over(hvp[1], want_hvp[1], c_abs),
    }
    same = all(torch.equal(a, b) for a, b in zip(got + hvp, again + hvp_again))
    say(f"  {label} " + "  ".join(f"{k} {x:.2e}" for k, x in errs.items())
        + f"  bitwise repeat {same}")
    check(all(x <= SPARSE_TOL for x in errs.values()),
          f"sparse kernel disagrees with plain beyond {SPARSE_TOL}: {label}")
    check(same, f"two sparse kernel runs differ: {label}")
    check(kernel_sums_are_trees(torch, fused_sparse, loss, slab, y, wt, off, w, v, vshift),
          f"in-kernel row sums are not tree_row_sum of the kernel's row values: {label}")
    return {"gevm": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "hvp": max(float((a - b).abs().max()) for a, b in zip(hvp, want_hvp))}


def kernel_sums_are_trees(torch, fused_sparse, loss, slab, y, wt, off, w, v, vshift):
    """Both kernels once more, handed a buffer for their row values: each
    per-lane sum they return equals tree_row_sum of those values, bit for
    bit."""
    e, m = slab.idx.shape[:2]
    f32 = lambda t: t.float().contiguous()
    y, wt, off, w, v, vshift = (f32(t) for t in (y, wt, off, w, v, vshift))
    rows = torch.empty((2, e, m), device=w.device)
    sum_wl, _, sum_d = fused_sparse.sparse_gevm_kernel(loss, slab, y, wt, off, w, row_values=rows)
    c = torch.empty((1, e, m), device=w.device)
    _, sum_c = fused_sparse.sparse_hvp_kernel(loss, slab, y, wt, off, w, v, vshift, row_values=c)
    tree = fused_sparse.tree_row_sum
    return (torch.equal(sum_wl, tree(rows[0])) and torch.equal(sum_d, tree(rows[1]))
            and torch.equal(sum_c, tree(c[0])))


def phase_sparse_vs_plain(torch, fused_sparse, losses):
    """Phase 7: both sparse kernels against the plain version, every case,
    all four losses, f32 and bf16 values; all outputs held; two runs bitwise
    equal; the in-kernel row sums bitwise tree_row_sum."""
    say("== phase 7: sparse GEVM and HVP kernels against their plain version")
    max_abs = {"gevm": 0.0, "hvp": 0.0}
    cases = 0
    grid = [(c, dt) for c in SPARSE_CASES for dt in (torch.float32, torch.bfloat16)]
    for (e, m, d, kmax, full), dtype in grid:
        for loss in (losses.logistic, losses.squared, losses.poisson, losses.smoothed_hinge):
            slab, *rest = sparse_inputs(torch, fused_sparse, loss, e, m, d, kmax,
                                        SEED + e + m + d + kmax, full=full)
            slab = slab.astype(dtype)
            plan = fused_sparse.plan_launch(e, m, slab.max_nnz, d, slab.val.element_size(), False)
            label = (f"{str(dtype)[6:]:8s} E={e} M={m:2d} D={d:4d} K={slab.max_nnz:2d} "
                     f"L={plan.lanes_per_block:2d} "
                     f"{'full ' if full else ''}{loss.name:14s}")
            errs = hold_sparse(torch, fused_sparse, loss, slab, *rest, label)
            max_abs = {k: max(max_abs[k], errs[k]) for k in max_abs}
            cases += 1
    say(f"  {cases} cases within {SPARSE_TOL} (f32 and bf16 values; loss sums, gradient and "
        f"HVP by relative error, sum d and sum c by error over |sum| + sum |.|; L lanes per "
        f"block; in-kernel sums bitwise tree_row_sum of the kernel's row values); max |kernel - "
        f"plain| GEVM {max_abs['gevm']:.3e}, HVP {max_abs['hvp']:.3e}")
    return max_abs


def sparse_bytes(e, m, k, d):
    """Bytes each sparse function must move, each input read once and each
    output written once: the slab (idx, val f32), y/wt/off, w (and v,
    vshift), and the outputs (grad or hvp, and the per-lane sums)."""
    slab_b, rows_b, cols_b = 8 * e * m * k, 12 * e * m, 4 * e * d
    return {"gevm": slab_b + rows_b + cols_b + cols_b + 8 * e,
            "hvp": slab_b + rows_b + 2 * cols_b + 4 * e + cols_b + 4 * e}


def launches_of_one_call(torch, fn):
    """The device kernels and the aten operators of one call, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(torch)
    events = prof.events()
    kernels = [ev.name for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    ops = sorted({ev.name for ev in events if ev.name.startswith("aten::")})
    return kernels, ops


def phase_sparse_times(torch, fused_sparse, losses):
    """Phase 8: each sparse kernel's call (``fused_value_grad_parts``,
    ``fused_hvp_parts``) at the full-width shape and at the GAME driver's
    slab shape (logistic, f32), by both methods (per-launch CUDA events,
    CUDA-graph replay) and the host clock, twice each, beside its bound,
    its tables' bytes and the plain version's time (context only). One
    call's launches are counted by torch.profiler and by the wrappers'
    counts."""
    say("== phase 8: sparse kernel times (logistic, f32): median of 30 per-launch CUDA-event "
        "readings; graph: median of 30 CUDA-graph replays of 20 launches, per launch; host: "
        "host clock over 200 calls enqueued back to back, per call")
    loss = losses.logistic
    out = {}
    for label, e_, m_, d, kmax, full in SPARSE_TIME_SHAPES:
        slab, y, wt, off, w, v, vshift = sparse_inputs(torch, fused_sparse, loss, e_, m_, d, kmax,
                                                       SEED, full=full)
        e, m, k = slab.idx.shape
        tables = slab.kernel_tables()  # built once per slab, outside the timed calls
        nnz = int((slab.val != 0).sum())
        calls = {
            "gevm": lambda: fused_sparse.fused_value_grad_parts(loss, slab, y, wt, off, w),
            "hvp": lambda: fused_sparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift),
        }
        plain = {
            "gevm": lambda: fused_sparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w),
            "hvp": lambda: fused_sparse.fused_hvp_parts_plain(loss, slab, y, wt, off, w, v, vshift),
        }
        nbytes = sparse_bytes(e, m, k, d)
        # flops: 2 per slot per contraction (the margin loops over all K
        # slots), 2 per real slot for the transpose
        flops = {"gevm": 2 * e * m * k + 2 * nnz, "hvp": 4 * e * m * k + 2 * nnz}
        shape = f"E={e} M={m} K={k} D={d} nnz={nnz} f32"
        say(f"  {label}: {shape}; column tables {tables.nbytes} B")
        res = {}
        for name in ("gevm", "hvp"):
            plan = slab._kernel_launch(name).plan
            say(f"    {name}: {plan.blocks} blocks of {plan.lanes_per_block} lanes, "
                f"{plan.row_threads} threads a row, {plan.smem_bytes} B of shared memory each")
            counter = fused_sparse.sparse_gevm_kernel if name == "gevm" else fused_sparse.sparse_hvp_kernel
            before = counter.launches
            kernels, ops = launches_of_one_call(torch, calls[name])
            check(counter.launches == before + 1, f"{name}: one call did not count one launch")
            check(not any(op in ops for op in ("aten::add", "aten::constant_pad_nd", "aten::pad")),
                  f"{name}: one call ran row-sum operators {ops}")
            check(kernels, f"{name}: torch.profiler recorded no device kernel for one call "
                           "(CUPTI traced nothing), so the launch count cannot be shown")
            check(len(kernels) == 1, f"{name}: one call launched {len(kernels)} device kernels")
            say(f"    {name}: one call = {len(kernels)} device kernel(s) by torch.profiler "
                f"{sorted(set(kernels))}, launch count +1, aten ops {ops}")
            ev, gr, ho = [], [], []
            for _ in range(2):
                ev.append(time_ms(torch, calls[name]))
                gr.append(graph_ms(torch, calls[name]))
                ho.append(host_ms(torch, calls[name]))
            plain_ms = time_ms(torch, plain[name])
            bytes_ms, ops_ms = nbytes[name] / MEM_RATE * 1e3, flops[name] / FP32_RATE * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            ms, graph = statistics.median(ev), statistics.median(gr)
            r = {"ms": ms, "ms_runs": ev, "graph_ms": graph, "graph_ms_runs": gr,
                 "host_ms": statistics.median(ho),
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "bytes": nbytes[name], "flops": flops[name], "share_of_bound": bound_ms / ms,
                 "share_of_bound_graph": bound_ms / graph, "table_bytes": tables.nbytes,
                 "design_bytes_ms": (nbytes[name] + tables.nbytes) / MEM_RATE * 1e3,
                 "device_kernels_per_call": len(kernels), "shape": shape,
                 "plan": dataclasses.asdict(plan)}
            say(f"    {name}: call {' / '.join(f'{x:.5f}' for x in ev)} ms (graph "
                f"{' / '.join(f'{x:.5f}' for x in gr)} ms; host "
                f"{' / '.join(f'{x:.5f}' for x in ho)} ms)   plain {plain_ms:.4f} ms "
                f"(context only)   bound {bound_ms:.5f} ms = {nbytes[name]} B / "
                f"{MEM_RATE / 1e12:.2f} TB/s ({CARD}; ops bound {ops_ms:.5f} ms)   share of "
                f"bound {bound_ms / ms:.3f} (graph {bound_ms / graph:.3f})   design overhead: "
                f"column tables {tables.nbytes} B, with them {r['design_bytes_ms']:.5f} ms")
            res[name] = r
        out[label] = res
    return out


def re_dataset(torch, x, y):
    """A RandomEffectDataset over the (E, M, D) stack (IDENTITY projection,
    every row active), as build_random_effect_dataset lays it out."""
    from photon_ml_tpu_torch.data.game import RandomEffectDataset

    e, m, d = x.shape
    dev = x.device
    rows = torch.arange(e * m, device=dev, dtype=torch.int32)
    # the scoring tensors stay views of the stack: update() never reads them
    idx = torch.arange(d, device=dev, dtype=torch.int32).expand(e * m, d)
    return RandomEffectDataset(
        row_index=rows.reshape(e, m), x=x, labels=y, base_offsets=torch.zeros_like(y),
        weights=torch.ones_like(y),
        entity_pos=torch.arange(e, device=dev, dtype=torch.int32).repeat_interleave(m),
        feat_idx=idx, feat_val=x.reshape(e * m, d),
        local_to_global=torch.arange(d, device=dev, dtype=torch.int32).expand(e, d).contiguous(),
        num_entities=e, global_dim=d,
    )


def phase_re_solve(torch, fused_sparse, times, dev="cuda"):
    """Phase 9: RandomEffectCoordinate.update at full width with LBFGS and
    with TRON, spec pallas (the kernels) then scatter (plain), both on the
    card; per-lane final objectives within the solver tolerance."""
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig, summarize_stacked_results
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    say(f"== phase 9: RandomEffectCoordinate.update, E={E_RE} M={M_RE} D={D_RE} skewed nnz, "
        "logistic, L2 0.5: LBFGS (60 iterations, tol 1e-7) and TRON (defaults)")
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = skewed_stack(torch, E_RE, M_RE, D_RE, 16, g, dev)
    w_true = 0.4 * torch.randn((E_RE, D_RE), device=dev, generator=g)
    z = torch.matmul(x, w_true.unsqueeze(-1)).squeeze(-1)
    y = (torch.sigmoid(z) > torch.rand(z.shape, device=dev, generator=g)).float()
    ds = re_dataset(torch, x, y)
    resid = torch.zeros((E_RE * M_RE,), device=dev)
    configs = {"LBFGS": OptimizerConfig(max_iterations=60, tolerance=1e-7),
               "TRON": OptimizerConfig.tron_default()}
    counters = (fused_sparse.sparse_gevm_kernel, fused_sparse.sparse_hvp_kernel)
    out = {}
    for opt, cfg in configs.items():
        runs = {}
        for spec in ("pallas", "scatter"):
            coord = RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION, OptimizerType(opt),
                                           cfg, RegularizationContext.l2(0.5), sparse_kernel=spec)
            coord.slab.kernel_tables()  # built once per slab, outside the timed solve
            sync(torch)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            w, res = coord.update(resid, coord.initial_coefficients())
            sync(torch)
            wall = time.perf_counter() - t0
            launches = {"gevm": counters[0].launches, "hvp": counters[1].launches}
            check(bool(torch.isfinite(res.value).all()) and bool(torch.isfinite(w).all()),
                  f"{opt}/{spec}: non-finite solve")
            runs[spec] = (res, wall, launches)
            say(f"  {opt} {spec:7s}: wall {wall:.4f} s, launches GEVM {launches['gevm']} "
                f"HVP {launches['hvp']}; {summarize_stacked_results(res)}")
        (res_k, wall_k, launches_k), (res_p, wall_p, launches_p) = runs["pallas"], runs["scatter"]
        check(launches_p == {"gevm": 0, "hvp": 0}, f"{opt}: the scatter solve launched a kernel")
        check(launches_k["gevm"] > 0, f"{opt}: the pallas solve launched no GEVM kernel")
        if opt == "TRON":
            check(launches_k["hvp"] > 0, "TRON: the pallas solve launched no HVP kernel")
        diff = (res_k.value - res_p.value).abs()
        ok = diff <= 1e-2 * res_p.value.abs() + 2e-3
        check(bool(ok.all()), f"{opt}: {int((~ok).sum())} lanes' objectives off the plain solve")
        device_s = sum(launches_k[n] * times[n]["graph_ms"] / 1e3 for n in ("gevm", "hvp"))
        call_s = sum(launches_k[n] * times[n]["ms"] / 1e3 for n in ("gevm", "hvp"))
        say(f"  {opt}: per-lane objective |pallas - scatter| max {float(diff.max()):.3e} "
            f"(solver tolerance 1e-2 rel + 2e-3); kernel time x launches = {device_s:.4f} s "
            f"(graph readings), {device_s / wall_k:.3f} of the pallas solve's wall; "
            f"{call_s:.4f} s, {call_s / wall_k:.3f}, by per-launch event readings; "
            f"scatter/pallas wall {wall_p / wall_k:.2f}")
        out[opt] = {"launches": launches_k, "wall_s": wall_k, "plain_wall_s": wall_p,
                    "kernel_s": device_s, "share_of_wall": device_s / wall_k,
                    "kernel_call_s": call_s, "call_share_of_wall": call_s / wall_k}
    return out


def _avro_long(n: int) -> bytes:
    """Avro's zigzag varint of ``n``."""
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _avro_str(text: str) -> bytes:
    raw = text.encode()
    return _avro_long(len(raw)) + raw


def _write_avro(path, encoded, schema, block=4096):
    """The container avro.write_container writes (deflate, blocks of
    ``block`` records), from records already encoded, deflated at level 1
    (level 6 took most of the time)."""
    from photon_ml_tpu_torch.io import avro as avro_io

    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": b"deflate"}
    with open(path, "wb") as f:
        f.write(avro_io.MAGIC + _avro_long(len(meta)))
        for k, v in meta.items():
            f.write(_avro_str(k) + _avro_long(len(v)) + v)
        f.write(_avro_long(0) + avro_io.DEFAULT_SYNC)
        for i in range(0, len(encoded), block):
            chunk = encoded[i:i + block]
            payload = zlib.compress(b"".join(chunk), 1)[2:-4]  # raw deflate
            f.write(_avro_long(len(chunk)) + _avro_long(len(payload)) + payload
                    + avro_io.DEFAULT_SYNC)


def write_game_avro(workdir, num_users, seed, wide=None):
    """bench.py's GAME data as TrainingExampleAvro with two feature sections,
    each user's rows split 80/20 into train/ and validate/. ``wide=(names,
    per_row)`` widens the fixed section: each row carries ``per_row`` of
    ``names`` feature names instead of the dense d_fixed."""
    from photon_ml_tpu_torch.io import schemas

    rng = np.random.default_rng(seed)
    rows_per_user = rng.integers(8, 16, size=num_users)
    n = int(rows_per_user.sum())
    user = rng.permutation(np.repeat(np.arange(num_users), rows_per_user))
    d_fixed = GAME_D_FIXED if wide is None else wide[1]
    x_f = rng.normal(size=(n, d_fixed)).astype(np.float32)
    x_r = rng.normal(size=(n, GAME_D_RANDOM)).astype(np.float32)
    if wide is None:
        cols = np.broadcast_to(np.arange(GAME_D_FIXED), (n, GAME_D_FIXED))
        w_f = rng.normal(size=GAME_D_FIXED).astype(np.float32)
    else:
        # distinct names a row: a random start and stride, stride * per_row < names
        start = rng.integers(0, wide[0], size=n)[:, None]
        stride = rng.integers(1, wide[0] // wide[1], size=n)[:, None]
        cols = (start + stride * np.arange(wide[1])) % wide[0]
        w_f = rng.normal(size=wide[0]).astype(np.float32)
    w_u = (rng.normal(size=(num_users, GAME_D_RANDOM)) * 1.5).astype(np.float32)
    fixed_margin = x_f @ w_f if wide is None else np.sum(x_f * w_f[cols], axis=1)
    margin = fixed_margin + np.sum(x_r * w_u[user], axis=1)
    y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    flip = rng.random(n) < 0.15
    y[flip] = 1.0 - y[flip]
    rank = np.zeros(n, np.int64)
    order = np.argsort(user, kind="stable")
    rank[order] = np.arange(n) - np.searchsorted(user[order], user[order])
    validate = rank >= np.ceil(0.8 * rows_per_user[user])
    schema = {
        "name": "GameExampleAvro", "namespace": "smoke", "type": "record",
        "fields": [
            {"name": "uid", "type": ["null", "string"], "default": None},
            {"name": "label", "type": "double"},
            {"name": "fixedFeatures", "type": {"type": "array", "items": schemas.FEATURE}},
            {"name": "userFeatures", "type": {"type": "array",
                                              "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
            {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
             "default": None},
        ],
    }

    # each record encoded by hand, as avro.write_datum would encode it (the
    # generic encoder took a minute for phase 10's rows on the card's host)
    pack = struct.Struct("<d").pack
    fixed_keys = [_avro_str(f"f{j}") + b"\x00" for j in range(wide[0] if wide else d_fixed)]
    user_keys = [_avro_str(f"u{j}") + b"\x00" for j in range(GAME_D_RANDOM)]
    user_ids = _avro_str("userId")

    def features(keys, cols_r, x_r_):  # one block of named features, the empty term
        return (_avro_long(len(x_r_)) + b"".join(keys[c] + pack(v) for c, v in zip(cols_r, x_r_))
                + b"\x00")

    def records(sel):
        rows = np.nonzero(sel)[0]
        xf, xr, cf = x_f[rows].tolist(), x_r[rows].tolist(), cols[rows].tolist()
        return [b"\x02" + _avro_str(str(r)) + pack(float(y[r])) + features(fixed_keys, cf[i], xf[i])
                + features(user_keys, range(GAME_D_RANDOM), xr[i]) + b"\x02\x02" + user_ids
                + _avro_str(f"user{user[r]}") + b"\x00" for i, r in enumerate(rows)]

    for name, sel in (("train", ~validate), ("validate", validate)):
        _write_avro(os.path.join(workdir, name, "part-00000.avro"), records(sel), schema)
    return int((~validate).sum()), int(validate.sum())


# the README quickstart's GAME flags (without --checkpoint-dir) on the
# generated data
GAME_FLAGS = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--feature-shard-id-to-feature-section-keys-map", "global:fixedFeatures|per_user:userFeatures",
    "--updating-sequence", "fixed,per-user",
    "--fixed-effect-data-configurations", "fixed:global,1",
    "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
    "--fixed-effect-optimization-configurations", "fixed:50,1e-7,0.01,1,LBFGS,L2",
    "--random-effect-optimization-configurations", "per-user:40,1e-6,0.1,1,LBFGS,L2",
    "--evaluator-type", "AUC", "--num-iterations", "2",
]
GAME_SECTIONS = {"global": ["fixedFeatures"], "per_user": ["userFeatures"]}
# the GAME driver's preprocess stage before native ingest: 129.66 s (the
# pure-Python Avro row loop; NVIDIA H100 80GB HBM3, 700 W)
PREPROCESS_ROW_LOOP_S = 129.66


def run_game_training(torch, fused_sparse, argv, spec):
    """One training-driver run under PHOTON_SPARSE_KERNEL=``spec`` with the
    kernel and ingest counts set to 0 just before it: (driver, wall,
    launches, stages, ingest counts). Fails unless the native decoder read
    every file."""
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.io import avro_data

    os.environ["PHOTON_SPARSE_KERNEL"] = spec
    sync(torch)
    for c in (fused_sparse.sparse_gevm_kernel, fused_sparse.sparse_hvp_kernel):
        c.launches = 0
    avro_data.ingest_counts.update(native_files=0, row_loop_files=0, rejected_files=0)
    t0 = time.perf_counter()
    try:
        driver = game_training_driver.main(argv)
    finally:
        del os.environ["PHOTON_SPARSE_KERNEL"]
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {"gevm": fused_sparse.sparse_gevm_kernel.launches,
                "hvp": fused_sparse.sparse_hvp_kernel.launches}
    counts = dict(avro_data.ingest_counts)
    check(counts["row_loop_files"] == 0 and counts["rejected_files"] == 0
          and counts["native_files"] > 0,
          f"spec {spec}: Avro files by path {counts}: the native decoder must read every file")
    _, result, _ = driver.results[0]
    tot = driver.timer.totals
    stages = {"preprocess": tot["prepare-feature-maps"] + tot["prepare-datasets"],
              "train": tot["train"] - result.timings["(validation)"],
              "validate": result.timings["(validation)"], "save": tot["save"]}
    return driver, wall, launches, stages, counts


def phase_game_driver(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 10: cli.game_training_driver.main end to end (the README
    quickstart's flags without --checkpoint-dir) with
    PHOTON_SPARSE_KERNEL=pallas, then off; every Avro file read by the
    native decoder; model layout, validation AUC and objective histories
    checked. Returns the run's numbers and the pallas run's driver."""

    say(f"== phase 10: game_training_driver.main, bench.py's GAME data, {GAME_USERS} users "
        f"(8-16 rows each, d_fixed={GAME_D_FIXED}, d_random={GAME_D_RANDOM}, 15% labels "
        "flipped), fixed + per-user LBFGS, 2 iterations")
    t0 = time.perf_counter()
    n_train, n_val = write_game_avro(workdir, GAME_USERS, SEED)
    say(f"  Avro written in {time.perf_counter() - t0:.1f} s: {n_train} train rows, "
        f"{n_val} validation rows")
    runs = {}
    drivers = {}
    for spec in ("pallas", "off"):
        out = os.path.join(workdir, f"out-{spec}")
        argv = ["--train-input-dirs", os.path.join(workdir, "train"),
                "--validate-input-dirs", os.path.join(workdir, "validate"),
                "--output-dir", out, "--device", dev] + GAME_FLAGS
        driver, wall, launches, stages, counts = run_game_training(torch, fused_sparse, argv, spec)
        drivers[spec] = driver
        _, result, metrics = driver.results[0]
        check(driver.device.type == dev, f"GAME driver ran off {dev}")
        layout = {k: sorted(os.listdir(os.path.join(out, "best", k)))
                  for k in ("fixed-effect", "random-effect")}
        check(layout == {"fixed-effect": ["fixed"], "random-effect": ["per-user"]},
              f"model layout {layout}")
        for kind, name in (("fixed-effect", "fixed"), ("random-effect", "per-user")):
            parts = os.listdir(os.path.join(out, "best", kind, name, "coefficients"))
            check(parts == ["part-00000.avro"], f"{kind}/{name} coefficients {parts}")
        check(all(np.isfinite(result.objective_history)), "non-finite objective")
        check(metrics["AUC"] > GAME_AUC_FLOOR, f"validation AUC {metrics['AUC']} <= {GAME_AUC_FLOOR}")
        slab = driver.combo_coords[0]["per-user"].slab
        tot = driver.timer.totals
        say("  preprocess by span: " + ", ".join(f"{k} {tot[k]:.2f} s" for k in (
            "prepare-feature-maps", "read-train-data", "read-validation-data",
            "build-fixed-effect-batches", "build-random-effect-datasets")))
        say(f"  spec {spec:6s}: validation AUC {metrics['AUC']:.6f}; objective history "
            + " ".join(f"{v:.6f}" for v in result.objective_history)
            + f"; GEVM launches {launches['gevm']}, HVP {launches['hvp']}; entities "
            f"{driver.re_datasets['per-user'].num_entities}, slab "
            f"{None if slab is None else tuple(slab.idx.shape)}"
            + ("" if slab is None else f" (column tables {slab.kernel_tables().nbytes} B)")
            + f"; wall {wall:.2f} s; stages "
            + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + f" (preprocess {PREPROCESS_ROW_LOOP_S} s through the Python row loop before "
            f"native ingest); Avro files read natively {counts['native_files']}, by the row "
            f"loop {counts['row_loop_files']}")
        runs[spec] = (result, launches, stages, wall, metrics["AUC"])
        if spec == "pallas":
            held = hold_driver_slab(torch, fused_sparse, driver.combo_coords[0]["per-user"])
    (res_k, launches_k, *_), (res_p, launches_p, *_) = runs["pallas"], runs["off"]
    check(launches_k["gevm"] > 0, "the pallas driver run launched no GEVM kernel")
    check(launches_p == {"gevm": 0, "hvp": 0}, "the off driver run launched a sparse kernel")
    for a, b in zip(res_k.objective_history, res_p.objective_history):
        check(abs(a - b) <= 1e-2 * abs(b) + 2e-3, f"objective histories differ: {a} vs {b}")
    say("  objective histories of the pallas and off runs agree within the solver tolerance")
    out = {spec: {"launches": r[1], "stages_s": r[2], "wall_s": r[3], "auc": r[4]}
           for spec, r in runs.items()}
    out["max_abs_err"] = held
    return out, drivers["pallas"]


def phase_ingest(workdir, trained):
    """Phase 11: read_game_data on the validation rows natively and through
    the Python row loop (PHOTON_ML_TPU_NATIVE=0), every array byte-equal."""
    from photon_ml_tpu_torch.io import avro_data

    val_dir = os.path.join(workdir, "validate")
    say("== phase 11: read_game_data on the validation dir, native decoder against the "
        "Python row loop")
    args = ([val_dir], trained.shard_index_maps, GAME_SECTIONS, ["userId"])
    reads = {}
    for path, env in (("native", "1"), ("row loop", "0")):
        os.environ["PHOTON_ML_TPU_NATIVE"] = env
        avro_data.ingest_counts.update(native_files=0, row_loop_files=0, rejected_files=0)
        try:
            t0 = time.perf_counter()
            data = avro_data.read_game_data(*args)
            secs = time.perf_counter() - t0
        finally:
            del os.environ["PHOTON_ML_TPU_NATIVE"]
        counts = dict(avro_data.ingest_counts)
        want = {"native": "native_files", "row loop": "row_loop_files"}[path]
        check(counts[want] == 1 and sum(counts.values()) == 1, f"{path} read went {counts}")
        reads[path] = (data, secs)
        say(f"  {path:8s}: {data.num_rows} rows in {secs:.3f} s, "
            f"{data.num_rows / secs:.0f} rows/s")
    (a, ta), (b, tb) = reads["native"], reads["row loop"]
    arrays = [(f, getattr(a, f), getattr(b, f)) for f in ("response", "offset", "weight")]
    arrays += [(f"ids[{t}]", a.ids[t], b.ids[t]) for t in a.ids]
    arrays += [(f"{s_}.{f}", getattr(a.shards[s_], f), getattr(b.shards[s_], f))
               for s_ in a.shards for f in ("indptr", "indices", "values")]
    for name, x, y in arrays:
        check(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(),
              f"ingest: {name} differs between the native and the row-loop read")
    check(a.id_vocabs == b.id_vocabs, "ingest: entity vocabularies differ")
    say(f"  {len(arrays)} arrays byte-equal; native {tb / ta:.1f}x the row loop's rate")
    # where a native read's host time goes (cProfile adds per-call cost to
    # the Python parts, so the shares lean toward them)
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(avro_data.read_game_data, *args)
    stats = pstats.Stats(prof)
    total = stats.total_tt
    name = lambda k: f"{os.path.basename(k[0])}:{k[2]}"
    cum = sorted(((v[3], name(k)) for k, v in stats.stats.items()
                  if "photon_ml_tpu_torch" in k[0]), reverse=True)[:8]
    own = sorted(((v[2], name(k)) for k, v in stats.stats.items()), reverse=True)[:8]
    say(f"  cProfile of one native read, {total:.3f} s in all; cumulative s by function: "
        + ", ".join(f"{n} {secs:.3f}" for secs, n in cum)
        + "; own s by function: " + ", ".join(f"{n} {secs:.3f}" for secs, n in own))
    return {"rows": a.num_rows, "native_s": ta, "row_loop_s": tb}


def score_bytes(*tensors):
    """Bytes a function must move: each given tensor (inputs read once, the
    output written once) in its own dtype."""
    return sum(t.numel() * t.element_size() for t in tensors)


def run_scoring(torch, argv):
    """One scoring-driver run, the ingest counts set to 0 just before it;
    fails unless the native decoder read every file."""
    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.io import avro_data

    avro_data.ingest_counts.update(native_files=0, row_loop_files=0, rejected_files=0)
    sync(torch)
    t0 = time.perf_counter()
    driver = game_scoring_driver.main(argv)
    sync(torch)
    wall = time.perf_counter() - t0
    counts = dict(avro_data.ingest_counts)
    check(counts["row_loop_files"] == 0 and counts["rejected_files"] == 0,
          f"scoring read Avro files through the row loop: {counts}")
    check(bool(np.isfinite(driver.scores).all()), "non-finite scores")
    return driver, wall


def phase_scoring(torch, workdir, trained, dev="cuda"):
    """Phase 12: cli.game_scoring_driver.main on phase 10's pallas model:
    the validation rows on the card and with --host-scoring, the training
    rows on the card; the scoring gather and the fixed-effect matvec timed
    against their bytes bound; rows without a model score exactly 0."""
    from photon_ml_tpu_torch.cli import game_scoring_driver as gsd
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.models.game import gather_scores

    model = os.path.join(trained.params.output_dir, "best")
    train_auc = trained.results[0][2]["AUC"]
    say(f"== phase 12: game_scoring_driver.main on phase 10's pallas model ({model})")
    common = ["--game-model-input-dir", model, "--evaluator-type", "AUC", "--device", dev,
              "--feature-shard-id-to-feature-section-keys-map",
              "global:fixedFeatures|per_user:userFeatures"]
    runs = {}
    for label, data_dir, files, extra in (
            ("validate, card", "validate", 1, []),
            ("validate, host", "validate", 1, ["--host-scoring", "true"]),
            ("train, card", "train", 4, [])):
        out = os.path.join(workdir, "scores-" + label.replace(", ", "-"))
        driver, wall = run_scoring(torch, ["--input-dirs", os.path.join(workdir, data_dir),
                                           "--output-dir", out,
                                           "--num-output-files-for-scores", str(files)]
                                   + extra + common)
        parts = sorted(os.listdir(os.path.join(out, "scores")))
        check(parts == [f"part-{i:05d}.avro" for i in range(files)], f"{label}: parts {parts}")
        rows = sum(1 for p_ in parts for _ in avro_io.read_container(
            os.path.join(out, "scores", p_)))
        check(rows == driver.data.num_rows == len(driver.scores), f"{label}: {rows} score rows")
        stages = driver.timer.totals
        say(f"  {label}: {rows} rows in {len(parts)} part files, AUC {driver.metrics['AUC']:.6f}; "
            f"wall {wall:.2f} s; stages " + ", ".join(
                f"{k} {stages[k]:.2f} s" for k in ("prepare-feature-maps", "read-data",
                                                   "load-model", "score", "save", "evaluate")
                if k in stages))
        runs[label] = (driver, wall)
    card, host = runs["validate, card"][0], runs["validate, host"][0]
    diff = np.abs(card.scores.astype(np.float64) - host.scores)
    ok = diff <= 1e-5 + 1e-4 * np.abs(host.scores)
    check(bool(ok.all()), f"card and host scores differ beyond the elementwise tolerance "
                          f"(max {diff.max():.3e})")
    for label in ("validate, card", "validate, host"):
        auc = runs[label][0].metrics["AUC"]
        check(abs(auc - train_auc) <= 1e-6,
              f"{label}: scoring AUC {auc} != the training driver's validation AUC {train_auc}")
    say(f"  card against host scores: max |diff| {diff.max():.3e} (elementwise tolerance "
        f"rtol 1e-4, atol 1e-5); scoring AUC = training validation AUC {train_auc:.6f} "
        "within 1e-6")

    # the device path's two functions on the training rows' own inputs
    driver = runs["train, card"][0]
    data = driver.data
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    means = model_io.load_fixed_effect(model, "fixed", driver.shard_index_maps["global"])[0]
    entity_means = model_io.load_random_effect(model, "per-user",
                                               driver.shard_index_maps["per_user"])[0]
    fidx, fvals = gsd.padded_coo(data.shards["global"], dev)
    ridx, rvals = gsd.padded_coo(data.shards["per_user"], dev)
    slab, ent_pos, matched = gsd.entity_positions(data.id_vocabs["userId"], entity_means,
                                                  data.ids["userId"],
                                                  data.shards["per_user"].dim)
    slab, ent_pos, w = put(slab), put(ent_pos), put(means)
    out = gather_scores(slab, ent_pos, ridx, rvals)
    cold = ent_pos.clone()
    cold[::7] = -1
    out_cold = gather_scores(slab, cold, ridx, rvals)
    sync(torch)
    check(bool((out_cold[::7] == 0).all()), "rows without a model did not score exactly 0")
    keep = torch.ones_like(out, dtype=torch.bool)
    keep[::7] = False
    check(torch.equal(out_cold[keep], out[keep]), "the other rows' scores moved")
    fout = gsd.fixed_contrib(w, fidx, fvals)
    timings = {}
    for name, fn, tensors, shape in (
            ("re_gather", lambda: gather_scores(slab, ent_pos, ridx, rvals),
             (slab, ent_pos, ridx, rvals, out),
             f"N={data.num_rows} K={ridx.shape[1]} E={slab.shape[0]} D={slab.shape[1]}"),
            ("fixed_matvec", lambda: gsd.fixed_contrib(w, fidx, fvals),
             (w, fidx, fvals, fout), f"N={data.num_rows} K={fidx.shape[1]} D={w.shape[0]}")):
        nbytes = score_bytes(*tensors)
        t = {"ms": time_ms(torch, fn), "graph_ms": graph_ms(torch, fn), "bytes": nbytes,
             "bound_ms": nbytes / MEM_RATE * 1e3, "bound_by": "bytes", "shape": shape}
        timings[name] = t
        say(f"  {name}: {shape}: events {t['ms']:.4f} ms, graph {t['graph_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.5f} ms ({nbytes} B), share by graph "
            f"{t['bound_ms'] / t['graph_ms']:.3f}")
    say(f"  {matched} of {len(data.id_vocabs['userId'])} entities matched; every 7th row "
        "given no model scores exactly 0 and no other row moved")
    say(json.dumps({"scoring": {
        "walls_s": {k: v[1] for k, v in runs.items()},
        "stages_s": {k: v[0].timer.totals for k, v in runs.items()},
        "functions": timings}}))
    return timings


def phase_offheap(torch, fused_sparse, workdir, trained, dev="cuda"):
    """Phase 13: feature_indexing --format OFFHEAP --partition-num 8 on the
    training rows, then the training driver (spec pallas) and the scoring
    driver with --offheap-indexmap-dir."""
    from photon_ml_tpu_torch.cli import feature_indexing
    from photon_ml_tpu_torch.io.offheap import OffHeapIndexMap

    say("== phase 13: feature_indexing (OFFHEAP, 8 partitions), then training (spec pallas) "
        "and scoring with --offheap-indexmap-dir")
    idx = os.path.join(workdir, "index-maps")
    t0 = time.perf_counter()
    written = feature_indexing.main([
        "--data-input-dirs", os.path.join(workdir, "train"), "--output-dir", idx,
        "--partition-num", "8", "--format", "OFFHEAP",
        "--feature-shard-id-to-feature-section-keys-map",
        "global:fixedFeatures|per_user:userFeatures"])
    say(f"  index maps {[os.path.relpath(p_, workdir) for p_ in written]} in "
        f"{time.perf_counter() - t0:.2f} s")
    argv = ["--train-input-dirs", os.path.join(workdir, "train"),
            "--validate-input-dirs", os.path.join(workdir, "validate"),
            "--output-dir", os.path.join(workdir, "out-offheap"), "--device", dev,
            "--offheap-indexmap-dir", idx] + GAME_FLAGS
    driver, wall, launches, stages, _ = run_game_training(torch, fused_sparse, argv, "pallas")
    check(all(isinstance(m, OffHeapIndexMap) for m in driver.shard_index_maps.values()),
          "the driver did not train on the off-heap maps")
    check(launches["gevm"] > 0, "the off-heap training run launched no GEVM kernel")
    hist = driver.results[0][1].objective_history
    want = trained.results[0][1].objective_history
    for a, b in zip(hist, want):
        check(abs(a - b) <= 1e-2 * abs(b) + 2e-3, f"off-heap objective history {a} vs {b}")
    auc = driver.results[0][2]["AUC"]
    say(f"  training: objective history " + " ".join(f"{v:.6f}" for v in hist)
        + f" (phase 10 pallas: " + " ".join(f"{v:.6f}" for v in want) + "), within the solver "
        f"tolerance; validation AUC {auc:.6f}; GEVM launches {launches['gevm']}; wall "
        f"{wall:.2f} s; stages " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()))
    scorer, swall = run_scoring(torch, [
        "--input-dirs", os.path.join(workdir, "validate"),
        "--game-model-input-dir", os.path.join(workdir, "out-offheap", "best"),
        "--output-dir", os.path.join(workdir, "scores-offheap"), "--offheap-indexmap-dir", idx,
        "--evaluator-type", "AUC", "--device", dev,
        "--feature-shard-id-to-feature-section-keys-map",
        "global:fixedFeatures|per_user:userFeatures"])
    check(abs(scorer.metrics["AUC"] - auc) <= 1e-6,
          f"off-heap scoring AUC {scorer.metrics['AUC']} != training validation AUC {auc}")
    say(f"  scoring: AUC {scorer.metrics['AUC']:.6f} (= the training run's within 1e-6); wall "
        f"{swall:.2f} s")
    return launches


def phase_random_projection(torch, trained, dev="cuda"):
    """Phase 14: one random-effect update with LBFGS on phase 10's per-user
    data under a RANDOM=4 projection, on the card and on the CPU; per-lane
    objectives held at the solver tolerance."""
    from photon_ml_tpu_torch.algorithm.random_effect import (
        RandomEffectCoordinate,
        global_coefficients,
    )
    from photon_ml_tpu_torch.cli.game_params import CoordinateOptConfig
    from photon_ml_tpu_torch.data.game import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.types import TaskType

    cfg = CoordinateOptConfig.parse("40,1e-6,0.1,1,LBFGS,L2")
    data = trained.train_data
    say(f"== phase 14: RANDOM=4 projection: RandomEffectCoordinate.update (LBFGS) on phase "
        f"10's per-user data ({data.num_rows} rows), card against CPU")
    resid = np.random.default_rng(SEED + 3).normal(scale=0.5, size=data.num_rows)
    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        ds = build_random_effect_dataset(
            data, RandomEffectDataConfig("userId", "per_user", projector="RANDOM",
                                         random_projection_dim=4), device=device)
        coord = RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION, cfg.optimizer,
                                       cfg.optimizer_config(), cfg.regularization_context(),
                                       sparse_kernel="pallas")
        check(coord.slab is None, "a RANDOM dataset built a slab")
        build_s = time.perf_counter() - t0
        sync(torch)
        t0 = time.perf_counter()
        w, res = coord.update(torch.from_numpy(resid.astype(np.float32)).to(device),
                              coord.initial_coefficients())
        wg = global_coefficients(ds, w)
        sync(torch)
        out[where] = (w.cpu().numpy(), res.value.cpu().numpy(), wg.cpu().numpy(),
                    time.perf_counter() - t0, build_s, tuple(ds.x.shape))
    (wc, vc, gc, tc, bc, shape), (wp, vp, gp, tp, bp, _) = out["card"], out["cpu"]
    check(np.isfinite(wc).all() and np.isfinite(gc).all(), "RANDOM: non-finite coefficients")
    # as phase 9: per-lane final objectives at the solver tolerance (a lane
    # stops once its objective settles, so its coefficients agree only to
    # the stopping test's noise, reported below)
    bad = np.abs(vc - vp) > 2e-3 + 1e-2 * np.abs(vp)
    check(not bad.any(), f"RANDOM: {int(bad.sum())} lanes' objectives off the CPU update")
    coef_off = np.abs(wc - wp) > 2e-3 + 1e-2 * np.abs(wp)
    lanes_off = int(coef_off.any(axis=1).sum())
    say(f"  stack {shape}; per-lane objectives card against CPU: max |diff| "
        f"{np.abs(vc - vp).max():.3e} (solver tolerance rtol 1e-2, atol 2e-3); coefficients: "
        f"max |diff| {np.abs(wc - wp).max():.3e}, {lanes_off} of {len(wc)} lanes beyond the "
        f"solver tolerance (objective diff there at most "
        f"{(np.abs(vc - vp)[coef_off.any(axis=1)].max() if lanes_off else 0.0):.3e}); "
        f"back-projected (E, D) max |diff| {np.abs(gc - gp).max():.3e}; update wall card "
        f"{tc:.3f} s, CPU {tp:.3f} s; dataset build card {bc:.2f} s, CPU {bp:.2f} s")

def hold_driver_slab(torch, fused_sparse, coord):
    """Both sparse kernels on the driver's own per-user slab and row vectors
    (labels, weights, base offsets plus a random residual gathered as the
    coordinate gathers it), at random coefficients, against the plain
    version (logistic, the driver's task)."""
    from photon_ml_tpu_torch.ops import losses

    ds, slab = coord.dataset, coord.slab
    e, d = ds.num_entities, ds.local_dim
    dev = slab.idx.device
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    resid = torch.randn((int(ds.row_index.max()) + 1,), device=dev, generator=g)
    w = 0.3 * torch.randn((e, d), device=dev, generator=g)
    v = torch.randn((e, d), device=dev, generator=g)
    vshift = torch.randn((e,), device=dev, generator=g)
    label = (f"the driver's slab: E={e} M={slab.idx.shape[1]} D={d} K={slab.max_nnz} "
             f"LOGISTIC")
    return hold_sparse(torch, fused_sparse, losses.logistic, slab, ds.labels, ds.weights,
                       coord.gathered_offsets(resid), w, v, vshift, label)


# --- sparse fixed effects, determinism, checkpoints -------------------------

# the repo's sparse-wide configuration (bench.py:59): N rows, D features,
# NNZ non-zeros per row
SPARSE_N, SPARSE_D, SPARSE_NNZ = 131072, 1 << 20, 64
# one lambda, solved by TRON so the card and CPU solutions can be held
# coefficient by coefficient: in f32 LBFGS stops when the objective's change
# rounds to nothing, which pins the objective, not every coefficient (the
# first run of this phase with LBFGS on an NVIDIA H100 put 1 of 1048577
# coefficients 0.00337 from the CPU run's, the objectives 3.7e-7 apart;
# PERF.md), while TRON's stop follows the gradient
SPARSE_GLM_FLAGS = ["--task", "LOGISTIC_REGRESSION", "--input-file-format", "LIBSVM",
                    "--feature-dimension", str(SPARSE_D), "--regularization-weights", "1",
                    "--optimizer", "TRON", "--regularization-type", "L2",
                    "--num-iterations", "100", "--convergence-tolerance", "1e-7"]
# phase 16's fixed section: FIXED_WIDE_PER_ROW of FIXED_WIDE_NAMES names a
# row, over phase 10's GAME_USERS users
FIXED_WIDE_NAMES, FIXED_WIDE_PER_ROW = 1 << 17, 32
# the quickstart's fixed effect (LBFGS, L2 lambda 0.01) with its iteration
# cap raised from 50 until the card and the CPU both converge: 131073
# columns at lambda 0.01 are nearly separable, and after 50 iterations the
# two trajectories had not converged and stood 3% apart (PERF.md)
FIXED_WIDE_ITERS = 1000
WIDE_GAME_FLAGS = [f if f != "fixed:50,1e-7,0.01,1,LBFGS,L2"
                   else f"fixed:{FIXED_WIDE_ITERS},1e-7,0.01,1,LBFGS,L2" for f in GAME_FLAGS]
# the transpose layouts are also timed at these widths, N=SPARSE_N, the
# rule's measurement below the 2^20 of bench.py:59
LAYOUT_WIDTHS = (4097, 1 << 13, 1 << 15)
SOLVER_RTOL, SOLVER_ATOL = 1e-2, 2e-3  # tests/tolerances.py, f32 "solver"


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def held(name, got, want):
    """Fail unless ``got`` is within the solver tolerance of ``want``;
    returns the largest absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{name}: shapes {got.shape} vs {want.shape}")
    bad = np.abs(got - want) > SOLVER_ATOL + SOLVER_RTOL * np.abs(want)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    check(not bad.any(), f"{name}: {int(bad.sum())} of {got.size} values outside the solver "
                         f"tolerance (max |diff| {err:.3g})")
    return err


def timed_pair(torch, fn):
    """(events ms, graph ms) of ``fn``, as every kernel is timed."""
    return time_ms(torch, fn), graph_ms(torch, fn)


def transposes_agree(torch, label, a, b, abs_sum):
    """Fail unless two sums of the same terms in different orders agree
    within 1e-5 of each output's sum of absolute terms (``abs_sum``): f32
    reordering error grows with that sum, not with the result, and the
    intercept column sums every row."""
    err = (a - b).abs()
    worst = float((err / (abs_sum + 1e-30)).max())
    check(bool((err <= 1e-5 * abs_sum).all()), f"{label}: the sums differ by up to {worst:.3g} "
                                                "of their absolute terms")
    return float(err.max()), worst


def transpose_times(torch, label, fn, abs_sum, nbytes):
    """``fn`` timed with deterministic algorithms off, on, on, off (in that
    order, one card): the two modes' results agree (``transposes_agree``)
    and the deterministic one repeats bit for bit."""
    out = {}
    results = {}
    for mode in (False, True, True, False):
        torch.use_deterministic_algorithms(mode)
        results.setdefault(mode, []).append(fn())
        out.setdefault(mode, []).append(timed_pair(torch, fn))
    torch.use_deterministic_algorithms(True)
    a, b = results[True]
    check(torch.equal(a, b), f"{label}: the deterministic transpose differs between calls")
    err, rel = transposes_agree(torch, f"{label}, atomics against deterministic",
                                results[False][0], a, abs_sum)
    bound = nbytes / MEM_RATE * 1e3
    rows = {}
    for mode, name in ((False, "atomics"), (True, "deterministic")):
        ev = statistics.median(t[0] for t in out[mode])
        gr = statistics.median(t[1] for t in out[mode])
        rows[name] = {"ms": ev, "graph_ms": gr, "ms_runs": [t[0] for t in out[mode]],
                      "graph_ms_runs": [t[1] for t in out[mode]]}
        say(f"    {label}, {name}: {ev:.5f} ms by events, {gr:.5f} ms by graph "
            f"(runs {' / '.join(f'{t[0]:.5f}|{t[1]:.5f}' for t in out[mode])}); bound "
            f"{bound:.5f} ms = {nbytes} B / {MEM_RATE / 1e12:.2f} TB/s, share by graph "
            f"{bound / gr:.3f}")
    return {"bound_ms": bound, "bytes": nbytes, "max_abs_err": err,
            "max_err_of_abs_terms": rel, **rows}


def layout_times(torch, dev, n, k, widths, g):
    """The transpose-layout rule's measurement below the full width: for each
    width in ``widths``, an f32 batch of ``n`` rows of ``k`` uniform random
    columns; the scatter layout's rmatvec (a deterministic index_add_) and
    the sorted view's (a segment sum) by events and by graph, the build of
    the view (one stable sort on the card) on the host's clock, and the
    calls after which the view has paid for its build."""
    from photon_ml_tpu_torch.ops.features import SparseFeatures

    dvec = torch.randn((n,), device=dev, generator=g)
    out = {}
    for d in widths:
        idx = torch.randint(0, d, (n, k), device=dev, generator=g, dtype=torch.int32)
        scatter = SparseFeatures(idx, torch.randn((n, k), device=dev, generator=g), d)
        sync(torch)
        t0 = time.perf_counter()
        sorted_ = scatter.with_transpose()
        sync(torch)
        build_ms = (time.perf_counter() - t0) * 1e3
        abs_sum = SparseFeatures(idx, scatter.values.abs(), d).rmatvec(dvec.abs())
        transposes_agree(torch, f"the two transpose layouts at D={d}", scatter.rmatvec(dvec),
                         sorted_.rmatvec(dvec), abs_sum)
        bound = (8 * n * k + 4 * n + 4 * d) / MEM_RATE * 1e3
        row = {"build_ms": build_ms, "bound_ms": bound}
        for label, fn in (("scatter", lambda: scatter.rmatvec(dvec)),
                          ("sorted", lambda: sorted_.rmatvec(dvec))):
            row[label] = dict(zip(("ms", "graph_ms"), timed_pair(torch, fn)))
        gain = row["scatter"]["graph_ms"] - row["sorted"]["graph_ms"]
        row["break_even_calls"] = build_ms / gain if gain > 0 else None
        out[str(d)] = row
        say(f"    layout rule at D={d} (N={n} K={k}): rmatvec scatter "
            f"{row['scatter']['ms']:.5f} ms by events, {row['scatter']['graph_ms']:.5f} by graph; "
            f"sorted {row['sorted']['ms']:.5f} / {row['sorted']['graph_ms']:.5f} ms; bound "
            f"{bound:.5f} ms; view built in {build_ms:.1f} ms (host clock), paid back after "
            + (f"{row['break_even_calls']:.1f} calls" if gain > 0 else "no number of calls"))
    return out


def run_glm(torch, argv):
    """One GLM-driver run, the parse counts set to 0 just before it; fails
    unless the native loader read the file."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io import libsvm

    libsvm.parse_counts.update(native_files=0, python_files=0)
    sync(torch)
    t0 = time.perf_counter()
    driver = glm_driver.main(argv)
    sync(torch)
    wall = time.perf_counter() - t0
    check(libsvm.parse_counts == {"native_files": 1, "python_files": 0},
          f"LIBSVM files by parser {libsvm.parse_counts}: the native loader must read it")
    return driver, wall


def phase_sparse_glm(torch, fused_sparse, losses, workdir, dev="cuda"):
    """Phase 15: cli.glm_driver.main on bench.py's sparse-wide configuration
    (D > 4096: padded-COO SparseFeatures) twice on ``dev`` and once on the
    CPU; model bytes equal between the card runs, coefficients and
    objectives held card against CPU; matvec and both transpose layouts
    timed against their bytes bound; the plain slab transpose and the wide
    transpose timed with deterministic algorithms off and on."""
    from photon_ml_tpu_torch.ops.features import SparseFeatures

    say(f"== phase 15: glm_driver.main on LIBSVM N={SPARSE_N} x D={SPARSE_D} (+ intercept), "
        f"{SPARSE_NNZ} non-zeros per row (bench.py:59), TRON, L2 lambda 1, no normalization; "
        f"twice on {dev}, once on the CPU")
    rng = np.random.default_rng(SEED + 15)
    w_true = (rng.normal(size=SPARSE_D) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "train"))
    _write_libsvm(os.path.join(workdir, "train", "part-00000.txt"), SPARSE_N, SPARSE_D,
                  SPARSE_NNZ, w_true, rng)
    say(f"  data written in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for label, device in (("card", dev), ("card again", dev), ("cpu", "cpu")):
        out = os.path.join(workdir, label.replace(" ", "-"))
        argv = ["--training-data-directory", os.path.join(workdir, "train"),
                "--output-directory", out, "--device", device] + SPARSE_GLM_FLAGS
        driver, wall = run_glm(torch, argv)
        feats = driver.train_batch.features
        check(isinstance(feats, SparseFeatures), f"{label}: the batch is not sparse")
        res = driver.trained.results[0]
        runs[label] = (driver, out)
        say(f"  {label}: wall {wall:.2f} s; stages "
            + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(driver.timer.totals.items()))
            + f"; batch {tuple(feats.indices.shape)} of width {feats.dim}, transpose layout "
            f"{'sorted' if feats.t_idx is not None else 'scatter'}; {int(res.iterations)} "
            f"iterations, stop reason {int(res.reason)}, objective {float(res.value):.6f}")
    (card, card_out), (again, again_out), (cpu, _) = (runs[k] for k in ("card", "card again", "cpu"))
    check(tree_bytes(os.path.join(card_out, "output")) == tree_bytes(os.path.join(again_out, "output")),
          "two card runs of the sparse GLM wrote different model bytes")
    w_card = card.models[0][1].coefficients.means.cpu().numpy()
    w_cpu = cpu.models[0][1].coefficients.means.cpu().numpy()
    check(bool(np.isfinite(w_card).all()), "non-finite coefficients")
    obj_err = held("sparse GLM objective, card vs CPU", float(card.trained.results[0].value),
                   float(cpu.trained.results[0].value))
    coef_err = held("sparse GLM coefficients, card vs CPU", w_card, w_cpu)
    say(f"  two card runs wrote byte-equal models; card vs CPU: objective |diff| {obj_err:.3g}, "
        f"coefficients max |diff| {coef_err:.3g} (within the solver tolerance)")

    feats = card.train_batch.features
    n, k = feats.indices.shape
    d = feats.dim
    g = torch.Generator(device=dev).manual_seed(SEED + 151)
    dvec = torch.randn((n,), device=dev, generator=g)
    wvec = torch.randn((d,), device=dev, generator=g)
    scatter = SparseFeatures(feats.indices, feats.values, d)
    t0 = time.perf_counter()
    sorted_ = scatter.with_transpose()
    sync(torch)
    build_s = time.perf_counter() - t0
    x_bytes = 8 * n * k  # int32 indices and f32 values, read once
    times = {}
    say(f"  wide ops at N={n} K={k} D={d} f32 (deterministic algorithms on); sorted "
        f"transpose built in {build_s * 1e3:.1f} ms (host clock)")
    for label, fn, nbytes in (
            ("matvec", lambda: scatter.matvec(wvec), x_bytes + 4 * d + 4 * n),
            ("rmatvec scatter", lambda: scatter.rmatvec(dvec), x_bytes + 4 * n + 4 * d),
            ("rmatvec sorted", lambda: sorted_.rmatvec(dvec), x_bytes + 4 * n + 4 * d)):
        ev, gr = timed_pair(torch, fn)
        bound = nbytes / MEM_RATE * 1e3
        times[label] = {"ms": ev, "graph_ms": gr, "bound_ms": bound, "bytes": nbytes,
                        "bound_by": "bytes"}
        say(f"    {label}: {ev:.5f} ms by events, {gr:.5f} ms by graph; bound {bound:.5f} ms "
            f"= {nbytes} B / {MEM_RATE / 1e12:.2f} TB/s ({CARD}); share by graph {bound / gr:.3f}")
    abs_sum = SparseFeatures(feats.indices, feats.values.abs(), d).rmatvec(dvec.abs())
    err, rel = transposes_agree(torch, "the two transpose layouts", scatter.rmatvec(dvec),
                                sorted_.rmatvec(dvec), abs_sum)
    say(f"    the two layouts agree within {err:.3g} ({rel:.3g} of a column's absolute terms)")
    times["layout rule"] = layout_times(torch, dev, n, k, LAYOUT_WIDTHS, g)
    times["rmatvec scatter, modes"] = transpose_times(
        torch, "rmatvec scatter (index_add_)", lambda: scatter.rmatvec(dvec), abs_sum,
        x_bytes + 4 * n + 4 * d)
    slab, *_ = sparse_inputs(torch, fused_sparse, losses.logistic, E_RE, M_RE, D_RE, 16, SEED,
                             dev=dev)
    slab = slab.with_kernel("scatter")
    e, m, ks = slab.idx.shape
    drow = torch.randn((e, m), device=dev, generator=g)
    say(f"  the plain slab transpose (SparseSlab.rmatvec, one flat index_add_) at full width "
        f"E={e} M={m} K={ks} D={slab.dim}")
    slab_abs = fused_sparse.SparseSlab(slab.idx, slab.val.abs(), slab.dim).rmatvec(drow.abs())
    times["slab rmatvec, modes"] = transpose_times(
        torch, "slab rmatvec", lambda: slab.rmatvec(drow), slab_abs,
        8 * e * m * ks + 4 * e * m + 4 * e * slab.dim)
    return {"times": times, "objective_abs_err": obj_err, "coefficient_abs_err": coef_err}


def phase_game_wide(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 16: the GAME driver (spec pallas) on phase 10's generator with
    the fixed section widened to FIXED_WIDE_NAMES names, FIXED_WIDE_PER_ROW a
    row, and the quickstart's fixed effect run to convergence: the fixed
    effect takes the sparse layout, the GEVM kernel launches, every fixed
    solve converges, two card runs write byte-equal models, and the
    objective history holds against the same command on the CPU. The first
    fixed solve then runs again on each side's batch at the quickstart's own
    cap of 50, a witness of how far two unconverged trajectories part
    (printed, not held)."""
    from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
    from photon_ml_tpu_torch.ops.features import SparseFeatures
    from photon_ml_tpu_torch.types import ConvergenceReason

    say(f"== phase 16: game_training_driver.main, phase 10's data with the fixed section "
        f"widened to {FIXED_WIDE_PER_ROW} of {FIXED_WIDE_NAMES} names a row ({GAME_USERS} "
        f"users), the quickstart's flags with the fixed effect's cap raised to "
        f"{FIXED_WIDE_ITERS} LBFGS iterations (L2 lambda 0.01), spec pallas; twice on {dev}, "
        "once on the CPU; then the first fixed solve at the quickstart's cap of 50 on each")
    t0 = time.perf_counter()
    n_train, n_val = write_game_avro(workdir, GAME_USERS, SEED + 16,
                                     wide=(FIXED_WIDE_NAMES, FIXED_WIDE_PER_ROW))
    say(f"  Avro written in {time.perf_counter() - t0:.1f} s: {n_train} train rows, "
        f"{n_val} validation rows")
    solves, first = [], {}
    update = FixedEffectCoordinate.update

    def recorded(self, residual_offsets, *args, **kwargs):
        if not solves:
            first["solve"] = (self, residual_offsets)
        coef, res = update(self, residual_offsets, *args, **kwargs)
        solves.append((int(res.iterations), ConvergenceReason(int(res.reason)).name))
        return coef, res

    runs = {}
    FixedEffectCoordinate.update = recorded
    try:
        for label, device in (("card", dev), ("card again", dev), ("cpu", "cpu")):
            out = os.path.join(workdir, "out-" + label.replace(" ", "-"))
            argv = ["--train-input-dirs", os.path.join(workdir, "train"),
                    "--validate-input-dirs", os.path.join(workdir, "validate"),
                    "--output-dir", out, "--device", device] + WIDE_GAME_FLAGS
            solves.clear()
            driver, wall, launches, stages, _ = run_game_training(torch, fused_sparse, argv,
                                                                  "pallas")
            width = len(driver.shard_index_maps["global"])
            feats = driver.fe_batches["fixed"].features
            check(width > 4096 and isinstance(feats, SparseFeatures),
                  f"{label}: the {width}-wide fixed shard did not take the sparse layout")
            _, result, metrics = driver.results[0]
            check(all(np.isfinite(result.objective_history)), f"{label}: non-finite objective")
            check(len(solves) == 2 and all(r != "MAX_ITERATIONS" for _, r in solves),
                  f"{label}: a fixed-effect solve did not converge within {FIXED_WIDE_ITERS} "
                  f"iterations: {solves}")
            if device != "cpu":
                check(launches["gevm"] > 0, f"{label}: the GEVM kernel did not launch")
            runs[label] = (result, out, launches, wall, list(solves), first.pop("solve"))
            say(f"  {label}: fixed shard width {width} (sparse layout, transpose "
                f"{'sorted' if feats.t_idx is not None else 'scatter'}); fixed solves "
                f"(iterations, stop) {solves}; AUC {metrics['AUC']:.6f}; objective history "
                + " ".join(f"{v:.6f}" for v in result.objective_history)
                + f"; GEVM launches {launches['gevm']}; wall {wall:.2f} s; stages "
                + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()))
    finally:
        FixedEffectCoordinate.update = update
    check(tree_bytes(os.path.join(runs["card"][1], "best"))
          == tree_bytes(os.path.join(runs["card again"][1], "best")),
          "two card runs of the wide GAME driver wrote different model bytes")
    err = held("wide GAME objective history, card vs CPU", runs["card"][0].objective_history,
               runs["cpu"][0].objective_history)
    say(f"  two card runs wrote byte-equal models; objective histories card vs CPU within "
        f"{err:.3g} (solver tolerance)")
    # the quickstart's own cap, a witness and not held: neither side's first
    # fixed solve converges in 50 iterations, and the two trajectories part
    capped = {}
    for label in ("card", "cpu"):
        coord, offsets = runs[label][5]
        problem = dataclasses.replace(coord.problem, optimizer_config=dataclasses.replace(
            coord.problem.optimizer_config, max_iterations=50))
        _, res = FixedEffectCoordinate(coord.batch, problem, coord.norm).update(
            offsets, coord.initial_coefficients())
        capped[label] = float(res.value)
    say(f"  the first fixed solve at the quickstart's cap of 50 (not converged): card "
        f"{capped['card']:.6f}, CPU {capped['cpu']:.6f}, |diff| "
        f"{abs(capped['card'] - capped['cpu']):.6f}; run to convergence above: card "
        f"{runs['card'][0].objective_history[0]:.6f}, CPU "
        f"{runs['cpu'][0].objective_history[0]:.6f}")
    return {"launches": runs["card"][2], "wall_s": runs["card"][3], "objective_abs_err": err,
            "fixed_solves": {k: runs[k][4] for k in runs}, "first_solve_cap_50": capped,
            "objective_history": {k: runs[k][0].objective_history for k in runs}}


def phase_checkpoints(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 17: phase 10's command with --checkpoint-dir under spec pallas
    and spec scatter: an uninterrupted run (the checkpoint's bytes and save
    time per step), a subprocess stopped by PHOTON_PREEMPT_AT (exit 75) and
    resumed, --checkpoint-async true, and --max-restarts 1 with an injected
    preemption; every run's model bytes equal the uninterrupted run's."""
    from photon_ml_tpu_torch import checkpoint
    from photon_ml_tpu_torch.resilience import preemption

    say("== phase 17: checkpoints and preemption: phase 10's command with --checkpoint-dir, "
        "spec pallas then scatter")
    here = os.path.dirname(os.path.abspath(__file__))
    base = ["--train-input-dirs", os.path.join(workdir, "train"),
            "--validate-input-dirs", os.path.join(workdir, "validate"),
            "--device", dev, "--delete-output-dir-if-exists", "true"] + GAME_FLAGS
    out = {}
    for spec in ("pallas", "scatter"):
        tag = lambda name: os.path.join(workdir, f"ck17-{spec}-{name}")
        saves = []
        inner_save = checkpoint.CoordinateDescentCheckpointer.save

        def timed_save(self, state, _inner=inner_save):
            t0 = time.perf_counter()
            path = _inner(self, state)
            saves.append((state.step, time.perf_counter() - t0,
                          sum(len(b) for b in tree_bytes(path).values())))
            return path

        checkpoint.CoordinateDescentCheckpointer.save = timed_save
        try:
            preemption.reset()
            clean, wall, launches, _, _ = run_game_training(
                torch, fused_sparse,
                base + ["--output-dir", tag("out"), "--checkpoint-dir", tag("ck")], spec)
        finally:
            checkpoint.CoordinateDescentCheckpointer.save = inner_save
        want = tree_bytes(os.path.join(tag("out"), "best"))
        steps = sorted(os.listdir(os.path.join(tag("ck"), "combo-0")))
        say(f"  spec {spec}: uninterrupted run {wall:.2f} s, GEVM launches {launches['gevm']}; "
            f"checkpoint per step: " + ", ".join(f"step {st} {b} B in {secs * 1e3:.1f} ms"
                                                 for st, secs, b in saves)
            + f"; kept {steps}")
        check(len(saves) == 4 and steps == ["step-3", "step-4"],
              f"spec {spec}: checkpoint saves {saves}, kept {steps}")

        env = dict(os.environ, PHOTON_SPARSE_KERNEL=spec, PHOTON_PREEMPT_AT="cycle:2")
        argv = base + ["--output-dir", tag("sub"), "--checkpoint-dir", tag("ck-sub")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
                               *argv], cwd=here, env=env, capture_output=True, text=True,
                              timeout=600)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 75, f"spec {spec}: the preempted subprocess exited "
                                     f"{proc.returncode}: {proc.stderr[-2000:]}")
        kept = sorted(os.listdir(os.path.join(tag("ck-sub"), "combo-0")))
        check(kept[-1] == "step-2", f"spec {spec}: the preempted run kept {kept}")
        preemption.reset()
        resumed, wall_r, launches_r, _, _ = run_game_training(torch, fused_sparse, argv, spec)
        check(tree_bytes(os.path.join(tag("sub"), "best")) == want,
              f"spec {spec}: the resumed run's model bytes differ from the uninterrupted run's")
        check(resumed.results[0][1].objective_history == clean.results[0][1].objective_history,
              f"spec {spec}: the resumed objective history differs")
        say(f"  spec {spec}: subprocess stopped at step 2 exited 75 after {sub_s:.2f} s (kept "
            f"{kept}); resumed in {wall_r:.2f} s (GEVM launches {launches_r['gevm']}): model "
            "bytes and objective history equal to the uninterrupted run's")

        preemption.reset()
        _, wall_a, _, _, _ = run_game_training(
            torch, fused_sparse, base + ["--output-dir", tag("async"), "--checkpoint-dir",
                                         tag("ck-async"), "--checkpoint-async", "true"], spec)
        check(tree_bytes(os.path.join(tag("async"), "best")) == want,
              f"spec {spec}: the async run's model bytes differ")
        preemption.reset()
        os.environ["PHOTON_PREEMPT_AT"] = "cycle:3"
        try:
            restarted, wall_m, _, _, _ = run_game_training(
                torch, fused_sparse, base + ["--output-dir", tag("restart"), "--checkpoint-dir",
                                             tag("ck-restart"), "--max-restarts", "1"], spec)
        finally:
            del os.environ["PHOTON_PREEMPT_AT"]
            preemption.reset()
        check(tree_bytes(os.path.join(tag("restart"), "best")) == want,
              f"spec {spec}: the restarted run's model bytes differ")
        say(f"  spec {spec}: --checkpoint-async true {wall_a:.2f} s and --max-restarts 1 with a "
            f"preemption at step 3 {wall_m:.2f} s: model bytes equal to the uninterrupted run's")
        out[spec] = {"saves": saves, "wall_s": wall, "subprocess_s": sub_s, "resume_s": wall_r,
                     "async_s": wall_a, "restart_s": wall_m}
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from photon_ml_tpu_torch.device import enable_determinism

    enable_determinism()  # before any CUDA work: cuBLAS reads its workspace setting once
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
    check(torch.are_deterministic_algorithms_enabled()
          and not torch.is_deterministic_algorithms_warn_only_enabled(),
          "deterministic algorithms are not on")
    say(f"  deterministic algorithms: on (warn_only off), CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ['CUBLAS_WORKSPACE_CONFIG']}")

    say("== phase 2: build the kernel libraries from csrc/ (nvcc) and the host libraries "
        "from native/ (g++), one compiler per source, in parallel")
    from photon_ml_tpu_torch.ops import fused_sparse

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    sources = (fused_glm.SOURCE, fused_sparse.SOURCE)
    host_sources = (("avro_decoder.cpp", ("-lz",)), ("libsvm_parser.cpp", ()),
                    ("pmix_store.cpp", ()))
    with concurrent.futures.ThreadPoolExecutor(len(sources) + len(host_sources)) as pool:
        kernel_builds = [pool.submit(native_build.build, src) for src in sources]
        host_builds = [pool.submit(native_build.build_host, src, libs)
                       for src, libs in host_sources]
        paths = [f.result() for f in kernel_builds]
        host_paths = [f.result() for f in host_builds]
    say(f"  {[os.path.relpath(p_, here) for p_ in paths + host_paths]} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, path in zip(sources, paths):
        log = native_build.build_logs.get(path, "").splitlines()
        regs = [line.split("Used ")[1].split(" registers")[0] for line in log if "registers" in line]
        spills = sum(1 for line in log if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
        say(f"  ptxas {src}: registers per kernel {regs}; kernels with spills or stack: {spills}")
    check(native_build.native_enabled(), "PHOTON_ML_TPU_NATIVE switches the host libraries off")

    max_abs_err = phase_kernel_vs_plain(torch, fused_glm, losses)
    times = phase_times(torch, fused_glm, losses)
    grid_launches = phase_train_grid(torch, fused_glm, times["bfloat16"]["graph_ms"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        driver_launches = phase_driver(torch, fused_glm, workdir)
    sparse_err = phase_sparse_vs_plain(torch, fused_sparse, losses)
    sparse_times = phase_sparse_times(torch, fused_sparse, losses)
    re_runs = phase_re_solve(torch, fused_sparse, sparse_times["full width"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_game_") as workdir:
        game_runs, trained = phase_game_driver(torch, fused_sparse, workdir)
        phase_ingest(workdir, trained)
        phase_scoring(torch, workdir, trained)
        phase_offheap(torch, fused_sparse, workdir, trained)
        phase_random_projection(torch, trained)
        checkpoints = phase_checkpoints(torch, fused_sparse, workdir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sparse_") as workdir:
        sparse_glm = phase_sparse_glm(torch, fused_sparse, losses, workdir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_") as workdir:
        wide = phase_game_wide(torch, fused_sparse, workdir)

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
        "graph_ms": bf16["graph_ms"],
        "ms_method": MS_METHOD,
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
        "shape": f"N={N_FULL} D={D_FULL} bf16",
        "f32": times["float32"],
    }]
    # GEVM's main path is the GAME driver (LBFGS, the quickstart), at the
    # driver's slab shape; HVP's is the random-effect TRON solve at full
    # width, the driver's LBFGS never calls it
    for key, kname, line, main_launches, main_shape in (
            ("gevm", "fused_sparse_gevm", 485, game_runs["pallas"]["launches"]["gevm"],
             "driver shape"),
            ("hvp", "fused_sparse_hvp", 527, re_runs["TRON"]["launches"]["hvp"], "full width")):
        t = sparse_times[main_shape][key]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "photon_ml_tpu_torch/csrc/fused_sparse.cu",
            "replaces": f"photon_ml_tpu/ops/fused_sparse.py:{line}",
            "launches": main_launches,
            "launches_re_lbfgs": re_runs["LBFGS"]["launches"][key],
            "launches_re_tron": re_runs["TRON"]["launches"][key],
            "launches_game_driver": game_runs["pallas"]["launches"][key],
            "launches_game_wide_fixed": wide["launches"][key],
            "max_abs_err": max(sparse_err[key], game_runs["max_abs_err"][key]),
            "ms": t["ms"],
            "graph_ms": t["graph_ms"],
            "host_ms": t["host_ms"],
            "ms_method": MS_METHOD,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": t["shape"],
            "table_bytes": t["table_bytes"],
            "design_bytes_ms": t["design_bytes_ms"],
            "shapes": {label: sparse_times[label][key] for label in sparse_times},
        })
    say(json.dumps({"sparse_fixed_effect": sparse_glm, "game_wide_fixed": wide,
                    "checkpoints": checkpoints}))
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
