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
    same update on the CPU.

Every phase prints on its own lines; any failed check exits non-zero. The
last lines are the card's name and power limit, one JSON object listing the
kernels, and ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA card is available or the
package is not beside this script. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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


def write_game_avro(workdir, num_users, seed):
    """bench.py's GAME data as TrainingExampleAvro with two feature sections,
    each user's rows split 80/20 into train/ and validate/."""
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import schemas

    rng = np.random.default_rng(seed)
    rows_per_user = rng.integers(8, 16, size=num_users)
    n = int(rows_per_user.sum())
    user = rng.permutation(np.repeat(np.arange(num_users), rows_per_user))
    x_f = rng.normal(size=(n, GAME_D_FIXED)).astype(np.float32)
    x_r = rng.normal(size=(n, GAME_D_RANDOM)).astype(np.float32)
    w_f = rng.normal(size=GAME_D_FIXED).astype(np.float32)
    w_u = (rng.normal(size=(num_users, GAME_D_RANDOM)) * 1.5).astype(np.float32)
    margin = x_f @ w_f + np.sum(x_r * w_u[user], axis=1)
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

    def records(sel):
        for r in np.nonzero(sel)[0]:
            yield {"uid": str(r), "label": float(y[r]),
                   "fixedFeatures": [{"name": f"f{j}", "term": "", "value": float(v)}
                                     for j, v in enumerate(x_f[r])],
                   "userFeatures": [{"name": f"u{j}", "term": "", "value": float(v)}
                                    for j, v in enumerate(x_r[r])],
                   "metadataMap": {"userId": f"user{user[r]}"}}

    for name, sel in (("train", ~validate), ("validate", validate)):
        avro_io.write_container(os.path.join(workdir, name, "part-00000.avro"), records(sel), schema)
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
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
