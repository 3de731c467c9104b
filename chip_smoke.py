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
  * checkpoints and preemption: the GAME driver with ``--checkpoint-dir``
    on phase 10's data, stopped (a subprocess exiting 75)
    and resumed, async, and restarted in-process, every model byte-equal to
    the uninterrupted run's;
  * the GAME driver's grid, sampling and factored surface (phase 19):
    bench.py:2411's lambda grid with ``--model-output-mode ALL``, per combo
    and with ``--vmapped-grid true`` (byte-equal models); down-sampling and
    Pearson selection, card against CPU, the sampled weights bit-equal to
    the host's threefry draws; bench.py:2476's full GAME model (fixed,
    per-user, per-item and a factored per-artist coordinate) twice on the
    card (byte-equal models and checkpoints) and once on the CPU, then
    scored latent-natively against the host oracle, the factored
    contribution timed against its bytes bound;
  * the GLM driver's whole surface on the dense GLM data (phase 18, run
    right after phase 6): the README's GLM quickstart as written
    (``--diagnostic-mode VALIDATE``), LBFGS and OWL-QN in a box,
    ``--diagnostic-mode ALL`` with TRON and box constraints twice on the
    card (byte-equal) and once on the CPU (held at the solver tolerance),
    and TrainingExampleAvro input with selected features, summaries and an
    off-heap index;
  * sparse fixed effects: ``cli.glm_driver.main`` on bench.py:59's
    sparse-wide data (N=131072, D=2^20), twice on the card (byte-equal) and
    once on the CPU, and the GAME driver with a 2^17-wide fixed shard, twice
    on the card (byte-equal) and, at 4000 users, once on the card and once
    on the CPU, with the wide matvec and transposes timed against their
    bytes bound.

  * the solve scheduler (phase 21, after phase 20 on its data): the
    full-width random-effect solve one-shot, through the host chunk loop and
    through the device rung loop (captured CUDA graphs), bitwise equal; the
    lane-indirect kernels bitwise the full launch at every rung; the
    bucketed GAME driver with ``--solve-compaction`` (host and device
    loops) and ``--adaptive-schedule``, byte-equal models; and a stop at a
    chunk or rung boundary resumed to the same model bytes; (f) the dense
    (E, M, D) stack's compacted solves bitwise the one-shot solve at every
    rung, at the GAME driver's stack shape and a wider D.

  * the tensor cache and streaming (phase 22): (a) phase 6's GLM command
    with ``--streaming-chunk-rows`` (LBFGS with ``--tensor-cache`` cold and
    warm, at ``PHOTON_PREFETCH_DEPTH=0``, and TRON; held against the
    in-memory solves), and a ``torch.profiler`` trace of one streamed pass
    (the pinned side-stream H2D copies against the kernels); (b) phase
    20's data with ``--streaming-random-effects`` and a block budget:
    held against the in-memory run, byte-equal at depth 0, with
    ``--solve-compaction`` and after a stop at a block boundary, both
    sparse kernels held on every block's slab, the update's peak device
    memory against the budget; (c) phase 10's command with
    ``--tensor-cache`` cold and warm (the warm run decodes no training
    file).

  * the daily retrain loop (phase 24, last, on phase 20's data): phase 22
    (b)'s first run is yesterday's; (a) the same command with
    ``--warm-start-from`` short-circuits (no ingest, no kernel launch,
    byte-equal model); (b) after a new part file (2 rows for every user of
    one prior block, 64 new users) the unchanged blocks are frozen (their
    users' coefficients bitwise the prior's) and the dirty and new blocks
    re-solve warm through the GEVM kernel; (c) bucketed in-memory warm
    starts at 2000 users on the card and the CPU; (d) ``--plan off`` and
    ``--plan auto`` (the cost model written, then loaded).

  * multi-process GAME training (phase 25, after phase 23 on phase 10's
    data): (a) the GAME driver with ``--distributed`` on a 1-rank NCCL
    group, model bytes equal to phase 10's; (b) ``cli.game_multihost_driver``
    at 1 rank (NCCL), held against phase 10's model; (c) 2 ranks sharing
    the card over gloo, checkpointed, held against (b), 2 part files, the
    fused-GLM and GEVM kernels launched on each rank; (d) 2-rank
    ``cli.game_multihost_scoring_driver`` against the scoring driver; (e)
    (c) extended by one iteration resumes only the new updates.

Deterministic algorithms are on from the start (``device.enable_determinism``).
Every phase prints on its own lines and its wall; any failed check exits
non-zero. The last lines are a JSON object of the sparse, checkpoint,
GLM-diagnostics and phase 19 numbers and every phase's wall, the card's
name and power limit, one JSON object listing the kernels, and
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA card is available or the
package is not beside this script. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 20260729
N_FULL, D_FULL = 262144, 512
GLM_DRIVER_D = 511  # the GLM driver's LIBSVM features (+ the intercept: D_FULL)
LAMBDAS = (10.0, 1.0, 0.1)
# the card's published peaks (NVIDIA H100 SXM data sheet), for the name torch
# reports: memory bytes/s and fp32 CUDA-core flop/s
CARD = "H100 80GB HBM3"
MEM_RATE, FP32_RATE = 3.35e12, 67e12
# kernel-vs-plain shapes: the main path's (N, D), a ragged N, an odd D,
# wider D that take the 4-, 8- and 16-column instantiations of stage 1, and
# the GAME drivers' dense fixed effects (32 features and the intercept) at
# phase 10's training rows and at the full GAME model's (phase 19c)
CHECK_SHAPES = ((N_FULL, D_FULL), (N_FULL - 37, D_FULL), (65536, D_FULL),
                (N_FULL, 65), (N_FULL - 37, 65), (65536, 65),
                (32768, 1000), (32768, 2048), (32771, 4096),
                (192667, 33), (96113, 33))
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


def graph_ms(torch, fn, reps: int = 20, runs: int = 30, budget_ms: float = 1500.0) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph, the graph replayed ``runs`` times between CUDA events,
    each replay's time divided by ``reps`` (the host's launch time between
    back-to-back calls stays out of the number). A slow call gets fewer
    replays: as many as fill ``budget_ms`` of device time, at least 5 (a
    14.8 ms call would otherwise hold the card 9 s for one reading)."""
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
    first = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    first[0].record()
    graph.replay()
    first[1].record()
    torch.cuda.synchronize()
    runs = max(5, min(runs, int(budget_ms / max(first[0].elapsed_time(first[1]), 1e-3))))
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


def hold_fused(torch, fused_glm, args, tol, label):
    """The fused kernel against its plain version on ``args`` (loss, x, y,
    weights, offsets, w): value and gradient relative error and the sum-d
    error over |sum d| + sum |d| within ``tol``, two kernel runs bitwise
    equal. Returns max |kernel - plain| over the three outputs."""
    got = fused_glm.fused_value_grad_kernel(*args)
    again = fused_glm.fused_value_grad_kernel(*args)
    want = fused_glm.fused_value_grad_parts_plain(*args)
    torch.cuda.synchronize()
    check(all(torch.isfinite(t).all() for t in got), f"non-finite kernel output: {label}")
    val_err = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    grad_err = (torch.linalg.vector_norm(got[1] - want[1])
                / torch.linalg.vector_norm(want[1])).item()
    sd_err = abs(got[2].item() - want[2].item()) / (
        abs(want[2].item()) + sum_abs_d(torch, *args))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    say(f"  {label}: value rel err {val_err:.3e}  |dgrad|/|grad| {grad_err:.3e}  "
        f"sum-d err {sd_err:.3e}  bitwise repeat {same}")
    check(val_err <= tol and grad_err <= tol and sd_err <= tol,
          f"kernel disagrees with plain beyond {tol}: {label}")
    check(same, f"two kernel runs differ: {label}")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


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
                label = f"{str(dtype)[6:]:8s} N={n:6d} D={d:4d} {loss.name:14s}"
                max_abs_err = max(max_abs_err, hold_fused(torch, fused_glm, args, tol, label))
                cases += 1
    say(f"  {cases} cases within tolerance (value and gradient relative error, and sum-d error "
        f"over |sum d| + sum |d|, <= 1e-5 f32, <= 1e-3 bf16); max |kernel - plain| over all "
        f"outputs {max_abs_err:.3e}")
    return max_abs_err


# the dense race's shapes: the GLM path's, and the GAME drivers' fixed effect
# (phase 10's training rows, 32 features and the intercept)
RACE_SHAPES = ((N_FULL, D_FULL), (192667, 33))


def dense_race_reports(torch, fused_glm, losses):
    """The dense race (PHOTON_ML_TPU_FUSED=auto) at RACE_SHAPES in bf16 and
    f32, each candidate's sec/pass or failure and the winner, printed."""
    out = {}
    for n, d in RACE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            rep = fused_glm.autotune_report(losses.logistic, n, d, dtype, "cuda")
            key = f"{n}x{d} {str(dtype)[6:]}"
            out[key] = rep
            check(rep["candidates"] and all("sec_per_pass" in c or c.get("failed")
                                            for c in rep["candidates"].values()),
                  f"dense race {key}: a candidate has neither a time nor a failure: {rep}")
            say(f"  dense race {key} (probe {min(n, fused_glm.PROBE_ROWS)} rows): winner "
                f"{rep['winner'] or 'matmul'}; " + "; ".join(
                    f"{name} " + (f"{c['sec_per_pass'] * 1e3:.4f} ms/pass, "
                                  f"{c['one_stream_gb_per_sec']} GB/s one stream of X"
                                  if "sec_per_pass" in c else f"FAILED {c['failed']}")
                    for name, c in rep["candidates"].items()))
    return out


def phase_times(torch, fused_glm, losses):
    """Phase 4: kernel and plain times at N=262144, D=512 beside the bound;
    the kernel by both methods (per-launch CUDA events, CUDA-graph replay);
    the dense race's baseline (two torch.matmul) on the same inputs; then
    the dense race's reports at RACE_SHAPES."""
    say("== phase 4: times at N=262144, D=512 (logistic): median of 30 per-launch CUDA-event "
        "readings; graph: median of 30 CUDA-graph replays of 20 launches")
    mem_rate, flop_rate = MEM_RATE, FP32_RATE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = (losses.logistic,) + make_inputs(torch, losses.logistic, N_FULL, D_FULL, dtype, SEED)
        kernel_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_kernel(*args))
        plain_ms = time_ms(torch, lambda: fused_glm.fused_value_grad_parts_plain(*args))
        library_ms = time_ms(torch, lambda: fused_glm.matmul_value_grad(*args))
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
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "share_of_bound": bound_ms / ms,
            "ms_runs": [kernel_ms, kernel_ms2], "graph_ms": graph,
            "share_of_bound_graph": bound_ms / graph,
        }
        say(f"  {name:8s} kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms (graph {graph:.4f} ms)   "
            f"plain two-pass {plain_ms:.4f} ms (context only)   two torch.matmul (the race's "
            f"baseline) {library_ms:.4f} ms   bound {bound_ms:.4f} ms = {nbytes} B "
            f"/ {mem_rate / 1e12:.2f} TB/s ({CARD}; ops bound {ops_ms:.4f} ms)   share of bound "
            f"{bound_ms / ms:.3f} (graph {bound_ms / graph:.3f})")
    out["race"] = dense_race_reports(torch, fused_glm, losses)
    return out


def phase_train_grid(torch, fused_glm, kernel_ms):
    """Phase 5: train_glm_grid at full width through the kernel; each
    lambda's final objective against a solve whose objective is plain."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.ops import losses
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
    chose = fused_glm.select_fused_block_rows(losses.logistic, N_FULL, D_FULL, torch.bfloat16,
                                              "cuda") is not None
    check(chose, "the dense race chose the matmul path for train_glm_grid's batch (it chose "
                 "the kernel at every shape measured so far)")
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
    # one %-format a block of rows ("label col:value ..." with 1-based
    # columns and 4 decimals): the bytes of a per-row f-string, in half the time
    row = "%d " + " ".join(["%d:%.4f"] * nnz) + "\n"
    with open(path, "w") as f:
        for lo in range(0, n, 4096):
            hi = min(n, lo + 4096)
            items = np.empty((hi - lo, 2 * nnz + 1), dtype=object)
            items[:, 0] = labels[lo:hi].tolist()
            items[:, 1::2] = (cols[lo:hi] + 1).tolist()
            items[:, 2::2] = vals[lo:hi].astype(np.float64).tolist()
            f.write((row * (hi - lo)) % tuple(items.ravel().tolist()))


def phase_driver(torch, fused_glm, workdir):
    """Phase 6: glm_driver.main end to end on a generated LIBSVM pair; the
    native loader must parse every file."""
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io import libsvm
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem

    n_train, n_val, d, nnz = N_FULL, 8192, GLM_DRIVER_D, 32
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
    b = driver.train_batch
    chose = fused_glm.select_fused_block_rows(  # the race's cached choice for this batch
        losses.for_task(driver.problem.task), b.num_rows, b.dim, b.features.matrix.dtype,
        b.device) is not None
    check(chose, "the dense race chose the matmul path for glm_driver's batch (it chose the "
                 "kernel at every shape measured so far)")
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
    driver.argv = argv  # phase 22 (a) streams the same command

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
    return launches, driver


# --- the GLM driver's whole surface: diagnostics, box constraints, Avro ----

# the README's GLM quickstart (README.md:37-45), flags verbatim
README_GLM_FLAGS = ["--task", "LOGISTIC_REGRESSION", "--input-file-format", "LIBSVM",
                    "--regularization-weights", "0.1,1,10", "--optimizer", "LBFGS",
                    "--regularization-type", "L2", "--normalization-type", "STANDARDIZATION",
                    "--diagnostic-mode", "VALIDATE"]
BOX_BOUND = 0.1
GLM_BOX = f'[{{"name":"*","term":"*","lowerBound":-{BOX_BOUND},"upperBound":{BOX_BOUND}}}]'
DIAG_FLAGS = ["--task", "LOGISTIC_REGRESSION", "--input-file-format", "LIBSVM",
              "--regularization-weights", "0.1,1,10", "--optimizer", "TRON",
              "--regularization-type", "L2", "--normalization-type", "STANDARDIZATION",
              "--diagnostic-mode", "ALL", "--coefficient-box-constraints", GLM_BOX]
BOOTSTRAP_SAMPLES = 10
# phase 18 (b)'s card-against-CPU pair and (c)'s Avro copy: the first quarter
# of phase 6's training rows (a cut for the call's time, see CUTS; on an
# eighth the fitting diagnostic has too few rows for its learning curves)
DIAG_CPU_ROWS = N_FULL // 4
# the section titles the JAX driver writes (photon_ml_tpu/cli/glm_driver.py
# diagnose): per chapter, in order; the CPU tests hold the port's HTML to the
# JAX driver's, here the card's HTML is held to these
VALIDATE_SECTIONS = ["Summary", "Feature importance (EXPECTED_MAGNITUDE)",
                     "Prediction / error independence", "Hosmer-Lemeshow calibration"]


def _sections(path):
    """The chapter and section titles of a model-diagnostic.html, numbers cut."""
    import re

    with open(path) as f:
        text = f.read()
    return [re.sub(r"^[\d.]+ ", "", h) for h in re.findall(r"<h[23][^>]*>([^<]*)</h[23]>", text)]


def _stripped_records(path):
    """An Avro file's records as JSON, the report timestamps blanked."""
    import re

    from photon_ml_tpu_torch.io.avro import read_container

    return [re.sub(r'"timestamp": "[^"]*"', '"timestamp": ""', json.dumps(r, sort_keys=True))
            for r in read_container(path)]


def run_glm_stages(torch, fused_glm, argv):
    """One glm_driver.main run with the fused kernel's launches counted per
    stage: the lambda grid (the driver's train_glm_grid), the fitting
    diagnostic's prefix grids, and the bootstrap (which solves with the
    plain objective, as the JAX package's does). The counts are set to 0
    just before the run. Returns (driver, wall, launches by stage, what
    each counted stage returned and each (model, batch, report) of the
    independence and Hosmer-Lemeshow diagnostics, the bootstrap's device
    resample counts)."""
    from photon_ml_tpu_torch import bootstrap
    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.diagnostics import (bootstrap_diagnostic, fitting,
                                                 hosmer_lemeshow, independence)

    kernel = fused_glm.fused_value_grad_kernel
    stages = {"grid": 0, "fitting": 0, "bootstrap": 0}
    returned, drawn = {"independence": [], "hosmer-lemeshow": []}, []

    def counted(stage, fn):
        def run(*a, **k):
            before = kernel.launches
            try:
                returned[stage] = fn(*a, **k)
                return returned[stage]
            finally:
                stages[stage] += kernel.launches - before
        return run

    def recorded(*a, **k):
        drawn.append(draw(*a, **k))
        return drawn[-1]

    def per_model(name, fn):
        def run(model, batch):
            returned[name].append((model, batch, fn(model, batch)))
            return returned[name][-1][2]
        return run

    grid, fit, boot, draw, ind, hl = (
        glm_driver.train_glm_grid, fitting.diagnose, bootstrap_diagnostic.diagnose,
        bootstrap.bootstrap_weights, independence.diagnose, hosmer_lemeshow.diagnose)
    glm_driver.train_glm_grid = counted("grid", grid)
    glm_driver.fitting.diagnose = counted("fitting", fit)
    glm_driver.bootstrap_diagnostic.diagnose = counted("bootstrap", boot)
    bootstrap.bootstrap_weights = recorded
    independence.diagnose = per_model("independence", ind)
    hosmer_lemeshow.diagnose = per_model("hosmer-lemeshow", hl)
    try:
        sync(torch)
        kernel.launches = 0
        t0 = time.perf_counter()
        driver = glm_driver.main(argv)
        sync(torch)
        wall = time.perf_counter() - t0
        total = kernel.launches
    finally:
        glm_driver.train_glm_grid, fitting.diagnose = grid, fit
        bootstrap_diagnostic.diagnose, bootstrap.bootstrap_weights = boot, draw
        independence.diagnose, hosmer_lemeshow.diagnose = ind, hl
    check(sum(stages.values()) == total, f"launches by stage {stages} != {total}")
    return driver, wall, dict(stages, total=total), returned, drawn


def _check_diagnosed(driver, out, label, mode, dev):
    """The output layout, the HTML's sections and the diagnostics/ files."""
    from photon_ml_tpu_torch.cli.glm_driver import DriverStage

    check(driver.stage == DriverStage.DIAGNOSED, f"{label}: stage {driver.stage.name}")
    check(driver.device.type == dev and driver.train_batch.labels.device.type == dev,
          f"{label}: the driver ran off the {dev} device")
    check(sorted(os.listdir(out)) == ["best", "diagnostics", "model-diagnostic.html", "output",
                                      "photon-ml-tpu.log"], f"{label}: layout {os.listdir(out)}")
    check(len(os.listdir(os.path.join(out, "output"))) == 3, f"{label}: output/")
    check(sorted(os.listdir(os.path.join(out, "diagnostics")))
          == ["evaluation-results.avro", "feature-summaries.avro"], f"{label}: diagnostics/")
    got = _sections(os.path.join(out, "model-diagnostic.html"))
    per_model = VALIDATE_SECTIONS + (["Fitting analysis (learning curves)"] if mode == "ALL" else [])
    want = ["System", "Parameters", "Feature summary"]
    for i, lam in enumerate(driver.trained.weights):
        want += [f"Model (lambda = {lam:g})"] + per_model
        if mode == "ALL" and i == 0:
            want.append("Bootstrap analysis")
    check(got == want, f"{label}: HTML sections {got} != {want}")
    records = _stripped_records(os.path.join(out, "diagnostics", "evaluation-results.avro"))
    check(len(records) == 3, f"{label}: {len(records)} evaluation records")
    return got


def _check_box(driver, label):
    """Every coefficient of every solve in [-BOX_BOUND, BOX_BOUND] (the
    solve's space, where the box binds). Returns per solve the count of
    coefficients on the bound."""
    import torch

    on_bound = []
    for lam, model in zip(driver.trained.weights, driver.trained.models):
        w = model.coefficients.means
        check(bool(torch.all(w.abs() <= BOX_BOUND)), f"{label} lambda={lam}: a coefficient outside the box")
        on_bound.append(int(torch.sum(w.abs() == BOX_BOUND)))
    return on_bound


def _plain_counts(returned, label):
    """Holds each model's Kendall pair counts and Hosmer-Lemeshow bin counts,
    as the run's diagnostics counted them on its device, exactly against
    numpy's count over the same predictions (the same subsample, f32
    differences, the same bin index). Returns, per model, the Kendall
    (concordant, discordant, ties in a, ties in b) and the HL (positive,
    negative) counts per bin."""
    from photon_ml_tpu_torch.diagnostics import independence

    kendall, bins = [], []
    for model, batch, report in returned["independence"]:
        pred = model.compute_mean_functions(batch).detach().cpu().numpy()
        present = batch.weights.detach().cpu().numpy() > 0.0
        pred, labels = pred[present], batch.labels.detach().cpu().numpy()[present]
        a, b = pred.astype(np.float64), (labels - pred).astype(np.float64)
        m = max(int(np.sqrt(len(a))), min(len(a), 2048))
        if len(a) > m:
            idx = np.random.default_rng(0).choice(len(a), size=m, replace=False)
            a, b = a[idx], b[idx]
        a, b = a.astype(np.float32), b.astype(np.float32)
        upper = np.triu_indices(len(a), 1)
        sa = np.sign(a[:, None] - a[None, :])[upper]
        sb = np.sign(b[:, None] - b[None, :])[upper]
        want = (int(np.sum(sa * sb > 0)), int(np.sum(sa * sb < 0)), int(np.sum(sa == 0)),
                int(np.sum((sa != 0) & (sb == 0))))
        # the report from numpy's counts, ties included, field for field
        check(report.kendall_tau == independence.analyze_counts(*want, len(a)),
              f"{label}: Kendall report {report.kendall_tau} != the one of numpy's counts {want}")
        kendall.append(want)
    for model, batch, report in returned["hosmer-lemeshow"]:
        nb = len(report.histogram)
        p = np.clip(model.compute_mean_functions(batch).detach().cpu().numpy(), 0.0, 1.0)
        present = batch.weights.detach().cpu().numpy() > 0.0
        y = batch.labels.detach().cpu().numpy()[present]
        idx = np.minimum((p[present] * np.float32(nb)).astype(np.int32), nb - 1)
        want = (np.bincount(idx, weights=y, minlength=nb).astype(np.int64).tolist(),
                np.bincount(idx, weights=1.0 - y, minlength=nb).astype(np.int64).tolist())
        got = ([h.observed_pos for h in report.histogram], [h.observed_neg for h in report.histogram])
        check(got == want, f"{label}: Hosmer-Lemeshow bin counts {got} != numpy's {want}")
        bins.append(want)
    check(len(kendall) == len(bins) == 3, f"{label}: {len(kendall)} Kendall and {len(bins)} HL reports")
    return kendall, bins


def _diagnostics_held(card, cpu, card_dir, cpu_dir):
    """(b) on the card against (b) on the CPU: per-lambda objectives and
    coefficients, every record of diagnostics/ (the evaluation contexts
    equal, their metrics and curve areas, the feature summaries), the
    fitting curves (the same prefixes) and the bootstrap's summaries, at
    the solver tolerance. Returns the largest |diff| of each."""
    import re

    from photon_ml_tpu_torch.io.avro import read_container

    (cd, _, _, cret, _), (pd, _, _, pret, _) = card, cpu
    errs = {}
    objective = lambda d: [float(r.value) for r in d.trained.results]
    errs["objectives"] = held("(b) objectives, card vs CPU", objective(cd), objective(pd))
    errs["coefficients"] = max(
        held(f"(b) lambda={lam:g} coefficients, card vs CPU", a.means_as_numpy(), b.means_as_numpy())
        for (lam, a), (_, b) in zip(cd.models, pd.models))
    def area(points):
        xy = np.asarray([[q["x"], q["y"]] for q in points], np.float64)
        return float(np.sum(np.diff(xy[:, 0]) * (xy[1:, 1] + xy[:-1, 1]) / 2.0))

    def context(rec, root):
        ctx = json.loads(re.sub(r'"timestamp": "[^"]*"', '"timestamp": ""',
                                json.dumps(rec["evaluationContext"]).replace(root, "")))
        ctx["modelTrainingContext"].pop("convergenceReason")
        return ctx

    paths = [os.path.join(d, "diagnostics", "evaluation-results.avro") for d in (card_dir, cpu_dir)]
    card_recs, cpu_recs = (list(read_container(p_)) for p_ in paths)
    check(len(card_recs) == len(cpu_recs) == 3, "(b): evaluation records card vs CPU")
    metric_err = curve_err = 0.0
    for a, b in zip(card_recs, cpu_recs):
        check(context(a, card_dir) == context(b, cpu_dir), "(b): evaluation contexts card vs CPU")
        check(sorted(a["scalarMetrics"]) == sorted(b["scalarMetrics"]), "(b): metric names")
        keys = sorted(b["scalarMetrics"])
        metric_err = max(metric_err, held("(b) evaluation metrics, card vs CPU",
                                          [a["scalarMetrics"][k] for k in keys],
                                          [b["scalarMetrics"][k] for k in keys]))
        check(sorted(a["curves"]) == sorted(b["curves"]), "(b): curve names")
        curve_err = max(curve_err, held("(b) curve areas, card vs CPU",
                                        [area(a["curves"][k]["points"]) for k in sorted(b["curves"])],
                                        [area(b["curves"][k]["points"]) for k in sorted(b["curves"])]))
    errs["evaluation_metrics"], errs["curve_areas"] = metric_err, curve_err
    paths = [os.path.join(d, "diagnostics", "feature-summaries.avro") for d in (card_dir, cpu_dir)]
    card_recs, cpu_recs = (list(read_container(p_)) for p_ in paths)
    check([(r["featureName"], r["featureTerm"]) for r in card_recs]
          == [(r["featureName"], r["featureTerm"]) for r in cpu_recs], "(b): feature summary names")
    metrics = lambda recs: [r["metrics"][k] for r in recs for k in sorted(r["metrics"])]
    errs["feature_summaries"] = held("(b) feature summaries, card vs CPU",
                                     metrics(card_recs), metrics(cpu_recs))
    fit_err = 0.0
    check(sorted(cret["fitting"]) == sorted(pret["fitting"]), "(b): fitting lambdas")
    for lam, rep in pret["fitting"].items():
        got = cret["fitting"][lam].metrics
        check(sorted(got) == sorted(rep.metrics), f"(b) lambda={lam:g}: fitting metrics")
        for name, (portions, train, test) in rep.metrics.items():
            check(got[name][0] == portions, f"(b) lambda={lam:g}: fitting prefixes card vs CPU")
            fit_err = max(fit_err, held(f"(b) lambda={lam:g} {name} curves, card vs CPU",
                                        got[name][1] + got[name][2], train + test))
    errs["fitting_curves"] = fit_err
    cb, pb = cret["bootstrap"], pret["bootstrap"]
    dist = lambda r: [v for k in sorted(r.metric_distributions) for v in r.metric_distributions[k]]
    check(sorted(cb.metric_distributions) == sorted(pb.metric_distributions), "(b): bootstrap metrics")
    errs["bootstrap_metrics"] = held("(b) bootstrap metric distributions, card vs CPU", dist(cb), dist(pb))
    bagged = lambda r: [r.bagged_model_metrics[k] for k in sorted(pb.bagged_model_metrics)]
    errs["bootstrap_bagged"] = held("(b) bagged-model metrics, card vs CPU", bagged(cb), bagged(pb))
    # the 20 features of largest |mean coefficient|: the box pins many at
    # exactly 0.1, so which of those tie-break into the 20 may differ;
    # every feature in both lists is held
    both = sorted(set(cb.important_feature_distributions) & set(pb.important_feature_distributions))
    summary = lambda r: [v for k in both for v in vars(r.important_feature_distributions[k]).values()]
    errs["bootstrap_coefficients"] = held("(b) bootstrap coefficient summaries, card vs CPU",
                                          summary(cb), summary(pb))
    return errs


def write_glm_avro(ds, path, names):
    """A HostDataset as TrainingExampleAvro rows (the ``features`` section),
    each record encoded by hand as avro.write_datum would encode it."""
    from photon_ml_tpu_torch.io import schemas

    pack = struct.Struct("<d").pack
    keys = [_avro_str(n) + b"\x00" for n in names]  # the name, the empty term
    vals = ds.values.tolist()
    idx = ds.indices.tolist()
    ptr = ds.indptr.tolist()
    labels = ds.labels.tolist()
    encoded = []
    for r in range(ds.num_rows):
        lo, hi = ptr[r], ptr[r + 1]
        feats = _avro_long(hi - lo) + b"".join(keys[idx[k]] + pack(vals[k]) for k in range(lo, hi))
        encoded.append(b"\x02" + _avro_str(str(r)) + pack(labels[r]) + feats + b"\x00"
                       + b"\x00\x00\x00")
    _write_avro(path, encoded, schemas.TRAINING_EXAMPLE)


def phase_glm_diagnostics(torch, fused_glm, workdir, dev="cuda"):
    """Phase 18 (run right after phase 6, on its LIBSVM pair: 262144 x 511
    + intercept, 8192 validation rows): (a) the README's GLM quickstart,
    flags verbatim (--diagnostic-mode VALIDATE), then its solver flags with
    box constraints of +-0.1 on every coefficient under LBFGS (L2) and
    OWL-QN (L1); (b) --diagnostic-mode ALL, TRON and the box, twice on the
    card (the second run's bytes equal the first's, timestamps apart) and
    once on the CPU (objectives, coefficients, diagnostics records, fitting
    curves and bootstrap summaries held at the solver tolerance); in every
    diagnosed run each model's Kendall pair counts and Hosmer-Lemeshow bin
    counts equal numpy's over the same predictions; (c) the same rows as
    TrainingExampleAvro through --input-file-format AVRO with a
    --selected-features-file naming half the features and
    --summarization-output-dir, then with --offheap-indexmap-dir on an
    OFFHEAP index that cli.feature_indexing built from them."""
    from photon_ml_tpu_torch.cli import feature_indexing
    from photon_ml_tpu_torch.diagnostics import fitting
    from photon_ml_tpu_torch.io import avro_data
    from photon_ml_tpu_torch.io.libsvm import read_libsvm
    from photon_ml_tpu_torch.io.offheap import OffHeapIndexMap
    from photon_ml_tpu_torch.utils import prng

    say("== phase 18: the GLM driver's diagnostics, box constraints and Avro input on phase 6's "
        "data: (a) the README quickstart (VALIDATE), then LBFGS and OWL-QN in a box, (b) ALL + "
        "TRON + box, twice on the card and once on the CPU, (c) Avro with selected features and "
        "summaries, then an off-heap index")
    if dev == "cuda":
        say(f"  nvidia-smi: {card_line()}")
    io = lambda out, device=dev: [
        "--training-data-directory", os.path.join(workdir, "train"),
        "--validating-data-directory", os.path.join(workdir, "validate"),
        "--output-directory", os.path.join(workdir, out), "--device", device]
    out = {}

    # (a) the README quickstart
    driver, wall, launches, returned, _ = run_glm_stages(torch, fused_glm, io("readme") + README_GLM_FLAGS)
    check(launches["grid"] > 0, "(a): the lambda grid launched no fused kernel")
    _check_diagnosed(driver, os.path.join(workdir, "readme"), "(a)", "VALIDATE", dev)
    _plain_counts(returned, "(a)")
    spans = {k: v for k, v in driver.timer.totals.items()}
    say(f"  (a) README quickstart: wall {wall:.2f} s; fused launches {launches}; Kendall and HL "
        f"counts of the 3 models = numpy's; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(spans.items())))
    out["readme"] = {"wall_s": wall, "launches": launches, "spans_s": spans}
    # its solver flags in the box: LBFGS with L2, OWL-QN with L1. The box
    # shows in the objective: above the free solve's at every lambda (the
    # quickstart's for L2; a free L1 run for OWL-QN). A line search that
    # backs off a clipped trial point can leave LBFGS's coefficients an ulp
    # inside the bound, as in the JAX package, so binding is not counted
    free_l1, _, launches, _, _ = run_glm_stages(
        torch, fused_glm, io("owlqn-free") + [f if f != "L2" else "L1" for f in README_GLM_FLAGS[:-2]])
    out["owlqn-free"] = {"launches": launches}
    bounded = README_GLM_FLAGS[:-2] + ["--coefficient-box-constraints", GLM_BOX]
    for tag, flags, free in (("lbfgs-box", bounded, driver),
                             ("owlqn-box", [f if f != "L2" else "L1" for f in bounded], free_l1)):
        boxed, wall, launches, _, _ = run_glm_stages(torch, fused_glm, io(tag) + flags)
        check(launches["grid"] > 0, f"(a) {tag}: the lambda grid launched no fused kernel")
        check(boxed.device.type == dev, f"(a) {tag}: the driver ran off the {dev} device")
        on_bound = _check_box(boxed, f"(a) {tag}")
        values = [float(r.value) for r in boxed.trained.results]
        unboxed = [float(r.value) for r in free.trained.results]
        check(boxed.trained.weights == free.trained.weights
              and all(v > f for v, f in zip(values, unboxed)),
              f"(a) {tag}: objectives {values} not above the free solves' {unboxed}")
        zeros = [int((m.coefficients.means == 0).sum()) for m in boxed.trained.models]
        say(f"  (a) {tag}: wall {wall:.2f} s; fused launches {launches}; every coefficient of the "
            f"3 solves in [-{BOX_BOUND}, {BOX_BOUND}], on the bound {on_bound}; iterations "
            f"{[int(r.iterations) for r in boxed.trained.results]}; objectives "
            + " ".join(f"{v:.6g}" for v in values) + " (free " + " ".join(f"{v:.6g}" for v in unboxed)
            + f"); zero coefficients {zeros}")
        out[tag] = {"wall_s": wall, "launches": launches}

    # (b) ALL + TRON + box, twice on the card, once on the CPU
    runs = []
    for tag in ("all", "all-again"):
        runs.append(run_glm_stages(torch, fused_glm, io(tag) + DIAG_FLAGS)
                    + (os.path.join(workdir, tag),))
    driver, wall, launches, returned, drawn, path = runs[0]
    check(launches["grid"] > 0 and launches["fitting"] > 0,
          f"(b): fused launches by stage {launches}: the grid and the fitting prefixes must launch")
    check(launches["bootstrap"] == 0, "(b): the bootstrap launched the fused kernel")
    _check_diagnosed(driver, path, "(b)", "ALL", dev)
    check(all(_check_box(driver, "(b)")), "(b): the box binds nothing in a solve")
    card_counts = _plain_counts(returned, "(b)")
    n = driver.train_batch.num_rows
    check(len(drawn) == 1 and drawn[0].device.type == dev and torch.equal(
        drawn[0].cpu(), torch.from_numpy(prng.bootstrap_counts(0, BOOTSTRAP_SAMPLES, n))),
        "(b): the bootstrap's counts on the card are not the host draw")
    tags = fitting.partition_tags(0, n)
    present = driver.train_batch.weights.cpu().numpy() > 0
    want_portions = [100.0 * float(np.sum((tags <= t) & present)) / float(present.sum())
                     for t in range(fitting.NUM_TRAINING_PARTITIONS - 1)]
    curves = [c for report in returned["fitting"].values() for c in report.metrics.values()]
    check(curves and all(portions == want_portions for portions, _, _ in curves),
          "(b): the fitting prefixes are not the host tags'")
    _, wall2, launches2, _, _, path2 = runs[1]
    check(launches2 == launches, f"(b): launches differ between runs {launches} {launches2}")
    for sub in ("output", "best"):
        check(tree_bytes(os.path.join(path, sub)) == tree_bytes(os.path.join(path2, sub)),
              f"(b): two card runs wrote different {sub}/ bytes")
    with open(os.path.join(path, "model-diagnostic.html"), "rb") as a, \
            open(os.path.join(path2, "model-diagnostic.html"), "rb") as b:
        html = a.read()
        check(html == b.read(), "(b): two card runs wrote different model-diagnostic.html bytes")
    for name in ("evaluation-results.avro", "feature-summaries.avro"):
        one = [r.replace("/all/", "/X/") for r in _stripped_records(os.path.join(path, "diagnostics", name))]
        two = [r.replace("/all-again/", "/X/") for r in _stripped_records(os.path.join(path2, "diagnostics", name))]
        check(one == two, f"(b): two card runs wrote different {name} records")
    spans = {k: v for k, v in driver.timer.totals.items()}
    say(f"  (b) ALL + TRON + box: walls {wall:.2f} and {wall2:.2f} s; fused launches {launches}; "
        f"every coefficient of the 3 solves in [-{BOX_BOUND}, {BOX_BOUND}]; bootstrap counts and "
        f"fitting prefixes = the host draw; the second run's output/, best/, HTML ({len(html)} B) "
        f"and records equal the first's; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(spans.items())))
    out["all"] = {"wall_s": [wall, wall2], "launches": launches, "spans_s": spans}
    # card against CPU on the first DIAG_CPU_ROWS training rows (a cut for
    # the call's time): one more card run, then the CPU run, on that subset
    quarter = os.path.join(workdir, "train-quarter")
    os.makedirs(quarter, exist_ok=True)
    with open(os.path.join(workdir, "train", "part-00000.txt")) as f, \
            open(os.path.join(quarter, "part-00000.txt"), "w") as g:
        for _, line in zip(range(DIAG_CPU_ROWS), f):
            g.write(line)
    io_q = lambda out, device: [a if a != os.path.join(workdir, "train") else quarter
                                for a in io(out, device)]
    card_q = run_glm_stages(torch, fused_glm, io_q("all-quarter", dev) + DIAG_FLAGS)
    path_q = os.path.join(workdir, "all-quarter")
    _check_diagnosed(card_q[0], path_q, "(b) quarter", "ALL", dev)
    card_counts = _plain_counts(card_q[3], "(b) quarter")
    cpu = run_glm_stages(torch, fused_glm, io_q("all-cpu", "cpu") + DIAG_FLAGS)
    cpu_path = os.path.join(workdir, "all-cpu")
    check(cpu[2]["total"] == 0, f"(b) CPU: fused launches {cpu[2]}")
    _check_diagnosed(cpu[0], cpu_path, "(b) CPU", "ALL", "cpu")
    check(all(_check_box(cpu[0], "(b) CPU")), "(b) CPU: the box binds nothing in a solve")
    cpu_counts = _plain_counts(cpu[3], "(b) CPU")
    errs = _diagnostics_held(card_q[:5], cpu, path_q, cpu_path)
    moved = [int(np.abs(np.subtract(a, b)).sum()) for i in range(2)
             for a, b in zip(card_counts[i], cpu_counts[i])]
    say(f"  (b) card and CPU on the first {DIAG_CPU_ROWS} training rows: card wall "
        f"{card_q[1]:.2f} s, CPU wall {cpu[1]:.2f} s; card vs CPU within the solver tolerance, largest "
        f"|diff| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; Kendall counts moved by {moved[:3]} pairs and HL bin counts by {moved[3:]} rows "
        f"per model (each run's counts = numpy's on its own predictions)")
    out["all"].update(cpu_wall_s=cpu[1], cpu_abs_err=errs)

    # (c) Avro input: selected features and summaries, then an off-heap index;
    # the training split is (b)'s subset (a cut for the call's time)
    names = [f"f{j}" for j in range(GLM_DRIVER_D)]
    t0 = time.perf_counter()
    for split, src in (("train", quarter), ("validate", os.path.join(workdir, "validate"))):
        ds = read_libsvm(os.path.join(src, "part-00000.txt"), dim=len(names),
                         add_intercept=False)
        write_glm_avro(ds, os.path.join(workdir, f"avro-{split}", "part-00000.avro"), names)
    selected = os.path.join(workdir, "selected-features.txt")
    with open(selected, "w") as f:
        f.write("\n".join(names[::2]) + "\n")
    say(f"  (c) TrainingExampleAvro copy written in {time.perf_counter() - t0:.2f} s")
    avro_io = lambda tag: ["--training-data-directory", os.path.join(workdir, "avro-train"),
                           "--validating-data-directory", os.path.join(workdir, "avro-validate"),
                           "--output-directory", os.path.join(workdir, tag), "--device", dev]
    flags = [f if f != "LIBSVM" else "AVRO" for f in README_GLM_FLAGS[:-2]]
    avro_data.ingest_counts.update(native_files=0, row_loop_files=0, rejected_files=0)
    driver, wall, launches, _, _ = run_glm_stages(torch, fused_glm, avro_io("avro") + flags + [
        "--selected-features-file", selected,
        "--summarization-output-dir", os.path.join(workdir, "summary")])
    counts = dict(avro_data.ingest_counts)
    check(counts["row_loop_files"] == 0 and counts["native_files"] > 0,
          f"(c): Avro files by path {counts}: the native decoder must read every file")
    check(launches["grid"] > 0, "(c): the Avro run launched no fused kernel")
    check(len(driver.index_map) == len(names[::2]) + 1, f"(c): {len(driver.index_map)} features")
    summary = _stripped_records(os.path.join(workdir, "summary", "part-00000.avro"))
    check(len(summary) == len(names[::2]) + 1, f"(c): {len(summary)} summary records")
    say(f"  (c) Avro + selected features: {len(driver.index_map)} features, wall {wall:.2f} s, "
        f"fused launches {launches}, {len(summary)} summary records, Avro files read natively "
        f"{counts['native_files']}")
    out["avro"] = {"wall_s": wall, "launches": launches}
    idx = os.path.join(workdir, "glm-index")
    feature_indexing.main(["--data-input-dirs", os.path.join(workdir, "avro-train"),
                           "--output-dir", idx, "--partition-num", "8", "--format", "OFFHEAP",
                           "--feature-shard-id-to-feature-section-keys-map", "global:features"])
    full, wall_f, launches_f, _, _ = run_glm_stages(torch, fused_glm, avro_io("avro-full") + flags)
    off, wall_o, launches_o, _, _ = run_glm_stages(torch, fused_glm, avro_io("avro-offheap") + flags + [
        "--offheap-indexmap-dir", os.path.join(idx, "global")])
    check(isinstance(off.index_map, OffHeapIndexMap), "(c): the run did not use the off-heap map")
    check(len(off.index_map) == len(full.index_map) == len(names) + 1, "(c): off-heap map width")
    check(launches_o["grid"] > 0, "(c): the off-heap run launched no fused kernel")
    worst = 0.0
    for (lam, a), (_, b) in zip(full.models, off.models):
        wa, wb = a.means_as_numpy(), b.means_as_numpy()
        for j in range(len(full.index_map)):
            key = full.index_map.get_feature_name(j)
            d = abs(float(wa[j]) - float(wb[off.index_map.get_index(key)]))
            worst = max(worst, d / (1e-2 * abs(float(wa[j])) + 2e-3))
    check(worst <= 1.0, f"(c): off-heap and in-memory models apart by {worst:.3f} of the solver tolerance")
    say(f"  (c) --offheap-indexmap-dir (8 partitions): wall {wall_o:.2f} s (in-memory map "
        f"{wall_f:.2f} s); fused launches {launches_o}; models equal by feature name within the "
        f"solver tolerance (worst {worst:.3f} of it)")
    out["offheap"] = {"wall_s": wall_o, "launches": launches_o, "in_memory_wall_s": wall_f,
                      "in_memory_launches": launches_f}
    out["launches_total"] = sum(launches["total"] for launches in (
        out["readme"]["launches"], out["owlqn-free"]["launches"], out["lbfgs-box"]["launches"],
        out["owlqn-box"]["launches"],
        out["all"]["launches"], launches2, out["avro"]["launches"], launches_f, launches_o))
    return out


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


PROFILE_ATTEMPTS = 3


def launches_of_one_call(torch, fn):
    """The device kernels and the aten operators of one call, by
    torch.profiler, and the number of traced calls it took. CUPTI now and
    then delivers no device record at all for a session (a trace with the
    call's aten operators and no device event of any kind); such a session
    shows nothing about the call, so the call is traced again in a fresh
    session, up to PROFILE_ATTEMPTS calls. A trace that holds device events
    is taken as it is."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(torch)
        events = prof.events()
        kernels = [ev.name for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
        ops = sorted({ev.name for ev in events if ev.name.startswith("aten::")})
        if kernels:
            break
    return kernels, ops, attempt


def phase_sparse_times(torch, fused_sparse, losses):
    """Phase 8: each sparse kernel's call (``fused_value_grad_parts``,
    ``fused_hvp_parts``) at the full-width shape and at the GAME driver's
    slab shape (logistic, f32), by both methods (per-launch CUDA events,
    CUDA-graph replay) and the host clock, twice each, beside its bound,
    its tables' bytes, the plain version's time (context only) and the
    dense incumbent's (the objective on the (E, M, D) stack: the sparse
    race's baseline, in torch ops). One call's launches are counted by
    torch.profiler and by the wrappers' counts."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective

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
        obj, norm = GLMObjective(loss), NormalizationContext.identity()
        dense = GLMBatch(DenseFeatures(slab.to_dense()), y, off, wt)
        library = {
            "gevm": lambda: obj.value_and_grad(w, dense, norm),
            "hvp": lambda: obj.hessian_vector(w, v, dense, norm),
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
            kernels, ops, traced = launches_of_one_call(torch, calls[name])
            check(counter.launches == before + traced,
                  f"{name}: {traced} traced call(s) did not count {traced} launch(es)")
            check(not any(op in ops for op in ("aten::add", "aten::constant_pad_nd", "aten::pad")),
                  f"{name}: one call ran row-sum operators {ops}")
            check(kernels, f"{name}: torch.profiler recorded no device kernel in {traced} "
                           "traced calls (CUPTI traced nothing), so the launch count cannot be "
                           "shown")
            check(len(kernels) == 1, f"{name}: one call launched {len(kernels)} device kernels")
            say(f"    {name}: one call = {len(kernels)} device kernel(s) by torch.profiler "
                f"{sorted(set(kernels))}, launch count +1, aten ops {ops}"
                + (f" (traced on call {traced}: CUPTI recorded no device event for the "
                   f"{traced - 1} before)" if traced > 1 else ""))
            ev, gr, ho = [], [], []
            for _ in range(2):
                ev.append(time_ms(torch, calls[name]))
                gr.append(graph_ms(torch, calls[name]))
                ho.append(host_ms(torch, calls[name]))
            plain_ms = time_ms(torch, plain[name])
            library_ms = time_ms(torch, library[name])
            bytes_ms, ops_ms = nbytes[name] / MEM_RATE * 1e3, flops[name] / FP32_RATE * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            ms, graph = statistics.median(ev), statistics.median(gr)
            r = {"ms": ms, "ms_runs": ev, "graph_ms": graph, "graph_ms_runs": gr,
                 "host_ms": statistics.median(ho),
                 "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "bytes": nbytes[name], "flops": flops[name], "share_of_bound": bound_ms / ms,
                 "share_of_bound_graph": bound_ms / graph, "table_bytes": tables.nbytes,
                 "design_bytes_ms": (nbytes[name] + tables.nbytes) / MEM_RATE * 1e3,
                 "device_kernels_per_call": len(kernels), "profiled_calls": traced, "shape": shape,
                 "plan": dataclasses.asdict(plan)}
            say(f"    {name}: call {' / '.join(f'{x:.5f}' for x in ev)} ms (graph "
                f"{' / '.join(f'{x:.5f}' for x in gr)} ms; host "
                f"{' / '.join(f'{x:.5f}' for x in ho)} ms)   plain {plain_ms:.4f} ms "
                f"(context only)   dense incumbent {library_ms:.4f} ms   bound {bound_ms:.5f} ms = {nbytes[name]} B / "
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


def write_game_avro(workdir, num_users, seed, wide=None, rows_per_user=None, parts=1):
    """bench.py's GAME data as TrainingExampleAvro with two feature sections,
    each user's rows split 80/20 into train/ and validate/. ``wide=(names,
    per_row)`` widens the fixed section: each row carries ``per_row`` of
    ``names`` feature names instead of the dense d_fixed. ``rows_per_user``
    replaces bench.py's 8-15 rows a user. ``parts`` splits each directory's
    rows, in order, over that many part files (the same rows in the same
    global order)."""
    rng = np.random.default_rng(seed)
    if rows_per_user is None:
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

    def records(sel):
        rows = np.nonzero(sel)[0]
        return _game_records([str(r) for r in rows], y[rows], x_f[rows], cols[rows], x_r[rows],
                             [f"user{u}" for u in user[rows]],
                             wide[0] if wide else d_fixed)

    for name, sel in (("train", ~validate), ("validate", validate)):
        encoded = records(sel)
        bounds = np.linspace(0, len(encoded), parts + 1).astype(int)
        for i in range(parts):
            _write_avro(os.path.join(workdir, name, f"part-{i:05d}.avro"),
                        encoded[bounds[i]:bounds[i + 1]], _game_schema())
    return int((~validate).sum()), int(validate.sum())


def _game_schema():
    from photon_ml_tpu_torch.io import schemas

    return {
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


def _game_records(uids, y, x_f, cols, x_r, users, n_fixed_names):
    """The records of ``_game_schema``, each encoded by hand as
    avro.write_datum would encode it (the generic encoder took a minute for
    phase 10's rows on the card's host): row i has the fixed features
    ``f{cols[i, j]}`` valued ``x_f[i, j]``, the user features ``u0..u7`` and
    ``userId`` ``users[i]`` in its metadataMap."""
    pack = struct.Struct("<d").pack
    fixed_keys = [_avro_str(f"f{j}") + b"\x00" for j in range(n_fixed_names)]
    user_keys = [_avro_str(f"u{j}") + b"\x00" for j in range(GAME_D_RANDOM)]
    user_ids = _avro_str("userId")

    def features(keys, cols_r, x_r_):  # one block of named features, the empty term
        return (_avro_long(len(x_r_)) + b"".join(keys[c] + pack(v) for c, v in zip(cols_r, x_r_))
                + b"\x00")

    xf, xr, cf = x_f.tolist(), x_r.tolist(), cols.tolist()
    return [b"\x02" + _avro_str(uid) + pack(float(y[i])) + features(fixed_keys, cf[i], xf[i])
            + features(user_keys, range(GAME_D_RANDOM), xr[i]) + b"\x02\x02" + user_ids
            + _avro_str(users[i]) + b"\x00" for i, uid in enumerate(uids)]


def write_delta_avro(path, user_rows, rng):
    """One more training part file of phase 20's schema and feature names
    (``f0..f31``, ``u0..u7``): ``user_rows`` maps a raw user id to its count
    of new rows, drawn from ``rng`` as write_game_avro draws (a logistic
    model with 15% of the labels flipped)."""
    users = [u for u, k in user_rows.items() for _ in range(k)]
    n = len(users)
    x_f = rng.normal(size=(n, GAME_D_FIXED)).astype(np.float32)
    x_r = rng.normal(size=(n, GAME_D_RANDOM)).astype(np.float32)
    w_f = rng.normal(size=GAME_D_FIXED).astype(np.float32)
    w_u = (rng.normal(size=(n, GAME_D_RANDOM)) * 1.5).astype(np.float32)
    margin = x_f @ w_f + np.sum(x_r * w_u, axis=1)
    y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    flip = rng.random(n) < 0.15
    y[flip] = 1.0 - y[flip]
    cols = np.broadcast_to(np.arange(GAME_D_FIXED), (n, GAME_D_FIXED))
    _write_avro(path, _game_records([f"delta{r}" for r in range(n)], y, x_f, cols, x_r, users,
                                    GAME_D_FIXED), _game_schema())
    return n


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
    launches of the three kernels, stages, ingest counts). Fails unless the
    native decoder read every file."""
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.io import avro_data
    from photon_ml_tpu_torch.ops import fused_glm

    os.environ["PHOTON_SPARSE_KERNEL"] = spec
    sync(torch)
    for c in (fused_sparse.sparse_gevm_kernel, fused_sparse.sparse_hvp_kernel,
              fused_glm.fused_value_grad_kernel):
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
                "hvp": fused_sparse.sparse_hvp_kernel.launches,
                "fused_glm": fused_glm.fused_value_grad_kernel.launches}
    counts = dict(avro_data.ingest_counts)
    if driver.delta_plan is not None and driver.delta_plan.short_circuit:
        # the prior model copied forward: no ingest at all
        check(not any(counts.values()), f"spec {spec}: a short-circuited run read Avro files "
                                        f"{counts}")
    else:
        check(counts["row_loop_files"] == 0 and counts["rejected_files"] == 0
              and counts["native_files"] > 0,
              f"spec {spec}: Avro files by path {counts}: the native decoder must read every "
              "file")
    tot = driver.timer.totals
    # the grid path's validation runs inside its "(grid)" span
    validate = sum(r.timings.get("(validation)", 0.0) for _, r, _ in driver.results)
    stages = {"preprocess": tot.get("prepare-feature-maps", 0.0) + tot.get("prepare-datasets", 0.0),
              "train": tot.get("train", 0.0) - validate, "validate": validate,
              "save": tot.get("save", 0.0)}
    return driver, wall, launches, stages, counts


def phase_game_driver(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 10: cli.game_training_driver.main end to end (the README
    quickstart's flags without --checkpoint-dir) with
    PHOTON_SPARSE_KERNEL=pallas, then off; every Avro file read by the
    native decoder; model layout, validation AUC and objective histories
    checked; the sparse kernels on the driver's slab and the fused kernel on
    its fixed batch held against their plain versions. Returns the run's
    numbers and the pallas run's driver."""
    from photon_ml_tpu_torch.ops import fused_glm

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
            + f"; GEVM launches {launches['gevm']}, HVP {launches['hvp']}, fused dense "
            f"{launches['fused_glm']}; entities "
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
    fixed_err = hold_driver_fixed(torch, fused_glm, drivers["pallas"].combo_coords[0]["fixed"],
                                  "phase 10")
    (res_k, launches_k, *_), (res_p, launches_p, *_) = runs["pallas"], runs["off"]
    kernels_launched(drivers["pallas"], launches_k, "the pallas driver run")
    check(launches_p["gevm"] == launches_p["hvp"] == 0,
          "the off driver run launched a sparse kernel")
    check((launches_p["fused_glm"] > 0) == (launches_k["fused_glm"] > 0),
          "the off driver run's dense fixed effect did not follow the dense race")
    for a, b in zip(res_k.objective_history, res_p.objective_history):
        check(abs(a - b) <= 1e-2 * abs(b) + 2e-3, f"objective histories differ: {a} vs {b}")
    say("  objective histories of the pallas and off runs agree within the solver tolerance")
    out = {spec: {"launches": r[1], "stages_s": r[2], "wall_s": r[3], "auc": r[4]}
           for spec, r in runs.items()}
    out["max_abs_err"] = held
    out["fixed_max_abs_err"] = fixed_err
    return out, drivers["pallas"]


def phase_ingest(workdir, trained):
    """Phase 11 (run after phase 17): read_game_data on the validation rows of
    phase 17's data (phase 10's generator at CHECKPOINT_USERS users; a cut,
    see CUTS) natively and through the Python row loop
    (PHOTON_ML_TPU_NATIVE=0), every array byte-equal."""
    from photon_ml_tpu_torch.io import avro_data

    val_dir = os.path.join(workdir, "ck17-data", "validate")
    say("== phase 11: read_game_data on phase 17's validation dir, native decoder against the "
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

def hold_driver_fixed(torch, fused_glm, coord, label):
    """The fused kernel on a GAME driver's own dense fixed-effect batch as
    the coordinate's update hands it to the objective: the base offsets plus
    a random residual, the weights after the coordinate's down-sampling (its
    rate, the driver's key), at random coefficients; held against the plain
    version at phase 3's tolerance."""
    from photon_ml_tpu_torch.algorithm.fixed_effect import DOWN_SAMPLING_SEED
    from photon_ml_tpu_torch.data.sampler import maybe_down_sample
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.ops.objective import GLMBatch

    b, task = coord.batch, coord.problem.task
    x = b.features.matrix
    n, d = x.shape
    g = torch.Generator(device=x.device).manual_seed(SEED + 31)
    resid = 0.5 * torch.randn((n,), device=x.device, generator=g)
    # the multihost driver's row-block coordinate does not down-sample
    batch = maybe_down_sample(GLMBatch(b.features, b.labels, b.offsets + resid, b.weights),
                              task, getattr(coord, "down_sampling_rate", None),
                              DOWN_SAMPLING_SEED)
    w = 0.3 * torch.randn((d,), device=x.device, generator=g)
    zero = int((batch.weights == 0).sum())
    return hold_fused(torch, fused_glm,
                      (losses.for_task(task), x, batch.labels, batch.weights, batch.offsets, w),
                      1e-5 if x.dtype == torch.float32 else 1e-3,
                      f"{label}: the driver's fixed batch N={n} D={d} {str(x.dtype)[6:]}, "
                      f"{zero} rows at weight 0")


def kernels_launched(driver, launches, label):
    """A GAME driver run on the card launched its path's kernels: the GEVM
    kernel, and the fused dense kernel, which the dense race chose for the
    driver's fixed effect (``fused_block_rows`` set; it chose the kernel at
    every shape measured so far)."""
    fixed = driver.combo_coords[0]["fixed"]
    check(fixed.problem.fused_block_rows is not None,
          f"{label}: the dense race chose the matmul path for the fixed effect")
    check(launches["gevm"] > 0 and launches["fused_glm"] > 0,
          f"{label}: a kernel of the path did not launch: {launches}")


def coordinate_scores(driver, result):
    """Each coordinate's training scores at the run's final parameters, and
    the total, on the host in float64."""
    coords = driver.combo_coords[0]
    out = {name: coords[name].score(result.coefficients[name]) for name in coords}
    out["(total)"] = result.total_scores
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def lane_iterations(tracker):
    """A random effect's per-lane iterations as numpy (a bucketed one's
    buckets concatenated), None for any other tracker."""
    if isinstance(tracker, tuple) and not hasattr(tracker, "iterations"):
        parts = [lane_iterations(t) for t in tracker]
        return None if not parts or any(p_ is None for p_ in parts) else np.concatenate(parts)
    it = getattr(tracker, "iterations", None)
    return None if it is None or it.ndim != 1 else it.cpu().numpy()


def scores_held(label, card, cpu, what="card vs CPU"):
    """Every coordinate's training scores and the total, card (driver,
    result) against CPU. The fixed effect's are held row by row at the
    solver tolerance. A per-entity coordinate solves each entity as an f32
    LBFGS lane that stops when its objective's change falls below the
    tolerance; card and CPU sum in different orders, so 2-14% of the lanes
    stop an iteration apart and a few hundred rows' scores part by up to
    0.2 while the lanes' objectives agree within 1e-4 relative (PERF.md,
    PR 8). Those coordinates and the total are held by the norm of the
    difference over the CPU's norm, within the solver's relative tolerance;
    the rows outside the elementwise tolerance and the lanes whose last
    solve stopped apart (where both runs lay the lanes out alike) are
    printed. ``what`` names the pair. Returns the numbers per coordinate."""
    from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate

    (card_driver, card_res), (cpu_driver, cpu_res) = card, cpu
    sc, sp = coordinate_scores(card_driver, card_res), coordinate_scores(cpu_driver, cpu_res)
    check(sorted(sc) == sorted(sp), f"{label}: coordinates {sorted(sc)} vs {sorted(sp)}")
    coords = card_driver.combo_coords[0]
    out = {}
    for name in sc:
        a, b = sc[name], sp[name]
        diff = np.abs(a - b)
        outside = int((diff > SOLVER_ATOL + SOLVER_RTOL * np.abs(b)).sum())
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        apart = None
        ta, tb = (r.trackers.get(name) for r in (card_res, cpu_res))
        # lanes line up only between two runs of one layout (bucketed or not)
        if name in coords and type(ta) is type(tb) and len(ta) == len(tb):
            ia, ib = lane_iterations(ta), lane_iterations(tb)
            if ia is not None and ib is not None and ia.shape == ib.shape:
                apart = int((ia != ib).sum())
        if isinstance(coords.get(name), FixedEffectCoordinate):
            held(f"{label}: {name} scores, {what}", a, b)
            how = "elementwise"
        else:
            check(rel <= SOLVER_RTOL, f"{label}: {name} scores, {what}: |diff| / |ref| "
                                      f"{rel:.3g} > {SOLVER_RTOL}")
            how = "in norm"
        say(f"  {label} {name} scores {what}, held {how}: max |diff| {diff.max():.4g}, "
            f"|diff| / |ref| {rel:.3g}, rows outside the elementwise tolerance {outside} of "
            f"{a.size}" + ("" if apart is None else
                           f", lanes whose last solve stopped apart {apart}"))
        out[name] = {"max_abs_diff": float(diff.max()), "rel_norm": rel,
                     "rows_outside_elementwise": outside, "lanes_stopped_apart": apart}
    return out


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
# phase 16's card-against-CPU pair runs at this depth (users), the same
# generator and widths: the CPU run at GAME_USERS took 65 s of the call
WIDE_CPU_USERS = 2000
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
    solve converges; at WIDE_CPU_USERS users two card runs write byte-equal
    models (the first gives the timings) and the objective history on the
    card holds against the same command on the CPU. The first fixed solve of that
    pair then runs again on each side's batch at the quickstart's own cap of
    50, a witness of how far two unconverged trajectories part (printed, not
    held)."""
    from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
    from photon_ml_tpu_torch.ops.features import SparseFeatures
    from photon_ml_tpu_torch.types import ConvergenceReason

    say(f"== phase 16: game_training_driver.main, phase 10's data with the fixed section "
        f"widened to {FIXED_WIDE_PER_ROW} of {FIXED_WIDE_NAMES} names a row, the quickstart's "
        f"flags with the fixed effect's cap raised to {FIXED_WIDE_ITERS} LBFGS iterations (L2 "
        f"lambda 0.01), spec pallas; at {WIDE_CPU_USERS} users twice on {dev} and once on the "
        "CPU, and the first fixed solve of the card and CPU pair at the quickstart's cap of 50 "
        "on each")
    small = os.path.join(workdir, "small")
    for users, where, seed in ((WIDE_CPU_USERS, small, SEED + 17),):
        t0 = time.perf_counter()
        n_train, n_val = write_game_avro(where, users, seed,
                                         wide=(FIXED_WIDE_NAMES, FIXED_WIDE_PER_ROW))
        say(f"  Avro written in {time.perf_counter() - t0:.1f} s: {users} users, {n_train} "
            f"train rows, {n_val} validation rows")
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
        for label, device, data in (("card small", dev, small),
                                    ("card small again", dev, small),
                                    ("cpu small", "cpu", small)):
            out = os.path.join(workdir, "out-" + label.replace(" ", "-"))
            argv = ["--train-input-dirs", os.path.join(data, "train"),
                    "--validate-input-dirs", os.path.join(data, "validate"),
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
    check(tree_bytes(os.path.join(runs["card small"][1], "best"))
          == tree_bytes(os.path.join(runs["card small again"][1], "best")),
          "two card runs of the wide GAME driver wrote different model bytes")
    err = held("wide GAME objective history, card vs CPU", runs["card small"][0].objective_history,
               runs["cpu small"][0].objective_history)
    say(f"  at {WIDE_CPU_USERS} users two card runs wrote byte-equal models, and objective "
        f"histories card vs CPU within {err:.3g} (solver tolerance)")
    # the quickstart's own cap, a witness and not held: neither side's first
    # fixed solve converges in 50 iterations, and the two trajectories part
    capped = {}
    for label in ("card small", "cpu small"):
        coord, offsets = runs[label][5]
        problem = dataclasses.replace(coord.problem, optimizer_config=dataclasses.replace(
            coord.problem.optimizer_config, max_iterations=50))
        _, res = FixedEffectCoordinate(coord.batch, problem, coord.norm).update(
            offsets, coord.initial_coefficients())
        capped[label] = float(res.value)
    c, u = capped["card small"], capped["cpu small"]
    say(f"  the first fixed solve at the quickstart's cap of 50 (not converged): card "
        f"{c:.6f}, CPU {u:.6f}, |diff| {abs(c - u):.6f}; run to convergence above: card "
        f"{runs['card small'][0].objective_history[0]:.6f}, CPU "
        f"{runs['cpu small'][0].objective_history[0]:.6f}")
    return {"launches": runs["card small"][2], "wall_s": runs["card small"][3],
            "objective_abs_err": err,
            "fixed_solves": {k: runs[k][4] for k in runs}, "first_solve_cap_50": capped,
            "objective_history": {k: runs[k][0].objective_history for k in runs}}


# phase 17's depth: phase 10's generator and widths at a fifth of its users
# (each of its ten driver runs is mostly Avro ingest, which scales with rows)
CHECKPOINT_USERS = 2000


def stopped_in_process(torch, fused_sparse, argv, spec, at):
    """A training-driver run in this process under PHOTON_PREEMPT_AT=``at``
    (``site:N``); returns the code of the SystemExit it ended with (75 for
    a preemption), None when it ran to its end."""
    from photon_ml_tpu_torch.resilience import preemption

    preemption.reset()
    os.environ["PHOTON_PREEMPT_AT"] = at
    try:
        run_game_training(torch, fused_sparse, argv, spec)
    except SystemExit as e:
        return e.code
    finally:
        del os.environ["PHOTON_PREEMPT_AT"]
        preemption.reset()
    return None


def phase_checkpoints(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 17: phase 10's command with --checkpoint-dir on phase 10's
    generator at CHECKPOINT_USERS users under spec pallas and spec scatter:
    an uninterrupted run (the checkpoint's bytes and save time per step),
    and a run stopped by PHOTON_PREEMPT_AT (exit 75: a subprocess under
    pallas, started first and run beside this process's runs, in-process
    under scatter) and resumed; under pallas also --checkpoint-async true,
    and --max-restarts 1 with an injected preemption; every run's model
    bytes equal the uninterrupted run's. Then the same pair under spec auto
    (``checkpoints_under_auto``)."""
    say("== phase 17: checkpoints and preemption: phase 10's command with --checkpoint-dir on "
        f"phase 10's generator at {CHECKPOINT_USERS} users, spec pallas, scatter, then auto")
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(workdir, "ck17-data")
    t0 = time.perf_counter()
    n_train, n_val = write_game_avro(data, CHECKPOINT_USERS, SEED + 170)
    say(f"  Avro written in {time.perf_counter() - t0:.1f} s: {CHECKPOINT_USERS} users, "
        f"{n_train} train rows, {n_val} validation rows")
    base = ["--train-input-dirs", os.path.join(data, "train"),
            "--validate-input-dirs", os.path.join(data, "validate"),
            "--device", dev, "--delete-output-dir-if-exists", "true"] + GAME_FLAGS
    # spec pallas's stopped run is a process of its own (the exit code 75 a
    # supervisor reads); it runs beside this process's runs (a cut, see CUTS)
    sub_argv = lambda spec: base + ["--output-dir", os.path.join(workdir, f"ck17-{spec}-sub"),
                                    "--checkpoint-dir", os.path.join(workdir, f"ck17-{spec}-ck-sub")]
    sub_err = tempfile.TemporaryFile("w+")
    t_sub = time.perf_counter()
    sub_proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
         *sub_argv("pallas")], cwd=here, stdout=subprocess.DEVNULL, stderr=sub_err, text=True,
        env=dict(os.environ, PHOTON_SPARSE_KERNEL="pallas", PHOTON_PREEMPT_AT="cycle:2"))
    try:
        return _checkpoints(torch, fused_sparse, workdir, base, sub_argv, sub_proc, sub_err,
                            t_sub)
    finally:
        if sub_proc.poll() is None:
            sub_proc.kill()
            sub_proc.wait()
        sub_err.close()


def _checkpoints(torch, fused_sparse, workdir, base, sub_argv, sub_proc, sub_err, t_sub):
    """Phase 17's runs, beside spec pallas's stopped subprocess."""
    from photon_ml_tpu_torch import checkpoint
    from photon_ml_tpu_torch.resilience import preemption

    out = {}
    # scatter first and pallas's resume last: the pallas subprocess runs
    # beside every in-process run before its resume
    for spec in ("scatter", "pallas"):
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

        extra = {}
        if spec == "pallas":
            # the async commit and the in-process restart, before the
            # subprocess's resume (they do not depend on the solve family:
            # they run under pallas only, cut for time)
            preemption.reset()
            _, wall_a, _, _, _ = run_game_training(
                torch, fused_sparse, base + ["--output-dir", tag("async"), "--checkpoint-dir",
                                             tag("ck-async"), "--checkpoint-async", "true"], spec)
            check(tree_bytes(os.path.join(tag("async"), "best")) == want,
                  f"spec {spec}: the async run's model bytes differ")
            preemption.reset()
            os.environ["PHOTON_PREEMPT_AT"] = "cycle:3"
            try:
                _, wall_m, _, _, _ = run_game_training(
                    torch, fused_sparse, base + ["--output-dir", tag("restart"),
                                                 "--checkpoint-dir", tag("ck-restart"),
                                                 "--max-restarts", "1"], spec)
            finally:
                del os.environ["PHOTON_PREEMPT_AT"]
                preemption.reset()
            check(tree_bytes(os.path.join(tag("restart"), "best")) == want,
                  f"spec {spec}: the restarted run's model bytes differ")
            say(f"  spec {spec}: --checkpoint-async true {wall_a:.2f} s and --max-restarts 1 with "
                f"a preemption at step 3 {wall_m:.2f} s: model bytes equal to the uninterrupted "
                "run's")
            extra = {"async_s": wall_a, "restart_s": wall_m}
        else:
            say(f"  spec {spec}: --checkpoint-async and --max-restarts runs cut (run under "
                "pallas only)")

        argv = sub_argv(spec)
        t0 = time.perf_counter()
        if spec == "pallas":
            code = sub_proc.wait(timeout=600)
            sub_err.seek(0)
            how, detail, t0 = ("subprocess (started first, beside the in-process runs)",
                               sub_err.read()[-2000:], t_sub)
        else:
            code, how, detail = stopped_in_process(torch, fused_sparse, argv, spec,
                                                   "cycle:2"), "in-process run", ""
        sub_s = time.perf_counter() - t0
        check(code == 75, f"spec {spec}: the preempted {how} exited {code}: {detail}")
        kept = sorted(os.listdir(os.path.join(tag("ck-sub"), "combo-0")))
        check(kept[-1] == "step-2", f"spec {spec}: the preempted run kept {kept}")
        preemption.reset()
        resumed, wall_r, launches_r, _, _ = run_game_training(torch, fused_sparse, argv, spec)
        check(tree_bytes(os.path.join(tag("sub"), "best")) == want,
              f"spec {spec}: the resumed run's model bytes differ from the uninterrupted run's")
        check(resumed.results[0][1].objective_history == clean.results[0][1].objective_history,
              f"spec {spec}: the resumed objective history differs")
        say(f"  spec {spec}: {how} stopped at step 2 exited 75 after {sub_s:.2f} s (kept "
            f"{kept}); resumed in {wall_r:.2f} s (GEVM launches {launches_r['gevm']}): model "
            "bytes and objective history equal to the uninterrupted run's")
        out[spec] = {"saves": saves, "wall_s": wall, "subprocess_s": sub_s, "resume_s": wall_r,
                     **extra}
    out["auto"] = checkpoints_under_auto(torch, fused_sparse, workdir, base)
    return out


def checkpoints_under_auto(torch, fused_sparse, workdir, base):
    """Phase 17 under spec auto: the run records its race winners beside
    its checkpoints (races.json) and a resumed run takes them. The stopped
    run (in this process, its race caches emptied first) is handed the
    uninterrupted run's record, and the resume starts with both race caches
    empty: it must race nothing, and its model bytes and objective history
    must equal the uninterrupted run's."""
    from photon_ml_tpu_torch.cli.game_training_driver import RACES_FILE
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.resilience import preemption

    tag = lambda name: os.path.join(workdir, f"ck17-auto-{name}")
    preemption.reset()
    clean, wall, _, _, _ = run_game_training(
        torch, fused_sparse, base + ["--output-dir", tag("out"), "--checkpoint-dir", tag("ck")],
        "auto")
    with open(os.path.join(tag("ck"), RACES_FILE)) as f:
        decisions = json.load(f)
    check({race for race, _, _ in decisions} == {"dense", "sparse"},
          f"spec auto: the recorded race decisions {decisions}")
    os.makedirs(tag("ck-sub"))
    shutil.copy(os.path.join(tag("ck"), RACES_FILE), tag("ck-sub"))
    argv = base + ["--output-dir", tag("sub"), "--checkpoint-dir", tag("ck-sub")]
    # the stopped run starts as a fresh process would: both race caches empty
    fused_sparse._race_cache.clear()
    fused_glm._autotune_cache.clear()
    code = stopped_in_process(torch, fused_sparse, argv, "auto", "cycle:2")
    check(code == 75, f"spec auto: the preempted run exited {code}")
    fused_sparse._race_cache.clear()
    fused_glm._autotune_cache.clear()
    raced = len(fused_sparse.race_reports()), len(fused_glm._autotune_timings)
    preemption.reset()
    resumed, wall_r, _, _, _ = run_game_training(torch, fused_sparse, argv, "auto")
    check((len(fused_sparse.race_reports()), len(fused_glm._autotune_timings)) == raced,
          "spec auto: the resumed run raced instead of taking the recorded winners")
    check(tree_bytes(os.path.join(tag("sub"), "best")) == tree_bytes(os.path.join(tag("out"),
                                                                              "best")),
          "spec auto: the resumed run's model bytes differ from the uninterrupted run's")
    check(resumed.results[0][1].objective_history == clean.results[0][1].objective_history,
          "spec auto: the resumed objective history differs")
    say(f"  spec auto: uninterrupted run {wall:.2f} s recorded {len(decisions)} race decisions "
        f"{decisions}; a run handed them stopped at step 2 (exit 75); resumed in "
        f"{wall_r:.2f} s with empty race caches, racing nothing: model bytes and objective "
        "history equal to the uninterrupted run's")
    return {"wall_s": wall, "resume_s": wall_r, "decisions": decisions}


# the lambda grid of bench.py:2411-2438 on phase 10's data: the fixed
# effect at the first two of its four lambdas (0.01, 0.1, 1, 10; a cut, see
# CUTS), the random effect at 0.1, bench.py's solver caps
GRID_LAMBDAS = ("0.01", "0.1")
GRID_FLAGS = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--feature-shard-id-to-feature-section-keys-map", "global:fixedFeatures|per_user:userFeatures",
    "--updating-sequence", "fixed,per-user",
    "--fixed-effect-data-configurations", "fixed:global,1",
    "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
    "--fixed-effect-optimization-configurations",
    ";".join(f"fixed:30,1e-7,{lam},1,LBFGS,L2" for lam in GRID_LAMBDAS),
    "--random-effect-optimization-configurations", "per-user:20,1e-6,0.1,1,LBFGS,L2",
    "--evaluator-type", "AUC", "--num-iterations", "2", "--model-output-mode", "ALL",
]
# phase 10's command with the fixed effect down-sampled at 0.5 and the
# per-user features chosen by Pearson at a features-to-samples ratio of 0.5
SAMPLING_RATE, PEARSON_RATIO = 0.5, 0.5
SAMPLED_FLAGS = [
    {"fixed:50,1e-7,0.01,1,LBFGS,L2": f"fixed:50,1e-7,0.01,{SAMPLING_RATE},LBFGS,L2",
     "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP":
         f"per-user:userId,per_user,1,-1,-1,{PEARSON_RATIO},INDEX_MAP"}.get(f, f)
    for f in GAME_FLAGS]
# the full GAME model of bench.py:2476-2506 (BASELINE config 5): its data
# (tests/game_test_utils.make_full_game_data, seed 23, 15% labels flipped)
# and tests/game_test_utils.make_full_game_coords' solvers
FULL_USERS, FULL_ITEMS, FULL_ARTISTS = 10000, 2000, 200
FULL_D = {"fixed": 32, "user": 8, "item": 8, "artist": 16}
FULL_SEED, FULL_LATENT = 23, 4
FULL_ITERATIONS = 3  # bench.py:2512
FULL_SECTIONS = {"global": "fixedFeatures", "per_user": "userFeatures",
                 "per_item": "itemFeatures", "per_artist": "artistFeatures"}
FULL_GAME_FLAGS = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--feature-shard-id-to-feature-section-keys-map",
    "|".join(f"{shard}:{sec}" for shard, sec in FULL_SECTIONS.items()),
    "--updating-sequence", "fixed,per-user,per-item,per-artist",
    "--fixed-effect-data-configurations", "fixed:global,1",
    "--random-effect-data-configurations",
    "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP|per-item:itemId,per_item,1,-1,-1,-1,INDEX_MAP"
    "|per-artist:artistId,per_artist,1,-1,-1,-1,IDENTITY",
    "--fixed-effect-optimization-configurations", "fixed:30,1e-7,0.01,1,LBFGS,L2",
    "--random-effect-optimization-configurations",
    "per-user:20,1e-6,0.1,1,LBFGS,L2|per-item:20,1e-6,0.1,1,LBFGS,L2",
    "--factored-random-effect-optimization-configurations",
    f"per-artist:10,1e-6,0,1,LBFGS,NONE:10,1e-6,0,1,LBFGS,NONE:1,{FULL_LATENT}",
    "--evaluator-type", "AUC", "--num-iterations", str(FULL_ITERATIONS),
]


def full_game_arrays(num_users, num_items, num_artists, seed):
    """tests/game_test_utils.make_full_game_data's draws for
    rows_per_user_range (8, 16) and FULL_D, then bench.py's label flips:
    (labels, features by section, user, item and artist of each row,
    rows per user)."""
    rng = np.random.default_rng(seed)
    rows_per_user = rng.integers(8, 16, size=num_users)
    n = int(rows_per_user.sum())
    user = np.repeat(np.arange(num_users, dtype=np.int32), rows_per_user)[rng.permutation(n)]
    item = rng.integers(0, num_items, size=n).astype(np.int32)
    artist_of_item = rng.integers(0, num_artists, size=num_items).astype(np.int32)
    artist = artist_of_item[item]
    x = {k: rng.normal(size=(n, d)).astype(np.float32) for k, d in FULL_D.items()}
    w_fixed = rng.normal(size=FULL_D["fixed"]).astype(np.float32)
    w_users = (rng.normal(size=(num_users, FULL_D["user"])) * 1.2).astype(np.float32)
    w_items = (rng.normal(size=(num_items, FULL_D["item"])) * 1.2).astype(np.float32)
    w_artists = (rng.normal(size=(num_artists, 2)) @ rng.normal(size=(2, FULL_D["artist"]))
                 ).astype(np.float32)
    margin = (x["fixed"] @ w_fixed + np.sum(x["user"] * w_users[user], axis=1)
              + np.sum(x["item"] * w_items[item], axis=1)
              + np.sum(x["artist"] * w_artists[artist], axis=1))
    y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    flip = rng.random(n) < 0.15
    y[flip] = 1.0 - y[flip]
    return y, x, user, item, artist, rows_per_user


def write_full_game_avro(workdir, num_users, num_items, num_artists, seed):
    """The full GAME data as Avro with four feature sections and the three
    ids in metadataMap, each user's rows split 80/20 into train/ and
    validate/ as write_game_avro splits them."""
    from photon_ml_tpu_torch.io import schemas

    y, x, user, item, artist, rows_per_user = full_game_arrays(num_users, num_items,
                                                               num_artists, seed)
    n = len(y)
    rank = np.zeros(n, np.int64)
    order = np.argsort(user, kind="stable")
    rank[order] = np.arange(n) - np.searchsorted(user[order], user[order])
    validate = rank >= np.ceil(0.8 * rows_per_user[user])
    feature = "com.linkedin.photon.avro.generated.FeatureAvro"
    fields = [{"name": "uid", "type": ["null", "string"], "default": None},
              {"name": "label", "type": "double"}]
    for i, sec in enumerate(FULL_SECTIONS.values()):
        fields.append({"name": sec, "type": {"type": "array",
                                             "items": schemas.FEATURE if i == 0 else feature}})
    fields.append({"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
                   "default": None})
    schema = {"name": "FullGameExampleAvro", "namespace": "smoke", "type": "record",
              "fields": fields}
    pack = struct.Struct("<d").pack
    keys = {k: [_avro_str(f"{k[0]}{j}") + b"\x00" for j in range(d)] for k, d in FULL_D.items()}
    id_keys = [_avro_str(k) for k in ("userId", "itemId", "artistId")]

    def section(k, row):  # one block of named features, the empty term
        return (_avro_long(len(row)) + b"".join(kk + pack(v) for kk, v in zip(keys[k], row))
                + b"\x00")

    def records(sel):
        rows = np.nonzero(sel)[0]
        xs = {k: v[rows].tolist() for k, v in x.items()}
        return [b"\x02" + _avro_str(str(r)) + pack(float(y[r]))
                + b"".join(section(k, xs[k][i]) for k in FULL_D)
                + b"\x02\x06" + id_keys[0] + _avro_str(f"u{user[r]}") + id_keys[1]
                + _avro_str(f"i{item[r]}") + id_keys[2] + _avro_str(f"a{artist[r]}") + b"\x00"
                for i, r in enumerate(rows)]

    for name, sel in (("train", ~validate), ("validate", validate)):
        _write_avro(os.path.join(workdir, name, "part-00000.avro"), records(sel), schema)
    return int((~validate).sum()), int(validate.sum())


def _run_line(label, driver, wall, launches, stages):
    results = driver.results
    return (f"  {label}: wall {wall:.2f} s; launches fused dense {launches['fused_glm']}, GEVM "
            f"{launches['gevm']}, HVP {launches['hvp']}; stages "
            + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
            + "; " + "; ".join(f"combo {i} objective {r.objective_history[-1]:.6f} AUC "
                               f"{m.get('AUC', float('nan')):.6f}"
                               for i, (_, r, m) in enumerate(results))
            + f"; best {driver.best_index}")


def phase_game_grid(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 19 (a) and (b), on phase 10's data. (a) bench.py:2411-2438's
    lambda grid through the training driver (spec pallas) with
    --model-output-mode ALL, per combo and then with --vmapped-grid true:
    every model file of best/ and all/<i>/ byte-equal, the same best combo.
    (b) phase 10's command with the fixed effect down-sampled and Pearson
    selection on the per-user features, on the card and on the CPU: the
    objective histories within the solver tolerance, the card's sampled
    weights bit-equal to the weights utils/prng's draws give on the host,
    every coordinate's scores held card against CPU (``scores_held``), and
    the fused kernel held against its plain version on the card run's
    down-sampled fixed batch."""
    from photon_ml_tpu_torch.algorithm.fixed_effect import DOWN_SAMPLING_SEED
    from photon_ml_tpu_torch.data import sampler
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.utils import prng

    say("== phase 19 (a): game_training_driver.main with bench.py:2411's lambda grid on phase "
        f"10's data ({GAME_USERS} users): fixed lambda {', '.join(GRID_LAMBDAS)}, random "
        "lambda 0.1, 2 iterations, --model-output-mode ALL, spec pallas; per combo, then "
        "--vmapped-grid true")
    # the first run decodes the Avro into a tensor cache of its own; the
    # other three read the columns from it (a cut, see CUTS)
    base = ["--train-input-dirs", os.path.join(workdir, "train"),
            "--validate-input-dirs", os.path.join(workdir, "validate"),
            "--tensor-cache", os.path.join(workdir, "tcache19"), "--device", dev]
    grid = {}
    for label, extra in (("per-combo", []), ("vmapped-grid", ["--vmapped-grid", "true"])):
        out = os.path.join(workdir, f"grid-{label}")
        driver, wall, launches, stages, _ = run_game_training(
            torch, fused_sparse, base + ["--output-dir", out] + GRID_FLAGS + extra, "pallas")
        check(len(driver.results) == len(GRID_LAMBDAS), f"{label}: {len(driver.results)} combos")
        for _, r, m in driver.results:
            check(all(np.isfinite(r.objective_history)), f"{label}: non-finite objective")
            check(m["AUC"] > GAME_AUC_FLOOR, f"{label}: validation AUC {m['AUC']}")
        grid_path = all("(grid)" in r.timings for _, r, _ in driver.results)
        check(grid_path == (label == "vmapped-grid"), f"{label}: trained through the wrong path")
        kernels_launched(driver, launches, label)
        say(_run_line(label, driver, wall, launches, stages))
        grid[label] = (driver, out, wall, launches, stages)
    (pc, pc_out, *_), (vg, vg_out, *_) = grid["per-combo"], grid["vmapped-grid"]
    check(pc.best_index == vg.best_index, f"best combo {pc.best_index} vs {vg.best_index}")
    files = 0
    for sub in ["best"] + [os.path.join("all", str(i)) for i in range(len(GRID_LAMBDAS))]:
        a, b = tree_bytes(os.path.join(pc_out, sub)), tree_bytes(os.path.join(vg_out, sub))
        check(bool(a) and a == b, f"{sub}: the per-combo and --vmapped-grid models differ")
        files += len(a)
    check(all(x[1].objective_history == y[1].objective_history
              for x, y in zip(pc.results, vg.results)), "objective histories differ")
    say(f"  per-combo and --vmapped-grid: {files} model files of best/ and all/0-3/ byte-equal, "
        f"best combo {pc.best_index} (lambda {GRID_LAMBDAS[pc.best_index]}) in both, objective "
        "histories equal")

    say(f"== phase 19 (b): phase 10's command with the fixed effect down-sampled at "
        f"{SAMPLING_RATE} and Pearson selection on the per-user features at ratio "
        f"{PEARSON_RATIO}, spec pallas, on phase 17's data ({CHECKPOINT_USERS} users of phase "
        f"10's generator); on {dev}, then the same command on the CPU")
    sampled = {}
    small = os.path.join(workdir, "ck17-data")
    for label, device in (("card", dev), ("cpu", "cpu")):
        out = os.path.join(workdir, f"sampled-{label}")
        argv = ["--train-input-dirs", os.path.join(small, "train"), "--validate-input-dirs",
                os.path.join(small, "validate"), "--device", device,
                "--output-dir", out] + SAMPLED_FLAGS
        driver, wall, launches, stages, _ = run_game_training(torch, fused_sparse, argv, "pallas")
        _, result, metrics = driver.results[0]
        check(all(np.isfinite(result.objective_history)), f"{label}: non-finite objective")
        fixed = driver.combo_coords[0]["fixed"]
        weights = sampler.maybe_down_sample(fixed.batch, driver.params.task_type,
                                            fixed.down_sampling_rate, DOWN_SAMPLING_SEED).weights
        ds = driver.re_datasets["per-user"]
        sampled[label] = (driver, result, weights.cpu().numpy(), ds)
        if device != "cpu":
            kernels_launched(driver, launches, label)
        say(_run_line(label, driver, wall, launches, stages)
            + f"; per-user local dims {ds.local_dim} of {ds.global_dim}")
    card, cpu = sampled["card"], sampled["cpu"]
    data = card[0].train_data
    # the sampled weights on the host: threefry draws of utils/prng, then
    # the binary sampler's rule in float32
    u = prng.uniform(prng.prng_key(DOWN_SAMPLING_SEED), (data.num_rows,))
    pos = data.response > 0.5
    keep = pos | (u < np.float32(SAMPLING_RATE))
    scale = np.where(pos, np.float32(1.0), np.float32(1.0 / SAMPLING_RATE)).astype(np.float32)
    want = np.where(keep, data.weight.astype(np.float32) * scale, np.float32(0.0))
    check(card[2].tobytes() == want.tobytes() == cpu[2].tobytes(),
          "the sampled weights on the card, on the CPU and from the host draws differ")
    for field in ("local_to_global", "x"):
        check(getattr(card[3], field).cpu().numpy().tobytes()
              == getattr(cpu[3], field).cpu().numpy().tobytes(),
              f"the Pearson-selected per-user dataset's {field} differs card vs CPU")
    check(card[3].local_dim < card[3].global_dim, "Pearson selection kept every feature")
    err = held("sampled GAME objective history, card vs CPU", card[1].objective_history,
               cpu[1].objective_history)
    score_err = scores_held("19 (b)", card[:2], cpu[:2])
    say(f"  sampled weights bit-equal on card, CPU and host ({int(keep.sum())} of "
        f"{data.num_rows} rows kept); Pearson datasets byte-equal; card vs CPU objective "
        f"histories within {err:.3g} (solver tolerance), scores held as above")
    fixed_err = hold_driver_fixed(torch, fused_glm, card[0].combo_coords[0]["fixed"],
                                  "phase 19 (b)") if dev != "cpu" else 0.0
    return {label: {"wall_s": v[2], "launches": v[3], "stages_s": v[4],
                    "best_index": v[0].best_index}
            for label, v in grid.items()} | {"sampled_objective_abs_err": err,
                                             "sampled_scores_card_vs_cpu": score_err,
                                             "fixed_max_abs_err": fixed_err}


def phase_full_game(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 19 (c): the full GAME model of bench.py:2476-2506 through the
    training driver (spec pallas, --checkpoint-dir) twice on the card
    (models and checkpoints byte-equal) and once on the CPU (objective
    histories and the per-artist coefficients V M elementwise within the
    solver tolerance, every coordinate's scores by ``scores_held``; the
    fused kernel held on the fixed batch); then the scoring driver on the
    validation rows, device against the host oracle at the elementwise
    tolerance and its AUC against the training driver's, and the factored
    scoring contribution timed against its bytes bound."""
    from photon_ml_tpu_torch.cli import game_scoring_driver as gsd
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.models.game import gather_scores
    from photon_ml_tpu_torch.ops import fused_glm

    say(f"== phase 19 (c): game_training_driver.main on bench.py:2476's full GAME model: "
        f"{FULL_USERS} users, {FULL_ITEMS} items, {FULL_ARTISTS} artists, 8-16 rows a user, "
        f"widths {FULL_D}, 15% labels flipped; fixed + per-user + per-item + factored "
        f"per-artist (latent {FULL_LATENT}, 1 inner iteration, 10 solver iterations), "
        f"{FULL_ITERATIONS} iterations, spec pallas; twice on {dev} with --checkpoint-dir, once on the CPU")
    t0 = time.perf_counter()
    n_train, n_val = write_full_game_avro(workdir, FULL_USERS, FULL_ITEMS, FULL_ARTISTS,
                                          FULL_SEED)
    say(f"  Avro written in {time.perf_counter() - t0:.1f} s: {n_train} train rows, "
        f"{n_val} validation rows")
    # the first card run decodes the training Avro into a tensor cache, the
    # second card run and the CPU run read the columns from it (a cut, see CUTS)
    base = ["--train-input-dirs", os.path.join(workdir, "train"),
            "--validate-input-dirs", os.path.join(workdir, "validate"),
            "--tensor-cache", os.path.join(workdir, "tcache19c")] + FULL_GAME_FLAGS
    runs = {}
    for label, device, ck in (("card", dev, True), ("card again", dev, True),
                              ("cpu", "cpu", False)):
        tag = label.replace(" ", "-")
        argv = base + ["--device", device, "--output-dir", os.path.join(workdir, f"out-{tag}")]
        if ck:
            argv += ["--checkpoint-dir", os.path.join(workdir, f"ck-{tag}")]
        driver, wall, launches, stages, _ = run_game_training(torch, fused_sparse, argv, "pallas")
        _, result, metrics = driver.results[0]
        check(all(np.isfinite(result.objective_history)), f"{label}: non-finite objective")
        check(metrics["AUC"] > GAME_AUC_FLOOR, f"{label}: validation AUC {metrics['AUC']}")
        if device != "cpu":
            kernels_launched(driver, launches, label)
        state = result.coefficients["per-artist"]
        say(_run_line(label, driver, wall, launches, stages)
            + f"; objective history " + " ".join(f"{v:.6f}" for v in result.objective_history)
            + f"; latent factors {tuple(state.v.shape)}, matrix {tuple(state.matrix.shape)}")
        runs[label] = (driver, wall, launches, stages)
    out = lambda label: os.path.join(workdir, "out-" + label.replace(" ", "-"))
    best = tree_bytes(os.path.join(out("card"), "best"))
    check(best == tree_bytes(os.path.join(out("card again"), "best")),
          "two card runs of the full GAME model wrote different model bytes")
    check(model_io.is_factored_random_effect(os.path.join(out("card"), "best"), "per-artist")
          and any(k.startswith("random-effect/per-artist/latent-matrix/") for k in best),
          "the factored coordinate's latent layout is missing")
    steps = {}
    for label in ("card", "card again"):
        root = os.path.join(workdir, "ck-" + label.replace(" ", "-"), "combo-0")
        steps[label] = {}
        for step in sorted(os.listdir(root)):
            with np.load(os.path.join(root, step, "arrays.npz")) as npz:
                arrays = {k: npz[k].tobytes() for k in npz.files}
            with open(os.path.join(root, step, "meta.json")) as f:
                steps[label][step] = (arrays, json.load(f))
    check(steps["card"] == steps["card again"] and len(steps["card"]) == 2,
          f"the two card runs' checkpoints differ (steps {sorted(steps['card'])})")
    last = f"step-{4 * FULL_ITERATIONS}"
    check(last in steps["card"], f"the card run kept steps {sorted(steps['card'])}")
    treedef = steps["card"][last][1]["structure"]["params"]["treedef"]
    check("'per-artist': CustomNode(FactoredState[None], [*, *])" in treedef,
          f"checkpoint structure {treedef}")
    (card_driver, *_), (cpu_driver, *_) = runs["card"], runs["cpu"]
    card_res, cpu_res = card_driver.results[0][1], cpu_driver.results[0][1]
    err = held("full GAME objective history, card vs CPU", card_res.objective_history,
               cpu_res.objective_history)
    score_err = scores_held("19 (c)", (card_driver, card_res), (cpu_driver, cpu_res))
    vm = lambda st: (st.v.double() @ st.matrix.double()).cpu().numpy()
    vm_err = held("full GAME per-artist V M, card vs CPU", vm(card_res.coefficients["per-artist"]),
                  vm(cpu_res.coefficients["per-artist"]))
    say(f"  two card runs wrote byte-equal models ({len(best)} files) and checkpoints (steps "
        f"{sorted(steps['card'])}, arrays and meta; params {treedef}); card vs CPU within the "
        f"solver tolerance: objective histories {err:.3g}, per-artist V M elementwise "
        f"{vm_err:.3g}; scores held as above")
    fixed_err = hold_driver_fixed(torch, fused_glm, card_driver.combo_coords[0]["fixed"],
                                  "phase 19 (c)") if dev != "cpu" else 0.0

    model = os.path.join(out("card"), "best")
    train_auc = runs["card"][0].results[0][2]["AUC"]
    common = ["--input-dirs", os.path.join(workdir, "validate"), "--game-model-input-dir", model,
              "--evaluator-type", "AUC", "--device", dev,
              "--feature-shard-id-to-feature-section-keys-map",
              "|".join(f"{shard}:{sec}" for shard, sec in FULL_SECTIONS.items())]
    scoring = {}
    for label, extra in (("card", []), ("host", ["--host-scoring", "true"])):
        driver, wall = run_scoring(torch, common + extra + [
            "--output-dir", os.path.join(workdir, f"scores-{label}")])
        scoring[label] = (driver, wall)
        check(abs(driver.metrics["AUC"] - train_auc) <= 1e-5,
              f"scoring {label}: AUC {driver.metrics['AUC']} against the training driver's "
              f"{train_auc}")
        say(f"  scoring {label}: {driver.data.num_rows} rows, AUC {driver.metrics['AUC']:.6f}, "
            f"wall {wall:.2f} s")
    with open(os.path.join(workdir, "scores-card", "photon-ml-tpu-scoring.log")) as f:
        check("entities matched (device, latent-native)" in f.read(),
              "the card scoring did not take the factored model's latent path")
    card, host = scoring["card"][0], scoring["host"][0]
    diff = np.abs(card.scores.astype(np.float64) - host.scores)
    check(bool((diff <= 1e-5 + 1e-4 * np.abs(host.scores)).all()),
          f"card and host scores differ beyond the elementwise tolerance (max {diff.max():.3e})")
    say(f"  card against host scores: max |diff| {diff.max():.3e} (elementwise tolerance); "
        f"scoring AUC = training validation AUC {train_auc:.6f} within 1e-5")

    # the factored contribution on the training rows' own inputs
    trained = runs["card"][0]
    data = trained.train_data
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    factors, matrix, _, _ = model_io.load_factored_random_effect(model, "per-artist")
    matrix = put(model_io.aligned_latent_matrix(model, "per-artist",
                                                trained.shard_index_maps["per_artist"], matrix))
    latent, ent_pos, matched = gsd.entity_positions(data.id_vocabs["artistId"], factors,
                                                    data.ids["artistId"], FULL_LATENT)
    latent, ent_pos = put(latent), put(ent_pos)
    idx, vals = gsd.padded_coo(data.shards["per_artist"], dev)
    fn = lambda: gsd.factored_contrib(latent, matrix, ent_pos, idx, vals)
    contrib = fn()
    flat = gather_scores(latent @ matrix, ent_pos, idx, vals)
    sync(torch)
    fdiff = float(torch.max(torch.abs(contrib - flat)))
    check(bool(torch.allclose(contrib, flat, rtol=1e-4, atol=1e-5)),
          f"the latent contribution and the V M gather differ (max {fdiff:.3e})")
    nbytes = score_bytes(latent, matrix, ent_pos, idx, vals, contrib)
    shape = (f"N={data.num_rows} K={idx.shape[1]} E={latent.shape[0]} k={FULL_LATENT} "
             f"D={matrix.shape[1]}")
    t = {"ms": time_ms(torch, fn), "graph_ms": graph_ms(torch, fn), "bytes": nbytes,
         "bound_ms": nbytes / MEM_RATE * 1e3, "bound_by": "bytes", "shape": shape,
         "max_abs_err_vs_flat": fdiff}
    say(f"  factored_contrib: {shape}: events {t['ms']:.4f} ms, graph {t['graph_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.5f} ms ({nbytes} B), share by graph "
        f"{t['bound_ms'] / t['graph_ms']:.3f}; {matched} artists matched; against the V M "
        f"gather within {fdiff:.3e}")
    return {"walls_s": {k: v[1] for k, v in runs.items()},
            "launches": {k: v[2] for k, v in runs.items()},
            "stages_s": {k: v[3] for k, v in runs.items()},
            "objective_abs_err": err, "scores_card_vs_cpu": score_err,
            "vm_abs_err_card_vs_cpu": vm_err, "fixed_max_abs_err": fixed_err,
            "scoring_walls_s": {k: v[1] for k, v in scoring.items()},
            "score_abs_err": float(diff.max()), "factored_contrib": t}


# --- size-bucketed random effects: the shape ladder and the sparse race ----

# phase 10's generator with heavy-tailed rows per user: min(zipf(1.9) + 4,
# 2048), drawn from its own seed; 20000 users, and 4000 for the card and CPU
# pair
SKEW_USERS, SKEW_SMALL_USERS, SKEW_SEED = 20000, 2000, 31  # small: a depth cut, see CUTS
SKEW_ZIPF, SKEW_MIN_ROWS, SKEW_MAX_ROWS = 1.9, 4, 2048
BUCKETED_FLAGS = GAME_FLAGS + ["--bucketed-random-effects", "true"]


def skewed_rows(num_users, seed):
    return np.minimum(np.random.default_rng(seed).zipf(SKEW_ZIPF, size=num_users)
                      + SKEW_MIN_ROWS, SKEW_MAX_ROWS)


def expected_buckets(rows_per_user):
    """The per-user dataset's stacks as the data implies them: (E_b, M_b)
    of each size bucket of the training rows (80% of each user's, rounded
    up), and of the one unbucketed stack."""
    from photon_ml_tpu_torch.algorithm.bucketed_random_effect import partition_entities_by_size

    train = np.ceil(0.8 * rows_per_user).astype(np.int64)
    buckets = [(len(b), int(train[b].max())) for b in partition_entities_by_size(train)]
    return buckets, (len(train), int(train.max()))


class SlabEvaluations:
    """Counts value+gradient evaluations on slabs of the fused family while
    installed (the GEVM kernel launches once for each)."""

    def __enter__(self):
        from photon_ml_tpu_torch.ops.fused_sparse import SparseSlab
        from photon_ml_tpu_torch.ops.objective import GLMObjective

        self.count, self._cls, inner = 0, GLMObjective, GLMObjective.value_and_grad

        def counted(obj, w, batch, *args, **kwargs):
            if isinstance(batch.features, SparseSlab) and batch.features.kernel.startswith("pallas"):
                self.count += 1
            return inner(obj, w, batch, *args, **kwargs)

        self._inner = inner
        GLMObjective.value_and_grad = counted
        return self

    def __exit__(self, *exc):
        self._cls.value_and_grad = self._inner


def objectives_held(label, a, b):
    return held(f"{label}: objective histories", a.objective_history, b.objective_history)


def race_lines(fused_sparse):
    """Every recorded sparse race: each candidate's time or failure reason,
    and the winner; each raced name must have one or the other."""
    out = {}
    for key, rep in fused_sparse.race_reports().items():
        label, shape = key[0], rep["shape"]
        names = set(fused_sparse.sparse_candidates(shape["rows"])) | {"dense"}
        check(names <= set(rep["candidates"]),
              f"race {label}: candidates missing from the report: "
              f"{sorted(names - set(rep['candidates']))}")
        for name, c in rep["candidates"].items():
            check("sec_per_pass" in c or bool(c.get("failed")),
                  f"race {label}: {name} has neither a time nor a failure reason")
        say(f"  race {label} (E={shape['lanes']} M={shape['rows']} K={shape['k']} "
            f"D={shape['dim']}, first {min(shape['lanes'], fused_sparse.RACE_LANES)} lanes): winner "
            f"{rep['winner'] or 'dense'}; " + "; ".join(
                f"{name} " + (f"{c['sec_per_pass'] * 1e3:.4f} ms/pass" if "sec_per_pass" in c
                              else c["failed"] if c["failed"].startswith("skipped")
                              else f"FAILED {c['failed']}")
                for name, c in rep["candidates"].items()))
        out[label] = {"shape": shape, "winner": rep["winner"], "candidates": rep["candidates"]}
    return out


def phase_bucketed(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 20: the GAME driver with --bucketed-random-effects true on a
    heavy-tailed variant of phase 10's data. (a) the data, each bucket's
    stack and the padded elements bucketed against unbucketed; (b) spec
    pallas on the card: one GEVM launch per bucket per evaluation; (c) the
    same command unbucketed, held against (b) by ``scores_held``'s rule and
    the objective histories; (e) both sparse kernels held against their
    plain version on every bucket's slab and on the unbucketed one; then at
    SKEW_SMALL_USERS users (cuts, see CUTS): (f) two bucketed runs on the
    card (byte-equal models) and one on the CPU, held likewise; (d) spec
    auto with --shape-canonicalization on: every bucket's race report,
    scores held against (f)'s card run."""
    from photon_ml_tpu_torch.ops import fused_glm

    say(f"== phase 20: game_training_driver.main --bucketed-random-effects true, phase 10's "
        f"generator with min(zipf({SKEW_ZIPF}) + {SKEW_MIN_ROWS}, {SKEW_MAX_ROWS}) rows a user "
        f"(seed {SKEW_SEED}), {SKEW_USERS} users; spec pallas, unbucketed; then "
        f"{SKEW_SMALL_USERS} users twice on {dev} and once on the CPU, and spec auto with "
        "--shape-canonicalization on")
    rows = skewed_rows(SKEW_USERS, SKEW_SEED)
    t0 = time.perf_counter()
    big = os.path.join(workdir, "skew")
    n_train, n_val = write_game_avro(big, SKEW_USERS, SEED + 20, rows_per_user=rows)
    buckets, (e_all, m_all) = expected_buckets(rows)
    k = GAME_D_RANDOM + 1
    elems = {"bucketed": sum(e * m * k for e, m in buckets), "unbucketed": e_all * m_all * k}
    say(f"  (a) Avro written in {time.perf_counter() - t0:.1f} s: {n_train} train rows, {n_val} "
        f"validation rows; rows a user mean {rows.mean():.2f}, largest {rows.max()}; buckets "
        + ", ".join(f"E={e} M={m} K={k}" for e, m in buckets)
        + f"; unbucketed E={e_all} M={m_all} K={k}; padded elements bucketed "
        f"{elems['bucketed']} against unbucketed {elems['unbucketed']} "
        f"({elems['unbucketed'] / elems['bucketed']:.1f}x)")
    base = ["--train-input-dirs", os.path.join(big, "train"),
            "--validate-input-dirs", os.path.join(big, "validate"), "--device", dev]
    out = {"buckets": buckets, "unbucketed": [e_all, m_all], "padded_elements": elems, "runs": {}}

    def run(label, flags, spec, data_base=base):
        d = os.path.join(workdir, "out20-" + label.replace(" ", "-"))
        with SlabEvaluations() as evals:
            driver, wall, launches, stages, _ = run_game_training(
                torch, fused_sparse, data_base + ["--output-dir", d] + flags, spec)
        result = driver.results[0][1]
        check(all(np.isfinite(result.objective_history)), f"{label}: non-finite objective")
        auc = driver.results[0][2]["AUC"]
        check(auc > GAME_AUC_FLOOR, f"{label}: validation AUC {auc}")
        say(_run_line(label, driver, wall, launches, stages)
            + f"; value+gradient evaluations on fused slabs {evals.count}")
        out["runs"][label] = {"wall_s": wall, "stages_s": stages, "launches": launches,
                              "slab_evaluations": evals.count, "auc": auc,
                              "objective_history": result.objective_history}
        return driver, result, d, launches, evals.count

    (b1, r1, d1, l1, n1) = run("(b) bucketed", BUCKETED_FLAGS, "pallas")
    coord = b1.combo_coords[0]["per-user"]
    got = sorted((int(sub.dataset.x.shape[0]), int(sub.dataset.x.shape[1])) for sub in coord._subs)
    check(got == sorted(buckets), f"(b): bucket stacks {got}, the data implies {sorted(buckets)}")
    check(all(sub.dataset.local_dim == k and sub.slab.max_nnz == k for sub in coord._subs),
          "(b): a bucket's local dim or slab width is not 9")
    check(coord.padded_elements() == elems["bucketed"], "(b): padded elements")
    kernels_launched(b1, l1, "(b) bucketed")
    check(l1["gevm"] == n1, f"(b): {l1['gevm']} GEVM launches for {n1} slab evaluations")
    fixed_err = [hold_driver_fixed(torch, fused_glm, b1.combo_coords[0]["fixed"], "phase 20 (b)")]
    say(f"  (b) GEVM launches {l1['gevm']} = one a bucket per evaluation ({len(buckets)} "
        "buckets)")

    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate

    with UpdatePeak(torch, RandomEffectCoordinate) as c_peak:
        (c, rc, _, lc, _) = run("(c) unbucketed", GAME_FLAGS, "pallas", base)
    # phase 22 (b) holds the streaming runs against this one
    out["_inmemory"] = (c, rc, c_peak.summary())
    say(f"  (c) in-memory update peak device memory {c_peak.summary()[0]} B above its start")
    kernels_launched(c, lc, "(c) unbucketed")
    check(c.re_datasets["per-user"].x.numel() // k == e_all * m_all,
          "(c): the unbucketed stack's shape")
    out["held_unbucketed"] = scores_held("(c)", (b1, r1), (c, rc), "bucketed vs unbucketed")
    objectives_held("(c) bucketed vs unbucketed", r1, rc)
    tb, tc = out["runs"]["(b) bucketed"]["stages_s"], out["runs"]["(c) unbucketed"]["stages_s"]
    say("  (c) stages, bucketed | unbucketed: " + ", ".join(
        f"{key} {tb[key]:.2f} | {tc[key]:.2f} s" for key in tb))

    say("  (e) both sparse kernels on every bucket's slab and on the unbucketed slab")
    errs = {"gevm": 0.0, "hvp": 0.0}
    for sub in list(coord._subs) + [c.combo_coords[0]["per-user"]]:
        e_ = hold_driver_slab(torch, fused_sparse, sub)
        errs = {key: max(errs[key], e_[key]) for key in errs}
    out["max_abs_err"] = errs
    del c

    small = os.path.join(workdir, "skew-small")
    write_game_avro(small, SKEW_SMALL_USERS, SEED + 21,
                    rows_per_user=skewed_rows(SKEW_SMALL_USERS, SKEW_SEED + 1))
    pair, small_dirs = {}, {}
    sargv = lambda device: ["--train-input-dirs", os.path.join(small, "train"),
                            "--validate-input-dirs", os.path.join(small, "validate"),
                            "--device", device]
    for label, device in (("(f) card", dev), ("(f) card again", dev), ("(f) cpu", "cpu")):
        driver, result, small_dirs[label], launches, _ = run(label, BUCKETED_FLAGS, "pallas",
                                                             sargv(device))
        if device != "cpu":
            kernels_launched(driver, launches, label)
            fixed_err.append(hold_driver_fixed(torch, fused_glm, driver.combo_coords[0]["fixed"],
                                               "phase 20 (f)"))
        pair[label] = (driver, result)
    check(tree_bytes(os.path.join(small_dirs["(f) card"], "best"))
          == tree_bytes(os.path.join(small_dirs["(f) card again"], "best")),
          "(f): two bucketed card runs wrote different model bytes")
    check(pair["(f) card again"][1].objective_history == pair["(f) card"][1].objective_history,
          "(f): the two card runs' objective histories differ")
    say("  (f) two bucketed card runs: model bytes and objective histories equal")
    del pair["(f) card again"]
    out["held_card_cpu"] = scores_held("(f)", pair["(f) card"], pair["(f) cpu"])
    objectives_held("(f) card vs CPU", pair["(f) card"][1], pair["(f) cpu"][1])

    fused_sparse._race_cache.clear()
    fused_sparse._race_reports.clear()
    (dd, rd, _, ld, nd) = run("(d) auto + ladder", BUCKETED_FLAGS + [
        "--shape-canonicalization", "on"], "auto", sargv(dev))
    out["races"] = race_lines(fused_sparse)
    subs = dd.combo_coords[0]["per-user"]._subs
    check(len(out["races"]) >= 1, "(d): no sparse race was recorded")
    # every race ran the kernel, and its evaluations are the solves' and
    # the races' together
    check(ld["gevm"] > 0 and ld["gevm"] == nd,
          f"(d): {ld['gevm']} GEVM launches for {nd} value+gradient evaluations on fused slabs")
    failed = {label: r["candidates"]["pallas"]["failed"] for label, r in out["races"].items()
              if "failed" in r["candidates"]["pallas"]}
    check(not failed, f"(d): the GEVM kernel failed its race: {failed}")
    say("  (d) buckets (E, M) on the ladder and their families: " + ", ".join(
        f"{tuple(s_.dataset.x.shape[:2])} {s_.slab.kernel if s_.slab is not None else 'dense'}"
        for s_ in subs))
    card_f = pair["(f) card"]
    out["held_auto"] = scores_held("(d)", (dd, rd), card_f, "auto + ladder vs (f) card")
    objectives_held("(d) auto + ladder vs (f) card", rd, card_f[1])
    del dd
    out["fixed_max_abs_err"] = max(fixed_err)
    return out


# --- phase 21: the solve scheduler -------------------------------------------

SCHED_CHUNK = 8
SCHEDULED_FLAGS = {"host": ["--solve-compaction", str(SCHED_CHUNK)],
                   "device": ["--solve-compaction", f"device:{SCHED_CHUNK}"]}


def result_bits(torch, res):
    """An OptResult's fields as comparable bit patterns (NaN padding of the
    histories included): a float tensor viewed as integers of its width."""
    out = []
    for t in res:
        if t is None:
            out.append(None)
            continue
        t = t.detach()
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        out.append(t.cpu())
    return out


def bitwise_results(torch, a, b) -> bool:
    return all((x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(result_bits(torch, a), result_bits(torch, b)))


def sparse_kernel_kind(name: str):
    """'gevm' or 'hvp' for a traced sparse_pass kernel (its kHvp template
    argument, demangled or mangled), 'sparse' when the name does not say,
    None for any other kernel."""
    if "sparse_pass" not in name:
        return None
    m = re.search(r"sparse_pass<[^,<>]*,[^,<>]*,\s*(true|false)", name)
    if m:
        return "hvp" if m.group(1) == "true" else "gevm"
    m = re.search(r"sparse_passI\w*?Lb([01])E", name)
    if m:
        return "hvp" if m.group(1) == "1" else "gevm"
    return "sparse"


SYNC_WARNING = "called a synchronizing CUDA operation"


def trace_split(torch, fn, counters):
    """One call of ``fn`` under torch.profiler and
    ``torch.cuda.set_sync_debug_mode("warn")``: the host wall after a sync,
    the kernels' device time summed from the trace's kernel events (those
    replayed inside CUDA graphs included), the sparse kernels the trace
    holds by kind, the ``counters``' (the GEVM and HVP wrappers') launch
    counts over the same call, and the syncs the card reported. CUPTI now
    and then delivers a session no device event; such a session is traced
    again, up to PROFILE_ATTEMPTS calls. It may also drop a kernel record
    (on an H100, whole runs of this script traced one sparse kernel fewer
    than an eager solve launched), so a trace's count is a lower bound.
    Each session starts with a small kernel of its own."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        sync(torch)
        before = [c.launches for c in counters]
        mode = torch.cuda.get_sync_debug_mode()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            sync(torch)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            sync(torch)
            wall = time.perf_counter() - t0
        counted = {k: c.launches - b for k, c, b in zip(("gevm", "hvp"), counters, before)}
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        traced = {"gevm": 0, "hvp": 0, "sparse": 0}
        for ev in kernels:
            kind = sparse_kernel_kind(ev.name)
            if kind is not None:
                traced[kind] += 1
        if kernels:
            break
    kernel_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    return {"wall_s": wall, "kernel_s": kernel_us / 1e6 if kernel_us else None,
            "calls": attempt, "traced": traced, "counted": counted,
            "syncs": sum(SYNC_WARNING in str(w.message) for w in caught)}


def phase_scheduler_solve(torch, fused_sparse, dev="cuda"):
    """Phase 21 (a): RandomEffectCoordinate.update at full width (phase 9's
    data: E=1024 M=64 K=16 D=2048, f32, spec pallas) with LBFGS and TRON,
    one-shot, through the host chunk loop at chunk 8 and through the device
    rung loop at chunk 8 (twice: the first captures the rung graphs); every
    OptResult field and the coefficients bitwise equal across the three.
    Prints the lane-iteration ledger, the wrappers' launch counts, counted
    host reads, captures and replays, walls, and for one more solve of each
    way a torch.profiler trace: host time against kernel time, the sparse
    kernels it holds (for the device loop, those replayed from its graphs,
    which no wrapper counts) and the syncs the card reported under
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.compile import compile_stats
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import HostReads, OptimizerConfig
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, solve_stats
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    say(f"== phase 21 (a): the solve scheduler at full width, E={E_RE} M={M_RE} D={D_RE} (K=16), "
        f"f32, spec pallas: one-shot, host chunk loop and device rung loop at chunk {SCHED_CHUNK}")
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
    schedules = {"one-shot": None, "host": SolveSchedule(SCHED_CHUNK),
                 "device": SolveSchedule(SCHED_CHUNK, loop="device")}
    out = {}
    for opt, cfg in configs.items():
        runs = {}
        for how, schedule in schedules.items():
            coord = RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION, OptimizerType(opt),
                                           cfg, RegularizationContext.l2(0.5),
                                           sparse_kernel="pallas", solve_schedule=schedule)
            coord.slab.kernel_tables()
            for rep in ((1, 2) if how == "device" else (1,)):
                label = how if rep == 1 else f"{how} again"
                sync(torch)
                for c in counters:
                    c.launches = 0
                solve_stats.reset()
                compile_stats.reset()
                reads0 = HostReads.count
                t0 = time.perf_counter()
                w, res = coord.update(resid, coord.initial_coefficients())
                sync(torch)
                wall = time.perf_counter() - t0
                rec = solve_stats.snapshot()[-1] if schedule is not None else None
                site = compile_stats.snapshot().get("scheduler.rung", {})
                runs[label] = {
                    "result": res, "wall_s": wall,
                    "launches": {"gevm": counters[0].launches, "hvp": counters[1].launches},
                    "host_reads": HostReads.count - reads0,
                    "executed": rec.executed if rec else None,
                    "baseline": rec.baseline if rec else None,
                    "dispatches": rec.dispatches if rec else None,
                    "device_chunks": rec.device_chunks if rec else None,
                    "captures": site.get("traces", 0), "replays": site.get("cache_hits", 0),
                    "decay": ([f"{c.active_lanes}/{c.batch_lanes}@{c.limit}" for c in rec.chunks]
                              if rec else None),
                }
                r = runs[label]
                check(bool(torch.isfinite(res.value).all()) and bool(torch.isfinite(w).all()),
                      f"(a) {opt} {label}: non-finite solve")
                # a replay launches through its graph, not the wrappers: the
                # second device solve's launches are read from its trace below
                check(label == "device again" or (r["launches"]["gevm"] > 0 and (
                    opt == "LBFGS" or r["launches"]["hvp"] > 0)),
                      f"(a) {opt} {label}: a kernel of the path did not launch: {r['launches']}")
                say(f"  (a) {opt} {label:12s}: wall {wall:.4f} s, wrapper launch counts GEVM "
                    f"{r['launches']['gevm']} HVP {r['launches']['hvp']}, counted host reads "
                    f"{r['host_reads']}"
                    + ("" if rec is None else
                       f", lane-iterations executed {rec.executed} of {rec.baseline} one-shot, "
                       f"{rec.dispatches} host dispatches, {rec.device_chunks} device chunks, "
                       f"captures {r['captures']} replays {r['replays']}; decay "
                       + " -> ".join(r["decay"])))
            if how == "device":
                again = runs["device again"]
                check(again["captures"] == 0, f"(a) {opt}: the second device solve captured "
                                              f"{again['captures']} graphs")
            # one more solve, traced: the sparse kernels torch.profiler saw
            # against the wrappers' counts, and the syncs the card reported
            # against the counted host reads
            reads0 = HostReads.count
            t = trace_split(torch, lambda: coord.update(resid, coord.initial_coefficients()),
                            counters)
            t["host_reads"] = HostReads.count - reads0
            runs[how]["trace"] = t
            traced, counted = t["traced"], t["counted"]
            check(t["kernel_s"] is not None,
                  f"(a) {opt} {how}: torch.profiler recorded no device kernel in {t['calls']} "
                  "traced calls")
            check(traced["sparse"] == 0, f"(a) {opt} {how}: sparse kernels of no known kind in "
                                         f"the trace: {traced}")
            if how == "device":
                # the graphs are cached: the wrappers launch only the
                # solve's initial evaluation, the replays the rest
                check(traced["gevm"] > counted["gevm"] and (
                    opt == "LBFGS" or traced["hvp"] > counted["hvp"]),
                      f"(a) {opt} device: the trace holds no kernel replayed from a graph "
                      f"(traced {traced}, wrapper counts {counted})")
            else:
                # every launch of an eager solve passes a wrapper; the trace
                # may drop a record, never add one
                check(0 < traced["gevm"] <= counted["gevm"] and traced["hvp"] <= counted["hvp"],
                      f"(a) {opt} {how}: the trace holds {traced} sparse kernels, the wrappers "
                      f"counted {counted}")
            # the lane ids of a compaction are uploaded from pinned memory
            # without a sync: on the one-shot solve and on the host loop
            # every sync is a counted host read
            check(t["syncs"] == t["host_reads"] if how != "device"
                  else t["syncs"] >= t["host_reads"],
                  f"(a) {opt} {how}: the card reported {t['syncs']} syncs against "
                  f"{t['host_reads']} counted host reads")
            say(f"  (a) {opt} {how} traced ({t['calls']} call(s)): host wall {t['wall_s']:.4f} s, "
                "device kernel time "
                + ("not recorded" if t["kernel_s"] is None else
                   f"{t['kernel_s']:.4f} s ({t['kernel_s'] / t['wall_s']:.3f} of the wall)")
                + f"; sparse kernels by torch.profiler GEVM {traced['gevm']} HVP {traced['hvp']}"
                f" (wrapper counts {counted['gevm']} / {counted['hvp']}); syncs reported by "
                f"the card {t['syncs']}, counted host reads {t['host_reads']}")
        base = runs["one-shot"]["result"]
        for label in ("host", "device", "device again"):
            check(bitwise_results(torch, runs[label]["result"], base),
                  f"(a) {opt}: the {label} solve is not bitwise the one-shot solve")
        say(f"  (a) {opt}: host and device solves bitwise equal to the one-shot solve "
            "(coefficients and every OptResult field)")
        out[opt] = {k: {kk: vv for kk, vv in v.items() if kk != "result"}
                    for k, v in runs.items()}
    return out


def batch_independence(torch, fused_sparse, label, slab, y, wt, off, ladder):
    """Phase 21 (b) on one slab: at every rung R of ``ladder`` the
    lane-indirect GEVM and HVP launches over R lanes (the active-first
    order: ascending ids) give those lanes' rows of the full launch bit for
    bit, and the indirect kernels hold against their plain versions within
    SPARSE_TOL. Returns the largest difference against the plain version."""
    from photon_ml_tpu_torch.ops import losses

    loss = losses.logistic
    e, d = slab.idx.shape[0], slab.dim
    g = torch.Generator(device=slab.device).manual_seed(SEED + 210)
    w = 0.3 * torch.randn((e, d), device=slab.device, generator=g)
    v = torch.randn((e, d), device=slab.device, generator=g)
    vshift = torch.randn((e,), device=slab.device, generator=g)
    full = fused_sparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
    full_hvp = fused_sparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
    errs = {"gevm": 0.0, "hvp": 0.0}
    rungs = sorted({min(r, e) for r in ladder}, reverse=True)
    for r in rungs:
        ids = torch.sort(torch.randperm(e, device=slab.device, generator=g)[:r])[0]
        lanes = fused_sparse.SlabLanes(slab, ids.to(torch.int32))
        sel = lambda t: t.index_select(0, ids).contiguous()
        got = fused_sparse.fused_value_grad_parts(loss, lanes, sel(y), sel(wt), sel(off), sel(w))
        got_hvp = fused_sparse.fused_hvp_parts(loss, lanes, sel(y), sel(wt), sel(off), sel(w),
                                               sel(v), sel(vshift))
        sync(torch)
        for a, b in zip(got + got_hvp, full + full_hvp):
            check(torch.equal(a, sel(b)), f"(b) {label}: rung {r}: a lane-indirect row is not "
                                          "bitwise the full launch's")
        plain = fused_sparse.fused_value_grad_parts_plain(loss, lanes, sel(y), sel(wt), sel(off),
                                                          sel(w))
        plain_hvp = fused_sparse.fused_hvp_parts_plain(loss, lanes, sel(y), sel(wt), sel(off),
                                                       sel(w), sel(v), sel(vshift))
        for key, a, b in (("gevm", got[1], plain[1]), ("hvp", got_hvp[0], plain_hvp[0])):
            err = float(torch.linalg.vector_norm((a - b).double())
                        / max(float(torch.linalg.vector_norm(b.double())), 1e-30))
            check(err <= SPARSE_TOL, f"(b) {label}: rung {r} {key}: indirect against plain "
                                     f"{err:.3g} > {SPARSE_TOL}")
            errs[key] = max(errs[key], float((a - b).abs().max()))
    say(f"  (b) {label}: rungs {rungs}: every lane-indirect GEVM and HVP row bitwise the full "
        f"launch's; against plain within {SPARSE_TOL} (max |diff| GEVM {errs['gevm']:.3g}, HVP "
        f"{errs['hvp']:.3g})")
    return errs


INDIRECT_WIDTHS = (64, 512)  # rung widths at which phase 21 (b) times the indirect launch


def indirect_times(torch, fused_sparse, slab, y, wt, off):
    """Phase 21 (b)'s timings on (a)'s slab: at each of INDIRECT_WIDTHS,
    the lane-indirect GEVM and HVP launches over that many lanes of the
    full slab, and the direct launch on a slab of the same lanes (its own
    tables), by graph and by events, beside the bound of an R-lane call."""
    from photon_ml_tpu_torch.ops import losses

    loss = losses.logistic
    e, m, k = slab.idx.shape
    d = slab.dim
    g = torch.Generator(device=slab.device).manual_seed(SEED + 211)
    out = {}
    for r in (min(r, e) for r in INDIRECT_WIDTHS):
        ids = torch.sort(torch.randperm(e, device=slab.device, generator=g)[:r])[0]
        sel = lambda t: t.index_select(0, ids).contiguous()
        lanes = fused_sparse.SlabLanes(slab, ids.to(torch.int32))
        own = fused_sparse.SparseSlab(sel(slab.idx), sel(slab.val), d, "pallas")
        own.kernel_tables()
        w = 0.1 * torch.randn((r, d), device=slab.device, generator=g)
        v = torch.randn((r, d), device=slab.device, generator=g)
        vs = torch.randn((r,), device=slab.device, generator=g)
        rows = (sel(y), sel(wt), sel(off))
        bound = {key: b / 3.35e12 * 1e3 for key, b in sparse_bytes(r, m, k, d).items()}
        for label, feats in (("indirect", lanes), ("direct", own)):
            calls = {"gevm": lambda f=feats: fused_sparse.fused_value_grad_parts(
                         loss, f, *rows, w),
                     "hvp": lambda f=feats: fused_sparse.fused_hvp_parts(loss, f, *rows, w, v, vs)}
            for key, fn in calls.items():
                out[f"{key} {label} R={r}"] = {
                    "graph_ms": graph_ms(torch, fn), "ms": time_ms(torch, fn),
                    "bound_ms": bound[key]}
    say("  (b) indirect launch times (graph / events ms; bound ms), "
        f"E={e} M={m} K={k} D={d}: " + "; ".join(
            f"{name} {t['graph_ms']:.5f} / {t['ms']:.5f} ({t['bound_ms']:.5f})"
            for name, t in out.items()))
    return out


def phase_scheduler(torch, fused_sparse, workdir, bucketed, dev="cuda"):
    """Phase 21, run after phase 20 in its directory: (a) the full-width RE
    solve three ways (``phase_scheduler_solve``); (b) batch independence
    of the lane-indirect kernels at every rung, on (a)'s slab and on phase
    20 (f)'s tail bucket; (c) on phase 20 (f)'s SKEW_SMALL_USERS users,
    phase 20 (f)'s command with --solve-compaction 8 and device:8 and
    --checkpoint-dir, model bytes equal to phase 20 (f)'s card run; (e) the
    same commands stopped by PHOTON_PREEMPT_AT=chunk:N (host loop) and
    rung:N (device loop) and resumed, model bytes equal to (c)'s
    uninterrupted runs; (d) on the same data, the device loop with
    --adaptive-schedule 0 (byte-equal), on (scores held) and 1:1 over 3
    iterations (buckets skipped, each a recorded decision)."""
    from photon_ml_tpu_torch.compile import ShapeBucketer, compile_stats
    from photon_ml_tpu_torch.optim.fused_schedule import rung_ladder
    from photon_ml_tpu_torch.optim.scheduler import solve_stats
    from photon_ml_tpu_torch.resilience import preemption

    counters = (fused_sparse.sparse_gevm_kernel, fused_sparse.sparse_hvp_kernel)
    out = {"solve": phase_scheduler_solve(torch, fused_sparse, dev)}
    launches = {k: sum(r["launches"][k] for o in out["solve"].values() for r in o.values())
                for k in ("gevm", "hvp")}

    say(f"== phase 21 (c)-(e): the GAME driver on phase 20 (f)'s data ({SKEW_SMALL_USERS} "
        "users) with the scheduler")
    small = os.path.join(workdir, "skew-small")
    sbase = ["--train-input-dirs", os.path.join(small, "train"),
             "--validate-input-dirs", os.path.join(small, "validate"), "--device", dev,
             "--delete-output-dir-if-exists", "true"]
    want = tree_bytes(os.path.join(workdir, "out20-(f)-card", "best"))
    ref_train = bucketed["runs"]["(f) card"]["stages_s"]["train"]
    runs = {}

    def run(label, flags, data_base=sbase):
        d = os.path.join(workdir, "out21-" + label)
        solve_stats.reset()
        compile_stats.reset()
        driver, wall, l_, stages, _ = run_game_training(
            torch, fused_sparse, data_base + ["--output-dir", d] + BUCKETED_FLAGS + flags, "pallas")
        kernels_launched(driver, l_, label)
        for k in launches:
            launches[k] += l_[k]
        t = solve_stats.totals()
        site = compile_stats.snapshot().get("scheduler.rung", {})
        runs[label] = {"wall_s": wall, "stages_s": stages, "launches": l_, "solve_totals": t,
                       "captures": site.get("traces", 0), "replays": site.get("cache_hits", 0)}
        say(f"  {label}: wall {wall:.2f} s, train stage {stages['train']:.2f} s (phase 20 (f) "
            f"unscheduled {ref_train:.2f} s), launches {l_}; captures {runs[label]['captures']} "
            f"replays {runs[label]['replays']}")
        for line in solve_stats.summary().splitlines():
            say(f"    {line}")
        return driver, d

    # (c)'s runs are checkpointed: they are (e)'s uninterrupted runs too
    drivers, clean = {}, {}
    for loop, flags in SCHEDULED_FLAGS.items():
        clean[loop] = run(f"(c)-{loop}", flags + ["--checkpoint-dir",
                          os.path.join(workdir, f"ck21-{loop}-clean")])
        drivers[loop], d = clean[loop]
        check(tree_bytes(os.path.join(d, "best")) == want,
              f"(c) --solve-compaction {flags[1]}: model bytes differ from phase 20 (f)'s")
    say("  (c) host and device loops: model bytes equal to phase 20 (f)'s unscheduled card run")

    coord = drivers["device"].combo_coords[0]["per-user"]
    tail = coord._subs[-1]
    errs = batch_independence(
        torch, fused_sparse, f"phase 20 (f)'s tail bucket E={tail.dataset.num_entities} "
        f"M={tail.slab.num_rows} K={tail.slab.max_nnz}", tail.slab, tail.dataset.labels,
        tail.dataset.weights, tail.gathered_offsets(torch.zeros(
            (int(tail.dataset.row_index.max()) + 1,), device=tail.slab.device)),
        rung_ladder(ShapeBucketer(), tail.dataset.num_entities))
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = skewed_stack(torch, E_RE, M_RE, D_RE, 16, g, dev)
    slab = fused_sparse.build_sparse_slab(x, kernel="pallas")
    rows = torch.rand((E_RE, M_RE), device=dev, generator=g)
    e2 = batch_independence(torch, fused_sparse, f"(a)'s slab E={E_RE} M={M_RE} K=16",
                            slab, (rows < 0.5).float(), rows + 0.5, 0.1 * rows,
                            rung_ladder(ShapeBucketer(), E_RE))
    out["max_abs_err"] = {k: max(errs[k], e2[k]) for k in errs}
    out["indirect_times"] = indirect_times(torch, fused_sparse, slab, (rows < 0.5).float(),
                                           rows + 0.5, 0.1 * rows)
    del drivers, coord, tail, slab, x

    # (e), then (d), on (c)'s data
    preempt = {}
    for loop, site, n in (("host", "chunk", 3), ("device", "rung", 2)):
        flags = SCHEDULED_FLAGS[loop]
        dc = clean[loop][1]
        ck = os.path.join(workdir, f"ck21-{loop}")
        argv = sbase + ["--output-dir", os.path.join(workdir, f"out21-(e)-{loop}")] + \
            BUCKETED_FLAGS + flags + ["--checkpoint-dir", ck]
        code = stopped_in_process(torch, fused_sparse, argv, "pallas", f"{site}:{n}")
        check(code == preemption.PREEMPT_EXIT_CODE,
              f"(e) {site}:{n}: the run exited {code}, not {preemption.PREEMPT_EXIT_CODE}")
        meta_files = sorted(os.listdir(os.path.join(ck, "combo-0")))
        with open(os.path.join(ck, "combo-0", meta_files[-1], "meta.json")) as f:
            partial = json.load(f)["partial"]
        check(partial is not None and partial.get("kind") == "bucketed_re"
              and (partial.get("inner") or {}).get("kind") == "scheduler",
              f"(e) {site}:{n}: the emergency checkpoint holds no scheduler progress: {partial}")
        _, wall_r, _, _, _ = run_game_training(torch, fused_sparse, argv, "pallas")
        check(tree_bytes(os.path.join(workdir, f"out21-(e)-{loop}", "best"))
              == tree_bytes(os.path.join(dc, "best")),
              f"(e) {site}:{n}: the resumed run's model bytes differ from the uninterrupted run's")
        say(f"  (e) {loop} loop: stopped at {site}:{n} (exit 75, checkpoint {meta_files[-1]} with "
            f"bucket {partial['bucket']} and the paused solve at iteration limit "
            f"{partial['inner']['limit']}), resumed in {wall_r:.2f} s: model bytes equal to the "
            "uninterrupted run's")
        preempt[loop] = {"site": f"{site}:{n}", "bucket": partial["bucket"],
                         "limit": partial["inner"]["limit"], "resume_s": wall_r}
    out["preempt"] = preempt
    check(tree_bytes(os.path.join(clean["host"][1], "best"))
          == tree_bytes(os.path.join(clean["device"][1], "best")),
          "(e) the host and device loops' uninterrupted runs wrote different model bytes")

    ref_driver, ref_dir = clean["device"]
    _, d0 = run("(d)-adaptive-0", SCHEDULED_FLAGS["device"] + ["--adaptive-schedule", "0"],
                sbase)
    check(tree_bytes(os.path.join(d0, "best")) == tree_bytes(os.path.join(ref_dir, "best")),
          "(d) --adaptive-schedule 0: model bytes differ from the run without it")
    for label, spec, extra in (("(d)-adaptive-on", "on", []),
                               # a tolerance every bucket's score is under: the
                               # epochs after the first skip buckets, each a
                               # recorded decision, the coefficients carried
                               ("(d)-adaptive-skips", "1:1", ["--num-iterations", "3"])):
        driver, _ = run(label, SCHEDULED_FLAGS["device"] + ["--adaptive-schedule", spec] + extra,
                        sbase)
        coord = driver.combo_coords[0]["per-user"]
        ledger = coord.ledger_export()
        skipped = [d.describe() for d in coord.skip_decisions if d.action == "skipped"]
        check(sum(e["skips"] for e in ledger.values()) == len(skipped),
              f"{label}: a skip without its recorded decision")
        if spec == "on":
            out["held_adaptive_on"] = scores_held(
                "(d)", (driver, driver.results[0][1]),
                (ref_driver, ref_driver.results[0][1]), "adaptive on vs without")
        else:
            check(len(skipped) > 0, f"{label}: no bucket was skipped")
        say(f"  {label}: --adaptive-schedule {spec}: {len(skipped)} skips, each a recorded "
            f"decision" + (f", e.g. {skipped[0]}" if skipped else "")
            + f"; ledger {json.dumps(ledger)}")
        out[label] = {"decisions": [d.describe() for d in coord.skip_decisions],
                      "ledger": ledger}
    say(f"  (d) --adaptive-schedule 0: model bytes equal to the run without it ({SKEW_SMALL_USERS} "
        "users)")
    out["runs"] = runs
    out["launches"] = launches
    return out

# --- phase 21 (f) and phase 22: dense-stack bits, streaming, the tensor cache -


DENSE_STACK_SHAPES = (("the GAME driver's stack", 20000, 12, 9),
                      ("a wider stack", 2048, 16, 128))
DENSE_CHUNK = 2  # phase 21 (f)'s chunk: every solve compacts onto several rungs


def dense_stack_problem(torch, dev, e, m, d, seed):
    """A dense (E, M, D) random-effect stack problem (logistic, labels from a
    planted model, about half the slots non-zero, 15% of the rows at weight
    0), made on the host from ``seed`` and moved to ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((e, m, d), generator=g) * (torch.rand((e, m, d), generator=g) < 0.5)
    w_true = 0.4 * torch.randn((e, d), generator=g)
    z = torch.einsum("emd,ed->em", x, w_true)
    y = (torch.sigmoid(z) > torch.rand((e, m), generator=g)).float()
    wt = (torch.rand((e, m), generator=g) < 0.85).float()
    off = 0.1 * torch.randn((e, m), generator=g)
    return tuple(t.to(dev) for t in (x, y, off, wt)), torch.zeros((e, d), device=dev)


def phase_dense_stack_bits(torch, dev="cuda"):
    """Phase 21 (f): the dense (E, M, D) stack contracts through elementwise
    products and ``tree_row_sum`` (ops/features.py), so a lane's bits do not
    follow the lane count. At the GAME driver's stack shape and at a wider
    D: the margins and the gradient transpose of the lanes a compaction
    keeps, computed as a batch of their own at each rung width, against the
    same lanes' rows of the full batch (the lanes whose bits differ are
    counted: all 0); then the compacted solves, host and device loop, LBFGS
    and TRON, bitwise the one-shot solve, every rung each one visited
    printed (each must visit more than one), with the solve walls."""
    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve, solve_stats
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    say("== phase 21 (f): the dense stack's lanes across batch counts, and its compacted "
        "solves against the one-shot solve")
    out = {}
    for label, e, m, d in DENSE_STACK_SHAPES:
        (x, y, off, wt), w0 = dense_stack_problem(torch, dev, e, m, d, SEED + e + d)
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        w = 0.3 * torch.randn((e, d), device=dev, generator=g)
        r = torch.randn((e, m), device=dev, generator=g)
        full = DenseFeatures(x)
        z_full, t_full = full.matvec(w), full.rmatvec(r)
        parted = {}
        widths = [n for n in (8, 64, 512, 4096, e // 2) if n < e]
        for n in widths:
            ids = torch.randperm(e, device=dev, generator=g)[:n].sort().values
            part = DenseFeatures(x.index_select(0, ids))
            z, t = part.matvec(w.index_select(0, ids)), part.rmatvec(r.index_select(0, ids))
            lanes = ((z != z_full.index_select(0, ids)).any(-1)
                     | (t != t_full.index_select(0, ids)).any(-1))
            parted[n] = int(lanes.sum())
        say(f"  (f) {label} E={e} M={m} D={d}: lanes whose margins or transpose bits differ "
            "from the full batch's, by batch width: "
            + ", ".join(f"{n}: {k} of {n}" for n, k in parted.items()))
        check(not any(parted.values()), f"(f) {label}: a lane's bits followed the batch width "
                                        f"{parted}")
        out[label] = {"lanes_parted_by_width": parted, "solves": {}}
        for opt in ("LBFGS", "TRON"):
            cfg = (OptimizerConfig.tron_default() if opt == "TRON"
                   else OptimizerConfig(max_iterations=60, tolerance=1e-7))
            kw = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[opt],
                      optimizer_config=cfg, regularization=RegularizationContext.l2(0.5))
            sync(torch)
            t0 = time.perf_counter()
            want = entity_lane_fns(**kw)[0](x, y, off, wt, w0)
            sync(torch)
            walls = {"one-shot": time.perf_counter() - t0}
            check(bool(torch.isfinite(want.value).all()),
                  f"(f) {label} {opt}: the one-shot solve is not finite")
            rungs, graphs = {}, {}
            for how, sched in (("host", SolveSchedule(DENSE_CHUNK)),
                               ("device", SolveSchedule(DENSE_CHUNK, loop="device"))):
                t0 = time.perf_counter()
                got = compacted_solve((x, y, off, wt), w0, schedule=sched, graphs=graphs, **kw)
                sync(torch)
                walls[how] = time.perf_counter() - t0
                rec = solve_stats.snapshot()[-1]
                rungs[how] = sorted({c.batch_lanes for c in rec.chunks}, reverse=True)
                check(bitwise_results(torch, got, want),
                      f"(f) {label} {opt} {how} loop: the compacted solve is not bitwise the "
                      f"one-shot solve (rungs {rungs[how]})")
                check(len(rungs[how]) > 1, f"(f) {label} {opt} {how} loop: the solve never "
                                           "compacted")
            out[label]["solves"][opt] = {"walls_s": walls, "rungs": rungs,
                                         "iterations_max": int(want.iterations.max())}
            say(f"  (f) {label} {opt}: host and device loop bitwise the one-shot solve; rungs "
                f"host {rungs['host']}, device {rungs['device']}; walls " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in walls.items()))
        del x, y, off, wt, w0, full, z_full, t_full
    return out


class UpdatePeak:
    """While installed, every ``cls.update`` call records the device memory
    it allocated at its peak: (allocated before, peak during), bytes."""

    def __init__(self, torch, cls):
        self.torch, self.cls, self.calls = torch, cls, []

    def __enter__(self):
        torch, inner = self.torch, self.cls.update
        self._inner = inner
        if not torch.cuda.is_available():  # a CPU rehearsal: nothing to measure
            return self

        def measured(coord, *args, **kwargs):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = inner(coord, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((before, torch.cuda.max_memory_allocated()))
            return out

        self.cls.update = measured
        return self

    def __exit__(self, *exc):
        self.cls.update = self._inner

    def summary(self):
        """(largest peak increment over an update, its absolute peak)."""
        return max(((peak - before, peak) for before, peak in self.calls), default=(0, 0))


STREAM_CHUNK_ROWS = 32768  # phase 22 (a): 8 chunks of phase 6's 262144 rows
STREAM_BUDGET_MB = 1  # phase 22 (b): 10 blocks of phase 20's data
STREAM_BLOCK_STOP = 3  # phase 22 (b): the subprocess stops at this block boundary


def copy_overlap(events, torch):
    """From a torch.profiler trace: H2D copy time, kernel time and the share
    of the copy time that overlaps kernel time (interval union of each)."""
    def union(spans):
        spans = sorted(spans)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    dev = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
    copies = union((ev.time_range.start, ev.time_range.end) for ev in dev
                   if "memcpy" in ev.name.lower() and "htod" in ev.name.lower().replace(" ", ""))
    kernels = union((ev.time_range.start, ev.time_range.end) for ev in dev
                    if "memcpy" not in ev.name.lower() and "memset" not in ev.name.lower())
    copy_us = sum(b - a for a, b in copies)
    kernel_us = sum(b - a for a, b in kernels)
    both = 0.0
    for a, b in copies:
        for c, d in kernels:
            both += max(0.0, min(b, d) - max(a, c))
    return {"h2d_copies": len(copies), "h2d_us": copy_us, "kernel_us": kernel_us,
            "overlap_share": both / copy_us if copy_us else None}


def _models_of(driver):
    return {lam: m.coefficients.means.double().cpu().numpy() for lam, m in driver.models}


def glm_models_held(label, got, want):
    """A streamed GLM driver's lambdas against an in-memory solve's: each
    objective at ``solver``, and the coefficients where both solves
    stopped at the same iteration for the same reason (f32 stopping tests
    pin objectives, not coefficients; ROADMAP Queue 3)."""
    (g_res, g_models), (w_res, w_models) = got, want
    compared = 0
    for lam in sorted(g_models):
        gr, wr = g_res[lam], w_res[lam]
        held(f"{label} lambda={lam:g}: objective", float(gr.value), float(wr.value))
        if (int(gr.iterations), int(gr.reason)) == (int(wr.iterations), int(wr.reason)):
            held(f"{label} lambda={lam:g}: coefficients", g_models[lam], w_models[lam])
            compared += 1
    check(compared > 0, f"{label}: no lambda stopped alike: no coefficients were compared")
    return compared


def phase_streaming_glm(torch, fused_glm, workdir, driver6, dev="cuda"):
    """Phase 22 (a), after phase 6 on its LIBSVM pair: the GLM driver with
    --streaming-chunk-rows (8 chunks) under LBFGS, with --tensor-cache cold
    then warm (the warm run parses no training file and spills nothing,
    and writes the cold run's model bytes), at PHOTON_PREFETCH_DEPTH=0
    (byte-equal), and under TRON; each held against the in-memory solve of
    the same optimizer (phase 6's run for LBFGS) at ``solver``; then one
    streamed value+gradient pass traced by torch.profiler (H2D copy time,
    kernel time and their overlap)."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.io import libsvm
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.optim.streaming import make_streaming_value_and_grad
    from photon_ml_tpu_torch.training import train_glm_grid
    from photon_ml_tpu_torch.types import OptimizerType

    say(f"== phase 22 (a): glm_driver.main --streaming-chunk-rows {STREAM_CHUNK_ROWS} on phase "
        f"6's LIBSVM pair ({N_FULL} x {GLM_DRIVER_D} + intercept): LBFGS with --tensor-cache "
        "cold and warm, at depth 0, and TRON")
    argv6 = driver6.argv
    cache = os.path.join(workdir, "tcache22")
    out, runs = {}, {}

    def run(label, flags, env=None):
        d = os.path.join(workdir, "out22-" + label)
        argv = [a if a != argv6[argv6.index("--output-directory") + 1] else d for a in argv6]
        sync(torch)
        libsvm.parse_counts.update(native_files=0, python_files=0)
        fused_glm.fused_value_grad_kernel.launches = 0
        spilled = dict(glm_driver.spill_counts)
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        t0 = time.perf_counter()
        try:
            driver = glm_driver.main(argv + ["--streaming-chunk-rows", str(STREAM_CHUNK_ROWS),
                                             "--device", dev] + flags)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        sync(torch)
        wall = time.perf_counter() - t0
        tot = driver.timer.totals
        rec = {"wall_s": wall, "preprocess_s": tot["preprocess"], "train_s": tot["train"],
               "parsed": dict(libsvm.parse_counts),
               "spilled": {k: glm_driver.spill_counts[k] - spilled[k] for k in spilled},
               "chunks": len(driver.streaming_source.loaders),
               "fused_launches": fused_glm.fused_value_grad_kernel.launches}
        check(driver.device.type == dev and driver.train_batch is None,
              f"(a) {label}: not a streamed run on {dev}")
        check(rec["chunks"] == -(-driver.streaming_source.num_rows // STREAM_CHUNK_ROWS),
              f"(a) {label}: {rec['chunks']} chunks")
        check(rec["parsed"]["python_files"] == 0, f"(a) {label}: a file went through the "
                                                   f"Python parser {rec['parsed']}")
        say(f"  (a) {label}: wall {wall:.2f} s, preprocess {rec['preprocess_s']:.2f} s, train "
            f"{rec['train_s']:.2f} s; LIBSVM files parsed {rec['parsed']['native_files']}, "
            f"spilled files {rec['spilled']['files']} chunks {rec['spilled']['chunks']}; "
            + "; ".join(f"lambda={lam:g} value {float(r.value):.6f} iters {int(r.iterations)}"
                        for lam, r in zip(driver.trained.weights, driver.trained.results)))
        runs[label] = driver
        out[label] = rec
        return driver, d

    def results(driver):
        return (dict(zip(driver.trained.weights, driver.trained.results)), _models_of(driver))

    cold, d_cold = run("lbfgs-cold", ["--tensor-cache", cache])
    check(out["lbfgs-cold"]["spilled"] == {"files": 1, "chunks": out["lbfgs-cold"]["chunks"]}
          and out["lbfgs-cold"]["parsed"]["native_files"] == 2,
          f"(a) the cold run: spilled {out['lbfgs-cold']['spilled']}, parsed "
          f"{out['lbfgs-cold']['parsed']}")
    glm_models_held("(a) streamed LBFGS vs phase 6", results(cold), results(driver6))
    warm, d_warm = run("lbfgs-warm", ["--tensor-cache", cache])
    check(out["lbfgs-warm"]["spilled"] == {"files": 0, "chunks": 0}
          and out["lbfgs-warm"]["parsed"]["native_files"] == 1,
          f"(a) the warm run decoded: spilled {out['lbfgs-warm']['spilled']}, parsed "
          f"{out['lbfgs-warm']['parsed']} (only the validation file may be parsed)")
    for sub in ("output", "best"):
        check(tree_bytes(os.path.join(d_warm, sub)) == tree_bytes(os.path.join(d_cold, sub)),
              f"(a) the warm run's {sub}/ bytes differ from the cold run's")
    _, d_sync = run("lbfgs-depth0", ["--tensor-cache", cache], {"PHOTON_PREFETCH_DEPTH": "0"})
    for sub in ("output", "best"):
        check(tree_bytes(os.path.join(d_sync, sub)) == tree_bytes(os.path.join(d_cold, sub)),
              f"(a) the depth-0 run's {sub}/ bytes differ from the pipelined run's")
    say(f"  (a) warm --tensor-cache: preprocess {out['lbfgs-warm']['preprocess_s']:.2f} s "
        f"against the cold {out['lbfgs-cold']['preprocess_s']:.2f} s, no training file parsed, "
        "nothing spilled, model bytes equal; PHOTON_PREFETCH_DEPTH=0: model bytes equal")
    tron, _ = run("tron", ["--tensor-cache", cache, "--optimizer", "TRON"])
    problem = GLMOptimizationProblem(tron.problem.task, OptimizerType.TRON,
                                     tron.problem.optimizer_config, tron.problem.regularization)
    ref = train_glm_grid(problem, driver6.train_batch, driver6.norm, LAMBDAS)
    ref_models = {lam: driver6._to_raw_space(m).coefficients.means.double().cpu().numpy()
                  for lam, m in zip(ref.weights, ref.models)}
    glm_models_held("(a) streamed TRON vs in-memory TRON",
                    results(tron), (dict(zip(ref.weights, ref.results)), ref_models))
    del ref

    # one streamed value+gradient pass under the profiler, on the warm chunks
    src = warm.streaming_source
    if dev != "cuda":
        return out
    vg = make_streaming_value_and_grad(src, warm.problem.objective, warm.norm, device="cuda")
    w = warm.trained.models[-1].coefficients.means
    vg(w)  # warm-up: pinned buffers and the side stream
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vg(w)
        sync(torch)
        pass_s = time.perf_counter() - t0
    ov = copy_overlap(prof.events(), torch)
    nbytes = sum(a.nbytes for load in src.loaders for a in load().values())
    check(ov["h2d_copies"] >= len(src.loaders), f"(a) the trace holds {ov['h2d_copies']} H2D "
                                                f"copies for {len(src.loaders)} chunks")
    say(f"  (a) one streamed value+gradient pass, traced: wall {pass_s:.4f} s for {nbytes} B of "
        f"chunk files ({nbytes / pass_s / 1e9:.2f} GB/s); H2D copies {ov['h2d_copies']} "
        f"{ov['h2d_us'] / 1e3:.3f} ms, kernels {ov['kernel_us'] / 1e3:.3f} ms, share of the "
        f"copy time overlapping kernel time "
        + ("n/a" if ov["overlap_share"] is None else f"{ov['overlap_share']:.3f}"))
    out["trace"] = dict(ov, pass_s=pass_s, chunk_bytes=nbytes)
    del runs, cold, warm, tron
    return out


def hold_block_slabs(torch, fused_sparse, manifest, label, indices=None, device="cuda"):
    """Both sparse kernels on every block's slab of a streaming manifest, or
    on the blocks ``indices`` (the per-block coordinate builds it on
    ``device``), held against their plain version as ``hold_driver_slab``
    holds the driver's slab."""
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.types import TaskType

    errs = {"gevm": 0.0, "hvp": 0.0}
    for i, ds, _, _ in manifest.iter_blocks(0, indices=indices, device=device):
        sub = RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION, sparse_kernel="pallas",
                                     solve_label=f"{label} block {i}")
        e_ = hold_driver_slab(torch, fused_sparse, sub)
        errs = {k: max(errs[k], e_[k]) for k in errs}
        del sub, ds
    return errs


def phase_streaming_game(torch, fused_sparse, workdir, inmem, dev="cuda"):
    """Phase 22 (b), after phase 21 on phase 20's data: the GAME driver with
    --streaming-random-effects and --re-memory-budget-mb STREAM_BUDGET_MB
    (at least 8 blocks), spec pallas, through --tensor-cache: held against
    phase 20 (c)'s in-memory run (objectives at ``solver``, per-entity
    scores by ``scores_held``); at PHOTON_PREFETCH_DEPTH=0 and with
    --solve-compaction 8 the model bytes equal the first run's; a
    subprocess stopped at a block boundary (exit 75) resumes to the same
    bytes; both sparse kernels held on every block's slab; the peak device
    memory of the streaming update against the budget and the in-memory
    update's."""
    from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
        StreamingRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.resilience import preemption

    c_driver, c_result, c_peak = inmem
    big = os.path.join(workdir, "skew")
    budget = int(STREAM_BUDGET_MB * 1e6)
    say(f"== phase 22 (b): game_training_driver.main --streaming-random-effects true "
        f"--re-memory-budget-mb {STREAM_BUDGET_MB} on phase 20's data ({SKEW_USERS} users), "
        "spec pallas, --tensor-cache; held against phase 20 (c)'s in-memory run")
    cache = os.path.join(workdir, "tcache22b")
    base = ["--train-input-dirs", os.path.join(big, "train"),
            "--validate-input-dirs", os.path.join(big, "validate"), "--device", dev,
            "--tensor-cache", cache, "--re-memory-budget-mb", str(STREAM_BUDGET_MB)]
    out = {"runs": {}}

    def run(label, flags, env=None):
        d = os.path.join(workdir, "out22b-" + label.replace(" ", "-"))
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            with UpdatePeak(torch, StreamingRandomEffectCoordinate) as peak:
                driver, wall, launches, stages, _ = run_game_training(
                    torch, fused_sparse, base + ["--output-dir", d] + flags, "pallas")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        result = driver.results[0][1]
        check(all(np.isfinite(result.objective_history)), f"(b) {label}: non-finite objective")
        inc, absolute = peak.summary()
        say(_run_line(f"(b) {label}", driver, wall, launches, stages)
            + f"; streaming update peak device memory {inc} B above its start ({absolute} B "
            "allocated in all)")
        out["runs"][label] = {"wall_s": wall, "stages_s": stages, "launches": launches,
                              "update_peak_increment_b": inc, "update_peak_b": absolute}
        return driver, result, d, launches

    d1, r1, dir1, l1 = run("streaming", GAME_FLAGS)
    manifest = d1.streaming_manifests["per-user"]
    n_blocks = len(manifest.blocks)
    check(n_blocks >= 8, f"(b): {n_blocks} blocks; the budget must give at least 8")
    check(manifest.max_block_bytes <= budget, "(b): a block's slab exceeds the budget")
    kernels_launched(d1, l1, "(b) streaming")
    out["blocks"] = [b["num_entities"] for b in manifest.blocks]
    out["max_block_bytes"] = manifest.max_block_bytes
    out["held_in_memory"] = scores_held("(b)", (d1, r1), (c_driver, c_result),
                                        "streaming vs in-memory")
    objectives_held("(b) streaming vs in-memory", r1, c_result)
    inc, absolute = out["runs"]["streaming"]["update_peak_increment_b"], \
        out["runs"]["streaming"]["update_peak_b"]
    say(f"  (b) {n_blocks} blocks (entities " + ", ".join(map(str, out["blocks"]))
        + f"), largest x-stack {manifest.max_block_bytes} B against the budget {budget} B; "
        f"streaming update peak {inc} B above its start ({inc / budget:.2f}x the budget) "
        f"against the in-memory update's {c_peak[0]} B ({c_peak[0] / max(inc, 1):.1f}x the "
        f"streaming one's); GEVM launches {l1['gevm']}")
    want = tree_bytes(os.path.join(dir1, "best"))
    # a subprocess stopped at a block boundary runs beside the depth-0 and
    # compacted runs (a cut, see CUTS): it only reads the cache (b) filled
    here = os.path.dirname(os.path.abspath(__file__))
    argv = base + ["--output-dir", os.path.join(workdir, "out22b-stopped"),
                   "--checkpoint-dir", os.path.join(workdir, "ck22b")] + GAME_FLAGS
    env = dict(os.environ, PHOTON_SPARSE_KERNEL="pallas",
               PHOTON_PREEMPT_AT=f"block:{STREAM_BLOCK_STOP}")
    stopped = start_rank_group("game_training_driver", argv, 1, workdir, "(22b stopped)",
                               plain=True, env=env)
    try:
        _, r0, dir0, _ = run("depth 0", GAME_FLAGS, {"PHOTON_PREFETCH_DEPTH": "0"})
        check(tree_bytes(os.path.join(dir0, "best")) == want,
              "(b) the depth-0 run's model bytes differ from the pipelined run's")
        _, rs, dirs, ls = run("compacted", GAME_FLAGS + ["--solve-compaction", str(SCHED_CHUNK)])
        check(tree_bytes(os.path.join(dirs, "best")) == want,
              "(b) the --solve-compaction run's model bytes differ from the one-shot run's")
        say("  (b) PHOTON_PREFETCH_DEPTH=0 and --solve-compaction 8: model bytes equal to the "
            f"pipelined one-shot run's (GEVM launches compacted {ls['gevm']})")
        sub_s, _ = join_rank_group(stopped, expect_rc=75)
    finally:
        stop_rank_groups(stopped)
    preemption.reset()
    # a new process resumes into an output dir of its own: the stopped run's
    # dir keeps the spilled state the checkpoint refers to by reference
    resumed_dir = os.path.join(workdir, "out22b-resumed")
    argv[argv.index("--output-dir") + 1] = resumed_dir
    resumed, wall_r, _, _, _ = run_game_training(torch, fused_sparse, argv, "pallas")
    check(tree_bytes(os.path.join(resumed_dir, "best")) == want,
          "(b) the run resumed from a block boundary wrote other model bytes")
    check(resumed.results[0][1].objective_history == r1.objective_history,
          "(b) the resumed objective history differs")
    say(f"  (b) a subprocess stopped at block boundary {STREAM_BLOCK_STOP}, beside the depth-0 "
        f"and compacted runs, exited 75 after {sub_s:.2f} s; resumed in {wall_r:.2f} s: model "
        "bytes and objective history equal")
    out.update(subprocess_s=sub_s, resume_s=wall_r)
    say("  (b) both sparse kernels on every block's slab")
    out["max_abs_err"] = (hold_block_slabs(torch, fused_sparse, manifest, "(b)")
                          if dev == "cuda" else {"gevm": 0.0, "hvp": 0.0})
    out["gevm_launches"] = l1["gevm"]
    # phase 24 retrains from the first run: its output dir and command
    out["_prior"] = (dir1, base)
    return out


def phase_cache_game(torch, fused_sparse, workdir, dev="cuda"):
    """Phase 22 (c), on phase 10's data: phase 10's command with
    --tensor-cache cold, then warm; the warm run never calls
    read_game_data on the training files (counted) and writes the cold
    run's model bytes; the preprocess spans of both. The warm run also
    takes --export-serve-store: its store is byte-equal to the
    ``build_model_store`` export of its saved model (phase 23 serves it)."""
    from photon_ml_tpu_torch.compile import ShapeBucketer
    from photon_ml_tpu_torch.io import avro_data
    from photon_ml_tpu_torch.serve import build_model_store

    say("== phase 22 (c): phase 10's command with --tensor-cache, cold then warm")
    cache = os.path.join(workdir, "tcache22c")
    real = avro_data.read_game_data
    calls = []

    def counted(files, *a, **kw):
        calls.append(len(files))
        return real(files, *a, **kw)

    out = {}
    avro_data.read_game_data = counted
    try:
        for label in ("cold", "warm"):
            calls.clear()
            d = os.path.join(workdir, f"out22c-{label}")
            argv = ["--train-input-dirs", os.path.join(workdir, "train"),
                    "--validate-input-dirs", os.path.join(workdir, "validate"),
                    "--output-dir", d, "--device", dev, "--tensor-cache", cache] + GAME_FLAGS
            if label == "warm":
                argv += ["--export-serve-store", os.path.join(workdir, SERVE_STORE)]
            driver, wall, launches, stages, _ = run_game_training(torch, fused_sparse, argv,
                                                                  "pallas")
            tot = driver.timer.totals
            out[label] = {"wall_s": wall, "stages_s": stages, "read_game_data_calls": len(calls),
                          "spans_s": {k: tot[k] for k in ("prepare-feature-maps",
                                                          "read-train-data",
                                                          "build-random-effect-datasets")}}
            say(_run_line(f"(c) {label}", driver, wall, launches, stages)
                + "; preprocess spans " + ", ".join(f"{k} {v:.2f} s"
                                                    for k, v in out[label]["spans_s"].items())
                + f"; read_game_data calls {len(calls)}")
            out[label]["dir"] = d
            if label == "warm":
                out[label]["driver_export_s"] = tot["export-serve-store"]
    finally:
        avro_data.read_game_data = real
    check(out["cold"]["read_game_data_calls"] == 2 and out["warm"]["read_game_data_calls"] == 1,
          f"(c) read_game_data calls cold {out['cold']['read_game_data_calls']}, warm "
          f"{out['warm']['read_game_data_calls']} (the warm run reads only the validation files)")
    check(tree_bytes(os.path.join(out["warm"]["dir"], "best"))
          == tree_bytes(os.path.join(out["cold"]["dir"], "best")),
          "(c) the warm run's model bytes differ from the cold run's")
    say(f"  (c) warm run: training files never decoded, model bytes equal; preprocess "
        f"{out['warm']['stages_s']['preprocess']:.2f} s against the cold "
        f"{out['cold']['stages_s']['preprocess']:.2f} s")
    store, again = os.path.join(workdir, SERVE_STORE), os.path.join(workdir, "store22c-again")
    build_model_store(os.path.join(out["warm"]["dir"], "best"), again, bucketer=ShapeBucketer())
    check(stores_equal(store, again), "(c) the warm run's --export-serve-store store differs "
                                      "from build_model_store's export of its saved model")
    out["export_serve_store_s"] = out["warm"]["driver_export_s"]
    say(f"  (c) warm run's --export-serve-store ({out['export_serve_store_s']:.2f} s): the "
        "store is byte-equal to build_model_store's export of the saved model (meta.json's "
        "source_model_dir aside)")
    shutil.rmtree(again)
    return out


def stores_equal(a, b) -> bool:
    """Two serve stores hold the same bytes, meta.json's source_model_dir
    aside."""
    ta, tb = tree_bytes(a), tree_bytes(b)
    if sorted(ta) != sorted(tb):
        return False
    for name in ta:
        if name == "meta.json":
            ma, mb = json.loads(ta[name]), json.loads(tb[name])
            ma.pop("source_model_dir"), mb.pop("source_model_dir")
            if ma != mb:
                return False
        elif ta[name] != tb[name]:
            return False
    return True


# --- phase 23: serving ---------------------------------------------------------

SERVE_STORE = "store22c"  # phase 22 (c)'s warm run exports phase 10's model here
SERVE_BATCH_ROWS = (1, 8, 32, 128)
SERVE_THREADS, SWAP_THREADS = 32, 16
# warmup's nnz cap: the fixed shard carries 33 nnz a row (rung 64)
SERVE_WARM_NNZ = 64
# phase 23 (b): rows served at max_batch_rows 1, and at 8 and 128 (depth
# cuts, see CUTS)
SERVE_PREFIX_ROWS = {1: 2048, 8: 4096, 128: 4096}
SERVE_SUBPROCESS_ROWS = 256  # phase 23 (e): score lines, half before the swap line


def serve_requests(workdir):
    """Phase 10's validation rows as serve-protocol request rows (the
    features and ids the batch driver reads from the same Avro file)."""
    from photon_ml_tpu_torch.io import avro as avro_io

    recs = avro_io.read_container(os.path.join(workdir, "validate", "part-00000.avro"))
    return [{"features": {"fixedFeatures": r["fixedFeatures"], "userFeatures": r["userFeatures"]},
             "ids": {"userId": (r.get("metadataMap") or {}).get("userId")}} for r in recs]


def served_concurrently(server, requests, threads):
    """Single-row requests from ``threads`` client threads, each sending its
    next request when its last one is answered (at most ``threads`` in
    flight); (scores in request order, wall seconds)."""
    scores = np.full(len(requests), np.nan, np.float32)

    def client(k):
        for i in range(k, len(requests), threads):
            got = server.score_rows([requests[i]])
            if len(got) != 1:
                raise RuntimeError(f"request {i} came back with {len(got)} scores")
            scores[i] = got[0]

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(client, k) for k in range(threads)]:
            f.result()
    return scores, time.perf_counter() - t0


def batch_split(torch, srv, requests, rows, dev):
    """One batch of ``rows`` requests: featurizing it on one thread (ms),
    scoring it padded (host ms, median of 30 calls: uploads, kernels and
    the read back), and on the card the kernels' device time over 20 calls
    of a torch.profiler trace against its wall (the device's busy share)."""
    t0 = time.perf_counter()
    batch = srv.featurize(requests[:rows])
    feat_ms = (time.perf_counter() - t0) * 1e3
    padded = batch.padded(srv.bucketer)
    calls = []
    for _ in range(33):
        t0 = time.perf_counter()
        srv._score_with(srv.model, padded)
        calls.append(time.perf_counter() - t0)
    out = {"featurize_ms": feat_ms, "score_ms": statistics.median(calls[3:]) * 1e3,
           "padded_rows": padded.num_rows}
    if dev != "cpu":
        tr = trace_split(torch, lambda: [srv._score_with(srv.model, padded) for _ in range(20)],
                         ())
        out["device_busy_share"] = (tr["kernel_s"] or 0.0) / tr["wall_s"]
    return out


def device_bytes(bundle) -> int:
    """Bytes of a server generation's coefficient tensors on the device."""
    ts = [w for *_, w in bundle.fixed]
    for *_, slab, scales in bundle.random:
        ts += [slab] + ([] if scales is None else [scales])
    return sum(t.numel() * t.element_size() for t in ts)


def quant_budget(meta, requests, ref):
    """tests/tolerances.quant_score_budget over tests/game_test_utils.
    serving_score_budget: per row, ||values||_1 of each random effect's
    shard (the intercept's 1 included) times the coordinate's pinned
    coefficient budget, plus 1e-6 + 1e-6 |reference score|."""
    budget = np.zeros(len(requests))
    for e in meta["random"]:
        coeff = float(e["quantization"]["coeff_err_budget"])
        sections = GAME_SECTIONS[e["shard"]]
        budget += coeff * np.array([1.0 + sum(abs(float(f["value"])) for sec in sections
                                              for f in q["features"].get(sec) or [])
                                    for q in requests])
    return budget + 1e-6 + 1e-6 * np.abs(np.asarray(ref, np.float64))


def phase_serving(torch, workdir, dev="cuda"):
    """Phase 23, on phase 10's data and model (phase 22 (c)'s warm run and
    its --export-serve-store store). (a) bf16 and int8 exports of the same
    model; slab bytes on disk and on the device by store dtype. (b) the
    validation rows as concurrent single-row requests (32 client threads) at
    max_batch_rows 1, 8, 32 and 128 after warmup (each client sends its
    next request when its last one is answered): p50/p99 latency, QPS and
    batch fill, and one full batch's featurize and scoring times; no new
    batch shape after warmup; at 32 the f32 scores np.array_equal to
    cli.game_scoring_driver.main's device scores on the same rows
    (--offheap-indexmap-dir <store>/features). Warmup covers nnz up to 64:
    a row carries 33 fixed-effect nnz (rung 64), so a cap of 16 would
    leave every request a shape warmup never saw. (c) the bf16 and
    int8 stores' scores within the pinned quantization budget of the f32
    scores. (d) a swap under load (16 client threads) between the stores of
    two of phase 19 (a)'s lambda models: no request dropped, no new shape in
    the probe, the new model's scores served after. (e) serve_driver as a
    subprocess fed JSON lines (score lines, one swap line, score lines,
    EOF): every response equals the in-process server's score."""
    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.compile import ShapeBucketer
    from photon_ml_tpu_torch.serve import (ModelStore, ModelSwapper, ScoringServer, ServeStats,
                                           build_model_store)

    say("== phase 23: serving phase 10's model (phase 22 (c)'s --export-serve-store) on "
        f"{dev}: store dtypes, latency against max_batch_rows, quantized scores, a swap under "
        "load, the serve driver as a subprocess")
    model = os.path.join(workdir, "out22c-warm", "best")
    stores = {"f32": os.path.join(workdir, SERVE_STORE)}
    t0 = time.perf_counter()
    for dt in ("bf16", "int8"):
        stores[dt] = os.path.join(workdir, f"store23-{dt}")
        build_model_store(model, stores[dt], bucketer=ShapeBucketer(), store_dtype=dt)
    say(f"  (a) bf16 and int8 stores exported in {time.perf_counter() - t0:.2f} s")
    requests = serve_requests(workdir)
    out = {"rows": len(requests), "stores": {}, "batch_rows": {}}

    def server_of(store_dir, rows, stats=None):
        srv = ScoringServer(ModelStore(store_dir), shard_sections=GAME_SECTIONS,
                            max_batch_rows=rows, max_wait_ms=2.0,
                            stats=stats or ServeStats(), device=dev)
        srv.warmup(warm_nnz=SERVE_WARM_NNZ)
        return srv

    for dt, path in stores.items():
        srv = server_of(path, 128)
        fp = srv.store.footprint()
        out["stores"][dt] = {"slab_bytes_disk": fp["slab_bytes_disk"],
                             "device_bytes": device_bytes(srv.model),
                             "slab_shape": list(srv.store.random[0].slab.shape)}
        if dt != "f32":
            # every row as one request, split into 128-row batches; held
            # against the f32 scores in (c)
            out["stores"][dt]["scores"] = srv.score_rows(requests)
        srv.close()
        say(f"  (a) {dt}: slab {tuple(out['stores'][dt]['slab_shape'])}, "
            f"{fp['slab_bytes_disk']} slab bytes on disk (slab and scales files), "
            f"{out['stores'][dt]['device_bytes']} coefficient bytes on the device "
            "(fixed effect, slab and scales)")

    # (b) the f32 store against max_batch_rows
    drv = run_scoring(torch, ["--input-dirs", os.path.join(workdir, "validate"),
                              "--game-model-input-dir", model,
                              "--output-dir", os.path.join(workdir, "scores23"),
                              "--offheap-indexmap-dir", os.path.join(stores["f32"], "features"),
                              "--feature-shard-id-to-feature-section-keys-map",
                              "global:fixedFeatures|per_user:userFeatures", "--device", dev])[0]
    check(drv.data.num_rows == len(requests), "(b) the driver and the requests count different "
                                              "rows")
    for rows in SERVE_BATCH_ROWS:
        reqs = requests[:SERVE_PREFIX_ROWS.get(rows, len(requests))]
        srv = server_of(stores["f32"], rows)
        split = batch_split(torch, srv, requests, rows, dev)
        srv.stats.reset()
        scores, wall = served_concurrently(srv, reqs, SERVE_THREADS)
        snap = srv.stats.snapshot()
        new_shapes = srv.new_request_compiles()
        srv.close()
        check(new_shapes == 0, f"(b) max_batch_rows {rows}: {new_shapes} new request shapes "
                               "after warmup")
        check(np.array_equal(scores, drv.scores[:len(reqs)]) if rows == 32 else
              bool(np.isfinite(scores).all()),
              f"(b) max_batch_rows {rows}: served scores differ from the scoring driver's")
        if rows == 32:
            served32 = scores
        out["batch_rows"][rows] = {k: snap[k] for k in (
            "requests", "batches", "p50_ms", "p99_ms", "qps", "batch_fill_ratio",
            "avg_batch_rows", "avg_requests_per_batch")}
        out["batch_rows"][rows]["wall_s"] = wall
        out["batch_rows"][rows]["bitwise_driver"] = bool(np.array_equal(
            scores, drv.scores[:len(reqs)]))
        out["batch_rows"][rows]["one_full_batch"] = split
        say(f"  (b) max_batch_rows {rows:3d}: {len(reqs)} single-row requests from "
            f"{SERVE_THREADS} closed-loop client threads in {wall:.2f} s; p50 "
            f"{snap['p50_ms']:.3f} ms, p99 {snap['p99_ms']:.3f} ms, {snap['qps']:.1f} req/s, "
            f"batch fill {snap['batch_fill_ratio']:.4f} ({snap['avg_requests_per_batch']} "
            f"requests a batch); new shapes after warmup 0; scores bitwise the driver's "
            f"{out['batch_rows'][rows]['bitwise_driver']}; one full batch: featurize "
            f"{split['featurize_ms']:.3f} ms on one thread, score {split['score_ms']:.3f} ms "
            f"({split['padded_rows']} padded rows)"
            + (f", device busy {split['device_busy_share']:.3f} of it"
               if "device_busy_share" in split else ""))
    say(f"  (b) at max_batch_rows 32 the {len(requests)} served f32 scores are np.array_equal "
        "to game_scoring_driver.main's device scores")

    # (c) quantized stores within their budget of the f32 scores
    for dt in ("bf16", "int8"):
        meta = ModelStore(stores[dt]).meta
        got = out["stores"][dt].pop("scores")
        budget = quant_budget(meta, requests, served32)
        diff = np.abs(got.astype(np.float64) - served32)
        check(bool((diff <= budget).all()), f"(c) {dt}: {int((diff > budget).sum())} scores "
                                            "outside the quantization budget")
        check(not np.array_equal(got, served32), f"(c) {dt}: scores bitwise the f32 ones")
        out["stores"][dt]["max_abs_score_err"] = float(diff.max())
        out["stores"][dt]["coeff_err_budget"] = meta["random"][0]["quantization"][
            "coeff_err_budget"]
        say(f"  (c) {dt}: max |score - f32 score| {diff.max():.3e}, every row within its "
            f"budget (largest {budget.max():.3e})")

    # (d) a swap under load between two of phase 19 (a)'s lambda models
    lam = [os.path.join(workdir, "grid-per-combo", "all", str(i), "") for i in (0, 1)]
    lam_stores = []
    for i, m in enumerate(lam):
        lam_stores.append(os.path.join(workdir, f"store23-lambda{i}"))
        build_model_store(m, lam_stores[-1], bucketer=ShapeBucketer())
    srv = server_of(lam_stores[0], 32)
    before = srv.score_rows(requests[:64])
    swapper = ModelSwapper(srv)
    fired, errors = [], []
    stop = threading.Event()

    def client(k):
        i = k
        while not stop.is_set() or i < k + SWAP_THREADS * 4:
            try:
                fired.append(srv.score_rows([requests[i % len(requests)]]))
            except Exception as exc:  # noqa: BLE001 — a dropped request is what (d) counts
                errors.append(repr(exc))
            i += SWAP_THREADS
    threads = [threading.Thread(target=client, args=(k,)) for k in range(SWAP_THREADS)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    report = swapper.swap(lam_stores[1])
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    after = srv.score_rows(requests[:64])
    srv.close()
    fresh = server_of(lam_stores[1], 32)
    want_after = fresh.score_rows(requests[:64])
    fresh.close()
    check(not errors, f"(d) {len(errors)} requests failed during the swap: {errors[:3]}")
    check(report["dropped_requests"] == 0 and report["new_compiles"] == 0
          and report["shape_compatible"], f"(d) swap report {report}")
    check(np.array_equal(after, want_after) and not np.array_equal(before, after),
          "(d) after the swap the server does not serve the new model's scores")
    out["swap"] = {"report": {k: report[k] for k in ("generation", "shape_compatible",
                                                     "new_compiles", "dropped_requests")},
                   "requests_during": len(fired), "failed": len(errors)}
    say(f"  (d) swap under load ({SWAP_THREADS} threads, {len(fired)} requests answered, "
        f"{len(errors)} failed): generation {report['generation']}, shape-compatible, "
        f"{report['new_compiles']} new shapes in the probe, {report['dropped_requests']} "
        "dropped; the new model's scores served after")

    # (e) the serve driver as a subprocess
    n = SERVE_SUBPROCESS_ROWS
    lines = [json.dumps({"id": f"a{i}", "rows": [q]}) for i, q in enumerate(requests[:n // 2])]
    lines.append(json.dumps({"cmd": "swap", "store_dir": lam_stores[1], "id": "swap"}))
    lines += [json.dumps({"id": f"b{i}", "rows": [q]})
              for i, q in enumerate(requests[n // 2:n])]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve_driver",
         "--model-store-dir", stores["f32"],
         "--feature-shard-id-to-feature-section-keys-map",
         "global:fixedFeatures|per_user:userFeatures", "--max-batch-rows", "32",
         "--warm-nnz", str(SERVE_WARM_NNZ), "--device", dev],
        input="\n".join(lines) + "\n", capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"(e) serve_driver exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    by_id = {r.get("id"): r for r in map(json.loads, proc.stdout.splitlines())}
    check(by_id.get("swap", {}).get("swap", {}).get("new_compiles") == 0,
          f"(e) the swap line's response {by_id.get('swap')}")
    fresh = server_of(lam_stores[1], 32)
    want_b = fresh.score_rows(requests[n // 2:n])
    fresh.close()
    got_a = np.asarray([by_id[f"a{i}"]["scores"][0] for i in range(n // 2)], np.float32)
    got_b = np.asarray([by_id[f"b{i}"]["scores"][0] for i in range(n - n // 2)], np.float32)
    check(np.array_equal(got_a, served32[:n // 2]) and np.array_equal(got_b, want_b),
          "(e) the serve driver's responses differ from the in-process server's scores")
    summary = [line for line in proc.stderr.splitlines() if "serve stats:" in line]
    check(bool(summary), "(e) the serve driver logged no stats summary at shutdown")
    out["subprocess"] = {"wall_s": wall, "responses": len(by_id)}
    say(f"  (e) serve_driver subprocess: {n} score lines and one swap line in {wall:.2f} s "
        "(start and warmup included); every response equals the in-process server's score; "
        f"its shutdown summary: {summary[-1].split('serve stats: ')[-1]}")
    return out


# depth cut for the call's time limit, every check kept
# --- phase 24: the daily retrain loop -----------------------------------------

RETRAIN_NEW_USERS = 64  # phase 24 (b): users the delta file brings, 4-12 rows each
RETRAIN_SMALL_SHARE = 0.05  # phase 24 (c): the share of the 2000 users given 2 new rows


def delta_plan_summary(plan):
    """A delta plan as comparable values: file classes (by name), each
    coordinate's status and reason, the short-circuit and the decisions."""
    f = plan.files
    return ({k: [os.path.basename(p_) for p_ in getattr(f, k)]
             for k in ("unchanged", "changed", "new", "removed")},
            {n: [c.status, c.reason] for n, c in plan.coordinates.items()},
            plan.short_circuit, list(plan.describe_decisions()))


def planned_lines(driver):
    """Every planned decision of a --plan auto run, with its predicted and
    realized cost."""
    return [d.describe() for d in driver.plan.decisions if d.planned_choice() is not None]


def phase_retrain(torch, fused_sparse, workdir, stream_game, dev="cuda"):
    """Phase 24, the daily retrain loop, last, on phase 20's data: phase 22
    (b)'s first streaming run is yesterday's run. (a) the same command with
    --warm-start-from it: a short circuit (the prior model copied forward,
    no ingest, no kernel launch, byte-equal best/). (b) a new training part
    file (2 rows for every user of the prior's middle block, RETRAIN_NEW_USERS
    new users, phase 20's feature names), then --warm-start-from the prior:
    unchanged blocks frozen (their entities' coefficients bitwise the
    prior's), the dirty and new blocks re-solved warm through the GEVM
    kernel (both sparse kernels held on their slabs), the fixed effect
    warm-started through the fused kernel, retrain.json chained. (c) on
    phase 20 (f)'s 2000 users, bucketed: a cold run, a delta file for
    RETRAIN_SMALL_SHARE of the users, warm runs on the card and on the CPU
    (the per-bucket warm stacks built, bitwise equal on both, and exported
    back bitwise the prior model's rows; equal delta plans; scores held by
    ``scores_held``). (d) --plan off gives the cold run's model bytes;
    --plan auto cold plans from static priors and writes cost-model.json,
    and its warm run loads it; every planned decision is printed with its
    predicted and realized cost. Nothing is claimed of the times."""
    from photon_ml_tpu_torch import retrain
    from photon_ml_tpu_torch.algorithm.streaming_random_effect import StreamingREManifest
    from photon_ml_tpu_torch.compile import compile_stats
    from photon_ml_tpu_torch.compile.cost import COST_MODEL_FILENAME
    from photon_ml_tpu_torch.optim.scheduler import solve_stats
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.ops import fused_glm

    prior_dir, base = stream_game["_prior"]
    cold = stream_game["runs"]["streaming"]
    say(f"== phase 24: the daily retrain loop (--warm-start-from) on phase 20's data, from "
        f"phase 22 (b)'s first streaming run; then --plan on phase 20 (f)'s {SKEW_SMALL_USERS} "
        "users")
    out = {"runs": {}}

    def run(label, argv, spec="pallas"):
        # each run's realized costs are its own, as in a process of its own
        solve_stats.reset()
        compile_stats.reset()
        driver, wall, launches, stages, counts = run_game_training(torch, fused_sparse, argv,
                                                                   spec)
        say(_run_line(label, driver, wall, launches, stages)
            + f"; Avro files read natively {counts['native_files']}")
        out["runs"][label] = {"wall_s": wall, "stages_s": stages, "launches": launches,
                              "spans_s": dict(driver.timer.totals)}
        return driver, launches

    def means(model_dir, driver):
        imap = driver.shard_index_maps["per_user"]
        return model_io.load_random_effect(os.path.join(model_dir, "best"), "per-user", imap)[0]

    # (a) nothing changed
    dir_a = os.path.join(workdir, "out24a")
    a, la = run("(a) unchanged", base + ["--output-dir", dir_a, "--warm-start-from", prior_dir]
                + GAME_FLAGS)
    check(a.delta_plan is not None and a.delta_plan.short_circuit,
          "(a): the unchanged rerun did not short-circuit")
    check(not any(la.values()), f"(a): the short-circuited run launched kernels {la}")
    check(a.results == [], "(a): the short-circuited run trained")
    check(tree_bytes(os.path.join(dir_a, "best")) == tree_bytes(os.path.join(prior_dir, "best")),
          "(a): best/ differs from the prior model's bytes")
    span = a.timer.totals["delta-short-circuit"]
    say(f"  (a) short circuit: span delta-short-circuit {span:.3f} s; best/ byte-equal to the "
        f"prior's; kernel launches {la}; retrain.json model {retrain.load_prior_manifest(dir_a).model_dir}")
    out["short_circuit_s"] = span

    # (b) a delta: the prior's middle block's users get 2 rows each, new users join
    prior = retrain.load_prior_manifest(prior_dir)
    prior_sm = StreamingREManifest.load(prior.coordinates["per-user"].streaming_manifest_dir)
    mid = len(prior_sm.blocks) // 2
    mid_users = [prior_sm.vocab[v] for v in prior_sm.load_block_meta(mid, "cpu").entity_ids]
    rng = np.random.default_rng(SEED + 240)
    new_users = [f"user{SKEW_USERS + j}" for j in range(RETRAIN_NEW_USERS)]
    user_rows = {u: 2 for u in mid_users}
    user_rows.update({u: int(rng.integers(4, 13)) for u in new_users})
    n_new = write_delta_avro(os.path.join(workdir, "skew", "train", "part-00001.avro"),
                             user_rows, rng)
    say(f"  (b) delta file part-00001.avro: {n_new} rows, 2 for each of the {len(mid_users)} "
        f"users of the prior's block {mid} of {len(prior_sm.blocks)} and 4-12 for each of "
        f"{len(new_users)} new users")
    dir_b = os.path.join(workdir, "out24b")
    b, lb = run("(b) delta", base + ["--output-dir", dir_b, "--warm-start-from", prior_dir]
                + GAME_FLAGS)
    plan = b.delta_plan
    check(plan is not None and not plan.short_circuit, "(b): no delta plan")
    check(len(plan.files.new) == 1 and not plan.files.changed and not plan.files.removed,
          f"(b): files {plan.files.describe()}")
    deltas = b.block_deltas.get("per-user") or []
    check(deltas, "(b): the blocks were not built by the delta builder (block reuse off)")
    by = {s_: sum(d.status == s_ for d in deltas) for s_ in ("unchanged", "dirty", "new")}
    frozen = b._frozen_blocks.get("per-user", frozenset())
    check(frozen and frozen == {d.index for d in deltas if d.status == "unchanged"},
          f"(b): frozen blocks {sorted(frozen)} are not the unchanged ones")
    check(by["dirty"] >= 1 and by["new"] >= 1, f"(b): block statuses {by}")
    check(any(d.status == "dirty" and d.prior_index == mid for d in deltas),
          f"(b): the prior's block {mid} is not dirty")
    dirty = plan.dirty_entities.get("userId", set())
    check(set(mid_users) | set(new_users) == dirty, "(b): the dirty set is not the delta's users")
    sm = b.streaming_manifests["per-user"]
    m_prior, m_b = means(prior_dir, b), means(dir_b, b)
    frozen_users = [sm.vocab[v] for i in sorted(frozen) for v in sm.load_block_meta(i, "cpu").entity_ids]
    check(all(np.array_equal(m_prior[u], m_b[u]) for u in frozen_users),
          "(b): a frozen entity's coefficients differ from the prior model's")
    moved = sum(not np.array_equal(m_prior[u], m_b[u]) for u in mid_users)
    check(moved == len(mid_users), f"(b): {len(mid_users) - moved} dirty users did not move")
    check(all(u in m_b for u in new_users), "(b): a new user is missing from the model")
    kernels_launched(b, lb, "(b) delta")
    fixed_err = hold_driver_fixed(torch, fused_glm, b.combo_coords[0]["fixed"], "phase 24 (b)")
    resolved = [i for i in range(len(sm.blocks)) if i not in frozen]
    say(f"  (b) both sparse kernels on the {len(resolved)} re-solved blocks' slabs")
    errs = (hold_block_slabs(torch, fused_sparse, sm, "(b)", indices=resolved)
            if dev == "cuda" else {"gevm": 0.0, "hvp": 0.0})
    chained = retrain.load_prior_manifest(dir_b)
    check(chained.model_dir == os.path.abspath(os.path.join(dir_b, "best"))
          and os.path.isdir(chained.coordinates["per-user"].streaming_manifest_dir),
          "(b): retrain.json does not chain to this run")
    reasons = sorted({d.reason for d in deltas if d.status != "unchanged"})
    say(f"  (b) blocks {len(deltas)}: unchanged {by['unchanged']}, dirty {by['dirty']}, new "
        f"{by['new']} (reasons: {reasons}); frozen {len(frozen)} blocks ({len(frozen_users)} users) bitwise the "
        f"prior model's; {moved} dirty users moved, {len(new_users)} new users solved; "
        f"GEVM launches {lb['gevm']} against 22 (b)'s cold run's {cold['launches']['gevm']}; "
        f"train stage {out['runs']['(b) delta']['stages_s']['train']:.2f} s against "
        f"{cold['stages_s']['train']:.2f} s (nothing is claimed)")
    out.update(blocks=by, frozen_blocks=len(frozen), frozen_users=len(frozen_users),
               dirty_users=len(dirty), max_abs_err=errs, fixed_max_abs_err=fixed_err,
               launches={"cold": cold["launches"], "short-circuit": la, "delta": lb})
    # what phase 26 (d) is held against: the delta file, the run, its frozen users
    out["_delta_b"] = {"file": os.path.join(workdir, "skew", "train", "part-00001.avro"),
                       "dir": dir_b, "n_new": n_new, "mid_users": mid_users,
                       "frozen_users": sorted(frozen_users)}

    # (c) and (d): in-memory bucketed warm starts and the planner, 2000 users
    small = os.path.join(workdir, "skew-small")

    def small_argv(label, device=dev, extra=()):
        return (["--train-input-dirs", os.path.join(small, "train"),
                 "--validate-input-dirs", os.path.join(small, "validate"), "--device", device,
                 "--output-dir", os.path.join(workdir, "out24-" + label)]
                + BUCKETED_FLAGS + list(extra))

    c_cold, lc = run("(c) cold", small_argv("c-cold"))
    kernels_launched(c_cold, lc, "(c) cold")
    dir_cc = os.path.join(workdir, "out24-c-cold")
    _, _ = run("(d) plan off", small_argv("d-off", extra=["--plan", "off"]))
    check(tree_bytes(os.path.join(workdir, "out24-d-off", "best"))
          == tree_bytes(os.path.join(dir_cc, "best")),
          "(d): the --plan off run's model bytes differ from the run without the flag")
    # the device loop under --plan auto: its solve ledger, its graph
    # captures (the port's traces) and the buckets' ledgers are the realized
    # costs the run feeds back
    planned = ["--plan", "auto", "--solve-compaction", f"device:{SCHED_CHUNK}"]
    d_cold, _ = run("(d) plan auto cold", small_argv("d-auto", extra=planned))
    src = next(x for x in d_cold.plan.decisions if x.policy == "cost-model")
    check(src.action in ("priors", "degraded") and "static priors" in src.reason,
          f"(d): the cold run's cost model came from {src.describe()}")
    dir_da = os.path.join(workdir, "out24-d-auto")
    sidecar = os.path.join(dir_da, COST_MODEL_FILENAME)
    check(os.path.exists(sidecar), "(d): the cold run wrote no cost-model.json")
    observed = json.load(open(sidecar))["observations"] if os.path.exists(sidecar) else {}
    check(bool(observed), "(d): the cold run realized no cost")
    say(f"  (d) --plan off: model bytes equal to the run without the flag; --plan auto cold: "
        f"{src.describe()}; cost-model.json keys {sorted(observed)}")
    for line_ in planned_lines(d_cold):
        say(f"  (d) cold planned: {line_}")

    vocab_small = sorted(c_cold.train_data.id_vocabs["userId"])
    rng_c = np.random.default_rng(SEED + 241)
    picked = rng_c.choice(len(vocab_small), size=int(RETRAIN_SMALL_SHARE * len(vocab_small)),
                          replace=False)
    n_small = write_delta_avro(os.path.join(small, "train", "part-00001.avro"),
                               {vocab_small[i]: 2 for i in sorted(picked)}, rng_c)
    say(f"  (c) delta file: {n_small} rows for {len(picked)} of {len(vocab_small)} users")
    pair = {}
    for label, device in (("(c) warm card", dev), ("(c) warm cpu", "cpu")):
        tag = label.split()[-1]
        argv = small_argv(f"c-warm-{tag}", device, ["--warm-start-from", dir_cc])
        driver, lw = run(label, argv)
        check(driver.delta_plan is not None and driver._warm_bucketed.get("per-user"),
              f"{label}: the per-bucket warm stacks were not built")
        log = open(os.path.join(workdir, f"out24-c-warm-{tag}", "photon-ml-tpu-game.log")).read()
        check(re.search(r"warm-starting \d+ bucket stacks from the prior model", log) is not None,
              f"{label}: the warm-start log line is missing")
        if device != "cpu":
            kernels_launched(driver, lw, label)
        pair[label] = (driver, driver.results[0][1])
    # the warm stacks: the card run's are the CPU run's bit for bit (one
    # prior, one bucket layout), and exported back through the buckets'
    # layout they are the prior model's rows, bit for bit
    card_d, cpu_d = pair["(c) warm card"][0], pair["(c) warm cpu"][0]
    stacks = card_d._warm_bucketed["per-user"]
    check(len(stacks) == len(cpu_d._warm_bucketed["per-user"]) and all(
        np.array_equal(a, b) for a, b in zip(stacks, cpu_d._warm_bucketed["per-user"])),
          "(c): the card run's warm stacks differ from the CPU run's")
    coord = card_d.combo_coords[0]["per-user"]
    back = coord.entity_export_by_raw_id(tuple(torch.from_numpy(w).to(dev) for w in stacks))[0]
    prior_rows = model_io.load_random_effect(os.path.join(dir_cc, "best"), "per-user",
                                             card_d.shard_index_maps["per_user"])[0]
    moved = [r for r, row in prior_rows.items() if not np.array_equal(back.get(r), row)]
    check(not moved and len(prior_rows) == len(back),
          f"(c): {len(moved)} of {len(prior_rows)} prior rows come back from the warm stacks "
          f"changed, e.g. {moved[:5]}")
    say(f"  (c) warm stacks: {len(stacks)} buckets, bitwise the CPU run's; exported back, "
        f"{len(prior_rows)} of {len(prior_rows)} prior rows bitwise the prior model's")
    card_plan, cpu_plan = (delta_plan_summary(pair[k][0].delta_plan)
                           for k in ("(c) warm card", "(c) warm cpu"))
    check(card_plan == cpu_plan, f"(c): the card's delta plan {card_plan} is not the CPU's "
                                 f"{cpu_plan}")
    out["held_card_cpu"] = scores_held("(c)", pair["(c) warm card"], pair["(c) warm cpu"])
    out["delta_plan_small"] = card_plan
    say(f"  (c) the delta plans of the card and CPU runs are equal: {card_plan[1]}")

    d_warm, _ = run("(d) plan auto warm", small_argv("d-auto-warm", extra=planned + [
        "--warm-start-from", dir_da]))
    src = next(x for x in d_warm.plan.decisions if x.policy == "cost-model")
    check(src.action == "loaded", f"(d): the warm run's cost model: {src.describe()}")
    lines = planned_lines(d_warm)
    check(lines and all("predicted=" in line_ for line_ in lines),
          "(d): a planned decision without a predicted cost")
    say(f"  (d) --plan auto warm: {src.describe()}")
    for line_ in lines:
        say(f"  (d) warm planned: {line_}")
    out["plan"] = {"cold": planned_lines(d_cold), "warm": lines}
    return out


MH_PARTS = 4  # phase 25: phase 10's rows over 4 part files, so 2 ranks both decode rows
MH_TIMEOUT_S = 300  # phase 25: a rank group that runs longer fails the phase
ELEMENTWISE = (1e-4, 1e-5)  # tests/tolerances.py "elementwise" (rtol, atol), f32
# phase 25 holds two GAME models' per-user coefficients by the norm of their
# difference over the reference's norm, and by the count of users with a
# coefficient outside the solver tolerance. An f32 LBFGS lane may stop an
# iteration apart when the residuals it solves on differ in the last bits,
# so a few users always move; the sound readings on an NVIDIA H100 (PERF.md,
# phase 25) were 3.66e-4 and 72 of 20000 users for (b) against phase 10 and
# 6.21e-4 and 69 for (c) against (b). The limits sit a few times above
# them: one bucket's or one rank's slice of users solved wrong exceeds both.
MH_REL_LIMIT = 3e-3
MH_OUTSIDE_LIMIT = 200
HOLD_RANK = "--hold-rank"  # the argument that runs this script as one training rank


def _free_init(workdir):
    """A fresh file:// rendezvous under ``workdir`` for one group."""
    import uuid

    return f"file://{os.path.join(workdir, 'pg-' + uuid.uuid4().hex)}"


def start_rank_group(module, argv, world, workdir, label, hold=False, plain=False, env=None,
                     head=None):
    """Start ``world`` processes of ``python -m
    photon_ml_tpu_torch.cli.<module>`` on the card with one file://
    rendezvous; every rank starts with its kernel counts at 0 (a fresh
    process). With ``hold`` each rank runs the training driver through this
    script's HOLD_RANK mode, which then holds the kernels on the rank's own
    coordinates. ``plain`` starts one process of the module with ``argv``
    alone (no rendezvous), ``env`` replaces the environment, ``head``
    replaces the command before the flags. Each rank's
    output goes to files under ``workdir`` (a pipe nobody reads while
    another group is joined could fill). Returns the handle
    ``join_rank_group`` takes."""
    env = env or dict(os.environ, PHOTON_SPARSE_KERNEL="pallas")
    head = head or ([os.path.abspath(__file__), HOLD_RANK] if hold
                    else ["-m", f"photon_ml_tpu_torch.cli.{module}"])
    mh = [] if plain else ["--multihost-coordinator", _free_init(workdir),
                           "--multihost-num-processes", str(world)]
    tag = re.sub(r"\W+", "-", label).strip("-")
    logs = [tuple(open(os.path.join(workdir, f"{tag}-rank{r}.{k}"), "w+")
                  for k in ("out", "err")) for r in range(world)]
    t0, launched_at = time.perf_counter(), time.time()
    procs = [subprocess.Popen(
        [sys.executable] + head + mh + ([] if plain else ["--multihost-process-id", str(r)])
        + argv,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=out, stderr=err,
        text=True) for r, (out, err) in enumerate(logs)]
    # each rank's exit time, taken when it exits, however late the join
    exited = [None] * world

    def watch(r, proc):
        proc.wait()
        exited[r] = (time.perf_counter(), time.time())

    for r, proc in enumerate(procs):
        threading.Thread(target=watch, args=(r, proc), daemon=True).start()
    return label, procs, logs, t0, launched_at, exited


def join_rank_group(handle, expect_rc=0):
    """Wait for a started group under MH_TIMEOUT_S (killing it and failing
    past that); fail if a rank exited other than ``expect_rc``. Returns (wall, [(returncode,
    stdout, stderr, launched_at, exited_at)]): epoch seconds, each rank's
    exit as its watcher saw it, so a group joined after it ended keeps its
    own wall."""
    label, procs, logs, t0, launched_at, exited = handle
    while None in exited:
        if time.perf_counter() - t0 > MH_TIMEOUT_S:
            for p_ in procs:
                p_.kill()
                p_.wait()
            fail(f"{label}: the {len(procs)} ranks did not finish within {MH_TIMEOUT_S} s")
        time.sleep(0.05)
    outs = []
    for p_, (out, err), (_, at) in zip(procs, logs, exited):
        out.seek(0)
        err.seek(0)
        outs.append((p_.returncode, out.read(), err.read(), launched_at, at))
        out.close()
        err.close()
    for r, (rc, _, err, *_) in enumerate(outs):
        if rc != expect_rc:
            say(f"  {label} rank {r} exited {rc}; its stderr ends:\n{err[-4000:]}")
            fail(f"{label}: rank {r} exited {rc}")
    return max(t for t, _ in exited) - t0, outs


def stop_rank_groups(*handles):
    """Kill every rank of the started groups that is still running (a
    failed check must leave no process behind)."""
    for handle in handles:
        for p_ in handle[1]:
            if p_.poll() is None:
                p_.kill()
                p_.wait()


def _rank_summaries(out_dir, world, outs=None):
    """Each rank's photon-ml-tpu-mh-<r>.json; with the group's ``outs``,
    also its start-up (launch to ``main``), set-up (``main`` to the run:
    the flags parsed and checked) and exit (run's end to the process's end)
    seconds."""
    summaries = []
    for r in range(world):
        with open(os.path.join(out_dir, f"photon-ml-tpu-mh-{r}.json")) as f:
            summary = json.load(f)
        if outs is not None:
            summary["startup_s"] = summary["entered_at"] - outs[r][3]
            summary["setup_s"] = summary["started_at"] - summary["entered_at"]
            summary["exit_s"] = outs[r][4] - summary["finished_at"]
        summaries.append(summary)
    return summaries


def _game_models(out_dir, idx):
    """(fixed-effect means, {raw id: per-user means}) of a saved model, by
    the off-heap index's feature positions."""
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.offheap import load_shard_index_map

    best = os.path.join(out_dir, "best")
    fe = model_io.load_fixed_effect(best, "fixed", load_shard_index_map(idx, "global"))[0]
    re_means = model_io.load_random_effect(best, "per-user",
                                           load_shard_index_map(idx, "per_user"))[0]
    return fe, re_means


def models_held(label, got, want):
    """Two GAME models: the fixed effect's coefficients elementwise at the
    solver tolerance; the per-user coefficients by the norm of the
    difference over the reference's norm within MH_REL_LIMIT, and at most
    MH_OUTSIDE_LIMIT users with a coefficient outside the solver tolerance.
    Returns (max abs diff, users outside the elementwise tolerance,
    bitwise)."""
    (fe_a, re_a), (fe_b, re_b) = got, want
    check(set(re_a) == set(re_b), f"{label}: the entity sets differ")
    held(f"{label}: fixed-effect coefficients", fe_a, fe_b)
    users = sorted(re_b)
    a = np.stack([re_a[k] for k in users])
    b = np.stack([re_b[k] for k in users])
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    check(rel <= MH_REL_LIMIT, f"{label}: per-user coefficients |diff| / |ref| {rel:.3g} > "
                               f"{MH_REL_LIMIT}")
    outside = int(np.any(np.abs(a - b) > SOLVER_ATOL + SOLVER_RTOL * np.abs(b), axis=1).sum())
    check(outside <= MH_OUTSIDE_LIMIT, f"{label}: {outside} of {len(users)} users outside the "
                                       f"elementwise tolerance > {MH_OUTSIDE_LIMIT}")
    worst = max(float(np.max(np.abs(fe_a - fe_b))), float(np.max(np.abs(a - b))))
    bitwise = bool(np.array_equal(fe_a, fe_b) and np.array_equal(a, b))
    say(f"  {label}: per-user |diff| / |ref| {rel:.3g} (limit {MH_REL_LIMIT}), users outside "
        f"the elementwise tolerance {outside} of {len(users)} (limit {MH_OUTSIDE_LIMIT})")
    return worst, outside, bitwise


def _scores_by_uid(scores_dir):
    from photon_ml_tpu_torch.io import avro as avro_io

    out = {}
    for f in sorted(os.listdir(scores_dir)):
        for rec in avro_io.read_container(os.path.join(scores_dir, f)):
            out[int(rec["uid"])] = rec["predictionScore"]
    return np.asarray([out[k] for k in sorted(out)], np.float32)


def run_multihost_in_process(torch, fused_sparse, argv, workdir):
    """The multihost driver at one rank in this process, its kernel counts
    set to 0 just before: its summary dict (launches, backend, ...)."""
    from photon_ml_tpu_torch.cli import game_multihost_driver
    from photon_ml_tpu_torch.ops import fused_glm

    os.environ["PHOTON_SPARSE_KERNEL"] = "pallas"
    sync(torch)
    for c in (fused_sparse.sparse_gevm_kernel, fused_sparse.sparse_hvp_kernel,
              fused_glm.fused_value_grad_kernel):
        c.launches = 0
    t0 = time.perf_counter()
    try:
        result = game_multihost_driver.main(
            ["--multihost-coordinator", _free_init(workdir), "--multihost-num-processes", "1",
             "--multihost-process-id", "0"] + argv)
    finally:
        del os.environ["PHOTON_SPARSE_KERNEL"]
    sync(torch)
    result["in_process_wall_s"] = time.perf_counter() - t0
    return result


def hold_rank_kernels(torch, fused_glm, fused_sparse, result, label):
    """The kernels on one multihost rank's own coordinates, against their
    plain versions: the fused kernel on its fixed-effect rows, both sparse
    kernels on its per-user slab; under --streaming-random-effects both
    sparse kernels on every block the rank owns (the streaming fixed
    effect's chunk passes are the plain objective: no fused kernel on that
    path, ``"fused_glm"`` None). {"fused_glm", "gevm", "hvp"}: max |kernel
    - plain|."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
    )

    coords = result["coordinates"]
    re_coord = coords["per-user"]
    if isinstance(re_coord, PerHostStreamingRandomEffectCoordinate):
        return {"fused_glm": None, **hold_block_slabs(torch, fused_sparse, re_coord.manifest,
                                                      label, device=re_coord._device)}
    held_ = {"fused_glm": hold_driver_fixed(torch, fused_glm, coords["fixed"],
                                            f"phase 25 {label}")}
    held_.update(hold_driver_slab(torch, fused_sparse, coords["per-user"].coordinate))
    return held_


def hold_rank(argv):
    """One rank of phase 25 (c) or 26 (c) (``chip_smoke.py --hold-rank
    <driver flags>``): the multihost training driver, then the kernels held on
    this rank's coordinates. The driver has written its summary, launch
    counts included, before the holds launch anything; the holds go to
    kernel-holds-<rank>.json beside it."""
    import torch

    from photon_ml_tpu_torch.cli import game_multihost_driver
    from photon_ml_tpu_torch.ops import fused_glm, fused_sparse

    result = game_multihost_driver.main(argv)
    rank = result["process_id"]
    holds = hold_rank_kernels(torch, fused_glm, fused_sparse, result, f"rank {rank}")
    with open(os.path.join(os.path.dirname(result["output"]), f"kernel-holds-{rank}.json"),
              "w") as f:
        json.dump(holds, f)


def phase_multihost(torch, fused_sparse, fused_glm, workdir, dev="cuda"):
    """Phase 25: multi-process GAME training on phase 10's data at full
    width. (a) the GAME driver with --distributed on a 1-rank NCCL group
    (model bytes = phase 10's); (b) the multihost driver, 1 rank, NCCL
    (coefficients within solver of phase 10's); (c) the multihost driver, 2
    ranks on the one card over gloo, beside (a) and (b) (within solver of
    (b); 2 part files; fused-GLM and GEVM launches on each rank;
    checkpointed). (b) and each
    rank of (c) hold the kernels on their own blocks against the plain
    versions. (d) the multihost scoring driver, 2 ranks, on (c)'s model
    against the single-process scoring driver at elementwise; (e) (c)
    extended by one iteration resumes only the new updates; (d) and (e) run
    side by side, started here and joined by ``finish_multihost``."""
    say(f"== phase 25: multi-process GAME training on phase 10's data ({GAME_USERS} users): "
        "--distributed, the multihost driver at 1 rank (NCCL) and 2 ranks (gloo, one card), "
        "multihost scoring, the 2-rank run resumed from its checkpoint")
    out = {"runs": {}}
    idx = os.path.join(workdir, "index-maps")  # phase 13's index of these training rows
    # phase 10's rows in the same order over MH_PARTS part files
    mh_dir = os.path.join(workdir, "mh-data")
    write_game_avro(mh_dir, GAME_USERS, SEED, parts=MH_PARTS)
    mh_flags = ["--train-input-dirs", os.path.join(mh_dir, "train"),
                "--validate-input-dirs", os.path.join(mh_dir, "validate"), "--device", dev,
                "--offheap-indexmap-dir", idx, "--delete-output-dir-if-exists", "true"] + GAME_FLAGS
    ckpt = os.path.join(workdir, "mh-ckpt")
    # (c) runs beside (a) and (b), which run in this process: it only reads
    # the part files above; (e) resumes it from its checkpoint
    group_c = start_rank_group("game_multihost_driver",
                               ["--output-dir", os.path.join(workdir, "out-mh2"), "--checkpoint-dir",
                                ckpt] + mh_flags, 2, workdir, "(25c)", hold=True)
    try:
        # (a) the single-process driver on a 1-rank group; it reads phase 10's
        # training columns from phase 19 (a)'s tensor cache (a cut, see CUTS)
        base = ["--train-input-dirs", os.path.join(workdir, "train"),
                "--validate-input-dirs", os.path.join(workdir, "validate"), "--device", dev,
                "--tensor-cache", os.path.join(workdir, "tcache19")]
        dist_out = os.path.join(workdir, "out-dist")
        driver, wall, launches, stages, _ = run_game_training(
            torch, fused_sparse, base + ["--output-dir", dist_out, "--distributed", "true"]
            + GAME_FLAGS, "pallas")
        fixed = driver.combo_coords[0]["fixed"]
        with open(os.path.join(dist_out, "photon-ml-tpu-game.log")) as f:
            group = re.search(r"distributed: (\d+)-rank mesh \((\w+), ", f.read())
        check(group is not None and group.groups() == ("1", "nccl"),
              f"(a) did not run on a 1-rank NCCL group: {group and group.groups()}")
        kernels_launched(driver, launches, "phase 25 (a)")
        same = tree_bytes(os.path.join(dist_out, "best")) == tree_bytes(
            os.path.join(workdir, "out-pallas", "best"))
        check(same, "(a) --distributed at one rank did not write phase 10's model bytes")
        holds = {"a": {"fused_glm": hold_driver_fixed(torch, fused_glm, fixed, "phase 25 (a)"),
                       **hold_driver_slab(torch, fused_sparse,
                                          driver.combo_coords[0]["per-user"])}}
        out["runs"]["a"] = {"backend": "nccl", "world": 1, "wall_s": wall,
                            "launches": launches, "stages_s": stages}
        say(f"  (a) game_training_driver --distributed, beside (c): backend nccl, world 1, "
            f"wall {wall:.2f} s, launches {launches}; model bytes equal phase 10's")
        # (b) in this process (its counts set to 0 just before): a 1-rank
        # NCCL group needs no second process
        result_b = run_multihost_in_process(
            torch, fused_sparse, ["--output-dir", os.path.join(workdir, "out-mh1")] + mh_flags,
            workdir)
        holds["b"] = [hold_rank_kernels(torch, fused_glm, fused_sparse, result_b, "(b)")]
        joined_c = join_rank_group(group_c)
    finally:
        stop_rank_groups(group_c)
    phase10 = _game_models(os.path.join(workdir, "out-pallas"), idx)
    runs_b_c = {}
    for key, world in (("b", 1), ("c", 2)):
        o = os.path.join(workdir, f"out-mh{world}")
        if world == 1:
            ranks, wall = [result_b], result_b["in_process_wall_s"]
        else:
            wall, outs = joined_c
            ranks = _rank_summaries(o, world, outs)
            holds[key] = []
            for r in range(world):
                with open(os.path.join(o, f"kernel-holds-{r}.json")) as f:
                    holds[key].append(json.load(f))
        want_backend = "nccl" if world == 1 else "gloo"
        check(all(r["backend"] == want_backend for r in ranks),
              f"({key}) backends {[r['backend'] for r in ranks]}, not {want_backend}")
        check(all(r["objective_history"] == ranks[0]["objective_history"] for r in ranks),
              f"({key}) the ranks walked different trajectories")
        for r, summary in enumerate(ranks):
            check(summary["launches"]["fused_glm"] > 0 and summary["launches"]["gevm"] > 0,
                  f"({key}) rank {r} launched {summary['launches']}: a kernel of the path did "
                  "not launch")
        parts = sorted(os.listdir(os.path.join(o, "best", "random-effect", "per-user",
                                               "coefficients")))
        check(len(parts) == world, f"({key}) random-effect part files {parts}")
        runs_b_c[key] = _game_models(o, idx)
        out["runs"][key] = {"backend": want_backend, "world": world, "wall_s": wall,
                            "rank_walls_s": [r["wall_s"] for r in ranks],
                            "rank_startup_s": [r.get("startup_s") for r in ranks],
                            "rank_setup_s": [r.get("setup_s") for r in ranks],
                            "rank_exit_s": [r.get("exit_s") for r in ranks],
                            "launches_by_rank": [r["launches"] for r in ranks],
                            "kernel_holds_by_rank": holds[key],
                            "objective_history": ranks[0]["objective_history"],
                            "auc": ranks[0]["validation_metrics"]["AUC"]}
        say(f"  ({key}) game_multihost_driver at {world} rank(s)"
            + ("" if world == 1 else ", beside (a), (b) and phase 26's (b)-(c) ranks")
            + f": backend {want_backend}, wall "
            f"{wall:.2f} s (in the driver " + ", ".join(f"{r['wall_s']:.2f}" for r in ranks)
            + " s" + ("" if world == 1 else "; start-up " + ", ".join(
                f"{r['startup_s']:.2f}" for r in ranks) + " s; set-up " + ", ".join(
                f"{r['setup_s']:.2f}" for r in ranks) + " s; exit " + ", ".join(
                f"{r['exit_s']:.2f}" for r in ranks) + " s")
            + "), launches by rank " + "; ".join(str(r["launches"]) for r in ranks)
            + f", AUC {ranks[0]['validation_metrics']['AUC']:.6f}, parts {parts}; each rank's "
            "kernels on its own blocks within tolerance of the plain versions, max |diff| "
            + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in h.items()) for h in holds[key]))
    worst, outside, bitwise = models_held("(b) against phase 10", runs_b_c["b"], phase10)
    out["runs"]["b"].update(max_abs_diff_vs_phase10=worst, users_outside_vs_phase10=outside,
                            bitwise_vs_phase10=bitwise)
    say(f"  (b) within solver of phase 10's model: max |diff| {worst:.3g}; bitwise {bitwise}")
    worst, outside, bitwise = models_held("(c) against (b)", runs_b_c["c"], runs_b_c["b"])
    out["runs"]["c"].update(max_abs_diff_vs_b=worst, users_outside_vs_b=outside,
                            bitwise_vs_b=bitwise)
    say(f"  (c) within solver of (b): max |diff| {worst:.3g}; bitwise {bitwise}")
    every = [holds["a"]] + holds["b"] + holds["c"]
    out["fixed_max_abs_err"] = max(h["fused_glm"] for h in every)
    out["max_abs_err"] = {k: max(h[k] for h in every) for k in ("gevm", "hvp")}
    # (d) multihost scoring of (c)'s model and (e) (c) extended by one
    # iteration, which restores (c)'s last step and runs only the 2 new
    # updates, run side by side: each only reads what (c) wrote
    score_flags = ["--input-dirs", os.path.join(mh_dir, "validate"),
                   "--game-model-input-dir", os.path.join(workdir, "out-mh2", "best"),
                   "--feature-shard-id-to-feature-section-keys-map",
                   "global:fixedFeatures|per_user:userFeatures", "--offheap-indexmap-dir", idx,
                   "--evaluator-type", "AUC", "--device", dev, "--delete-output-dir-if-exists",
                   "true"]
    steps_c = sorted(os.listdir(os.path.join(ckpt, "combo-0")))
    flags3 = list(mh_flags)
    flags3[flags3.index("--num-iterations") + 1] = "3"
    o3 = os.path.join(workdir, "out-mh2-3")
    group_d = start_rank_group("game_multihost_scoring_driver",
                               ["--output-dir", os.path.join(workdir, "mh-scores")] + score_flags,
                               2, workdir, "(25d)")
    group_e = start_rank_group("game_multihost_driver", ["--output-dir", o3, "--checkpoint-dir",
                                                         ckpt] + flags3, 2, workdir,
                               "(25e) extended to 3 iterations")
    out["_groups"] = [group_d, group_e]
    try:
        single, swall = run_scoring(torch, ["--output-dir", os.path.join(workdir, "sp-scores")]
                                    + score_flags)
    except BaseException:
        stop_rank_groups(group_d, group_e)
        raise
    out["_finish"] = {"single": single, "swall": swall, "steps_c": steps_c, "o3": o3,
                      "ckpt": ckpt}
    return out


def finish_multihost(workdir, out):
    """Phase 25 (d) and (e), joined after phase 26 (a) ran beside them and
    beside 26 (d) and (e): (d)'s
    multihost scores against the scoring driver's at elementwise; (e)
    restored (c)'s step 4 and ran only steps 5-6."""
    fin = out.pop("_finish")
    group_d, group_e = out.pop("_groups")
    single, swall, steps_c, o3, ckpt = (fin[k] for k in ("single", "swall", "steps_c", "o3",
                                                          "ckpt"))
    wall, _ = join_rank_group(group_d)
    w3, outs = join_rank_group(group_e)
    got = _scores_by_uid(os.path.join(workdir, "mh-scores", "scores"))
    want = _scores_by_uid(os.path.join(workdir, "sp-scores", "scores"))
    check(got.shape == want.shape and np.allclose(got, want, rtol=ELEMENTWISE[0],
                                                  atol=ELEMENTWISE[1]),
          "(d) multihost scores differ from the scoring driver's beyond elementwise")
    out["runs"]["d"] = {"backend": "gloo", "world": 2, "wall_s": wall, "single_wall_s": swall,
                        "max_abs_diff": float(np.max(np.abs(got - want))),
                        "auc_single": single.metrics["AUC"]}
    say(f"  (d) multihost scoring at 2 ranks, beside (e) and 26 (a), (d), (e): wall "
        f"{wall:.2f} s; "
        f"{len(got)} scores "
        f"within elementwise of the scoring driver's (max |diff| "
        f"{out['runs']['d']['max_abs_diff']:.3g}, single-process wall {swall:.2f} s)")
    resumed = _rank_summaries(o3, 2, outs)
    steps3 = sorted(os.listdir(os.path.join(ckpt, "combo-0")))
    check(steps_c == ["step-3", "step-4"] and steps3 == ["step-5", "step-6"],
          f"(e) checkpoint steps {steps_c} then {steps3}")
    check(all(r["objective_history"][:4] == out["runs"]["c"]["objective_history"]
              and len(r["objective_history"]) == 6 for r in resumed),
          "(e) the resumed run did not restore (c)'s 4 updates")
    out["runs"]["e"] = {"backend": "gloo", "world": 2, "wall_s": w3,
                        "rank_walls_s": [r["wall_s"] for r in resumed],
                        "launches_by_rank": [r["launches"] for r in resumed],
                        "steps": [steps_c, steps3]}
    say(f"  (e) (c) extended to 3 iterations, beside (d) and 26 (a), (d), (e): wall {w3:.2f} s "
        "(in the driver "
        + ", ".join(f"{r['wall_s']:.2f}" for r in resumed) + " s), restoring step 4 "
        f"(steps {steps_c}) and running only steps 5-6 ({steps3}); launches by rank "
        + "; ".join(str(r["launches"]) for r in resumed))
    return out


def start_multihost_streaming(workdir, retrain, dev="cuda"):
    """Phase 26's data and its rank groups (b) and (c), started after
    phase 24 and run beside 26 (a): phase 20's rows in the same order over
    MH_PARTS part files, an off-heap index of them, the streaming multihost
    driver at 1 NCCL rank (b) and at 2 gloo ranks through --hold-rank (c).
    Phase 24 (b)'s delta part file moves out of 22 (b)'s training dir (26
    (a) runs 22 (b)'s command) into (d)'s. Returns what
    ``phase_multihost_streaming`` takes."""
    from photon_ml_tpu_torch.cli import feature_indexing

    say(f"== phase 26 (start): phase 20's data ({SKEW_USERS} users) over {MH_PARTS} part files "
        "and its off-heap index; the streaming multihost driver at 1 NCCL rank (b) and at 2 gloo "
        "ranks (c), started beside 26 (a)")
    delta_dir = os.path.join(workdir, "mh-skew-delta")
    os.makedirs(delta_dir, exist_ok=True)
    shutil.move(retrain["_delta_b"]["file"], os.path.join(delta_dir, f"part-{MH_PARTS:05d}.avro"))
    data = os.path.join(workdir, "mh-skew")
    t0 = time.perf_counter()
    write_game_avro(data, SKEW_USERS, SEED + 20, rows_per_user=skewed_rows(SKEW_USERS, SKEW_SEED),
                    parts=MH_PARTS)
    idx = os.path.join(workdir, "index26")
    feature_indexing.main(["--data-input-dirs", os.path.join(data, "train"), "--output-dir", idx,
                           "--partition-num", "8", "--format", "OFFHEAP",
                           "--feature-shard-id-to-feature-section-keys-map",
                           "global:fixedFeatures|per_user:userFeatures"])
    data_s = time.perf_counter() - t0
    say(f"  Avro over {MH_PARTS} part files and the off-heap index in {data_s:.1f} s")
    flags = ["--train-input-dirs", os.path.join(data, "train"),
             "--validate-input-dirs", os.path.join(data, "validate"), "--device", dev,
             "--offheap-indexmap-dir", idx, "--delete-output-dir-if-exists", "true",
             "--streaming-random-effects", "true", "--re-memory-budget-mb",
             str(STREAM_BUDGET_MB)] + GAME_FLAGS
    groups = [start_rank_group("game_multihost_driver",
                               ["--output-dir", os.path.join(workdir, f"out26{key}")] + flags,
                               world, workdir, f"(26{key})", hold=world > 1)
              for key, world in (("b", 1), ("c", 2))]
    return {"data": data, "idx": idx, "flags": flags, "data_s": data_s, "groups": groups,
            "delta_dir": delta_dir}


def phase_multihost_streaming(torch, fused_sparse, workdir, stream_game, started, dev="cuda",
                              also_start=None):
    """Phase 26, last, beside phase 25, on phase 20's data over MH_PARTS
    part files with an off-heap index of them: per-host streaming GAME
    training. (b) (started before phase 25) the multihost driver, 1 NCCL
    rank, streaming: per-user
    coefficients held against 22 (b) by phase 25's limits, the fixed effect
    at ``solver``; (c) (started with (b)) the same at 2 gloo ranks on the
    one card: every coefficient bitwise (b)'s, each rank's GEVM and HVP
    bitwise their plain versions on its owned blocks (--hold-rank). Then
    starts (d) and (e), which ``finish_multihost_streaming`` joins: (d)
    --warm-start-from (c) with phase 24 (b)'s delta part file beside (c)'s
    files; (e) --warm-start-from (c) on (c)'s own files; and beside them
    runs (a), the GAME driver with --distributed --streaming-random-effects
    on a 1-rank NCCL group: 22 (b)'s first run's model bytes. ``also_start()``
    runs once (d) and (e) have started, before (a): phase 27 (b)'s ranks."""
    prior_dir, base22 = stream_game["_prior"]
    data, idx, flags = started["data"], started["idx"], started["flags"]
    group_b, group_c = started["groups"]
    say(f"== phase 26: per-host streaming GAME training on phase 20's data over {MH_PARTS} part "
        f"files, --re-memory-budget-mb {STREAM_BUDGET_MB}: --distributed "
        "--streaming-random-effects, the multihost driver streaming at 1 rank (NCCL) and 2 ranks "
        "(gloo, one card), --warm-start-from at 2 ranks")
    out = {"runs": {}, "data_s": started["data_s"]}
    joined = {"b": join_rank_group(group_b), "c": join_rank_group(group_c)}
    phase22 = _game_models(prior_dir, idx)
    models, holds = {}, {"b": []}
    for key, world in (("b", 1), ("c", 2)):
        o = os.path.join(workdir, f"out26{key}")
        wall, outs_ = joined[key]
        ranks = _rank_summaries(o, world, outs_)
        if world > 1:
            for r in range(world):
                with open(os.path.join(o, f"kernel-holds-{r}.json")) as f:
                    holds["c"] = holds.get("c", []) + [json.load(f)]
            for h in holds["c"]:
                check(h["gevm"] == 0.0 and h["hvp"] == 0.0,
                      f"26 (c) a rank's sparse kernels are not bitwise their plain version on "
                      f"its blocks: {h}")
        want_backend = "nccl" if world == 1 else "gloo"
        check(all(r["backend"] == want_backend for r in ranks),
              f"26 ({key}) backends {[r['backend'] for r in ranks]}, not {want_backend}")
        check(all(r["objective_history"] == ranks[0]["objective_history"] for r in ranks),
              f"26 ({key}) the ranks walked different trajectories")
        for r, summary in enumerate(ranks):
            check(summary["launches"]["gevm"] > 0,
                  f"26 ({key}) rank {r} launched {summary['launches']}: GEVM did not launch")
        blocks = [sorted(r["streaming_blocks"]["per-user"]) for r in ranks]
        check(sorted(g for b in blocks for g in b) == list(range(len(stream_game["blocks"]))),
              f"26 ({key}) owned blocks {blocks} are not a split of 22 (b)'s "
              f"{len(stream_game['blocks'])} blocks")
        parts = sorted(os.listdir(os.path.join(o, "best", "random-effect", "per-user",
                                               "coefficients")))
        check(len(parts) == world, f"26 ({key}) random-effect part files {parts}")
        models[key] = _game_models(o, idx)
        out["runs"][key] = {"backend": want_backend, "world": world, "wall_s": wall,
                            "rank_walls_s": [r["wall_s"] for r in ranks],
                            "blocks_by_rank": blocks,
                            "launches_by_rank": [r["launches"] for r in ranks],
                            "lane_iterations_by_rank": [r["block_lane_iterations"]
                                                        for r in ranks],
                            "kernel_holds_by_rank": holds[key],
                            "objective_history": ranks[0]["objective_history"],
                            "auc": ranks[0]["validation_metrics"]["AUC"]}
        say(f"  ({key}) game_multihost_driver --streaming-random-effects at {world} rank(s)"
            + ", beside phase 25" + ("" if world == 1 else " and (b)")
            + f": backend {want_backend}, wall {wall:.2f} s (in the driver "
            + ", ".join(f"{r['wall_s']:.2f}" for r in ranks) + " s), blocks by rank "
            + "; ".join(str(b) for b in blocks) + ", launches by rank "
            + "; ".join(str(r["launches"]) for r in ranks) + ", block lane-iterations by rank "
            + ", ".join(str(r["block_lane_iterations"]) for r in ranks)
            + f", AUC {ranks[0]['validation_metrics']['AUC']:.6f}, parts {parts}"
            + ("" if world == 1 else "; each rank's GEVM and HVP bitwise their plain versions "
               "on its owned blocks' slabs"))
    worst, outside, bitwise = models_held("26 (b) against 22 (b)", models["b"], phase22)
    out["runs"]["b"].update(max_abs_diff_vs_22b=worst, users_outside_vs_22b=outside,
                            bitwise_vs_22b=bitwise)
    say(f"  (b) held against 22 (b): max |diff| {worst:.3g}; bitwise {bitwise}")
    same = (np.array_equal(models["c"][0], models["b"][0]) and set(models["c"][1])
            == set(models["b"][1]) and all(np.array_equal(models["c"][1][k], models["b"][1][k])
                                           for k in models["b"][1]))
    check(same, "26 (c): the 2-rank coefficients are not bitwise (b)'s")
    gevm_b = out["runs"]["b"]["launches_by_rank"][0]["gevm"]
    gevm_c = [n["gevm"] for n in out["runs"]["c"]["launches_by_rank"]]
    check(sum(gevm_c) == gevm_b,
          f"26 (c): GEVM launches by rank {gevm_c} do not sum to (b)'s {gevm_b}")
    say("  (c) every coefficient (fixed effect and each user's) bitwise (b)'s; GEVM launches by "
        f"rank {gevm_c} sum to (b)'s {gevm_b}")
    out["max_abs_err"] = {k: max(h[k] for h in holds["c"]) for k in ("gevm", "hvp")}

    # (d) phase 24 (b)'s delta part file; (e) (c)'s own files: both warm
    # from (c), side by side
    out_c = os.path.join(workdir, "out26c")
    # (c)'s part files where they were, the delta file after them
    flags_d = list(flags)
    flags_d[flags_d.index("--train-input-dirs") + 1] = (os.path.join(data, "train") + ","
                                                         + started["delta_dir"])
    started["groups"] += [
        start_rank_group("game_multihost_driver", ["--output-dir", os.path.join(
            workdir, "out26d"), "--warm-start-from", out_c] + flags_d, 2, workdir, "(26d)"),
        start_rank_group("game_multihost_driver", ["--output-dir", os.path.join(
            workdir, "out26e"), "--warm-start-from", out_c] + flags, 2, workdir, "(26e)")]
    if also_start is not None:
        also_start()
    # (a) the single-process driver's per-host streaming coordinate on a
    # 1-rank group, 22 (b)'s first command plus --distributed
    out_a = os.path.join(workdir, "out26a")
    driver, wall, launches, stages, _ = run_game_training(
        torch, fused_sparse, base22 + ["--output-dir", out_a, "--distributed", "true"]
        + GAME_FLAGS, "pallas")
    with open(os.path.join(out_a, "photon-ml-tpu-game.log")) as f:
        group = re.search(r"distributed: (\d+)-rank mesh \((\w+), ", f.read())
    check(group is not None and group.groups() == ("1", "nccl"),
          f"26 (a) did not run on a 1-rank NCCL group: {group and group.groups()}")
    check("sharding=perhost_streaming" in driver.plan.describe(),
          f"26 (a): {driver.plan.describe()}")
    kernels_launched(driver, launches, "phase 26 (a)")
    check(tree_bytes(os.path.join(out_a, "best")) == tree_bytes(os.path.join(prior_dir, "best")),
          "26 (a) --distributed --streaming-random-effects did not write 22 (b)'s model bytes")
    out["runs"]["a"] = {"backend": "nccl", "world": 1, "wall_s": wall, "launches": launches,
                        "stages_s": stages}
    say(_run_line("(a) --distributed --streaming-random-effects, beside (d) and (e)", driver,
                  wall, launches, stages) + "; model bytes equal 22 (b)'s first run's")
    out["_finish"] = {"models_c": models["c"], "idx": idx}
    return out


def finish_multihost_streaming(workdir, started, out, retrain):
    """Phase 26 (d) and (e), run beside each other. (d) --warm-start-from
    (c) with phase 24 (b)'s delta part file beside (c)'s four: the prior
    blocking pinned, the blocks with no new rows frozen (their users'
    coefficients bitwise (c)'s), the rest re-solved warm, on the plan both
    ranks agree; each rank's GEVM launches below (c)'s; the new users in
    the model; held against phase 24 (b), the single-process streaming
    delta run of the same rows from 22 (b): the same frozen users, the
    coefficients under phase 25's limits. (e) --warm-start-from (c) on
    (c)'s files: both coordinates frozen on both ranks, (c)'s model bytes,
    no GEVM launch."""
    fin = out.pop("_finish")
    delta_b = retrain["_delta_b"]
    group_d, group_e = started["groups"][2:]
    wall_d, outs_d = join_rank_group(group_d)
    wall_e, outs_e = join_rank_group(group_e)
    out_c = os.path.join(workdir, "out26c")
    ranks_c = _rank_summaries(out_c, 2)
    for key, wall, outs_ in (("d", wall_d, outs_d), ("e", wall_e, outs_e)):
        o = os.path.join(workdir, f"out26{key}")
        ranks = _rank_summaries(o, 2, outs_)
        digests = [r["delta_digest"] for r in ranks]
        check(digests[0] is not None and digests[0] == digests[1],
              f"26 ({key}) the ranks' delta digests {digests} do not agree")
        logs = []
        for r in range(2):
            with open(os.path.join(o, f"photon-ml-tpu-mh-{r}.log")) as f:
                logs.append(f.read())
        out["runs"][key] = {"backend": "gloo", "world": 2, "wall_s": wall,
                            "rank_walls_s": [r["wall_s"] for r in ranks],
                            "blocks_by_rank": [sorted(r["streaming_blocks"]["per-user"])
                                               for r in ranks],
                            "launches_by_rank": [r["launches"] for r in ranks],
                            "lane_iterations_by_rank": [r["block_lane_iterations"]
                                                        for r in ranks],
                            "delta_digest": digests[0],
                            "objective_history": ranks[0]["objective_history"]}
        if key == "d":
            frozen = []
            for r in range(2):
                check("fixed=dirty per-user=dirty" in logs[r]
                      and "warm start: ['fixed', 'per-user'] seeded" in logs[r]
                      and "; frozen [" not in logs[r],
                      f"26 (d) rank {r} did not warm-start both coordinates")
                found = re.search(r"freezing (\d+)/(\d+) unchanged blocks, (\d+) on this host",
                                  logs[r])
                check(found is not None, f"26 (d) rank {r} froze no block")
                frozen.append(tuple(int(x) for x in found.groups()))
                check(ranks[r]["launches"]["gevm"] < ranks_c[r]["launches"]["gevm"],
                      f"26 (d) rank {r} launched GEVM {ranks[r]['launches']['gevm']} times, not "
                      f"below (c)'s {ranks_c[r]['launches']['gevm']}")
            n_frozen, n_blocks = frozen[0][:2]
            frozen_g = [r["frozen_blocks"]["per-user"] for r in ranks]
            check(n_frozen > 0 and sum(f[2] for f in frozen) == n_frozen
                  and [len(g) for g in frozen_g] == [f[2] for f in frozen],
                  f"26 (d) frozen blocks by rank {frozen}, by global id {frozen_g}")
            from photon_ml_tpu_torch.parallel.perhost_streaming import (
                EntityShardPlan,
                PerHostStreamingManifest,
            )

            man_d = os.path.join(o, "streaming-re", "per-user", "process-0")
            plan_d = EntityShardPlan.from_sidecars(man_d)
            vocab_d = PerHostStreamingManifest.load(man_d).vocab
            frozen_users = sorted(vocab_d[v] for g in frozen_g[0] + frozen_g[1]
                                  for v in plan_d.blocks[g])
            m_d = _game_models(o, fin["idx"])
            check(all(np.array_equal(m_d[1][u], fin["models_c"][1][u]) for u in frozen_users),
                  "26 (d): a frozen block's user moved from (c)'s coefficients")
            new_users = [f"user{SKEW_USERS + j}" for j in range(RETRAIN_NEW_USERS)]
            check(all(u in m_d[1] for u in new_users), "26 (d): a new user is missing")
            mid_users = delta_b["mid_users"]
            moved = sum(not np.array_equal(m_d[1][u], fin["models_c"][1][u]) for u in mid_users)
            check(moved == len(mid_users), f"26 (d): {len(mid_users) - moved} dirty users did "
                                           "not move")
            # against phase 24 (b): the same rows, the same pinning rule
            check(frozen_users == delta_b["frozen_users"],
                  f"26 (d) froze {len(frozen_users)} users, 24 (b) "
                  f"{len(delta_b['frozen_users'])}: not the same users")
            worst, outside, _ = models_held("26 (d) against 24 (b)", m_d,
                                            _game_models(delta_b["dir"], fin["idx"]))
            out["runs"]["d"].update(delta_rows=delta_b["n_new"], mid_block_users=len(mid_users),
                                    mid_users_moved=moved, frozen_blocks=n_frozen,
                                    blocks=n_blocks, frozen_users=len(frozen_users),
                                    frozen_by_rank=[f[2] for f in frozen],
                                    max_abs_diff_vs_24b=worst, users_outside_vs_24b=outside)
            say(f"  (d) --warm-start-from (c) with phase 24 (b)'s delta part file "
                f"({delta_b['n_new']} rows: 2 for each of the {len(mid_users)} users of the "
                f"middle block, 4-12 for each of {RETRAIN_NEW_USERS} new users), 2 ranks beside "
                "(e), (a) and 25 (d)-(e): wall "
                f"{wall:.2f} s; the prior blocking pinned: {n_frozen} of {n_blocks} blocks "
                f"frozen (by rank {[f[2] for f in frozen]}; {len(frozen_users)} users bitwise "
                f"(c)'s, the users 24 (b) froze), the rest re-solved warm, on the plan both "
                f"ranks agree (digest "
                f"{digests[0]}); {moved} of the middle block's users moved; GEVM launches by "
                "rank " + ", ".join(str(r["launches"]["gevm"]) for r in ranks) + " against (c)'s "
                + ", ".join(str(r["launches"]["gevm"]) for r in ranks_c)
                + "; block lane-iterations by rank "
                + ", ".join(str(r["block_lane_iterations"]) for r in ranks) + " against (c)'s "
                + ", ".join(str(r["block_lane_iterations"]) for r in ranks_c))
        else:
            for r in range(2):
                check("frozen ['fixed', 'per-user']" in logs[r],
                      f"26 (e) rank {r} did not freeze both coordinates")
                check(ranks[r]["launches"]["gevm"] == 0,
                      f"26 (e) rank {r} launched GEVM {ranks[r]['launches']['gevm']} times")
            check(tree_bytes(os.path.join(o, "best")) == tree_bytes(os.path.join(out_c, "best")),
                  "26 (e): the frozen run's model bytes differ from (c)'s")
            say(f"  (e) --warm-start-from (c) on (c)'s files, 2 ranks beside (d), (a) and 25 "
                "(d)-(e): "
                f"wall {wall:.2f} s; both coordinates frozen, every owned block on both ranks "
                "(blocks " + "; ".join(str(b) for b in out["runs"]["e"]["blocks_by_rank"])
                + f"), model bytes equal (c)'s, digest {digests[0]} agreed, GEVM launches 0")
    return out


ELASTIC_RANK = "--elastic-rank"  # the argument that runs this script as one phase 27 (b) rank
# phase 27 (b): three logical owners on the two ranks, owner 2 on rank 0
ELASTIC_MEMBERSHIP = (1, [0, 1, 2], {0: 0, 1: 1, 2: 0})


def elastic_rank(argv):
    """One rank of phase 27 (b) (``chip_smoke.py --elastic-rank <multihost
    driver flags>``): the multihost driver's per-host streaming path, built
    from the driver's own helpers as ``_train`` builds it (positional file
    share, one fixed-effect chunk a part file, the agreed blocking), over
    ELASTIC_MEMBERSHIP's logical owners, with an ``ElasticMonitor`` in both
    coordinates, as tests/elastic_reshard_worker.py's loss arm: when rank 0
    reaches its first block of the last epoch, owner 2 stops beating and is
    declared lost (rank 1 fires at its own first block of that epoch). Each
    rank drains at its next safe boundary, the session agrees plan v2, moves only
    the changed blocks and re-bases, and the descent resumes from the
    emergency checkpoint on a coordinate rebuilt on the re-based manifest.
    Then the model is saved as the driver saves it, both sparse kernels are
    held against their plain versions on every block the rank owns after the
    re-plan, and ``elastic-<rank>.json`` records the rank's run."""
    import torch

    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.algorithm.streaming_fixed_effect import (
        PerHostStreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer
    from photon_ml_tpu_torch.cli import game_multihost_driver as mhd
    from photon_ml_tpu_torch.cli.game_params import CoordinateOptConfig, parse_training_params
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _input_files,
        resolve_date_range_dirs,
    )
    from photon_ml_tpu_torch.compile.plan import ExecutionPlan
    from photon_ml_tpu_torch.device import enable_determinism
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.ops import fused_sparse
    from photon_ml_tpu_torch.ops import losses as losses_mod
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.parallel.elastic import (
        ElasticMonitor,
        ElasticSession,
        FleetMembership,
        ReplanBarrierError,
        ReplanRequired,
        declare_lost_hosts,
    )
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
        build_perhost_streaming_manifest,
    )
    from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir

    enable_determinism()
    t_start = time.perf_counter()
    mh_args, rest = mhd._add_multihost_flags(argv)
    p = parse_training_params(rest)
    mh = multihost.initialize(mh_args["coordinator"], mh_args["num_processes"],
                              mh_args["process_id"], device=p.device)
    try:
        ctx, pid, n = mh.mesh_context(), mh.process_id, mh.num_processes
        if mh.coordinator_only_io():
            prepare_output_dir(p.output_dir, True)
        mh.barrier("output-dir")
        plan = ExecutionPlan.resolve(
            shape_canonicalization=p.shape_canonicalization,
            solve_compaction=p.solve_compaction, adaptive_schedule=p.adaptive_schedule,
            distributed=True, streaming=True, bucketed=p.bucketed_random_effects, plan=p.plan,
            num_processes=n)
        shards = {"global", "per_user"}
        shard_maps = mhd._shard_maps(p, shards)
        all_files = _input_files(resolve_date_range_dirs(
            p.train_input_dirs, p.train_date_range, p.train_date_range_days_ago))
        gds = mhd._decode_share(p, mhd.host_file_share(all_files, n, pid), shard_maps, shards,
                                ["userId"])
        file_base, n_global = mhd.global_row_layout(len(all_files), gds, ctx, n)

        def assemble(vec_per_gd):
            return torch.from_numpy(np.asarray(mhd.merge_row_vectors(
                gds, file_base, n_global, ctx, n, vec_per_gd))).to(ctx.device)

        labels = assemble(lambda gd: gd.response.astype(np.float32))
        weights = assemble(lambda gd: gd.weight.astype(np.float32))
        offsets = assemble(lambda gd: gd.offset.astype(np.float32))
        g_file_counts = np.diff(np.append(file_base, n_global)).astype(np.int64)
        dc = p.random_effect_data_configs["per-user"]
        rows = mhd._host_rows(gds, file_base, "per_user", "userId", len(shard_maps["per_user"]))
        version, hosts, binding = ELASTIC_MEMBERSHIP
        membership = FleetMembership(version, hosts, binding)
        manifest = build_perhost_streaming_manifest(
            rows, dc, os.path.join(p.output_dir, "streaming-re", "per-user", f"process-{pid}"),
            ctx, n, pid, memory_budget_bytes=int(p.re_memory_budget_mb * 1e6),
            bucketer=plan.bucketer or "off", membership=membership)
        del rows
        fleet_dir = os.path.join(p.output_dir, "fleet")
        monitor = ElasticMonitor(fleet_dir, membership, process_id=pid, heartbeat_deadline=60.0,
                                 min_poll_interval=0.0, num_processes=n)
        session = ElasticSession(fleet_dir, pid, n, monitor, barrier_timeout=120.0)
        combo = p.config_grid()[0]
        fe_cfg, re_cfg = combo["fixed"], combo["per-user"]
        dim = len(shard_maps["global"])
        fe = PerHostStreamingFixedEffectCoordinate(
            [int(c) for c in g_file_counts], mhd._fe_chunk_loaders(gds, "global", dim), dim,
            GLMOptimizationProblem(p.task_type, fe_cfg.optimizer, fe_cfg.optimizer_config(),
                                   fe_cfg.regularization_context()),
            ctx=ctx, num_processes=n, plan=plan, device=ctx.device, elastic=monitor)
        re_kw = dict(task=p.task_type, optimizer=re_cfg.optimizer,
                     optimizer_config=re_cfg.optimizer_config(),
                     regularization=re_cfg.regularization_context(),
                     state_root=os.path.join(p.output_dir, "streaming-re-state",
                                             f"per-user-host{pid}-1"),
                     plan=plan, device=ctx.device, ctx=ctx, num_processes=n, elastic=monitor)
        re = PerHostStreamingRandomEffectCoordinate(manifest=manifest, **re_kw)
        fired, log = {"done": False}, []

        def fire():
            monitor.silence_host(2)
            declare_lost_hosts(fleet_dir, [2], reason="logical owner 2 reclaimed")
            log.append(f"rank {pid} declared owner 2 lost")

        # each rank fires before its first block of the last epoch (the
        # marker writes are idempotent), so it drains at that block's
        # boundary, mid-epoch, whatever its peer's timing
        slab_for, calls = re._slab_for, {"n": 0}
        first_of_last = (p.num_iterations - 1) * len(re.manifest.blocks) + 1

        def hooked(i, ds, extra):
            calls["n"] += 1
            if not fired["done"] and calls["n"] == first_of_last:
                fired["done"] = True
                fire()
            return slab_for(i, ds, extra)

        re._slab_for = hooked
        loss = losses_mod.for_task(p.task_type)
        ck = CoordinateDescentCheckpointer(os.path.join(p.output_dir, f"ckpt-{pid}"),
                                           run_fingerprint="phase-27b")
        replans, result, t_run = [], None, time.perf_counter()
        while result is None:
            cd = CoordinateDescent({"fixed": fe, "per-user": re},
                                   lambda s: torch.sum(weights * loss.loss(s + offsets, labels)))
            try:
                result = cd.run(p.num_iterations, n_global, checkpointer=ck)
            except ReplanRequired as e:
                where = (f"mid-epoch, {len(e.partial['meta']['done_global_ids'])} blocks done"
                         if e.partial else "no partial")
                log.append(f"rank {pid} drained for v{e.proposal['version']} ({where}): {e}")
                t0 = time.perf_counter()
                try:
                    res = session.replan(re.manifest, e.proposal,
                                         state_dir=re.replan_state_dirs(), epoch=re._epoch)
                except ReplanBarrierError as err:
                    log.append(f"supervised-relaunch fallback: {err}")
                    raise
                moved_bytes = sum(os.path.getsize(os.path.join(res.manifest.dir, b["file"]))
                                  for g, b in zip(res.manifest.global_block_ids,
                                                  res.manifest.blocks) if g in res.incoming)
                replans.append({"version": res.plan_version, "moved": res.moved,
                                "incoming": res.incoming, "rebuilt": res.rebuilt,
                                "blocks_total": res.blocks_total,
                                "incoming_block_bytes": moved_bytes,
                                "seconds": time.perf_counter() - t0,
                                "decisions": res.decisions})
                re = PerHostStreamingRandomEffectCoordinate(
                    manifest=res.manifest, initial_epoch=re._epoch + 1, **re_kw)
        run_s = time.perf_counter() - t_run
        launches = mhd.kernel_launches()
        out = os.path.join(p.output_dir, "best")
        mh.barrier("pre-save")
        if mh.coordinator_only_io():
            os.makedirs(out, exist_ok=True)
            model_io.save_fixed_effect(out, "fixed", p.task_type,
                                       result.coefficients["fixed"].detach().cpu().numpy(),
                                       shard_maps["global"], feature_shard_id="global")
        mh.barrier("saved-fixed")
        mhd._save_streaming_re_parts(out, "per-user", p, dc, re, result.coefficients["per-user"],
                                     shard_maps["per_user"], mh)
        mh.barrier("saved-per-user")
        # (the kernels need the card: a CPU rehearsal records no holds)
        holds = (hold_block_slabs(torch, fused_sparse, re.manifest, f"27 (b) rank {pid}",
                                  device=re._device) if re._device.type == "cuda"
                 else {"gevm": None, "hvp": None})
        with open(os.path.join(p.output_dir, f"elastic-{pid}.json"), "w") as f:
            json.dump({"backend": ctx.backend, "replans": replans, "log": log,
                       "launches": launches, "holds": holds, "run_s": run_s,
                       "wall_s": time.perf_counter() - t_start,
                       "owned": [int(g) for g in re.manifest.global_block_ids],
                       "plan_version": monitor.membership.version,
                       "objective_history": result.objective_history}, f, default=str)
    finally:
        multihost.shutdown()


def start_elastic_seed(workdir, started26):
    """Phase 27 (a)'s seed, started with phase 26's first groups (beside
    phase 25): 26 (c)'s 2-rank command with --checkpoint-dir, stopped after
    its first checkpointed iteration (``PHOTON_PREEMPT_AT=cycle:2``, exit
    75). A watcher thread starts the relaunch, the same command at one rank
    on the same dirs, as soon as both seed ranks have exited 75."""
    say("== phase 27 (start): (a)'s 2-rank seed, stopped after one checkpointed iteration, "
        "beside phase 25; its 1-rank relaunch starts when it exits")
    seed_argv = (["--output-dir", os.path.join(workdir, "out27a"), "--checkpoint-dir",
                  os.path.join(workdir, "ck27a")] + started26["flags"])
    env = dict(os.environ, PHOTON_SPARSE_KERNEL="pallas", PHOTON_PREEMPT_AT="cycle:2")
    seed = start_rank_group("game_multihost_driver", seed_argv, 2, workdir, "(27a seed)", env=env)
    started = {"seed": seed, "seed_argv": seed_argv, "groups": [seed], "lock": threading.Lock(),
               "stopping": False}

    def relaunch_when_seed_ends():
        for proc in seed[1]:
            proc.wait()
        with started["lock"]:
            if not started["stopping"] and all(p_.returncode == 75 for p_ in seed[1]):
                # the seed's split, read before the relaunch re-bases it
                started["seed_blocks"] = {}
                for r in range(2):
                    with open(os.path.join(workdir, "out27a", "streaming-re", "per-user",
                                           f"process-{r}", "manifest.json")) as f:
                        started["seed_blocks"][r] = sorted(json.load(f)["global_block_ids"])
                started["relaunch"] = start_rank_group(
                    "game_multihost_driver", seed_argv, 1, workdir, "(27a relaunch)")
                started["groups"].append(started["relaunch"])

    started["watcher"] = threading.Thread(target=relaunch_when_seed_ends, daemon=True)
    started["watcher"].start()
    return started


def start_elastic_live(workdir, started26, started):
    """Phase 27 (b)'s two ranks (ELASTIC_RANK), started beside 26 (a), (d)
    and (e)."""
    say("== phase 27 (b) start: the live re-plan's 2 ranks, beside 26 (a), (d) and (e)")
    started["live"] = start_rank_group(
        "game_multihost_driver", ["--output-dir", os.path.join(workdir, "out27b")]
        + started26["flags"], 2, workdir, "(27b)",
        head=[os.path.abspath(__file__), ELASTIC_RANK])
    started["groups"].append(started["live"])


def stop_elastic(started):
    """Stop phase 27's groups, the watcher first (it may start one)."""
    if "lock" in started:
        with started["lock"]:
            started["stopping"] = True
        stop_rank_groups(*started["groups"])
        started["watcher"].join(timeout=30)
    stop_rank_groups(*started["groups"])


def relaunch_elastic(workdir, started):
    """Phase 27 (a)'s seed joined (exit 75); the relaunch the watcher
    started on the seed's exit, after reading the seed's split."""
    started["seed_wall"], _ = join_rank_group(started["seed"], expect_rc=75)
    started["watcher"].join(timeout=60)
    check("relaunch" in started, "27 (a): the relaunch did not start after the seed exited")


def phase_elastic(workdir, started26, started, mh_stream):
    """Phase 27, after phase 26, on its data (phase 20's 20000 skewed users
    over MH_PARTS part files, 1 MB blocks). (a) the relaunch re-plan: 26
    (c)'s command seeded on 2 gloo ranks and stopped after one checkpointed
    iteration, relaunched on the same output dir as 1 NCCL rank: the driver
    adopts the layout at plan v2, copies only the lost rank's blocks and
    spilled coefficients, decodes no random-effect shard, and writes 26
    (b)'s coefficients bit for bit. (b) the live re-plan of ``elastic_rank``
    on 2 gloo ranks with 3 logical owners: owner 2 lost mid-epoch, one
    re-plan to v2, no fallback and no cold rebuild, 26 (b)'s coefficients
    bit for bit, each rank's GEVM and HVP bitwise their plain versions on
    its blocks after the re-plan."""
    say("== phase 27: elastic re-planning on phase 26's data: (a) a 2-rank run relaunched as 1 "
        "rank adopts its layout at plan v2; (b) a live re-plan after a logical owner's loss")
    idx = started26["idx"]
    model_b = _game_models(os.path.join(workdir, "out26b"), idx)
    out = {}

    def bitwise_26b(model):
        return (np.array_equal(model[0], model_b[0]) and set(model[1]) == set(model_b[1])
                and all(np.array_equal(model[1][k], model_b[1][k]) for k in model_b[1]))

    # (a) the seed (joined by relaunch_elastic), then the relaunch at 1 rank
    out_a = os.path.join(workdir, "out27a")
    seed_wall, seed_blocks = started["seed_wall"], started["seed_blocks"]
    wall_a, outs_a = join_rank_group(started["relaunch"])
    summary, = _rank_summaries(out_a, 1, outs_a)
    with open(os.path.join(out_a, "photon-ml-tpu-mh-0.log")) as f:
        log_a = f.read()
    adopted = summary["adopted"].get("per-user")
    check(adopted is not None and adopted["plan_version"] == 2
          and "adopted relaunch re-plan v2" in log_a,
          f"27 (a) the relaunch did not adopt the layout at plan v2: {summary['adopted']}")
    check(summary["backend"] == "nccl", f"27 (a) relaunch backend {summary['backend']}")
    check(sorted(adopted["blocks"]) == seed_blocks[1]
          and sorted(g for g, _, _ in adopted["moved"]) == seed_blocks[1],
          f"27 (a) copied blocks {adopted['blocks']}, not the lost rank's {seed_blocks[1]}")
    check(adopted["state_files"] >= len(seed_blocks[1]),
          f"27 (a) {adopted['state_files']} state files for {len(seed_blocks[1])} blocks")
    check("per_user" not in summary["decoded_shard_rows"]
          and summary["decoded_shard_rows"].get("global") == summary["num_rows"],
          f"27 (a) the relaunch decoded {summary['decoded_shard_rows']}: a random-effect shard "
          "was decoded again")
    check(summary["launches"]["gevm"] > 0, f"27 (a) relaunch launches {summary['launches']}")
    check(bitwise_26b(_game_models(out_a, idx)),
          "27 (a) the relaunched run's coefficients are not bitwise 26 (b)'s")
    proc0 = os.path.join(out_a, "streaming-re", "per-user", "process-0")
    with open(os.path.join(proc0, "manifest.json")) as f:
        m0 = json.load(f)
    files = dict(zip(m0["global_block_ids"], (b["file"] for b in m0["blocks"])))
    block_bytes = sum(os.path.getsize(os.path.join(proc0, files[g])) for g in adopted["blocks"])
    state_root = os.path.join(out_a, "streaming-re-state")
    state_bytes = sum(os.path.getsize(os.path.join(root, f)) for root, _, fs in os.walk(state_root)
                      if "-host0-" in root for f in fs
                      if any(f == f"coefs-g{g:05d}.npy" for g in adopted["blocks"]))
    out["a"] = {"seed_wall_s": seed_wall, "relaunch_wall_s": wall_a,
                "relaunch_in_driver_s": summary["wall_s"], "replan_s": adopted["seconds"],
                "blocks_by_seed_rank": seed_blocks, "adopted_blocks": adopted["blocks"],
                "state_files": adopted["state_files"], "block_bytes": block_bytes,
                "state_bytes": state_bytes, "launches": summary["launches"],
                "decoded_shard_rows": summary["decoded_shard_rows"],
                "startup_s": summary["startup_s"]}
    say(f"  (a) seed: 26 (c)'s command on 2 gloo ranks with --checkpoint-dir, stopped after one "
        f"checkpointed iteration (exit 75), wall {seed_wall:.2f} s, blocks by rank "
        f"{seed_blocks[0]}; {seed_blocks[1]}; relaunch on the same output dir at 1 NCCL rank: "
        f"adopted at plan v2 in {adopted['seconds']:.3f} s, {len(adopted['blocks'])} of "
        f"{len(seed_blocks[0]) + len(seed_blocks[1])} blocks copied ({block_bytes} bytes) and "
        f"{adopted['state_files']} coefficient files ({state_bytes} bytes), rows decoded by "
        f"shard {summary['decoded_shard_rows']} (no random-effect shard), wall {wall_a:.2f} s "
        f"(in the driver {summary['wall_s']:.2f} s), launches {summary['launches']}; every "
        "coefficient bitwise 26 (b)'s")

    # (b) the live re-plan
    out_b = os.path.join(workdir, "out27b")
    wall_b, _ = join_rank_group(started["live"])
    ranks = []
    for r in range(2):
        with open(os.path.join(out_b, f"elastic-{r}.json")) as f:
            ranks.append(json.load(f))
    for r, rank in enumerate(ranks):
        check(rank["backend"] == "gloo", f"27 (b) rank {r} backend {rank['backend']}")
        check([x["version"] for x in rank["replans"]] == [2] and rank["plan_version"] == 2,
              f"27 (b) rank {r} re-plans {[x['version'] for x in rank['replans']]}")
        check(not any("supervised-relaunch" in line for line in rank["log"])
              and rank["replans"][0]["rebuilt"] == [],
              f"27 (b) rank {r} fell back: {rank['log']} {rank['replans'][0]['rebuilt']}")
        check(rank["holds"]["gevm"] == 0.0 and rank["holds"]["hvp"] == 0.0,
              f"27 (b) rank {r}'s sparse kernels are not bitwise their plain version on its "
              f"blocks after the re-plan: {rank['holds']}")
        check(rank["launches"]["gevm"] > 0, f"27 (b) rank {r} launches {rank['launches']}")
    moved = ranks[0]["replans"][0]["moved"]
    check(moved and moved == ranks[1]["replans"][0]["moved"]
          and sorted(ranks[0]["owned"] + ranks[1]["owned"])
          == list(range(ranks[0]["replans"][0]["blocks_total"])),
          f"27 (b) the ranks disagree on the moved blocks or the new split: {moved}, "
          f"{ranks[0]['owned']}, {ranks[1]['owned']}")
    check(any("mid-epoch" in line for rank in ranks for line in rank["log"]),
          f"27 (b) no rank drained mid-epoch: {[rank['log'] for rank in ranks]}")
    check(ranks[0]["objective_history"] == mh_stream["runs"]["b"]["objective_history"],
          "27 (b) the objectives are not 26 (b)'s")
    check(bitwise_26b(_game_models(out_b, idx)),
          "27 (b) the live re-planned run's coefficients are not bitwise 26 (b)'s")
    out["b"] = {"wall_s": wall_b, "rank_walls_s": [x["wall_s"] for x in ranks],
                "run_s": [x["run_s"] for x in ranks], "moved": moved,
                "incoming_by_rank": [x["replans"][0]["incoming"] for x in ranks],
                "incoming_block_bytes_by_rank": [x["replans"][0]["incoming_block_bytes"]
                                                 for x in ranks],
                "replan_s_by_rank": [x["replans"][0]["seconds"] for x in ranks],
                "owned_by_rank": [x["owned"] for x in ranks],
                "launches_by_rank": [x["launches"] for x in ranks],
                "holds_by_rank": [x["holds"] for x in ranks], "log": ranks[0]["log"]
                + ranks[1]["log"]}
    say(f"  (b) 2 gloo ranks, logical owners {ELASTIC_MEMBERSHIP[1]} bound "
        f"{ELASTIC_MEMBERSHIP[2]}: " + "; ".join(ranks[0]["log"] + ranks[1]["log"])
        + f"; plan v2 moved {len(moved)} of {ranks[0]['replans'][0]['blocks_total']} blocks "
        f"{[g for g, _, _ in moved]} (incoming bytes by rank "
        f"{out['b']['incoming_block_bytes_by_rank']}, re-plan "
        + ", ".join(f"{x:.3f}" for x in out["b"]["replan_s_by_rank"]) + " s by rank), owned "
        f"after it {ranks[0]['owned']}; {ranks[1]['owned']}; wall {wall_b:.2f} s (descent "
        + ", ".join(f"{x:.2f}" for x in out["b"]["run_s"]) + " s by rank), launches by rank "
        + "; ".join(str(x["launches"]) for x in ranks) + "; no fallback, no cold rebuild; every "
        "coefficient bitwise 26 (b)'s; each rank's GEVM and HVP bitwise their plain versions "
        "on its blocks after the re-plan")
    out["max_abs_err"] = {k: max(x["holds"][k] or 0.0 for x in ranks) for k in ("gevm", "hvp")}
    return out


CUTS = [
    "phases 25, 26 and 27 run last, side by side (each only reads what the runs before it "
    "wrote): 26 (b)'s rank, (c)'s two ranks and 27 (a)'s two seed ranks start before phase 25 "
    "and run beside it; 25 (c)'s two ranks run beside 25 (a) and (b) in this process; 27 (a)'s "
    "relaunched rank starts when the seed exits; 25 (d)'s and (e)'s ranks, 26 (d)'s and (e)'s "
    "and 27 (b)'s run beside each other and beside 26 (a) in this process; no rank group runs "
    "beside any other phase",
    "phase 17: spec pallas's stopped subprocess starts first and runs beside the in-process "
    "runs (it writes its own dirs)",
    "phase 19 (a): the grid's fixed-effect lambdas 0.01 and 0.1, the first two of bench.py's "
    "four (phase 23 swaps between their stores)",
    "phase 19 (c): the first card run decodes the training Avro into a tensor cache; the "
    "second card run and the CPU run read the columns from it",
    f"phase 19 (b): the sampled card and CPU pair on phase 17's data ({CHECKPOINT_USERS} users "
    f"of phase 10's generator), not phase 10's {GAME_USERS}",
    "phase 25 (a): the --distributed run reads phase 10's training columns from phase 19 (a)'s "
    "tensor cache",
    f"phase 11 (after phase 17): the native and row-loop reads of phase 17's validation rows "
    f"({CHECKPOINT_USERS} users), not phase 10's",
    f"phase 20: the byte-equal pair of bucketed card runs and the spec auto run with "
    f"--shape-canonicalization on run at {SKEW_SMALL_USERS} users ((f)'s data; (d) held against "
    f"(f)'s card run), not {SKEW_USERS}; (b) and the unbucketed (c) keep {SKEW_USERS}",
    f"phase 21 (c): the host and device loops at {SKEW_SMALL_USERS} users (phase 20 (f)'s data, "
    f"model bytes held against 20 (f)'s card run), not {SKEW_USERS}; they are (e)'s "
    "uninterrupted runs, checkpointed",
    "phase 22 (b): the subprocess stopped at a block boundary runs beside the depth-0 and "
    "--solve-compaction runs (it only reads the tensor cache the first run filled)",
    "graph timings of a slow call replay the graph fewer times (as many as fill 1.5 s of device "
    "time, at least 5): phase 15's deterministic scatter is timed over 5 replays, not 30",
    f"phase 17: phase 10's generator and widths at {CHECKPOINT_USERS} users, not "
    f"{GAME_USERS} (4000 before phase 22 was added)",
    "phase 17: specs scatter and auto run the uninterrupted and the stopped-and-resumed pair "
    "only; --checkpoint-async and --max-restarts run under spec pallas alone",
    f"phase 16: no card run of its own for the timings, the byte-equal pair's first run at "
    f"{WIDE_CPU_USERS} users gives them (one at 5000 users before phase 27 was added, 20000 "
    f"before phase 25); the byte-equal pair and the card and CPU pair at {WIDE_CPU_USERS} "
    "users, not 4000",
    f"phase 20 (f) and phase 21 (d)-(e): {SKEW_SMALL_USERS} users, not 4000",
    f"phase 18 (b): the card-against-CPU pair of ALL + TRON + box runs on the first "
    f"{DIAG_CPU_ROWS} of phase 6's training rows (a quarter); the two byte-equal card runs keep "
    "every row",
    "phase 18 (c): the TrainingExampleAvro copy's training split is (b)'s subset of phase 6's "
    "training rows (all of them before phase 25 was added); the validation split keeps every row",
    "phase 17: only spec pallas stops a subprocess (exit 75); under scatter and auto the "
    "stopped run is in-process (SystemExit 75), auto's with its race caches emptied first",
    f"phase 21 (d): the --adaptive-schedule runs at {SKEW_SMALL_USERS} users (phase 20 (f)'s "
    f"data, as (e)), not {SKEW_USERS}",
    "phase 23 (b): single-row requests of the first "
    + ", ".join(f"{n} validation rows at max_batch_rows {b}" for b, n in SERVE_PREFIX_ROWS.items())
    + ", not all 37488 (32 serves every row; 8192 at 1, 8 and 128 before this cut)",
    "phase 19 (a)-(b): the per-combo run decodes phase 10's training Avro into a tensor "
    "cache; the --vmapped-grid run and the sampled card and CPU runs read the columns from it",
]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    from photon_ml_tpu_torch.device import enable_determinism

    enable_determinism()  # before any CUDA work: cuBLAS reads its workspace setting once
    from photon_ml_tpu_torch import native_build
    from photon_ml_tpu_torch.ops import fused_glm, losses

    start = time.perf_counter()
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

    walls = {}

    def timed(label, fn, *args):
        """Run one phase and print its wall."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[label] = time.perf_counter() - t0
        say(f"  -- phase {label} wall {walls[label]:.1f} s (the call so far "
            f"{time.perf_counter() - start:.1f} s)")
        return out

    max_abs_err = timed("3", phase_kernel_vs_plain, torch, fused_glm, losses)
    times = timed("4", phase_times, torch, fused_glm, losses)
    grid_launches = timed("5", phase_train_grid, torch, fused_glm, times["bfloat16"]["graph_ms"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        driver_launches, driver6 = timed("6", phase_driver, torch, fused_glm, workdir)
        glm_diag = timed("18", phase_glm_diagnostics, torch, fused_glm, workdir)
        stream_glm = timed("22a", phase_streaming_glm, torch, fused_glm, workdir, driver6)
        del driver6
    sparse_err = timed("7", phase_sparse_vs_plain, torch, fused_sparse, losses)
    sparse_times = timed("8", phase_sparse_times, torch, fused_sparse, losses)
    re_runs = timed("9", phase_re_solve, torch, fused_sparse, sparse_times["full width"])
    # phase 10's dir stays until phase 25, which runs last, beside 26
    with tempfile.TemporaryDirectory(prefix="chip_smoke_game_") as game_dir:
        game_runs, trained = timed("10", phase_game_driver, torch, fused_sparse, game_dir)
        timed("12", phase_scoring, torch, game_dir, trained)
        timed("13", phase_offheap, torch, fused_sparse, game_dir, trained)
        timed("14", phase_random_projection, torch, trained)
        checkpoints = timed("17", phase_checkpoints, torch, fused_sparse, game_dir)
        timed("11", phase_ingest, game_dir, trained)
        game_grid = timed("19ab", phase_game_grid, torch, fused_sparse, game_dir)
        cache_game = timed("22c", phase_cache_game, torch, fused_sparse, game_dir)
        serving = timed("23", phase_serving, torch, game_dir)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sparse_") as sparse_dir:
            sparse_glm = timed("15", phase_sparse_glm, torch, fused_sparse, losses, sparse_dir)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_") as workdir:
            wide = timed("16", phase_game_wide, torch, fused_sparse, workdir)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_full_") as workdir:
            full_game = timed("19c", phase_full_game, torch, fused_sparse, workdir)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bucketed_") as workdir:
            bucketed = timed("20", phase_bucketed, torch, fused_sparse, workdir)
            scheduler = timed("21", phase_scheduler, torch, fused_sparse, workdir, bucketed)
            dense_bits = timed("21f", phase_dense_stack_bits, torch)
            stream_game = timed("22b", phase_streaming_game, torch, fused_sparse, workdir,
                                bucketed.pop("_inmemory"))
            retrain = timed("24", phase_retrain, torch, fused_sparse, workdir, stream_game)
            # phases 25 and 26 last, side by side: their rank groups run
            # beside each other and beside 25 (a)-(b) and 26 (a), no other
            # phase; a failed check stops every group
            started = timed("26start", start_multihost_streaming, workdir, retrain)
            multihost, started27 = {}, {"groups": []}
            try:
                # phase 27, on phase 26's data: (a)'s seed beside phase 25,
                # its relaunch when the seed exits; (b) beside 26 (a), (d), (e)
                started27 = timed("27start", start_elastic_seed, workdir, started)
                multihost = timed("25", phase_multihost, torch, fused_sparse, fused_glm,
                                  game_dir)
                mh_stream = timed("26", phase_multihost_streaming, torch, fused_sparse, workdir,
                                  stream_game, started, "cuda",
                                  lambda: start_elastic_live(workdir, started, started27))
                timed("27relaunch", relaunch_elastic, workdir, started27)
                timed("25de", finish_multihost, game_dir, multihost)
                timed("26de", finish_multihost_streaming, workdir, started, mh_stream, retrain)
                elastic = timed("27", phase_elastic, workdir, started, started27, mh_stream)
            finally:
                stop_rank_groups(*started["groups"], *multihost.get("_groups", ()))
                stop_elastic(started27)
            stream_game.pop("_prior")
            retrain.pop("_delta_b")
    say(f"  -- the whole call {time.perf_counter() - start:.1f} s")

    bf16 = times["bfloat16"]

    def mh_launches(key):
        """Phase 25's launches: (a) the 1-rank --distributed run, then each
        rank of (b) and (c), each rank counted from 0 in its own process."""
        runs = multihost["runs"]
        return {"a": runs["a"]["launches"][key],
                **{f"{k}_rank{r}": n[key] for k in ("b", "c")
                   for r, n in enumerate(runs[k]["launches_by_rank"])}}

    def mh_stream_launches(key):
        """Phase 26's launches: (a), then each rank of (b)-(e), each rank
        counted from 0 in its own process."""
        runs = mh_stream["runs"]
        return {"a": runs["a"]["launches"][key],
                **{f"{k}_rank{r}": n[key] for k in ("b", "c", "d", "e")
                   for r, n in enumerate(runs[k]["launches_by_rank"])}}

    def elastic_launches(key):
        """Phase 27's launches: (a)'s relaunched rank, then each rank of (b),
        each counted from 0 in its own process."""
        return {"a_relaunch": elastic["a"]["launches"][key],
                **{f"b_rank{r}": n[key] for r, n in enumerate(elastic["b"]["launches_by_rank"])}}

    kernels = [{
        "name": "fused_glm_value_grad",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_glm.cu",
        "replaces": "photon_ml_tpu/ops/fused_glm.py:223",
        "also_replaces": ["photon_ml_tpu/ops/fused_glm.py:350"],
        "launches": driver_launches,
        "launches_train_glm_grid": grid_launches,
        "launches_glm_diagnostics": glm_diag["launches_total"],
        "launches_glm_diagnostics_by_run": {k: v["launches"] for k, v in glm_diag.items()
                                            if isinstance(v, dict)},
        "launches_game_driver": game_runs["pallas"]["launches"]["fused_glm"],
        "launches_game_grid": {k: game_grid[k]["launches"]["fused_glm"]
                               for k in ("per-combo", "vmapped-grid")},
        "launches_full_game": {k: v["fused_glm"] for k, v in full_game["launches"].items()},
        "launches_bucketed": {k: v["launches"]["fused_glm"]
                              for k, v in bucketed["runs"].items()},
        "launches_delta_retrain": {k: v["fused_glm"] for k, v in retrain["launches"].items()},
        "launches_multihost": mh_launches("fused_glm"),
        "launches_multihost_streaming": mh_stream_launches("fused_glm"),
        "launches_elastic": elastic_launches("fused_glm"),
        "max_abs_err": max(max_abs_err, game_runs["fixed_max_abs_err"],
                           game_grid["fixed_max_abs_err"], full_game["fixed_max_abs_err"],
                           bucketed["fixed_max_abs_err"], retrain["fixed_max_abs_err"],
                           multihost["fixed_max_abs_err"]),
        "ms": bf16["ms"],
        "graph_ms": bf16["graph_ms"],
        "ms_method": MS_METHOD,
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "library_what": "two torch.matmul products and elementwise ops on the same inputs "
                        "(the dense race's baseline)",
        "dense_race": times["race"],
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
            "launches_game_grid": {k: game_grid[k]["launches"][key]
                                   for k in ("per-combo", "vmapped-grid")},
            "launches_full_game": {k: v[key] for k, v in full_game["launches"].items()},
            "launches_bucketed": {k: v["launches"][key] for k, v in bucketed["runs"].items()},
            "launches_scheduler": scheduler["launches"][key],
            "launches_streaming_game": stream_game["runs"]["streaming"]["launches"][key],
            # phase 24: 22 (b)'s cold run, the short-circuited rerun, the delta run
            "launches_delta_retrain": {k: v[key] for k, v in retrain["launches"].items()},
            "launches_multihost": mh_launches(key),
            "launches_multihost_streaming": mh_stream_launches(key),
            "launches_elastic": elastic_launches(key),
            # replays launch through their graphs, not the wrappers: phase 21
            # (a)'s traced device-loop solve, by torch.profiler
            "launches_device_loop_traced": {
                opt: scheduler["solve"][opt]["device"]["trace"]["traced"][key]
                for opt in scheduler["solve"]},
            "max_abs_err": max(sparse_err[key], game_runs["max_abs_err"][key],
                               bucketed["max_abs_err"][key], scheduler["max_abs_err"][key],
                               stream_game["max_abs_err"][key], retrain["max_abs_err"][key],
                               multihost["max_abs_err"][key], mh_stream["max_abs_err"][key],
                               elastic["max_abs_err"][key]),
            "ms": t["ms"],
            "graph_ms": t["graph_ms"],
            "host_ms": t["host_ms"],
            "ms_method": MS_METHOD,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_what": "GLMObjective on the dense (E, M, D) stack of the same inputs, torch "
                            "ops (the sparse race's dense incumbent)",
            "shape": t["shape"],
            "table_bytes": t["table_bytes"],
            "design_bytes_ms": t["design_bytes_ms"],
            "shapes": {label: sparse_times[label][key] for label in sparse_times},
        })
    say(json.dumps({"sparse_fixed_effect": sparse_glm, "game_wide_fixed": wide,
                    "checkpoints": checkpoints, "glm_diagnostics": glm_diag,
                    "game_grid": game_grid, "full_game": full_game, "bucketed": bucketed,
                    "scheduler": scheduler, "dense_stack_bits": dense_bits,
                    "streaming": {"glm": stream_glm, "game": stream_game, "cache": cache_game},
                    "serving": serving, "retrain": retrain, "multihost": multihost,
                    "multihost_streaming": mh_stream, "elastic": elastic,
                    "phase_walls_s": walls, "cuts": CUTS, "card": card}, default=str))
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [HOLD_RANK]:
        hold_rank(sys.argv[2:])
    elif sys.argv[1:2] == [ELASTIC_RANK]:
        elastic_rank(sys.argv[2:])
    else:
        main()
