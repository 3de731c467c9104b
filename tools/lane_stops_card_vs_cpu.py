#!/usr/bin/env python3
"""Where the GAME driver's card and CPU runs part: every random-effect lane's stop, on one CUDA card.

    python3 tools/lane_stops_card_vs_cpu.py

Writes chip_smoke.py's GAME data (phase 10's 20000 users and phase 19c's
full GAME model) into a temporary directory and runs the training driver
on each, with the commands of phases 19b, 10 and 19c, once with
``--device cuda`` and once with ``--device cpu``. Every
``RandomEffectCoordinate.update`` is recorded: each lane's iteration count,
stopping reason and final objective value. For each command it prints the
objective histories, each coordinate's score difference (the largest, and
the rows outside the solver tolerance of tests/tolerances.py), and for every
random-effect update the lanes whose iteration count or reason differ
between the two devices and how far the lanes' objective values part, on
all lanes and on those that stopped at the same iteration. Then the lanes
that hold the rows outside the tolerance, the factored coordinate's
``V M`` difference, and the fixed coefficients' difference.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

RTOL, ATOL = cs.SOLVER_RTOL, cs.SOLVER_ATOL
SOLVES = []  # (global dim, iterations, reasons, values) of every RE update


def recording_updates():
    from photon_ml_tpu_torch.algorithm import random_effect

    inner = random_effect.RandomEffectCoordinate.update

    def update(self, *args, **kwargs):
        params, res = inner(self, *args, **kwargs)
        SOLVES.append((self.dataset.global_dim, res.iterations.cpu().numpy().copy(),
                       res.reason.cpu().numpy().copy(), res.value.double().cpu().numpy().copy()))
        return params, res

    random_effect.RandomEffectCoordinate.update = update


def outside(a, b):
    return np.abs(a - b) > ATOL + RTOL * np.abs(b)


def compare(torch, fused_sparse, tag, flags, workdir):
    runs = {}
    for dev in ("cuda", "cpu"):
        SOLVES.clear()
        argv = ["--train-input-dirs", os.path.join(workdir, "train"),
                "--validate-input-dirs", os.path.join(workdir, "validate"), "--device", dev,
                "--output-dir", os.path.join(workdir, f"out-{tag}-{dev}")] + flags
        driver, *_ = cs.run_game_training(torch, fused_sparse, argv, "pallas")
        res = driver.results[0][1]
        runs[dev] = (driver, res, cs.coordinate_scores(driver, res), list(SOLVES))
    (card, card_res, card_s, card_l), (_, cpu_res, cpu_s, cpu_l) = runs["cuda"], runs["cpu"]
    print(f"== {tag}: objective history card {card_res.objective_history}, "
          f"cpu {cpu_res.objective_history}")
    for name in card_s:
        d = np.abs(card_s[name] - cpu_s[name])
        print(f"  {name} scores: max |diff| {d.max():.4g}, rows outside the solver tolerance "
              f"{int(outside(card_s[name], cpu_s[name]).sum())}")
    for u, (a, b) in enumerate(zip(card_l, cpu_l)):
        apart = a[1] != b[1]
        dv = np.abs(a[3] - b[3])
        same = dv[~apart].max() if (~apart).any() else 0.0
        print(f"  RE update {u} (global dim {a[0]}): {len(a[1])} lanes, iteration count apart "
              f"{int(apart.sum())}, reason apart {int((a[2] != b[2]).sum())}; lane objective "
              f"max |diff| {dv.max():.4g} (relative {np.max(dv / np.maximum(np.abs(b[3]), 1e-12)):.3g}),"
              f" on lanes stopped at the same iteration {same:.4g}")
        if apart.any():
            idx = np.nonzero(apart)[0][:8]
            print(f"    lanes {idx.tolist()}: iterations card {a[1][idx].tolist()}, cpu "
                  f"{b[1][idx].tolist()}; objectives card {a[3][idx].round(5).tolist()}, cpu "
                  f"{b[3][idx].round(5).tolist()}")
    for name, coord in card.combo_coords[0].items():
        ds = getattr(coord, "dataset", None)
        if ds is None:
            continue
        rows = ds.row_index.cpu().numpy()
        bad = outside(card_s[name], cpu_s[name])
        lanes = [e for e in range(rows.shape[0]) if bad[rows[e][rows[e] >= 0]].any()]
        print(f"  {name}: lanes holding rows outside the tolerance {len(lanes)}, e.g. {lanes[:10]}")
    if "per-artist" in card_res.coefficients:
        vm = lambda st: (st.v.double() @ st.matrix.double()).cpu().numpy()
        a, b = vm(card_res.coefficients["per-artist"]), vm(cpu_res.coefficients["per-artist"])
        print(f"  per-artist V M: max |diff| {np.abs(a - b).max():.4g}, outside the tolerance "
              f"{int(outside(a, b).sum())} of {a.size}")
    fixed = lambda r: r.coefficients["fixed"].double().cpu().numpy()
    print(f"  fixed coefficients: max |diff| {np.abs(fixed(card_res) - fixed(cpu_res)).max():.4g}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this comparison needs a CUDA card")
    from photon_ml_tpu_torch.device import enable_determinism

    enable_determinism()
    torch.backends.cuda.matmul.allow_tf32 = False
    from photon_ml_tpu_torch.ops import fused_sparse

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    cs.check = lambda cond, msg: None if cond else print(f"  (chip_smoke check: {msg})")
    recording_updates()
    with tempfile.TemporaryDirectory() as w:
        cs.write_game_avro(w, cs.GAME_USERS, cs.SEED)
        compare(torch, fused_sparse, "19b", cs.SAMPLED_FLAGS, w)
        compare(torch, fused_sparse, "phase 10", cs.GAME_FLAGS, w)
    with tempfile.TemporaryDirectory() as w:
        cs.write_full_game_avro(w, cs.FULL_USERS, cs.FULL_ITEMS, cs.FULL_ARTISTS, cs.FULL_SEED)
        compare(torch, fused_sparse, "19c", cs.FULL_GAME_FLAGS, w)


if __name__ == "__main__":
    main()
