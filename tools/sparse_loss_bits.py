#!/usr/bin/env python3
"""Where the sparse kernels and their plain version part at w != 0, per loss, on one CUDA card.

    python3 tools/sparse_loss_bits.py

The plain slab margin adds its K products in the kernels' association
(``fused_sparse.kernel_order_row_sum``), so the margins z and zv agree bit
for bit. What is left between the two sides is each loss's own arithmetic
on z: the kernel's ``csrc/losses.cuh`` against torch's elementwise ops. For
every loss, at the GAME driver's slab shape (E=20000, M=12, K=D=9, every
slot filled) and at full width (E=256, M=64, D=2048, K up to 16), with
seeded coefficients (0.1 x a normal draw), this prints how many of the
kernels' row values (the weighted losses wl, the derivatives d, the HVP's
c) and outputs differ from the plain version's, and the largest difference
in units in the last place. Needs a card: without one it says so and exits 1.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = (("driver", 20000, 12, 9, 9, True), ("full width", 256, 64, 2048, 16, False))
LOSSES = ("logistic", "squared", "poisson", "smoothed_hinge")
SEED = 24


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (finite entries)."""
    ok = np.isfinite(a) & np.isfinite(b)
    ia = a[ok].astype(np.float32).view(np.int32).astype(np.int64)
    ib = b[ok].astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def inputs(torch, fused_sparse, loss_name, e, m, d, max_nnz, full, dev):
    rng = np.random.default_rng(SEED + e + m + d)
    x = np.zeros((e, m, d), np.float32)
    nnz = np.full((e, m), max_nnz) if full else rng.integers(1, max_nnz + 1, size=(e, m))
    for i in range(e):
        for r in range(m):
            x[i, r, rng.choice(d, size=nnz[i, r], replace=False)] = rng.normal(size=nnz[i, r])
    if loss_name == "poisson":
        y = rng.poisson(1.5, size=(e, m)).astype(np.float32)
    elif loss_name == "squared":
        y = rng.normal(size=(e, m)).astype(np.float32)
    else:
        y = (rng.random((e, m)) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=(e, m)).astype(np.float32)
    off = rng.normal(scale=0.2, size=(e, m)).astype(np.float32)
    w = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    v = rng.normal(size=(e, d)).astype(np.float32)
    vshift = rng.normal(size=e).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    slab = fused_sparse.build_sparse_slab(t(x), kernel="pallas")
    return slab, t(y), t(wt), t(off), t(w), t(v), t(vshift)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels have no CPU mode; nothing measured")
        return 1
    from photon_ml_tpu_torch.device import enable_determinism

    enable_determinism()
    from photon_ml_tpu_torch.ops import fused_sparse, losses

    print(f"card: {torch.cuda.get_device_name(0)}")
    for label, e, m, d, max_nnz, full in SHAPES:
        for name in LOSSES:
            loss = getattr(losses, name)
            slab, y, wt, off, w, v, vshift = inputs(torch, fused_sparse, name, e, m, d, max_nnz,
                                                    full, "cuda")
            rows = torch.empty((2, e, m), device="cuda")
            c_rows = torch.empty((1, e, m), device="cuda")
            got = fused_sparse.sparse_gevm_kernel(loss, slab, y, wt, off, w, row_values=rows)
            got_hvp = fused_sparse.sparse_hvp_kernel(loss, slab, y, wt, off, w, v, vshift,
                                                     row_values=c_rows)
            z = slab.matvec(w) + off
            masked = lambda x_: torch.where(wt > 0, wt * x_, torch.zeros_like(x_))
            plain_rows = {"wl": masked(loss.loss(z, y)), "d": masked(loss.d1(z, y)),
                          "c": masked(loss.d2(z, y)) * (slab.matvec(v) + vshift[:, None])}
            kernel_rows = {"wl": rows[0], "d": rows[1], "c": c_rows[0]}
            want = fused_sparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w)
            want_hvp = fused_sparse.fused_hvp_parts_plain(loss, slab, y, wt, off, w, v, vshift)
            parts = []
            for key in ("wl", "d", "c"):
                a, b = kernel_rows[key].cpu().numpy(), plain_rows[key].cpu().numpy()
                parts.append(f"{key} {int((a != b).sum())} of {a.size} differ "
                             f"(max {ulps(a, b)} ulp)")
            outs = ("sum wl", "X^T d", "sum d", "X^T c", "sum c")
            for key, a, b in zip(outs, got + got_hvp, want + want_hvp):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                parts.append(f"{key} {int((a != b).sum())} differ (max {ulps(a, b)} ulp)")
            print(f"{label} E={e} M={m} D={d} {name}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
