#!/usr/bin/env python3
"""Whether both sides of the sparse race add in the flat ``(m, k)`` order, on one CUDA card.

    python3 tools/sparse_flat_order.py

The per-bucket sparse race verifies each family bitwise against the
``segment`` baseline (the plain formulation). Both the GEVM kernel
(``pallas``) and the plain formulation claim the flat order: a column's
contributions ``val[m, k] * d[m]`` added one after another in increasing
``(m, k)``. On the card the plain transpose is ``FlatOrderPlan`` (the
deterministic ``index_add_`` sums long columns in another association).
This script builds slabs of phase 20's bucket shapes (dense rows of
K = D = 9, logistic) and, for each, prints the entries that differ and the
largest difference of:

  * the row derivatives ``d``: the kernel's own (its ``row_values``) against
    the plain formulation's on the card, and on the CPU;
  * the kernel's gradient, the plain gradient on the card, and the plain
    gradient on the CPU, each against the flat order of its own ``d``
    (numpy float32, one ``(m, k)`` step at a time);
  * the kernel's value and gradient against the plain ones on the card;

and the race's record of ``pallas`` on that slab (timed, or failed with its
reason). Without a card it runs the CPU half and says the card half was not
run.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# phase 20's laddered bucket shapes (E lanes, M rows), each raced on its
# first 512 lanes
SHAPES = ((512, 8), (512, 16), (512, 32), (512, 64), (512, 2048))
K = 9
SEED = 20


def flat_order_grad(idx: np.ndarray, val: np.ndarray, d: np.ndarray, dim: int) -> np.ndarray:
    """X^T d in float32, one (m, k) step at a time for every lane at once:
    within a step each lane adds one slot, so the order is exactly flat."""
    e, m, k = idx.shape
    acc = np.zeros((e, dim), np.float32)
    lanes = np.arange(e)
    for mi in range(m):
        for ki in range(k):
            cols = idx[:, mi, ki]
            acc[lanes, cols] = acc[lanes, cols] + val[:, mi, ki] * d[:, mi]
    return acc


def compare(label: str, got: np.ndarray, want: np.ndarray) -> str:
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return (f"{label}: {int((got != want).sum())} of {got.size} entries differ, "
            f"max |diff| {diff.max():.3e}")


def main() -> None:
    import torch

    from photon_ml_tpu_torch.device import enable_determinism

    enable_determinism()
    from photon_ml_tpu_torch.ops import fused_sparse, losses
    from photon_ml_tpu_torch.types import TaskType

    loss = losses.logistic
    card = torch.cuda.is_available()
    print(f"device: {torch.cuda.get_device_name(0) if card else 'cpu (the card half not run)'}")

    def plain_d(slab, y, wt, off, w):
        z = slab.matvec(w) + off
        return torch.where(wt > 0, wt * loss.d1(z, y), torch.zeros_like(z))

    for e, m in SHAPES:
        g = torch.Generator().manual_seed(SEED + m)
        x = torch.randn((e, m, K), generator=g)
        y = (torch.rand((e, m), generator=g) < 0.5).float()
        wt = torch.rand((e, m), generator=g) + 0.5
        off = 0.1 * torch.randn((e, m), generator=g)
        w = 0.3 * torch.randn((e, K), generator=g)
        slab = fused_sparse.build_sparse_slab(x, kernel="pallas")
        idx, val = slab.idx.numpy(), slab.val.numpy()
        d_cpu = plain_d(slab, y, wt, off, w).numpy()
        cpu = fused_sparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w)[1].numpy()
        lines = [compare("plain on the CPU vs flat order", cpu,
                         flat_order_grad(idx, val, d_cpu, K))]
        if card:
            dev = [t.cuda() for t in (y, wt, off, w)]
            cslab = fused_sparse.build_sparse_slab(x.cuda(), kernel="pallas")
            d_card = plain_d(cslab, *dev).cpu().numpy()
            plain = fused_sparse.fused_value_grad_parts_plain(loss, cslab, *dev)
            rows = torch.empty((2, e, m), device="cuda")
            kernel = fused_sparse.sparse_gevm_kernel(loss, cslab, *dev, row_values=rows)
            d_kernel = rows[1].cpu().numpy()
            race = fused_sparse.race_sparse_kernels(
                TaskType.LOGISTIC_REGRESSION, cslab, x.cuda(), dev[0], dev[2], dev[1])
            lines += [
                compare("kernel d vs plain d on the card", d_kernel, d_card),
                compare("plain d on the card vs on the CPU", d_card, d_cpu),
                compare("plain on the card vs flat order", plain[1].cpu().numpy(),
                        flat_order_grad(idx, val, d_card, K)),
                compare("kernel vs flat order of its own d", kernel[1].cpu().numpy(),
                        flat_order_grad(idx, val, d_kernel, K)),
                compare("kernel vs plain on the card, value", kernel[0].cpu().numpy(),
                        plain[0].cpu().numpy()),
                compare("gradient", kernel[1].cpu().numpy(), plain[1].cpu().numpy()),
                f"race: pallas {race['candidates']['pallas']}, winner {race['winner'] or 'dense'}",
            ]
        print(f"E={e} M={m} K={K}: " + "; ".join(lines), flush=True)


if __name__ == "__main__":
    main()
