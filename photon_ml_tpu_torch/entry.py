"""The port's entry points, beside the JAX package's ``__graft_entry__``.

``entry()``              -> ``(fn, example_args)``: the scoring step of the
                            flagship model, GLM mean-function scoring of a
                            batch (n=1024, d=256), on the card unless
                            ``device="cpu"``.
``dryrun_multihost(n)``  -> ``n`` gloo ranks, each its own process (on
                            the card unless ``device="cpu"``; the ranks
                            share one card when there is one): one
                            distributed fixed-effect solve over the ranks'
                            row blocks and one multihost checkpoint (the
                            coordinator writes, every rank reads it back).
                            Raises when the ranks' coefficients differ.
``dryrun_multichip(n)``  -> the port runs one process a device, so a run
                            over ``n`` devices is ``n`` ranks:
                            ``dryrun_multihost(n)``.

Run the ranks from a shell (``--device cpu`` where there is no card)::

    python -m photon_ml_tpu_torch.entry --dryrun-multihost 2
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

N, D = 1024, 256
# the dry run's problem: rows, features, and the solve's settings
DRY_ROWS, DRY_DIM, DRY_ITERS = 512, 16, 30


def _make_batch(n: int, d: int, device, seed: int = 0):
    """The JAX entry's batch (``__graft_entry__._make_batch``): the same
    seeded numpy draws."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.objective import GLMBatch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(device)
    return GLMBatch.create(DenseFeatures(put(x)), put(y))


def entry(device: Optional[str] = None):
    """The forward step: GLM mean-function scoring of a batch. Returns
    ``(forward, (w, batch))``; ``forward(w, batch)`` gives the (N,) means."""
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
    from photon_ml_tpu_torch.types import TaskType

    dev = resolve_device(device)
    batch = _make_batch(N, D, dev)
    w = torch.zeros((D,), dtype=torch.float32, device=dev)

    def forward(w, batch):
        model = GeneralizedLinearModel(Coefficients(w), TaskType.LOGISTIC_REGRESSION)
        return model.compute_mean_functions(batch)

    return forward, (w, batch)


def _rank(rank: int, world: int, port: int, out_dir: str, device: str) -> None:
    """One rank of the dry run: its block of the seeded rows, the
    distributed solve, and the multihost checkpoint's round trip."""
    from photon_ml_tpu_torch.checkpoint import CheckpointState, CoordinateDescentCheckpointer
    from photon_ml_tpu_torch.device import enable_determinism
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.parallel.distributed import DistributedFixedEffectSolver
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    enable_determinism()
    mh = multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device,
                              backend="gloo")
    try:
        ctx = mh.mesh_context()
        full = _make_batch(DRY_ROWS, DRY_DIM, "cpu", seed=1)
        lo, hi = ctx.block(DRY_ROWS)
        lo, hi = min(lo, DRY_ROWS), min(hi, DRY_ROWS)
        put = lambda t: t[lo:hi].to(ctx.device)
        batch = GLMBatch(DenseFeatures(put(full.features.matrix)), put(full.labels),
                         put(full.offsets), put(full.weights))
        problem = GLMOptimizationProblem(
            TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
            OptimizerConfig(max_iterations=DRY_ITERS, tolerance=1e-6),
            RegularizationContext.l2(1.0))
        model, _ = DistributedFixedEffectSolver(problem, ctx).run(
            batch, NormalizationContext.identity())
        w = model.coefficients.means
        ck = CoordinateDescentCheckpointer(os.path.join(out_dir, "ckpt"), "dryrun",
                                           multihost=mh)
        zeros = torch.zeros_like(w)
        ck.save(CheckpointState(step=1, params={"fixed": w}, scores={"fixed": zeros},
                                total_scores=zeros, objective_history=[],
                                validation_history=[]))
        mh.barrier("dryrun-saved")
        back = ck.restore({"fixed": zeros}, {"fixed": zeros}, zeros)
        if back is None or back.step != 1 or not torch.equal(
                back.params["fixed"].to(w.device), w):
            raise RuntimeError(f"rank {rank}: the multihost checkpoint did not round-trip")
        np.save(os.path.join(out_dir, f"coefs-{rank}.npy"), w.detach().cpu().numpy())
    finally:
        multihost.shutdown()


def dryrun_multihost(n_processes: int = 2, device: str = "cuda", timeout: float = 300.0) -> None:
    """Run the dry run on ``n_processes`` gloo ranks (one process each, on
    ``device``); raises if a rank fails or the ranks' fixed-effect
    coefficients are not bitwise equal."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.entry", "--rank", str(i),
             "--world", str(n_processes), "--port", str(port), "--out-dir", tmp,
             "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(n_processes)]
        failed = []
        try:
            for i, p in enumerate(procs):
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    failed.append(f"rank {i} (exit {p.returncode}):\n{out[-1500:]}\n"
                                  f"{err[-1500:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError("multihost dry run failed:\n" + "\n".join(failed))
        coefs = [np.load(os.path.join(tmp, f"coefs-{i}.npy")) for i in range(n_processes)]
    if any(c.tobytes() != coefs[0].tobytes() for c in coefs[1:]):
        raise RuntimeError("ranks diverged: their fixed-effect coefficients differ")
    print(f"dryrun_multihost({n_processes}): OK — ranks agree bitwise, "
          "checkpoint round-tripped")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One process a device: ``n_devices`` ranks, ``dryrun_multihost``."""
    dryrun_multihost(n_devices, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-multihost", type=int, default=None,
                    help="run the dry run on this many gloo ranks")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    a = ap.parse_args(argv)
    if a.rank is not None:
        _rank(a.rank, a.world, a.port, a.out_dir, a.device)
    else:
        dryrun_multihost(a.dryrun_multihost or 2, device=a.device)


if __name__ == "__main__":
    main()
