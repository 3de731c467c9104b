"""The process-group mesh and its collectives (port of
photon_ml_tpu/parallel/mesh.py).

The JAX package's topology is a ``jax.sharding.Mesh`` over devices, its
cross-device movement the collectives XLA inserts. Here the topology is a
``torch.distributed`` process group with **one rank per device**, in the
JAX package's process-major device order, and the collectives are methods
of :class:`MeshContext` that every rank calls in the same order:

  * :meth:`MeshContext.sum` — a **fixed-order float sum**: every rank
    all-gathers the per-rank partials and adds them in rank order, so all
    ranks hold the same bits, a 1-rank run is bitwise the single-process
    run, and two runs of one N-rank command give the same bytes. The
    backend's own float ``all_reduce`` is never used: its association
    follows whatever algorithm NCCL or gloo picks;
  * :meth:`MeshContext.max` / :meth:`MeshContext.min` (exact);
  * :meth:`MeshContext.all_to_all` of fixed-width records (the shuffle);
  * :meth:`MeshContext.all_gather` (exact; no arithmetic).

The backend follows the topology: NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU. Gloo has no CUDA
all_to_all, so a gloo group stages every collective through host tensors
explicitly (``comm_device``); an NCCL group stages host tensors onto the
rank's card. A collective that fails raises :class:`CollectiveError`; no
collective ever answers with a process-local value instead.

``MeshContext.local()`` is a world of one with no process group: every
collective is the identity on its input.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.ops.features import DenseFeatures, SparseFeatures
from photon_ml_tpu_torch.ops.objective import GLMBatch

Tensor = torch.Tensor

DATA_AXIS = "data"


class CollectiveError(RuntimeError):
    """A collective failed on this rank (a dead peer, a torn-down group, a
    backend that cannot move the tensor). Never degraded to a local value:
    the other ranks may be waiting inside the same collective."""


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A process group (one rank per device) plus the rank's device."""

    group: Optional[object]  # torch.distributed ProcessGroup; None = a world of 1
    rank: int
    world: int
    device: torch.device
    backend: str = "none"  # "nccl" | "gloo" | "none" (no group)
    axis: str = DATA_AXIS

    @staticmethod
    def local(device="cpu") -> "MeshContext":
        """A world of one with no process group: every collective is the
        identity."""
        return MeshContext(None, 0, 1, torch.device(device))

    @property
    def num_devices(self) -> int:
        return self.world

    @property
    def comm_device(self) -> torch.device:
        """Where the backend moves tensors: the card under NCCL, the host
        under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    # -- the rank's blocks ------------------------------------------------
    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the world size."""
        return -(-n // self.world) * self.world

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's contiguous ``[lo, hi)`` block of an axis of length
        ``n`` padded to a multiple of the world size (``hi`` may pass
        ``n``: the tail rank's block holds padding)."""
        per = self.padded(n) // self.world
        return self.rank * per, (self.rank + 1) * per

    # -- collectives ------------------------------------------------------
    def _run(self, op: str, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — any backend fault is re-raised, named
            raise CollectiveError(
                f"collective {op} over {self.world} ranks ({self.backend}) failed on "
                f"rank {self.rank}: {type(e).__name__}: {e}") from e

    def all_gather(self, t: Tensor) -> List[Tensor]:
        """Every rank's ``t`` (uniform shape and dtype), in rank order, on
        ``t``'s device."""
        if self.group is None:
            return [t]
        import torch.distributed as dist

        def go():
            src = t.detach().to(self.comm_device).contiguous()
            if src.dtype == torch.bool:
                src = src.to(torch.uint8)
            out = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(out, src, group=self.group)
            return [o.to(t.device).to(t.dtype) for o in out]

        return self._run("all_gather", go)

    def sum(self, t: Tensor) -> Tensor:
        """The fixed-order sum over ranks: ``((p0 + p1) + p2) + ...`` on
        every rank."""
        parts = self.all_gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def max(self, t: Tensor) -> Tensor:
        return torch.stack(self.all_gather(t)).amax(dim=0)

    def min(self, t: Tensor) -> Tensor:
        return torch.stack(self.all_gather(t)).amin(dim=0)

    def concat(self, t: Tensor) -> Tensor:
        """Every rank's block concatenated along axis 0 in rank order."""
        parts = self.all_gather(t)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def all_to_all(self, send: Tensor) -> Tensor:
        """``send`` is ``(world, m, W)``: block ``d`` goes to rank ``d``.
        Returns ``(world, m, W)``: block ``s`` came from rank ``s``."""
        if self.group is None:
            return send
        import torch.distributed as dist

        def go():
            src = send.detach().to(self.comm_device).contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out.to(send.device)

        return self._run("all_to_all", go)

    # -- host-vector helpers (numpy in, numpy out) -------------------------
    def sum_np(self, vec: np.ndarray) -> np.ndarray:
        v = np.ascontiguousarray(vec)
        return self.sum(torch.from_numpy(v)).numpy().astype(v.dtype, copy=False)

    def max_np(self, vec: np.ndarray) -> np.ndarray:
        v = np.ascontiguousarray(vec)
        return self.max(torch.from_numpy(v)).numpy().astype(v.dtype, copy=False)


def data_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> MeshContext:
    """The mesh over the default process group (a world of one on the CPU
    without one); an NCCL group's device is the current card. ``n_devices``
    must equal the world size: a process group's size is fixed when it is
    brought up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        backend = str(dist.get_backend())
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
        ctx = MeshContext(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device,
                          backend, axis)
    else:
        ctx = dataclasses.replace(MeshContext.local(), axis=axis)
    if n_devices is not None and n_devices != ctx.world:
        raise ValueError(f"need {n_devices} devices, the process group has {ctx.world}")
    return ctx


def _pad_array_leading(a: Tensor, target: int, fill=0.0) -> Tensor:
    n = a.shape[0]
    if n == target:
        return a
    pad = torch.full((target - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=0)


def pad_leading(a: Tensor, multiple: int, fill=0.0) -> Tensor:
    """Pad the leading axis up to the next multiple (for even sharding)."""
    n = a.shape[0]
    return _pad_array_leading(a, -(-n // multiple) * multiple, fill)


def pad_rows(batch: GLMBatch, multiple: int) -> GLMBatch:
    """Pad a GLMBatch with weight-0 rows so rows % multiple == 0. Padding
    rows carry weight 0 and contribute exactly zero to every objective sum
    (``ops/objective._wmul``)."""
    n = batch.num_rows
    target = -(-n // multiple) * multiple
    if target == n:
        return batch
    feats = batch.features
    if isinstance(feats, DenseFeatures):
        feats = DenseFeatures(_pad_array_leading(feats.matrix, target))
    elif isinstance(feats, SparseFeatures):
        # the transpose layout stays valid: padding rows carry only zero
        # values, which add nothing to the column sums
        feats = dataclasses.replace(
            feats, indices=_pad_array_leading(feats.indices, target, 0),
            values=_pad_array_leading(feats.values, target, 0.0))
    else:
        raise TypeError(f"unsupported features type {type(feats)}")
    return GLMBatch(
        feats,
        _pad_array_leading(batch.labels, target),
        _pad_array_leading(batch.offsets, target),
        _pad_array_leading(batch.weights, target),  # weight 0 = padding
    )
