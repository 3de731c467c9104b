"""Sparse per-entity slabs, their fused kernels and the per-bucket race
(port of photon_ml_tpu/ops/fused_sparse.py).

A random-effect coordinate's per-entity rows live in a padded-COO **slab**:
``idx``/``val`` of shape ``(E, M, K)``, K the largest row non-zero count
(rounded up the shape ladder when one is asked for), padding slots at
column 0 with value 0, each row's entries in ascending column order. Two
formulations compute the same arithmetic on it: margins gathered per row
and added in the kernels' association (``kernel_order_row_sum``),
transposes applied in flat ``(m, k)`` order, row sums through the
fixed-association ``tree_row_sum``.

  * the plain one (``SparseSlab.matvec`` / ``rmatvec``, and
    ``*_parts_plain``): a gather and a transpose in flat order. It serves
    the ``scatter``, ``segment`` and ``flat`` specs, which are three
    schedules of that arithmetic in the JAX package. On a CPU the transpose
    is one flat ``index_add_``, which adds in that order; on the card the
    deterministic ``index_add_`` sums a column in another association
    (``tools/sparse_flat_order.py``), so there it is ``FlatOrderPlan``: one
    elementwise add per step down the longest column;
  * the fused one, spec ``pallas``: on a CUDA slab the hand-written kernels
    of ``csrc/fused_sparse.cu`` (value + gradient in one pass, and the
    Hessian-vector product in one pass), every lane in one launch; on a CPU
    slab the plain version. A CUDA slab never falls back to the plain
    version: a kernel that fails to build or launch raises.

``PHOTON_SPARSE_KERNEL`` keeps the JAX grammar: ``off`` (default) keeps the
dense path; ``scatter`` | ``segment`` | ``flat`` | ``pallas`` |
``pallas:<rows>`` force a family (``:<rows>`` is a TPU row-block schedule:
the same CUDA kernel here); ``auto`` races every family and the dense
incumbent on each bucket's own tensors (``race_sparse_kernels``). A
candidate is verified bitwise against the ``segment`` baseline, and every
candidate that produced no timing is recorded with its reason (one that
disagrees, or runs another name's code); a kernel that fails to build or
launch on the card raises, in the race as under a forced spec.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import warnings
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

SOURCE = "fused_sparse.cu"
_SPARSE_ENV = "PHOTON_SPARSE_KERNEL"
SPARSE_FAMILIES = ("scatter", "segment", "flat", "pallas")
#: the family the race measures candidates against and verifies them by
#: ("the kernel off")
SPARSE_BASELINE = "segment"
#: row blocks of the TPU's blocked pallas variants, raced by name where
#: they divide the slab's padded row count (the same CUDA kernel here)
PALLAS_ROW_BLOCKS = (256, 2048)
VAL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(storage: torch.dtype) -> torch.dtype:
    return torch.float64 if storage == torch.float64 else torch.float32


def tree_row_sum(x: Tensor) -> Tensor:
    """Fixed-association pairwise sum over the last axis: zero-pad to a
    power of two, then add adjacent pairs until one is left. Bitwise the
    JAX package's ``tree_row_sum`` (the same adds in the same order)."""
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def kernel_order_row_sum(prod: Tensor) -> Tensor:
    """Row sums of ``(..., M, K)`` products in the kernels' association
    (csrc/fused_sparse.cu, step 4): ``tpr = row_threads_for(M, K)``
    partials, partial ``t`` adding the products ``q = t, t + tpr, ...`` in
    turn from zero, then ``tree_row_sum`` over the ``tpr`` partials. ``tpr``
    depends on (M, K) alone, so a lane's bits do not depend on the batch.
    A partial never holds -0 (it starts at +0), so the zero padding up to a
    multiple of ``tpr`` adds nothing."""
    m, k = prod.shape[-2], prod.shape[-1]
    tpr = row_threads_for(m, k)
    steps = -(-k // tpr)
    if steps * tpr != k:
        prod = torch.nn.functional.pad(prod, (0, steps * tpr - k))
    prod = prod.reshape(prod.shape[:-1] + (steps, tpr))
    z = torch.zeros(prod.shape[:-2] + (tpr,), dtype=prod.dtype, device=prod.device)
    for s in range(steps):
        z = z + prod[..., s, :]
    return tree_row_sum(z)


# ---------------------------------------------------------------------------
# the slab
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseSlab:
    """Padded-COO per-entity features: ``idx``/``val`` ``(..., M, K)``.

    With a leading lane axis, ``matvec`` takes ``(..., D)`` coefficients, one
    row per lane, and ``rmatvec`` returns them. ``kernel`` names the family
    the objective dispatches on: ``pallas*`` takes the fused kernels, any
    other the plain formulation.
    """

    idx: Tensor  # (..., M, K) int32
    val: Tensor  # (..., M, K)
    dim: int
    kernel: str = "scatter"
    # the kernels' column tables, built on first use and shared by the
    # slab's views (they depend on idx and the real slots only)
    _tables: Optional["ColumnTables"] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # per kernel ("gevm", "hvp"): the checked launch description
    _launch: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    # the card's flat-order transpose, built on first use and shared like _tables
    _flat: Optional["FlatOrderPlan"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def num_rows(self) -> int:
        return self.idx.shape[-2]

    @property
    def max_nnz(self) -> int:
        return self.idx.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def _flat_idx(self) -> Tensor:
        """Slot indices into the ravel of ``(..., D)``: lane l's columns
        offset by ``l * D``."""
        lead = tuple(self.idx.shape[:-2])
        base = torch.arange(math.prod(lead), device=self.idx.device, dtype=torch.int64)
        return self.idx.long() + (base * self.dim).reshape(lead + (1, 1))

    def matvec(self, w: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        wv = w.reshape(-1)[self._flat_idx()]
        return kernel_order_row_sum(wv.to(acc) * self.val.to(acc))

    def _transpose_apply(self, contrib: Tensor) -> Tensor:
        """The transpose action of every plain family, in flat (lane, m, k)
        order into the raveled ``(..., D)`` output: one ``index_add_`` on a
        CPU, ``FlatOrderPlan`` on the card."""
        lead = tuple(self.idx.shape[:-2])
        if contrib.is_cuda:
            if self._flat is None:
                self._flat = FlatOrderPlan.build(self.idx, self.val, self.dim)
            return self._flat.apply(contrib).reshape(lead + (self.dim,))
        out = torch.zeros(math.prod(lead) * self.dim, dtype=contrib.dtype,
                          device=contrib.device)
        out.index_add_(0, self._flat_idx().reshape(-1), contrib.reshape(-1))
        return out.reshape(lead + (self.dim,))

    def rmatvec(self, d: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        return self._transpose_apply(self.val.to(acc) * d.to(acc)[..., None])

    def sq_rmatvec(self, d: Tensor) -> Tensor:
        acc = _acc_dtype(self.val.dtype)
        return self._transpose_apply(torch.square(self.val.to(acc)) * d.to(acc)[..., None])

    def row_sq_norms(self) -> Tensor:
        return torch.sum(torch.square(self.val.to(_acc_dtype(self.val.dtype))), dim=-1)

    def to_dense(self) -> Tensor:
        """``(..., M, D)`` dense view (tests and debugging)."""
        acc = _acc_dtype(self.val.dtype)
        lead = tuple(self.idx.shape[:-1])
        out = torch.zeros(math.prod(lead) * self.dim, dtype=acc, device=self.idx.device)
        rows = torch.arange(math.prod(lead), device=self.idx.device).reshape(lead + (1,))
        out.index_add_(0, (self.idx.long() + rows * self.dim).reshape(-1),
                       self.val.to(acc).reshape(-1))
        return out.reshape(lead + (self.dim,))

    def with_kernel(self, kernel: str) -> "SparseSlab":
        return SparseSlab(self.idx, self.val, self.dim, kernel, self._tables, _flat=self._flat)

    def astype(self, dtype: torch.dtype) -> "SparseSlab":
        return SparseSlab(self.idx, self.val.to(dtype), self.dim, self.kernel, self._tables,
                          _flat=self._flat)

    def kernel_tables(self) -> "ColumnTables":
        """The kernels' column tables (see ``ColumnTables``), built once per
        slab in plain PyTorch on the slab's device and kept: the slab is
        fixed for a whole solve."""
        if self._tables is None:
            if self.idx.dim() != 3:
                raise ValueError(f"kernel_tables needs an (E, M, K) slab, got {tuple(self.idx.shape)}")
            self._tables = ColumnTables.build(self.idx, self.val, self.dim)
        return self._tables

    def _kernel_launch(self, kind: str, positions: Optional[int] = None) -> "_KernelLaunch":
        """The slab's checked launch description for one kernel, made on
        first use: the slab's checks run here, once. ``positions`` keys the
        lane-indirect launch of that many positions."""
        key = kind if positions is None else (kind, positions)
        launch = self._launch.get(key)
        if launch is None:
            launch = self._launch[key] = _KernelLaunch.make(self, kind, positions)
        return launch


@dataclasses.dataclass(frozen=True)
class ColumnTables:
    """Per lane, its populated columns and each column's slots, sized by
    the non-zeros: entries ``lane_cols[e]:lane_cols[e+1]`` of ``cols`` and
    ``col_end`` are lane e's populated columns in ascending order; entry c
    owns ``slots[col_end[c-1]:col_end[c]]`` (from 0 for c = 0), its real
    slots' lane-local positions ``m * K + k`` in flat (m, k) order, and lane
    e's slots start at ``lane_slots[e]``. Padding slots (value 0) are listed
    nowhere. Slots are 16-bit (int16 holding the unsigned bits) where
    ``M * K <= 65536``, else int32."""

    lane_cols: Tensor  # (E + 1,) int32
    lane_slots: Tensor  # (E + 1,) int32
    cols: Tensor  # (C,) int32
    col_end: Tensor  # (C,) int32
    slots: Tensor  # (nnz,) int16 or int32
    slot16: bool
    max_lane_cols: int  # most populated columns of one lane
    max_lane_slots: int  # most real slots of one lane

    @staticmethod
    def build(idx: Tensor, val: Tensor, dim: int) -> "ColumnTables":
        e, m, k = idx.shape
        mk = m * k
        lane = torch.arange(e, device=idx.device, dtype=torch.int64)[:, None]
        key = torch.where(val.reshape(e, mk) != 0, idx.reshape(e, mk).long(), dim)
        # one stable sort of (lane, column) keys keeps each column's slots in
        # flat order; the padding key `dim` sorts last within its lane
        sorted_key, perm = torch.sort((key + lane * (dim + 1)).reshape(-1), stable=True)
        real = sorted_key % (dim + 1) != dim
        pairs, counts = torch.unique_consecutive(sorted_key[real], return_counts=True)
        if pairs.numel() and int(counts.sum()) >= 2 ** 31:
            raise ValueError("the slab has 2^31 or more real slots: out of the kernels' range")
        lane_cols, lane_slots = (torch.zeros(e + 1, dtype=torch.int64, device=idx.device)
                                 for _ in range(2))
        lane_cols[1:] = torch.cumsum(torch.bincount(pairs // (dim + 1), minlength=e), 0)
        lane_slots[1:] = torch.cumsum(torch.bincount(sorted_key[real] // (dim + 1),
                                                     minlength=e), 0)
        slots = perm[real] % mk
        slot16 = mk <= 65536
        slots = (torch.where(slots >= 32768, slots - 65536, slots).to(torch.int16) if slot16
                 else slots.to(torch.int32))
        return ColumnTables(lane_cols.to(torch.int32), lane_slots.to(torch.int32),
                            (pairs % (dim + 1)).to(torch.int32),
                            torch.cumsum(counts, 0).to(torch.int32), slots.contiguous(), slot16,
                            int(torch.diff(lane_cols).max()), int(torch.diff(lane_slots).max()))

    def slot_positions(self) -> Tensor:
        """``slots`` as int64 positions (the 16-bit form read unsigned)."""
        s = self.slots.long()
        return s & 0xFFFF if self.slot16 else s

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.lane_cols, self.lane_slots, self.cols, self.col_end, self.slots))


@dataclasses.dataclass(frozen=True)
class FlatOrderPlan:
    """The transpose ``out[lane, idx] += contrib`` in flat ``(m, k)`` order
    from torch ops, for the card. Each populated (lane, column) owns its
    real slots (value non-zero) in flat order; columns are ranked by
    descending slot count, so the columns that still have a slot at step j
    are a prefix of that ranking. A pass gathers every real contribution in
    step-major order, adds step j's prefix into the accumulators with one
    elementwise add, and writes each accumulator to its column once: per
    column the adds of the CUDA kernel's column owner, in its order.
    Padding slots add zero and are left out, as the kernel leaves them."""

    gather: Tensor  # (nnz,) int64: positions in the raveled contributions, step-major
    steps: Tuple[int, ...]  # step j: the columns that have a j-th slot
    # (size,) int64: each raveled output position's ranked column, or C (a
    # zero) where no column lands: the output is one gather, which a CUDA
    # graph can capture
    out_map: Tensor

    @staticmethod
    def build(idx: Tensor, val: Tensor, dim: int) -> "FlatOrderPlan":
        mk = idx.shape[-2] * idx.shape[-1]
        lanes = idx.numel() // mk if mk else 0
        dev = idx.device
        lane = torch.arange(lanes, device=dev, dtype=torch.int64)[:, None]
        key = (idx.reshape(lanes, mk).long() + lane * dim).reshape(-1)
        real = (val.reshape(-1) != 0).nonzero().squeeze(1)
        # a stable sort by column keeps each column's slots in flat order
        col_key, perm = torch.sort(key[real], stable=True)
        cols, counts = torch.unique_consecutive(col_key, return_counts=True)
        step = (torch.arange(col_key.numel(), device=dev)
                - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts))
        order = torch.sort(counts, descending=True, stable=True)[1]
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=dev)
        slot_rank = torch.repeat_interleave(rank, counts)
        step_major = torch.sort(step * max(cols.numel(), 1) + slot_rank)[1]
        per_step = torch.bincount(step, minlength=int(counts.max()) if counts.numel() else 0)
        out_map = torch.full((lanes * dim,), cols.numel(), dtype=torch.int64, device=dev)
        out_map[cols[order]] = torch.arange(cols.numel(), device=dev)
        return FlatOrderPlan(real[perm][step_major], tuple(per_step.tolist()), out_map)

    def apply(self, contrib: Tensor) -> Tensor:
        """The raveled ``(..., D)`` transpose of ``(..., M, K)`` contributions."""
        g = contrib.reshape(-1)[self.gather]
        # a trailing zero serves the output positions no column lands on
        acc = torch.zeros(self.steps[0] + 1 if self.steps else 1, dtype=contrib.dtype,
                          device=contrib.device)
        at = 0
        for n in self.steps:
            acc.narrow(0, 0, n).add_(g.narrow(0, at, n))
            at += n
        return acc.index_select(0, self.out_map)


@dataclasses.dataclass
class SlabLanes:
    """Lanes ``ids`` of a slab, in that order: a solve scheduler's compacted
    batch. The kernels read the lanes' data and column tables from the full
    slab through their lane-indirect launch, so a compaction rebuilds no
    table (``ColumnTables.build`` syncs the host and cannot be captured in
    a CUDA graph). The plain formulation runs on ``plain()``, the lanes
    gathered by ``index_select`` into a slab of their own at each call (the
    device loop rewrites ``ids`` in place between chunks). ``ids`` is int32
    ``(R,)`` on the slab's device."""

    slab: SparseSlab
    ids: Tensor
    # the device loop's inverse permutation of every lane (``inv[l] < R``
    # exactly for the R gathered lanes, at their positions): with it the
    # plain transpose runs on the full slab, through the slab's one
    # FlatOrderPlan, which a CUDA graph can capture
    inv: Optional[Tensor] = None

    @property
    def kernel(self) -> str:
        return self.slab.kernel

    @property
    def dim(self) -> int:
        return self.slab.dim

    @property
    def idx(self) -> Tensor:
        """The full slab's indices (their device and type; the lanes'
        own are ``plain().idx``)."""
        return self.slab.idx

    @property
    def val(self) -> Tensor:
        """The full slab's values (their type; the lanes' own are
        ``plain().val``)."""
        return self.slab.val

    def plain(self) -> SparseSlab:
        ids = self.ids.long()
        return SparseSlab(self.slab.idx.index_select(0, ids), self.slab.val.index_select(0, ids),
                          self.dim, self.kernel)

    def matvec(self, w: Tensor) -> Tensor:
        return self.plain().matvec(w)

    def rmatvec(self, d: Tensor) -> Tensor:
        if self.inv is None:
            return self.plain().rmatvec(d)
        # the lanes' rows in place among zero rows, transposed on the full
        # slab: each lane's columns add its own slots in flat order, as the
        # gathered slab's plan adds them, so the result is bitwise the same
        lanes = self.slab.idx.shape[0]
        pad = d.new_zeros((lanes - d.shape[0],) + tuple(d.shape[1:]))
        full = torch.cat([d, pad]).index_select(0, self.inv)
        return self.slab.rmatvec(full).index_select(0, self.ids.long())


def build_sparse_slab(x, bucketer=None, kernel: str = "scatter",
                      dtype: Optional[torch.dtype] = None) -> SparseSlab:
    """Extract the padded-COO slab from a dense ``(..., M, D)`` stack (a
    tensor on any device, or an array). K is the largest row non-zero count
    (at least 1), rounded up the shape ladder (``bucketer``: a
    ``compile.ShapeBucketer`` or spec, None reads ``PHOTON_SHAPE_LADDER``)
    and capped at D; a stable sort of the zero mask keeps each row's
    non-zeros in ascending column order; padding slots carry column 0 and
    value 0. Byte-equal to the JAX package's build."""
    from photon_ml_tpu_torch.compile import resolve_bucketer

    x = torch.as_tensor(x)
    d = x.shape[-1]
    mask = x != 0
    counts = mask.sum(dim=-1)
    k_raw = max(int(counts.max()) if counts.numel() else 0, 1)
    b = resolve_bucketer(bucketer)
    k = k_raw if b is None else min(b.canon(k_raw), d)
    k = max(min(k, d), 1)
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True)[1][..., :k]
    val = torch.gather(x, -1, order)
    pad = torch.arange(k, device=x.device) >= counts[..., None]
    idx = torch.where(pad, 0, order).to(torch.int32)
    val = torch.where(pad, torch.zeros((), dtype=x.dtype, device=x.device), val)
    return SparseSlab(idx, val.to(dtype or x.dtype), d, kernel)


def slab_nnz_stats(slab: SparseSlab) -> dict:
    """Host-side nnz accounting: how much the slab avoids of its dense
    ``(M, D)`` counterpart."""
    nnz = (slab.val != 0).sum(dim=-1)
    rows = nnz.numel()
    dense_elems = rows * slab.dim
    slab_elems = slab.val.numel()
    return {
        "rows": rows,
        "max_nnz": int(nnz.max()) if rows else 0,
        "mean_nnz": round(float(nnz.float().mean()) if rows else 0.0, 2),
        "padded_k": slab.max_nnz,
        "dim": slab.dim,
        "slab_elements": slab_elems,
        "dense_elements": dense_elems,
        "density": round(slab_elems / dense_elems, 4) if dense_elems else 0.0,
    }


# ---------------------------------------------------------------------------
# the fused pieces: plain version and CUDA kernels
# ---------------------------------------------------------------------------


def _masked(weights: Tensor, x: Tensor) -> Tensor:
    return torch.where(weights > 0.0, weights * x, torch.zeros_like(x))


def fused_value_grad_parts_plain(loss, slab, labels, weights, offsets, w):
    """Per lane ``(sum wt*l, X^T d, sum d)`` in the plain formulation."""
    z = slab.matvec(w) + offsets
    wl = _masked(weights, loss.loss(z, labels))
    d = _masked(weights, loss.d1(z, labels))
    return tree_row_sum(wl), slab.rmatvec(d), tree_row_sum(d)


def fused_hvp_parts_plain(loss, slab, labels, weights, offsets, w, v, vshift):
    """Per lane ``(X^T c, sum c)``, ``c = [wt>0] wt l''(z) (X v + vshift)``."""
    z = slab.matvec(w) + offsets
    d2 = _masked(weights, loss.d2(z, labels))
    c = d2 * (slab.matvec(v) + vshift[..., None])
    return slab.rmatvec(c), tree_row_sum(c)


# launch plan: how a kernel packs lanes into blocks and what it stages

KERNEL_THREADS = 256  # threads per block (csrc/fused_sparse.cu kThreads)
SLOTS_PER_BLOCK = 1024  # a block takes whole lanes until it holds about this many slots
SMEM_BUDGET = 64 * 1024  # shared memory a block may stage: 3 or more blocks per SM
SMEM_LIMIT = 227 * 1024  # what one H100 block can have
BLOCKS_PER_SM = 8  # resident blocks an SM holds (csrc kMinBlocks)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one kernel runs on an (E, M, K, D) slab: ``lanes_per_block``
    whole lanes per block of ``threads``, ``row_threads`` threads per row;
    whether the lanes' data (slab, y/wt/off, row values, column-table
    entries: ``table_cols`` and ``table_slots`` at most) is ``staged`` in
    shared memory, and their rows of w and v (``stage_coef``);
    ``smem_bytes`` in all, laid out as ``layout()`` of csrc/fused_sparse.cu.
    Row values that are not staged live in a device scratch of
    ``scratch_floats``."""

    lanes_per_block: int
    blocks: int
    threads: int
    row_threads: int
    rows_pow2: int
    table_cols: int
    table_slots: int
    staged: bool
    stage_coef: bool
    smem_bytes: int
    scratch_floats: int


def _staged(n: int) -> int:
    """Shared memory for a staged range of n bytes (csrc staged_bytes)."""
    return _align16(n) + 16


def row_threads_for(m: int, k: int) -> int:
    """Threads per row of an ``(M, K)`` slab: a power of two, at most 32,
    no more than K needs, and no more than the rows of a block packed at
    ``SLOTS_PER_BLOCK`` leave room for. A function of M and K alone: the
    margin's K-term association follows it, so a lane's arithmetic does not
    depend on how many lanes the launch holds (the solve scheduler's
    compacted batches rely on that)."""
    lanes = max(1, -(-SLOTS_PER_BLOCK // (m * k)))
    return min(32, _pow2_at_least(k),
               1 << max(0, (KERNEL_THREADS // (lanes * m)).bit_length() - 1))


def plan_launch(e: int, m: int, k: int, d: int, val_bytes: int, hvp: bool, sms: int = 132,
                lane_cols: Optional[int] = None, lane_slots: Optional[int] = None,
                indirect: bool = False) -> LaunchPlan:
    """Pack lanes into blocks and choose what each block stages while its
    ``SMEM_BUDGET`` lasts: first the lanes' data (idx/val, y/wt/off, two
    arrays of row values, and their column-table entries: ``lane_cols``
    populated columns and ``lane_slots`` real slots a lane at most, by
    default what the shape allows), then their rows of w (and v). What is
    not staged is read from device memory (w and v through ``__ldg``).

    A lane never spans two blocks; several lanes share one only while the
    slab is small, so a block that packs lanes always stages. Where the
    grid would need more than one wave of ``BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs, a block takes more lanes while they stage as much. A row
    gets ``row_threads_for(m, k)`` threads. ``indirect`` plans the
    lane-indirect launch of ``e`` positions (its block header holds the
    lanes' ids and table prefixes)."""
    lane_cols = min(m * k, d) if lane_cols is None else lane_cols
    lane_slots = m * k if lane_slots is None else lane_slots
    pw = _pow2_at_least(m)

    def layout(lanes):
        slots = lanes * m * k
        used = _align16(4 * (3 * lanes + 18)) if indirect else _align16(8 * (lanes + 1))
        data = (_align16(8 * lanes * pw) + 3 * _staged(4 * lanes * m)
                + _staged(4 * slots) + _staged(val_bytes * slots)
                + 2 * _staged(4 * lanes * lane_cols)
                + _staged((2 if m * k <= 65536 else 4) * lanes * lane_slots))
        staged = used + data <= SMEM_BUDGET
        used += data if staged else 0
        coef = (2 if hvp else 1) * _staged(4 * lanes * d)
        stage_coef = used + coef <= SMEM_BUDGET
        used += coef if stage_coef else 0
        return staged, stage_coef, used

    lanes = max(1, min(e, -(-SLOTS_PER_BLOCK // (m * k))))
    staged, stage_coef, used = layout(lanes)
    one_wave = min(e, -(-e // (sms * BLOCKS_PER_SM)))
    if one_wave > lanes and layout(one_wave)[:2] == (staged, stage_coef):
        lanes = one_wave
        staged, stage_coef, used = layout(lanes)
    blocks = -(-e // lanes)
    return LaunchPlan(
        lanes_per_block=lanes, blocks=blocks, threads=KERNEL_THREADS,
        row_threads=row_threads_for(m, k),
        rows_pow2=pw, table_cols=lanes * lane_cols, table_slots=lanes * lane_slots,
        staged=staged, stage_coef=stage_coef, smem_bytes=used,
        scratch_floats=0 if staged else blocks * 2 * lanes * pw,
    )


class _SlabPlan(ctypes.Structure):
    """csrc/fused_sparse.cu's SlabPlan, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in
                ("idx", "val", "lane_cols", "lane_slots", "cols", "col_end", "slots")] + [
        ("lanes", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "m", "k", "d", "val_bf16", "slot16", "lanes_per_block", "row_threads",
            "rows_pow2", "table_cols", "table_slots", "staged", "stage_coef", "smem_bytes",
            "indirect")]


@dataclasses.dataclass
class _KernelLaunch:
    """A slab's checked launch description for one kernel: its shape, plan
    and the C struct (which holds raw pointers to the slab and its tables;
    the slab keeps both alive)."""

    e: int
    m: int
    d: int
    device: torch.device
    plan: LaunchPlan
    struct: _SlabPlan
    ref: object  # ctypes pointer to struct

    @staticmethod
    def make(slab: "SparseSlab", kind: str, positions: Optional[int] = None) -> "_KernelLaunch":
        """``positions``: the lane-indirect launch of that many positions
        (planned as an R-lane slab with the full slab's per-lane maxima)."""
        if not slab.idx.is_cuda:
            raise ValueError("the sparse kernels need a CUDA slab")
        if slab.idx.dim() != 3:
            raise ValueError(f"idx: expected (E, M, K), got {tuple(slab.idx.shape)}")
        e, m, k = slab.idx.shape
        d = slab.dim
        if min(e, m, k, d) < 1 or e >= 2 ** 31 or m * k >= 2 ** 31:
            raise ValueError(f"slab shape (E={e}, M={m}, K={k}, D={d}) out of the kernels' range")
        dev = slab.idx.device
        _check("idx", slab.idx, (e, m, k), (torch.int32,), dev)
        _check("val", slab.val, (e, m, k), VAL_DTYPES, dev)
        n = e if positions is None else positions
        if n < 1:
            raise ValueError(f"a lane-indirect launch needs at least one position, got {n}")
        t = slab.kernel_tables()
        plan = plan_launch(n, m, k, d, slab.val.element_size(), kind == "hvp",
                           torch.cuda.get_device_properties(dev).multi_processor_count,
                           t.max_lane_cols, t.max_lane_slots, indirect=positions is not None)
        if plan.lanes_per_block * max(m * k, d) >= 2 ** 31:
            raise ValueError(f"slab shape (E={e}, M={m}, K={k}) out of the kernels' range")
        struct = _SlabPlan(
            slab.idx.data_ptr(), slab.val.data_ptr(), t.lane_cols.data_ptr(),
            t.lane_slots.data_ptr(), t.cols.data_ptr(), t.col_end.data_ptr(),
            t.slots.data_ptr(), n, m, k, d, int(slab.val.dtype == torch.bfloat16),
            int(t.slot16), plan.lanes_per_block, plan.row_threads, plan.rows_pow2,
            plan.table_cols, plan.table_slots, int(plan.staged), int(plan.stage_coef),
            plan.smem_bytes, int(positions is not None))
        return _KernelLaunch(n, m, d, dev, plan, struct, ctypes.byref(struct))


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.photon_sparse_gevm.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, p]
    lib.photon_sparse_gevm.restype = ctypes.c_int
    lib.photon_sparse_hvp.argtypes = [p, p, i, p, p, p, p, p, p, i, p, p, p, p, p]
    lib.photon_sparse_hvp.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return native_build.load(SOURCE, _configure)


def _check(name: str, t: Tensor, shape, dtypes, device) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {'/'.join(str(x)[6:] for x in dtypes)} tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the slab on {device}")


def _f32_args(launch: _KernelLaunch, named) -> list:
    """Data pointers of the per-call vectors, each checked: contiguous f32
    on the slab's device, of shape ``rows`` (E, M), ``cols`` (E, D),
    ``lanes`` (E,) or ``one`` ()."""
    shapes = {"rows": (launch.e, launch.m), "cols": (launch.e, launch.d), "lanes": (launch.e,),
              "one": ()}
    ptrs = []
    for name, t, shape in named:
        shape = shapes[shape]
        if (t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous()
                or t.device != launch.device):
            _check(name, t, shape, (torch.float32,), launch.device)
        ptrs.append(t.data_ptr())
    return ptrs


def _run(fn, what: str, launch: _KernelLaunch, args, rows_out: Optional[Tensor], nrv: int) -> None:
    """Allocate the scratch the plan needs and launch on the current stream
    of the slab's device."""
    rows_ptr = None
    if rows_out is not None:
        _check("row_values", rows_out, (nrv, launch.e, launch.m), (torch.float32,), launch.device)
        rows_ptr = rows_out.data_ptr()
    # held until the kernel is queued: freed after that, the caching
    # allocator hands its block out again only to later work on this stream
    scratch = None
    if launch.plan.scratch_floats:
        scratch = torch.empty(launch.plan.scratch_floats, dtype=torch.float32,
                              device=launch.device)
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    if torch.cuda.current_device() == launch.device.index:
        err = fn(*args, rows_ptr, scratch_ptr, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(launch.device):
            err = fn(*args, rows_ptr, scratch_ptr, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sparse {what} kernel launch failed: cudaError {err} "
                           f"(E, M, D) = {(launch.e, launch.m, launch.d)}, {launch.plan}")


def _lane_launch(slab: SparseSlab, kind: str, lane_ids: Optional[Tensor]):
    """(launch, lane-id pointer): the direct launch, or the lane-indirect
    one over ``lane_ids`` (contiguous int32 ``(R,)`` on the slab's device,
    each a lane of the slab: the kernel reads what they name)."""
    if lane_ids is None:
        return slab._kernel_launch(kind), None
    launch = slab._kernel_launch(kind, lane_ids.numel())
    _check("lane_ids", lane_ids, (lane_ids.numel(),), (torch.int32,), launch.device)
    return launch, lane_ids.data_ptr()


def sparse_gevm_kernel(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                       weights: Tensor, offsets: Tensor, w: Tensor,
                       row_values: Optional[Tensor] = None,
                       lane_ids: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the GEVM kernel: ``(sum wl (E,), grad (E, D), sum d (E,))``.
    The slab is a CUDA ``(E, M, K)`` slab (int32 indices, f32/bf16 values);
    labels/weights/offsets ``(E, M)`` and w ``(E, D)`` are contiguous f32 on
    its device. Raises on anything else. ``row_values``, a ``(2, E, M)`` f32
    buffer, receives the row values wl and d (for tests; the main path
    passes none). With ``lane_ids`` (int32 ``(R,)``), the lane-indirect
    launch: position i is lane ``lane_ids[i]`` of the slab, and the row
    vectors, w and every output have R positions in that order."""
    launch, ids = _lane_launch(slab, "gevm", lane_ids)
    ptrs = _f32_args(launch, (("labels", labels, "rows"), ("weights", weights, "rows"),
                              ("offsets", offsets, "rows"), ("w", w, "cols")))
    grad, sum_wl, sum_d = (torch.empty(shape, dtype=torch.float32, device=launch.device)
                           for shape in ((launch.e, launch.d), launch.e, launch.e))
    _run(_library().photon_sparse_gevm, "GEVM", launch,
         [launch.ref, ids, loss.kernel_id, *ptrs, grad.data_ptr(), sum_wl.data_ptr(),
          sum_d.data_ptr()], row_values, 2)
    sparse_gevm_kernel.launches += 1
    return sum_wl, grad, sum_d


# the launches this wrapper issues, eagerly or once into a CUDA graph being
# captured; a replay of that graph launches its kernels without the wrapper
sparse_gevm_kernel.launches = 0


def sparse_hvp_kernel(loss: PointwiseLoss, slab: SparseSlab, labels: Tensor,
                      weights: Tensor, offsets: Tensor, w: Tensor, v: Tensor,
                      vshift: Tensor, row_values: Optional[Tensor] = None,
                      lane_ids: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Launch the HVP kernel: ``(hvp (E, D), sum c (E,))``; as the GEVM
    kernel, plus v ``(E, D)`` and vshift, ``(E,)`` or one value ``()`` for
    every lane, f32. ``row_values``, a ``(1, E, M)`` f32 buffer, receives c.
    ``lane_ids`` as for the GEVM kernel."""
    launch, ids = _lane_launch(slab, "hvp", lane_ids)
    scalar = vshift.dim() == 0
    ptrs = _f32_args(launch, (("labels", labels, "rows"), ("weights", weights, "rows"),
                              ("offsets", offsets, "rows"), ("w", w, "cols"),
                              ("v", v, "cols"), ("vshift", vshift, "one" if scalar else "lanes")))
    ptrs.append(0 if scalar else 1)  # vshift's stride
    hvp, sum_c = (torch.empty(shape, dtype=torch.float32, device=launch.device)
                  for shape in ((launch.e, launch.d), launch.e))
    _run(_library().photon_sparse_hvp, "HVP", launch,
         [launch.ref, ids, loss.kernel_id, *ptrs, hvp.data_ptr(), sum_c.data_ptr()],
         row_values, 1)
    sparse_hvp_kernel.launches += 1
    return hvp, sum_c


# counted as the GEVM wrapper's
sparse_hvp_kernel.launches = 0


def _f32(t: Tensor, shape) -> Tensor:
    if t.dtype == torch.float32 and t.shape == shape and t.is_contiguous():
        return t  # the solvers' case: no tensor op on the launch path
    return torch.broadcast_to(t.to(torch.float32), shape).contiguous()


def _kernel_target(slab) -> Tuple[SparseSlab, Optional[Tensor]]:
    """(the slab a kernel launches on, lane ids or None) of a slab or a
    ``SlabLanes`` view."""
    if isinstance(slab, SlabLanes):
        return slab.slab, slab.ids
    return slab, None


def fused_value_grad_parts(loss: PointwiseLoss, slab, labels: Tensor,
                           weights: Tensor, offsets: Tensor, w: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per lane ``(sum_m wt*l, X^T d, sum_m d)``: ``(E,)``, ``(E, D)``,
    ``(E,)``. ``offsets`` already fold the normalization margin shift. A
    CUDA slab goes through the GEVM kernel (one launch, row sums inside; a
    ``SlabLanes`` view through its lane-indirect launch), a CPU slab through
    the plain version."""
    if not slab.idx.is_cuda:
        return fused_value_grad_parts_plain(loss, slab, labels, weights, offsets, w)
    base, ids = _kernel_target(slab)
    rows = (w.shape[0], base.num_rows)
    return sparse_gevm_kernel(
        loss, base, _f32(labels, rows), _f32(weights, rows), _f32(offsets, rows),
        _f32(w, (rows[0], base.dim)), lane_ids=ids,
    )


def fused_hvp_parts(loss: PointwiseLoss, slab, labels: Tensor,
                    weights: Tensor, offsets: Tensor, w: Tensor, v: Tensor,
                    vshift: Tensor) -> Tuple[Tensor, Tensor]:
    """Per lane ``(X^T c, sum_m c)`` with ``c = [wt>0] wt l''(z) (X v +
    vshift)``: ``(E, D)`` and ``(E,)``; vshift is per lane."""
    lanes = tuple(w.shape[:-1])
    if not slab.idx.is_cuda:
        vshift = torch.broadcast_to(torch.as_tensor(vshift, device=w.device), lanes)
        return fused_hvp_parts_plain(loss, slab, labels, weights, offsets, w, v, vshift)
    vshift = torch.as_tensor(vshift, dtype=torch.float32, device=w.device)
    base, ids = _kernel_target(slab)
    rows = (lanes[0], base.num_rows)
    cols = (lanes[0], base.dim)
    return sparse_hvp_kernel(
        loss, base, _f32(labels, rows), _f32(weights, rows), _f32(offsets, rows),
        _f32(w, cols), _f32(v, cols), vshift if vshift.dim() == 0 else _f32(vshift, lanes),
        lane_ids=ids,
    )


# ---------------------------------------------------------------------------
# selection: the per-bucket race (dense incumbent against the sparse families)
# ---------------------------------------------------------------------------


def _family_block(kernel: str) -> Tuple[str, int]:
    if ":" in kernel:
        fam, block = kernel.split(":", 1)
        return fam, int(block)
    return kernel, 0


def sparse_candidates(m: int) -> Tuple[str, ...]:
    """The raced family names for a slab of ``m`` padded rows per lane."""
    blocked = tuple(f"pallas:{b}" for b in PALLAS_ROW_BLOCKS if m > b and m % b == 0)
    return SPARSE_FAMILIES + blocked


def resolve_sparse_kernel(spec: Optional[str] = None) -> Optional[str]:
    """Effective sparse-kernel spec: an explicit value wins; ``None`` falls
    back to ``PHOTON_SPARSE_KERNEL``. Returns ``None`` (off), ``"auto"``
    (race per bucket), or a family name."""
    if spec is None:
        spec = os.environ.get(_SPARSE_ENV)
    if spec is None:
        return None
    text = str(spec).strip().lower()
    if text in ("", "off", "false", "0", "none"):
        return None
    if text in ("on", "auto", "race"):
        return "auto"
    fam, _ = _family_block(text)
    if fam not in SPARSE_FAMILIES or (":" in text and fam != "pallas"):
        # ":<rows>" is pallas-only grammar, as in the JAX package
        raise ValueError(
            f"bad sparse-kernel spec {spec!r} (want off | auto | "
            f"{' | '.join(SPARSE_FAMILIES)} | pallas:<rows>)"
        )
    return text


_race_cache: dict = {}
_race_reports: dict = {}

RACE_LANES = 512  # a race probes this many lanes of its dataset at most
RACE_GATE_SEED = 20260729  # the seeded coefficients the race also verifies at


def _lane_vg(task):
    """The solvers' own lane value+grad closure (``GLMObjective`` over a
    lane-batched ``GLMBatch``, identity normalization, no L2), so the race
    measures what a solve pays per evaluation."""
    from photon_ml_tpu_torch.ops import losses as losses_mod
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective

    obj = GLMObjective(losses_mod.for_task(task))
    norm = NormalizationContext.identity()

    def vg(feats, y, off, wt, w):
        if isinstance(feats, Tensor):
            feats = DenseFeatures(feats)
        return obj.value_and_grad(w, GLMBatch(feats, y, off, wt), norm, 0.0)

    return vg


def _max_diff(a: Tensor, b: Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b.double()))) if a.numel() else 0.0


def _same_code(fam: str) -> Optional[str]:
    """The raced name whose code ``fam`` runs in the port, or None: the
    plain families are one formulation, the blocked pallas names the one
    kernel."""
    if fam in ("scatter", "flat"):
        return SPARSE_BASELINE
    if fam != "pallas" and _family_block(fam)[0] == "pallas":
        return "pallas"
    return None


def race_sparse_kernels(task, slab: SparseSlab, x_dense, labels: Tensor, offsets: Tensor,
                        weights: Tensor, candidates: Optional[Tuple[str, ...]] = None) -> dict:
    """Race every sparse family (and the dense incumbent) on this bucket's
    own tensors, its first ``RACE_LANES`` lanes, through the solvers' lane
    value+grad closure. Each candidate is verified at w = 0 and at a seeded
    w (``RACE_GATE_SEED``), where the margins' association shows.

    Returns ``{"winner", "baseline", "shape", "nnz", "candidates"}`` as the
    JAX package does: every raced name appears either with its timing or
    with a ``"failed"`` reason (a value or gradient not bitwise the
    ``segment`` baseline's, with the largest difference; ineligibility; or
    a name that runs the code of another raced name: ``scatter`` and
    ``flat`` are ``segment`` here, ``pallas:<rows>`` is ``pallas``, and
    each is timed once). ``winner`` is a family name, or ``None`` when the
    dense path keeps the bucket. A family that raises on a CUDA slab (a
    kernel that fails to build or launch) raises here with its reason: only
    a measured loss or a failed check hands the bucket to another family.
    """
    e, m, k = slab.idx.shape
    d = slab.dim
    n = min(e, RACE_LANES)
    slab_p = SparseSlab(slab.idx[:n].contiguous(), slab.val[:n].contiguous(), d, slab.kernel)
    y_p, off_p, wt_p = (t[:n].contiguous() for t in (labels, offsets, weights))
    w0 = torch.zeros((n, d), dtype=_acc_dtype(slab.val.dtype), device=slab.device)
    # the gate's second point: a seeded draw, the same on every device (at
    # w = 0 every margin is 0 whatever order its products are added in)
    w1 = (0.1 * torch.randn((n, d), generator=torch.Generator().manual_seed(RACE_GATE_SEED),
                            dtype=torch.float64)).to(w0.dtype).to(slab.device)
    vg = _lane_vg(task)
    time_vg = lambda data: fused_glm.time_value_and_grad(lambda w, dd: vg(*dd, w), w0, data)

    report, timings, outputs = {}, {}, {}
    cands = list(candidates if candidates is not None else sparse_candidates(m))
    if SPARSE_BASELINE not in cands:
        cands.insert(0, SPARSE_BASELINE)
    f64 = slab.val.dtype == torch.float64
    for fam in cands:
        if _family_block(fam)[0] == "pallas" and f64:
            report[fam] = {"failed": "skipped: pallas family ineligible under float64"}
            continue
        same = _same_code(fam)
        if same is not None and same in cands:
            report[fam] = {"failed": f"skipped: the port runs it as {same}, timed once"}
            continue
        data = (slab_p.with_kernel(fam), y_p, off_p, wt_p)
        try:
            outputs[fam] = vg(*data, w0) + vg(*data, w1)
            # timing stays inside the try: a candidate that verifies but
            # fails while timed reads as failed too
            timings[fam] = time_vg(data)
        except Exception as exc:
            reason = f"error: {type(exc).__name__}: {exc}"[:300]
            if slab.device.type == "cuda":
                raise RuntimeError(f"sparse race, family {fam}: {reason}") from exc
            # race probe on a CPU slab: the failure disqualifies the
            # candidate and is recorded with its reason
            report[fam] = {"failed": reason}
            outputs.pop(fam, None)

    base = outputs.get(SPARSE_BASELINE)
    verified = {}
    for fam, got in outputs.items():
        if base is None:
            report.setdefault(fam, {})["failed"] = "baseline family failed; no verification possible"
            continue
        if not all(torch.equal(a, b) for a, b in zip(got, base)):
            report[fam] = {"failed": (
                f"numerics: not bitwise-equal to the {SPARSE_BASELINE} baseline on this "
                f"device (max |diff| value "
                f"{max(_max_diff(got[0], base[0]), _max_diff(got[2], base[2])):.3e}, "
                f"gradient {max(_max_diff(got[1], base[1]), _max_diff(got[3], base[3])):.3e}; "
                "at w = 0 and at a seeded w)")}
            continue
        verified[fam] = timings[fam]

    try:
        x_p = torch.as_tensor(x_dense)[:n].to(slab.device).contiguous()
        timings["dense"] = time_vg((x_p, y_p, off_p, wt_p))
    except Exception as exc:  # noqa: BLE001 — incumbent probe: the race goes on without it, the failure recorded
        report["dense"] = {"failed": f"error: {type(exc).__name__}: {exc}"[:300]}

    rows = n * m
    for fam, sec in timings.items():
        if fam in verified or fam == "dense":
            report[fam] = {
                "sec_per_pass": round(sec, 6),
                "lane_rows_per_sec": round(rows / sec, 1) if sec else 0.0,
            }
    eligible = dict(verified)
    if "dense" in timings:
        eligible["dense"] = timings["dense"]
    winner = min(eligible, key=eligible.get) if eligible else None
    return {
        "winner": None if winner == "dense" else winner,
        "baseline": SPARSE_BASELINE,
        "shape": {"lanes": int(e), "rows": m, "k": k, "dim": d},
        "nnz": slab_nnz_stats(slab),
        "candidates": {fam: report[fam] for fam in cands + ["dense"] if fam in report},
    }


def select_sparse_kernel(task, slab: SparseSlab, x_dense, labels: Tensor, offsets: Tensor,
                         weights: Tensor, spec: Optional[str] = None, label: str = "re",
                         candidates: Optional[Tuple[str, ...]] = None) -> Optional[str]:
    """Per-bucket family selection. ``spec`` (or ``PHOTON_SPARSE_KERNEL``):
    off -> ``None`` (the dense path stays); a family name -> forced;
    ``auto`` -> the race on this bucket's tensors, cached per (loss, shape,
    dtype, device, candidates). Returns the family, or ``None`` for dense.
    ``candidates`` narrows the race to the named families (and dense). A
    race that raises (a kernel failing on the card) leaves its reason in
    ``race_reports()`` and chooses nothing."""
    from photon_ml_tpu_torch.ops import losses as losses_mod

    resolved = resolve_sparse_kernel(spec)
    if resolved != "auto":
        return resolved
    e, m, k = slab.idx.shape
    # dtype is part of the key (pallas is ineligible under f64), and a
    # narrowed race must not answer for the full one
    key = (
        losses_mod.for_task(task).name, e, m, k, slab.dim,
        str(slab.val.dtype).replace("torch.", ""), str(slab.device),
        tuple(candidates) if candidates else None,
    )
    if key not in _race_cache:
        try:
            report = race_sparse_kernels(task, slab, x_dense, labels, offsets, weights,
                                         candidates=tuple(candidates) if candidates else None)
        except Exception as exc:
            # a kernel that failed on the card: recorded with its reason, then raised
            _race_reports[(label,) + key] = {"failed": f"{type(exc).__name__}: {exc}"[:300]}
            raise
        _race_reports[(label,) + key] = report
        _race_cache[key] = report["winner"]
    fused_glm.race_log.append(("sparse", key, _race_cache[key]))
    return _race_cache[key]


def adopt_race_decisions(decisions) -> None:
    """Seed both races' caches with recorded ``(race, key, winner)``
    decisions (``fused_glm.race_log`` entries, tuples or the lists JSON
    makes of them): the selections that meet those keys take the recorded
    winners and race nothing."""

    def as_tuple(v):
        return tuple(as_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v

    for race, key, winner in decisions:
        cache = {"dense": fused_glm._autotune_cache, "sparse": _race_cache}[race]
        cache[as_tuple(key)] = winner


def race_reports() -> dict:
    """Every recorded per-bucket race report, keyed by (label,) + cache key."""
    return dict(_race_reports)


def build_and_select(task, x, labels: Tensor, offsets: Tensor, weights: Tensor, spec: str,
                     label: str, bucketer=None,
                     candidates: Optional[Tuple[str, ...]] = None) -> Optional[SparseSlab]:
    """Slab build and family selection for one bucket's dense stack ``x``,
    with an already-resolved ``spec``: ``auto`` races on this bucket's own
    tensors (narrowed to ``candidates`` when given), a family name is
    forced. Returns the slab carrying the family, or ``None`` when the dense
    path keeps the bucket. The fused family is never taken for f64 values:
    a forced ``pallas`` warns and runs ``scatter``, as the JAX package does."""
    slab = build_sparse_slab(x, bucketer=bucketer)
    if spec == "auto":
        family = select_sparse_kernel(task, slab, x, labels, offsets, weights, spec="auto",
                                      label=label, candidates=candidates)
    else:
        family = spec
        if _family_block(family)[0] == "pallas" and slab.val.dtype == torch.float64:
            warnings.warn(
                f"{label}: pallas family is ineligible under float64; "
                "running the scatter family instead",
                stacklevel=2,
            )
            family = "scatter"
    return slab.with_kernel(family) if family is not None else None
