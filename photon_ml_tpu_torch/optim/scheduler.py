"""Convergence-compacted solve scheduler: chunk → compact → resume (port of
photon_ml_tpu/optim/scheduler.py).

A lane-batched random-effect solve steps every lane until the slowest one
converges. The scheduler stops converged lanes from burning device work:

  1. **chunk**: advance every lane K more iterations (``advance`` of
     ``algorithm/random_effect.entity_lane_fns``, to an absolute iteration
     bound); converged lanes are masked no-ops, active lanes pause at the
     chunk boundary with their whole carried state;
  2. **compact**: read the per-lane ``reason`` flags, gather the
     unconverged lanes' problem data and state into a smaller batch padded
     up the ``ShapeBucketer`` ladder, so compacted batches land on about
     log(E) lane counts (on the card: the kernels' launch plans and the
     device loop's captured graphs are shared by rung). Pad lanes repeat a
     real lane with ``reason`` forced non-zero, so they freeze. A
     ``SparseSlab``'s lanes are gathered as a ``SlabLanes`` view, which the
     kernels read through their lane-indirect launch: no column table is
     rebuilt;
  3. **resume**: advance the compacted batch another K iterations and
     scatter its lanes back into the full entity-order state.

Every lane's arithmetic is independent of the batch it rides in, so the
final results are bitwise those of the one-shot solve. The solvers reduce
over a lane's coefficients through the fixed-association ``lane_sum``
(optim/common.py), never through a library reduction whose order may
follow the batch; the CPU's transcendental functions compute every lane
element alike (ops/losses.py); on the card the ``pallas`` slab kernels
choose a lane's summation order from (M, K, D) alone. A dense ``(E, M, D)``
stack contracts through elementwise products and ``tree_row_sum``
(ops/features.py, ops/objective.py), never a batched ``torch.matmul``,
whose cuBLAS kernel follows the batch count (it parted compacted lanes
from the one-shot solve's bits on an NVIDIA H100, chip_smoke.py phase 21
(f)). So a dense stack is compacted on the card as on the CPU.

``schedule.loop == "device"`` runs the rung loop of optim/fused_schedule.py
instead (on the card, one captured CUDA graph per rung width): same bits,
O(#rungs) host reads. Only an injected ``optim.device_drain`` fault
degrades it to the host loop; a real capture or replay error raises.

Telemetry: every compacted solve records its chunks and its lane-iteration
ledger in :data:`solve_stats`, with the host reads it counted (``HostReads``:
each is a sync with the card, and not every sync is one of them); drivers
log ``solve_stats.summary()``.

``PHOTON_SOLVE_CHUNK`` = ``off`` (default) | ``on`` | K | ``device[:K]``,
read through ``compile/overrides.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.compile.canonical import ShapeBucketer
from photon_ml_tpu_torch.ops.fused_sparse import SlabLanes, SparseSlab
from photon_ml_tpu_torch.optim.common import HostReads, OptResult
from photon_ml_tpu_torch.resilience import faults, preemption

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

DEFAULT_CHUNK = 8

# reason code stamped on ladder-pad lanes so the chunk freezes them; never
# scattered back
_PAD_REASON = 1


@dataclasses.dataclass(frozen=True)
class SolveSchedule:
    """Static compaction policy for one coordinate's solves.

    ``chunk_size``: iterations per chunk between compaction pauses.
    ``bucketer``: the ladder compacted lane counts round up to.
    ``loop``: ``"host"`` (this module's chunk loop, the default) or
    ``"device"`` (optim/fused_schedule.py: the rung loop, one captured
    CUDA graph per rung width on the card; results stay bitwise).
    """

    chunk_size: int = DEFAULT_CHUNK
    bucketer: ShapeBucketer = ShapeBucketer()
    loop: str = "host"

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(
                f"solve-compaction chunk size must be >= 1, got {self.chunk_size}"
            )
        if self.loop not in ("host", "device"):
            raise ValueError(
                f"solve-compaction loop must be 'host' or 'device', "
                f"got {self.loop!r}"
            )

    def describe(self) -> str:
        loop = f"loop={self.loop}, " if self.loop != "host" else ""
        return (
            f"compaction(chunk={self.chunk_size}, {loop}"
            f"{self.bucketer.describe()})"
        )


def resolve_schedule(spec=None) -> Optional[SolveSchedule]:
    """Effective schedule: an explicit value wins; ``None`` falls back to
    ``PHOTON_SOLVE_CHUNK``. Returns None when compaction is off.

    Spellings (driver flag and env var share them): ``off``/``false``/``0``
    -> None; ``on``/``true`` -> default chunk; a positive integer -> that
    chunk size; ``device`` or ``device:CHUNK`` -> the device loop.
    """
    if isinstance(spec, SolveSchedule):
        return spec
    if spec is None:
        from photon_ml_tpu_torch.compile.overrides import solve_chunk_spec

        raw = solve_chunk_spec()
        if raw is None:
            return None
        return resolve_schedule(raw)
    if isinstance(spec, bool):
        return SolveSchedule() if spec else None
    if isinstance(spec, int):
        return SolveSchedule(chunk_size=spec) if spec > 0 else None
    text = str(spec).strip().lower()
    if text in ("", "off", "false", "0", "none"):
        return None
    if text in ("on", "true", "default"):
        return SolveSchedule()
    if text == "device":
        return SolveSchedule(loop="device")
    if text.startswith("device:"):
        inner = resolve_schedule(text.split(":", 1)[1])
        if inner is None:
            raise ValueError(
                f"bad solve-compaction spec {spec!r}: 'device:' needs a "
                "chunk size (the device loop has no 'off' half)"
            )
        return dataclasses.replace(inner, loop="device")
    try:
        chunk = int(text)
    except ValueError as e:
        raise ValueError(
            f"bad solve-compaction spec {spec!r} (want off | on | CHUNK | "
            f"device[:CHUNK], e.g. 8 or device:8): {e}"
        ) from e
    if chunk < 1:
        raise ValueError(
            f"solve-compaction chunk size must be >= 1, got {chunk}"
        )
    return SolveSchedule(chunk_size=chunk)


# ---------------------------------------------------------------------------
# telemetry (process-wide, thread-safe)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChunkRecord:
    """One host dispatch of one compacted solve: a chunk on the host loop,
    a rung hop on the device loop."""

    chunk: int  # index within the solve
    batch_lanes: int  # lanes in the dispatched batch (full E or ladder rung)
    active_lanes: int  # genuinely unconverged lanes in the batch
    limit: int  # absolute iteration bound the dispatch ran to
    advanced: int  # iterations the loop actually stepped (max over lanes)


@dataclasses.dataclass
class SolveRecord:
    """Lane-iteration ledger of one compacted solve. ``chunks`` holds one
    entry per host dispatch; ``device_chunks`` the chunks run inside the
    device loop's rung programs (0 on the host loop); ``host_reads`` the
    counted host reads (``HostReads``: the solvers' own convergence tests
    and the scheduler's flag reads; each is a sync with the card, but the
    count is a lower bound on the syncs, which chip_smoke.py phase 21 (a)
    measures)."""

    label: str
    lanes: int  # entity lanes in the full problem
    max_iteration: int  # slowest lane's final iteration count
    executed: int  # sum over chunks of batch_lanes * advanced
    baseline: int  # lanes * max_iteration: the one-shot burn
    chunks: List[ChunkRecord]
    device_chunks: int = 0
    host_reads: int = 0

    @property
    def saved(self) -> int:
        return self.baseline - self.executed

    @property
    def dispatches(self) -> int:
        return len(self.chunks)


class SolveStats:
    """Registry of compacted-solve ledgers: totals in plain counters, the
    worst (largest-baseline) record and a short ring of recent ones, and
    the per-block visitation ledger of adaptive scheduling, keyed by label
    (bounded by the block count)."""

    RECENT_KEEP = 32
    HOTTEST_KEEP = 5

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = dict.fromkeys(
            ("solves", "lanes", "executed", "baseline", "chunks",
             "device_chunks", "host_reads", "blocks_visited", "blocks_skipped"), 0
        )
        self._worst: Optional[SolveRecord] = None
        self._recent: List[SolveRecord] = []
        self._blocks: dict = {}

    def record(self, rec: SolveRecord) -> None:
        with self._lock:
            self._counters["solves"] += 1
            self._counters["lanes"] += rec.lanes
            self._counters["executed"] += rec.executed
            self._counters["baseline"] += rec.baseline
            self._counters["chunks"] += len(rec.chunks)
            self._counters["device_chunks"] += rec.device_chunks
            self._counters["host_reads"] += rec.host_reads
            if self._worst is None or rec.baseline > self._worst.baseline:
                self._worst = rec
            self._recent.append(rec)
            del self._recent[: -self.RECENT_KEEP]

    def record_block(self, label: str, *, score: Optional[float] = None,
                     executed: int = 0, skipped: bool = False) -> None:
        """One block-level visitation event of the adaptive schedule: a
        solved visit carries its score and lane-iterations, a skip
        neither."""
        with self._lock:
            e = self._blocks.setdefault(
                label, {"visits": 0, "skips": 0, "score": None, "executed": 0}
            )
            if skipped:
                e["skips"] += 1
                self._counters["blocks_skipped"] += 1
            else:
                e["visits"] += 1
                e["executed"] += int(executed)
                if score is not None:
                    e["score"] = float(score)
                self._counters["blocks_visited"] += 1

    def snapshot(self) -> List[SolveRecord]:
        """The most recent solve records (bounded ring, newest last)."""
        with self._lock:
            return list(self._recent)

    def block_totals(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._blocks.items()}

    def reset(self) -> None:
        with self._lock:
            self._counters = dict.fromkeys(self._counters, 0)
            self._worst = None
            self._recent.clear()
            self._blocks.clear()

    def totals(self) -> dict:
        with self._lock:
            return {
                "solves": self._counters["solves"],
                "lanes": self._counters["lanes"],
                "executed_lane_iterations": self._counters["executed"],
                "baseline_lane_iterations": self._counters["baseline"],
                "saved_lane_iterations": (
                    self._counters["baseline"] - self._counters["executed"]
                ),
                "chunk_dispatches": self._counters["chunks"],
                "device_chunk_iterations": self._counters["device_chunks"],
                "host_reads": self._counters["host_reads"],
            }

    def realized_plan_cost(self) -> Optional[float]:
        """This run's solve ledger in planner cost units (compile/cost.py):
        executed lane-iterations plus the host-pause tariff per host
        dispatch (every chunk on the host loop, every rung hop on the
        device loop; chunks inside a rung's graph pause nothing). The
        realized cost ``ExecutionPlan.record_realized`` feeds back into the
        schedule's predictions; None when no solves ran."""
        from photon_ml_tpu_torch.compile.cost import CHUNK_PAUSE_COST

        with self._lock:
            if not self._counters["solves"]:
                return None
            return float(self._counters["executed"]
                         + CHUNK_PAUSE_COST * self._counters["chunks"])

    def summary(self) -> str:
        """Driver-log summary: the ledger plus the active-lane decay of the
        worst (largest-baseline) solve."""
        with self._lock:
            c = dict(self._counters)
            worst = self._worst
            blocks = {k: dict(v) for k, v in self._blocks.items()}
        lines = []
        if not c["solves"]:
            lines.append("solve compaction: no compacted solves recorded")
        else:
            saved = c["baseline"] - c["executed"]
            pct = 100.0 * saved / c["baseline"] if c["baseline"] else 0.0
            lines.append(
                f"solve compaction: {c['solves']} solves / {c['lanes']} lanes; "
                f"{c['executed']} lane-iterations executed vs {c['baseline']} one-shot "
                f"(saved {saved}, {pct:.1f}%); {c['chunks']} host dispatches, "
                f"{c['device_chunks']} device chunks, {c['host_reads']} counted host reads"
            )
        if worst is not None:
            decay = " -> ".join(
                f"{ch.active_lanes}/{ch.batch_lanes}@{ch.limit}" for ch in worst.chunks
            )
            lines.append(
                f"  [{worst.label}] active-lane decay (active/batch@limit): {decay}"
            )
        if blocks:
            hottest = sorted(
                ((k, v) for k, v in blocks.items() if v["score"] is not None),
                key=lambda kv: -kv[1]["score"],
            )[: self.HOTTEST_KEEP]
            lines.append(
                f"adaptive blocks: {c['blocks_visited']} visits / "
                f"{c['blocks_skipped']} skips across {len(blocks)} blocks"
                + (
                    "; hottest: " + ", ".join(
                        f"{k}(score={v['score']:.3g}, iters={v['executed']})"
                        for k, v in hottest
                    )
                    if hottest else ""
                )
            )
        return "\n".join(lines)


#: THE process-wide registry every compacted solve reports into.
solve_stats = SolveStats()


# ---------------------------------------------------------------------------
# lane data and state: gather, scatter, snapshot
# ---------------------------------------------------------------------------


def _lane_fns(task, optimizer, optimizer_config, regularization, reg_weight=None):
    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns

    return entity_lane_fns(task, optimizer, optimizer_config, regularization, reg_weight)


def _gather_data(data, idx: Tensor):
    """The lanes ``idx`` (int64 ``(R,)`` on the data's device) of
    ``(feats, y, off, wt)``: a slab's as a ``SlabLanes`` view, the rest by
    ``index_select``."""
    feats, *rows = data
    if isinstance(feats, SparseSlab):
        feats = SlabLanes(feats, idx.to(torch.int32))
    else:
        feats = feats.index_select(0, idx)
    return (feats, *(t.index_select(0, idx) for t in rows))


def _fields(state):
    return [f.name for f in dataclasses.fields(state)]


def _gather_state(state, idx: Tensor):
    """The lanes ``idx`` of a solver state (every field has the lane axis)."""
    return dataclasses.replace(state, **{
        n: (None if getattr(state, n) is None else getattr(state, n).index_select(0, idx))
        for n in _fields(state)})


def _upload_lanes(idx: np.ndarray, device: torch.device) -> Tensor:
    """Lane ids as an int64 tensor on ``device``. On the card the copy is
    issued from pinned memory with ``non_blocking=True``, so it does not
    synchronize the host (a pageable copy would, uncounted by
    ``HostReads``); the caching host allocator keeps the pinned buffer
    until the copy has run. The bits are the same either way."""
    host = torch.from_numpy(idx.astype(np.int64))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _gather_batch(data, state, idx: np.ndarray, n_active: int):
    """Compact the ``idx`` lanes of (data, state); entries past
    ``n_active`` repeat a real lane and get ``reason`` forced non-zero so
    they freeze."""
    idx_t = _upload_lanes(idx, state.w.device)
    state_c = _gather_state(state, idx_t)
    pad = torch.arange(idx.shape[0], device=state.w.device) >= n_active
    state_c.reason = torch.where(pad, torch.full_like(state_c.reason, _PAD_REASON),
                                 state_c.reason)
    return _gather_data(data, idx_t), state_c


def _scatter_batch(full_state, part_state, idx: np.ndarray, n_active: int):
    """Scatter the first ``n_active`` lanes of a compacted batch back into
    entity order (pad lanes land nowhere)."""
    pos = _upload_lanes(idx[:n_active], full_state.w.device)
    return dataclasses.replace(full_state, **{
        n: (None if getattr(full_state, n) is None else
            getattr(full_state, n).index_copy(0, pos, getattr(part_state, n)[:n_active]))
        for n in _fields(full_state)})


def _snapshot_state(state, label: str, limit: int, executed: int,
                    chunks: List[ChunkRecord]) -> dict:
    """Host snapshot of a paused solve, the ``partial`` payload checkpoint.py
    persists: the full per-lane state as numbered numpy leaves (a bitwise
    round trip) plus the scheduler's bookkeeping. A resume rebuilds the
    state and continues; the finished solve equals an uninterrupted one."""
    names = [n for n in _fields(state) if getattr(state, n) is not None]
    return {
        "meta": {
            "kind": "scheduler",
            "label": label,
            "limit": int(limit),
            "executed": int(executed),
            "treedef": f"{type(state).__name__}({', '.join(names)})",
            "num_leaves": len(names),
            "chunks": [dataclasses.asdict(c) for c in chunks],
        },
        "arrays": {f"state.{i}": getattr(state, n).detach().cpu().numpy()
                   for i, n in enumerate(names)},
    }


def _restore_state(template_state, partial: dict):
    """Rebuild the paused state from a snapshot, a freshly initialized
    state giving the structure and the device."""
    names = [n for n in _fields(template_state) if getattr(template_state, n) is not None]
    meta = partial["meta"]
    treedef = f"{type(template_state).__name__}({', '.join(names)})"
    if meta.get("treedef") != treedef or meta.get("num_leaves") != len(names):
        raise ValueError(
            "scheduler resume snapshot does not match this solver's state "
            f"structure ({meta.get('treedef')} vs {treedef}) — optimizer or "
            "config changed since the emergency checkpoint; refusing to resume"
        )
    dev = template_state.w.device
    return dataclasses.replace(template_state, **{
        n: torch.from_numpy(np.array(partial["arrays"][f"state.{i}"])).to(dev)
        for i, n in enumerate(names)})


# ---------------------------------------------------------------------------
# the scheduler loop
# ---------------------------------------------------------------------------


def compacted_solve(data, w0: Tensor, *, task, optimizer, optimizer_config, regularization,
                    schedule: SolveSchedule, label: str = "re_solve",
                    resume: Optional[dict] = None, reg_weight=None,
                    graphs: Optional[dict] = None) -> OptResult:
    """Solve every lane of ``data = (feats, y, off, wt)`` (each with leading
    entity axis E) with chunked, convergence-compacted batches. Returns the
    lane-batched ``OptResult``, bitwise the one-shot solve's.

    The loop: init -> chunk on the full batch -> read the per-lane reason
    flags -> while a lane is unconverged: gather the active lanes onto the
    ladder (when the rung is smaller than the batch, or the active set
    changed once compacted), chunk again, scatter back. Telemetry lands in
    :data:`solve_stats`.

    Chunk pauses are preemption drain points (site ``"chunk"``): a request
    raises ``Preempted`` carrying a host snapshot of the paused state;
    passing it back as ``resume`` finishes the solve bitwise as an
    uninterrupted one would (resumed batches restart uncompacted).

    ``schedule.loop == "device"`` goes through the device loop
    (optim/fused_schedule.py; ``graphs`` is the caller's cache of captured
    rung programs, keyed by its tensors). The ``optim.device_drain`` fault
    site guards that dispatch: an injected fault degrades this solve to
    the host loop below, which recomputes from scratch with the same bits.
    Nothing else degrades: a capture, replay or kernel error raises.
    ``reg_weight`` overrides the total regularization weight.
    """
    cfg = dict(task=task, optimizer=optimizer, optimizer_config=optimizer_config,
               regularization=regularization)
    lanes = int(w0.shape[0])
    if schedule.loop == "device":
        from photon_ml_tpu_torch.optim import fused_schedule

        try:
            faults.inject("optim.device_drain", label=label, lanes=lanes)
        except Exception as e:  # noqa: BLE001 — only the injected fault reaches here; the host loop recomputes the solve with the same bits
            logger.warning("device solve (%s) refused by an injected fault (%s: %s); "
                           "degrading to the host chunk loop", label, type(e).__name__, e)
        else:
            return fused_schedule.device_solve(
                data, w0, schedule=schedule, label=label, resume=resume,
                reg_weight=reg_weight, graphs=graphs, **cfg)
    reads0 = HostReads.count
    max_iter = optimizer_config.max_iterations
    chunk = schedule.chunk_size
    bucketer = schedule.bucketer

    _, init, advance, result_of = _lane_fns(**cfg, reg_weight=reg_weight)

    state = init(*data, w0)
    chunks: List[ChunkRecord] = []
    executed = 0
    limit = 0
    if resume is not None:
        # the fresh state is only the structure template; every carried
        # value comes from the snapshot
        state = _restore_state(state, resume)
        limit = int(resume["meta"]["limit"])
        executed = int(resume["meta"]["executed"])
        chunks = [ChunkRecord(**c) for c in resume["meta"]["chunks"]]

    # batch bookkeeping: cur_ids maps batch position -> entity lane; the
    # full state is authoritative (compacted chunks scatter back into it)
    cur_data = data
    cur_state = state
    cur_ids = np.arange(lanes)
    cur_active = lanes
    if resume is not None:
        HostReads.count += 1
        cur_active = int(np.count_nonzero(state.reason.cpu().numpy() == 0))
    compacted = False

    while True:
        prev_limit = limit
        limit = min(limit + chunk, max_iter)
        cur_state = advance(*cur_data, cur_state, limit)
        if compacted:
            state = _scatter_batch(state, cur_state, cur_ids, cur_active)
        else:
            state = cur_state
        # one small read a chunk: the lane flags and iteration counters that
        # drive compaction and the ledger
        HostReads.count += 1
        reasons, iters = torch.stack([state.reason, state.iteration]).cpu().numpy()
        advanced = max(int(min(int(iters.max(initial=0)), limit) - prev_limit), 0) if lanes else 0
        batch_lanes = len(cur_ids)
        active_idx = np.nonzero(reasons == 0)[0]
        chunks.append(ChunkRecord(chunk=len(chunks), batch_lanes=batch_lanes,
                                  active_lanes=cur_active, limit=limit, advanced=advanced))
        executed += batch_lanes * advanced
        if active_idx.size == 0 or limit >= max_iter:
            break
        if preemption.check("chunk", label=label, limit=limit):
            # the full state was just scattered back, so its snapshot is
            # the solve: coordinate descent folds it into the emergency
            # checkpoint
            raise preemption.Preempted(
                f"preempted at chunk boundary ({label}, iteration limit "
                f"{limit}/{max_iter}): {preemption.reason()}",
                site="chunk",
                partial=_snapshot_state(state, label, limit, executed, chunks),
            )
        # compact when the rung shrinks the batch; once compacted, also
        # re-gather when the active set changed (newly frozen lanes stop
        # riding along), but not when nothing converged this chunk
        rung = min(bucketer.canon(int(active_idx.size)), lanes)
        if (rung < batch_lanes or compacted) and not np.array_equal(
                active_idx, cur_ids[:cur_active]):
            idx = np.concatenate(
                [active_idx, np.full(rung - active_idx.size, active_idx[0])]).astype(np.int64)
            cur_data, cur_state = _gather_batch(data, state, idx, int(active_idx.size))
            cur_ids = idx
            compacted = True
        cur_active = int(active_idx.size)

    # the last chunk's read holds every lane's iteration count: no sync here
    max_iteration = int(iters.max(initial=0))
    solve_stats.record(SolveRecord(
        label=label, lanes=lanes, max_iteration=max_iteration, executed=executed,
        baseline=lanes * max_iteration, chunks=chunks,
        host_reads=HostReads.count - reads0))
    return result_of(state)
