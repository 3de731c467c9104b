"""The device rung loop: chunk→compact→resume with O(#rungs) host reads
(port of photon_ml_tpu/optim/fused_schedule.py).

The host chunk loop (optim/scheduler.py) reads the lane flags back after
every chunk, and its solvers test convergence on the host every iteration
and every line-search or CG step. The JAX package fuses the whole cycle
into one XLA program per ladder rung. The port's counterpart is a **CUDA
graph per rung width**, captured once per (coordinate, rung width, dtype)
and replayed:

  * static buffers hold the full entity-order solver state, the problem
    data's tensors (the coordinate's own; the residual offsets are copied
    into a static buffer per update) and the loop's scalars (iteration
    limit, horizon, exit target, executed lane-iterations, chunk count);
  * one chunk of the rung program is three graphs: **gather** (a stable
    sort of the converged flags puts the active lanes first in ascending
    entity order, the host loop's ``np.nonzero`` order; a ``[:R]`` slice
    gathers their data, a slab's as ids for the kernels' lane-indirect
    launch, and their state into the width's static buffers), **step**
    (one ``advance(..., trips=1)`` iteration with fixed trip counts, every
    masked step exact and no host test; replayed ``chunk`` times) and
    **scatter** (the lanes back in entity order through the inverse
    permutation, and the ledger). Splitting the chunk keeps a capture to
    one iteration's operations;
  * a chunk is gated on the device: while the active count is above the
    next rung down and the limit below the horizon it advances; otherwise
    the limit stays put and the whole chunk is an exact identity. So the
    host replays a rung's chunk several times between reads (1, 2, 4, ...
    up to the chunks the horizon allows) and reads the four scalars once
    per round: O(#rungs x log(chunks)) reads a solve.

A kernel wrapper counts the launches it issues: the warm-up's, eagerly,
and the capture's, into the graph. A replay launches the graph's kernels
without the wrappers, so their counts do not move; chip_smoke.py phase 21
(a) counts the replayed kernels from a torch.profiler trace.

This loop is not the path the drivers document: every masked line-search
and CG step of a fixed-trip chunk runs, so a chunk launches several times
the kernels of the host loop's, and on the bucketed driver the captures
are not yet amortized (ROADMAP). The host loop is the documented path.

Every lane's arithmetic is batch-independent (optim/scheduler.py), so the
device loop is bitwise the host loop and the one-shot solve. On the CPU the
same rung loop runs its programs eagerly; that is how the tests hold it.

Preemption keeps a boundary per rung hop (site ``"rung"``): with a request
pending, a rung runs to one more chunk at most, then ``Preempted`` carries
the host loop's ``kind="scheduler"`` snapshot, which resumes on either
loop, bitwise.

**No fallback hides this loop.** The JAX package degrades any failure of
its fused path to the host loop. Here only the injected
``optim.device_drain`` fault does (optim/scheduler.py); a capture, replay
or kernel error raises. The plain slab families (``scatter``,
``segment``, ``flat``) run too: a rung's gathered lanes are a ``SlabLanes``
view carrying the rung's inverse permutation, so their transpose runs on
the full slab through its one ``FlatOrderPlan``, built before the first
capture (a plan built per gathered slab would read sizes back to the host
inside the graph), bitwise the gathered slab's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from photon_ml_tpu_torch.compile.stats import instrumented_capture
from photon_ml_tpu_torch.ops.fused_sparse import FlatOrderPlan, SlabLanes, SparseSlab
from photon_ml_tpu_torch.optim.common import HostReads, OptResult
from photon_ml_tpu_torch.resilience import preemption

Tensor = torch.Tensor

__all__ = ["device_solve", "rung_ladder", "next_lower_rung"]

SITE = "scheduler.rung"


def rung_ladder(bucketer, lanes: int) -> List[int]:
    """The descending dispatch widths a ``lanes``-wide solve can visit:
    the full width first, then every ladder rung strictly below it."""
    rungs = []
    size = bucketer.base
    while size < lanes:
        rungs.append(size)
        size = max(int(math.ceil(size * bucketer.growth)), size + 1)
    return [lanes] + rungs[::-1]


def next_lower_rung(bucketer, rung: int) -> int:
    """The largest ladder value strictly below ``rung`` (0 below the base):
    the active count at which a rung hands the solve to the next width."""
    if rung <= bucketer.base:
        return 0
    prev = 0
    size = bucketer.base
    while size < rung:
        prev = size
        size = max(int(math.ceil(size * bucketer.growth)), size + 1)
    return prev


def _prepare_device_family(feats) -> None:
    """A plain slab family's transpose on the card is the full slab's
    ``FlatOrderPlan``: build it now, outside any capture (its build reads
    sizes back to the host)."""
    if (isinstance(feats, SparseSlab) and feats.idx.is_cuda
            and not feats.kernel.startswith("pallas") and feats._flat is None):
        feats._flat = FlatOrderPlan.build(feats.idx, feats.val, feats.dim)


class _Rung:
    """The static buffers of one rung width: the gathered lanes' ids, the
    inverse permutation, their problem data and their solver state."""

    def __init__(self, loop: "_RungLoop", rung: int):
        dev = loop.lim.device
        self.width = rung
        self.idx = torch.zeros((rung,), dtype=torch.int64, device=dev)
        self.inv = torch.zeros((loop.lanes,), dtype=torch.int64, device=dev)
        if isinstance(loop.feats, SparseSlab):
            self.ids = torch.zeros((rung,), dtype=torch.int32, device=dev)
            feats = SlabLanes(loop.feats, self.ids, self.inv)
        else:
            feats = loop.feats.new_zeros((rung,) + tuple(loop.feats.shape[1:]))
        rows = lambda t: t.new_zeros((rung,) + tuple(t.shape[1:]))
        self.data = (feats, rows(loop.y), rows(loop.off), rows(loop.wt))
        self.part = {n: rows(t) for n, t in loop.state.items()}


class _RungLoop:
    """One solve problem's static buffers and its rung programs. A chunk at
    width R is three programs on the static buffers: gather (the gate, the
    stable sort of the converged flags, the lanes' data and state), one
    fixed-trip iteration (run ``chunk`` times) and scatter (the lanes back
    in entity order, the ledger). On the card each is a captured CUDA graph
    (one capture per width, the iteration's graph replayed ``chunk`` times
    a chunk); on the CPU the same functions run eagerly."""

    def __init__(self, data, init_state, advance: Callable, chunk: int):
        feats, y, off, wt = data
        self.feats, self.y, self.wt = feats, y, wt
        self.off = off.clone()
        self.advance = advance
        self.chunk = chunk
        self.names = [f.name for f in dataclasses.fields(init_state)
                      if getattr(init_state, f.name) is not None]
        self.template = init_state
        self.state = {n: getattr(init_state, n).clone() for n in self.names}
        self.lanes = init_state.w.shape[0]
        dev = init_state.w.device
        scalar = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        self.lim, self.new_lim, self.horizon, self.target, self.executed, self.dchunks = (
            scalar() for _ in range(6))
        self.cuda = dev.type == "cuda"
        self.rungs: dict = {}  # width -> _Rung
        self.graphs: dict = {}  # (key, width) -> the width's three graphs
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    def matches(self, data) -> bool:
        feats, y, _, wt = data
        return feats is self.feats and y is self.y and wt is self.wt

    def load(self, off: Tensor, state) -> None:
        """A new solve: its offsets and initial state into the buffers."""
        self.off.copy_(off)
        for n in self.names:
            self.state[n].copy_(getattr(state, n))

    def current(self):
        return dataclasses.replace(self.template, **self.state)

    def _rung(self, width: int) -> _Rung:
        if width not in self.rungs:
            self.rungs[width] = _Rung(self, width)
        return self.rungs[width]

    def _gather(self, r: _Rung) -> None:
        """The gate, and the active lanes first (ascending entity order,
        the host loop's ``np.nonzero`` order) gathered at width R."""
        st = self.state
        order = torch.sort((st["reason"] != 0).to(torch.int32), stable=True)[1]
        r.idx.copy_(order[: r.width])
        r.inv.copy_(torch.sort(order)[1])  # the inverse permutation
        n_active = torch.sum((st["reason"] == 0).to(torch.int64))
        go = (n_active > self.target) & (self.lim < self.horizon)
        self.new_lim.copy_(torch.where(
            go, torch.minimum(self.lim + self.chunk, self.horizon), self.lim))
        self.dchunks.add_(go.to(torch.int64))
        feats, y, off, wt = r.data
        if isinstance(feats, SlabLanes):
            r.ids.copy_(r.idx)
        else:
            feats.copy_(self.feats.index_select(0, r.idx))
        for buf, full in ((y, self.y), (off, self.off), (wt, self.wt)):
            buf.copy_(full.index_select(0, r.idx))
        for n in self.names:
            r.part[n].copy_(st[n].index_select(0, r.idx))

    def _step(self, r: _Rung) -> None:
        """One fixed-trip iteration of the gathered lanes toward the new
        limit (an exact identity when the gate is closed)."""
        new = self.advance(*r.data, dataclasses.replace(self.template, **r.part),
                           self.new_lim, trips=1)
        for n in self.names:
            r.part[n].copy_(getattr(new, n))

    def _scatter(self, r: _Rung) -> None:
        """The gathered lanes back in entity order (``idx`` holds R
        distinct lanes; converged fillers advanced as the identity), and
        the chunk's ledger."""
        back = r.inv < r.width
        src = torch.clamp(r.inv, max=r.width - 1)
        for n in self.names:
            new = r.part[n].index_select(0, src)
            mask = back.reshape(back.shape + (1,) * (new.dim() - 1))
            self.state[n].copy_(torch.where(mask, new, self.state[n]))
        advanced = torch.clamp_min(
            torch.minimum(torch.max(r.part["iteration"]), self.new_lim) - self.lim, 0)
        self.executed.add_(advanced * r.width)
        self.lim.copy_(self.new_lim)

    def _programs(self, r: _Rung):
        return (lambda: self._gather(r), lambda: self._step(r), lambda: self._scatter(r))

    def _capture(self, r: _Rung):
        """Warm the three programs up eagerly with the gate closed (an
        identity that makes every launch plan and kernel attribute; a sync
        in them raises here), then capture each."""
        HostReads.count += 1
        saved = torch.stack([self.horizon, self.lim, self.dchunks]).tolist()
        self.horizon.copy_(self.lim)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(stream):
            torch.cuda.set_sync_debug_mode("error")
            try:
                for program in self._programs(r):
                    program()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(stream)
        graphs = []
        for program in self._programs(r):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                program()
            graphs.append(graph)
        self.horizon.fill_(saved[0])
        self.lim.fill_(saved[1])
        self.dchunks.fill_(saved[2])
        return graphs

    def _replay(self, graphs) -> None:
        gather, step, scatter = graphs
        gather.replay()
        for _ in range(self.chunk):
            step.replay()
        scatter.replay()

    def eager_chunk(self, rung: int) -> None:
        """One chunk of the rung program, run eagerly."""
        gather, step, scatter = self._programs(self._rung(rung))
        gather()
        for _ in range(self.chunk):
            step()
        scatter()

    def run(self, rung: int, key) -> None:
        """One chunk of the rung program: replayed from its graphs on the
        card (captured on first use), eagerly on the CPU."""
        if not self.cuda:
            self.eager_chunk(rung)
            return
        r = self._rung(rung)
        instrumented_capture(SITE, (key, rung), self.graphs, lambda: self._capture(r),
                             self._replay)


def _loop_for(graphs: Optional[dict], key, data, init_state, advance, chunk) -> _RungLoop:
    """The rung loop of this problem: the caller's cached one when its
    tensors are the same, else a new one (kept in ``graphs`` when given)."""
    loop = graphs.get(key) if graphs is not None else None
    if loop is None or not loop.matches(data):
        loop = _RungLoop(data, init_state, advance, chunk)
        if graphs is not None:
            graphs[key] = loop
    loop.load(data[2], init_state)
    return loop


def device_solve(data, w0: Tensor, *, task, optimizer, optimizer_config, regularization,
                 schedule, label: str = "re_solve", resume: Optional[dict] = None,
                 reg_weight=None, graphs: Optional[dict] = None) -> OptResult:
    """Solve every lane of ``data`` with the rung loop; bitwise the host
    chunk loop (``scheduler.compacted_solve``) and the one-shot solve.
    Telemetry lands in ``scheduler.solve_stats``: one ``ChunkRecord`` per
    rung hop, the chunks run inside the rung programs on
    ``device_chunks``, the counted host reads on ``host_reads``. ``graphs``, a
    dict the caller keeps (a coordinate: one per coordinate), caches the
    captured rung programs across solves of the same tensors."""
    from photon_ml_tpu_torch.optim.scheduler import (
        ChunkRecord,
        SolveRecord,
        _lane_fns,
        _restore_state,
        _snapshot_state,
        solve_stats,
    )

    _prepare_device_family(data[0])
    reads0 = HostReads.count
    cfg = dict(task=task, optimizer=optimizer, optimizer_config=optimizer_config,
               regularization=regularization)
    lanes = int(w0.shape[0])
    max_iter = optimizer_config.max_iterations
    chunk = schedule.chunk_size
    bucketer = schedule.bucketer

    _, init, advance, result_of = _lane_fns(**cfg, reg_weight=reg_weight)
    state = init(*data, w0)
    chunks: List[ChunkRecord] = []
    executed = 0
    device_chunks = 0
    limit = 0
    active = lanes
    if resume is not None:
        # the host loop's kind="scheduler" snapshot: a preempted solve
        # resumes on either loop, bitwise
        state = _restore_state(state, resume)
        limit = int(resume["meta"]["limit"])
        executed = int(resume["meta"]["executed"])
        chunks = [ChunkRecord(**c) for c in resume["meta"]["chunks"]]
        HostReads.count += 1
        active = int((state.reason == 0).sum())
    key = (task, optimizer, optimizer_config, regularization, reg_weight, lanes,
           tuple(w0.shape), w0.dtype, chunk)
    loop = _loop_for(graphs, key, data, state, advance, chunk)

    while active > 0 and limit < max_iter:
        rung = min(bucketer.canon(active), lanes)
        target = next_lower_rung(bucketer, rung)
        # with a preemption pending, the rung runs one more chunk at most so
        # that its boundary comes promptly
        horizon = min(limit + chunk, max_iter) if preemption.requested() else max_iter
        loop.lim.fill_(limit)
        loop.horizon.fill_(horizon)
        loop.target.fill_(target)
        loop.executed.zero_()
        loop.dchunks.zero_()
        room = -(-(horizon - limit) // chunk)
        replays, burst = 0, 1
        while True:
            for _ in range(min(burst, room - replays)):
                loop.run(rung, key)
            replays += min(burst, room - replays)
            # the only read of a round: four scalars (the state stays put)
            HostReads.count += 1
            new_limit, exec_d, dch_d, act_d = torch.stack([
                loop.lim, loop.executed, loop.dchunks,
                torch.sum((loop.state["reason"] == 0).to(torch.int64))]).tolist()
            if act_d <= target or new_limit >= horizon or replays >= room:
                break
            burst *= 2
        chunks.append(ChunkRecord(chunk=len(chunks), batch_lanes=rung, active_lanes=active,
                                  limit=new_limit, advanced=new_limit - limit))
        executed += exec_d
        device_chunks += dch_d
        limit = new_limit
        active = act_d
        if active == 0 or limit >= max_iter:
            break
        if preemption.check("rung", label=label, limit=limit):
            raise preemption.Preempted(
                f"preempted at rung boundary ({label}, iteration limit "
                f"{limit}/{max_iter}): {preemption.reason()}",
                site="rung",
                partial=_snapshot_state(loop.current(), label, limit, executed, chunks),
            )

    final = dataclasses.replace(loop.template, **{n: t.clone() for n, t in loop.state.items()})
    HostReads.count += 1
    max_iteration = int(final.iteration.max()) if lanes else 0
    solve_stats.record(SolveRecord(
        label=label, lanes=lanes, max_iteration=max_iteration, executed=executed,
        baseline=lanes * max_iteration, chunks=chunks, device_chunks=device_chunks,
        host_reads=HostReads.count - reads0))
    return result_of(final)
