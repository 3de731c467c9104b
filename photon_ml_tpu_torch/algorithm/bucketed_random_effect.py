"""Size-bucketed random-effect coordinate (port of
photon_ml_tpu/algorithm/bucketed_random_effect.py, without the mesh).

The plain :class:`RandomEffectCoordinate` pads every entity lane to the row
count of the largest entity. Real per-member data is heavy-tailed, so most
of that ``(E, M_max, D)`` stack is padding. Here entities are partitioned by
sample count into geometric buckets (caps doubling per bucket), each bucket
gets its own entity-major stack padded only to its own largest entity (and,
with a shape ladder, up the ladder), and each bucket solves as its own
lane-batched solve. The reference's analogue is the active-set cap
(RandomEffectDataSet.scala:246-307), a hard truncation; bucketing keeps
every active row.

The coordinate protocol is unchanged (a drop-in for ``CoordinateDescent``):
the state is a tuple of per-bucket ``(E_b, D_loc)`` stacks, and scores
scatter back to the global row order through each bucket's row selection.
With a sparse spec each bucket builds its own slab (``auto``: each bucket
races the families and the dense stack on its own tensors).

With a ``solve_schedule`` each bucket's solve is convergence-compacted
(optim/scheduler.py): bucketing fixes the padding waste of skewed entity
sizes, compaction the iteration waste of skewed convergence. Its chunk (or
rung) pauses and the bucket boundaries are preemption drain points: the
``Preempted`` payload carries the finished buckets' coefficients and the
paused solve, and ``update(resume=)`` continues from it bitwise. With an
``adaptive`` schedule (optim/convergence.py) every bucket's convergence
score lands in a ledger, and a bucket under tolerance for ``patience``
consecutive epochs is skipped, each skip a recorded ``PlanDecision``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    global_coefficients,
)
from photon_ml_tpu_torch.data.game import (
    GameData,
    HostFeatures,
    RandomEffectDataConfig,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.compile.plan import PlanDecision
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.convergence import ConvergenceLedger
from photon_ml_tpu_torch.optim.scheduler import solve_stats
from photon_ml_tpu_torch.resilience import faults, preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType, real_dtype

Tensor = torch.Tensor
State = Tuple[Tensor, ...]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} on the bucketed random effect is not yet ported to photon_ml_tpu_torch")


def _filter_game_data(data: GameData, re_id: str, shard: str, row_sel: np.ndarray,
                      entity_ids: np.ndarray) -> GameData:
    """Row-subset view of one shard with the bucket's entities remapped to a
    dense 0..E_b-1 id space (vectorized CSR slicing)."""
    feats = data.shards[shard]
    starts = feats.indptr[row_sel]
    ends = feats.indptr[row_sel + 1]
    lengths = (ends - starts).astype(np.int64)
    item_idx = np.repeat(starts, lengths) + (
        np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    )
    new_indptr = np.zeros(len(row_sel) + 1, np.int64)
    np.cumsum(lengths, out=new_indptr[1:])
    sub = HostFeatures(new_indptr, feats.indices[item_idx], feats.values[item_idx], feats.dim)
    # entity_ids is sorted: searchsorted gives the dense rank
    dense_ids = np.searchsorted(entity_ids, data.ids[re_id][row_sel]).astype(np.int32)
    vocab = [data.id_vocabs[re_id][e] for e in entity_ids]
    return GameData(
        response=data.response[row_sel],
        offset=data.offset[row_sel],
        weight=data.weight[row_sel],
        ids={re_id: dense_ids},
        id_vocabs={re_id: vocab},
        shards={shard: sub},
    )


def partition_entities_by_size(counts: np.ndarray, max_buckets: int = 6) -> List[np.ndarray]:
    """Entity ids grouped into geometric size buckets: bucket k holds the
    entities with count in (min*2^(k-1), min*2^k] (caps double), the tail
    merged into the last of at most ``max_buckets``."""
    present = np.nonzero(counts > 0)[0]
    if len(present) == 0:
        return []
    c = counts[present]
    lo = max(int(c.min()), 1)
    bucket_of = np.ceil(np.log2(np.maximum(c / lo, 1.0))).astype(np.int64)
    bucket_of = np.minimum(bucket_of, max_buckets - 1)
    return [
        np.sort(present[bucket_of == b])
        for b in range(int(bucket_of.max()) + 1)
        if (bucket_of == b).any()
    ]


@dataclasses.dataclass(frozen=True)
class BucketedDatasetBundle:
    """The per-bucket datasets, built once per (data, config) and shared by
    every grid combo's coordinate."""

    buckets: List[np.ndarray]  # vocab-index entity sets, one per bucket
    datasets: List[object]  # RandomEffectDataset per bucket
    row_sels: List[np.ndarray]  # bucket rows -> global row index
    dense_ids: List[np.ndarray]  # bucket rows -> dense (bucket-local) id
    num_rows: int
    vocab: List[str]
    bucketer: Optional[object] = None  # the ladder the buckets were padded up, or None

    @staticmethod
    def build(data: GameData, config: RandomEffectDataConfig, max_buckets: int = 6,
              bucketer=None, device=None) -> "BucketedDatasetBundle":
        """``bucketer`` (``compile.ShapeBucketer`` or spec; None reads
        ``PHOTON_SHAPE_LADDER``) also rounds every bucket's dims up the
        ladder with masked padding. Each bucket is built on the host, padded
        there, then moved to ``device`` (default cuda)."""
        from photon_ml_tpu_torch.compile import canonicalize_re_dataset, resolve_bucketer

        bucketer = resolve_bucketer(bucketer)
        dev = resolve_device(device)
        re_id = config.random_effect_id
        ids = data.ids[re_id]
        counts = np.bincount(ids, minlength=int(ids.max()) + 1 if len(ids) else 0)
        buckets = partition_entities_by_size(counts, max_buckets)
        datasets, row_sels, dense_ids = [], [], []
        for entity_ids in buckets:
            row_sel = np.nonzero(np.isin(ids, entity_ids))[0]
            filtered = _filter_game_data(data, re_id, config.feature_shard_id, row_sel,
                                         entity_ids)
            datasets.append(canonicalize_re_dataset(
                build_random_effect_dataset(filtered, config, device="cpu"), bucketer,
                device=dev))
            row_sels.append(row_sel)
            dense_ids.append(filtered.ids[re_id])
        return BucketedDatasetBundle(buckets=buckets, datasets=datasets, row_sels=row_sels,
                                     dense_ids=dense_ids, num_rows=data.num_rows,
                                     vocab=list(data.id_vocabs[re_id]), bucketer=bucketer)


@dataclasses.dataclass
class BucketedRandomEffectCoordinate:
    """Per-entity solves bucketed by entity size (coordinate protocol).

    ``sparse_kernel`` is each bucket's spec (None reads
    ``PHOTON_SPARSE_KERNEL``). ``solve_schedule`` (a ``SolveSchedule``)
    compacts every bucket's solve; ``adaptive`` (an ``AdaptiveSchedule``)
    skips buckets whose score stayed under its tolerance. Buckets keep
    their positional order (the resume payload's ``done.j`` prefix depends
    on it). ``mesh_ctx`` names the JAX package's mesh, which is not ported:
    setting it raises.
    """

    data: GameData
    config: RandomEffectDataConfig
    task: TaskType
    optimizer: OptimizerType = OptimizerType.LBFGS
    optimizer_config: Optional[OptimizerConfig] = None
    regularization: RegularizationContext = dataclasses.field(
        default_factory=RegularizationContext.none
    )
    max_buckets: int = 6
    bundle: Optional[BucketedDatasetBundle] = None  # prebuilt, shared
    bucketer: Optional[object] = None
    sparse_kernel: Optional[str] = None
    device: Optional[object] = None  # where a bundle built here lives
    mesh_ctx: Optional[object] = None
    solve_schedule: Optional[object] = None
    adaptive: Optional[object] = None

    def __post_init__(self):
        if self.mesh_ctx is not None:
            raise _not_ported("mesh_ctx")
        if self.bundle is None:
            self.bundle = BucketedDatasetBundle.build(
                self.data, self.config, self.max_buckets, self.bucketer, self.device)
        b = self.bundle
        self.buckets = b.buckets
        self._num_rows = b.num_rows
        self._row_sels = b.row_sels
        self._dense_ids = b.dense_ids
        self._subs: List[RandomEffectCoordinate] = [
            RandomEffectCoordinate(
                dataset=ds,
                task=self.task,
                optimizer=self.optimizer,
                optimizer_config=self.optimizer_config,
                regularization=self.regularization,
                solve_label=f"bucket{i}",
                sparse_kernel=self.sparse_kernel,
                # the buckets' ladder pads the slab width too: one setting
                bucketer=b.bucketer or "off",
                solve_schedule=self.solve_schedule,
            )
            for i, ds in enumerate(b.datasets)
        ]
        # adaptive-schedule state: the bucket-indexed ledger, the epoch
        # counter and every recorded skip decision
        self._ledger = ConvergenceLedger()
        self._epoch = 0
        self.skip_decisions: list = []
        # each bucket's row selection on its dataset's device, made once
        self._row_index = [torch.from_numpy(rs).to(sub.dataset.device)
                           for rs, sub in zip(self._row_sels, self._subs)]

    # -- exports for the driver (validation scoring, model save) -----------
    def vocab_position_maps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Original id-vocab index -> (owning bucket, position within that
        bucket's coefficient stack); -1/-1 where no model exists."""
        v = len(self.bundle.vocab)
        bucket_of = np.full(v, -1, np.int32)
        pos_in_bucket = np.full(v, -1, np.int32)
        for bi, (sub, entity_ids, dense_ids) in enumerate(
                zip(self._subs, self.buckets, self._dense_ids)):
            # ladder-padded buckets carry -1 scoring rows beyond the real ones
            entity_pos = sub.dataset.entity_pos.cpu().numpy()[: len(dense_ids)]
            known = entity_pos >= 0
            pos_of_dense = np.full(len(entity_ids), -1, np.int32)
            pos_of_dense[dense_ids[known]] = entity_pos[known]
            has = pos_of_dense >= 0
            bucket_of[entity_ids[has]] = bi
            pos_in_bucket[entity_ids[has]] = pos_of_dense[has]
        return bucket_of, pos_in_bucket

    def global_coefficient_stacks(self, state: State) -> List[Tensor]:
        """Per-bucket ``(E_b, D_global)`` back-projected coefficient stacks."""
        return [global_coefficients(sub.dataset, w) for sub, w in zip(self._subs, state)]

    def entity_export_by_raw_id(self, state: State, residual_offsets: Optional[Tensor] = None):
        """(means, variances) dicts keyed by raw entity id, global-space rows
        as numpy arrays. ``variances`` is None unless ``residual_offsets``
        (the global (N,) residual scores) is given; then it holds each
        bucket's 1/H_jj at the final coefficients, scattered to global
        space like the means."""
        host = lambda t: t.detach().cpu().numpy()
        mean_stacks = [host(s) for s in self.global_coefficient_stacks(state)]
        var_stacks = None
        if residual_offsets is not None:
            var_stacks = []
            for sub, rows, w in zip(self._subs, self._row_index, state):
                if sub.dataset.projection_matrix is not None:
                    # a diagonal variance does not survive a dense random
                    # back-projection
                    raise ValueError("per-entity variances are not defined in global space "
                                     "for RANDOM-projected datasets")
                var = sub.coefficient_variances(w, residual_offsets[rows])
                var_stacks.append(host(global_coefficients(sub.dataset, var)))
        bucket_of, pos_in_bucket = self.vocab_position_maps()
        means, variances = {}, ({} if var_stacks is not None else None)
        for vi, raw in enumerate(self.bundle.vocab):
            b = bucket_of[vi]
            if b >= 0:
                means[raw] = mean_stacks[b][pos_in_bucket[vi]]
                if variances is not None:
                    variances[raw] = var_stacks[b][pos_in_bucket[vi]]
        return means, variances

    def stack_sizes(self) -> List[int]:
        """Entity count per coefficient stack, in stack order (the offsets a
        gather over the concatenated stacks needs)."""
        return [s.num_entities for s in self._subs]

    @property
    def num_entities(self) -> int:
        return sum(s.num_entities for s in self._subs)

    def padded_elements(self) -> int:
        """Elements of the per-bucket ``(E_b, M_b, D_b)`` stacks: what
        bucketing shrinks against one ``(E, M_max, D_max)`` stack."""
        return sum(s.dataset.x.numel() for s in self._subs)

    # -- coordinate protocol ------------------------------------------------
    def initial_coefficients(self) -> State:
        return tuple(s.initial_coefficients() for s in self._subs)

    def _bucket_shapes(self) -> List[List[int]]:
        """Per-bucket coefficient-stack shapes (ladder padding included)."""
        return [[int(s.num_entities), int(s.local_dim)] for s in self._subs]

    def _partial_payload(self, finished: List[Tensor], bucket: int,
                         inner: Optional[dict] = None) -> dict:
        """Preemption ``partial`` payload: the finished buckets'
        coefficients, and for a drain inside bucket ``bucket`` its
        scheduler snapshot nested under ``inner.`` keys."""
        meta = {"kind": "bucketed_re", "bucket": bucket, "shapes": self._bucket_shapes(),
                "inner": inner["meta"] if inner is not None else None}
        arrays = {f"done.{j}": w.detach().cpu().numpy() for j, w in enumerate(finished)}
        if inner is not None:
            arrays.update({f"inner.{k}": v for k, v in inner["arrays"].items()})
        return {"meta": meta, "arrays": arrays}

    # -- adaptive-schedule plumbing (optim/convergence.py) -------------------
    def _host_driven(self) -> bool:
        return self.solve_schedule is not None or self.adaptive is not None

    def _record_bucket_result(self, bi: int, res) -> None:
        if not self._host_driven():
            return
        score = float(torch.max(res.grad_norm)) if res.grad_norm.numel() else 0.0
        executed = int(torch.sum(res.iterations))
        under = self.adaptive is not None and score < self.adaptive.tolerance
        self._ledger.observe(bi, score, executed=executed, epoch=self._epoch,
                             under_tolerance=under)
        solve_stats.record_block(f"bucket{bi}", score=score, executed=executed)

    def _record_bucket_skip(self, bi: int) -> None:
        self._ledger.record_skip(bi, epoch=self._epoch)
        solve_stats.record_block(f"bucket{bi}", skipped=True)
        self.skip_decisions.append(PlanDecision(
            "adaptive", "skipped",
            f"bucket {bi} scored under tolerance "
            f"{self.adaptive.tolerance:g} for >= {self.adaptive.patience} "
            f"consecutive epochs; epoch {self._epoch} carries its "
            "coefficients forward",
        ))

    def _adaptive_skips(self, n_buckets: int, start_bucket: int) -> set:
        """The buckets this epoch skips. The ``optim.block_skip`` fault
        site guards the decision: an injected fault degrades the epoch to
        visit-everything with a recorded decision, never a silent skip."""
        if self.adaptive is None:
            return set()
        candidates = {bi for bi in range(start_bucket, n_buckets)
                      if self._ledger.should_skip(bi, self.adaptive)}
        if candidates:
            try:
                faults.inject("optim.block_skip", epoch=self._epoch, buckets=len(candidates))
            except Exception as e:  # noqa: BLE001 — an injected fault makes the skip decision untrusted; visiting everything is the safe degrade
                self.skip_decisions.append(PlanDecision(
                    "adaptive", "pinned",
                    f"bucket-skip fault at epoch {self._epoch} "
                    f"({type(e).__name__}: {e}); degraded to "
                    "visit-everything for this epoch",
                ))
                return set()
        return candidates

    def ledger_export(self) -> dict:
        """JSON-safe ledger entries ({bucket: entry}) for retrain.json."""
        return self._ledger.to_json()

    def _resume_point(self, resume: dict, device) -> Tuple[int, List[Tensor], Optional[dict]]:
        """(bucket to start at, finished buckets' coefficients, the paused
        solve's snapshot or None) of a ``bucketed_re`` payload."""
        m = resume.get("meta") or {}
        if m.get("kind") != "bucketed_re":
            raise ValueError(f"resume payload kind {m.get('kind')!r} is not a "
                             "bucketed-RE progress snapshot")
        shapes = self._bucket_shapes()
        saved = [list(map(int, x)) for x in (m.get("shapes") or [])]
        if saved != shapes:
            raise ValueError(
                "bucketed resume snapshot does not match this coordinate's buckets "
                f"({saved[:3]}... vs {shapes[:3]}...) — the buckets were rebuilt "
                "differently since the emergency checkpoint; refusing to resume")
        start = int(m["bucket"])
        arrays = resume.get("arrays") or {}
        done = [torch.from_numpy(np.array(arrays[f"done.{j}"])).to(device)
                for j in range(start)]
        inner = None
        if m.get("inner") is not None:
            inner = {"meta": m["inner"],
                     "arrays": {k[len("inner."):]: v for k, v in arrays.items()
                                if k.startswith("inner.")}}
        return start, done, inner

    def update(self, residual_offsets: Tensor, state: State,
               reg_weight: Optional[float] = None, resume: Optional[dict] = None):
        """Each bucket gathers its rows' residuals and solves on its own
        (buckets are disjoint entity sets). Returns the new state and the
        per-bucket OptResults (None for a bucket skipped or finished before
        a resume). ``reg_weight`` overrides every bucket's total
        regularization weight (``CoordinateDescent.run_grid``).

        On the scheduled path the bucket boundaries (site ``"bucket"``) and
        every solve's chunk or rung boundaries are preemption drain points:
        ``Preempted`` carries the finished buckets' coefficients (and the
        paused solve); passing that payload back as ``resume`` continues
        from the interrupted bucket, bitwise as an uninterrupted update."""
        start, new_state, inner = 0, [], None
        if resume is not None:
            start, new_state, inner = self._resume_point(resume, residual_offsets.device)
        else:
            self._epoch += 1
        skips = self._adaptive_skips(len(self._subs), start)
        results: List[object] = [None] * start
        for bi, (sub, rows, w0) in enumerate(zip(self._subs, self._row_index, state)):
            if bi < start:
                continue
            if bi in skips:
                # coefficients carry forward unchanged; recorded, never silent
                self._record_bucket_skip(bi)
                new_state.append(w0)
                results.append(None)
                continue
            kw = {} if reg_weight is None else {"reg_weight": reg_weight}
            try:
                coefs, res = sub.update(residual_offsets[rows], w0,
                                        resume=inner if bi == start else None, **kw)
            except preemption.Preempted as e:
                # inside bucket bi: wrap the solve's snapshot with the
                # buckets finished so far and unwind
                raise preemption.Preempted(
                    str(e), site=e.site,
                    partial=self._partial_payload(new_state, bi, e.partial)) from e
            new_state.append(coefs)
            results.append(res)
            self._record_bucket_result(bi, res)
            if (self.solve_schedule is not None and bi + 1 < len(self._subs)
                    and preemption.check("bucket", bucket=bi)):
                raise preemption.Preempted(
                    f"preempted at bucket boundary (bucket {bi + 1}/{len(self._subs)}): "
                    f"{preemption.reason()}",
                    site="bucket", partial=self._partial_payload(new_state, bi + 1))
        return tuple(new_state), tuple(results)

    def score(self, state: State) -> Tensor:
        device = self._row_index[0].device if self._row_index else None
        total = torch.zeros((self._num_rows,), dtype=real_dtype(), device=device)
        for sub, rows, w in zip(self._subs, self._row_index, state):
            # ladder-padded buckets score their pad rows too (0); slice them off
            total[rows] = sub.score(w)[: rows.numel()]
        return total

    def regularization_term(self, state: State, reg_weight: Optional[float] = None) -> Tensor:
        device = self._row_index[0].device if self._row_index else None
        total = torch.zeros((), dtype=real_dtype(), device=device)
        for sub, w in zip(self._subs, state):
            total = total + sub.regularization_term(w, reg_weight)
        return total
