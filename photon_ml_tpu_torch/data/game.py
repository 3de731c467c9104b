"""GAME data layer: host-side columnar data and entity-major tensors on a
device (port of photon_ml_tpu/data/game.py for the INDEX_MAP, IDENTITY and
RANDOM projections).

  * ``GameData``: the columnar dataset in one global row order (responses,
    offsets, weights, dense entity ids per id type, one CSR matrix per
    feature shard), built on the host with numpy.
  * ``RandomEffectDataset``: the per-entity training rows as padded
    ``(E, M, D_loc)`` tensors (entities are lanes of one solve), plus the
    scoring tensors in global row order. Grouping, the active/passive split
    and the local projection are host-side numpy, identical to the JAX
    build; the tensors then move to the device. A RANDOM projection makes
    the local space the k-dimensional image of one shared Gaussian matrix
    (projectors.py), so its stack is dense in every slot.

Pearson feature selection and the tensor cache are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.projectors import build_projector
from photon_ml_tpu_torch.types import ProjectorType, real_dtype

Tensor = torch.Tensor


def _np_real():
    return np.float64 if real_dtype() == torch.float64 else np.float32


@dataclasses.dataclass
class HostFeatures:
    """CSR features for one feature shard (host)."""

    indptr: np.ndarray  # (N+1,) int64
    indices: np.ndarray  # (nnz,) int32
    values: np.ndarray  # (nnz,) float32
    dim: int

    @property
    def num_rows(self) -> int:
        return len(self.indptr) - 1


@dataclasses.dataclass
class GameData:
    """Columnar GAME dataset in one global row order (host).

    ``ids[id_type]`` holds dense entity indices (mapped from raw id strings
    via ``id_vocabs[id_type]``; -1 for an id unseen in a given vocabulary).
    """

    response: np.ndarray  # (N,)
    offset: np.ndarray  # (N,)
    weight: np.ndarray  # (N,)
    ids: Dict[str, np.ndarray]  # id_type -> (N,) int32 dense entity index
    id_vocabs: Dict[str, List[str]]  # id_type -> raw id per dense index
    shards: Dict[str, HostFeatures]  # feature shard id -> CSR

    @property
    def num_rows(self) -> int:
        return len(self.response)


def balanced_entity_order(active_counts: np.ndarray, num_shards: int) -> np.ndarray:
    """Entity indices in tensor-layout order: sorted by active-sample count
    descending, then stride-interleaved over ``num_shards`` equal slices
    (RandomEffectIdPartitioner.scala:64-97 analogue); short slices are
    padded with -1."""
    by_size = np.argsort(-active_counts, kind="stable")
    per_shard: List[List[int]] = [[] for _ in range(num_shards)]
    for pos, ent in enumerate(by_size):
        per_shard[pos % num_shards].append(int(ent))
    cap = max(len(p) for p in per_shard)
    order = []
    for p in per_shard:
        order.extend(p + [-1] * (cap - len(p)))
    return np.asarray(order, np.int64)


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """Parity with data/RandomEffectDataConfiguration.scala:42-130."""

    random_effect_id: str  # id type to group by (e.g. "userId")
    feature_shard_id: str
    num_shards: int = 1  # equal slices of the entity axis
    active_upper_bound: Optional[int] = None  # max active samples per entity
    passive_lower_bound: Optional[int] = None  # min passive rows to keep an entity's passive set
    features_to_samples_ratio: Optional[float] = None  # Pearson selection cap
    projector: str = "INDEX_MAP"  # INDEX_MAP | IDENTITY | RANDOM
    random_projection_dim: Optional[int] = None
    # whether the shard's last column is an intercept the RANDOM projection
    # passes through untouched (ProjectionMatrix.scala isKeepingInterceptTerm)
    random_projection_intercept: bool = True
    seed: int = 7


@dataclasses.dataclass
class RandomEffectDataset:
    """Entity-major random-effect training and scoring tensors on a device.

    Training (active) tensors, entity-major:
      row_index   (E, M) int32 — global row of each active sample (-1 pad)
      x           (E, M, D_loc) — locally projected dense features
      labels, base_offsets, weights (E, M) (weight 0 = pad)
    Scoring tensors, global row order (active and passive rows):
      entity_pos  (N,) int32 — the row's entity position (-1 none)
      feat_idx    (N, K) int32 — local feature indices (-1 masked)
      feat_val    (N, K)
    Projection bookkeeping:
      local_to_global (E, D_loc) int32 — global column per local column (-1 pad)
      projection_matrix (k, D_global) — the shared RANDOM-projection matrix,
        None for INDEX_MAP/IDENTITY; it back-projects coefficients
    """

    row_index: Tensor
    x: Tensor
    labels: Tensor
    base_offsets: Tensor
    weights: Tensor
    entity_pos: Tensor
    feat_idx: Tensor
    feat_val: Tensor
    local_to_global: Tensor
    num_entities: int
    global_dim: int
    projection_matrix: Optional[Tensor] = None

    TENSOR_FIELDS = ("row_index", "x", "labels", "base_offsets", "weights",
                     "entity_pos", "feat_idx", "feat_val", "local_to_global")

    @property
    def num_rows(self) -> int:
        return self.entity_pos.shape[0]

    @property
    def local_dim(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device


def build_random_effect_dataset(data: GameData, config: RandomEffectDataConfig,
                                device=None, projector=None) -> RandomEffectDataset:
    """Host-side build — group by entity, cap the active set, project to
    each entity's local space, pad — then the tensors move to ``device``
    (default cuda). Arrays are byte-equal to the JAX build's.

    ``projector`` (a ProjectionMatrixProjector) is consulted only for
    ``config.projector == "RANDOM"``; omitted, one is built from
    ``config.random_projection_dim`` and ``config.seed``."""
    if config.projector not in ("INDEX_MAP", "IDENTITY", "RANDOM"):
        raise ValueError(f"unknown random-effect projector {config.projector!r}")
    if config.features_to_samples_ratio is not None:
        raise ValueError(
            "random-effect features-to-samples ratio (Pearson feature selection) "
            "is not yet ported to photon_ml_tpu_torch"
        )
    dev = resolve_device(device)
    real = _np_real()
    ids = data.ids[config.random_effect_id]
    feats = data.shards[config.feature_shard_id]
    n = data.num_rows
    num_entities_raw = int(ids.max()) + 1 if n else 0
    rng = np.random.default_rng(config.seed)

    # ---- active/passive split (reservoir-cap semantics) -------------------
    counts = np.bincount(ids, minlength=num_entities_raw)
    cap = config.active_upper_bound or (int(counts.max()) if n else 1)
    # a random priority per row; each entity keeps its ``cap`` smallest
    priority = rng.random(n)
    order = np.lexsort((priority, ids))
    sorted_ids = ids[order]
    group_start = np.searchsorted(sorted_ids, np.arange(num_entities_raw), side="left")
    rank = np.arange(n) - group_start[sorted_ids]
    active_mask = np.zeros(n, bool)
    active_mask[order] = rank < cap
    # kept weights are re-scaled so the active set represents the whole
    # entity (RandomEffectDataSet.scala:298-301)
    active_counts = np.minimum(counts, cap)
    scale = np.ones(num_entities_raw)
    over = counts > cap
    scale[over] = counts[over] / cap

    projection_matrix = None
    if config.projector == "RANDOM":
        d_loc, local_to_global, project_rows, projection_matrix = _random_projection(
            config, feats, num_entities_raw, projector, real)
    else:
        d_loc, local_to_global, project_rows = _local_index_maps(
            config, ids, feats, n, num_entities_raw, active_mask, real)

    # ---- entity-major training tensors ------------------------------------
    entity_order = balanced_entity_order(active_counts, config.num_shards)
    e_padded = len(entity_order)
    m = max(min(int(active_counts.max()) if n else 1, cap), 1)
    row_index = np.full((e_padded, m), -1, np.int32)
    tensor_pos = np.full(num_entities_raw + 1, -1, np.int32)
    valid_ents = entity_order >= 0
    tensor_pos[entity_order[valid_ents]] = np.nonzero(valid_ents)[0].astype(np.int32)

    act_rows = np.nonzero(active_mask)[0]
    act_ids = ids[act_rows]
    o2 = np.lexsort((act_rows, act_ids))
    act_rows_s = act_rows[o2]
    act_ids_s = act_ids[o2]
    astart = np.searchsorted(act_ids_s, np.arange(num_entities_raw), side="left")
    arank = np.arange(len(act_rows_s)) - astart[act_ids_s]
    row_index[tensor_pos[act_ids_s], arank] = act_rows_s.astype(np.int32)

    flat_sel = row_index.reshape(-1)
    valid_slot = flat_sel >= 0
    sel_rows = flat_sel[valid_slot].astype(np.int64)
    pidx, pval = project_rows(sel_rows)
    x = np.zeros((e_padded * m, d_loc), real)
    rr = np.repeat(np.arange(len(sel_rows)), pidx.shape[1])
    cc = pidx.reshape(-1)
    vv = pval.reshape(-1)
    ok = cc >= 0
    x[np.nonzero(valid_slot)[0][rr[ok]], cc[ok]] = vv[ok]
    x = x.reshape(e_padded, m, d_loc)

    def scatter_col(src):
        out = np.zeros((e_padded, m), real)
        out.reshape(-1)[valid_slot] = src[sel_rows]
        return out

    labels_t = scatter_col(data.response)
    offsets_t = scatter_col(data.offset)
    weights_t = scatter_col(data.weight)
    weights_t.reshape(-1)[valid_slot] *= scale[ids[sel_rows]].astype(real)

    # ---- scoring tensors (all rows) ---------------------------------------
    entity_pos_all = tensor_pos[ids].astype(np.int32)
    if config.passive_lower_bound is not None:
        # passive rows survive only for entities with more than the bound
        # (RandomEffectDataSet.generatePassiveData:344-351)
        passive_mask = ~active_mask
        passive_counts = np.bincount(ids[passive_mask], minlength=num_entities_raw)
        keep_entity = passive_counts > config.passive_lower_bound
        entity_pos_all[passive_mask & ~keep_entity[ids]] = -1
    sc_idx, sc_val = project_rows(np.arange(n, dtype=np.int64))

    # local_to_global is indexed by raw entity id; the tensors are laid out
    # in balanced (tensor-position) order
    l2g_tensor = np.full((e_padded, d_loc), -1, np.int32)
    l2g_tensor[np.nonzero(valid_ents)[0]] = local_to_global[entity_order[valid_ents]]

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return RandomEffectDataset(
        row_index=put(row_index), x=put(x), labels=put(labels_t),
        base_offsets=put(offsets_t), weights=put(weights_t),
        entity_pos=put(entity_pos_all), feat_idx=put(sc_idx), feat_val=put(sc_val),
        local_to_global=put(l2g_tensor), num_entities=e_padded, global_dim=feats.dim,
        projection_matrix=None if projection_matrix is None else projection_matrix.to(dev),
    )


def _random_projection(config, feats, num_entities_raw, projector, real):
    """The RANDOM local space: every entity shares one dense (k, d) matrix
    (projector/ProjectionMatrixBroadcast.scala:30-96), applied on the host
    to the CSR rows; no local column maps to a global one."""
    if projector is None:
        projector = build_projector(
            ProjectorType.RANDOM, feats.dim, config.random_projection_dim,
            keep_intercept=config.random_projection_intercept, seed=config.seed,
        )
    d_loc = projector.projected_dim
    local_to_global = np.full((num_entities_raw, d_loc), -1, np.int32)

    def project_rows(row_sel: np.ndarray):
        starts = feats.indptr[row_sel]
        ends = feats.indptr[row_sel + 1]
        lens = (ends - starts).astype(np.int64)
        flat_ptr = (np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
                    if len(row_sel) else np.zeros(0, np.int64))
        row_splits = np.concatenate([[0], np.cumsum(lens)])
        dense = projector.project_sparse_features(
            feats.indices[flat_ptr].astype(np.int64), feats.values[flat_ptr], row_splits)
        out_idx = np.tile(np.arange(d_loc, dtype=np.int32), (len(row_sel), 1))
        return out_idx, dense.astype(real)

    return d_loc, local_to_global, project_rows, projector.matrix


def _local_index_maps(config, ids, feats, n, num_entities_raw, active_mask, real):
    """The INDEX_MAP local space (each entity's features seen in its active
    rows, in ascending global order) or the IDENTITY one (every column):
    (D_loc, local_to_global by raw entity, project_rows)."""
    rows_nnz = np.repeat(np.arange(n), np.diff(feats.indptr))
    keep = active_mask[rows_nnz]
    pair_key = ids[rows_nnz[keep]].astype(np.int64) * feats.dim + feats.indices[keep].astype(np.int64)
    uniq = np.unique(pair_key)
    pair_e = (uniq // feats.dim).astype(np.int64)
    pair_f = (uniq % feats.dim).astype(np.int64)
    if config.projector == "IDENTITY":
        d_loc = feats.dim
        local_to_global = np.tile(np.arange(feats.dim, dtype=np.int32), (num_entities_raw, 1))
        pair_lookup = None
    else:  # INDEX_MAP: local order = ascending global column per entity
        o = np.lexsort((pair_f, pair_e))
        pair_e, pair_f = pair_e[o], pair_f[o]
        ent_start = np.searchsorted(pair_e, np.arange(num_entities_raw), side="left")
        local_idx = np.arange(len(pair_e)) - ent_start[pair_e]
        per_entity_dims = np.bincount(pair_e, minlength=num_entities_raw)
        d_loc = max(int(per_entity_dims.max()) if len(pair_e) else 1, 1)
        local_to_global = np.full((num_entities_raw, d_loc), -1, np.int32)
        local_to_global[pair_e, local_idx] = pair_f.astype(np.int32)
        pair_lookup = (pair_e * feats.dim + pair_f, local_idx)  # sorted composite keys

    def project_rows(row_sel: np.ndarray):
        """Rows' features in their entity's local space: (feat_idx (R, K)
        int32 with -1 masked, feat_val (R, K))."""
        sub_nnz_counts = np.diff(feats.indptr)[row_sel]
        k = max(int(sub_nnz_counts.max()) if len(row_sel) and sub_nnz_counts.size else 1, 1)
        out_idx = np.full((len(row_sel), k), -1, np.int32)
        out_val = np.zeros((len(row_sel), k), real)
        starts = feats.indptr[row_sel]
        ends = feats.indptr[row_sel + 1]
        lens = (ends - starts).astype(np.int64)
        flat_rows = np.repeat(np.arange(len(row_sel)), lens)
        flat_ptr = (np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
                    if len(row_sel) else np.zeros(0, np.int64))
        cols = feats.indices[flat_ptr].astype(np.int64)
        vals = feats.values[flat_ptr]
        slot = np.arange(len(flat_rows)) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        if pair_lookup is None:
            out_idx[flat_rows, slot] = cols.astype(np.int32)
            out_val[flat_rows, slot] = vals
            return out_idx, out_val
        comp = ids[row_sel][flat_rows].astype(np.int64) * feats.dim + cols
        keys, locs = pair_lookup
        pos = np.searchsorted(keys, comp)
        pos_c = np.clip(pos, 0, len(keys) - 1) if len(keys) else np.zeros_like(pos)
        hit = (keys[pos_c] == comp) if len(keys) else np.zeros(len(comp), bool)
        out_idx[flat_rows[hit], slot[hit]] = locs[pos_c[hit]].astype(np.int32)
        out_val[flat_rows[hit], slot[hit]] = vals[hit]
        return out_idx, out_val

    return d_loc, local_to_global, project_rows


def padded_row_coo(feats: HostFeatures, pad_col: int = -1):
    """CSR -> padded per-row COO: (cols (N, K), vals (N, K)), K = max
    nnz per row; padding slots carry ``pad_col`` with value 0."""
    n = feats.num_rows
    row_nnz = np.diff(feats.indptr)
    k = max(int(row_nnz.max()) if n else 1, 1)
    cols = np.full((n, k), pad_col, np.int32)
    vals = np.zeros((n, k), feats.values.dtype)
    rows = np.repeat(np.arange(n), row_nnz)
    slots = np.arange(len(feats.indices)) - np.repeat(feats.indptr[:-1], row_nnz)
    cols[rows, slots] = feats.indices
    vals[rows, slots] = feats.values
    return cols, vals


def build_fixed_effect_batch(data: GameData, feature_shard_id: str, dense: bool = True,
                             device=None):
    """One GLMBatch over all rows of a shard on ``device``, dense or
    padded-COO (data/FixedEffectDataSet.scala:31-105 analogue)."""
    from photon_ml_tpu_torch.io.libsvm import HostDataset, to_batch

    feats = data.shards[feature_shard_id]
    ds = HostDataset(
        labels=data.response, indptr=feats.indptr, indices=feats.indices,
        values=feats.values, dim=feats.dim, offsets=data.offset, weights=data.weight,
    )
    return to_batch(ds, dense=dense, pad_rows_to=1, device=device)
