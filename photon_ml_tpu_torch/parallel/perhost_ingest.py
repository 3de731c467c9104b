"""True per-host GAME ingest: each rank decodes only its input partitions,
the collective shuffle routes rows to entity owners, and each rank builds
ONLY its own entity slabs (port of photon_ml_tpu/parallel/perhost_ingest.py).

Reference pipeline (SURVEY.md §3.2): per-executor Avro decode with
per-partition index maps (DataProcessingUtils.scala:57-80) ->
``partitionBy``/``groupByKey`` entity regroup with reservoir caps
(RandomEffectDataSet.scala:171-357) -> per-entity local datasets. Here the
regroup is :mod:`photon_ml_tpu_torch.parallel.shuffle` (one all_to_all) and
the grouping, the INDEX_MAP / IDENTITY / RANDOM projection and the active /
passive split run on the OWNER rank over only the rows it received. The
active-set reservoir uses a partitioning-invariant per-row priority, so the
model does not depend on how input files are assigned to ranks.

One rank is one device: every tensor of :class:`ShardedREData` is the
rank's own block (the JAX package's per-device shard of the same index),
on the rank's device. Integer fields, keys and routed rows equal the JAX
package's at the same world size, and the float fields are the same
values. The solvers run the port's single-host random-effect solve on the
block, the rank's kernel selection included (the GEVM/HVP kernels on the
card); scoring is owner-computes: each rank scores its own rows from its
own block and one fixed-order sum merges the ``(N,)`` partials.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.parallel.mesh import MeshContext
from photon_ml_tpu_torch.parallel.shuffle import (
    balanced_bucket_owners,
    bucket_of,
    collective_max,
    collective_sum,
    exchange_rows,
    stable_entity_keys,
    stable_row_priority,
)
from photon_ml_tpu_torch.types import real_dtype

Tensor = torch.Tensor

# raw entity-id strings ride the exchange as fixed-width UTF-8 so the OWNER
# of an entity (who may never have ingested any of its rows) can write the
# model with real ids (the JAX package's record layout)
RAW_ID_BYTES = 48


def _np_real():
    return np.float64 if real_dtype() == torch.float64 else np.float32


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to photon_ml_tpu_torch")


@dataclasses.dataclass
class HostRows:
    """This host's decoded rows (global feature space). ``row_index`` must
    be globally unique and < 2^31."""

    entity_raw_ids: Sequence[str]  # (n,) raw entity id per row
    row_index: np.ndarray  # (n,) int64 global row id
    labels: np.ndarray  # (n,) float32
    weights: np.ndarray  # (n,) float32
    offsets: np.ndarray  # (n,) float32
    feat_idx: np.ndarray  # (n, K) int32, -1 padded, global feature indices
    feat_val: np.ndarray  # (n, K) float32
    global_dim: int

    @property
    def num_rows(self) -> int:
        return len(self.row_index)


@dataclasses.dataclass
class ShardedREData:
    """The rank's block of the entity-sharded random-effect tensors.
    Training tensors are entity-major; scoring tensors are row-major over
    the rows the rank OWNS (active and passive)."""

    # training (active) tensors of this rank's entities
    row_index: Tensor  # (E_loc, S) int32, -1 pad
    x: Tensor  # (E_loc, S, D_loc) locally-projected dense
    labels: Tensor  # (E_loc, S)
    base_offsets: Tensor  # (E_loc, S)
    weights: Tensor  # (E_loc, S), 0 = pad
    local_to_global: Tensor  # (E_loc, D_loc) int32, -1 pad
    entity_keys: Tensor  # (E_loc, 2) int32 packed u64 key, padding lanes 0
    entity_mask: Tensor  # (E_loc,) bool, False = padding lane
    # scoring tensors over this rank's owned rows
    score_row_index: Tensor  # (R,) int32, -1 pad
    score_slot: Tensor  # (R,) int32 entity slot within the block
    score_feat_idx: Tensor  # (R, K) int32 local feature indices, -1 pad
    score_feat_val: Tensor  # (R, K)
    # static metadata (identical on every rank)
    num_entities: int  # real entities across all ranks
    entities_per_device: int  # padded block height E_loc
    rows_per_device: int  # padded scoring rows R
    num_rows: int  # global N
    global_dim: int
    # whether the ingested row ids passed the dense-[0, N) checks
    # (necessary, not sufficient); non-dense ids are slab-build-only
    row_ids_dense: bool = True
    # this rank's raw id per entity key (decoded from the exchanged bytes)
    raw_ids_by_key: Dict[int, str] = dataclasses.field(default_factory=dict)
    # the agreed bucket -> rank owner map (identical on every rank)
    bucket_owners: Optional[np.ndarray] = None
    num_buckets: int = 0
    projector: str = "INDEX_MAP"
    projection_matrix: Optional[np.ndarray] = None

    @property
    def local_dim(self) -> int:
        return self.x.shape[-1]


@dataclasses.dataclass
class REBucketSlabs:
    """One size bucket's block of the training slabs, padded only to THIS
    bucket's collectively-agreed (sample, feature) widths."""

    row_index: Tensor  # (E_b, S_b) int32, -1 pad
    x: Tensor  # (E_b, S_b, D_b)
    labels: Tensor
    base_offsets: Tensor
    weights: Tensor  # 0 = pad
    local_to_global: Tensor  # (E_b, D_b) int32, -1 pad
    entity_keys: Tensor  # (E_b, 2) int32 packed u64
    entity_mask: Tensor  # (E_b,) bool
    entities_per_device: int
    samples_cap: int  # S_b
    num_entities: int  # real entities in this bucket (global)

    @property
    def local_dim(self) -> int:
        return self.x.shape[-1]


@dataclasses.dataclass
class BucketedShardedREData:
    """The rank's block in size-bucketed form: the training slabs are a
    LIST of per-bucket stacks, and the scoring slots index the
    CONCATENATION of the bucket slabs (bucket base + rank in bucket)."""

    buckets: List[REBucketSlabs]
    score_row_index: Tensor
    score_slot: Tensor
    score_feat_idx: Tensor
    score_feat_val: Tensor
    num_entities: int
    entities_per_device: int
    rows_per_device: int
    num_rows: int
    global_dim: int
    local_dim: int  # max over buckets of D_b (the scoring width)
    row_ids_dense: bool = True
    raw_ids_by_key: Dict[int, str] = dataclasses.field(default_factory=dict)
    bucket_owners: Optional[np.ndarray] = None
    num_buckets: int = 0
    projector: str = "INDEX_MAP"
    projection_matrix: Optional[np.ndarray] = None

    @property
    def padded_elements(self) -> int:
        """x-slab element count across buckets (the skew diagnostic)."""
        return sum(int(np.prod(b.x.shape)) for b in self.buckets)


def local_shards(arr) -> List[np.ndarray]:
    """This host's shards of a sharded array, in device order: one rank is
    one device, so the block itself."""
    t = arr.detach().cpu() if isinstance(arr, Tensor) else arr
    return [np.asarray(t)]


def _pack_u64(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 keys as (hi, lo) int32 bit views (torch has no full uint64)."""
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def _unpack_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) | lo.view(
        np.uint32).astype(np.uint64)


def csr_to_padded(feats, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR shard -> row-major padded (feat_idx (n, K) int32 with -1 mask,
    feat_val (n, K) f32)."""
    nnz = np.diff(feats.indptr)
    k = max(int(nnz.max()) if n else 1, 1)
    fi = np.full((n, k), -1, np.int32)
    fv = np.zeros((n, k), np.float32)
    rows_rep = np.repeat(np.arange(n), nnz)
    slots = np.arange(len(feats.indices)) - np.repeat(feats.indptr[:-1], nnz)
    fi[rows_rep, slots] = feats.indices
    fv[rows_rep, slots] = feats.values
    return fi, fv


def _pad_to(a: np.ndarray, rows: int, fill) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def _pad_width(a: np.ndarray, k: int, fill, dtype) -> np.ndarray:
    a = a.astype(dtype)
    return a if a.shape[1] == k else _pad_to(a.T, k, fill).T


def concat_host_rows(parts: Sequence[HostRows], global_dim: int) -> HostRows:
    """Concatenate per-file HostRows into one block, padding the feature
    width to the widest part."""
    if not parts:
        return HostRows(entity_raw_ids=[], row_index=np.zeros(0, np.int64),
                        labels=np.zeros(0, np.float32), weights=np.zeros(0, np.float32),
                        offsets=np.zeros(0, np.float32),
                        feat_idx=np.full((0, 1), -1, np.int32),
                        feat_val=np.zeros((0, 1), np.float32), global_dim=global_dim)
    k_max = max(p.feat_idx.shape[1] for p in parts)
    return HostRows(
        entity_raw_ids=[r for p in parts for r in p.entity_raw_ids],
        row_index=np.concatenate([p.row_index for p in parts]),
        labels=np.concatenate([p.labels for p in parts]),
        weights=np.concatenate([p.weights for p in parts]),
        offsets=np.concatenate([p.offsets for p in parts]),
        feat_idx=np.concatenate([_pad_width(p.feat_idx, k_max, -1, np.int32) for p in parts]),
        feat_val=np.concatenate([_pad_width(p.feat_val, k_max, 0.0, np.float32)
                                 for p in parts]),
        global_dim=global_dim,
    )


def per_host_re_dataset(
    rows: HostRows,
    ctx: MeshContext,
    num_processes: int = 1,
    process_id: int = 0,
    active_upper_bound: Optional[int] = None,
    num_buckets: int = 4096,
    slab_build_only: bool = False,
    size_buckets: int = 1,
    projector: str = "INDEX_MAP",
    projection_matrix: Optional[np.ndarray] = None,
    projection_dim: Optional[int] = None,
    projection_seed: int = 1234567890,
    projection_keep_intercept: bool = True,
) -> "ShardedREData | BucketedShardedREData":
    """Shuffle this rank's rows to their entity owners and build the owned
    block. Every rank calls this collectively.

    Row ids must be dense [0, N) across ranks (``global_row_layout`` or
    ``densify_row_ids``); scoring scatters into an (N,) vector. Non-dense
    ids raise unless ``slab_build_only=True``, which marks the result so
    scoring refuses it.

    ``size_buckets=1`` returns :class:`ShardedREData`; ``> 1`` returns
    :class:`BucketedShardedREData` with up to that many geometric
    active-count buckets, each padded only to its own agreed width.

    ``projector``: ``"INDEX_MAP"`` (each entity's local space is the
    features it saw in training), ``"IDENTITY"`` (the global shard space),
    or ``"RANDOM"`` (rows projected through the shared Gaussian matrix,
    derived from ``projection_seed`` identically on every rank unless
    ``projection_matrix`` is given).
    """
    if projector not in ("INDEX_MAP", "IDENTITY", "RANDOM"):
        raise ValueError(f"unknown projector {projector!r}")
    dt = _np_real()
    if projector == "RANDOM":
        if projection_matrix is None:
            if projection_dim is None:
                raise ValueError("RANDOM projector needs projection_dim (or a prebuilt "
                                 "projection_matrix)")
            from photon_ml_tpu_torch.projectors import gaussian_random_projection_matrix

            projection_matrix = gaussian_random_projection_matrix(
                projection_dim, rows.global_dim, keep_intercept=projection_keep_intercept,
                seed=projection_seed)
        projection_matrix = np.asarray(projection_matrix, dt)
        if projection_matrix.shape[1] != rows.global_dim:
            raise ValueError(f"projection matrix is {projection_matrix.shape}, dataset "
                             f"global_dim is {rows.global_dim}")
        k_proj = projection_matrix.shape[0]
    else:
        projection_matrix = None
        k_proj = 0
    n_dev = ctx.num_devices
    keys = stable_entity_keys(rows.entity_raw_ids)

    # ---- agree on record width (global max nnz) + row-id bounds ----------
    local_max_row = int(rows.row_index.max()) if rows.num_rows else -1
    km = collective_max(np.asarray([rows.feat_idx.shape[1], local_max_row], np.int64), ctx,
                        num_processes)
    k, g_max_row = int(km[0]), int(km[1])
    sums = collective_sum(np.asarray([rows.num_rows, int(rows.row_index.sum())], np.int64),
                          ctx, num_processes)
    n_global, g_id_sum = int(sums[0]), int(sums[1])
    row_ids_dense = (g_max_row == n_global - 1
                     and g_id_sum == n_global * (n_global - 1) // 2)
    if not row_ids_dense and not slab_build_only:
        raise ValueError(
            f"row ids are not dense [0, N): max id {g_max_row} vs {n_global} global rows. "
            "Use global_row_layout / densify_row_ids to assign dense ids "
            "(host_rows_from_avro's strided ids are slab-build-only), or pass "
            "slab_build_only=True if this dataset will never be scored.")
    fi = _pad_width(rows.feat_idx, k, -1, np.int32)
    fv = _pad_width(rows.feat_val, k, 0.0, np.float32)

    # ---- balanced owner map from collectively-summed bucket counts --------
    buckets = bucket_of(keys, num_buckets)
    counts = np.bincount(buckets, minlength=num_buckets).astype(np.int64)
    owners = balanced_bucket_owners(collective_sum(counts, ctx, num_processes), n_dev)
    dest = owners[buckets]

    # ---- pack + exchange --------------------------------------------------
    hi, lo = _pack_u64(keys)
    raw_words = RAW_ID_BYTES // 4
    raw_bytes = np.zeros((rows.num_rows, RAW_ID_BYTES), np.uint8)
    for i, rid in enumerate(rows.entity_raw_ids):
        b = rid.encode("utf-8")
        if len(b) > RAW_ID_BYTES:
            raise ValueError(f"entity id {rid!r} exceeds {RAW_ID_BYTES} UTF-8 bytes")
        raw_bytes[i, : len(b)] = np.frombuffer(b, np.uint8)
    int_payload = np.concatenate(
        [rows.row_index.astype(np.int32)[:, None], hi[:, None], lo[:, None],
         raw_bytes.view(np.int32), fi], axis=1)
    flt_payload = np.concatenate(
        [rows.labels.astype(np.float32)[:, None], rows.weights.astype(np.float32)[:, None],
         rows.offsets.astype(np.float32)[:, None], fv], axis=1)
    ex = exchange_rows(dest, int_payload, flt_payload, ctx, num_processes, process_id)

    # ---- group, cap, project, measure (this rank's one device) -----------
    bi, bf = ex.int_rows[0], ex.float_rows[0]
    okeys = _unpack_u64(bi[:, 1], bi[:, 2])
    orow = bi[:, 0].astype(np.int64)
    prio = stable_row_priority(okeys, orow)
    # group by entity, priority-ordered within (row id breaks ties)
    order = np.lexsort((orow, prio, okeys))
    okeys, orow = okeys[order], orow[order]
    oraw = bi[order, 3: 3 + raw_words]
    ofi, ofv = bi[order, 3 + raw_words:], bf[order, 3:]
    olab, owgt, ooff = bf[order, 0], bf[order, 1], bf[order, 2]
    uniq, ent_start, inv = np.unique(okeys, return_index=True, return_inverse=True)
    e_d = len(uniq)
    cnt = np.bincount(inv, minlength=e_d)
    rank = np.arange(len(okeys)) - ent_start[inv]
    cap = active_upper_bound or (int(cnt.max()) if e_d else 1)
    active = rank < cap
    # kept weights rescaled so the active set represents the entity
    # (RandomEffectDataSet.scala:298-301)
    scale = np.where(cnt > cap, cnt / cap, 1.0)
    wgt = owgt * np.where(active, scale[inv], 1.0)
    xproj = None
    if projector == "INDEX_MAP":
        a_rows = np.nonzero(active)[0]
        pe = np.repeat(inv[a_rows], ofi.shape[1])
        pf = ofi[a_rows].reshape(-1)
        keep = pf >= 0
        pair = np.unique(pe[keep].astype(np.int64) * rows.global_dim + pf[keep])
        pair_e = (pair // rows.global_dim).astype(np.int64)
        pair_f = (pair % rows.global_dim).astype(np.int64)
        dims = np.bincount(pair_e, minlength=e_d)
    elif projector == "IDENTITY":
        pair_e = pair_f = np.zeros(0, np.int64)
        dims = np.full(e_d, rows.global_dim, np.int64)
    else:  # RANDOM: project every owned row through the shared matrix
        pair_e = pair_f = np.zeros(0, np.int64)
        dims = np.full(e_d, k_proj, np.int64)
        nr_d = len(orow)
        xproj = np.zeros((nr_d, k_proj), dt)
        pm_t = projection_matrix.T  # (D_global, k_proj)
        for lo_r in range(0, nr_d, 8192):
            sl = slice(lo_r, min(lo_r + 8192, nr_d))
            cols = pm_t[np.maximum(ofi[sl], 0)]  # (B, K, k_proj)
            vals = np.where(ofi[sl] >= 0, ofv[sl], 0.0)
            xproj[sl] = np.einsum("bk,bkp->bp", vals, cols)
    raw_ids = {}
    for e, first in enumerate(ent_start):
        b = np.ascontiguousarray(oraw[first]).view(np.uint8).tobytes()
        raw_ids[int(uniq[e])] = b.rstrip(b"\x00").decode("utf-8")

    # ---- agree on uniform tensor dims (one collective max) ----------------
    neg_sentinel = np.iinfo(np.int64).min
    local_meta = np.zeros(5, np.int64)
    local_meta[4] = neg_sentinel
    local_meta[0] = e_d
    if e_d:
        a_e = np.minimum(cnt, cap)
        local_meta[1] = int(a_e.max())
        local_meta[2] = int(dims.max()) if len(dims) else 1
        # negated min: one collective max also agrees the global MIN active
        # count (the geometric bucket base)
        local_meta[4] = -int(a_e.min())
    local_meta[3] = len(orow)
    e_max, s_max, d_loc, r_max, neg_min = (
        int(v) for v in collective_max(local_meta, ctx, num_processes))
    e_max, s_max, d_loc, r_max = max(e_max, 1), max(s_max, 1), max(d_loc, 1), max(r_max, 1)
    g_min_act = max(-neg_min, 1) if neg_min > neg_sentinel else 1
    real_entities = int(collective_sum(np.asarray([e_d], np.int64), ctx, num_processes)[0])

    # ---- agree on bucket widths + per-bucket dims -------------------------
    nb = max(int(size_buckets), 1)
    widths = (sorted({min(g_min_act << b, s_max) for b in range(nb - 1)} | {s_max})
              if nb > 1 else [s_max])
    warr = np.asarray(widths, np.int64)
    nb_eff = len(widths)
    if nb_eff == 1:
        bidx = np.zeros(e_d, np.int64)
        bslot = np.arange(e_d, dtype=np.int64)
        kept = [0]
        bdims = [(e_max, s_max, d_loc)]
        bucket_counts = np.asarray([real_entities], np.int64)
    else:
        bmeta = np.zeros(3 * nb_eff, np.int64)
        bucket_counts_local = np.zeros(nb_eff, np.int64)
        bidx = np.zeros(e_d, np.int64)
        bslot = np.zeros(e_d, np.int64)
        if e_d:
            a_e = np.minimum(cnt, cap)
            bidx = np.searchsorted(warr, a_e, side="left")  # first width >= a_e
            for b in range(nb_eff):
                sel = bidx == b
                n_sel = int(sel.sum())
                bslot[sel] = np.arange(n_sel)
                bucket_counts_local[b] += n_sel
                bmeta[3 * b] = n_sel
                if n_sel:
                    bmeta[3 * b + 1] = int(a_e[sel].max())
                    dm = dims[sel]
                    bmeta[3 * b + 2] = int(dm.max()) if len(dm) else 1
        g_bmeta = collective_max(bmeta, ctx, num_processes)
        bucket_counts = collective_sum(bucket_counts_local, ctx, num_processes)
        kept = [b for b in range(nb_eff) if int(g_bmeta[3 * b]) > 0] or [0]
        bdims = [(max(int(g_bmeta[3 * b]), 1), max(int(g_bmeta[3 * b + 1]), 1),
                  max(int(g_bmeta[3 * b + 2]), 1)) for b in kept]
    pos_of_bucket = np.full(nb_eff, -1, np.int64)
    pos_of_bucket[kept] = np.arange(len(kept))
    bucket_base = np.concatenate([[0], np.cumsum([bd[0] for bd in bdims])[:-1]]).astype(np.int64)
    d_loc_max = max(bd[2] for bd in bdims)

    # ---- build the block ----------------------------------------------------
    k_sc = k_proj if projector == "RANDOM" else k  # scoring feature width
    nr = len(orow)
    li = lv = loc_idx = None
    if e_d:
        if projector == "INDEX_MAP":
            ent_start_pairs = np.searchsorted(pair_e, np.arange(e_d), side="left")
            loc_idx = np.arange(len(pair_e)) - ent_start_pairs[pair_e]
            comp_keys = pair_e * rows.global_dim + pair_f
            rr = np.repeat(np.arange(nr), ofi.shape[1])
            cc = ofi.reshape(-1).astype(np.int64)
            valid = cc >= 0
            comp = inv[rr].astype(np.int64) * rows.global_dim + cc
            pos = np.searchsorted(comp_keys, comp)
            pos_c = np.clip(pos, 0, max(len(comp_keys) - 1, 0))
            hit = valid & (len(comp_keys) > 0) & (comp_keys[pos_c] == comp)
            li = np.where(hit, loc_idx[pos_c], -1).reshape(nr, -1).astype(np.int32)
            lv = np.where(hit.reshape(nr, -1), ofv, 0.0)
        elif projector == "IDENTITY":
            li, lv = ofi.astype(np.int32), ofv
        else:
            li, lv = np.tile(np.arange(k_proj, dtype=np.int32), (nr, 1)), xproj
    sri = np.full((r_max,), -1, np.int32)
    ssl = np.zeros((r_max,), np.int32)
    sfi = np.full((r_max, k_sc), -1, np.int32)
    sfv = np.zeros((r_max, k_sc), dt)
    if e_d:
        gslot = bucket_base[pos_of_bucket[bidx]] + bslot
        sri[:nr] = orow.astype(np.int32)
        ssl[:nr] = gslot[inv].astype(np.int32)
        sfi[:nr] = li
        sfv[:nr] = lv
    blocks = []
    for bpos, b in enumerate(kept):
        e_max_b, s_b, dl_b = bdims[bpos]
        tri = np.full((e_max_b, s_b), -1, np.int32)
        tx = np.zeros((e_max_b, s_b, dl_b), dt)
        tlab = np.zeros((e_max_b, s_b), dt)
        toff = np.zeros((e_max_b, s_b), dt)
        twgt = np.zeros((e_max_b, s_b), dt)
        l2g = np.full((e_max_b, dl_b), -1, np.int32)
        ekeys = np.zeros((e_max_b, 2), np.int32)
        emask = np.zeros((e_max_b,), bool)
        if e_d:
            in_b = bidx == b
            sel_e = np.nonzero(in_b)[0]  # key-sorted; bslot == arange
            n_b = len(sel_e)
            if n_b:
                emask[:n_b] = True
                ekeys[:n_b, 0], ekeys[:n_b, 1] = _pack_u64(uniq[sel_e])
                if projector == "INDEX_MAP":
                    pe_in = in_b[pair_e]
                    l2g[bslot[pair_e[pe_in]], loc_idx[pe_in]] = pair_f[pe_in].astype(np.int32)
                elif projector == "IDENTITY":
                    l2g[:n_b] = np.arange(dl_b, dtype=np.int32)
                # RANDOM: l2g stays -1 (back-projection goes through the matrix)
                act = active & in_b[inv]
                er = bslot[inv[act]]
                rk = rank[act]
                tri[er, rk] = orow[act].astype(np.int32)
                tlab[er, rk] = olab[act]
                toff[er, rk] = ooff[act]
                twgt[er, rk] = wgt[act]
                arow = np.nonzero(act)[0]
                dense = np.zeros((len(arow), dl_b), dt)
                rows2 = np.repeat(np.arange(len(arow)), li.shape[1])
                lia = li[arow].reshape(-1)
                lva = lv[arow].reshape(-1)
                ok = lia >= 0
                dense[rows2[ok], lia[ok]] = lva[ok]
                tx[er, rk] = dense
        blocks.append(dict(row_index=tri, x=tx, labels=tlab, base_offsets=toff, weights=twgt,
                           local_to_global=l2g, entity_keys=ekeys, entity_mask=emask))

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
    score = dict(score_row_index=put(sri), score_slot=put(ssl), score_feat_idx=put(sfi),
                 score_feat_val=put(sfv))
    meta = dict(rows_per_device=r_max, num_rows=n_global, global_dim=rows.global_dim,
                row_ids_dense=row_ids_dense, raw_ids_by_key=raw_ids, bucket_owners=owners,
                num_buckets=num_buckets, projector=projector,
                projection_matrix=projection_matrix)
    if nb == 1:
        return ShardedREData(**{f: put(a) for f, a in blocks[0].items()}, **score,
                             num_entities=real_entities, entities_per_device=bdims[0][0],
                             **meta)
    bucket_slabs = [
        REBucketSlabs(**{f: put(a) for f, a in blk.items()},
                      entities_per_device=bdims[bpos][0], samples_cap=bdims[bpos][1],
                      num_entities=int(bucket_counts[kept[bpos]]))
        for bpos, blk in enumerate(blocks)
    ]
    return BucketedShardedREData(buckets=bucket_slabs, **score, num_entities=real_entities,
                                 entities_per_device=int(sum(bd[0] for bd in bdims)),
                                 local_dim=d_loc_max, **meta)


# ---------------------------------------------------------------------------
# the solvers over the per-rank blocks (drop-in CoordinateDescent coordinates)
# ---------------------------------------------------------------------------


def _block_coordinate(data, task, optimizer, optimizer_config, regularization, label,
                      sparse_kernel, bucketer):
    """The port's single-host random-effect coordinate over one rank's
    training block (its kernel selection included)."""
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.data.game import RandomEffectDataset

    dev = data.x.device
    none = torch.zeros((1,), dtype=torch.int32, device=dev)
    pm = getattr(data, "projection_matrix", None)
    ds = RandomEffectDataset(
        row_index=data.row_index, x=data.x, labels=data.labels,
        base_offsets=data.base_offsets, weights=data.weights,
        entity_pos=none, feat_idx=none[None], feat_val=none[None].to(data.x.dtype),
        local_to_global=data.local_to_global, num_entities=data.x.shape[0],
        global_dim=data.x.shape[-1],
        # a RANDOM-projected block is dense in every slot: the dense stack
        projection_matrix=(None if pm is None else torch.from_numpy(np.asarray(pm)).to(dev)))
    return RandomEffectCoordinate(ds, task, optimizer, optimizer_config, regularization,
                                  solve_label=label, sparse_kernel=sparse_kernel,
                                  bucketer=bucketer or "off")


def _owned_scores(ctx: MeshContext, num_rows: int, w: Tensor, srow: Tensor, sslot: Tensor,
                  sfi: Tensor, sfv: Tensor) -> Tensor:
    """Owner-computes scoring: this rank's owned rows scored from its own
    block, scattered into an (N,) vector (each row is owned by one rank,
    so the fixed-order merge adds exact zeros)."""
    wsel = w[torch.clamp_min(sslot, 0).long()]  # (R, D)
    vals = torch.gather(wsel, 1, torch.clamp_min(sfi, 0).long())
    vals = torch.where(sfi >= 0, vals * sfv, torch.zeros_like(vals))
    valid = srow >= 0
    out = torch.zeros((num_rows,), dtype=w.dtype, device=w.device)
    out[srow[valid].long()] = torch.sum(vals, dim=-1)[valid]
    return ctx.sum(out)


def _refuse_sparse_ids(data) -> None:
    if not data.row_ids_dense:
        raise ValueError(
            "dataset was built slab_build_only from non-dense row ids; scoring would "
            "drop out-of-range rows — rebuild with dense [0, N) ids (densify_row_ids)")


@dataclasses.dataclass
class PerHostRandomEffectSolver:
    """Entity-sharded random-effect coordinate over :class:`ShardedREData`
    (update / score / initial_coefficients / regularization_term): update is
    the single-host solve on the rank's block (zero collectives), scoring is
    owner-computes plus one fixed-order sum (coefficients never move; scores
    do). The state is the rank's ``(E_loc, D_loc)`` block."""

    data: ShardedREData
    task: object
    optimizer: object
    optimizer_config: object
    regularization: object
    ctx: MeshContext
    sparse_kernel: Optional[str] = None  # None reads PHOTON_SPARSE_KERNEL
    solve_label: str = "per_host_re"
    bucketer: Optional[object] = None

    # the checkpoint gathers this state across ranks (leaf 0 is sharded)
    rank_sharded_leaves = (0,)

    @property
    def cd_jit(self) -> bool:
        """Across ranks the scores merge through a collective inside the
        update's score: the fused cycle refuses the coordinate (the JAX
        ``cd_jit = process_count() == 1``)."""
        return self.ctx.world == 1

    def __post_init__(self):
        self.coordinate = _block_coordinate(
            self.data, self.task, self.optimizer, self.optimizer_config, self.regularization,
            self.solve_label, self.sparse_kernel, self.bucketer)

    @property
    def local_dim(self) -> int:
        return self.data.local_dim

    @property
    def slab(self):
        return self.coordinate.slab

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.data.entity_mask.shape[0], self.data.local_dim),
                           dtype=real_dtype(), device=self.data.x.device)

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor,
               reg_weight: Optional[float] = None, resume: Optional[dict] = None):
        if resume is not None:
            raise _not_ported("resuming inside a per-host random-effect update")
        return self.coordinate.update(residual_offsets, init_coefficients, reg_weight=reg_weight)

    def score(self, coefficients: Tensor) -> Tensor:
        _refuse_sparse_ids(self.data)
        d = self.data
        return _owned_scores(self.ctx, d.num_rows, coefficients, d.score_row_index,
                             d.score_slot, d.score_feat_idx, d.score_feat_val)

    def regularization_term(self, coefficients, reg_weight: Optional[float] = None) -> Tensor:
        """The rank's term summed over ranks in rank order."""
        from photon_ml_tpu_torch.optim.problem import _split_reg_weight

        l1, l2 = _split_reg_weight(self.regularization, reg_weight)
        ws = coefficients if isinstance(coefficients, tuple) else (coefficients,)
        term = sum(l1 * torch.sum(torch.abs(w)) + 0.5 * l2 * torch.sum(torch.square(w))
                   for w in ws)
        return self.ctx.sum(term.reshape(1))[0]


@dataclasses.dataclass
class PerHostBucketedRandomEffectSolver(PerHostRandomEffectSolver):
    """Size-bucketed variant over :class:`BucketedShardedREData`: the state
    is a TUPLE of per-bucket ``(E_b, D_b)`` blocks, one single-host solve per
    bucket, and scoring concatenates the bucket blocks so one gather serves
    them all."""

    data: BucketedShardedREData  # type: ignore[assignment]

    def __post_init__(self):
        self.coordinates = [
            _block_coordinate(b, self.task, self.optimizer, self.optimizer_config,
                              self.regularization, f"{self.solve_label}-bucket{i}",
                              self.sparse_kernel, self.bucketer)
            for i, b in enumerate(self.data.buckets)
        ]
        self.rank_sharded_leaves = tuple(range(len(self.data.buckets)))

    @property
    def slab(self):
        return self.coordinates[0].slab

    def initial_coefficients(self) -> Tuple[Tensor, ...]:
        return tuple(torch.zeros((b.entity_mask.shape[0], b.local_dim), dtype=real_dtype(),
                                 device=b.x.device) for b in self.data.buckets)

    def update(self, residual_offsets: Tensor, init_coefficients, reg_weight=None,
               resume: Optional[dict] = None):
        if resume is not None:
            raise _not_ported("resuming inside a per-host random-effect update")
        state, results = [], []
        for coord, w0 in zip(self.coordinates, init_coefficients):
            w, res = coord.update(residual_offsets, w0, reg_weight=reg_weight)
            state.append(w)
            results.append(res)
        return tuple(state), tuple(results)

    def concatenated(self, state) -> Tensor:
        """The bucket blocks concatenated, feature axis padded to the shared
        scoring width: the layout the scoring slots index."""
        d_max = self.data.local_dim
        return torch.cat([torch.nn.functional.pad(w, (0, d_max - w.shape[-1]))
                          for w in state], dim=0)

    def score(self, state) -> Tensor:
        _refuse_sparse_ids(self.data)
        d = self.data
        return _owned_scores(self.ctx, d.num_rows, self.concatenated(state), d.score_row_index,
                             d.score_slot, d.score_feat_idx, d.score_feat_val)


# ---------------------------------------------------------------------------
# per-host Avro decode (the DataProcessingUtils per-partition analogue)
# ---------------------------------------------------------------------------


def host_rows_from_avro(host_files: Sequence[str], file_ordinals: Sequence[int], index_map,
                        random_effect_id: str, shard_id: str, shard_sections: Sequence[str],
                        intercept: bool = True, row_stride: int = 1 << 22,
                        prefetch_depth: Optional[int] = None) -> HostRows:
    """Decode ONLY this host's Avro part files into :class:`HostRows`.
    Global row ids are ``ordinal * row_stride + row_in_file`` (unique
    without coordination while every file holds < row_stride rows) and
    SPARSE: pass the result through :func:`densify_row_ids` before a build
    that will be scored. Files decode on a background thread up to
    ``prefetch_depth`` ahead (io/pipeline.py); the order is the same."""
    from photon_ml_tpu_torch.io.avro_data import read_game_data
    from photon_ml_tpu_torch.io.pipeline import Prefetcher

    file_ordinals = list(file_ordinals)
    if len(host_files) != len(file_ordinals):
        raise ValueError(f"{len(host_files)} files but {len(file_ordinals)} ordinals — a "
                         "mismatch would silently drop input files")
    max_ord = max(file_ordinals) if file_ordinals else 0
    if (max_ord + 1) * row_stride >= 2 ** 31:
        raise ValueError(f"file ordinal {max_ord} x stride {row_stride} overflows the int32 "
                         "row-id space; lower row_stride or merge input files")

    def decode_all():
        for path, ordinal in zip(host_files, file_ordinals):
            gd = read_game_data([path], {shard_id: index_map}, {shard_id: list(shard_sections)},
                                [random_effect_id], shard_intercepts={shard_id: intercept})
            yield path, ordinal, gd

    parts: List[HostRows] = []
    for path, ordinal, gd in Prefetcher(decode_all, depth=prefetch_depth,
                                        name="avro-decode-prefetch"):
        feats = gd.shards[shard_id]
        n = gd.num_rows
        if n >= row_stride:
            raise ValueError(f"{path}: {n} rows exceeds row_stride {row_stride}")
        fi, fv = csr_to_padded(feats, n)
        vocab = gd.id_vocabs[random_effect_id]
        parts.append(HostRows(
            entity_raw_ids=[vocab[i] for i in gd.ids[random_effect_id]],
            row_index=ordinal * row_stride + np.arange(n, dtype=np.int64),
            labels=gd.response.astype(np.float32), weights=gd.weight.astype(np.float32),
            offsets=gd.offset.astype(np.float32), feat_idx=fi, feat_val=fv,
            global_dim=feats.dim))
    return concat_host_rows(parts, len(index_map))


def densify_row_ids(rows: HostRows, row_stride: int, ctx: MeshContext,
                    num_processes: int = 1) -> HostRows:
    """Rewrite strided row ids (``ordinal * row_stride + row_in_file``) into
    the dense [0, N) layout with one collective per-file count exchange.
    Each file must be decoded wholly by one host, rows numbered from 0;
    violations raise."""
    ords = rows.row_index // row_stride
    j = rows.row_index % row_stride
    local_max = int(ords.max()) if rows.num_rows else -1
    num_files = int(collective_max(np.asarray([local_max], np.int64), ctx,
                                   num_processes)[0]) + 1
    counts = np.bincount(ords, minlength=max(num_files, 1)).astype(np.int64)
    g_counts = collective_sum(counts, ctx, num_processes)
    order = np.argsort(rows.row_index, kind="stable")
    ords_s, j_s = ords[order], j[order]
    uniq_o, seg_counts = np.unique(ords_s, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(seg_counts)[:-1]])
    bad = j_s != np.arange(len(j_s)) - np.repeat(starts, seg_counts)
    if bad.any():
        o = int(ords_s[np.argmax(bad)])
        raise ValueError(f"file ordinal {o}: row-in-file ids are not contiguous "
                         f"[0, {int(counts[o])})")
    split = g_counts[uniq_o] != seg_counts
    if split.any():
        o = int(uniq_o[np.argmax(split)])
        raise ValueError(f"file ordinal {o}: decoded on more than one host "
                         f"({int(counts[o])} rows here, {int(g_counts[o])} globally)")
    file_base = np.concatenate([[0], np.cumsum(g_counts)[:-1]])
    return dataclasses.replace(rows, row_index=file_base[ords] + j)


# ---------------------------------------------------------------------------
# scoring-time row routing (validation / inference over per-host models)
# ---------------------------------------------------------------------------


def score_routed_rows(sd: "ShardedREData | BucketedShardedREData", coefficients,
                      rows: HostRows, num_rows_out: int, ctx: MeshContext,
                      num_processes: int = 1, process_id: int = 0) -> np.ndarray:
    """Score rows THIS host ingested against entity models on any rank:
    route each row to its entity's owner with the training shuffle's owner
    map, the owner projects it into the entity's local space and dots it
    with its block row, and one collective sum merges the partials. A row
    whose entity has no model, or a feature the entity never saw, adds 0
    (RandomEffectModel.scala:129-158). Returns the (num_rows_out,) float32
    scores, identical on every host."""
    if sd.bucket_owners is None:
        raise ValueError("dataset was built without bucket_owners")
    host = lambda t: t.detach().cpu().numpy() if isinstance(t, Tensor) else np.asarray(t)
    if isinstance(sd, BucketedShardedREData):
        if not isinstance(coefficients, (tuple, list)) or len(coefficients) != len(sd.buckets):
            raise ValueError("bucketed dataset requires the per-bucket coefficient tuple "
                             f"({len(sd.buckets)} buckets)")
        d_max = sd.local_dim
        w_h = np.concatenate([np.pad(host(w), ((0, 0), (0, d_max - w.shape[-1])))
                              for w in coefficients])
        k_h = np.concatenate([host(b.entity_keys) for b in sd.buckets])
        m_h = np.concatenate([host(b.entity_mask) for b in sd.buckets])
        l_h = np.concatenate([np.pad(host(b.local_to_global),
                                     ((0, 0), (0, d_max - b.local_to_global.shape[-1])),
                                     constant_values=-1) for b in sd.buckets])
    else:
        w_h, k_h = host(coefficients), host(sd.entity_keys)
        m_h, l_h = host(sd.entity_mask), host(sd.local_to_global)
    keys = stable_entity_keys(rows.entity_raw_ids)
    dest = sd.bucket_owners[bucket_of(keys, sd.num_buckets)]
    # every host packs the same record width (the training path's rule)
    k = int(collective_max(np.asarray([rows.feat_idx.shape[1]], np.int64), ctx,
                           num_processes)[0])
    fi_p = _pad_width(rows.feat_idx, k, -1, np.int32)
    fv_p = _pad_width(rows.feat_val, k, 0.0, np.float32)
    hi, lo = _pack_u64(keys)
    int_payload = np.concatenate(
        [rows.row_index.astype(np.int32)[:, None], hi[:, None], lo[:, None], fi_p], axis=1)
    ex = exchange_rows(dest, int_payload, fv_p, ctx, num_processes, process_id)
    scores_local = np.zeros(num_rows_out, np.float64)
    bi, bf = ex.int_rows[0], ex.float_rows[0]
    if len(bi):
        okeys = _unpack_u64(bi[:, 1], bi[:, 2])
        slab_keys = _unpack_u64(k_h[:, 0], k_h[:, 1])
        # key -> slot lookup over this rank's (masked) lanes
        order = np.argsort(slab_keys, kind="stable")
        sk = slab_keys[order]
        pos_c = np.clip(np.searchsorted(sk, okeys), 0, max(len(sk) - 1, 0))
        hit = (sk[pos_c] == okeys) & m_h[order][pos_c]
        slot = np.where(hit, order[pos_c], -1)
        fi, fv = bi[:, 3:], bf
        rr = np.nonzero(slot >= 0)[0]
        if len(rr) and getattr(sd, "projection_matrix", None) is not None:
            # RANDOM: project the routed row through the shared matrix
            pm_t = np.asarray(sd.projection_matrix).T
            cols = pm_t[np.maximum(fi[rr], 0)]
            vals = np.where(fi[rr] >= 0, fv[rr], 0.0)
            xp = np.einsum("bk,bkp->bp", vals, cols)
            np.add.at(scores_local, bi[rr, 0], np.sum(w_h[slot[rr]] * xp, axis=1))
        elif len(rr):
            # a block row's valid local_to_global prefix is sorted ascending,
            # so the local index of a global feature is a row-wise search
            l2g_rows = l_h[slot[rr]]
            big = np.int64(np.iinfo(np.int32).max)
            l2g_sorted = np.where(l2g_rows >= 0, l2g_rows, big).astype(np.int64)
            gidx = fi[rr].astype(np.int64)
            safe_g = np.where(gidx >= 0, gidx, 0)
            d_loc = l2g_sorted.shape[1]
            stride = big + 1
            base = np.arange(len(rr))[:, None] * stride
            j = np.searchsorted((l2g_sorted + base).reshape(-1),
                                (safe_g + base).reshape(-1)).reshape(len(rr), -1)
            j_local = j - np.arange(len(rr))[:, None] * d_loc
            j_c = np.clip(j_local, 0, d_loc - 1)
            found = ((gidx >= 0) & (j_local < d_loc)
                     & (np.take_along_axis(l2g_rows, j_c, axis=1) == gidx))
            wsel = w_h[slot[rr][:, None], j_c]
            np.add.at(scores_local, bi[rr, 0],
                      np.sum(np.where(found, wsel * fv[rr], 0.0), axis=1))
    return np.asarray(collective_sum(scores_local.astype(np.float32), ctx, num_processes),
                      np.float32)


# ---------------------------------------------------------------------------
# per-host MODEL ingest (SPMD scoring: no host ever holds the full model)
# ---------------------------------------------------------------------------


def per_host_model_slabs(entity_ids: Sequence[str], coef_idx: np.ndarray,
                         coef_val: np.ndarray, global_dim: int, ctx: MeshContext,
                         num_processes: int = 1, process_id: int = 0,
                         num_buckets: int = 4096) -> Tuple[ShardedREData, Tensor]:
    """Entity-sharded MODEL blocks from the per-entity coefficient records
    THIS host loaded (its share of the model's part files): each record is
    routed to its entity's owner with the training shuffle, the owner builds
    its block, and scoring routes rows to owners (score_routed_rows).
    Returns (the dataset view the routing needs, the rank's ``(E_loc,
    D_loc)`` coefficient block)."""
    n = len(entity_ids)
    rows = HostRows(entity_raw_ids=list(entity_ids), row_index=np.arange(n, dtype=np.int64),
                    labels=np.zeros(n, np.float32), weights=np.ones(n, np.float32),
                    offsets=np.zeros(n, np.float32), feat_idx=coef_idx.astype(np.int32),
                    feat_val=coef_val.astype(np.float32), global_dim=global_dim)
    # one record-row per entity: the single active sample IS the
    # coefficient vector in the entity's local space
    sd = per_host_re_dataset(rows, ctx, num_processes, process_id, num_buckets=num_buckets,
                             slab_build_only=True)
    x_d, r_d = sd.x.cpu().numpy(), sd.row_index.cpu().numpy()
    has = (r_d >= 0).any(axis=1)
    first = np.argmax(r_d >= 0, axis=1)
    w_d = np.where(has[:, None], np.take_along_axis(x_d, first[:, None, None], axis=1)[:, 0, :],
                   0.0).astype(np.float32)
    return sd, torch.from_numpy(w_d).to(ctx.device)


# ---------------------------------------------------------------------------
# per-host file-partition bookkeeping shared by the multihost drivers
# ---------------------------------------------------------------------------


def host_file_share(all_files: Sequence[str], num_processes: int,
                    process_id: int) -> List[Tuple[str, int]]:
    """Deterministic round-robin (file, global ordinal) share for this host."""
    return [(f, i) for i, f in enumerate(all_files) if i % num_processes == process_id]


def global_row_layout(num_files: int, decoded, ctx: MeshContext,
                      num_processes: int) -> Tuple[np.ndarray, int]:
    """(file_base, n_global): dense global row ids = exclusive prefix over
    per-file counts, agreed collectively. ``decoded`` is [(ordinal, obj
    with num_rows)]."""
    counts = np.zeros(num_files, np.int64)
    for ordinal, gd in decoded:
        counts[ordinal] = gd.num_rows
    g_counts = collective_sum(counts, ctx, num_processes)
    return np.concatenate([[0], np.cumsum(g_counts)[:-1]]).astype(np.int64), int(g_counts.sum())


def merge_row_vectors(decoded, file_base: np.ndarray, n_global: int, ctx: MeshContext,
                      num_processes: int, vec_per_gd) -> np.ndarray:
    """Replicated (n_global,) vector from per-host row values: each host
    scatters its rows into zeros, one collective sum merges (every row is
    written by one host, so the sum is exact)."""
    local = np.zeros(n_global, np.float32)
    for ordinal, gd in decoded:
        local[file_base[ordinal] + np.arange(gd.num_rows)] = vec_per_gd(gd)
    return collective_sum(local, ctx, num_processes)


def merge_group_ids(gds, file_base, n_rows, id_name, ctx, num_processes: int) -> np.ndarray:
    """Globally consistent dense group ids for grouped evaluators: each
    host hashes ITS rows' raw ids, the (hi, lo) int32 halves merge exactly
    with one collective sum each, and every host ranks the identical keys."""
    hi_l = np.zeros(n_rows, np.int32)
    lo_l = np.zeros(n_rows, np.int32)
    for ordinal, gd in gds:
        vocab = gd.id_vocabs[id_name]
        hi, lo = _pack_u64(stable_entity_keys([vocab[i] for i in gd.ids[id_name]]))
        ids = file_base[ordinal] + np.arange(gd.num_rows)
        hi_l[ids] = hi
        lo_l[ids] = lo
    hi_g = collective_sum(hi_l, ctx, num_processes).astype(np.int32)
    lo_g = collective_sum(lo_l, ctx, num_processes).astype(np.int32)
    _, dense = np.unique(_unpack_u64(hi_g, lo_g), return_inverse=True)
    return dense.astype(np.int32)
