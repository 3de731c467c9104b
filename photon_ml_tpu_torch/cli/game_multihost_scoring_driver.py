"""Multi-process SPMD GAME scoring driver: score datasets against models that
NO single process ever holds (port of
photon_ml_tpu/cli/game_multihost_scoring_driver.py).

Every process runs the same program: it loads only its share of each
random-effect model's part files (ModelProcessingUtils.scala:205-219 layout,
the files the multihost training driver writes), routes each model record
to its entity's owner with the stable-hash shuffle, decodes only its share
of the input rows, routes them to the owners for scoring
(parallel.perhost_ingest.score_routed_rows), and writes the scores part
file of each input file it decoded. The fixed-effect model is small and
replicated (the broadcast analogue). Coefficients stay sharded end to end:
loaded sharded, held sharded, applied sharded.

Factored models score latent-natively: the shared (k, D) matrix is
replicated, each process loads its share of the latent-factor part files,
and rows are projected into the k-dim latent space before routing.

Scope: Avro inputs, prebuilt feature maps (``--offheap-indexmap-dir``).

Run (one process per device):

    python -m photon_ml_tpu_torch.cli.game_multihost_scoring_driver \\
        --multihost-coordinator HOST:PORT --multihost-num-processes N \\
        --multihost-process-id I  <game scoring flags...>
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.game_multihost_driver import _add_multihost_flags
from photon_ml_tpu_torch.cli.game_params import parse_scoring_params
from photon_ml_tpu_torch.cli.game_scoring_driver import SCORES_DIR
from photon_ml_tpu_torch.cli.game_training_driver import _input_files, resolve_date_range_dirs
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import model_io, schemas
from photon_ml_tpu_torch.io.avro_data import read_game_data
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.perhost_ingest import (
    HostRows,
    concat_host_rows,
    csr_to_padded,
    global_row_layout,
    host_file_share,
    merge_group_ids,
    merge_row_vectors,
    per_host_model_slabs,
    score_routed_rows,
)
from photon_ml_tpu_torch.parallel.shuffle import collective_sum
from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir
from photon_ml_tpu_torch.utils.logging import PhotonLogger


def _load_re_model_rows(base: str, part_files: List[str], index_map):
    """THIS process's share of one random-effect model's part files as
    sparse per-entity coefficient rows (global indices)."""
    ids: List[str] = []
    idx_rows: List[np.ndarray] = []
    val_rows: List[np.ndarray] = []
    for f in part_files:
        for rec in avro_io.read_container(os.path.join(base, f)):
            cols, vals = [], []
            for ntv in rec["means"]:
                j = model_io.ntv_index(ntv, index_map)
                if j >= 0:
                    cols.append(j)
                    vals.append(ntv["value"])
            ids.append(rec["modelId"])
            idx_rows.append(np.asarray(cols, np.int32))
            val_rows.append(np.asarray(vals, np.float32))
    k = max(max((len(c) for c in idx_rows), default=1), 1)
    fi = np.full((len(ids), k), -1, np.int32)
    fv = np.zeros((len(ids), k), np.float32)
    for i, (c, v) in enumerate(zip(idx_rows, val_rows)):
        fi[i, : len(c)] = c
        fv[i, : len(c)] = v
    return ids, fi, fv


def _rows(gds, file_base, shard, re_id, feats_of, global_dim) -> HostRows:
    parts = []
    for ordinal, gd in gds:
        fi, fv = feats_of(gd.shards[shard], gd.num_rows)
        vocab = gd.id_vocabs[re_id]
        parts.append(HostRows(
            entity_raw_ids=[vocab[i] for i in gd.ids[re_id]],
            row_index=file_base[ordinal] + np.arange(gd.num_rows, dtype=np.int64),
            labels=np.nan_to_num(gd.response).astype(np.float32),
            weights=gd.weight.astype(np.float32), offsets=gd.offset.astype(np.float32),
            feat_idx=fi, feat_val=fv, global_dim=global_dim))
    return concat_host_rows(parts, global_dim)


def main(argv: Optional[List[str]] = None) -> dict:
    """Score this process's share; every process of the job calls it."""
    enable_determinism()
    mh_args, rest = _add_multihost_flags(list(argv) if argv is not None else sys.argv[1:])
    p = parse_scoring_params(rest)
    if not p.offheap_indexmap_dir:
        raise ValueError("multihost scoring needs prebuilt feature maps: pass "
                         "--offheap-indexmap-dir (a full-data vocabulary scan per host "
                         "defeats per-host ingest)")
    mh = multihost.initialize(mh_args["coordinator"], mh_args["num_processes"],
                              mh_args["process_id"], device=p.device)
    try:
        return _score(p, mh)
    finally:
        multihost.shutdown()


def _score(p, mh) -> dict:
    from photon_ml_tpu_torch.io.offheap import load_shard_index_map

    ctx = mh.mesh_context()
    n_proc, pid = mh.num_processes, mh.process_id
    if mh.coordinator_only_io():
        prepare_output_dir(p.output_dir, p.delete_output_dir_if_exists)
    mh.barrier("output-dir")
    logger = PhotonLogger(os.path.join(p.output_dir, f"photon-ml-tpu-mh-scoring-{pid}.log"))

    # ---- model layout ---------------------------------------------------------
    layout = model_io.list_game_model(p.game_model_input_dir)
    fixed, random = [], []
    for name in layout[model_io.FIXED_EFFECT]:
        with open(os.path.join(p.game_model_input_dir, model_io.FIXED_EFFECT, name,
                               model_io.ID_INFO)) as f:
            fixed.append((name, f.read().strip()))
    for name in layout[model_io.RANDOM_EFFECT]:
        with open(os.path.join(p.game_model_input_dir, model_io.RANDOM_EFFECT, name,
                               model_io.ID_INFO)) as f:
            lines = f.read().splitlines()
        random.append((name, lines[0], lines[1] if len(lines) > 1 else "",
                       model_io.is_factored_random_effect(p.game_model_input_dir, name)))
    shards = sorted({s for _, s in fixed if s} | {s for _, _, s, _ in random if s})
    shard_maps = {s: load_shard_index_map(p.offheap_indexmap_dir, s) for s in shards}
    grouped_ids = sorted({idn for _, _, idn in (p.evaluators or []) if idn})
    id_types = sorted(set(p.random_effect_id_types) | {rid for _, rid, _, _ in random if rid}
                      | set(grouped_ids))

    # ---- per-host input decode --------------------------------------------------
    all_files = _input_files(resolve_date_range_dirs(p.input_dirs, p.date_range,
                                                     p.date_range_days_ago))
    host_files = host_file_share(all_files, n_proc, pid)
    gds = [(ordinal, read_game_data(
        [f], shard_maps, p.feature_shard_sections, id_types,
        shard_intercepts=p.feature_shard_intercepts or None,
        # evaluators need labels; pure inference tolerates nulls
        response_required=bool(p.evaluators))) for f, ordinal in host_files]
    file_base, n_global = global_row_layout(len(all_files), gds, ctx, n_proc)
    logger.info(f"host {pid}: scoring {sum(gd.num_rows for _, gd in gds)}/{n_global} rows "
                f"({len(host_files)}/{len(all_files)} files), backend {ctx.backend}")

    def merge(vec_per_gd):
        return merge_row_vectors(gds, file_base, n_global, ctx, n_proc, vec_per_gd)

    scores = merge(lambda gd: gd.offset.astype(np.float32)).astype(np.float64)

    # ---- fixed effects: replicated model, local margins -------------------------
    for name, shard in fixed:
        means, _, _, _ = model_io.load_fixed_effect(p.game_model_input_dir, name,
                                                    shard_maps[shard])
        local = np.zeros(n_global, np.float32)
        for ordinal, gd in gds:
            fi, fv = csr_to_padded(gd.shards[shard], gd.num_rows)
            sel = np.where(fi >= 0, means[np.maximum(fi, 0)], 0.0)
            local[file_base[ordinal] + np.arange(gd.num_rows)] = np.sum(sel * fv, axis=1)
        scores += collective_sum(local, ctx, n_proc)

    # ---- random effects: per-host model parts -> owner blocks -> routing --------
    for name, re_id, shard, factored in random:
        base = os.path.join(p.game_model_input_dir, model_io.RANDOM_EFFECT, name)
        if factored:
            # only the tiny matrix is loaded whole; latent factors per host
            matrix = model_io.load_latent_matrix(p.game_model_input_dir, name)
            aligned = model_io.aligned_latent_matrix(p.game_model_input_dir, name,
                                                     shard_maps[shard], matrix, warn=logger.warn)
            lat_dir = os.path.join(base, model_io.LATENT_FACTORS)
            parts = sorted(f for f in os.listdir(lat_dir) if f.endswith(".avro"))
            mine = [f for f, _ in host_file_share(parts, n_proc, pid)]
            ids, vecs = [], []
            for f in mine:
                for rec in avro_io.read_container(os.path.join(lat_dir, f)):
                    ids.append(rec["effectId"])
                    vecs.append(np.asarray(rec["latentFactor"], np.float32))
            k_lat = matrix.shape[0]
            fv_m = np.stack(vecs) if vecs else np.zeros((0, k_lat), np.float32)
            fi_m = np.tile(np.arange(k_lat, dtype=np.int32), (len(ids), 1))
            logger.info(f"factored effect {name!r}: host {pid} loaded {len(ids)} latent "
                        f"factors ({len(mine)}/{len(parts)} part files)")
            sd, w = per_host_model_slabs(ids, fi_m, fv_m, k_lat, ctx, n_proc, pid)

            def latent_feats(f, n, aligned=aligned, k_lat=k_lat):
                # x M^T one padded column at a time: O(n k) memory
                fi, fv = csr_to_padded(f, n)
                xp = np.zeros((n, aligned.shape[0]), np.float32)
                for j in range(fi.shape[1]):
                    xp += fv[:, j, None] * aligned[:, np.maximum(fi[:, j], 0)].T
                return np.tile(np.arange(k_lat, dtype=np.int32), (n, 1)), xp

            vrows = _rows(gds, file_base, shard, re_id, latent_feats, k_lat)
        else:
            coef_dir = os.path.join(base, model_io.COEFFICIENTS)
            parts = sorted(f for f in os.listdir(coef_dir) if f.endswith(".avro"))
            mine = [f for f, _ in host_file_share(parts, n_proc, pid)]
            ids, fi_m, fv_m = _load_re_model_rows(coef_dir, mine, shard_maps[shard])
            logger.info(f"random effect {name!r}: host {pid} loaded {len(ids)} of the model's "
                        f"entities ({len(mine)}/{len(parts)} part files)")
            sd, w = per_host_model_slabs(ids, fi_m, fv_m, len(shard_maps[shard]), ctx, n_proc,
                                         pid)
            vrows = _rows(gds, file_base, shard, re_id, csr_to_padded, len(shard_maps[shard]))
        scores += score_routed_rows(sd, w, vrows, n_global, ctx, n_proc, pid)
    scores = scores.astype(np.float32)

    # ---- save: each host writes the scores of the files it decoded --------------
    out = os.path.join(p.output_dir, SCORES_DIR)
    if mh.coordinator_only_io():
        os.makedirs(out, exist_ok=True)
    mh.barrier("scores-dir")
    for ordinal, gd in gds:
        base_id = int(file_base[ordinal])

        def records(gd=gd, base_id=base_id):
            for r in range(gd.num_rows):
                label = float(gd.response[r])
                yield {"uid": str(base_id + r), "label": None if np.isnan(label) else label,
                       "modelId": p.game_model_id,
                       "predictionScore": float(scores[base_id + r]),
                       "weight": float(gd.weight[r]), "metadataMap": None}

        avro_io.write_container(os.path.join(out, f"part-{ordinal:05d}.avro"), records(),
                                schemas.SCORING_RESULT)
    mh.barrier("scores-written")

    # ---- evaluators (replicated labels / weights) --------------------------------
    metrics: Dict[str, float] = {}
    if p.evaluators:
        from photon_ml_tpu_torch.evaluation.evaluators import evaluator_for

        labels = torch.from_numpy(merge(lambda gd: gd.response.astype(np.float32)))
        weights = torch.from_numpy(merge(lambda gd: gd.weight.astype(np.float32)))
        group_cols = {idn: torch.from_numpy(merge_group_ids(gds, file_base, n_global, idn, ctx,
                                                            n_proc))
                      for idn in grouped_ids}
        for etype, k, id_name in p.evaluators:
            kwargs = {"labels": labels, "weights": weights}
            if id_name is not None:
                kwargs["group_ids"] = group_cols[id_name]
            key = etype.value if k is None else f"{etype.value}@{k}"
            metrics[key] = float(evaluator_for(etype, k or 10).evaluate(
                torch.from_numpy(scores), **kwargs))
        if mh.coordinator_only_io():
            logger.info("metrics: " + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))
    logger.info(f"wrote scores to {out}")
    logger.close()
    return {"num_rows": n_global, "metrics": metrics, "process_id": pid,
            "num_processes": n_proc, "backend": ctx.backend, "scores_dir": out,
            "scores": scores}


if __name__ == "__main__":
    main()
