"""GAME scoring driver on the card: load a saved GAME model, score data,
save and evaluate (port of photon_ml_tpu/cli/game_scoring_driver.py).

Reference spec: cli/game/scoring/Driver.scala:50-241 — prepare feature maps,
load GAME data (response optional), load the model from its on-disk layout
(ModelProcessingUtils.loadGameModelFromHDFS), total score = sum of
coordinate scores + offset (GAMEModel.scala:92-94), save ScoringResultAvro
shards (:142-162), evaluate per requested evaluator (:222-236).

Scoring runs on ``--device`` (default cuda): a fixed effect is one
padded-COO matvec; a random effect stacks the per-entity models into an
``(E, D)`` slab and gathers each row's coefficients by entity position
(rows whose entity has no model score 0, RandomEffectModel.scala:129-158).
A factored random effect scores from its latent structure (the (E, k)
factors and the (k, D) matrix, realigned by feature name to this run's
index map), never flattened to (E, D). ``--host-scoring true`` scores with
numpy on the host instead, from the flattened coefficients every model
keeps: the device path's parity oracle.

    python -m photon_ml_tpu_torch.cli.game_scoring_driver \\
      --input-dirs data/val --game-model-input-dir out/best --output-dir scores \\
      --feature-shard-id-to-feature-section-keys-map "global:features|per_user:userFeatures" \\
      --evaluator-type AUC
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.cli.game_params import GameScoringParams, parse_scoring_params
from photon_ml_tpu_torch.cli.game_training_driver import (
    _input_files,
    io_resilience_config,
    resolve_date_range_dirs,
)
from photon_ml_tpu_torch.data.game import padded_row_coo
from photon_ml_tpu_torch.device import enable_determinism, resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import evaluator_for
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_data, model_io, schemas
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.offheap import load_shard_index_map
from photon_ml_tpu_torch.models.game import gather_scores
from photon_ml_tpu_torch.ops.fused_sparse import tree_row_sum
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer

SCORES_DIR = "scores"


def padded_coo(feats, device):
    """CSR -> the (N, K) padded-COO index and value tensors on ``device``;
    pad slots carry index 0 and value 0, so a gather through them adds 0."""
    cols, vals = padded_row_coo(feats, pad_col=0)
    return torch.from_numpy(cols).to(device), torch.from_numpy(vals).to(device)


def fixed_contrib(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """score_n = sum_k vals_nk * w[idx_nk], the K terms summed by
    ``tree_row_sum`` (as ``models.game.gather_scores`` sums them): a row's
    bits do not follow the row count or a zero-padded K."""
    return tree_row_sum(w[idx] * vals)


def factored_contrib(latent: torch.Tensor, matrix: torch.Tensor, ent_pos: torch.Tensor,
                     idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """score_n = (sum_k vals_nk * M[:, idx_nk]) . latent[ent_pos_n]; a row
    with ent_pos -1 scores 0 (FactoredRandomEffectCoordinate.score over a
    saved model). Both sums go through ``tree_row_sum``."""
    xp = tree_row_sum((matrix.T[idx] * vals[:, :, None]).transpose(1, 2))  # (N, k)
    contrib = tree_row_sum(xp * latent[torch.clamp_min(ent_pos, 0)])
    return torch.where(ent_pos >= 0, contrib, torch.zeros_like(contrib))


def entity_positions(vocab, by_raw_id, ids, fallback_width):
    """Stack the per-entity vectors present in ``by_raw_id`` and map each
    data row's vocab id to its stack position (-1 = no model, scores 0 —
    RandomEffectModel.scala:129-158 semantics)."""
    pos = np.full(len(vocab), -1, np.int32)
    rows = []
    for vi, raw in enumerate(vocab):
        vec = by_raw_id.get(raw)
        if vec is not None:
            pos[vi] = len(rows)
            rows.append(vec)
    stacked = (np.stack(rows).astype(np.float32) if rows
               else np.zeros((1, fallback_width), np.float32))
    ent_pos = np.where(ids >= 0, pos[np.maximum(ids, 0)], -1).astype(np.int32)
    return stacked, ent_pos, len(rows)


class GameScoringDriver:
    def __init__(self, params: GameScoringParams, logger: Optional[PhotonLogger] = None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
        self.host_scoring = params.host_scoring
        self._own_logger = logger is None
        self.logger = logger or PhotonLogger(
            os.path.join(params.output_dir, "photon-ml-tpu-scoring.log")
        )
        self.timer = Timer(self.logger.info)
        self.shard_index_maps: Dict[str, IndexMap] = {}
        self.data = None
        self.scores: Optional[np.ndarray] = None
        self.metrics: Dict[str, float] = {}
        # resolved once (date-range expansion walks the daily tree)
        self._input_paths: Optional[List[str]] = None

    def _resolved_input_paths(self) -> List[str]:
        if self._input_paths is None:
            p = self.params
            self._input_paths = _input_files(
                resolve_date_range_dirs(p.input_dirs, p.date_range, p.date_range_days_ago)
            )
        return self._input_paths

    # ------------------------------------------------------------------
    def _load_model_layout(self):
        """Discover coordinates and their shard/id bindings from the model dir."""
        layout = model_io.list_game_model(self.params.game_model_input_dir)
        fixed, random = [], []
        for name in layout[model_io.FIXED_EFFECT]:
            base = os.path.join(self.params.game_model_input_dir, model_io.FIXED_EFFECT, name)
            with open(os.path.join(base, model_io.ID_INFO)) as f:
                shard = f.read().strip()
            fixed.append((name, shard))
        for name in layout[model_io.RANDOM_EFFECT]:
            base = os.path.join(self.params.game_model_input_dir, model_io.RANDOM_EFFECT, name)
            with open(os.path.join(base, model_io.ID_INFO)) as f:
                lines = f.read().splitlines()
            re_id = lines[0] if lines else ""
            shard = lines[1] if len(lines) > 1 else ""
            random.append((name, re_id, shard))
        return fixed, random

    def _prepare_feature_maps(self, shards: List[str]) -> None:
        p = self.params
        scanned = {}
        if shards and not p.offheap_indexmap_dir:
            # one read of the input files gives every shard's vocabulary
            scanned = avro_data.collect_shard_feature_keys(
                self._resolved_input_paths(),
                {shard: p.feature_shard_sections.get(shard) or ["features"] for shard in shards})
        for shard in shards:
            if p.offheap_indexmap_dir:
                self.shard_index_maps[shard] = load_shard_index_map(p.offheap_indexmap_dir, shard)
            else:
                add_intercept = p.feature_shard_intercepts.get(shard, True)
                self.shard_index_maps[shard] = IndexMap.build(scanned[shard], add_intercept)

    # ------------------------------------------------------------------
    def run(self) -> None:
        p = self.params
        with resilience.resilience_scope(io_resilience_config(
                p.on_corrupt, p.corrupt_skip_budget, p.io_retries)):
            self._run()

    def _run(self) -> None:
        p = self.params
        prepare_output_dir(p.output_dir, p.delete_output_dir_if_exists)
        try:
            fixed, random = self._load_model_layout()
            shards = sorted({s for _, s in fixed if s} | {s for _, _, s in random if s})
            with avro_data.reuse_parses():  # the scan's parses feed the read
                with self.timer.measure("prepare-feature-maps"):
                    self._prepare_feature_maps(shards)
                id_types = sorted(set(p.random_effect_id_types)
                                  | {rid for _, rid, _ in random if rid})
                with self.timer.measure("read-data"):
                    self.data = avro_data.read_game_data(
                        self._resolved_input_paths(),
                        self.shard_index_maps,
                        p.feature_shard_sections,
                        id_types,
                        shard_intercepts=p.feature_shard_intercepts or None,
                        # evaluators need labels; pure inference reads tolerate nulls
                        response_required=bool(p.evaluators),
                    )
            self.logger.info(f"scoring {self.data.num_rows} rows")
            with self.timer.measure("score"):
                if self.host_scoring:
                    total = self._score_host(self.data, fixed, random)
                else:
                    total = self._score_device(self.data, fixed, random)
            self.scores = np.asarray(total, np.float32)
            with self.timer.measure("save"):
                self._save_scores(self.data)
            with self.timer.measure("evaluate"):
                self._evaluate(self.data)
            self.logger.info(self.timer.summary())
        finally:
            if self._own_logger:
                self.logger.close()

    # ------------------------------------------------------------------
    def _score_device(self, data, fixed, random) -> np.ndarray:
        """Device scoring: a padded-COO matvec per fixed effect; per random
        effect, the per-entity slab and one gather by entity position."""
        p = self.params
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        total = put(np.asarray(data.offset, np.float32))
        for name, shard in fixed:
            with self.timer.measure("load-model"):
                means, _, _, _ = model_io.load_fixed_effect(
                    p.game_model_input_dir, name, self.shard_index_maps[shard])
            idx, vals = padded_coo(data.shards[shard], self.device)
            total = total + fixed_contrib(put(means), idx, vals)
            self.logger.info(f"fixed effect {name!r} applied (device)")
        for name, re_id, shard in random:
            vocab = data.id_vocabs[re_id]
            idx, vals = padded_coo(data.shards[shard], self.device)
            if model_io.is_factored_random_effect(p.game_model_input_dir, name):
                # latent-native: the matrix columns are positions in the
                # training feature space, realigned by name to this run's map
                with self.timer.measure("load-model"):
                    factors, matrix, _, _ = model_io.load_factored_random_effect(
                        p.game_model_input_dir, name)
                    matrix = model_io.aligned_latent_matrix(
                        p.game_model_input_dir, name, self.shard_index_maps[shard], matrix,
                        warn=self.logger.warn)
                latent, ent_pos, matched = entity_positions(
                    vocab, factors, data.ids[re_id], matrix.shape[0])
                total = total + factored_contrib(put(latent), put(matrix), put(ent_pos),
                                                 idx, vals)
                self.logger.info(f"factored random effect {name!r}: {matched}/{len(vocab)} "
                                 "entities matched (device, latent-native)")
                continue
            with self.timer.measure("load-model"):
                entity_means, _, _, _ = model_io.load_random_effect(
                    p.game_model_input_dir, name, self.shard_index_maps[shard])
            slab, ent_pos, matched = entity_positions(
                vocab, entity_means, data.ids[re_id], data.shards[shard].dim)
            total = total + gather_scores(put(slab), put(ent_pos), idx, vals)
            self.logger.info(
                f"random effect {name!r}: {matched}/{len(vocab)} entities matched (device)")
        return total.cpu().numpy()

    def _score_host(self, data, fixed, random) -> np.ndarray:
        """Reference-style host scoring (the parity oracle for the device
        path; never materializes an (entities x features) matrix)."""
        p = self.params
        total = np.asarray(data.offset, np.float64).copy()
        for name, shard in fixed:
            means, _, _, _ = model_io.load_fixed_effect(
                p.game_model_input_dir, name, self.shard_index_maps[shard]
            )
            feats = data.shards[shard]
            contrib = np.zeros(data.num_rows)
            nnz_rows = np.repeat(np.arange(data.num_rows), np.diff(feats.indptr))
            np.add.at(contrib, nnz_rows, means[feats.indices] * feats.values)
            total += contrib
            self.logger.info(f"fixed effect {name!r} applied")

        for name, re_id, shard in random:
            entity_means, _, _, _ = model_io.load_random_effect(
                p.game_model_input_dir, name, self.shard_index_maps[shard]
            )
            feats = data.shards[shard]
            vocab = data.id_vocabs[re_id]
            contrib = np.zeros(data.num_rows)
            nnz_rows = np.repeat(np.arange(data.num_rows), np.diff(feats.indptr))
            ent_of_nnz = data.ids[re_id][nnz_rows]
            order = np.argsort(ent_of_nnz, kind="stable")
            sorted_ent = ent_of_nnz[order]
            bounds = np.searchsorted(sorted_ent, np.arange(len(vocab) + 1), side="left")
            matched = 0
            for vi, raw in enumerate(vocab):
                w_row = entity_means.get(raw)
                if w_row is None:
                    continue  # rows of this entity score 0 (:129-158)
                matched += 1
                sel = order[bounds[vi]:bounds[vi + 1]]
                np.add.at(contrib, nnz_rows[sel], w_row[feats.indices[sel]] * feats.values[sel])
            total += contrib
            self.logger.info(f"random effect {name!r}: {matched}/{len(vocab)} entities matched")
        return total

    # ------------------------------------------------------------------
    def _save_scores(self, data) -> None:
        p = self.params
        out = os.path.join(p.output_dir, SCORES_DIR)
        os.makedirs(out, exist_ok=True)
        n = data.num_rows
        shards = max(p.num_output_files_for_scores, 1)
        per = (n + shards - 1) // shards

        for i in range(shards):
            lo, hi = i * per, min((i + 1) * per, n)

            def records(lo=lo, hi=hi):
                for r in range(lo, hi):
                    label = float(data.response[r])
                    yield {
                        "uid": str(r),
                        "label": None if np.isnan(label) else label,
                        "modelId": p.game_model_id,
                        "predictionScore": float(self.scores[r]),
                        "weight": float(data.weight[r]),
                        "metadataMap": None,
                    }

            avro_io.write_container(
                os.path.join(out, f"part-{i:05d}.avro"), records(), schemas.SCORING_RESULT)
        self.logger.info(f"wrote scores to {out}")

    def _evaluate(self, data) -> None:
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        labels, weights, scores = put(data.response), put(data.weight), put(self.scores)
        for etype, k, id_name in self.params.evaluators:
            ev = evaluator_for(etype, k or 10)
            kwargs = {"labels": labels, "weights": weights}
            if id_name is not None:
                kwargs["group_ids"] = put(data.ids[id_name])
            key = etype.value if k is None else f"{etype.value}@{k}"
            self.metrics[key] = float(ev.evaluate(scores, **kwargs))
            self.logger.info(f"{key}: {self.metrics[key]:.6g}")


def main(argv: Optional[List[str]] = None) -> GameScoringDriver:
    enable_determinism()
    driver = GameScoringDriver(parse_scoring_params(argv))
    # scoring restarts from scratch (no descent state): a cooperative
    # preemption here is a clean exit with the preemption code
    with preemption.signal_scope():
        try:
            driver.run()
        except preemption.Preempted as e:
            print(f"photon-ml-tpu-torch game-scoring: preempted ({e}); exiting "
                  f"{preemption.PREEMPT_EXIT_CODE}", file=sys.stderr)
            raise SystemExit(preemption.PREEMPT_EXIT_CODE) from e
    return driver


if __name__ == "__main__":
    main()
