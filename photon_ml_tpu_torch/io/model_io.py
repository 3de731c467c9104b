"""GAME / GLM model persistence in the reference's on-disk layout (port of
the fixed- and random-effect part of photon_ml_tpu/io/model_io.py; the
factored and matrix-factorization layouts are not yet ported).

Reference spec: avro/model/ModelProcessingUtils.scala:40-148 —

  outputDir/fixed-effect/<coordinateName>/id-info            (text: ids)
  outputDir/fixed-effect/<coordinateName>/coefficients/part-00000.avro
  outputDir/random-effect/<coordinateName>/id-info
  outputDir/random-effect/<coordinateName>/coefficients/part-*.avro

Coefficients are BayesianLinearModelAvro records whose means/variances are
NameTermValueAvro (feature name/term -> value); per-entity models use
modelId = raw entity id. The feature name/term strings come from an
IndexMap (feature key = "name\\x01term").
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.types import TaskType

FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"


def _split_key(key: str) -> Tuple[str, str]:
    if DELIMITER in key:
        name, term = key.split(DELIMITER, 1)
        return name, term
    return key, ""


def _coeff_records(means: np.ndarray, variances: Optional[np.ndarray],
                   index_map: IndexMap) -> Tuple[List[dict], Optional[List[dict]]]:
    # sparse encoding keeps every index where EITHER the mean or the variance
    # is nonzero (an exactly-zero mean — common under OWL-QN — must not drop
    # its posterior variance)
    nz = np.nonzero(means)[0]
    if variances is not None:
        nz = np.union1d(nz, np.nonzero(variances)[0])
    means_rec = []
    for j in nz:
        name, term = _split_key(index_map.get_feature_name(int(j)) or str(int(j)))
        means_rec.append({"name": name, "term": term, "value": float(means[j])})
    var_rec = None
    if variances is not None:
        var_rec = []
        for j in nz:
            name, term = _split_key(index_map.get_feature_name(int(j)) or str(int(j)))
            var_rec.append({"name": name, "term": term, "value": float(variances[j])})
    return means_rec, var_rec


def _model_record(model_id: str, task: TaskType, means: np.ndarray,
                  variances: Optional[np.ndarray], index_map: IndexMap) -> dict:
    means_rec, var_rec = _coeff_records(means, variances, index_map)
    return {
        "modelId": model_id,
        "modelClass": schemas.MODEL_CLASS_BY_TASK[task.value],
        "means": means_rec,
        "variances": var_rec,
        "lossFunction": None,
    }


def ntv_index(ntv: dict, index_map: IndexMap) -> int:
    """BayesianLinearModelAvro name/term -> feature index, with the bare-name
    fallback for termless keys like (INTERCEPT); -1 when absent."""
    idx = index_map.get_index(f"{ntv['name']}{DELIMITER}{ntv['term']}")
    if idx < 0 and ntv["term"] == "":
        idx = index_map.get_index(ntv["name"])
    return idx


def _record_to_dense(rec: dict, index_map: IndexMap) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    d = len(index_map)

    def lookup(ntv) -> int:
        return ntv_index(ntv, index_map)

    means = np.zeros(d, np.float32)
    for ntv in rec["means"]:
        idx = lookup(ntv)
        if idx >= 0:
            means[idx] = ntv["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(d, np.float32)
        for ntv in rec["variances"]:
            idx = lookup(ntv)
            if idx >= 0:
                variances[idx] = ntv["value"]
    return means, variances


# ---------------------------------------------------------------------------
# fixed effect
# ---------------------------------------------------------------------------


def save_fixed_effect(output_dir: str, name: str, task: TaskType, means: np.ndarray,
                      index_map: IndexMap, variances: Optional[np.ndarray] = None,
                      feature_shard_id: str = "global") -> None:
    base = os.path.join(output_dir, FIXED_EFFECT, name)
    os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
    with open(os.path.join(base, ID_INFO), "w") as f:
        f.write(feature_shard_id + "\n")
    avro_io.write_container(
        os.path.join(base, COEFFICIENTS, "part-00000.avro"),
        [_model_record(name, task, means, variances, index_map)],
        schemas.BAYESIAN_LINEAR_MODEL,
    )


def load_fixed_effect(input_dir: str, name: str, index_map: IndexMap
                      ) -> Tuple[np.ndarray, Optional[np.ndarray], TaskType, str]:
    base = os.path.join(input_dir, FIXED_EFFECT, name)
    with open(os.path.join(base, ID_INFO)) as f:
        shard = f.read().strip()
    recs = list(avro_io.read_directory(os.path.join(base, COEFFICIENTS)))
    rec = recs[0]
    means, variances = _record_to_dense(rec, index_map)
    task = TaskType(schemas.TASK_BY_MODEL_CLASS.get(
        rec.get("modelClass"), "LOGISTIC_REGRESSION"))
    return means, variances, task, shard


# ---------------------------------------------------------------------------
# random effect (per-entity models in original feature space)
# ---------------------------------------------------------------------------


def save_random_effect(
    output_dir: str,
    name: str,
    task: TaskType,
    entity_means: Dict[str, np.ndarray],  # raw entity id -> dense global coeffs
    index_map: IndexMap,
    random_effect_id: str = "",
    feature_shard_id: str = "",
    num_files: int = 1,
    entity_variances: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """(num_files = numberOfOutputFilesForRandomEffectModel parity;
    entity_variances fills the BayesianLinearModelAvro variances list when
    the driver ran with --compute-variance.)"""
    base = os.path.join(output_dir, RANDOM_EFFECT, name)
    os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
    with open(os.path.join(base, ID_INFO), "w") as f:
        f.write(f"{random_effect_id}\n{feature_shard_id}\n")
    items = sorted(entity_means.items())
    shards: List[List[dict]] = [[] for _ in range(max(num_files, 1))]
    for i, (eid, means) in enumerate(items):
        var = entity_variances.get(eid) if entity_variances else None
        shards[i % len(shards)].append(_model_record(eid, task, means, var, index_map))
    for i, recs in enumerate(shards):
        avro_io.write_container(
            os.path.join(base, COEFFICIENTS, f"part-{i:05d}.avro"),
            recs,
            schemas.BAYESIAN_LINEAR_MODEL,
        )


def load_random_effect(
    input_dir: str, name: str, index_map: IndexMap,
    variances_out: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Dict[str, np.ndarray], TaskType, str, str]:
    """Pass ``variances_out`` (a dict) to also collect per-entity variance
    rows for records that carry them."""
    base = os.path.join(input_dir, RANDOM_EFFECT, name)
    with open(os.path.join(base, ID_INFO)) as f:
        lines = f.read().splitlines()
    re_id = lines[0] if lines else ""
    shard = lines[1] if len(lines) > 1 else ""
    out: Dict[str, np.ndarray] = {}
    task = TaskType.LOGISTIC_REGRESSION
    for rec in avro_io.read_directory(os.path.join(base, COEFFICIENTS)):
        means, variances = _record_to_dense(rec, index_map)
        out[rec["modelId"]] = means
        if variances_out is not None and variances is not None:
            variances_out[rec["modelId"]] = variances
        if rec.get("modelClass") in schemas.TASK_BY_MODEL_CLASS:
            task = TaskType(schemas.TASK_BY_MODEL_CLASS[rec["modelClass"]])
    return out, task, re_id, shard


def list_game_model(input_dir: str) -> Dict[str, List[str]]:
    """Enumerate coordinate names present in a saved GAME model dir."""
    out = {FIXED_EFFECT: [], RANDOM_EFFECT: []}
    for kind in (FIXED_EFFECT, RANDOM_EFFECT):
        d = os.path.join(input_dir, kind)
        if os.path.isdir(d):
            out[kind] = sorted(os.listdir(d))
    return out
