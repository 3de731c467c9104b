"""GAME / GLM model persistence in the reference's on-disk layout (port of
photon_ml_tpu/io/model_io.py).

Reference spec: avro/model/ModelProcessingUtils.scala:40-148 —

  outputDir/fixed-effect/<coordinateName>/id-info            (text: ids)
  outputDir/fixed-effect/<coordinateName>/coefficients/part-00000.avro
  outputDir/random-effect/<coordinateName>/id-info
  outputDir/random-effect/<coordinateName>/coefficients/part-*.avro

A factored random effect also keeps its latent structure beside the
flattened coefficients: ``latent-factors/`` and ``latent-matrix/``
(LatentFactorAvro, AvroUtils.scala:244-266), the word ``factored`` on the
third line of ``id-info`` and the matrix columns' feature keys in
``latent-matrix-features`` (JSON). A matrix-factorization model is two
directories of LatentFactorAvro (ModelProcessingUtils.scala:251-311).

Coefficients are BayesianLinearModelAvro records whose means/variances are
NameTermValueAvro (feature name/term -> value); per-entity models use
modelId = raw entity id. The feature name/term strings come from an
IndexMap (feature key = "name\\x01term").
"""

from __future__ import annotations

import json
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


# ---------------------------------------------------------------------------
# latent factors (LatentFactorAvro part files of {effectId, latentFactor})
# ---------------------------------------------------------------------------

LATENT_FACTORS = "latent-factors"
LATENT_MATRIX = "latent-matrix"
LATENT_MATRIX_FEATURES = "latent-matrix-features"


def save_latent_factors(path: str, factors: Dict[str, np.ndarray],
                        num_files: int = 1) -> None:
    """Write {effectId -> latent vector} as LatentFactorAvro part files,
    the ids in sorted order dealt round-robin over ``num_files``."""
    os.makedirs(path, exist_ok=True)
    shards: List[List[dict]] = [[] for _ in range(max(num_files, 1))]
    for i, (eid, vec) in enumerate(sorted(factors.items())):
        shards[i % len(shards)].append(
            {"effectId": str(eid), "latentFactor": [float(v) for v in np.asarray(vec)]}
        )
    for i, recs in enumerate(shards):
        avro_io.write_container(
            os.path.join(path, f"part-{i:05d}.avro"), recs, schemas.LATENT_FACTOR
        )


def load_latent_factors(path: str) -> Dict[str, np.ndarray]:
    return {rec["effectId"]: np.asarray(rec["latentFactor"], np.float64)
            for rec in avro_io.read_directory(path)}


def save_matrix_factorization(output_dir: str, row_effect_type: str, col_effect_type: str,
                              row_factors: Dict[str, np.ndarray],
                              col_factors: Dict[str, np.ndarray], num_files: int = 1) -> None:
    """MatrixFactorizationModel's layout (ModelProcessingUtils.scala:251-272):
    ``<rowEffectType>/`` and ``<colEffectType>/`` of LatentFactorAvro files."""
    save_latent_factors(os.path.join(output_dir, row_effect_type), row_factors, num_files)
    save_latent_factors(os.path.join(output_dir, col_effect_type), col_factors, num_files)


def load_matrix_factorization(input_dir: str, row_effect_type: str, col_effect_type: str
                              ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """ModelProcessingUtils.scala:291-311 (a missing directory raises)."""
    row_path = os.path.join(input_dir, row_effect_type)
    col_path = os.path.join(input_dir, col_effect_type)
    for p in (row_path, col_path):
        if not os.path.isdir(p):
            raise FileNotFoundError(f"latent factor directory not found: {p}")
    return load_latent_factors(row_path), load_latent_factors(col_path)


def save_factored_random_effect(
    output_dir: str,
    name: str,
    entity_factors: Dict[str, np.ndarray],  # raw entity id -> (k,) latent coefficients
    matrix: np.ndarray,  # (k, D_global) latent matrix
    random_effect_id: str = "",
    feature_shard_id: str = "",
    num_files: int = 1,
    index_map: Optional[IndexMap] = None,
) -> None:
    """A factored random effect's latent structure: the per-entity latent
    coefficients (effectId = raw entity id), the matrix (one record a
    latent dimension, effectId = its index) and, with ``index_map``, the
    feature key of every matrix column, so a run with another index map
    realigns the columns by name. Loads back to the same state."""
    base = os.path.join(output_dir, RANDOM_EFFECT, name)
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, ID_INFO), "w") as f:
        f.write(f"{random_effect_id}\n{feature_shard_id}\nfactored\n")
    save_latent_factors(os.path.join(base, LATENT_FACTORS), entity_factors, num_files)
    matrix = np.asarray(matrix)
    save_latent_factors(os.path.join(base, LATENT_MATRIX),
                        {str(k): matrix[k] for k in range(matrix.shape[0])})
    if index_map is not None:
        # JSON, since feature names and terms may hold tabs and newlines
        pairs = [list(_split_key(index_map.get_feature_name(j) or str(j)))
                 for j in range(matrix.shape[1])]
        with open(os.path.join(base, LATENT_MATRIX_FEATURES), "w") as f:
            json.dump({"columns": pairs}, f)


def _latent_matrix(base: str) -> np.ndarray:
    rows = load_latent_factors(os.path.join(base, LATENT_MATRIX))
    return np.stack([rows[str(k)] for k in range(len(rows))])


def load_latent_matrix(input_dir: str, name: str) -> np.ndarray:
    """Only the shared (k, D) latent matrix."""
    return _latent_matrix(os.path.join(input_dir, RANDOM_EFFECT, name))


def load_factored_random_effect(input_dir: str, name: str
                                ) -> Tuple[Dict[str, np.ndarray], np.ndarray, str, str]:
    """(entity latent factors, (k, D_global) matrix, reId, shard)."""
    base = os.path.join(input_dir, RANDOM_EFFECT, name)
    with open(os.path.join(base, ID_INFO)) as f:
        lines = f.read().splitlines()
    re_id = lines[0] if lines else ""
    shard = lines[1] if len(lines) > 1 else ""
    factors = load_latent_factors(os.path.join(base, LATENT_FACTORS))
    return factors, _latent_matrix(base), re_id, shard


def load_latent_matrix_feature_keys(input_dir: str, name: str) -> Optional[List[str]]:
    """The training-order feature keys of the matrix columns, or None for a
    model without the binding file. Lines of a name and a term split by a tab, the
    binding's earlier format, still load."""
    path = os.path.join(input_dir, RANDOM_EFFECT, name, LATENT_MATRIX_FEATURES)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        text = f.read()
    try:
        pairs = json.loads(text)["columns"]
    except json.JSONDecodeError:
        pairs = [line.partition("\t")[::2] for line in text.splitlines() if line]
    # always the delimiter form: a termless key is "name\x01", not "name"
    return [f"{nm}{DELIMITER}{term}" for nm, term in pairs]


def is_factored_random_effect(input_dir: str, name: str) -> bool:
    """Whether ``random-effect/<name>`` holds a factored model (its id-info
    says so on a third line)."""
    info = os.path.join(input_dir, RANDOM_EFFECT, name, ID_INFO)
    if not os.path.isfile(info):
        return False
    with open(info) as f:
        lines = f.read().splitlines()
    return len(lines) > 2 and lines[2] == "factored"


def aligned_latent_matrix(input_dir: str, name: str, index_map: IndexMap,
                          matrix: np.ndarray, warn=None) -> np.ndarray:
    """A factored model's (k, D_train) matrix with its columns moved to this
    run's index map by feature name (the columns are positions in the
    training feature space). A model without the binding file is taken
    positionally when the widths agree (with a warning) and raises when
    they do not."""
    train_keys = load_latent_matrix_feature_keys(input_dir, name)
    if train_keys is None:
        if len(index_map) != matrix.shape[1]:
            raise ValueError(
                f"factored model {name!r} predates the latent-matrix feature binding "
                f"and this run's index map has {len(index_map)} features vs the "
                f"matrix's {matrix.shape[1]} columns — cannot align; rebuild the "
                "model or pass the training offheap index maps"
            )
        if warn is not None:
            warn(
                f"factored model {name!r} has no latent-matrix feature binding: "
                "assuming this run's index map matches the training map "
                "positionally (same size only proves length, not order) — scores "
                "are wrong if the feature sets differ; rebuild the model to get the "
                "binding"
            )
        return matrix.astype(np.float32)
    aligned = np.zeros((matrix.shape[0], len(index_map)), np.float32)
    for j, key in enumerate(train_keys):
        tgt = index_map.get_index(key)
        if tgt < 0 and key.endswith(DELIMITER):
            # the empty-term fallback, e.g. (INTERCEPT) stored without a delimiter
            tgt = index_map.get_index(key[: -len(DELIMITER)])
        if tgt >= 0:
            aligned[:, tgt] = matrix[:, j]
    return aligned


def list_game_model(input_dir: str) -> Dict[str, List[str]]:
    """Enumerate coordinate names present in a saved GAME model dir."""
    out = {FIXED_EFFECT: [], RANDOM_EFFECT: []}
    for kind in (FIXED_EFFECT, RANDOM_EFFECT):
        d = os.path.join(input_dir, kind)
        if os.path.isdir(d):
            out[kind] = sorted(os.listdir(d))
    return out
