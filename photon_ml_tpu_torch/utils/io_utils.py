"""Output-directory management, text model writers and the feature
statistics writer (port of photon_ml_tpu/utils/io_utils.py).

Reference spec: util/IOUtils.scala — writeModelsInText (:207-260, one line per
coefficient ``name\\tterm\\tvalue\\tregWeight`` sorted descending by value),
writeBasicStatistics (:262-322, FeatureSummarizationResultAvro records).
The on-disk layout is the JAX package's, so either package reads the other's
models.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, Tuple

import numpy as np

from photon_ml_tpu_torch.io.avro import write_container
from photon_ml_tpu_torch.io.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.io.schemas import FEATURE_SUMMARIZATION_RESULT
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel


def prepare_output_dir(path: str, delete_if_exists: bool = False) -> None:
    """(Driver --delete-output-dirs-if-exist behavior.)"""
    if os.path.exists(path):
        if delete_if_exists:
            shutil.rmtree(path)
        elif os.listdir(path):
            raise FileExistsError(
                f"output directory {path} exists and is non-empty "
                "(pass delete-output-dirs-if-exist to overwrite)"
            )
    os.makedirs(path, exist_ok=True)


def _split_feature_key(key: str) -> Tuple[str, str]:
    parts = key.split(DELIMITER)
    if len(parts) == 1:
        return parts[0], ""
    if len(parts) == 2:
        return parts[0], parts[1]
    raise IOError(f"unknown name and terms: {key!r}")


def write_models_in_text(
    models: Iterable[Tuple[float, GeneralizedLinearModel]],
    model_dir: str,
    index_map: IndexMap,
) -> None:
    """One ``part-<i>.txt`` per (lambda, model); each line
    ``name\\tterm\\tvalue\\tregWeight``, coefficients sorted descending by value."""
    os.makedirs(model_dir, exist_ok=True)
    for i, (reg_weight, model) in enumerate(models):
        means = model.means_as_numpy()
        lines = []
        for idx in np.argsort(-means, kind="stable"):
            key = index_map.get_feature_name(int(idx))
            if key is None:
                continue
            name, term = _split_feature_key(key)
            lines.append(f"{name}\t{term}\t{means[idx]}\t{reg_weight}")
        with open(os.path.join(model_dir, f"part-{i:05d}.txt"), "w") as f:
            f.write("\n".join(lines))


def read_models_from_text(model_dir: str) -> Dict[float, Dict[Tuple[str, str], float]]:
    """Inverse of write_models_in_text: per reg-weight, (name, term) -> value."""
    out: Dict[float, Dict[Tuple[str, str], float]] = {}
    for fname in sorted(os.listdir(model_dir)):
        if not fname.startswith("part-"):
            continue
        with open(os.path.join(model_dir, fname)) as f:
            for line in f:
                if not line.strip():
                    continue
                name, term, value, lam = line.rstrip("\n").split("\t")
                out.setdefault(float(lam), {})[(name, term)] = float(value)
    return out


def write_basic_statistics(summary, output_dir: str, index_map: IndexMap) -> None:
    """FeatureSummarizationResultAvro records, one per feature, with metrics
    {max, min, mean, normL1, normL2, numNonzeros, variance}, in
    ``<output_dir>/part-00000.avro`` (IOUtils.writeBasicStatistics parity)."""
    os.makedirs(output_dir, exist_ok=True)
    arrays = {
        "max": summary.max,
        "min": summary.min,
        "mean": summary.mean,
        "normL1": summary.norm_l1,
        "normL2": summary.norm_l2,
        "numNonzeros": summary.num_nonzeros,
        "variance": summary.variance,
    }
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    records = []
    for idx in range(len(arrays["mean"])):
        key = index_map.get_feature_name(idx)
        if key is None:
            continue
        name, term = _split_feature_key(key)
        records.append({
            "featureName": name,
            "featureTerm": term,
            "metrics": {k: float(v[idx]) for k, v in arrays.items()},
        })
    write_container(os.path.join(output_dir, "part-00000.avro"), records,
                    FEATURE_SUMMARIZATION_RESULT)
