"""Output-directory management and text model writers (port of
photon_ml_tpu/utils/io_utils.py; the Avro statistics writer is not yet
ported).

Reference spec: util/IOUtils.scala — writeModelsInText (:207-260, one line per
coefficient ``name\\tterm\\tvalue\\tregWeight`` sorted descending by value).
The on-disk layout is the JAX package's, so either package reads the other's
models.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, Tuple

import numpy as np

from photon_ml_tpu_torch.io.index_map import DELIMITER, IndexMap
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
