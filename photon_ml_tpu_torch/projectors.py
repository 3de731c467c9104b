"""Dimensionality projectors for random-effect feature spaces (port of
photon_ml_tpu/projectors.py).

Reference spec: projector/ProjectionMatrix.scala:31-119 (dense Gaussian
random projection: entries ~ N(0, 1)/k clipped to [-1, 1], optional dummy
intercept row selecting the last original column; projectFeatures = M @ x,
projectCoefficients = M.T @ c i.e. projected -> original),
projector/RandomEffectProjector.scala:35-77 (factory over ProjectorType),
model/RandomEffectModelInProjectedSpace.scala:83 (project model coefficients
back for scoring).

The matrix is drawn with numpy from the same seed as the JAX package's, so
the two packages hold the same matrix bit for bit. Rows are projected on the
host (data/game.py builds the dense ``(E, M, k)`` stack from them); the
back-projection of a whole stacked model is one ``(E, k) @ (k, d)`` matmul
on the device. INDEX_MAP lives in data/game.py; IDENTITY is the absence of
projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import ProjectorType, real_dtype

Tensor = torch.Tensor

# MathConst.scala:24
RANDOM_SEED = 1234567890


def _np_real():
    return np.float64 if real_dtype() == torch.float64 else np.float32


def gaussian_random_projection_matrix(
    projected_dim: int,
    original_dim: int,
    keep_intercept: bool = True,
    seed: int = RANDOM_SEED,
) -> np.ndarray:
    """Dense Gaussian random projection matrix, reference semantics.

    Entries are drawn N(0, 1), divided by ``projected_dim`` (the reference
    deliberately uses std = k rather than sqrt(k) to keep magnitudes small,
    ProjectionMatrix.scala:96-99) and clipped to [-1, 1]. With
    ``keep_intercept`` a final row is appended that passes the last original
    column (the intercept) through untouched, so the output has
    ``projected_dim + 1`` rows.
    """
    real = _np_real()
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((projected_dim, original_dim)) / float(projected_dim)
    m = np.clip(m, -1.0, 1.0).astype(real)
    if keep_intercept:
        intercept_row = np.zeros((1, original_dim), real)
        intercept_row[0, original_dim - 1] = 1.0
        m = np.concatenate([m, intercept_row], axis=0)
    return m


@dataclasses.dataclass(frozen=True)
class ProjectionMatrixProjector:
    """One dense projection matrix shared by every entity.

    ``matrix`` has shape (k, d): k = projected-space dim (incl. intercept
    row when kept), d = original-space dim.
    """

    matrix: Tensor  # (k, d)

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[0]

    @property
    def original_dim(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, features: Tensor) -> Tensor:
        """(..., d) -> (..., k)."""
        return features @ self.matrix.T

    def project_sparse_features(
        self, indices: np.ndarray, values: np.ndarray, row_splits: np.ndarray
    ) -> np.ndarray:
        """Host-side CSR rows -> dense projected (N, k) without densifying
        the original d-wide matrix: gather the needed columns of M."""
        mat = self.matrix.detach().cpu().numpy()
        n = len(row_splits) - 1
        out = np.zeros((n, mat.shape[0]), _np_real())
        rows = np.repeat(np.arange(n), np.diff(row_splits))
        contrib = mat[:, indices].T * values[:, None]  # (nnz, k)
        np.add.at(out, rows, contrib)
        return out

    def project_coefficients(self, coefficients: Tensor) -> Tensor:
        """Projected-space coefficients (..., k) -> original space (..., d)
        (RandomEffectModelInProjectedSpace.toRandomEffectModel analogue)."""
        return coefficients @ self.matrix


def build_projector(
    projector_type: ProjectorType,
    original_dim: int,
    projected_dim: Optional[int] = None,
    keep_intercept: bool = True,
    seed: int = RANDOM_SEED,
) -> Optional[ProjectionMatrixProjector]:
    """Factory mirroring RandomEffectProjector.buildRandomEffectProjector
    (projector/RandomEffectProjector.scala:54-77): RANDOM -> Gaussian matrix
    projector (on the host); INDEX_MAP / IDENTITY -> None (handled by the
    random-effect dataset build)."""
    if projector_type == ProjectorType.RANDOM:
        if projected_dim is None:
            raise ValueError("RANDOM projector requires projected_dim")
        m = gaussian_random_projection_matrix(projected_dim, original_dim, keep_intercept, seed)
        return ProjectionMatrixProjector(torch.from_numpy(m))
    return None
