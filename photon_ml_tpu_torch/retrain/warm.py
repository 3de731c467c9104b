"""Warm-start coefficient builders from a saved GAME model (port of
photon_ml_tpu/retrain/warm.py, the same module).

The saved model (io/model_io, the reference Avro layout) holds per-entity
coefficient rows in the global feature space, keyed by raw entity id and
feature name: the only representation stable across runs (dense vocab ids
and local projection spaces belong to one run). These builders gather the
rows back into each coordinate's solve space, as numpy arrays the driver
moves to its device:

  * fixed effect: a (D,) vector aligned to the current index map by name;
  * in-memory random effect: an (E, D_loc) stack gathered through the new
    dataset's per-entity ``local_to_global`` projection;
  * bucketed random effect: one such stack per bucket;
  * streaming random effect: a seeded
    :class:`~photon_ml_tpu_torch.algorithm.streaming_random_effect.SpilledREState`
    (one ``coefs-*.npy`` per block).

Exactness: export writes each float32 coefficient as a double and the
reload narrows it back (an exact round trip), and the local->global scatter
writes disjoint positions per entity, so gathering back through the same
``local_to_global`` reproduces the prior local coefficients bitwise for any
entity whose projection is unchanged. That is what lets an unchanged block
skip its solve and still export bitwise-identical rows.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.data.game import _np_real
from photon_ml_tpu_torch.io import model_io

__all__ = [
    "bucketed_random_effect_init",
    "dense_random_effect_init",
    "fixed_effect_init",
    "random_effect_entity_means",
    "seed_perhost_spilled_state",
    "seed_spilled_state",
]


def fixed_effect_init(model_dir: str, name: str, index_map) -> Optional[np.ndarray]:
    """The prior fixed-effect vector aligned to the current index map by
    feature name (new features start at 0; dropped features drop), or None
    when the prior model has no such coordinate."""
    base = os.path.join(model_dir, model_io.FIXED_EFFECT, name)
    if not os.path.isdir(base):
        return None
    means, _, _, _ = model_io.load_fixed_effect(model_dir, name, index_map)
    return np.asarray(means, _np_real())


def random_effect_entity_means(model_dir: str, name: str, index_map
                               ) -> Optional[Dict[str, np.ndarray]]:
    """Prior per-entity global-space rows keyed by raw entity id, aligned to
    the current index map by name; None when the coordinate is absent or
    factored (latent state does not round-trip through dense rows, so a
    factored coordinate retrains cold)."""
    base = os.path.join(model_dir, model_io.RANDOM_EFFECT, name)
    if not os.path.isdir(base):
        return None
    if model_io.is_factored_random_effect(model_dir, name):
        return None
    means, _, _, _ = model_io.load_random_effect(model_dir, name, index_map)
    return {k: np.asarray(v, _np_real()) for k, v in means.items()}


def _gather_local(row_global: np.ndarray, local_to_global: np.ndarray) -> np.ndarray:
    """One entity's global-space row gathered into its local solve space
    (-1 projection slots stay 0)."""
    valid = local_to_global >= 0
    out = np.zeros(local_to_global.shape, row_global.dtype)
    out[valid] = row_global[local_to_global[valid]]
    return out


def dense_random_effect_init(entity_means: Dict[str, np.ndarray], *, vocab: List[str],
                             pos_of_vocab: np.ndarray, local_to_global: np.ndarray) -> np.ndarray:
    """(E, D_loc) warm stack for an in-memory random-effect coordinate:
    every entity with a prior row gathers it through its own projection;
    entities new to the model start at 0 (the cold init)."""
    w = np.zeros(local_to_global.shape, _np_real())
    for vi, raw in enumerate(vocab):
        p = int(pos_of_vocab[vi])
        if p >= 0 and raw in entity_means:
            w[p] = _gather_local(entity_means[raw].astype(_np_real()), local_to_global[p])
    return w


def bucketed_random_effect_init(entity_means: Dict[str, np.ndarray], bundle) -> List[np.ndarray]:
    """Per-bucket warm stacks for a bucketed random-effect coordinate, one
    ``(E_b, D_loc)`` array per bucket of a ``BucketedDatasetBundle``, shaped
    as ``initial_coefficients()`` (ladder padding included; padded rows stay
    0). Each bucket walks its layout as the export does: bucket rows map
    dense bucket-local ids to tensor positions, dense ids map back to the
    run's vocab, and each placed entity gathers its prior global row through
    its own ``local_to_global``, so an unchanged entity's local coefficients
    come back bitwise."""
    stacks: List[np.ndarray] = []
    for entity_ids, ds, dense_ids in zip(bundle.buckets, bundle.datasets, bundle.dense_ids):
        # ladder-canonicalized buckets pad entity_pos with -1 rows beyond
        # the real rows dense_ids covers: slice to match
        entity_pos = ds.entity_pos.cpu().numpy()[: len(dense_ids)]
        known = entity_pos >= 0
        pos_of_dense = np.full(len(entity_ids), -1, np.int32)
        pos_of_dense[dense_ids[known]] = entity_pos[known]
        local_to_global = ds.local_to_global.cpu().numpy()
        w = np.zeros((int(ds.num_entities), int(ds.local_dim)), _np_real())
        for d, vi in enumerate(entity_ids):
            p = int(pos_of_dense[d])
            if p < 0:
                continue
            raw = bundle.vocab[int(vi)]
            if raw in entity_means:
                w[p] = _gather_local(entity_means[raw].astype(_np_real()), local_to_global[p])
        stacks.append(w)
    return stacks


def seed_perhost_spilled_state(manifest, entity_means: Dict[str, np.ndarray], state_dir: str):
    """The multi-host twin of :func:`seed_spilled_state` (per-host owned
    blocks, files keyed by global block id)."""
    raise NotImplementedError(
        "seed_perhost_spilled_state (multi-host streaming state) is not yet "
        "ported to photon_ml_tpu_torch")


def seed_spilled_state(manifest, entity_means: Dict[str, np.ndarray], state_dir: str):
    """A ``SpilledREState`` under ``state_dir`` seeded from the prior model,
    one ``coefs-*.npy`` per block of ``manifest`` (block bookkeeping only:
    no data slab is read). Blocks whose every entity carries a prior row
    (the unchanged blocks) hold the prior coefficients bitwise; untouched
    blocks stay unwritten, which the state serves as zeros."""
    from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
        SpilledREState,
        _positions_of_dense,
    )

    shapes = [(b["num_entities"], b["local_dim"]) for b in manifest.blocks]
    state = SpilledREState(dir=state_dir, shapes=shapes)
    for i in range(len(manifest.blocks)):
        meta = manifest.load_block_meta(i, "cpu")
        pos_of_dense = _positions_of_dense(meta)
        local_to_global = meta.local_to_global.numpy()
        w = np.zeros(shapes[i], _np_real())
        touched = False
        for j, vi in enumerate(meta.entity_ids):
            raw = manifest.vocab[vi]
            p = int(pos_of_dense[j])
            if p >= 0 and raw in entity_means:
                w[p] = _gather_local(entity_means[raw].astype(_np_real()), local_to_global[p])
                touched = True
        if touched:
            state.write(i, w)
    return state
