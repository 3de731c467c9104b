"""Avro training-data ingest: TrainingExampleAvro -> columnar host datasets
(port of the Python row loop of photon_ml_tpu/io/avro_data.py; the native
columnar decoder is not yet ported).

Reference spec: avro/data/DataProcessingUtils.scala:33-200 — feature key =
"name\\x01term", per-shard sparse vectors with the intercept appended, entity
ids from the record field or else the metadataMap.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.game import GameData, HostFeatures, _np_real
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key


def _iter_records(paths: Sequence[str]) -> Iterable[dict]:
    for p in paths:
        yield from avro_io.read_directory(p)


def collect_feature_keys(paths: Sequence[str],
                         sections: Sequence[str] = ("features",)) -> List[str]:
    """Whole-dataset feature vocabulary of the record fields ``sections``
    (each a FeatureAvro array), sorted."""
    keys = set()
    for rec in _iter_records(paths):
        for section in sections:
            for f in rec.get(section) or []:
                keys.add(feature_key(f["name"], f["term"]))
    return sorted(keys)


def collect_entity_ids(paths: Sequence[str], id_types: Sequence[str]) -> Dict[str, set]:
    """Raw entity-id sets per id type (record field first, then
    metadataMap); a row missing an id type adds nothing to its set."""
    out: Dict[str, set] = {t: set() for t in id_types}
    for rec in _iter_records(paths):
        meta = rec.get("metadataMap") or {}
        for t in id_types:
            if t in rec and rec[t] is not None:
                out[t].add(str(rec[t]))
            elif t in meta:
                out[t].add(meta[t])
    return out


def read_game_data(
    paths: Sequence[str],
    shard_index_maps: Dict[str, IndexMap],
    shard_sections: Dict[str, List[str]],
    id_types: Sequence[str],
    shard_intercepts: Optional[Dict[str, bool]] = None,
    id_vocabs: Optional[Dict[str, List[str]]] = None,
    response_required: bool = True,
) -> GameData:
    """TrainingExampleAvro -> GameData with one feature space per shard.

    A feature belongs to shard s iff its key is in s's index map, looked up
    over s's sections (default ``features``). With ``id_vocabs`` (the
    training vocabularies, for validation reads) an unseen entity maps to -1.
    """
    real = _np_real()
    shard_intercepts = shard_intercepts or {s: True for s in shard_index_maps}
    n = 0
    labels: List[float] = []
    offsets: List[float] = []
    weights: List[float] = []
    raw_ids: Dict[str, List[str]] = {t: [] for t in id_types}
    per_shard: Dict[str, Tuple[List[int], List[int], List[float]]] = {
        s: ([0], [], []) for s in shard_index_maps
    }
    for rec in _iter_records(paths):
        label = rec.get("label", rec.get("response"))
        if label is None:
            if response_required:
                raise ValueError(f"row {n}: label/response missing")
            label = float("nan")
        labels.append(float(label))
        offsets.append(float(rec.get("offset") or 0.0))
        weights.append(float(rec.get("weight") if rec.get("weight") is not None else 1.0))
        meta = rec.get("metadataMap") or {}
        for t in id_types:
            if t in rec and rec[t] is not None:
                raw_ids[t].append(str(rec[t]))
            elif t in meta:
                raw_ids[t].append(meta[t])
            else:
                raise ValueError(
                    f"row {n}: id type {t!r} found neither as a record field "
                    "nor in metadataMap"
                )
        keyed_by_section: Dict[str, List[Tuple[str, float]]] = {}
        for s, imap in shard_index_maps.items():
            ptr, idx, val = per_shard[s]
            for section in shard_sections.get(s) or ["features"]:
                if section not in keyed_by_section:
                    keyed_by_section[section] = [
                        (feature_key(f["name"], f["term"]), float(f["value"]))
                        for f in rec.get(section) or []
                    ]
                for key, value in keyed_by_section[section]:
                    j = imap.get_index(key)
                    if j >= 0:
                        idx.append(j)
                        val.append(value)
            if shard_intercepts.get(s, True) and imap.intercept_index >= 0:
                idx.append(imap.intercept_index)
                val.append(1.0)
            ptr.append(len(idx))
        n += 1

    ids: Dict[str, np.ndarray] = {}
    vocabs: Dict[str, List[str]] = {}
    for t in id_types:
        if id_vocabs is not None and t in id_vocabs:
            vocab = list(id_vocabs[t])
            lookup = {v: i for i, v in enumerate(vocab)}
            ids[t] = np.asarray([lookup.get(v, -1) for v in raw_ids[t]], np.int32)
        else:
            vocab = sorted(set(raw_ids[t]))
            lookup = {v: i for i, v in enumerate(vocab)}
            ids[t] = np.asarray([lookup[v] for v in raw_ids[t]], np.int32)
        vocabs[t] = vocab

    shards = {
        s: HostFeatures(np.asarray(ptr, np.int64), np.asarray(idx, np.int32),
                        np.asarray(val, real), len(shard_index_maps[s]))
        for s, (ptr, idx, val) in per_shard.items()
    }
    return GameData(
        response=np.asarray(labels, real),
        offset=np.asarray(offsets, real),
        weight=np.asarray(weights, real),
        ids=ids,
        id_vocabs=vocabs,
        shards=shards,
    )
