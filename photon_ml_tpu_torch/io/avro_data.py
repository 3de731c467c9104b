"""Avro training-data ingest: TrainingExampleAvro -> columnar host datasets
(port of photon_ml_tpu/io/avro_data.py).

Reference spec: avro/data/DataProcessingUtils.scala:33-200 (GenericRecord ->
GameDatum: feature key = "name\\x01term", per-shard sparse vector assembly
with intercept append, id lookup from record field or metadataMap) and
io/GLMSuite.readLabeledPointsFromAvro (io/GLMSuite.scala:98-139).

Every read goes columnar through the native decoder (io/avro_native.py)
when each of its files takes that path, and otherwise through the Python
row loop, all or nothing per read. The row loop runs when
``PHOTON_ML_TPU_NATIVE=0`` asks for it or when the decoder rejects a file
(unsupported schema shape, corrupt block; logged). ``ingest_counts``
counts the files each path read, so a caller can tell which one ran.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch import native_build, resilience
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.data.game import GameData, HostFeatures, _np_real
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_native
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.io.libsvm import HostDataset

logger = logging.getLogger(__name__)

# files read since import: by the native decoder, by the Python row loop,
# and the files the decoder rejected (each sent its whole read to the loop)
ingest_counts = {"native_files": 0, "row_loop_files": 0, "rejected_files": 0}


def _iter_records(paths: Sequence[str]) -> Iterable[dict]:
    """The Python row loop over every part file of ``paths`` (counted);
    per-block retries and the corrupt-shard policy live in
    avro.read_container, driven by the process-wide resilience config."""
    ingest_counts["row_loop_files"] += len(_expand_part_files(paths))
    for p in paths:
        yield from avro_io.read_directory(p)


def _expand_part_files(paths: Sequence[str]) -> List[str]:
    """Part files in read_directory order (one shared definition)."""
    out: List[str] = []
    for p in paths:
        out.extend(avro_io.list_part_files(p))
    return out


# parses kept for reuse inside ``reuse_parses()``: {(path, size, mtime): columns}
_reused_parses: Optional[Dict[tuple, object]] = None


@contextlib.contextmanager
def reuse_parses():
    """Inside the block, a part file the native decoder has parsed (the same
    path, size and modification time) is not parsed again: a driver's
    vocabulary scan and its dataset read share one parse. The parses are
    dropped on exit."""
    global _reused_parses
    outer = _reused_parses
    if outer is None:
        _reused_parses = {}
    try:
        yield
    finally:
        _reused_parses = outer


def _parse_key(path: str) -> Optional[tuple]:
    if _reused_parses is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None  # the read itself reports the missing file
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns)


def _native_columns(paths: Sequence[str]):
    """NativeColumns per part file, or None if ANY file can't take the
    native path (all-or-nothing keeps the assembly uniform); None at once
    with ``PHOTON_ML_TPU_NATIVE=0``.

    Whole-file reads retry under the active policy (the ``io.read_block``
    fault site covers the whole-file parse, block=-1). A file the decoder
    rejects (an unsupported schema shape, a corrupt block) is logged and
    counted, and the read goes to the Python row loop, which owns the
    block-granular corrupt-shard skip/raise semantics.
    """
    if not native_build.native_enabled():
        return None
    policy = resilience.current_config().io_policy

    def read_one(f: str):
        faults.inject("io.read_block", path=f, block=-1, offset=0)
        return avro_native.read_columns(f)

    cols = []
    for f in _expand_part_files(paths):
        key = _parse_key(f)
        if key is not None and key in _reused_parses:
            cols.append(_reused_parses[key])
            continue
        try:
            c = resilience.call_with_retry(
                lambda f=f: read_one(f), policy, describe=f"native read {f}"
            )
            reason = "unsupported schema shape or undecodable data"
        except ValueError as e:
            c, reason = None, str(e)
        if c is None:
            ingest_counts["rejected_files"] += 1
            logger.warning("native decoder rejected %s (%s); reading through the "
                           "Python row loop", f, reason)
            return None
        if key is not None:
            _reused_parses[key] = c
        cols.append(c)
    return cols or None


def _read_natively(cols_list, assembled):
    """Count a columnar read that produced its result; a declined assembly
    (an exotic field type) is logged before the row loop takes over."""
    if assembled is not None:
        ingest_counts["native_files"] += len(cols_list)
    else:
        logger.warning("columnar assembly declined the native columns; reading "
                       "through the Python row loop")
    return assembled


def _padded_matrix(heap: bytes, offsets: np.ndarray, total: int) -> Tuple[np.ndarray, np.ndarray]:
    """(total, maxlen) u8 matrix of zero-padded strings + (total,) lengths,
    built fully vectorized from the byte heap."""
    buf = np.frombuffer(heap, np.uint8)
    starts = offsets[:total]
    lengths = (offsets[1 : total + 1] - starts).astype(np.int64)
    maxlen = int(lengths.max()) if total else 1
    maxlen = max(maxlen, 1)
    pos = starts[:, None] + np.arange(maxlen)[None, :]
    mask = np.arange(maxlen)[None, :] < lengths[:, None]
    safe = np.clip(pos, 0, max(len(buf) - 1, 0))
    mat = np.where(mask, buf[safe] if len(buf) else 0, 0).astype(np.uint8)
    return mat, lengths


_NONE_BYTES = np.frombuffer(b"None", np.uint8)


def _row_hashes(mat: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each row of a (total, width) u8 matrix, eight bytes
    at a time."""
    total, width = mat.shape
    words = np.zeros((total, (width + 7) // 8 * 8), np.uint8)
    words[:, :width] = mat
    h = np.zeros(total, np.uint64)
    with np.errstate(over="ignore"):
        for col in words.view(np.uint64).T:
            h = (h ^ col) * np.uint64(0x100000001B3)
            h ^= h >> np.uint64(29)
    return h


def _unique_rows(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(first, inverse)`` of the distinct rows of a (total, width) u8
    matrix: the index of one row of each, and each row's distinct row. The
    rows' hashes are deduplicated (a sort of integers, not of the rows'
    bytes); every row is then compared with its group's first row byte for
    byte, and a collision, should one occur, dedupes the rows' bytes
    instead."""
    width = mat.shape[1]
    _, first, inverse = np.unique(_row_hashes(mat), return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    if np.array_equal(mat, mat[first[inverse]]):
        return first, inverse
    rows = mat.view(np.dtype((np.void, width))).ravel()
    _, first, inverse = np.unique(rows, return_index=True, return_inverse=True)
    return first, inverse.reshape(-1)


def _ntv_keys_to_indices(raw: dict, index_map: IndexMap,
                         return_keys: bool = False):
    """Vectorized feature-key -> index over a raw NTV column bundle: build
    padded (name, term) byte matrices, dedupe rows with np.unique, and touch
    python strings only once per UNIQUE key (IndexMap probe)."""
    total = raw["total"]
    if total == 0:
        empty = np.zeros(0, np.int64)
        return (empty, []) if return_keys else empty
    name_mat, name_len = _padded_matrix(raw["name_heap"], raw["name_off"], total)
    term = raw["term"]
    if term[0] == "strings":
        term_mat, term_len = _padded_matrix(term[1], term[2], total)
    elif term[0] == "union":
        _, heap, off_str, str_mask = term
        n_str = int(str_mask.sum())
        smat, slen = _padded_matrix(heap, off_str, n_str)
        width = max(smat.shape[1], 4)  # room for the literal "None"
        term_mat = np.zeros((total, width), np.uint8)
        term_len = np.empty(total, np.int64)
        term_mat[str_mask, : smat.shape[1]] = smat
        term_len[str_mask] = slen
        # python-codec parity: feature_key(name, None) stringifies None
        term_mat[~str_mask, :4] = _NONE_BYTES
        term_len[~str_mask] = 4
    else:  # "empty"
        term_mat = np.zeros((total, 1), np.uint8)
        term_len = np.zeros(total, np.int64)

    combined = np.concatenate(
        [
            name_len[:, None].view(np.uint8).reshape(total, 8),
            term_len[:, None].view(np.uint8).reshape(total, 8),
            name_mat,
            term_mat,
        ],
        axis=1,
    )
    first, inverse = _unique_rows(np.ascontiguousarray(combined))

    nbuf = raw["name_heap"]
    keys = []
    for i in first:
        nm = nbuf[raw["name_off"][i] : raw["name_off"][i + 1]].decode("utf-8")
        tl = int(term_len[i])
        tm = term_mat[i, :tl].tobytes().decode("utf-8")
        keys.append(feature_key(nm, tm))
    mapped = np.fromiter(
        (index_map.get_index(k) for k in keys), dtype=np.int64, count=len(keys)
    )
    idx = mapped[inverse]
    return (idx, keys) if return_keys else idx


class _AllKeys:
    """Index-map stand-in: _ntv_keys_to_indices probes once per unique key;
    the vocabulary scan only wants the keys."""

    @staticmethod
    def get_index(_k):
        return -1


def _section_keys_columnar(cols_list, sections) -> Optional[Dict[str, set]]:
    """The keys of each of ``sections`` from native columns; None -> row
    loop."""
    out = {s: set() for s in sections}
    for cols in cols_list:
        for section in sections:
            if not cols.has_field(section):
                continue
            ntv = cols.ntv_array_raw(section)
            if ntv is None:
                return None
            out[section].update(_ntv_keys_to_indices(ntv, _AllKeys, return_keys=True)[1])
    return out


def collect_shard_feature_keys(
    paths: Sequence[str], shard_sections: Dict[str, Sequence[str]]
) -> Dict[str, List[str]]:
    """:func:`collect_feature_keys` for several shards over one read of the
    files: ``{shard: sorted keys of its sections}``."""
    sections = sorted({s for secs in shard_sections.values() for s in secs})
    per_section = None
    native = _native_columns(paths)
    if native is not None:
        per_section = _read_natively(native, _section_keys_columnar(native, sections))
    if per_section is None:
        per_section = {s: set() for s in sections}
        for rec in _iter_records(paths):
            for section in sections:
                for f in rec.get(section) or []:
                    per_section[section].add(feature_key(f["name"], f["term"]))
    return {shard: sorted(set().union(*(per_section[s] for s in secs)))
            for shard, secs in shard_sections.items()}


def collect_feature_keys(
    paths: Sequence[str], sections: Sequence[str] = ("features",)
) -> List[str]:
    """Whole-dataset feature vocabulary (NameAndTermFeatureSetContainer
    analogue). ``sections`` are the record fields holding FeatureAvro arrays
    (the reference's feature sections/bags). Columnar through the native
    decoder when the files support it."""
    return collect_shard_feature_keys(paths, {"": sections})[""]


def collect_entity_ids(
    paths: Sequence[str], id_types: Sequence[str]
) -> Dict[str, set]:
    """Raw entity-id sets per id type (record field first, then
    metadataMap); a row missing an id type adds nothing to its set: the
    delta-retrain planner's dirty-set probe (retrain/delta.py), which reads
    only the changed files. Columnar through the native decoder when the
    files support it; the Python row loop otherwise."""
    out: Dict[str, set] = {t: set() for t in id_types}
    native = _native_columns(paths)
    if native is not None:
        columns = []
        for cols in native:
            lookup = _IdColumns(cols)
            columns.append({t: lookup.column(t) for t in id_types})
        if all(c is not None for per in columns for c in per.values()):
            _read_natively(native, columns)
            for per in columns:
                for t, col in per.items():
                    out[t].update(v for v in col if v is not None)
            return out
        _read_natively(native, None)
    for rec in _iter_records(paths):
        meta = rec.get("metadataMap") or {}
        for t in id_types:
            if t in rec and rec[t] is not None:
                out[t].add(str(rec[t]))
            elif t in meta:
                out[t].add(meta[t])
    return out


def read_training_examples(
    paths: Sequence[str],
    index_map: IndexMap,
    add_intercept: bool = True,
    label_field: str = "label",
) -> HostDataset:
    """TrainingExampleAvro files -> HostDataset (single feature space).

    ``label_field``: "label" for TRAINING_EXAMPLE records, "response" for
    RESPONSE_PREDICTION ones (io/FieldNamesType.scala parity).

    Runs columnar through the native decoder when the files support it
    (identical output; PHOTON_ML_TPU_NATIVE=0 forces the python row loop).
    """
    native = _native_columns(paths)
    if native is not None:
        fast = _read_natively(native, _read_training_examples_columnar(
            native, index_map, add_intercept, label_field
        ))
        if fast is not None:
            return fast
    real = _np_real()
    labels: List[float] = []
    offsets: List[float] = []
    weights: List[float] = []
    indptr: List[int] = [0]
    indices: List[int] = []
    values: List[float] = []
    intercept_idx = index_map.intercept_index
    for rec in _iter_records(paths):
        labels.append(float(rec[label_field]))
        offsets.append(float(rec.get("offset") or 0.0))
        weights.append(float(rec.get("weight") if rec.get("weight") is not None else 1.0))
        for f in rec["features"]:
            idx = index_map.get_index(feature_key(f["name"], f["term"]))
            if idx >= 0:
                indices.append(idx)
                values.append(float(f["value"]))
        if add_intercept and intercept_idx >= 0:
            indices.append(intercept_idx)
            values.append(1.0)
        indptr.append(len(indices))
    return HostDataset(
        labels=np.asarray(labels, real),
        indptr=np.asarray(indptr, np.int64),
        indices=np.asarray(indices, np.int32),
        values=np.asarray(values, real),
        dim=len(index_map),
        offsets=np.asarray(offsets, real),
        weights=np.asarray(weights, real),
    )


def _read_training_examples_columnar(
    cols_list, index_map: IndexMap, add_intercept: bool, label_field: str
) -> Optional[HostDataset]:
    """Vectorized assembly from native columns; None -> caller falls back."""
    real = _np_real()
    parts = []
    intercept_idx = index_map.intercept_index
    for cols in cols_list:
        lab = cols.scalar(label_field)
        feats = cols.ntv_array_raw("features")
        if lab is None or feats is None or not lab[1].all():
            return None
        labels, _ = lab
        counts, values = feats["counts"], feats["values"]
        off = cols.scalar("offset")
        wt = cols.scalar("weight")
        n = cols.n
        # rec.get("offset") or 0.0 / weight None -> 1.0 (python-loop parity)
        offsets = np.where(off[1].astype(bool), off[0], 0.0) if off else np.zeros(n)
        weights = np.where(wt[1].astype(bool), wt[0], 1.0) if wt else np.ones(n)

        idx = _ntv_keys_to_indices(feats, index_map)
        keep = idx >= 0
        row_of_item = np.repeat(np.arange(n, dtype=np.int64), counts)
        kept_rows = row_of_item[keep]
        kept_idx = idx[keep].astype(np.int32)
        kept_vals = values[keep]
        per_row = np.bincount(kept_rows, minlength=n).astype(np.int64)
        order = np.argsort(kept_rows, kind="stable")
        kept_idx, kept_vals = kept_idx[order], kept_vals[order]
        if add_intercept and intercept_idx >= 0:
            ptr = np.zeros(n + 1, np.int64)
            np.cumsum(per_row, out=ptr[1:])
            kept_idx = np.insert(kept_idx, ptr[1:], np.full(n, intercept_idx, np.int32))
            kept_vals = np.insert(kept_vals, ptr[1:], np.ones(n))
            per_row = per_row + 1
        parts.append((labels, offsets, weights, per_row, kept_idx, kept_vals))

    labels = np.concatenate([p[0] for p in parts])
    offsets = np.concatenate([p[1] for p in parts])
    weights = np.concatenate([p[2] for p in parts])
    per_row = np.concatenate([p[3] for p in parts])
    indices = np.concatenate([p[4] for p in parts])
    values = np.concatenate([p[5] for p in parts])
    indptr = np.zeros(len(labels) + 1, np.int64)
    np.cumsum(per_row, out=indptr[1:])
    return HostDataset(
        labels=labels.astype(real),
        indptr=indptr,
        indices=indices.astype(np.int32),
        values=values.astype(real),
        dim=len(index_map),
        offsets=offsets.astype(real),
        weights=weights.astype(real),
    )


def _dense_ids(raw_ids: Dict[str, List[str]], id_types: Sequence[str],
               id_vocabs: Optional[Dict[str, List[str]]]):
    """Raw id strings -> (dense int32 ids, vocabularies) per id type. With
    ``id_vocabs`` (the training vocabularies, for scoring and validation
    reads) an unseen entity maps to -1 ("no model", scores 0 —
    RandomEffectModel.scala:129-158); otherwise the sorted distinct ids."""
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
    return ids, vocabs


def read_game_data(
    paths: Sequence[str],
    shard_index_maps: Dict[str, IndexMap],
    shard_sections: Dict[str, List[str]],
    id_types: Sequence[str],
    shard_intercepts: Optional[Dict[str, bool]] = None,
    id_vocabs: Optional[Dict[str, List[str]]] = None,
    response_required: bool = True,
) -> GameData:
    """TrainingExampleAvro -> GameData with per-shard feature spaces.

    ``shard_sections`` maps feature-shard id -> feature-bag names. The
    reference keys feature bags by Avro *section* (separate record fields);
    the common convention in photon datasets encodes the bag in the feature
    ``name`` prefix or uses one default section — here, a feature belongs to
    shard s iff its key is present in s's index map, which subsumes both.

    Entity ids are read from ``metadataMap`` (DataProcessingUtils.scala:
    90-114: field or metadata map lookup).

    Runs columnar through the native decoder when the files support it
    (identical output; PHOTON_ML_TPU_NATIVE=0 forces the python row loop).
    """
    real = _np_real()
    shard_intercepts = shard_intercepts or {s: True for s in shard_index_maps}
    native = _native_columns(paths)
    if native is not None:
        fast = _read_natively(native, _read_game_data_columnar(
            native, shard_index_maps, shard_sections, id_types,
            shard_intercepts, id_vocabs, response_required,
        ))
        if fast is not None:
            return fast
    n = 0
    labels: List[float] = []
    offsets: List[float] = []
    weights: List[float] = []
    raw_ids: Dict[str, List[str]] = {t: [] for t in id_types}
    per_shard: Dict[str, Tuple[List[int], List[int], List[float]]] = {
        s: ([0], [], []) for s in shard_index_maps
    }
    for rec in _iter_records(paths):
        # response may be absent when scoring unlabeled data
        # (cli/game/scoring/Driver.scala isResponseRequired=false :83)
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
            # record field first, then metadataMap (DataProcessingUtils.scala:
            # 90-114 lookup order)
            if t in rec and rec[t] is not None:
                raw_ids[t].append(str(rec[t]))
            elif t in meta:
                raw_ids[t].append(meta[t])
            else:
                raise ValueError(
                    f"row {n}: id type {t!r} found neither as a record field "
                    "nor in metadataMap"
                )
        # compute each section's keyed features once, then probe shard maps
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

    ids, vocabs = _dense_ids(raw_ids, id_types, id_vocabs)

    shards = {
        s: HostFeatures(
            np.asarray(ptr, np.int64),
            np.asarray(idx, np.int32),
            np.asarray(val, real),
            len(shard_index_maps[s]),
        )
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


class _IdColumns:
    """Raw entity ids of one file's native columns, per id type: the record
    field first, then ``metadataMap`` per record (DataProcessingUtils.scala:
    90-114 lookup order)."""

    def __init__(self, cols):
        self.cols = cols
        self._meta = None
        self._meta_tried = False

    def _meta_lookup(self, i: int, t: str) -> Optional[str]:
        if not self._meta_tried:
            self._meta_tried = True
            m = self.cols.string_map("metadataMap")
            if m is not None:
                mcounts, mkeys, mvals, mpresent = m
                mstarts = np.zeros(len(mcounts) + 1, np.int64)
                np.cumsum(mcounts, out=mstarts[1:])
                mdense = np.cumsum(mpresent.astype(np.int64)) - 1
                self._meta = (mstarts, mkeys, mvals, mpresent, mdense)
        if self._meta is None:
            return None
        mstarts, mkeys, mvals, mpresent, mdense = self._meta
        if not mpresent[i]:
            return None
        di = int(mdense[i])
        for j in range(int(mstarts[di]), int(mstarts[di + 1])):
            if mkeys[j] == t:
                return mvals[j]
        return None

    def column(self, t: str) -> Optional[List[Optional[str]]]:
        """One id per row (None where neither the field nor metadataMap
        has it), or None for an id field of an exotic type."""
        cols = self.cols
        ftype = cols.field_type(t)
        field_vals = None  # list with None where the field value is null
        if ftype in ("int", "long"):
            sc = cols.scalar(t)
            field_vals = [str(int(v)) if pr else None for v, pr in zip(sc[0], sc[1])]
        elif ftype is not None:
            st = cols.strings(t)
            if st is None:
                return None
            field_vals = list(st[0])
        out = []
        for i in range(cols.n):
            v = field_vals[i] if field_vals is not None else None
            out.append(self._meta_lookup(i, t) if v is None else v)
        return out


def _read_game_data_columnar(
    cols_list,
    shard_index_maps: Dict[str, IndexMap],
    shard_sections: Dict[str, List[str]],
    id_types: Sequence[str],
    shard_intercepts: Dict[str, bool],
    id_vocabs: Optional[Dict[str, List[str]]],
    response_required: bool,
) -> Optional[GameData]:
    """Vectorized GAME ingest from native columns; None -> python loop."""
    real = _np_real()
    all_labels, all_offsets, all_weights = [], [], []
    raw_ids: Dict[str, List[str]] = {t: [] for t in id_types}
    shard_parts: Dict[str, list] = {s: [] for s in shard_index_maps}

    for cols in cols_list:
        n = cols.n
        lab = cols.scalar("label") or cols.scalar("response")
        if lab is None:
            if cols.has_field("label") or cols.has_field("response"):
                return None  # exotic label type -> python loop semantics
            if response_required:
                return None  # python loop raises the canonical error
            labels = np.full(n, np.nan)
        else:
            vals, present = lab
            if present.all():
                labels = vals.copy()
            elif response_required:
                return None
            else:
                labels = np.where(present.astype(bool), vals, np.nan)
        off = cols.scalar("offset")
        wt = cols.scalar("weight")
        all_labels.append(labels)
        all_offsets.append(
            np.where(off[1].astype(bool), off[0], 0.0) if off else np.zeros(n)
        )
        all_weights.append(
            np.where(wt[1].astype(bool), wt[0], 1.0) if wt else np.ones(n)
        )

        # ids: record field first, metadataMap PER RECORD otherwise
        # (DataProcessingUtils.scala:90-114 lookup order; the python loop's
        # `t in rec and rec[t] is not None` is a per-record decision)
        lookup = _IdColumns(cols)
        for t in id_types:
            got = lookup.column(t)
            if got is None or any(v is None for v in got):
                return None  # exotic id type, or a missing id: the python loop
            raw_ids[t].extend(got)

        # per-shard features: union of the shard's sections
        section_cache: Dict[str, tuple] = {}
        for s, imap in shard_index_maps.items():
            per_row = np.zeros(n, np.int64)
            idx_parts, val_parts, row_parts = [], [], []
            for section in shard_sections.get(s) or ["features"]:
                if section not in section_cache:
                    if not cols.has_field(section):
                        section_cache[section] = None
                    else:
                        ntv = cols.ntv_array_raw(section)
                        if ntv is None:
                            return None
                        rows = np.repeat(
                            np.arange(n, dtype=np.int64), ntv["counts"]
                        )
                        section_cache[section] = (rows, ntv)
                cached = section_cache[section]
                if cached is None:
                    continue  # absent section == no features (python parity)
                rows, ntv = cached
                values = ntv["values"]
                idx = _ntv_keys_to_indices(ntv, imap)
                keep = idx >= 0
                row_parts.append(rows[keep])
                idx_parts.append(idx[keep].astype(np.int32))
                val_parts.append(values[keep])
            if row_parts:
                rows_k = np.concatenate(row_parts)
                idx_k = np.concatenate(idx_parts)
                vals_k = np.concatenate(val_parts)
                order = np.argsort(rows_k, kind="stable")
                rows_k, idx_k, vals_k = rows_k[order], idx_k[order], vals_k[order]
                per_row = np.bincount(rows_k, minlength=n).astype(np.int64)
            else:
                idx_k = np.zeros(0, np.int32)
                vals_k = np.zeros(0)
            if shard_intercepts.get(s, True) and imap.intercept_index >= 0:
                ptr = np.zeros(n + 1, np.int64)
                np.cumsum(per_row, out=ptr[1:])
                idx_k = np.insert(
                    idx_k, ptr[1:], np.full(n, imap.intercept_index, np.int32)
                )
                vals_k = np.insert(vals_k, ptr[1:], np.ones(n))
                per_row = per_row + 1
            shard_parts[s].append((per_row, idx_k, vals_k))

    labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
    n_total = len(labels)
    ids, vocabs = _dense_ids(raw_ids, id_types, id_vocabs)

    shards = {}
    for s, parts in shard_parts.items():
        per_row = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int64)
        indices = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int32)
        values = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0)
        indptr = np.zeros(n_total + 1, np.int64)
        np.cumsum(per_row, out=indptr[1:])
        shards[s] = HostFeatures(
            indptr, indices.astype(np.int32), values.astype(real),
            len(shard_index_maps[s]),
        )
    return GameData(
        response=labels.astype(real),
        offset=np.concatenate(all_offsets).astype(real),
        weight=np.concatenate(all_weights).astype(real),
        ids=ids,
        id_vocabs=vocabs,
        shards=shards,
    )
