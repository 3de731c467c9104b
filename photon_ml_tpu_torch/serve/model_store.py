"""Mmap'd coefficient store for the online scoring server (port of
photon_ml_tpu/serve/model_store.py; the same layout, meta keys and bytes,
so a store either package writes opens in the other).

A saved GAME model (the reference's Avro layout, io/model_io.py) is great
for offline interchange and terrible for a warm request path: every open
re-parses name/term records and re-densifies coefficients through a Python
dict. This module EXPORTS a model once into an off-heap serving layout and
then serves it with zero parse work per process:

  ``store_dir/``
    ``meta.json``                 format/coordinates/shards/ladder manifest
    ``features/<shard>/``         pmix feature index (io/offheap.py store;
                                  the SAME store the batch drivers accept
                                  via ``--offheap-indexmap-dir``)
    ``fixed/<name>.npy``          (D,) f32 fixed-effect coefficients (mmap)
    ``random/<name>/rows/``       pmix entity -> slab-row lookup
                                  (:class:`~photon_ml_tpu_torch.io.
                                  offheap.SlabRowIndex` — the
                                  feature-index machinery generalized to
                                  coefficient slabs)
    ``random/<name>/slab.npy``    (E_pad, D) per-entity coefficient slab
                                  (f32, or bf16-as-uint16 / int8 under a
                                  quantized ``store_dtype`` — see
                                  :mod:`photon_ml_tpu_torch.serve.
                                  quantize`), row order = the rows
                                  store's index order, entity count
                                  padded up the shape ladder so a model
                                  swap that stays within the rung meets
                                  no new batch shape
    ``random/<name>/scales.npy``  (E_pad,) f32 per-row absmax scale
                                  sidecar (int8 stores only)

Opening the store is a handful of mmaps (the page cache is the share
mechanism — concurrent servers on one host map the same physical pages,
the owner-computes lookup never copies a slab), and the store participates
in the checkpoint by-reference protocol (``__checkpoint_ref__`` /
``__checkpoint_from_ref__``, photon_ml_tpu_torch/checkpoint.py) so the
:class:`~photon_ml_tpu_torch.serve.swap.ModelSwapper` rolls a live server
to a new store through the same path streaming checkpoints restore
through.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.checkpoint import CheckpointRefError
from photon_ml_tpu_torch.compile import ShapeBucketer
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import model_io, schemas
from photon_ml_tpu_torch.io.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.io.offheap import (
    OffHeapIndexMap,
    SlabRowIndex,
    build_offheap_store,
    build_slab_index,
)
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.serve import quantize

logger = logging.getLogger(__name__)

STORE_FORMAT = "game-serve-store"
# version 2: optional quantized slabs (store_dtype + scale sidecars +
# pinned error budgets in meta). A version-1 store (no store_dtype key)
# still opens — it is exactly a version-2 f32 store.
STORE_VERSION = 2
META_FILE = "meta.json"
FEATURES_DIR = "features"
FIXED_DIR = "fixed"
RANDOM_DIR = "random"
ROWS_DIR = "rows"
SLAB_FILE = "slab.npy"
SCALES_FILE = "scales.npy"

#: on-disk slab dtype per store_dtype (bf16 travels as its raw bit
#: pattern so plain numpy can mmap it)
_DISK_DTYPE = {"f32": np.float32, "bf16": np.uint16, "int8": np.int8}


def _scan_records(model_dir: str, kind: str, name: str) -> List[dict]:
    return list(
        avro_io.read_directory(
            os.path.join(model_dir, kind, name, model_io.COEFFICIENTS)
        )
    )


def _record_keys(rec: dict) -> List[str]:
    """Feature keys named by one BayesianLinearModelAvro record (the
    intercept pseudo-feature is excluded — the index store carries its own
    intercept slot)."""
    out = []
    for section in ("means", "variances"):
        for ntv in rec.get(section) or []:
            if ntv["name"] == INTERCEPT_KEY and ntv["term"] == "":
                continue
            out.append(feature_key(ntv["name"], ntv["term"]))
    return out


def build_model_store(
    model_dir: str,
    store_dir: str,
    num_partitions: int = 1,
    bucketer: Optional[ShapeBucketer] = None,
    force_python: bool = False,
    store_dtype: str = "f32",
) -> dict:
    """Export a saved GAME model dir into the serving layout. Returns the
    written meta dict.

    ``store_dtype`` (``f32`` | ``bf16`` | ``int8``) selects the slab
    storage policy (:mod:`photon_ml_tpu_torch.serve.quantize`): ``f32`` keeps
    the bitwise-to-the-batch-driver contract; the quantized dtypes trade
    a pinned, export-time-verified coefficient error budget for 2x/4x
    smaller slabs. Fixed-effect vectors stay f32 under every policy (they
    are ``(D,)`` and replicated — the slabs are the serving bytes).

    The feature space is scanned FROM THE MODEL ITSELF (every name/term its
    coefficient records mention) — no training inputs needed at export
    time. Features a request carries that the model never weighted resolve
    to index -1 and drop out, which contributes exactly the 0.0 their zero
    coefficient would have. (The JAX function's ``entity_filter``, the
    fleet's sharded export, waits for the fleet.)
    """
    quantize.validate_store_dtype(store_dtype)
    layout = model_io.list_game_model(model_dir)
    fixed_entries = []
    for name in layout[model_io.FIXED_EFFECT]:
        with open(
            os.path.join(model_dir, model_io.FIXED_EFFECT, name, model_io.ID_INFO)
        ) as f:
            shard = f.read().strip()
        fixed_entries.append((name, shard))
    random_entries = []
    for name in layout[model_io.RANDOM_EFFECT]:
        with open(
            os.path.join(model_dir, model_io.RANDOM_EFFECT, name, model_io.ID_INFO)
        ) as f:
            lines = f.read().splitlines()
        re_id = lines[0] if lines else ""
        shard = lines[1] if len(lines) > 1 else ""
        random_entries.append((name, re_id, shard))

    # pass 1: raw records per coordinate + per-shard feature vocabulary
    fixed_recs: Dict[str, dict] = {}
    random_recs: Dict[str, List[dict]] = {}
    shard_keys: Dict[str, set] = {}
    task = None
    for name, shard in fixed_entries:
        recs = _scan_records(model_dir, model_io.FIXED_EFFECT, name)
        fixed_recs[name] = recs[0]
        shard_keys.setdefault(shard, set()).update(_record_keys(recs[0]))
        task = task or recs[0].get("modelClass")
    for name, re_id, shard in random_entries:
        if model_io.is_factored_random_effect(model_dir, name):
            logger.warning(
                "random effect %r is factored: serving its projected-back "
                "coefficients (bitwise parity holds against the driver's "
                "--host-scoring oracle, not the latent-native device path)",
                name,
            )
        recs = _scan_records(model_dir, model_io.RANDOM_EFFECT, name)
        random_recs[name] = recs
        keys = shard_keys.setdefault(shard, set())
        for rec in recs:
            keys.update(_record_keys(rec))
        task = task or (recs[0].get("modelClass") if recs else None)

    os.makedirs(store_dir, exist_ok=True)

    # feature index stores (one per shard; the batch drivers open these
    # directly via --offheap-indexmap-dir <store_dir>/features)
    maps: Dict[str, OffHeapIndexMap] = {}
    for shard, keys in sorted(shard_keys.items()):
        fdir = os.path.join(store_dir, FEATURES_DIR, shard)
        build_offheap_store(
            fdir,
            sorted(keys),
            add_intercept=True,
            num_partitions=num_partitions,
            force_python=force_python,
        )
        maps[shard] = OffHeapIndexMap(fdir, force_python=force_python)

    meta: dict = {
        "format": STORE_FORMAT,
        "version": STORE_VERSION,
        "store_dtype": store_dtype,
        "task": schemas.TASK_BY_MODEL_CLASS.get(
            task, "LOGISTIC_REGRESSION"
        ),
        "source_model_dir": os.path.abspath(model_dir),
        "ladder": bucketer.describe() if bucketer is not None else None,
        "shards": {s: {"dim": len(m), "intercept": True} for s, m in maps.items()},
        "fixed": [],
        "random": [],
    }

    os.makedirs(os.path.join(store_dir, FIXED_DIR), exist_ok=True)
    for name, shard in fixed_entries:
        means, _ = model_io._record_to_dense(fixed_recs[name], maps[shard])
        np.save(
            os.path.join(store_dir, FIXED_DIR, f"{name}.npy"),
            means.astype(np.float32),
        )
        meta["fixed"].append({"name": name, "shard": shard})

    for name, re_id, shard in random_entries:
        base = os.path.join(store_dir, RANDOM_DIR, name)
        os.makedirs(base, exist_ok=True)
        recs = random_recs[name]
        entity_ids = sorted(str(rec["modelId"]) for rec in recs)
        build_slab_index(
            os.path.join(base, ROWS_DIR),
            entity_ids,
            num_partitions=num_partitions,
            force_python=force_python,
        )
        rows = SlabRowIndex(os.path.join(base, ROWS_DIR), force_python=force_python)
        n_entities = rows.num_rows
        padded = (
            bucketer.canon(max(n_entities, 1))
            if bucketer is not None
            else n_entities
        )
        slab = np.zeros((max(padded, 1), len(maps[shard])), np.float32)
        for rec in recs:
            row = rows.get_row(str(rec["modelId"]))
            means, _ = model_io._record_to_dense(rec, maps[shard])
            slab[row] = means
        rows.close()
        stored, scales = quantize.quantize_slab(slab, store_dtype)
        # the pinned-budget gate: realized error vs the analytic budget,
        # computed against the TRUE slab — an over-budget slab fails the
        # export here and never serves
        err_report = quantize.slab_error_report(
            slab, stored, scales, store_dtype
        )
        np.save(os.path.join(base, SLAB_FILE), stored)
        if scales is not None:
            np.save(os.path.join(base, SCALES_FILE), scales)
        meta["random"].append(
            {
                "name": name,
                "re_id": re_id,
                "shard": shard,
                "entities": n_entities,
                "padded_rows": int(stored.shape[0]),
                "quantization": err_report,
            }
        )

    for m in maps.values():
        m.close()
    tmp = os.path.join(store_dir, META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(store_dir, META_FILE))
    return meta


def is_model_store(path: str) -> bool:
    try:
        with open(os.path.join(path, META_FILE)) as f:
            return json.load(f).get("format") == STORE_FORMAT
    except (OSError, ValueError):
        return False


@dataclasses.dataclass
class FixedEffectSlab:
    name: str
    shard: str
    coefficients: np.ndarray  # (D,) f32 memmap


@dataclasses.dataclass
class RandomEffectSlab:
    name: str
    re_id: str
    shard: str
    rows: SlabRowIndex  # entity raw id -> slab row
    slab: np.ndarray  # (E_pad, D) memmap (f32 / bf16-as-uint16 / int8)
    entities: int  # real (unpadded) entity count
    store_dtype: str = "f32"
    scales: Optional[np.ndarray] = None  # (E_pad,) f32 memmap (int8 only)
    quantization: Optional[dict] = None  # realized/budget coeff error

    def dequantized(self) -> np.ndarray:
        """The f32 coefficient values the device gathers serve (for f32
        stores, the slab itself) — the host view of this slab."""
        return quantize.dequantize_slab(
            self.slab, self.scales, self.store_dtype
        )


class ModelStore:
    """One opened serving store: mmap'd coefficients + entity/feature
    lookups. Read-only and thread-safe after construction (every member is
    an immutable mmap or a mapped hash probe)."""

    def __init__(self, store_dir: str, force_python: bool = False):
        self.store_dir = os.path.abspath(store_dir)
        with open(os.path.join(store_dir, META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != STORE_FORMAT:
            raise IOError(f"{store_dir} is not a {STORE_FORMAT} directory")
        if int(self.meta.get("version") or 1) > STORE_VERSION:
            raise IOError(
                f"{store_dir} is a version-{self.meta['version']} store; "
                f"this build reads <= {STORE_VERSION} — upgrade the serving "
                "binary before pointing it at this export"
            )
        # version-1 stores carry no store_dtype key: they are f32 exports
        self.store_dtype: str = self.meta.get("store_dtype") or "f32"
        quantize.validate_store_dtype(self.store_dtype)
        self.feature_maps: Dict[str, OffHeapIndexMap] = {
            shard: OffHeapIndexMap(
                os.path.join(store_dir, FEATURES_DIR, shard),
                force_python=force_python,
            )
            for shard in self.meta["shards"]
        }
        self.fixed: List[FixedEffectSlab] = [
            FixedEffectSlab(
                e["name"],
                e["shard"],
                np.load(
                    os.path.join(store_dir, FIXED_DIR, f"{e['name']}.npy"),
                    mmap_mode="r",
                ),
            )
            for e in self.meta["fixed"]
        ]
        self.random: List[RandomEffectSlab] = []
        for e in self.meta["random"]:
            base = os.path.join(store_dir, RANDOM_DIR, e["name"])
            slab = np.load(os.path.join(base, SLAB_FILE), mmap_mode="r")
            scales = self._open_quantized(base, e, slab)
            self.random.append(
                RandomEffectSlab(
                    e["name"],
                    e["re_id"],
                    e["shard"],
                    SlabRowIndex(
                        os.path.join(base, ROWS_DIR), force_python=force_python
                    ),
                    slab,
                    int(e["entities"]),
                    store_dtype=self.store_dtype,
                    scales=scales,
                    quantization=e.get("quantization"),
                )
            )

    def _open_quantized(
        self, base: str, entry: dict, slab: np.ndarray
    ) -> Optional[np.ndarray]:
        """Open-time dequantization gate for one coordinate: the slab's
        on-disk dtype, the recorded error budget, and (int8) the scale
        sidecar are all validated BEFORE the store can serve — a corrupt
        sidecar or over-budget meta fails the open actionably; it never
        degrades to serving garbage coefficients."""
        name = entry["name"]
        want = _DISK_DTYPE[self.store_dtype]
        if slab.dtype != want:
            raise IOError(
                f"store {self.store_dir} coordinate {name!r}: slab dtype "
                f"{slab.dtype} does not match store_dtype "
                f"{self.store_dtype!r} (expected {np.dtype(want)}); the "
                "export is inconsistent — re-export the store"
            )
        if self.store_dtype == "f32":
            return None
        faults.inject("serve.dequant", coordinate=name)
        q = entry.get("quantization") or {}
        realized = q.get("realized_max_abs_coeff_err")
        budget = q.get("coeff_err_budget")
        # `not (realized <= budget)` so a NaN smuggled into the meta (or
        # written by a pre-fix exporter from a NaN-corrupted slab) is
        # refused — NaN fails every comparison, including this gate's
        if realized is None or budget is None or not (realized <= budget):
            raise IOError(
                f"store {self.store_dir} coordinate {name!r}: quantized "
                f"slab has no valid pinned error budget in meta "
                f"(realized={realized!r}, budget={budget!r}); refusing to "
                "serve an unverified quantized export"
            )
        if self.store_dtype != "int8":
            return None
        try:
            scales = np.load(os.path.join(base, SCALES_FILE), mmap_mode="r")
        except (OSError, ValueError) as e:
            raise IOError(
                f"store {self.store_dir} coordinate {name!r}: int8 scale "
                f"sidecar {SCALES_FILE} is missing or unreadable ({e}); "
                "the store cannot dequantize — re-export it"
            ) from e
        if (
            scales.dtype != np.float32
            or scales.shape != (slab.shape[0],)
            or not bool(np.all(np.isfinite(scales)))
            or not bool(np.all(np.asarray(scales) > 0))
        ):
            raise IOError(
                f"store {self.store_dir} coordinate {name!r}: int8 scale "
                f"sidecar is corrupt (dtype {scales.dtype}, shape "
                f"{scales.shape}; scales must be finite and > 0); "
                "refusing to serve garbage coefficients — re-export the "
                "store"
            )
        return scales

    # -- lookups ------------------------------------------------------------
    def shard_dim(self, shard: str) -> int:
        return len(self.feature_maps[shard])

    def feature_index(self, shard: str, key: str) -> int:
        return self.feature_maps[shard].get_index(key)

    def entity_row(self, coordinate: str, raw_id: Optional[str]) -> int:
        """Slab row of ``raw_id`` for a random-effect coordinate; -1 when
        the entity has no model (its contribution is 0 —
        RandomEffectModel.scala:129-158 semantics)."""
        if raw_id is None:
            return -1
        for re in self.random:
            if re.name == coordinate:
                return re.rows.get_row(str(raw_id))
        raise KeyError(f"no random-effect coordinate {coordinate!r} in store")

    def features_dir(self) -> str:
        """The per-shard feature index stores — hand this to the batch
        scoring driver as ``--offheap-indexmap-dir`` so both paths score
        through an identical feature space."""
        return os.path.join(self.store_dir, FEATURES_DIR)

    def footprint(self) -> dict:
        """Store-footprint gauges for :class:`~photon_ml_tpu_torch.serve.
        stats.ServeStats`: slab bytes on disk (slab files + scale sidecars
        ONLY — the quantization dial's denominator; fixed-effect vectors
        are f32 under every policy), bytes mapped into this process
        (slabs + scales + fixed), and the storage dtype."""
        disk = 0
        mapped = 0
        for f in self.fixed:
            mapped += int(f.coefficients.nbytes)
        for r in self.random:
            base = os.path.join(self.store_dir, RANDOM_DIR, r.name)
            mapped += int(r.slab.nbytes)
            disk += self._file_size(os.path.join(base, SLAB_FILE))
            if r.scales is not None:
                mapped += int(r.scales.nbytes)
                disk += self._file_size(os.path.join(base, SCALES_FILE))
        return {
            "slab_bytes_disk": disk,
            "mapped_bytes": mapped,
            "store_dtype": self.store_dtype,
        }

    @staticmethod
    def _file_size(path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    def describe(self) -> str:
        re_desc = ", ".join(
            f"{r.name}({r.entities} entities, slab {tuple(r.slab.shape)})"
            for r in self.random
        )
        fp = self.footprint()
        return (
            f"model store {self.store_dir} "
            f"[{self.store_dtype}, {fp['slab_bytes_disk']} slab bytes]: "
            f"{len(self.fixed)} fixed / {len(self.random)} random "
            f"[{re_desc}]"
        )

    def close(self) -> None:
        for m in self.feature_maps.values():
            m.close()
        for r in self.random:
            r.rows.close()
        self.feature_maps = {}
        self.fixed = []
        self.random = []

    # -- checkpoint by-reference protocol (photon_ml_tpu_torch/checkpoint.py)
    def __checkpoint_ref__(self) -> dict:
        return {
            "kind": STORE_FORMAT,
            "version": STORE_VERSION,
            "store_dir": self.store_dir,
        }

    def __checkpoint_from_ref__(self, ref: dict) -> "ModelStore":
        if not isinstance(ref, dict) or ref.get("kind") != STORE_FORMAT:
            raise CheckpointRefError(
                f"not a {STORE_FORMAT} reference: {ref!r}"
            )
        store_dir = ref.get("store_dir", "")
        if not is_model_store(store_dir):
            raise CheckpointRefError(
                f"serve-store reference points at {store_dir!r}, which is "
                "missing or not a store — it may have been retired; refusing "
                "to swap"
            )
        return ModelStore(store_dir)
