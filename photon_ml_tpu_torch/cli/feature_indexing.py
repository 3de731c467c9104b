"""Feature indexing job: build partitioned name->index maps from data (port
of photon_ml_tpu/cli/feature_indexing.py; the same files).

Reference spec: FeatureIndexingJob.scala:59-350 — scan the dataset for
distinct (name, term) keys per feature shard (+ intercept), hash-partition,
and write partitioned index stores the drivers later load via
--offheap-indexmap-dir. The PalDB-per-partition layout is replaced by the
IndexMap partitioned build (same hash-partition + global-offset semantics,
io/index_map.py) persisted as one JSON file per shard, or with ``--format
OFFHEAP`` as the memory-mapped pmix store (io/offheap.py):

    <output>/feature-index.json              (single/global map)
    <output>/feature-index-<shard>.json      (per feature shard)
    <output>/<shard>/meta.json, partition-<i>.pmix   (OFFHEAP)

    python -m photon_ml_tpu_torch.cli.feature_indexing \\
      --data-input-dirs data/train --output-dir index-maps --partition-num 8 \\
      --format OFFHEAP \\
      --feature-shard-id-to-feature-section-keys-map "global:features|per_user:userFeatures"

The scan goes through the native Avro decoder (io/avro_data.py).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from photon_ml_tpu_torch.cli.game_params import parse_shard_intercepts, parse_shard_sections
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.io import avro_data
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.io.offheap import build_offheap_store


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch feature-indexing",
        description="Build feature index maps (FeatureIndexingJob parity)",
    )
    a = p.add_argument
    a("--data-input-dirs", required=True, help="comma-separated input dirs")
    a("--partition-num", type=int, default=1, help="hash partitions in the map")
    a("--output-dir", required=True)
    a("--feature-shard-id-to-feature-section-keys-map", dest="shard_sections", default=None)
    a("--feature-shard-id-to-intercept-map", dest="shard_intercepts", default=None)
    a("--add-intercept", default="true")
    a("--format", dest="store_format", default="JSON", choices=["JSON", "OFFHEAP"],
      help="JSON index file, or the native memory-mapped pmix store "
      "(the PalDB-analogue off-heap format)")
    return p


def main(argv: Optional[List[str]] = None) -> List[str]:
    enable_determinism()
    ns = build_parser().parse_args(argv)
    paths = []
    for d in ns.data_input_dirs.split(","):
        if not d:
            continue
        if os.path.isfile(d):
            paths.append(d)
        else:
            paths.extend(
                os.path.join(d, f)
                for f in sorted(os.listdir(d))
                if not f.startswith((".", "_"))
            )
    os.makedirs(ns.output_dir, exist_ok=True)
    add_intercept_default = str(ns.add_intercept).strip().lower() in ("true", "1", "yes")

    offheap = ns.store_format == "OFFHEAP"
    partitions = max(ns.partition_num, 1)

    def emit(keys: List[str], add_intercept: bool, shard: Optional[str]) -> str:
        if offheap:
            out = (
                os.path.join(ns.output_dir, shard) if shard else ns.output_dir
            )
            build_offheap_store(out, keys, add_intercept, partitions)
            count = len(keys) + int(add_intercept)
        else:
            imap = IndexMap.build(keys, add_intercept, partitions)
            out = os.path.join(
                ns.output_dir,
                f"feature-index-{shard}.json" if shard else "feature-index.json",
            )
            imap.save(out)
            count = len(imap)
        label = f"shard {shard}: " if shard else ""
        print(f"{label}{count} features -> {out}")
        return out

    written: List[str] = []
    shard_sections = parse_shard_sections(ns.shard_sections)
    shard_intercepts = parse_shard_intercepts(ns.shard_intercepts)
    if shard_sections:
        for shard, sections in shard_sections.items():
            keys = avro_data.collect_feature_keys(paths, sections)
            written.append(
                emit(keys, shard_intercepts.get(shard, add_intercept_default), shard)
            )
    else:
        keys = avro_data.collect_feature_keys(paths)
        written.append(emit(keys, add_intercept_default, None))
    return written


if __name__ == "__main__":
    main()
