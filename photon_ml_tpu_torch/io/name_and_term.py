"""NameAndTerm feature-set container — the reference's (deprecated)
whole-dataset feature vocabulary path (port of
photon_ml_tpu/io/name_and_term.py; the same text layout).

Reference spec: avro/data/NameAndTermFeatureSetContainer.scala:38-260 and
avro/data/NameAndTerm.scala — per feature-section sets of (name, term)
pairs, persisted as one text subdirectory per section (``name\\tterm``
lines), combinable into a feature→index map for a chosen set of sections
(getFeatureNameAndTermToIndexMap :46-57), plus a standalone CLI that scans
input avro data and writes the vocabulary
(NameAndTermFeatureSetContainer.main :127-260 — the
``--feature-name-and-term-set-path`` producer for the GAME driver,
deprecated in favor of the off-heap index maps but still part of the
surface).

Design deltas from the reference (documented, deliberate):
  * index assignment is SORTED (name, term) order, not JVM Set iteration
    order — deterministic maps are required for checkpoint/resume parity;
  * the "scan" is a host-side streaming pass over avro container files
    (io/avro_data.collect_feature_keys) instead of a Spark flatMap.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from photon_ml_tpu_torch.io import avro_data
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key

NameAndTerm = Tuple[str, str]

INTERCEPT_NAME_AND_TERM: NameAndTerm = ("(INTERCEPT)", "")


class NameAndTermFeatureSetContainer:
    """Per-section (name, term) vocabulary sets."""

    def __init__(self, feature_sets: Dict[str, Set[NameAndTerm]]):
        self.feature_sets = {k: set(v) for k, v in feature_sets.items()}

    # -- combination ----------------------------------------------------
    def feature_name_and_term_to_index_map(
        self, section_keys: Sequence[str], add_intercept: bool = True
    ) -> Dict[NameAndTerm, int]:
        """Union the chosen sections and index them
        (getFeatureNameAndTermToIndexMap :46-57; sorted for determinism)."""
        union: Set[NameAndTerm] = set()
        for key in section_keys:
            union |= self.feature_sets.get(key, set())
        out = {nt: i for i, nt in enumerate(sorted(union))}
        if add_intercept:
            out[INTERCEPT_NAME_AND_TERM] = len(out)
        return out

    def index_map(self, section_keys: Sequence[str], add_intercept: bool = True) -> IndexMap:
        """Same union as an IndexMap (the framework's native map type)."""
        union: Set[NameAndTerm] = set()
        for key in section_keys:
            union |= self.feature_sets.get(key, set())
        return IndexMap.build(
            (feature_key(n, t) for n, t in union), add_intercept=add_intercept
        )

    # -- persistence (text layout: <dir>/<section>/part-00000) ----------
    def save_as_text(self, output_dir: str) -> None:
        """One subdirectory per section of ``name\\tterm`` lines
        (saveAsTextFiles :63-69 layout)."""
        for section, feature_set in self.feature_sets.items():
            d = os.path.join(output_dir, section)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "part-00000"), "w") as f:
                for name, term in sorted(feature_set):
                    f.write(f"{name}\t{term}\n")

    @staticmethod
    def read_from_text(
        input_dir: str, section_keys: Sequence[str]
    ) -> "NameAndTermFeatureSetContainer":
        """readNameAndTermFeatureSetContainerFromTextFiles :75-88 parity:
        1 token = name with empty term; 2 = name, term; else error."""
        sets: Dict[str, Set[NameAndTerm]] = {}
        for section in section_keys:
            d = os.path.join(input_dir, section)
            feature_set: Set[NameAndTerm] = set()
            for fname in sorted(os.listdir(d)):
                if fname.startswith((".", "_")):
                    continue
                with open(os.path.join(d, fname)) as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if not line:
                            continue
                        parts = line.split("\t")
                        if len(parts) == 1:
                            feature_set.add((parts[0], ""))
                        elif len(parts) == 2:
                            feature_set.add((parts[0], parts[1]))
                        else:
                            raise ValueError(
                                f"Unexpected entry {line!r}: expected 1 or 2 "
                                f"tab-separated tokens, found {len(parts)}"
                            )
            sets[section] = feature_set
        return NameAndTermFeatureSetContainer(sets)

    # -- generation from data -------------------------------------------
    @staticmethod
    def generate_from_avro(
        paths: Sequence[str], section_keys: Sequence[str]
    ) -> "NameAndTermFeatureSetContainer":
        """ONE streaming pass over the avro inputs collecting every
        section's distinct (name, term) pairs (the main()'s Spark
        flatMap+distinct, host-side)."""
        sets: Dict[str, Set[NameAndTerm]] = {k: set() for k in section_keys}
        for rec in avro_data._iter_records(paths):
            for section in section_keys:
                for f in rec.get(section) or []:
                    sets[section].add((f["name"], f["term"]))
        return NameAndTermFeatureSetContainer(sets)


def main(argv: Optional[List[str]] = None) -> NameAndTermFeatureSetContainer:
    """Standalone vocabulary-generation job (the reference's
    Generate-Feature-Name-And-Term-List CLI, :127-260; flag names kept)."""
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _input_files,
        resolve_date_range_dirs,
    )
    from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir

    p = argparse.ArgumentParser(prog="generate-feature-name-and-term-list")
    p.add_argument("--data-input-directory", required=True,
                   help="comma-separated input dirs")
    p.add_argument("--date-range", default=None)
    p.add_argument("--date-range-days-ago", default=None)
    p.add_argument("--feature-name-and-term-set-output-dir", required=True)
    p.add_argument("--feature-section-keys", default="features",
                   help="comma-separated section keys")
    p.add_argument("--delete-output-dir-if-exists", default="false")
    p.add_argument("--application-name", default="generate-feature-name-and-term-list")
    ns = p.parse_args(argv)
    if ns.date_range and ns.date_range_days_ago:
        p.error("--date-range and --date-range-days-ago are exclusive")

    dirs = [d for d in ns.data_input_directory.split(",") if d]
    sections = [s.strip() for s in ns.feature_section_keys.split(",") if s.strip()]
    prepare_output_dir(
        ns.feature_name_and_term_set_output_dir,
        str(ns.delete_output_dir_if_exists).lower() in ("true", "1", "yes"),
    )
    paths = _input_files(
        resolve_date_range_dirs(dirs, ns.date_range, ns.date_range_days_ago)
    )
    container = NameAndTermFeatureSetContainer.generate_from_avro(paths, sections)
    container.save_as_text(ns.feature_name_and_term_set_output_dir)
    return container


if __name__ == "__main__":
    main()
