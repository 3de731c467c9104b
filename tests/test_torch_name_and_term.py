"""The port's NameAndTerm vocabulary and date-range inputs against the JAX
package (CPU): the generation command's text files byte-equal, the
container's section unions and index maps equal, the training driver built
on a NameAndTerm vocabulary equal to the JAX driver's; ``DateRange`` and the
daily-path expansion equal, and the date-range flags of the training driver
on the fixture of tests/test_game_drivers.py (``TestDateRangeDiscovery``).
"""

import datetime
import os
import shutil

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.io import name_and_term as jnt
from photon_ml_tpu.utils import date_range as jdr
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.io import name_and_term as tnt
from photon_ml_tpu_torch.io.index_map import feature_key
from photon_ml_tpu_torch.utils import date_range as tdr
from test_game_drivers import COMMON_FLAGS, game_avro_dirs  # noqa: F401
from test_name_and_term import avro_dir  # noqa: F401
from tolerances import assert_allclose


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def test_generation_command_writes_the_jax_commands_files(avro_dir, tmp_path):  # noqa: F811
    argv = ["--data-input-directory", avro_dir, "--feature-section-keys", "features,userFeatures"]
    got = tnt.main(argv + ["--feature-name-and-term-set-output-dir", str(tmp_path / "port")])
    want = jnt.main(argv + ["--feature-name-and-term-set-output-dir", str(tmp_path / "jax")])
    assert got.feature_sets == want.feature_sets
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    back = tnt.NameAndTermFeatureSetContainer.read_from_text(
        str(tmp_path / "jax"), ["features", "userFeatures"])
    assert back.feature_sets == want.feature_sets
    for sections in (["features"], ["userFeatures"], ["features", "userFeatures"]):
        for icpt in (True, False):
            assert back.feature_name_and_term_to_index_map(sections, icpt) == \
                want.feature_name_and_term_to_index_map(sections, icpt)
            assert back.index_map(sections, icpt).index_to_name == \
                want.index_map(sections, icpt).index_to_name


def test_malformed_vocabulary_line_raises(tmp_path):
    (tmp_path / "nt" / "features").mkdir(parents=True)
    (tmp_path / "nt" / "features" / "part-00000").write_text("a\tb\tc\n")
    for mod in (tnt, jnt):
        with pytest.raises(ValueError, match="tab-separated"):
            mod.NameAndTermFeatureSetContainer.read_from_text(str(tmp_path / "nt"), ["features"])


def test_training_on_a_name_and_term_vocabulary_matches_jax(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    nt_dir = str(tmp_path / "nt")
    tnt.main(["--data-input-directory", train_dir, "--feature-name-and-term-set-output-dir",
              nt_dir, "--feature-section-keys", "fixedFeatures,userFeatures"])
    # drop one fixed feature: the vocabulary, not a scan, must govern
    path = os.path.join(nt_dir, "fixedFeatures", "part-00000")
    kept = [line for line in open(path).read().splitlines() if not line.startswith("f0\t")]
    open(path, "w").write("\n".join(kept) + "\n")
    argv = ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--feature-name-and-term-set-path", nt_dir, "--num-iterations", "1",
            "--evaluator-type", "AUC"] + COMMON_FLAGS
    td = tdriver.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    jd = jdriver.main(argv + ["--output-dir", str(tmp_path / "jax")])
    for shard in ("global", "per_user"):
        assert td.shard_index_maps[shard].index_to_name == jd.shard_index_maps[shard].index_to_name
    assert td.shard_index_maps["global"].get_index(feature_key("f0", "")) < 0
    assert_allclose(td.results[0][1].objective_history, jd.results[0][1].objective_history,
                    kind="solver", dtype=np.float32)


@pytest.mark.parametrize("text", ["20260101-20260131", "20240228-20240301", "20261231-20270102"])
def test_date_ranges_parse_and_expand_as_in_the_jax_package(tmp_path, text):
    got, want = tdr.DateRange.from_string(text), jdr.DateRange.from_string(text)
    assert (got.start, got.end, got.days()) == (want.start, want.end, want.days())
    today = datetime.date(2026, 7, 28)
    got, want = tdr.DateRange.from_days_ago("40-1", today), jdr.DateRange.from_days_ago("40-1", today)
    assert (got.start, got.end) == (want.start, want.end)
    dr = tdr.DateRange.from_string(text)
    for i, day in enumerate(dr.days()):
        if i % 2 == 0:
            (tmp_path / "daily" / f"{day.year:04d}" / f"{day.month:02d}" / f"{day.day:02d}").mkdir(
                parents=True)
    assert tdr.expand_date_range_paths(str(tmp_path), dr) == jdr.expand_date_range_paths(
        str(tmp_path), jdr.DateRange.from_string(text))
    for mod in (tdr, jdr):
        with pytest.raises(FileNotFoundError):
            mod.expand_date_range_paths(str(tmp_path), mod.DateRange.from_string(text),
                                        error_on_missing=True)
    with pytest.raises(ValueError, match="invalid"):
        tdr.DateRange.from_string("20260102-20260101")


def test_training_with_daily_layout(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    root = tmp_path / "daily-root"
    for day in ("27", "28"):
        dest = root / "daily" / "2026" / "07" / day
        dest.mkdir(parents=True)
        shutil.copy(os.path.join(train_dir, "part-0.avro"), dest / "part-0.avro")
    vroot = tmp_path / "val-root"
    (vroot / "daily" / "2026" / "07" / "29").mkdir(parents=True)
    shutil.copy(os.path.join(val_dir, "part-0.avro"), vroot / "daily" / "2026" / "07" / "29")
    rows = []
    for rng in ("20260727-20260727", "20260727-20260728", "20260720-20260730"):
        argv = ["--train-input-dirs", str(root), "--train-date-range", rng,
                "--validate-input-dirs", str(vroot), "--validate-date-range", "20260729-20260729",
                "--num-iterations", "1", "--model-output-mode", "NONE"] + COMMON_FLAGS
        td = tdriver.main(argv + ["--output-dir", str(tmp_path / "o"), "--device", "cpu"])
        jd = jdriver.main(argv + ["--output-dir", str(tmp_path / "j")])
        assert td.train_data.num_rows == jd.train_data.num_rows
        assert td.validation_data.num_rows == jd.validation_data.num_rows
        assert_allclose(td.results[0][1].objective_history, jd.results[0][1].objective_history,
                        kind="solver", dtype=np.float32)
        rows.append(td.train_data.num_rows)
    assert rows[1] == rows[2] == 2 * rows[0]


def test_missing_range_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdriver.main(["--train-input-dirs", str(tmp_path), "--train-date-range",
                      "20000101-20000102", "--output-dir", str(tmp_path / "o"),
                      "--device", "cpu"] + COMMON_FLAGS)


@pytest.mark.parametrize("pair", [("--train-date-range", "--train-date-range-days-ago"),
                                  ("--validate-date-range", "--validate-date-range-days-ago")])
def test_exclusive_range_flags_rejected(pair):
    with pytest.raises(ValueError, match="exclusive"):
        tparams.parse_training_params(["--train-input-dirs", "/x", "--output-dir", "/y",
                                       pair[0], "20260101-20260102", pair[1], "9-1"]
                                      + COMMON_FLAGS)
