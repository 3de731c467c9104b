"""The port's off-heap feature index store and the feature-indexing job
against the JAX package (CPU), on the generators of
tests/test_offheap_index.py: store files byte-identical to the JAX
``build_offheap_store`` (the native and the pure-Python writer), lookups
equal to the JAX store and to ``IndexMap.build``, each package reading the
other's store, the native and ``force_python`` readers agreeing, and
``feature_indexing`` writing the same files as the JAX job (JSON and
OFFHEAP).
"""

import os

import pytest

from photon_ml_tpu.cli import feature_indexing as jfeature_indexing
from photon_ml_tpu.io import offheap as joffheap
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch.cli import feature_indexing as tfeature_indexing
from photon_ml_tpu_torch.io import offheap as toffheap
from photon_ml_tpu_torch.io.index_map import INTERCEPT_KEY, IndexMap
from test_game_drivers import game_avro_dirs  # noqa: F401
from test_offheap_index import _keys

KEYSETS = {
    "500 keys": sorted(set(_keys(500, seed=1))),
    "one key": ["only\x01key"],
    "unicode": ["café\x01t", "日本\x01", "emoji\U0001f600\x01x"],
    "empty": [],
}


def _files(store_dir):
    out = {}
    for root, _, names in os.walk(store_dir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, store_dir)] = f.read()
    return out


@pytest.mark.parametrize("partitions", [1, 3, 8])
@pytest.mark.parametrize("add_intercept", [True, False])
@pytest.mark.parametrize("keyset", sorted(KEYSETS))
def test_store_files_are_byte_identical_to_the_jax_store(tmp_path, keyset, add_intercept,
                                                         partitions):
    keys = KEYSETS[keyset]
    joffheap.build_offheap_store(str(tmp_path / "jax"), keys, add_intercept, partitions)
    for force_python in (False, True):
        out = str(tmp_path / f"port-{force_python}")
        toffheap.build_offheap_store(out, keys, add_intercept, partitions,
                                     force_python=force_python)
        assert _files(out) == _files(str(tmp_path / "jax"))


@pytest.mark.parametrize("force_python", [False, True], ids=["native", "python"])
def test_lookups_equal_the_jax_store_and_the_in_memory_map(tmp_path, force_python):
    keys = KEYSETS["500 keys"]
    toffheap.build_offheap_store(str(tmp_path / "port"), keys, True, 4)
    joffheap.build_offheap_store(str(tmp_path / "jax"), keys, True, 4)
    ref = IndexMap.build(keys, add_intercept=True, num_partitions=4)
    # each package reads the other's store, with either reader
    for store_dir in (str(tmp_path / "port"), str(tmp_path / "jax")):
        port = toffheap.OffHeapIndexMap(store_dir, force_python=force_python)
        jax_ = joffheap.OffHeapIndexMap(store_dir, force_python=force_python)
        assert len(port) == len(jax_) == len(ref) == len(keys) + 1
        for k in keys + ["no-such-key\x01", INTERCEPT_KEY]:
            assert port.get_index(k) == jax_.get_index(k) == ref.get_index(k), k
        for i in range(-1, len(ref) + 1):
            assert port.get_feature_name(i) == jax_.get_feature_name(i) == ref.get_feature_name(i)
        assert port.intercept_index == ref.intercept_index
        assert port.name_to_index == ref.name_to_index
        port.close()
        jax_.close()


def test_native_and_python_readers_agree(tmp_path):
    keys = sorted(set(_keys(300, seed=2)))
    toffheap.build_offheap_store(str(tmp_path / "s"), keys, num_partitions=2)
    native = toffheap.OffHeapIndexMap(str(tmp_path / "s"))
    python = toffheap.OffHeapIndexMap(str(tmp_path / "s"), force_python=True)
    assert [native.get_index(k) for k in keys] == [python.get_index(k) for k in keys]
    assert [native.get_feature_name(i) for i in range(len(keys) + 1)] == \
        [python.get_feature_name(i) for i in range(len(keys) + 1)]
    assert "zzz\x01" not in native and "zzz\x01" not in python


def test_loaders_detect_the_store_and_the_json_map(tmp_path):
    keys = ["f1\x01", "f2\x01"]
    toffheap.build_offheap_store(str(tmp_path / "store"), keys)
    assert isinstance(toffheap.load_index_map(str(tmp_path / "store")), toffheap.OffHeapIndexMap)
    (tmp_path / "json").mkdir()
    IndexMap.build(keys).save(str(tmp_path / "json" / "feature-index.json"))
    m = toffheap.load_index_map(str(tmp_path / "json"))
    assert isinstance(m, IndexMap) and m.index_to_name == \
        JIndexMap.load(str(tmp_path / "json" / "feature-index.json")).index_to_name
    JIndexMap.build(keys).save(str(tmp_path / "feature-index-global.json"))
    assert toffheap.load_shard_index_map(str(tmp_path), "global").index_to_name == \
        ["f1\x01", "f2\x01", INTERCEPT_KEY]
    (tmp_path / "s2").mkdir()
    toffheap.build_offheap_store(str(tmp_path / "s2" / "global"), keys)
    assert isinstance(toffheap.load_shard_index_map(str(tmp_path / "s2"), "global"),
                      toffheap.OffHeapIndexMap)


@pytest.mark.parametrize("fmt,partitions", [("JSON", 1), ("JSON", 3), ("OFFHEAP", 1),
                                             ("OFFHEAP", 8)])
@pytest.mark.parametrize("sections", [None, "global:fixedFeatures|per_user:userFeatures"])
def test_feature_indexing_writes_the_jax_jobs_files(game_avro_dirs, tmp_path, fmt,  # noqa: F811
                                                    partitions, sections):
    train_dir, _, _ = game_avro_dirs
    argv = ["--data-input-dirs", train_dir, "--partition-num", str(partitions),
            "--format", fmt]
    if sections:
        argv += ["--feature-shard-id-to-feature-section-keys-map", sections,
                 "--feature-shard-id-to-intercept-map", "per_user:false"]
    got = tfeature_indexing.main(argv + ["--output-dir", str(tmp_path / "port")])
    want = jfeature_indexing.main(argv + ["--output-dir", str(tmp_path / "jax")])
    assert [os.path.relpath(p, str(tmp_path / "port")) for p in got] == \
        [os.path.relpath(p, str(tmp_path / "jax")) for p in want]
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
