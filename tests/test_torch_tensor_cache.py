"""The port's tensor cache (photon_ml_tpu_torch/io/tensor_cache.py) against
the JAX package (CPU):

  * ``content_key``, ``file_stat_token``, ``index_map_digest`` and
    ``process_shard_scope`` equal the JAX package's for the same files and
    configs, the drivers' config dicts included;
  * an entry written by the port is byte-equal to the JAX package's for the
    same arrays and meta, and each package reads the other's;
  * hit, miss, config and source invalidation, a broken entry, read and
    write faults, directory entries and ``invalidate``: the cases of
    ``tests/test_pipeline.py::TestTensorCache``;
  * ``game_data_to_arrays`` round trips (arrays copied out of the memory
    maps), and a cached random-effect dataset equals the built one.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.data.game import game_data_to_arrays as j_to_arrays
from photon_ml_tpu.io import tensor_cache as jtc
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.io import tensor_cache as ttc
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.resilience import RetryError, faults
from photon_ml_tpu_torch.retrain import manifest as tmanifest
from test_torch_game import _port_data


@pytest.fixture
def cache(tmp_path):
    return ttc.TensorCache(str(tmp_path / "tcache"), stats=ttc.CacheStats())


@pytest.fixture
def sources(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"part-{i}.avro"
        p.write_bytes(b"x" * (10 + i))
        paths.append(str(p))
    return paths


CONFIGS = [
    {"kind": "game_data", "sections": {"global": ["f"], "per_user": ["u"]},
     "intercepts": {"global": True}, "id_types": ["userId"], "ladder": None,
     "index_maps": {"global": "ab", "per_user": "cd"}},
    {"kind": "glm_stream_chunks", "chunk_rows": 32768, "format": "LIBSVM",
     "fields": "TRAINING_EXAMPLE", "intercept": True, "index_map": "00"},
    {"kind": "streaming_re_blocks", "budget": 4000, "ladder": "8:2", "lam": 0.1},
    {},
]


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c.get("kind", "empty"))
@pytest.mark.parametrize("scope", [None, "process=0/2", "process=1/4;blocks=0-3"])
def test_keys_equal_the_jax_packages(sources, config, scope):
    assert ttc.content_key(sources, config, scope) == jtc.content_key(sources, config, scope)
    assert ttc.file_stat_token(sources) == jtc.file_stat_token(sources)
    assert ttc.process_shard_scope(1, 4) == jtc.process_shard_scope(1, 4)
    assert ttc.process_shard_scope(0, 2, "b") == jtc.process_shard_scope(0, 2, "b")


def test_driver_config_dicts_key_alike(sources):
    """The GAME driver hashes ``dataclasses.asdict`` of the random-effect
    config: the port's carries the JAX field names and values."""
    for kw in (dict(), dict(active_upper_bound=7, features_to_samples_ratio=0.1,
                            projector="IDENTITY", seed=3)):
        t = dataclasses.asdict(tgame.RandomEffectDataConfig("userId", "per_user", **kw))
        j = dataclasses.asdict(JReConfig("userId", "per_user", **kw))
        assert list(t) == list(j) and t == j
        cfg = {"kind": "re_dataset", "coord": "per-user"}
        assert ttc.content_key(sources, {**cfg, "config": t}) == \
            jtc.content_key(sources, {**cfg, "config": j})


def test_index_map_digest_equals_the_jax_packages():
    keys = [f"f{i}\x01t{i % 3}" for i in range(40)]
    for parts in (1, 4):
        t = IndexMap.build(keys, add_intercept=True, num_partitions=parts)
        j = JIndexMap.build(keys, add_intercept=True, num_partitions=parts)
        assert ttc.index_map_digest(t) == jtc.index_map_digest(j)
    # the retrain manifest uses the same functions
    assert tmanifest.index_map_digest is ttc.index_map_digest
    assert tmanifest.file_stat_token is ttc.file_stat_token


def test_entry_bytes_equal_and_each_reads_the_others(tmp_path):
    arrays = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "ids~userId": np.asarray([3, 1, 2], np.int32)}
    meta = {"num_entities": 3, "global_dim": 4, "vocab": ["a", "é"]}
    key = ttc.content_key([], {"t": 1})
    t_entry = ttc.TensorCache(str(tmp_path / "t")).put(key, arrays, meta)
    j_entry = jtc.TensorCache(str(tmp_path / "j")).put(key, arrays, meta)
    assert sorted(os.listdir(t_entry)) == sorted(os.listdir(j_entry))
    for name in os.listdir(t_entry):
        with open(os.path.join(t_entry, name), "rb") as a, open(os.path.join(j_entry, name),
                                                                "rb") as b:
            assert a.read() == b.read(), name
    got = ttc.TensorCache(str(tmp_path / "j")).get(key)
    want = jtc.TensorCache(str(tmp_path / "t")).get(key)
    assert got.meta == want.meta == meta
    for k in arrays:
        assert np.array_equal(got.arrays[k], arrays[k]) and np.array_equal(want.arrays[k],
                                                                           arrays[k])


class TestTensorCache:
    def test_miss_then_hit_roundtrip(self, cache):
        key = ttc.content_key([], {"a": 1})
        assert cache.get(key) is None
        arrays = {"x": np.arange(12, dtype=np.float32).reshape(3, 4), "y": np.asarray([1, 2, 3])}
        cache.put(key, arrays, meta={"n": 3})
        hit = cache.get(key)
        assert hit.meta == {"n": 3}
        for k in arrays:
            assert np.array_equal(hit.arrays[k], arrays[k])
            assert isinstance(hit.arrays[k], np.memmap) and not hit.arrays[k].flags.writeable
        s = cache.stats.snapshot()
        assert (s["hits"], s["misses"], s["writes"]) == (1, 1, 1)
        assert s["bytes_reused"] == sum(a.nbytes for a in arrays.values())
        assert "1 hits / 1 misses (50% hit rate)" in cache.stats.summary()

    def test_config_change_is_a_miss(self, cache, tmp_path):
        src = tmp_path / "part-0.bin"
        src.write_bytes(b"data")
        k1 = cache.key_for([str(src)], {"cap": 10})
        k2 = cache.key_for([str(src)], {"cap": 11})
        assert k1 != k2
        cache.put(k1, {"x": np.zeros(2)})
        assert cache.get(k2) is None

    def test_source_change_is_a_miss(self, cache, tmp_path):
        src = tmp_path / "part-0.bin"
        src.write_bytes(b"data")
        k1 = cache.key_for([str(src)], {"cap": 10})
        src.write_bytes(b"data2")
        assert cache.key_for([str(src)], {"cap": 10}) != k1

    def test_shard_scope_changes_every_key(self, tmp_path):
        a = ttc.TensorCache(str(tmp_path / "a"), shard_scope=ttc.process_shard_scope(0, 2))
        b = ttc.TensorCache(str(tmp_path / "b"), shard_scope=ttc.process_shard_scope(1, 2))
        assert a.key_for([], {"k": 1}) != b.key_for([], {"k": 1})
        assert a.key_for([], {"k": 1}) == jtc.TensorCache(
            str(tmp_path / "c"), shard_scope="process=0/2").key_for([], {"k": 1})

    def test_broken_entry_degrades_to_miss(self, cache):
        key = ttc.content_key([], {"b": 1})
        cache.put(key, {"x": np.zeros(4)})
        with open(os.path.join(cache.entry_dir(key), "meta.json"), "w") as f:
            f.write("{not json")
        assert cache.get(key) is None
        assert not os.path.exists(cache.entry_dir(key))
        assert cache.stats.snapshot()["broken"] == 1

    def test_truncated_array_degrades_to_miss(self, cache):
        key = ttc.content_key([], {"t": 1})
        entry = cache.put(key, {"x": np.zeros(64)})
        with open(os.path.join(entry, "x.npy"), "r+b") as f:
            f.truncate(40)
        assert cache.get(key) is None and not os.path.exists(entry)

    def test_read_fault_retries_then_degrades_to_miss(self, cache):
        key = ttc.content_key([], {"c": 1})
        cache.put(key, {"x": np.ones(3)})
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec(site="io.cache_read", at=1, kind="io")])):
            assert cache.get(key) is not None
        cache.put(key, {"x": np.ones(3)})
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec(site="io.cache_read", rate=1.0, kind="io")])):
            assert cache.get(key) is None
            assert cache.get_dir(key) is None

    def test_write_fault_retries_then_raises(self, cache):
        key = ttc.content_key([], {"d": 1})
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec(site="io.cache_write", at=1, kind="io")])):
            cache.put(key, {"x": np.zeros(2)})
        assert cache.get(key) is not None
        key2 = ttc.content_key([], {"d": 2})
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec(site="io.cache_write", rate=1.0, kind="io")])):
            with pytest.raises(RetryError):
                cache.put(key2, {"x": np.zeros(2)})
        assert cache.get(key2) is None
        # nothing half-written is left beside the entries
        assert not [d for d in os.listdir(os.path.dirname(cache.entry_dir(key2)))
                    if d.startswith(".tmp-")]

    def test_dir_entries(self, cache):
        key = ttc.content_key([], {"e": 1})
        assert cache.get_dir(key) is None

        def build(tmp):
            with open(os.path.join(tmp, "blob.txt"), "w") as f:
                f.write("payload")

        entry = cache.build_dir(key, build)
        assert cache.get_dir(key) == entry and cache.has(key)
        with open(os.path.join(entry, "blob.txt")) as f:
            assert f.read() == "payload"

    def test_invalidate(self, cache):
        key = ttc.content_key([], {"i": 1})
        assert cache.invalidate(key) is False
        cache.put(key, {"x": np.zeros(2)})
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec(site="io.cache_invalidate", rate=1.0, kind="io")])):
            assert cache.invalidate(key) is False  # a failed removal is a no-op
        assert cache.has(key)
        assert cache.invalidate(key) is True and not cache.has(key)
        assert cache.stats.snapshot()["invalidations"] == 1

    def test_bad_array_name_is_refused(self, cache):
        with pytest.raises(ValueError, match="bad cache array name"):
            cache.put(ttc.content_key([], {"n": 1}), {"../x": np.zeros(1)})


@pytest.fixture(scope="module")
def glmix():
    jdata, _ = make_glmix_data(np.random.default_rng(83), num_users=48,
                               rows_per_user_range=(4, 20), d_fixed=4, d_random=3)
    return jdata, _port_data(jdata)


def test_game_data_round_trips_through_the_cache(glmix, tmp_path):
    jdata, tdata = glmix
    arrays, meta = tgame.game_data_to_arrays(tdata)
    jarrays, jmeta = j_to_arrays(jdata)
    assert meta == jmeta and sorted(arrays) == sorted(jarrays)
    cache = ttc.TensorCache(str(tmp_path / "c"))
    key = cache.key_for([], {"kind": "game_data"})
    cache.put(key, arrays, meta)
    hit = cache.get(key)
    back = tgame.game_data_from_arrays(hit.arrays, hit.meta)
    for name in ("response", "offset", "weight"):
        got = getattr(back, name)
        assert not isinstance(got, np.memmap) and got.flags.writeable
        assert got.tobytes() == getattr(tdata, name).tobytes()
    assert back.id_vocabs == tdata.id_vocabs
    for k in tdata.ids:
        assert np.array_equal(back.ids[k], tdata.ids[k])
    for k, f in tdata.shards.items():
        g = back.shards[k]
        assert g.dim == f.dim
        for a in ("indptr", "indices", "values"):
            assert getattr(g, a).tobytes() == getattr(f, a).tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(projector="IDENTITY", active_upper_bound=6)],
                         ids=["index-map", "identity-capped"])
def test_cached_re_dataset_equals_the_built_one(glmix, tmp_path, kw):
    jdata, tdata = glmix
    cfg = tgame.RandomEffectDataConfig("userId", "per_user", **kw)
    cache = ttc.TensorCache(str(tmp_path / "c"))
    key = cache.key_for([], {"kind": "re_dataset", "config": dataclasses.asdict(cfg)})
    built = tgame.build_random_effect_dataset(tdata, cfg, device="cpu", tensor_cache=cache,
                                              cache_key=key)
    hit = cache.get(key)
    assert hit is not None and hit.meta == {"num_entities": built.num_entities,
                                            "global_dim": built.global_dim}
    cached = tgame.build_random_effect_dataset(tdata, cfg, device="cpu", tensor_cache=cache,
                                               cache_key=key)
    want = j_build(jdata, JReConfig("userId", "per_user", **kw))
    for f in tgame.RandomEffectDataset.TENSOR_FIELDS:
        a, b = getattr(cached, f), getattr(built, f)
        assert isinstance(a, torch.Tensor) and torch.equal(a, b), f
        assert a.numpy().tobytes() == np.asarray(getattr(want, f)).tobytes(), f
        # a private copy: writing it leaves the cache entry alone
        a.reshape(-1)[:1] = 0
    assert cache.get(key).arrays["x"].tobytes() == built.x.numpy().tobytes()
    # the JAX package reads the port's entry
    jds = j_build(jdata, JReConfig("userId", "per_user", **kw),
                  tensor_cache=jtc.TensorCache(str(tmp_path / "c")), cache_key=key)
    assert np.asarray(jds.x).tobytes() == built.x.numpy().tobytes()
