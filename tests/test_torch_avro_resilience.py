"""The port's Avro retry and corrupt-block machinery against the JAX
package (CPU): a container with a corrupted block read with ``on_corrupt``
``raise`` (the same error, at the same block and offset) and ``skip`` (the
same records, within and beyond the budget), the process-wide config, a
transiently failing file healed by per-block retries, and a whole GAME read
whose file the native decoder rejects read by the row loop with the skip
policy, equal to the JAX read under the same policy. The ``io.read_block``
and ``io.index_load`` fault sites fire in both packages alike: the same
records read, the same fires counted, ``RetryError`` raised or not.
"""

import builtins

import numpy as np
import pytest

from photon_ml_tpu import resilience as jres
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import avro_data as javro_data
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.io import offheap as joffheap
from photon_ml_tpu.resilience import faults as jfaults
from photon_ml_tpu_torch import resilience as tres
from photon_ml_tpu_torch.io import offheap as toffheap
from photon_ml_tpu_torch.resilience import faults as tfaults
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import avro_data as tavro_data
from photon_ml_tpu_torch.io.index_map import IndexMap
from test_avro_io import _corrupt_block, _sync_positions, _write_blocks
from test_avro_native import TRAIN_SCHEMA, _train_records


def _both(path, **kwargs):
    """(port result or error, JAX result or error) of reading ``path``."""
    out = []
    for mod in (tavro, javro):
        try:
            out.append(list(mod.read_container(path, **kwargs)))
        except (tavro.CorruptBlockError, javro.CorruptBlockError) as e:
            out.append((type(e).__name__, e.path, e.block_index, e.offset, e.reason))
    return out


@pytest.mark.parametrize("block", [0, 1, 2])
@pytest.mark.parametrize("mode,budget", [("raise", 16), ("skip", 0), ("skip", 1), ("skip", 4)])
def test_corrupt_block_reads_as_in_the_jax_package(tmp_path, block, mode, budget):
    path = str(tmp_path / "part-0.avro")
    recs = _write_blocks(path)
    offset = _corrupt_block(path, block)
    got, want = _both(path, on_corrupt=mode, skip_budget=budget)
    assert got == want
    if mode == "skip" and budget >= 1:
        assert got == recs[:10 * block] + recs[10 * (block + 1):]
    else:
        assert got[:4] == ("CorruptBlockError", path, block, offset)


def test_truncated_file_and_two_corrupt_blocks_against_the_budget(tmp_path):
    path = str(tmp_path / "part-0.avro")
    _write_blocks(path, num_records=50)
    _corrupt_block(path, 1)
    _corrupt_block(path, 3)
    for budget in (1, 2):
        got, want = _both(path, on_corrupt="skip", skip_budget=budget)
        assert got == want
    data, syncs = _sync_positions(path)
    with open(path, "wb") as f:
        f.write(data[: syncs[2] - 5])
    got, want = _both(path)
    assert got == want
    got, want = _both(path, on_corrupt="skip", skip_budget=4)
    assert got == want


def test_the_process_config_drives_the_read(tmp_path):
    path = str(tmp_path / "part-0.avro")
    recs = _write_blocks(path)
    _corrupt_block(path, 2)
    with tres.resilience_scope(tres.ResilienceConfig(on_corrupt="skip", corrupt_skip_budget=1)):
        assert list(tavro.read_directory(str(tmp_path))) == recs[:20]
    with pytest.raises(tavro.CorruptBlockError):
        list(tavro.read_container(path))
    with pytest.raises(ValueError, match="on_corrupt"):
        tres.ResilienceConfig(on_corrupt="explode")
    with pytest.raises(ValueError, match="on_corrupt must be one of"):
        list(tavro.read_container(path, on_corrupt="explode"))


class _FlakyFile:
    """A file whose reads fail with OSError at the given read calls."""

    failed = []

    def __init__(self, f, fail_at):
        self._f, self._fail_at, self._calls = f, set(fail_at), 0

    def read(self, *a):
        self._calls += 1
        if self._calls in self._fail_at:
            self.failed.append(self._calls)
            raise OSError(f"transient read failure #{self._calls}")
        return self._f.read(*a)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


@pytest.mark.parametrize("fail_at", [(1,), (3, 40, 41), tuple(range(5, 400, 37))])
def test_transient_read_failures_heal_by_per_block_retries(tmp_path, monkeypatch, fail_at):
    path = str(tmp_path / "part-0.avro")
    recs = _write_blocks(path)
    real_open = builtins.open
    monkeypatch.setattr(tavro, "open", lambda p, m="r": _FlakyFile(real_open(p, m), fail_at),
                        raising=False)
    monkeypatch.setattr(_FlakyFile, "failed", [])
    policy = tres.RetryPolicy(max_attempts=3, base_delay=0.0)
    with tres.resilience_scope(tres.ResilienceConfig(io_policy=policy)):
        assert list(tavro.read_container(path)) == recs
    assert _FlakyFile.failed and set(_FlakyFile.failed) <= set(fail_at)
    with tres.resilience_scope(tres.ResilienceConfig(io_policy=tres.RetryPolicy.no_retry())):
        with pytest.raises(tres.RetryError):
            list(tavro.read_container(path))


@pytest.mark.parametrize("attempts,base", [(4, 0.05), (6, 0.2)])
def test_retry_policy_delays_match_the_jax_package(attempts, base):
    import random

    tp = tres.RetryPolicy(max_attempts=attempts, base_delay=base)
    jp = jres.RetryPolicy(max_attempts=attempts, base_delay=base)
    tr, jr = random.Random(0), random.Random(0)
    assert [tp.delay_for(a, tr) for a in range(attempts)] == \
        [jp.delay_for(a, jr) for a in range(attempts)]
    slept_t, slept_j = [], []
    for mod, slept in ((tres, slept_t), (jres, slept_j)):
        with pytest.raises(mod.RetryError):
            mod.call_with_retry(lambda: (_ for _ in ()).throw(OSError("x")),
                                mod.RetryPolicy(max_attempts=attempts, base_delay=base),
                                sleep=slept.append)
    assert slept_t == slept_j and len(slept_t) == attempts - 1


def test_game_read_of_a_corrupt_file_skips_as_the_jax_package(tmp_path, monkeypatch):
    recs = _train_records(120)
    for i, r in enumerate(recs):
        r["metadataMap"] = {"userId": f"user{i % 7}"}
    d = tmp_path / "data"
    d.mkdir()
    tavro.write_container(str(d / "part-0.avro"), recs[:60], TRAIN_SCHEMA)
    tavro.write_container(str(d / "part-1.avro"), recs[60:], TRAIN_SCHEMA, block_size=15)
    _corrupt_block(str(d / "part-1.avro"), 1)
    keys = tavro_data.collect_feature_keys([str(d / "part-0.avro")])
    maps, jmaps = {"g": IndexMap.build(keys)}, {"g": JIndexMap.build(keys)}
    args = ({"g": ["features"]}, ["userId"])
    with pytest.raises(tavro.CorruptBlockError):
        tavro_data.read_game_data([str(d)], maps, *args)
    before = dict(tavro_data.ingest_counts)
    with tres.resilience_scope(tres.ResilienceConfig(on_corrupt="skip", corrupt_skip_budget=2)):
        got = tavro_data.read_game_data([str(d)], maps, *args)
    assert tavro_data.ingest_counts["rejected_files"] == before["rejected_files"] + 1
    assert tavro_data.ingest_counts["row_loop_files"] == before["row_loop_files"] + 2
    with jres.resilience_scope(jres.ResilienceConfig(on_corrupt="skip", corrupt_skip_budget=2)):
        want = javro_data.read_game_data([str(d)], jmaps, *args)
    assert got.num_rows == want.num_rows == 105
    assert np.array_equal(got.response, want.response) and got.id_vocabs == want.id_vocabs
    assert np.array_equal(got.shards["g"].indices, want.shards["g"].indices)
    assert np.array_equal(got.shards["g"].values, want.shards["g"].values)


# ---------------------------------------------------------------------------
# the io.read_block and io.index_load fault sites, both packages alike
# ---------------------------------------------------------------------------

PACKAGES = {"port": (tres, tfaults), "jax": (jres, jfaults)}


def _under_faults(pkg, site, rate, attempts, seed, call):
    """(result or "RetryError", fires) of ``call()`` under one package's
    fault plan at ``site`` and retry policy."""
    res, faults = PACKAGES[pkg]
    plan = faults.FaultPlan([faults.FaultSpec(site, rate=rate, seed=seed, times=None)])
    cfg = res.ResilienceConfig(io_policy=res.RetryPolicy(max_attempts=attempts, base_delay=0.0))
    with faults.fault_scope(plan), res.resilience_scope(cfg):
        try:
            out = call()
        except res.RetryError:
            out = "RetryError"
    return out, plan.fire_count(site)


@pytest.mark.parametrize("rate,attempts", [(0.3, 8), (1.0, 2)])
def test_read_block_faults_heal_or_exhaust_as_in_the_jax_package(tmp_path, rate, attempts):
    """tests/test_avro_io.py's retryable-fault and retry-exhaustion cases:
    a 0.3 rate heals under 8 attempts, a certain fault exhausts 2."""
    path = str(tmp_path / "part-0.avro")
    recs = _write_blocks(path)
    got = _under_faults("port", "io.read_block", rate, attempts, 13,
                        lambda: list(tavro.read_container(path)))
    want = _under_faults("jax", "io.read_block", rate, attempts, 13,
                         lambda: list(javro.read_container(path)))
    assert got == want
    assert got[1] > 0
    assert got[0] == (recs if rate < 1.0 else "RetryError")


def test_the_native_whole_file_read_fires_read_block(tmp_path, monkeypatch):
    """The columnar GAME read's whole-file parse is the site at block -1:
    a certain fault exhausts the retries in both packages."""
    recs = _train_records(40)
    for i, r in enumerate(recs):
        r["metadataMap"] = {"userId": f"user{i % 5}"}
    d = tmp_path / "data"
    d.mkdir()
    tavro.write_container(str(d / "part-0.avro"), recs, TRAIN_SCHEMA)
    keys = tavro_data.collect_feature_keys([str(d / "part-0.avro")])
    args = ({"g": ["features"]}, ["userId"])
    blocks = []
    real_inject = tfaults.inject

    def spy(site, **context):
        if site == "io.read_block":
            blocks.append(context["block"])
        real_inject(site, **context)

    monkeypatch.setattr(tfaults, "inject", spy)
    got = _under_faults("port", "io.read_block", 1.0, 2, 3, lambda: tavro_data.read_game_data(
        [str(d)], {"g": IndexMap.build(keys)}, *args))
    want = _under_faults("jax", "io.read_block", 1.0, 2, 3, lambda: javro_data.read_game_data(
        [str(d)], {"g": JIndexMap.build(keys)}, *args))
    assert got == want == ("RetryError", 2)
    assert blocks == [-1, -1]


@pytest.mark.parametrize("loader", ["index_map", "offheap"])
@pytest.mark.parametrize("rate,attempts", [(0.5, 8), (1.0, 3)])
def test_index_load_fires_in_both_loaders_as_in_the_jax_package(tmp_path, loader, rate,
                                                                attempts):
    keys = [f"f{i}\u0001t" for i in range(12)]
    if loader == "index_map":
        path = str(tmp_path / "map.json")
        IndexMap.build(keys).save(path)

        def load_t():
            return IndexMap.load(path).index_to_name

        def load_j():
            return JIndexMap.load(path).index_to_name
    else:
        path = str(tmp_path / "store")
        toffheap.build_offheap_store(path, keys, num_partitions=2, force_python=True)

        def load_t():
            return [toffheap.OffHeapIndexMap(path, force_python=True).get_index(k) for k in keys]

        def load_j():
            return [joffheap.OffHeapIndexMap(path, force_python=True).get_index(k) for k in keys]
    got = _under_faults("port", "io.index_load", rate, attempts, 7, load_t)
    want = _under_faults("jax", "io.index_load", rate, attempts, 7, load_j)
    assert got == want
    assert got[1] > 0
    assert (got[0] == "RetryError") == (rate == 1.0)
