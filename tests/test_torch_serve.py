"""The port's single-host serving layer (photon_ml_tpu_torch/serve and
cli/serve_driver) against the JAX package's, on the CPU.

  * Stores: both packages' ``build_model_store`` on one saved model write
    the same bytes for f32, bf16 and int8, and each package opens the
    other's store; ``SlabRowIndex`` rows are equal across packages.
  * Parity: concurrent single-row requests through the port's server
    (``device="cpu"``, ``max_batch_rows=16``) are ``np.array_equal`` to the
    port's batch scoring driver, and within ``elementwise`` of the JAX
    server; bf16/int8 scores within ``quant_score_budget``.
  * Ports of tests/test_serve.py's ModelStore, MicroBatcher, ModelSwap,
    JSON-lines, ServeStats, ServeDriver and quantized-store cases, with
    their assertions kept. A "compile" in the port is the first sight of a
    batch shape at a scoring site (serve/server.py).
  * The training driver's ``--export-serve-store`` writes the bytes
    ``build_model_store`` writes for its best model.
"""

import concurrent.futures
import io
import json
import os
import shutil
import threading

import numpy as np
import pytest

from game_test_utils import (
    assert_scores_match_store,
    game_avro_records,
    make_glmix_data,
    save_synthetic_game_model,
    serve_requests_from_records,
    write_game_avro,
)
from tolerances import assert_allclose

from photon_ml_tpu.compile import ShapeBucketer as JShapeBucketer
from photon_ml_tpu.io import offheap as joffheap
from photon_ml_tpu.serve import ModelStore as JModelStore
from photon_ml_tpu.serve import ScoringServer as JScoringServer
from photon_ml_tpu.serve import ServeStats as JServeStats
from photon_ml_tpu.serve import build_model_store as jbuild_model_store
from photon_ml_tpu_torch.checkpoint import CheckpointRefError, rebuild_from_ref
from photon_ml_tpu_torch.compile import ShapeBucketer, compile_stats
from photon_ml_tpu_torch.io import offheap as toffheap
from photon_ml_tpu_torch.serve import (
    MicroBatcher,
    ModelStore,
    ModelSwapper,
    RowBatch,
    ScoringServer,
    ServeStats,
    build_model_store,
    is_model_store,
    quantize,
    serve_json_lines,
)

pytestmark = pytest.mark.serve

SECTIONS = {"global": ["fixedFeatures"], "per_user": ["userFeatures"]}
SECTIONS_FLAG = "global:fixedFeatures|per_user:userFeatures"
DTYPES = ("f32", "bf16", "int8")


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def serving_world(tmp_path_factory):
    """One synthetic model + Avro scoring inputs (with offsets) + the f32,
    bf16 and int8 stores each package exports from it."""
    base = tmp_path_factory.mktemp("tserve")
    rng = np.random.default_rng(42)
    data, truth = make_glmix_data(
        rng, num_users=10, rows_per_user_range=(6, 12), d_fixed=5, d_random=3
    )
    offsets = rng.normal(size=data.num_rows).astype(np.float32)
    model_dir = str(base / "model")
    w_fixed, entity_means, _, _ = save_synthetic_game_model(
        model_dir, rng, d_fixed=5, d_random=3, num_users=10
    )
    in_dir = base / "in"
    in_dir.mkdir()
    write_game_avro(str(in_dir / "part-0.avro"), data, range(data.num_rows), truth, offsets)
    stores, jstores, metas = {}, {}, {}
    for dt in DTYPES:
        stores[dt] = str(base / f"store-{dt}")
        jstores[dt] = str(base / f"jstore-{dt}")
        metas[dt] = build_model_store(model_dir, stores[dt], bucketer=ShapeBucketer(),
                                      store_dtype=dt)
        jbuild_model_store(model_dir, jstores[dt], bucketer=JShapeBucketer(), store_dtype=dt)
    records = list(game_avro_records(data, range(data.num_rows), truth, offsets))
    return {
        "base": base,
        "model_dir": model_dir,
        "in_dir": str(in_dir),
        "store_dir": stores["f32"],
        "stores": stores,
        "jstores": jstores,
        "metas": metas,
        "records": records,
        "requests": serve_requests_from_records(records),
        "w_fixed": w_fixed,
        "entity_means": entity_means,
    }


def _run_scoring_driver(world, out_dir, store_dir=None):
    from photon_ml_tpu_torch.cli import game_scoring_driver

    return game_scoring_driver.main([
        "--input-dirs", world["in_dir"],
        "--game-model-input-dir", world["model_dir"],
        "--output-dir", str(out_dir),
        "--offheap-indexmap-dir", os.path.join(store_dir or world["store_dir"], "features"),
        "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
        "--evaluator-type", "AUC,RMSE",
        "--delete-output-dir-if-exists", "true",
        "--device", "cpu",
    ])


def _server(store_dir, max_batch_rows=16, max_wait_ms=5.0, warm_nnz=8):
    server = ScoringServer(ModelStore(store_dir), shard_sections=SECTIONS,
                           max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
                           stats=ServeStats(), device="cpu")
    if warm_nnz:
        server.warmup(warm_nnz=warm_nnz)
    return server


def _second_model(world, name, seed, num_users=10, store_dtype="f32"):
    """A perturbed model (SAME entity count: same ladder rung) and its store."""
    model = str(world["base"] / f"model-{name}")
    store = str(world["base"] / f"store-{name}")
    if not os.path.isdir(store):
        save_synthetic_game_model(model, np.random.default_rng(seed), d_fixed=5, d_random=3,
                                  num_users=num_users)
        build_model_store(model, store, bucketer=ShapeBucketer(), store_dtype=store_dtype)
    return store


# ---------------------------------------------------------------------------
# the store, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_both_packages_write_the_same_store_bytes(serving_world, dtype):
    port = _tree_bytes(serving_world["stores"][dtype])
    jax_ = _tree_bytes(serving_world["jstores"][dtype])
    assert sorted(port) == sorted(jax_)
    for name in port:
        if name == "meta.json":
            a, b = json.loads(port[name]), json.loads(jax_[name])
            assert a.pop("source_model_dir") == b.pop("source_model_dir")
            assert a == b
        assert port[name] == jax_[name], name


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_package_opens_the_others_store(serving_world, dtype):
    port_of_jax = ModelStore(serving_world["jstores"][dtype])
    jax_of_port = JModelStore(serving_world["stores"][dtype])
    assert port_of_jax.store_dtype == jax_of_port.store_dtype == dtype
    for a, b in zip(port_of_jax.random, jax_of_port.random):
        assert a.name == b.name and a.entities == b.entities
        assert np.array_equal(a.dequantized(), b.dequantized())
        for raw in serving_world["entity_means"]:
            assert a.rows.get_row(raw) == b.rows.get_row(raw)
    for a, b in zip(port_of_jax.fixed, jax_of_port.fixed):
        assert np.array_equal(np.asarray(a.coefficients), np.asarray(b.coefficients))
    assert port_of_jax.meta["shards"] == jax_of_port.meta["shards"]
    port_of_jax.close()
    jax_of_port.close()


@pytest.mark.parametrize("partitions,force_python", [(1, False), (3, False), (3, True)])
def test_slab_row_index_rows_equal_the_jax_rows(tmp_path, partitions, force_python):
    rng = np.random.default_rng(partitions)
    keys = sorted({f"user{int(k)}" for k in rng.integers(0, 10_000, size=700)} | {"é", "a b"})
    toffheap.build_slab_index(str(tmp_path / "t"), keys, num_partitions=partitions,
                              force_python=force_python)
    joffheap.build_slab_index(str(tmp_path / "j"), keys, num_partitions=partitions)
    assert _tree_bytes(str(tmp_path / "t")) == _tree_bytes(str(tmp_path / "j"))
    t = toffheap.open_slab_index(str(tmp_path / "t"), force_python=force_python)
    j = joffheap.open_slab_index(str(tmp_path / "j"))
    assert t.num_rows == j.num_rows == len(keys)
    rows = [t.get_row(k) for k in keys]
    assert rows == [j.get_row(k) for k in keys]
    assert sorted(rows) == list(range(len(keys)))
    assert [t.row_key(r) for r in rows] == keys
    assert t.get_row("never-seen") == j.get_row("never-seen") == -1
    t.close()
    j.close()
    toffheap.build_offheap_store(str(tmp_path / "f"), keys, add_intercept=True)
    with pytest.raises(IOError, match="intercept"):
        toffheap.SlabRowIndex(str(tmp_path / "f"))


# ---------------------------------------------------------------------------
# ModelStore (tests/test_serve.py::TestModelStore)
# ---------------------------------------------------------------------------


class TestModelStore:
    def test_detect_and_meta(self, serving_world):
        assert is_model_store(serving_world["store_dir"])
        assert not is_model_store(serving_world["model_dir"])
        store = ModelStore(serving_world["store_dir"])
        assert [f.name for f in store.fixed] == ["fixed"]
        assert [r.name for r in store.random] == ["per-user"]
        assert store.meta["shards"]["global"]["dim"] == 6  # 5 features + intercept
        store.close()

    def test_fixed_coefficients_roundtrip(self, serving_world):
        store = ModelStore(serving_world["store_dir"])
        w = np.asarray(store.fixed[0].coefficients)
        assert sorted(np.round(w, 6)) == sorted(np.round(serving_world["w_fixed"], 6))
        store.close()

    def test_entity_rows_and_slab(self, serving_world):
        store = ModelStore(serving_world["store_dir"])
        re = store.random[0]
        assert re.entities == 10
        assert re.slab.shape[0] == 16  # ladder-padded: 10 -> 16
        for raw, vec in serving_world["entity_means"].items():
            row = store.entity_row("per-user", raw)
            assert 0 <= row < 10
            assert sorted(np.round(np.asarray(re.slab[row]), 6)) == sorted(np.round(vec, 6))
        assert store.entity_row("per-user", "never-seen") == -1
        assert store.entity_row("per-user", None) == -1
        assert not np.asarray(re.slab[10:]).any()
        assert len(store.feature_maps["per_user"]) == 4
        store.close()

    def test_checkpoint_ref_roundtrip(self, serving_world):
        store = ModelStore(serving_world["store_dir"])
        rebuilt = rebuild_from_ref(store, store.__checkpoint_ref__())
        assert rebuilt.store_dir == store.store_dir
        rebuilt.close()
        with pytest.raises(CheckpointRefError):
            rebuild_from_ref(store, {"kind": "game-serve-store", "store_dir": "/nonexistent"})
        with pytest.raises(CheckpointRefError):
            rebuild_from_ref(store, {"kind": "something-else"})
        store.close()

    def test_unknown_coordinate_raises(self, serving_world):
        store = ModelStore(serving_world["store_dir"])
        with pytest.raises(KeyError):
            store.entity_row("no-such-coordinate", "u0")
        store.close()

    def test_factored_coordinate_exports_projected_back_with_the_warning(self, tmp_path, caplog):
        from photon_ml_tpu.io import model_io as jmodel_io
        from photon_ml_tpu.io.index_map import IndexMap, feature_key
        from photon_ml_tpu.types import TaskType

        # the training drivers' layout: the projected-back coefficients and
        # the latent structure beside them
        rng = np.random.default_rng(5)
        umap = IndexMap.build([feature_key(f"u{j}", "") for j in range(4)], add_intercept=True)
        factors = {f"u{i}": rng.normal(size=2).astype(np.float32) for i in range(6)}
        matrix = rng.normal(size=(2, len(umap))).astype(np.float32)
        model = str(tmp_path / "model")
        jmodel_io.save_random_effect(
            model, "per-user", TaskType.LOGISTIC_REGRESSION,
            {k: v @ matrix for k, v in factors.items()}, umap,
            random_effect_id="userId", feature_shard_id="per_user")
        jmodel_io.save_factored_random_effect(
            model, "per-user", factors, matrix, random_effect_id="userId",
            feature_shard_id="per_user", index_map=umap)
        with caplog.at_level("WARNING"):
            build_model_store(model, str(tmp_path / "t"))
        assert any("is factored" in r.getMessage() for r in caplog.records)
        jbuild_model_store(model, str(tmp_path / "j"))
        assert _tree_bytes(str(tmp_path / "t"))["random/per-user/slab.npy"] == \
            _tree_bytes(str(tmp_path / "j"))["random/per-user/slab.npy"]


# ---------------------------------------------------------------------------
# MicroBatcher (tests/test_serve.py::TestMicroBatcher)
# ---------------------------------------------------------------------------


def _one_row_batch(value: float, k: int = 2) -> RowBatch:
    return RowBatch(
        offset=np.asarray([value], np.float32),
        shard_idx={"s": np.zeros((1, k), np.int32)},
        shard_val={"s": np.zeros((1, k), np.float32)},
        ent_row={"c": np.asarray([-1], np.int32)},
    )


class TestMicroBatcher:
    def test_coalesces_and_slices(self):
        seen = []

        def score(batch):
            seen.append(batch.num_rows)
            return batch.offset * 2.0

        b = MicroBatcher(score, max_batch_rows=64, max_wait_ms=50.0,
                         bucketer=ShapeBucketer(), stats=ServeStats()).start()
        futs = [b.submit(_one_row_batch(float(i))) for i in range(20)]
        got = np.concatenate([f.result() for f in futs])
        np.testing.assert_array_equal(got, np.arange(20, dtype=np.float32) * 2)
        b.close()
        assert len(seen) < 20
        assert all(n in (8, 16, 32, 64) for n in seen)
        snap = b.stats.snapshot()
        assert snap["requests"] == 20
        assert 0 < snap["batch_fill_ratio"] <= 1.0

    def test_padded_rows_and_nnz_follow_the_ladder(self):
        batch = RowBatch.concat([_one_row_batch(1.0, k=3), _one_row_batch(2.0, k=5)])
        assert batch.shard_idx["s"].shape == (2, 5)
        padded = batch.padded(ShapeBucketer())
        assert padded.num_rows == 8 and padded.shard_val["s"].shape == (8, 8)
        assert (padded.ent_row["c"][2:] == -1).all() and not padded.offset[2:].any()
        assert batch.padded(None) is batch

    def test_wait_bound_flushes_single_request(self):
        b = MicroBatcher(lambda batch: batch.offset, max_batch_rows=1024, max_wait_ms=5.0,
                         bucketer=None, stats=ServeStats()).start()
        assert b.submit(_one_row_batch(3.0)).result(timeout=10) == [3.0]
        b.close()

    def test_batch_cap_flushes_without_wait(self):
        release = threading.Event()
        calls = []

        def score(batch):
            release.wait(10)
            calls.append(batch.num_rows)
            return batch.offset

        b = MicroBatcher(score, max_batch_rows=4, max_wait_ms=10_000.0,
                         bucketer=None, stats=ServeStats()).start()
        futs = [b.submit(_one_row_batch(float(i))) for i in range(8)]
        release.set()
        for f in futs:
            f.result(timeout=10)
        b.close()
        assert max(calls) <= 4 and len(calls) >= 2

    def test_multi_row_requests_never_overshoot_cap(self):
        release = threading.Event()
        calls = []

        def score(batch):
            release.wait(30)
            calls.append(batch.num_rows)
            return batch.offset

        b = MicroBatcher(score, max_batch_rows=8, max_wait_ms=10_000.0,
                         bucketer=None, stats=ServeStats()).start()
        sizes = [6, 5, 4, 8, 3]  # 6+5 would overshoot; so would 4+8
        futs = [b.submit(RowBatch(offset=np.arange(n, dtype=np.float32),
                                  shard_idx={"g": np.zeros((n, 1), np.int32)},
                                  shard_val={"g": np.zeros((n, 1), np.float32)},
                                  ent_row={}))
                for n in sizes]
        release.set()
        for f, n in zip(futs, sizes):
            np.testing.assert_array_equal(f.result(timeout=30), np.arange(n, dtype=np.float32))
        b.close()
        assert max(calls) <= 8

    def test_error_fans_to_all_members(self):
        def score(batch):
            raise RuntimeError("device fell over")

        b = MicroBatcher(score, max_batch_rows=8, max_wait_ms=20.0,
                         bucketer=None, stats=ServeStats()).start()
        futs = [b.submit(_one_row_batch(1.0)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fell over"):
                f.result(timeout=10)
        assert b.stats.snapshot()["errors"] >= 1
        b.close()

    def test_drain_fence(self):
        b = MicroBatcher(lambda batch: batch.offset, max_batch_rows=8, max_wait_ms=1.0,
                         bucketer=None, stats=ServeStats()).start()
        futs = [b.submit(_one_row_batch(float(i))) for i in range(10)]
        assert b.drain(timeout=10)
        assert all(f.done() for f in futs)
        assert b.outstanding() == 0
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(_one_row_batch(0.0))

    def test_score_fn_pinning_groups_generations(self):
        calls = []

        def fn_a(batch):
            calls.append(("a", batch.num_rows))
            return batch.offset

        def fn_b(batch):
            calls.append(("b", batch.num_rows))
            return batch.offset + 100.0

        b = MicroBatcher(fn_a, max_batch_rows=64, max_wait_ms=100.0,
                         bucketer=None, stats=ServeStats()).start()
        futs = [b.submit(_one_row_batch(float(i)), score_fn=fn_a if i % 2 == 0 else fn_b)
                for i in range(6)]
        vals = np.concatenate([f.result(timeout=10) for f in futs])
        b.close()
        np.testing.assert_array_equal(vals, np.asarray([0, 101, 2, 103, 4, 105], np.float32))


# ---------------------------------------------------------------------------
# parity: the port's server against its batch driver and the JAX server
# ---------------------------------------------------------------------------


class TestServingParity:
    def test_served_scores_bitwise_equal_batch_driver(self, serving_world, tmp_path):
        """Concurrent single-row requests through the micro-batched server
        == the port's batch scoring driver, bitwise; within elementwise of
        the JAX server's."""
        drv = _run_scoring_driver(serving_world, tmp_path / "drv")
        server = _server(serving_world["store_dir"])
        wm = compile_stats.watermark()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(lambda q: server.submit_rows([q]), serving_world["requests"]))
        served = np.concatenate([f.result(timeout=60) for f in futs])
        assert served.dtype == np.float32
        assert np.array_equal(served, drv.scores)
        assert wm.new_traces() == 0
        assert server.new_request_compiles() == 0
        assert not server.fully_warm()  # the port has no persistent cache
        snap = server.stats.snapshot()
        assert snap["requests"] == len(serving_world["requests"])
        assert snap["batches"] < snap["requests"]
        server.close()
        jserver = JScoringServer(JModelStore(serving_world["jstores"]["f32"]),
                                 shard_sections=SECTIONS, max_batch_rows=16, max_wait_ms=5.0,
                                 stats=JServeStats())
        jserved = jserver.score_rows(serving_world["requests"])
        jserver.close()
        assert_allclose(served, jserved, kind="elementwise")

    def test_multi_row_requests_and_cold_entities(self, serving_world, tmp_path):
        drv = _run_scoring_driver(serving_world, tmp_path / "drv2")
        server = _server(serving_world["store_dir"], max_batch_rows=32, max_wait_ms=1.0)
        reqs = serving_world["requests"]
        served = server.score_rows(reqs)  # wider than the cap: split
        assert np.array_equal(served, drv.scores)
        assert len(reqs) > server.batcher.max_batch_rows
        assert server.new_request_compiles() == 0
        cold = dict(reqs[0], ids={"userId": "cold-user-999"})
        base = dict(reqs[0], ids={})
        np.testing.assert_array_equal(server.score_rows([cold]), server.score_rows([base]))
        server.close()

    def test_empty_rows(self, serving_world):
        server = _server(serving_world["store_dir"], max_batch_rows=8, warm_nnz=None)
        assert server.score_rows([]).shape == (0,)
        server.close()

    def test_a_request_past_the_warmed_nnz_is_one_new_shape(self, serving_world):
        server = ScoringServer(ModelStore(serving_world["store_dir"]), shard_sections=SECTIONS,
                               bucketer="2:2", max_batch_rows=2, stats=ServeStats(),
                               device="cpu")
        assert server.warmup(warm_nnz=2)["nnz_rungs"] == [2]
        server.score_rows(serving_world["requests"][:1])  # 6 fixed nnz: rung 8
        assert server.new_request_compiles() > 0
        server.close()

    def test_cuda_without_a_card_raises(self, serving_world):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has a card: the no-card refusal cannot be exercised")
        store = ModelStore(serving_world["store_dir"])
        with pytest.raises(RuntimeError, match="cuda"):
            ScoringServer(store, shard_sections=SECTIONS, stats=ServeStats())
        store.close()


# ---------------------------------------------------------------------------
# quantized stores (tests/test_serve.py::TestQuantizedStore)
# ---------------------------------------------------------------------------


class TestQuantizedStore:
    def test_export_bytes_and_pinned_budget(self, serving_world):
        stores = serving_world["stores"]
        f32_bytes = os.path.getsize(os.path.join(stores["f32"], "random", "per-user", "slab.npy"))
        true_slab = np.asarray(ModelStore(stores["f32"]).random[0].slab)
        for dt in ("bf16", "int8"):
            store = ModelStore(stores[dt])
            assert store.store_dtype == dt
            re = store.random[0]
            q = re.quantization
            assert 0 < q["realized_max_abs_coeff_err"] <= q["coeff_err_budget"]
            row_budget = quantize.row_coeff_budget(dt, np.max(np.abs(true_slab), axis=1))
            err = np.abs(re.dequantized().astype(np.float64) - true_slab)
            assert np.all(err <= row_budget[:, None])
            got = os.path.getsize(os.path.join(stores[dt], "random", "per-user", "slab.npy"))
            if dt == "bf16":
                assert got <= 0.55 * f32_bytes + 128
            else:
                scales = os.path.getsize(
                    os.path.join(stores[dt], "random", "per-user", "scales.npy"))
                assert got + scales <= 0.55 * f32_bytes + 256
            store.close()

    def test_bf16_bits_equal_ml_dtypes_on_ties_subnormals_and_specials(self):
        import ml_dtypes

        rng = np.random.default_rng(7)
        u = rng.integers(0, 2 ** 32, size=200_000, dtype=np.uint64).astype(np.uint32)
        ties = (rng.integers(0, 2 ** 16, size=20_000).astype(np.uint32) << 16) | 0x8000
        subnormal = rng.integers(1, 1 << 23, size=20_000).astype(np.uint32)
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38,
                            1e-45, -1e-45], np.float32).view(np.uint32)
        for bits in (u, ties.astype(np.uint32), subnormal, subnormal | 0x80000000, special):
            x = bits.view(np.float32)
            with np.errstate(invalid="ignore", over="ignore"):
                want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
            got = quantize.f32_to_bf16_bits(x)
            assert np.array_equal(got, want)
            assert np.array_equal(quantize.bf16_bits_to_f32(got).view(np.uint32),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32)
                                  .view(np.uint32))

    def test_version1_meta_opens_as_f32_and_future_version_refused(self, serving_world,
                                                                   tmp_path):
        v1 = str(tmp_path / "v1-store")
        shutil.copytree(serving_world["stores"]["f32"], v1)
        meta_path = os.path.join(v1, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["version"] = 1
        meta.pop("store_dtype", None)
        for e in meta["random"]:
            e.pop("quantization", None)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        store = ModelStore(v1)
        assert store.store_dtype == "f32"
        assert store.random[0].scales is None
        store.close()
        meta["version"] = 99
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(IOError, match="version-99"):
            ModelStore(v1)

    def test_quantized_scores_within_budget_f32_bitwise(self, serving_world):
        reqs = serving_world["requests"]
        f32_server = _server(serving_world["stores"]["f32"])
        oracle = f32_server.score_rows(reqs)
        f32_server.close()
        for dt in DTYPES:
            server = _server(serving_world["stores"][dt])
            served = server.score_rows(reqs)
            assert_scores_match_store(served, oracle, server.store.meta, reqs, SECTIONS,
                                      err_msg=f"store_dtype={dt}")
            if dt != "f32":
                assert not np.array_equal(served, oracle)
                # at their storage width on the device
                slab = server.model.random[0][3]
                assert str(slab.dtype) == {"bf16": "torch.bfloat16", "int8": "torch.int8"}[dt]
            server.close()

    def test_quantized_scores_within_elementwise_of_the_jax_server(self, serving_world):
        reqs = serving_world["requests"]
        for dt in ("bf16", "int8"):
            server = _server(serving_world["stores"][dt])
            served = server.score_rows(reqs)
            server.close()
            jserver = JScoringServer(JModelStore(serving_world["jstores"][dt]),
                                     shard_sections=SECTIONS, max_batch_rows=16,
                                     max_wait_ms=5.0, stats=JServeStats())
            jserved = jserver.score_rows(reqs)
            jserver.close()
            assert_allclose(served, jserved, kind="elementwise", err_msg=dt)

    def test_same_dtype_swap_compile_free_dtype_change_flagged(self, serving_world):
        store2 = _second_model(serving_world, "int8-2", 77, store_dtype="int8")
        server = _server(serving_world["stores"]["int8"])
        swapper = ModelSwapper(server)
        report = swapper.swap(store2)
        assert report["new_compiles"] == 0
        assert report["shape_compatible"]
        assert report["dropped_requests"] == 0
        problems = swapper.validate_compatible(ModelStore(serving_world["stores"]["bf16"]))
        assert any("dtype" in p for p in problems)
        with pytest.raises(CheckpointRefError, match="dtype"):
            swapper.swap(serving_world["stores"]["bf16"], require_compatible=True)
        report = swapper.swap(serving_world["stores"]["bf16"])
        assert not report["shape_compatible"] and server.store.store_dtype == "bf16"
        server.close()

    def test_corrupt_scale_sidecar_refuses_open(self, serving_world, tmp_path):
        broken = str(tmp_path / "broken-int8")
        shutil.copytree(serving_world["stores"]["int8"], broken)
        scales_path = os.path.join(broken, "random", "per-user", "scales.npy")
        n_rows = np.load(scales_path).shape[0]
        np.save(scales_path, np.full(n_rows, np.nan, np.float32))
        with pytest.raises(IOError, match="corrupt"):
            ModelStore(broken)
        with open(scales_path, "wb") as f:
            f.write(b"not an npy file")
        with pytest.raises(IOError, match="missing or unreadable"):
            ModelStore(broken)
        os.unlink(scales_path)
        with pytest.raises(IOError, match="missing or unreadable"):
            ModelStore(broken)

    def test_slab_dtype_that_disagrees_with_meta_refuses_open(self, serving_world, tmp_path):
        broken = str(tmp_path / "mixed")
        shutil.copytree(serving_world["stores"]["bf16"], broken)
        shutil.copy(os.path.join(serving_world["stores"]["f32"], "random", "per-user",
                                 "slab.npy"),
                    os.path.join(broken, "random", "per-user", "slab.npy"))
        with pytest.raises(IOError, match="does not match store_dtype"):
            ModelStore(broken)

    def test_over_budget_meta_refuses_open(self, serving_world, tmp_path):
        tampered = str(tmp_path / "tampered-int8")
        shutil.copytree(serving_world["stores"]["int8"], tampered)
        meta_path = os.path.join(tampered, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        q = meta["random"][0]["quantization"]
        q["realized_max_abs_coeff_err"] = q["coeff_err_budget"] * 2
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(IOError, match="budget"):
            ModelStore(tampered)

    def test_serve_dequant_fault_injection(self, serving_world):
        from photon_ml_tpu_torch.resilience import faults

        plan = faults.FaultPlan([faults.FaultSpec(site="serve.dequant", at=1)])
        with faults.fault_scope(plan):
            with pytest.raises(OSError, match="serve.dequant"):
                ModelStore(serving_world["stores"]["int8"])
        assert plan.fire_count("serve.dequant") == 1
        plan2 = faults.FaultPlan([faults.FaultSpec(site="serve.dequant", at=1)])
        with faults.fault_scope(plan2):
            ModelStore(serving_world["stores"]["f32"]).close()
        assert plan2.fire_count("serve.dequant") == 0

    def test_store_footprint_gauges(self, serving_world):
        server = _server(serving_world["stores"]["int8"], warm_nnz=None)
        snap = server.stats.snapshot()
        assert snap["store_dtype"] == "int8"
        assert snap["store_slab_bytes"] > 0
        assert snap["store_mapped_bytes"] > 0
        assert "int8" in server.stats.summary()
        server.close()

    def test_export_over_budget_slab_fails(self):
        slab = np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32)
        stored, scales = quantize.quantize_slab(slab, "int8")
        with pytest.raises(IOError, match="budget"):
            quantize.slab_error_report(slab, stored, scales * 2.0, "int8")
        with pytest.raises(ValueError, match="store_dtype"):
            quantize.validate_store_dtype("fp8")

    def test_non_finite_slab_fails_export_and_open(self, serving_world, tmp_path):
        slab = np.random.default_rng(4).normal(size=(8, 6)).astype(np.float32)
        slab[3, 2] = np.nan
        for dt in ("bf16", "int8"):
            stored, scales = quantize.quantize_slab(slab, dt)
            with pytest.raises(IOError, match="budget"):
                quantize.slab_error_report(slab, stored, scales, dt)
        tampered = str(tmp_path / "nan-meta-int8")
        shutil.copytree(serving_world["stores"]["int8"], tampered)
        meta_path = os.path.join(tampered, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["random"][0]["quantization"]["realized_max_abs_coeff_err"] = float("nan")
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(IOError, match="budget"):
            ModelStore(tampered)


# ---------------------------------------------------------------------------
# live model swap (tests/test_serve.py::TestModelSwap)
# ---------------------------------------------------------------------------


class TestModelSwap:
    def test_swap_zero_compiles_zero_drops(self, serving_world):
        store2 = _second_model(serving_world, "2", 43)
        server = _server(serving_world["store_dir"], max_wait_ms=2.0)
        before = server.score_rows(serving_world["requests"][:4])
        old = server.model
        swapper = ModelSwapper(server)
        wm = compile_stats.watermark()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(server.score_rows, [q]) for q in serving_world["requests"]]
            report = swapper.swap(store2)
            results = [f.result(timeout=60) for f in futs]
        assert report["new_compiles"] == 0
        assert report["shape_compatible"]
        assert report["dropped_requests"] == 0
        assert wm.new_traces() == 0
        assert len(results) == len(serving_world["requests"])
        assert all(len(r) == 1 for r in results)
        after = server.score_rows(serving_world["requests"][:4])
        assert not np.allclose(before, after)
        assert server.model.generation == 2
        assert server.stats.snapshot()["swaps"] == 1
        # the old generation was drained, retired and its store closed
        assert old._retired and old.store.random == [] and not old.begin_request()
        # the new generation scores as a fresh server on the new store does
        fresh = _server(store2)
        assert np.array_equal(after, fresh.score_rows(serving_world["requests"][:4]))
        fresh.close()
        server.close()

    def test_swap_refuses_missing_store(self, serving_world):
        server = _server(serving_world["store_dir"], max_batch_rows=8, warm_nnz=None)
        swapper = ModelSwapper(server)
        with pytest.raises(CheckpointRefError):
            swapper.swap("/nonexistent/store")
        assert server.model.generation == 1
        assert len(server.score_rows(serving_world["requests"][:2])) == 2
        server.close()

    def test_swap_detects_shape_change(self, serving_world):
        store3 = _second_model(serving_world, "3", 44, num_users=20)  # rung 32 vs 16
        server = _server(serving_world["store_dir"], max_batch_rows=8, warm_nnz=None)
        swapper = ModelSwapper(server)
        with pytest.raises(CheckpointRefError, match="slab"):
            swapper.swap(store3, require_compatible=True)
        assert server.model.generation == 1
        server.close()


# ---------------------------------------------------------------------------
# JSON-lines request loop (tests/test_serve.py::TestJsonLinesLoop)
# ---------------------------------------------------------------------------


class TestJsonLinesLoop:
    def _serve(self, serving_world, lines, with_swapper=False):
        server = _server(serving_world["store_dir"], max_batch_rows=8, max_wait_ms=1.0)
        swapper = ModelSwapper(server) if with_swapper else None
        out = io.StringIO()
        handled = serve_json_lines(server, io.StringIO("\n".join(lines) + "\n"), out,
                                   swapper=swapper)
        server.close()
        return handled, [json.loads(line) for line in out.getvalue().splitlines()]

    def test_score_stats_shutdown(self, serving_world, tmp_path):
        drv = _run_scoring_driver(serving_world, tmp_path / "loop-drv")
        reqs = serving_world["requests"]
        lines = [json.dumps({"id": f"r{i}", "rows": [q]}) for i, q in enumerate(reqs)]
        lines += [json.dumps({"cmd": "stats", "id": "st"}), json.dumps({"cmd": "shutdown"}),
                  json.dumps({"id": "after", "rows": [reqs[0]]})]
        handled, responses = self._serve(serving_world, lines)
        assert handled == len(reqs)
        by_id = {r.get("id"): r for r in responses}
        served = np.asarray([by_id[f"r{i}"]["scores"][0] for i in range(len(reqs))], np.float32)
        assert np.array_equal(served, drv.scores)
        assert "stats" in by_id["st"] and by_id["st"]["new_request_compiles"] == 0
        assert "after" not in by_id

    def test_bad_lines_fail_softly(self, serving_world):
        lines = [
            "this is not json",
            json.dumps({"rows": []}),
            json.dumps({"rows": "nope"}),
            json.dumps({"cmd": "swap", "store_dir": "/nonexistent"}),
            json.dumps({"id": "ok", "rows": [serving_world["requests"][0]]}),
            json.dumps({"cmd": "shutdown"}),
        ]
        handled, responses = self._serve(serving_world, lines)
        assert handled == 1
        assert len([r for r in responses if "error" in r]) == 4
        ok = [r for r in responses if r.get("id") == "ok"]
        assert len(ok) == 1 and len(ok[0]["scores"]) == 1

    def test_swap_command(self, serving_world):
        store2 = _second_model(serving_world, "loop", 45)
        q = serving_world["requests"][0]
        lines = [
            json.dumps({"id": "pre", "rows": [q]}),
            json.dumps({"cmd": "swap", "store_dir": store2, "id": "sw"}),
            json.dumps({"id": "post", "rows": [q]}),
            json.dumps({"cmd": "shutdown"}),
        ]
        _, responses = self._serve(serving_world, lines, with_swapper=True)
        by_id = {r.get("id"): r for r in responses}
        assert by_id["sw"]["swap"]["new_compiles"] == 0
        assert by_id["pre"]["scores"] != by_id["post"]["scores"]


# ---------------------------------------------------------------------------
# ServeStats (tests/test_serve.py::TestServeStats)
# ---------------------------------------------------------------------------


class TestServeStats:
    def test_percentiles_and_summary(self):
        from photon_ml_tpu.serve import ServeStats as JStats

        s, j = ServeStats(), JStats()
        for ms in range(1, 101):
            s.record_request(ms / 1e3)
            j.record_request(ms / 1e3)
        s.record_batch(rows_real=75, rows_padded=100, num_requests=100)
        snap = s.snapshot()
        assert snap["requests"] == 100
        assert 45 <= snap["p50_ms"] <= 55
        assert 95 <= snap["p99_ms"] <= 100
        assert (snap["p50_ms"], snap["p99_ms"]) == (j.snapshot()["p50_ms"],
                                                    j.snapshot()["p99_ms"])
        assert snap["batch_fill_ratio"] == 0.75
        text = s.summary()
        assert "p50" in text and "p99" in text and "fill" in text
        s.reset()
        assert s.snapshot()["requests"] == 0

    def test_fleet_stats_keeps_the_jax_keys(self):
        from photon_ml_tpu.serve import FleetStats as JFleet
        from photon_ml_tpu_torch.serve import FleetStats

        f, j = FleetStats(), JFleet()
        for stats in (f, j):
            stats.record_scatter(3)
            stats.record_hedge()
            stats.record_degraded_rows(2)
        assert sorted(f.snapshot()) == sorted(j.snapshot())
        assert f.snapshot()["scatter_calls"] == 3 and f.snapshot()["degraded_rows"] == 2
        f.reset()
        assert f.snapshot()["hedges"] == 0


# ---------------------------------------------------------------------------
# the serve driver (tests/test_serve.py::TestServeDriver)
# ---------------------------------------------------------------------------


class TestServeDriver:
    def test_build_store_only_then_serve(self, serving_world, tmp_path):
        from photon_ml_tpu_torch.cli import serve_driver

        store_dir = str(tmp_path / "driver-store")
        d = serve_driver.main([
            "--model-store-dir", store_dir,
            "--game-model-input-dir", serving_world["model_dir"],
            "--build-store-only", "true", "--device", "cpu",
        ])
        assert is_model_store(store_dir)
        assert d.server is None
        assert _tree_bytes(store_dir)["random/per-user/slab.npy"] == \
            _tree_bytes(serving_world["store_dir"])["random/per-user/slab.npy"]
        reqs = serving_world["requests"]
        in_text = "\n".join([json.dumps({"id": str(i), "rows": [q]})
                             for i, q in enumerate(reqs[:5])]
                            + [json.dumps({"cmd": "shutdown"})]) + "\n"
        out = io.StringIO()
        driver = serve_driver.GameServeDriver(serve_driver.parse_serve_params([
            "--model-store-dir", store_dir,
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
            "--max-batch-rows", "8", "--warm-nnz", "4", "--device", "cpu",
        ]))
        driver.run(in_stream=io.StringIO(in_text), out_stream=out)
        assert driver.handled == 5
        assert driver.warm_report["warm_batches"] == 1
        responses = [json.loads(line) for line in out.getvalue().splitlines()]
        assert sum(1 for r in responses if "scores" in r) == 5

    def test_parse_validation(self):
        from photon_ml_tpu_torch.cli.game_params import GameServeParams

        with pytest.raises(ValueError, match="model-store-dir"):
            GameServeParams().validate()
        with pytest.raises(ValueError, match="assert-warm"):
            GameServeParams(model_store_dir="x", assert_warm=True).validate()
        with pytest.raises(ValueError, match="max-batch-rows"):
            GameServeParams(model_store_dir="x", max_batch_rows=0).validate()
        with pytest.raises(ValueError, match="shape-canonicalization"):
            GameServeParams(model_store_dir="x", shape_canonicalization="nope").validate()
        with pytest.raises(ValueError, match="warmup"):
            GameServeParams(model_store_dir="x", assert_warm=True, persistent_cache_dir="c",
                            warmup=False).validate()
        with pytest.raises(ValueError, match="store-dtype"):
            GameServeParams(model_store_dir="x", store_dtype="fp8").validate()
        with pytest.raises(ValueError, match="--device"):
            GameServeParams(model_store_dir="x", device="tpu").validate()
        GameServeParams(model_store_dir="x").validate()

    def test_serve_flags_parse_like_the_jax_parser(self):
        from photon_ml_tpu.cli.game_params import parse_serve_params as jparse
        from photon_ml_tpu_torch.cli.game_params import parse_serve_params

        argv = ["--model-store-dir", "s", "--game-model-input-dir", "m",
                "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
                "--max-batch-rows", "32", "--max-wait-ms", "0.5", "--warm-nnz", "16",
                "--store-dtype", "int8", "--no-warmup", "--num-store-partitions", "2"]
        got, want = parse_serve_params(argv), jparse(argv)
        for field in ("model_store_dir", "game_model_input_dir", "feature_shard_sections",
                      "max_batch_rows", "max_wait_ms", "shape_canonicalization", "warmup",
                      "warm_nnz", "store_dtype", "num_store_partitions"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.device == "cuda"
        with pytest.raises(SystemExit):
            parse_serve_params(["--model-store-dir", "s", "--store-dtype", "fp8"])

    def test_persistent_cache_stays_fenced_naming_itself(self):
        from photon_ml_tpu_torch.cli.game_params import parse_serve_params

        with pytest.raises(ValueError, match="--persistent-cache is not yet ported"):
            parse_serve_params(["--model-store-dir", "s", "--persistent-cache", "cache"])

    def test_assert_warm_raises_the_jax_no_cache_error(self, serving_world, tmp_path):
        from photon_ml_tpu_torch.cli import serve_driver
        from photon_ml_tpu_torch.cli.game_params import GameServeParams

        driver = serve_driver.GameServeDriver(GameServeParams(
            model_store_dir=serving_world["store_dir"], persistent_cache_dir=str(tmp_path),
            assert_warm=True, device="cpu"))
        with pytest.raises(RuntimeError, match="--assert-warm needs a working persistent cache"):
            driver.run(in_stream=io.StringIO(""), out_stream=io.StringIO())
        assert driver.server is None


# ---------------------------------------------------------------------------
# the training driver's --export-serve-store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_training_driver_export_equals_build_model_store(tmp_path, dtype):
    from photon_ml_tpu_torch.cli import game_training_driver

    rng = np.random.default_rng(11)
    data, truth = make_glmix_data(rng, num_users=12, rows_per_user_range=(6, 12),
                                  d_fixed=4, d_random=3)
    train = tmp_path / "train"
    train.mkdir()
    write_game_avro(str(train / "part-0.avro"), data, range(data.num_rows), truth)
    out, store = str(tmp_path / "out"), str(tmp_path / "store")
    driver = game_training_driver.main([
        "--train-input-dirs", str(train), "--output-dir", out, "--device", "cpu",
        "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
        "--updating-sequence", "fixed,per-user",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
        "--fixed-effect-optimization-configurations", "fixed:20,1e-7,0.1,1,LBFGS,L2",
        "--random-effect-optimization-configurations", "per-user:20,1e-6,0.1,1,LBFGS,L2",
        "--export-serve-store", store, "--store-dtype", dtype,
    ])
    assert "export-serve-store" in driver.timer.totals
    again = str(tmp_path / "again")
    build_model_store(os.path.join(out, "best"), again, bucketer=ShapeBucketer(),
                      store_dtype=dtype)
    got, want = _tree_bytes(store), _tree_bytes(again)
    assert sorted(got) == sorted(want)
    for name in got:
        if name != "meta.json":
            assert got[name] == want[name], name
    assert json.loads(got["meta.json"]) == json.loads(want["meta.json"])
    assert ModelStore(store).store_dtype == dtype
