"""The port's sharded serving fleet (photon_ml_tpu_torch/serve/fleet and
cli/fleet_driver) against the JAX package's, on the CPU.

  * Ports of tests/test_serve_fleet.py's single-process arms (shard plan,
    sharded export, bitwise parity, fleet swap, delta rollout, chaos,
    degradation accounting, smoothed hinge, params, quantized metas) with
    their assertions kept; engines score with ``device="cpu"``. A
    "compile" in the port is the first sight of a batch shape at a scoring
    site (serve/server.py).
  * Across packages: both ``build_fleet_stores`` write the same store bytes
    and ``fleet.json``, and each package opens the other's fleet;
    ``ServeShardPlan.owners_of`` is equal; port fleet scores are
    ``np.array_equal`` to the port's single-host server and batch scoring
    driver and within ``elementwise`` of the JAX fleet; every chaos, hedge
    and degradation counter equals JAX's on the same fault plan; the fleet
    params parse as JAX's do.
  * Two ``fleet_driver`` replica processes over local TCP: bitwise scores,
    a fleet swap under traffic, one replica killed (every socket and
    subprocess call carries a timeout).
"""

import concurrent.futures
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from game_test_utils import (
    game_avro_records,
    make_glmix_data,
    save_synthetic_game_model,
    serve_requests_from_records,
    write_game_avro,
)
from tolerances import assert_allclose

from photon_ml_tpu.compile import ShapeBucketer as JShapeBucketer
from photon_ml_tpu.resilience import faults as jfaults
from photon_ml_tpu.serve import FleetStats as JFleetStats
from photon_ml_tpu.serve import ModelStore as JModelStore
from photon_ml_tpu.serve import ServeStats as JServeStats
from photon_ml_tpu.serve import fleet as jfleet
from photon_ml_tpu_torch.compile import ShapeBucketer, compile_stats
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.serve import (
    FleetStats,
    ModelStore,
    ScoringServer,
    ServeStats,
    build_model_store,
)
from photon_ml_tpu_torch.serve import fleet as tfleet
from photon_ml_tpu_torch.serve.model_store import build_model_stores
from photon_ml_tpu_torch.serve.fleet import (
    FleetRouter,
    FleetSwapError,
    FleetSwapper,
    LocalReplicaClient,
    NoLiveReplicaError,
    ReplicaEngine,
    ReplicaUnavailableError,
    ServeShardPlan,
    build_fleet_stores,
    is_fleet_dir,
    load_fleet_meta,
    replica_store_dir,
)

pytestmark = pytest.mark.fleet

SECTIONS = {"global": ["fixedFeatures"], "per_user": ["userFeatures"]}
SECTIONS_FLAG = "global:fixedFeatures|per_user:userFeatures"
NUM_USERS = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def fleet_world(tmp_path_factory):
    """tests/test_serve_fleet.py's world (one synthetic model + requests +
    single store + 2-replica fleet + a perturbed second model/fleet), with
    the JAX package's exports of the same models beside the port's."""
    base = tmp_path_factory.mktemp("tfleet")
    rng = np.random.default_rng(1142)
    data, truth = make_glmix_data(rng, num_users=NUM_USERS, rows_per_user_range=(6, 12),
                                  d_fixed=5, d_random=3)
    offsets = rng.normal(size=data.num_rows).astype(np.float32)
    model_dir = str(base / "model")
    save_synthetic_game_model(model_dir, rng, d_fixed=5, d_random=3, num_users=NUM_USERS)
    in_dir = base / "in"
    in_dir.mkdir()
    write_game_avro(str(in_dir / "part-0.avro"), data, range(data.num_rows), truth, offsets)
    store_dir = str(base / "store")
    build_model_store(model_dir, store_dir, bucketer=ShapeBucketer())
    fleet_dir = str(base / "fleet")
    meta = build_fleet_stores(model_dir, fleet_dir, num_replicas=2, bucketer=ShapeBucketer())
    model2 = str(base / "model2")
    save_synthetic_game_model(model2, np.random.default_rng(1143), d_fixed=5, d_random=3,
                              num_users=NUM_USERS)
    fleet2 = str(base / "fleet2")
    build_fleet_stores(model2, fleet2, num_replicas=2, bucketer=ShapeBucketer())
    jfleet_dir = str(base / "jfleet")
    jmeta = jfleet.build_fleet_stores(model_dir, jfleet_dir, num_replicas=2,
                                      bucketer=JShapeBucketer())
    jfleet2 = str(base / "jfleet2")
    jfleet.build_fleet_stores(model2, jfleet2, num_replicas=2, bucketer=JShapeBucketer())
    records = list(game_avro_records(data, range(data.num_rows), truth, offsets))
    return {
        "base": base, "model_dir": model_dir, "model2": model2, "in_dir": str(in_dir),
        "store_dir": store_dir, "fleet_dir": fleet_dir, "fleet2": fleet2, "meta": meta,
        "jfleet_dir": jfleet_dir, "jfleet2": jfleet2, "jmeta": jmeta, "records": records,
        "requests": serve_requests_from_records(records),
    }


def _single_server(world, **kw):
    server = ScoringServer(ModelStore(world["store_dir"]), shard_sections=SECTIONS,
                           max_batch_rows=kw.pop("max_batch_rows", 16),
                           max_wait_ms=kw.pop("max_wait_ms", 1.0), stats=ServeStats(),
                           device="cpu", **kw)
    server.warmup(warm_nnz=8)
    return server


def _engines(fleet_dir, n=2, pkg="port"):
    engines = []
    for r in range(n):
        if pkg == "port":
            e = ReplicaEngine(ModelStore(replica_store_dir(fleet_dir, r)), replica_id=r,
                              num_replicas=n, shard_sections=SECTIONS, max_batch_rows=16,
                              max_wait_ms=1.0, stats=ServeStats(), device="cpu")
        else:
            e = jfleet.ReplicaEngine(JModelStore(jfleet.replica_store_dir(fleet_dir, r)),
                                     replica_id=r, num_replicas=n, shard_sections=SECTIONS,
                                     max_batch_rows=16, max_wait_ms=1.0, stats=JServeStats())
        e.warmup(warm_nnz=8)
        engines.append(e)
    return engines


def _local_fleet(world, fleet_dir=None, n=2, **router_kw):
    fleet_dir = fleet_dir or world["fleet_dir"]
    engines = _engines(fleet_dir, n)
    clients = [LocalReplicaClient(e) for e in engines]
    router = FleetRouter(load_fleet_meta(fleet_dir), clients, stats=FleetStats(), **router_kw)
    return router, engines, clients


def _close_fleet(router, engines):
    router.close()
    for e in engines:
        e.close()


def _run_scoring_driver(world, out_dir):
    from photon_ml_tpu_torch.cli import game_scoring_driver

    return game_scoring_driver.main([
        "--input-dirs", world["in_dir"],
        "--game-model-input-dir", world["model_dir"],
        "--output-dir", str(out_dir),
        "--offheap-indexmap-dir", os.path.join(world["store_dir"], "features"),
        "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
        "--delete-output-dir-if-exists", "true",
        "--device", "cpu",
    ])


# ---------------------------------------------------------------------------
# ServeShardPlan
# ---------------------------------------------------------------------------


class TestServeShardPlan:
    def test_deterministic_and_balanced(self):
        ids = [f"user-{i}" for i in range(1000)]
        p1 = ServeShardPlan.build(ids, num_replicas=4, num_buckets=64)
        p2 = ServeShardPlan.build(ids, num_replicas=4, num_buckets=64)
        assert p1.same_assignment(p2)
        owners = p1.owners_of(ids)
        counts = np.bincount(owners, minlength=4)
        assert counts.min() > 0
        assert counts.max() <= 2 * counts.mean()

    def test_owner_of_matches_vectorized(self):
        ids = [f"e{i}" for i in range(50)]
        plan = ServeShardPlan.build(ids, num_replicas=3, num_buckets=12)
        vec = plan.owners_of(ids + [None])
        for i, raw in enumerate(ids):
            assert plan.owner_of(raw) == vec[i]
        assert vec[-1] == -1
        assert plan.owner_of(None) == -1

    def test_json_roundtrip_and_mismatch(self):
        plan = ServeShardPlan.build([f"e{i}" for i in range(20)], 2, 8)
        again = ServeShardPlan.from_json(json.loads(json.dumps(plan.to_json())))
        assert plan.same_assignment(again)
        other = ServeShardPlan.build([f"e{i}" for i in range(20)], 2, 16)
        assert not plan.same_assignment(other)
        with pytest.raises(ValueError, match="owners length"):
            ServeShardPlan.from_json({"num_replicas": 2, "num_buckets": 8, "owners": [0, 1]})

    def test_build_validation(self):
        with pytest.raises(ValueError, match="num_replicas"):
            ServeShardPlan.build(["a"], 0)
        with pytest.raises(ValueError, match="num_buckets"):
            ServeShardPlan.build(["a"], 4, num_buckets=2)

    @pytest.mark.parametrize("replicas,buckets", [(1, 8), (2, 64), (3, 12), (4, 64), (7, 128)])
    def test_owners_of_equals_the_jax_plan(self, replicas, buckets):
        ids = [f"user-{i}" for i in range(500)] + ["é", "a b", ""]
        t = ServeShardPlan.build(ids, replicas, buckets)
        j = jfleet.ServeShardPlan.build(ids, replicas, buckets)
        assert t.to_json() == j.to_json()
        probe = ids + [None, "never-seen"]
        assert np.array_equal(t.owners_of(probe), j.owners_of(probe))
        assert t.owners_of(probe).dtype == j.owners_of(probe).dtype
        assert t.same_assignment(ServeShardPlan.from_json(j.to_json()))


# ---------------------------------------------------------------------------
# Sharded export
# ---------------------------------------------------------------------------


class TestFleetStores:
    def test_fleet_layout_and_meta(self, fleet_world):
        assert is_fleet_dir(fleet_world["fleet_dir"])
        assert not is_fleet_dir(fleet_world["store_dir"])
        meta = load_fleet_meta(fleet_world["fleet_dir"])
        assert meta["plan"]["num_replicas"] == 2
        assert [e["name"] for e in meta["fixed"]] == ["fixed"]
        assert [e["name"] for e in meta["random"]] == ["per-user"]
        assert meta["random"][0]["re_id"] == "userId"

    def test_slabs_partition_disjointly(self, fleet_world):
        full = ModelStore(fleet_world["store_dir"])
        plan = ServeShardPlan.from_json(fleet_world["meta"]["plan"])
        owned = {r: set() for r in range(2)}
        for r in range(2):
            shard = ModelStore(replica_store_dir(fleet_world["fleet_dir"], r))
            for i in range(NUM_USERS):
                raw = f"u{i}"
                if shard.entity_row("per-user", raw) >= 0:
                    owned[r].add(raw)
                    np.testing.assert_array_equal(
                        np.sort(np.asarray(shard.random[0].slab[shard.entity_row("per-user", raw)])),
                        np.sort(np.asarray(full.random[0].slab[full.entity_row("per-user", raw)])))
                    assert plan.owner_of(raw) == r
            shard.close()
        assert owned[0] | owned[1] == {f"u{i}" for i in range(NUM_USERS)}
        assert not (owned[0] & owned[1])
        full.close()

    def test_fixed_and_features_replicated(self, fleet_world):
        full = ModelStore(fleet_world["store_dir"])
        for r in range(2):
            shard = ModelStore(replica_store_dir(fleet_world["fleet_dir"], r))
            np.testing.assert_array_equal(np.asarray(shard.fixed[0].coefficients),
                                          np.asarray(full.fixed[0].coefficients))
            for s in full.feature_maps:
                assert shard.shard_dim(s) == full.shard_dim(s)
            shard.close()
        full.close()

    @pytest.mark.parametrize("which", ["fleet", "fleet2"])
    def test_both_packages_write_the_same_fleet_bytes(self, fleet_world, which):
        port_dir, jax_dir = fleet_world[f"{which}_dir" if which == "fleet" else which], \
            fleet_world[f"j{which}_dir" if which == "fleet" else f"j{which}"]
        port, jax_ = _tree_bytes(port_dir), _tree_bytes(jax_dir)
        assert sorted(port) == sorted(jax_)
        for name in port:
            if name.endswith("meta.json") or name == "fleet.json":
                a, b = json.loads(port[name]), json.loads(jax_[name])
                assert a.pop("source_model_dir", None) == b.pop("source_model_dir", None)
                for ra, rb in zip(a.get("replicas", []), b.get("replicas", [])):
                    assert ra.pop("store_dir") == os.path.join(os.path.abspath(port_dir),
                                                               f"replica-{ra['replica']}")
                    assert rb.pop("store_dir") == os.path.join(os.path.abspath(jax_dir),
                                                               f"replica-{rb['replica']}")
                assert a == b, name
            else:
                assert port[name] == jax_[name], name

    def test_one_read_writes_the_stores_build_model_store_writes(self, fleet_world, tmp_path):
        seen = []

        def stores_for(ids):
            seen.append(ids)
            return {str(tmp_path / "odd"): lambda i: int(i[1:]) % 2 == 1,
                    str(tmp_path / "all"): None}

        metas = build_model_stores(fleet_world["model_dir"], stores_for,
                                   bucketer=ShapeBucketer(), store_dtype="bf16")
        assert seen == [sorted(f"u{i}" for i in range(NUM_USERS))]
        assert list(metas) == [str(tmp_path / "odd"), str(tmp_path / "all")]
        for name, entity_filter in (("odd", lambda i: int(i[1:]) % 2 == 1), ("all", None)):
            want = str(tmp_path / f"{name}-alone")
            build_model_store(fleet_world["model_dir"], want, bucketer=ShapeBucketer(),
                              entity_filter=entity_filter, store_dtype="bf16")
            assert _tree_bytes(str(tmp_path / name)) == _tree_bytes(want), name
        assert metas[str(tmp_path / "odd")]["random"][0]["entities"] == NUM_USERS // 2

    def test_each_package_opens_the_others_fleet(self, fleet_world):
        tmeta = load_fleet_meta(fleet_world["jfleet_dir"])
        jmeta = jfleet.load_fleet_meta(fleet_world["fleet_dir"])
        assert tmeta["plan"] == jmeta["plan"] == fleet_world["meta"]["plan"]
        assert jfleet.is_fleet_dir(fleet_world["fleet_dir"])
        assert is_fleet_dir(fleet_world["jfleet_dir"])
        for r in range(2):
            t = ModelStore(replica_store_dir(fleet_world["jfleet_dir"], r))
            j = JModelStore(jfleet.replica_store_dir(fleet_world["fleet_dir"], r))
            assert t.random[0].entities == j.random[0].entities
            assert np.array_equal(t.random[0].dequantized(), j.random[0].dequantized())
            t.close()
            j.close()
        # the port's router and engines serve the JAX export bitwise as they
        # serve their own
        server = _single_server(fleet_world)
        single = server.score_rows(fleet_world["requests"])
        server.close()
        router, engines, _ = _local_fleet(fleet_world, fleet_dir=fleet_world["jfleet_dir"])
        assert np.array_equal(router.score_rows(fleet_world["requests"]), single)
        _close_fleet(router, engines)


# ---------------------------------------------------------------------------
# Bitwise parity — THE fleet gate
# ---------------------------------------------------------------------------


class TestFleetParity:
    def test_fleet_bitwise_equal_single_store_and_driver(self, fleet_world, tmp_path):
        drv = _run_scoring_driver(fleet_world, tmp_path / "drv")
        server = _single_server(fleet_world)
        single = server.score_rows(fleet_world["requests"])
        server.close()
        assert np.array_equal(single, drv.scores)

        router, engines, _ = _local_fleet(fleet_world)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(lambda q: router.submit_rows([q]), fleet_world["requests"]))
        served = np.concatenate([f.result(timeout=60) for f in futs])
        assert np.array_equal(served, single)
        assert np.array_equal(served, drv.scores)
        snap = router.stats.snapshot()
        assert snap["requests"] == len(fleet_world["requests"])
        assert snap["degraded_rows"] == 0
        assert snap["scatter_calls"] >= snap["requests"]
        _close_fleet(router, engines)

    def test_single_replica_fleet_matches(self, fleet_world, tmp_path):
        fleet1 = str(tmp_path / "fleet1")
        build_fleet_stores(fleet_world["model_dir"], fleet1, num_replicas=1,
                           bucketer=ShapeBucketer())
        server = _single_server(fleet_world)
        single = server.score_rows(fleet_world["requests"])
        server.close()
        router, engines, _ = _local_fleet(fleet_world, fleet_dir=fleet1, n=1)
        served = router.score_rows(fleet_world["requests"])
        assert np.array_equal(served, single)
        _close_fleet(router, engines)

    def test_cold_entity_and_empty(self, fleet_world):
        router, engines, _ = _local_fleet(fleet_world)
        req = fleet_world["requests"][0]
        cold = dict(req, ids={"userId": "never-seen-user"})
        bare = dict(req, ids={})
        np.testing.assert_array_equal(router.score_rows([cold]), router.score_rows([bare]))
        assert router.score_rows([]).shape == (0,)
        _close_fleet(router, engines)

    def test_multi_row_requests(self, fleet_world):
        server = _single_server(fleet_world)
        single = server.score_rows(fleet_world["requests"])
        server.close()
        router, engines, _ = _local_fleet(fleet_world)
        served = router.score_rows(fleet_world["requests"])
        assert np.array_equal(served, single)
        _close_fleet(router, engines)

    def test_port_fleet_holds_the_jax_fleet(self, fleet_world):
        """The port's fleet and the JAX fleet score the same requests over
        the same exports: within ``elementwise`` (the device sums of two
        frameworks), each bitwise its own single-store server."""
        router, engines, _ = _local_fleet(fleet_world)
        served = router.score_rows(fleet_world["requests"])
        _close_fleet(router, engines)
        jengines = _engines(fleet_world["jfleet_dir"], pkg="jax")
        jrouter = jfleet.FleetRouter(jfleet.load_fleet_meta(fleet_world["jfleet_dir"]),
                                     [jfleet.LocalReplicaClient(e) for e in jengines],
                                     stats=JFleetStats())
        jserved = jrouter.score_rows(fleet_world["requests"])
        _close_fleet(jrouter, jengines)
        assert served.dtype == jserved.dtype == np.float32
        assert_allclose(served, jserved, kind="elementwise")


# ---------------------------------------------------------------------------
# Fleet-wide atomic swap
# ---------------------------------------------------------------------------


class TestFleetSwap:
    def _fleet_scores(self, world, fleet_dir):
        router, engines, _ = _local_fleet(world, fleet_dir=fleet_dir)
        scores = router.score_rows(world["requests"])
        _close_fleet(router, engines)
        return scores

    def test_swap_atomic_zero_compiles_zero_drops(self, fleet_world):
        old_ref = self._fleet_scores(fleet_world, fleet_world["fleet_dir"])
        new_ref = self._fleet_scores(fleet_world, fleet_world["fleet2"])
        assert not np.any(old_ref == new_ref)

        router, engines, _ = _local_fleet(fleet_world)
        swapper = FleetSwapper(router)
        reqs = fleet_world["requests"]
        wm = compile_stats.watermark()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(router.score_rows, [q]) for q in reqs]
            report = swapper.swap(fleet_world["fleet2"])
            results = [f.result(timeout=60) for f in futs]
        assert report["new_compiles"] == 0
        assert report["dropped_requests"] == 0
        assert report["commit_failures"] == []
        assert wm.new_traces() == 0
        assert len(results) == len(reqs)
        for i, r in enumerate(results):
            assert len(r) == 1
            assert r[0] == old_ref[i] or r[0] == new_ref[i]
        after = router.score_rows(reqs)
        assert np.array_equal(after, new_ref)
        assert router.generation == 1
        assert all(e.epoch == 1 for e in engines)
        assert router.stats.snapshot()["swaps"] == 1
        _close_fleet(router, engines)

    def test_swap_aborts_on_prepare_failure(self, fleet_world, tmp_path):
        broken = str(tmp_path / "broken-fleet")
        shutil.copytree(fleet_world["fleet2"], broken)
        shutil.rmtree(replica_store_dir(broken, 1))
        router, engines, _ = _local_fleet(fleet_world)
        before = router.score_rows(fleet_world["requests"][:4])
        with pytest.raises(FleetSwapError, match="aborted"):
            FleetSwapper(router).swap(broken)
        assert router.generation == 0
        assert all(e.epoch == 0 for e in engines)
        after = router.score_rows(fleet_world["requests"][:4])
        np.testing.assert_array_equal(before, after)
        _close_fleet(router, engines)

    def test_swap_refuses_plan_mismatch(self, fleet_world, tmp_path):
        other = str(tmp_path / "threeway")
        build_fleet_stores(fleet_world["model2"], other, num_replicas=3,
                           bucketer=ShapeBucketer())
        router, engines, _ = _local_fleet(fleet_world)
        with pytest.raises(FleetSwapError, match="re-shard"):
            FleetSwapper(router).swap(other)
        assert router.generation == 0
        _close_fleet(router, engines)

    def test_requests_submitted_before_swap_stay_on_old_generation(self, fleet_world):
        old_ref = self._fleet_scores(fleet_world, fleet_world["fleet_dir"])
        router, engines, _ = _local_fleet(fleet_world, max_request_workers=2)
        reqs = fleet_world["requests"]
        futs = [router.submit_rows([q]) for q in reqs]
        report = FleetSwapper(router).swap(fleet_world["fleet2"])
        results = np.concatenate([f.result(timeout=60) for f in futs])
        assert report["generation"] == 1
        np.testing.assert_array_equal(results, old_ref)
        assert router.stats.snapshot()["stale_rescores"] == 0
        _close_fleet(router, engines)

    def test_fresh_router_joins_swapped_fleet(self, fleet_world):
        new_ref = self._fleet_scores(fleet_world, fleet_world["fleet2"])
        router, engines, clients = _local_fleet(fleet_world)
        FleetSwapper(router).swap(fleet_world["fleet2"])
        router2 = FleetRouter(load_fleet_meta(fleet_world["fleet_dir"]), clients,
                              stats=FleetStats())
        assert router2.sync_generation() == 1
        np.testing.assert_array_equal(router2.score_rows(fleet_world["requests"]), new_ref)
        router3 = FleetRouter(load_fleet_meta(fleet_world["fleet_dir"]), clients,
                              stats=FleetStats())
        np.testing.assert_array_equal(router3.score_rows(fleet_world["requests"]), new_ref)
        assert router3.stats.snapshot()["stale_rescores"] >= 1
        assert router3.generation == 1
        router2.close()  # LocalReplicaClient.close is a no-op: safe to share
        router3.close()
        _close_fleet(router, engines)

    def test_commit_straggler_redriven_on_next_swap(self, fleet_world, tmp_path):
        router, engines, clients = _local_fleet(fleet_world)
        for r in range(2):
            resp = clients[r].call({"cmd": "prepare",
                                    "store_dir": replica_store_dir(fleet_world["fleet2"], r),
                                    "epoch": 1})
            assert resp["ok"], resp
        router.flip_generation(1)
        assert clients[0].call({"cmd": "commit", "epoch": 1})["ok"]
        assert engines[0].epoch == 1 and engines[1].epoch == 0
        assert len(router.score_rows(fleet_world["requests"][:4])) == 4
        fleet3 = str(tmp_path / "fleet3")
        build_fleet_stores(fleet_world["model_dir"], fleet3, num_replicas=2,
                           bucketer=ShapeBucketer())
        report = FleetSwapper(router).swap(fleet3)
        assert report["generation"] == 2
        assert report["commit_failures"] == []
        assert all(e.epoch == 2 for e in engines)
        _close_fleet(router, engines)

    def test_barrier_fault_aborts_cleanly(self, fleet_world):
        router, engines, _ = _local_fleet(fleet_world)
        plan = faults.FaultPlan([faults.FaultSpec("serve.fleet_swap_barrier", at=1)])
        with faults.fault_scope(plan):
            with pytest.raises(FleetSwapError, match="barrier"):
                FleetSwapper(router).swap(fleet_world["fleet2"])
        assert router.generation == 0
        assert all(e.epoch == 0 for e in engines)
        report = FleetSwapper(router).swap(fleet_world["fleet2"])
        assert report["generation"] == 1
        assert report["new_compiles"] == 0
        _close_fleet(router, engines)


# ---------------------------------------------------------------------------
# Delta rollout: the retrain -> export -> fleet-swap provenance seam
# ---------------------------------------------------------------------------


def _retrain_manifest(tmp_path, model_dir, name="rollout"):
    from photon_ml_tpu_torch.retrain.manifest import RetrainManifest

    rd = tmp_path / name
    rd.mkdir()
    RetrainManifest(output_dir=str(rd), model_dir=model_dir, task="LOGISTIC_REGRESSION",
                    file_stats=[], ingest_inputs={}, ingest_digest="d", updating_sequence=[],
                    coordinates={}).save(str(rd))
    return str(rd)


class TestDeltaRollout:
    def test_rollout_traces_retrain_and_swaps_atomically(self, fleet_world, tmp_path):
        retrain_dir = _retrain_manifest(tmp_path, fleet_world["model2"])
        router, engines, _ = _local_fleet(fleet_world)
        report = FleetSwapper(router).rollout_delta(fleet_world["fleet2"], retrain_dir)
        assert report["rollout"] == "delta"
        assert report["retrain_dir"] == retrain_dir
        assert report["generation"] == 1
        assert report["new_compiles"] == 0
        assert report["dropped_requests"] == 0
        assert router.generation == 1
        _close_fleet(router, engines)

    def test_mismatched_model_refused_old_generation_serves(self, fleet_world, tmp_path):
        retrain_dir = _retrain_manifest(tmp_path, fleet_world["model_dir"])
        router, engines, _ = _local_fleet(fleet_world)
        before = router.score_rows(fleet_world["requests"][:4])
        with pytest.raises(FleetSwapError, match="mismatched"):
            FleetSwapper(router).rollout_delta(fleet_world["fleet2"], retrain_dir)
        assert router.generation == 0
        assert all(e.epoch == 0 for e in engines)
        np.testing.assert_array_equal(before, router.score_rows(fleet_world["requests"][:4]))
        _close_fleet(router, engines)

    def test_unfinished_retrain_refused(self, fleet_world, tmp_path):
        empty = tmp_path / "no-manifest"
        empty.mkdir()
        router, engines, _ = _local_fleet(fleet_world)
        with pytest.raises(FleetSwapError, match="no committed"):
            FleetSwapper(router).rollout_delta(fleet_world["fleet2"], str(empty))
        assert router.generation == 0
        _close_fleet(router, engines)

    def test_chaos_fault_aborts_then_next_rollout_succeeds(self, fleet_world, tmp_path):
        retrain_dir = _retrain_manifest(tmp_path, fleet_world["model2"])
        router, engines, _ = _local_fleet(fleet_world)
        before = router.score_rows(fleet_world["requests"][:4])
        with faults.fault_scope(faults.FaultPlan(
                [faults.FaultSpec("serve.fleet_delta_rollout", at=1)])):
            with pytest.raises(FleetSwapError, match="delta rollout"):
                FleetSwapper(router).rollout_delta(fleet_world["fleet2"], retrain_dir)
        assert router.generation == 0
        assert all(e.epoch == 0 for e in engines)
        np.testing.assert_array_equal(before, router.score_rows(fleet_world["requests"][:4]))
        report = FleetSwapper(router).rollout_delta(fleet_world["fleet2"], retrain_dir)
        assert report["generation"] == 1
        _close_fleet(router, engines)

    def test_no_retrain_dir_skips_provenance(self, fleet_world):
        router, engines, _ = _local_fleet(fleet_world)
        report = FleetSwapper(router).rollout_delta(fleet_world["fleet2"])
        assert report["rollout"] == "delta"
        assert report["retrain_dir"] is None
        assert report["generation"] == 1
        _close_fleet(router, engines)


# ---------------------------------------------------------------------------
# Chaos: route faults, scatter faults, lost replicas
# ---------------------------------------------------------------------------


class TestFleetChaos:
    def test_injected_route_failure_fails_one_request(self, fleet_world):
        router, engines, _ = _local_fleet(fleet_world)
        plan = faults.FaultPlan([faults.FaultSpec("serve.route", at=1)])
        with faults.fault_scope(plan):
            with pytest.raises(OSError):
                router.score_rows(fleet_world["requests"][:1])
            scores = router.score_rows(fleet_world["requests"][:2])
        assert len(scores) == 2
        _close_fleet(router, engines)

    def test_injected_scatter_failure_retries_bitwise(self, fleet_world):
        server = _single_server(fleet_world)
        ref = server.score_rows(fleet_world["requests"])
        server.close()
        router, engines, _ = _local_fleet(fleet_world)
        plan = faults.FaultPlan([faults.FaultSpec("serve.replica_scatter", at=1)])
        with faults.fault_scope(plan):
            served = router.score_rows(fleet_world["requests"])
        assert np.array_equal(served, ref)
        assert router.stats.snapshot()["routed_retries"] >= 1
        _close_fleet(router, engines)

    def test_replica_lost_mid_request_degrades_and_recovers(self, fleet_world):
        server = _single_server(fleet_world)
        ref = server.score_rows(fleet_world["requests"])
        cold_ref = server.score_rows([dict(q, ids={}) for q in fleet_world["requests"]])
        server.close()

        router, engines, clients = _local_fleet(fleet_world, probe_cooldown_s=0.2)
        plan = ServeShardPlan.from_json(fleet_world["meta"]["plan"])
        owners = plan.owners_of([q["ids"]["userId"] for q in fleet_world["requests"]])
        clients[1].fail_mode = "killed"
        t0 = time.monotonic()
        served = router.score_rows(fleet_world["requests"])
        assert time.monotonic() - t0 < 30.0
        for i in range(len(served)):
            expect = ref[i] if owners[i] == 0 else cold_ref[i]
            assert served[i] == expect, i
        snap = router.stats.snapshot()
        assert snap["degraded_rows"] > 0
        assert snap["routed_retries"] >= 1
        router.score_rows(fleet_world["requests"][:2])
        assert 1 not in router.live_replicas()
        clients[1].fail_mode = None
        time.sleep(0.25)
        healed = router.score_rows(fleet_world["requests"])
        np.testing.assert_array_equal(healed, ref)
        assert 1 in router.live_replicas()
        _close_fleet(router, engines)

    def test_all_replicas_dead_raises_not_hangs(self, fleet_world):
        router, engines, clients = _local_fleet(fleet_world)
        for c in clients:
            c.fail_mode = "killed"
        raised = False
        for _ in range(5):
            try:
                router.score_rows(fleet_world["requests"][:1])
            except NoLiveReplicaError:
                raised = True
                break
        assert raised
        _close_fleet(router, engines)


# ---------------------------------------------------------------------------
# Degradation accounting: every degraded response counted EXACTLY once
# ---------------------------------------------------------------------------


def _slow_client(base, engine, delay_s=0.0, then_fail=False, error=ReplicaUnavailableError):
    """An in-process client (of either package) that answers after
    ``delay_s``, or dies after the delay with ``then_fail``."""

    class Slow(base):
        def call(self, msg, timeout=None):
            time.sleep(delay_s)
            if then_fail:
                raise error("slow replica died")
            return super().call(msg, timeout)

    return Slow(engine)


class TestDegradationAccounting:
    def _owners(self, world):
        plan = ServeShardPlan.from_json(world["meta"]["plan"])
        return np.asarray(plan.owners_of([q["ids"]["userId"] for q in world["requests"]]))

    def _cold_refs(self, world):
        server = _single_server(world)
        ref = server.score_rows(world["requests"])
        cold_ref = server.score_rows([dict(q, ids={}) for q in world["requests"]])
        server.close()
        return ref, cold_ref

    def test_retry_then_degrade_counts_each_row_exactly_once(self, fleet_world):
        ref, cold_ref = self._cold_refs(fleet_world)
        owners = self._owners(fleet_world)
        owned_by_1 = int(np.sum(owners == 1))
        assert owned_by_1 > 0
        router, engines, clients = _local_fleet(fleet_world)
        clients[1].fail_mode = "killed"
        served = router.score_rows(fleet_world["requests"])
        snap = router.stats.snapshot()
        assert snap["routed_retries"] >= 1
        assert snap["degraded_rows"] == owned_by_1
        for i in range(len(served)):
            assert served[i] == (ref[i] if owners[i] == 0 else cold_ref[i])
        router.score_rows(fleet_world["requests"])
        snap2 = router.stats.snapshot()
        assert snap2["degraded_rows"] == 2 * owned_by_1
        assert snap2["dead_replica_skips"] >= 1
        _close_fleet(router, engines)

    def test_slow_owner_hedge_wins_primary_no_degradation(self, fleet_world):
        ref, _ = self._cold_refs(fleet_world)
        engines = _engines(fleet_world["fleet_dir"])
        clients = [LocalReplicaClient(engines[0]),
                   _slow_client(LocalReplicaClient, engines[1], delay_s=0.15)]
        router = FleetRouter(load_fleet_meta(fleet_world["fleet_dir"]), clients,
                             stats=FleetStats(), hedge_ms=20.0)
        served = router.score_rows(fleet_world["requests"])
        snap = router.stats.snapshot()
        assert snap["hedges"] >= 1
        assert snap["degraded_rows"] == 0
        np.testing.assert_array_equal(served, ref)
        _close_fleet(router, engines)

    def test_hedged_fallback_counts_hedge_and_degraded_once(self, fleet_world):
        ref, cold_ref = self._cold_refs(fleet_world)
        owners = self._owners(fleet_world)
        owned_by_1 = int(np.sum(owners == 1))
        engines = _engines(fleet_world["fleet_dir"])
        clients = [LocalReplicaClient(engines[0]),
                   _slow_client(LocalReplicaClient, engines[1], delay_s=0.15, then_fail=True)]
        router = FleetRouter(load_fleet_meta(fleet_world["fleet_dir"]), clients,
                             stats=FleetStats(), hedge_ms=20.0)
        served = router.score_rows(fleet_world["requests"])
        snap = router.stats.snapshot()
        assert snap["hedges"] == 1
        assert snap["degraded_rows"] == owned_by_1
        for i in range(len(served)):
            assert served[i] == (ref[i] if owners[i] == 0 else cold_ref[i])
        _close_fleet(router, engines)


# the FleetStats counters the SLO ledger attributes (latencies left out)
COUNTERS = ("requests", "rows", "scatter_calls", "hedges", "reroutes", "routed_retries",
            "stale_rescores", "degraded_rows", "dead_replica_skips", "swaps")


def _chaos_run(pkg, world, scenario):
    """One chaos scenario through one package's fleet over its own export
    of the same model; returns the router's counters."""
    if pkg == "port":
        F, fl, fdir, fdir2 = faults, tfleet, world["fleet_dir"], world["fleet2"]
        stats, unavailable = FleetStats(), ReplicaUnavailableError
    else:
        F, fl, fdir, fdir2 = jfaults, jfleet, world["jfleet_dir"], world["jfleet2"]
        stats, unavailable = JFleetStats(), jfleet.ReplicaUnavailableError
    engines = _engines(fdir, pkg=pkg)
    clients = [fl.LocalReplicaClient(e) for e in engines]
    kw = {}
    if scenario.startswith("hedge"):
        clients[1] = _slow_client(fl.LocalReplicaClient, engines[1], delay_s=0.15,
                                  then_fail=scenario == "hedge-then-fail", error=unavailable)
        kw["hedge_ms"] = 20.0
    router = fl.FleetRouter(fl.load_fleet_meta(fdir), clients, stats=stats, **kw)
    reqs = world["requests"]
    try:
        if scenario in ("route", "scatter"):
            site = {"route": "serve.route", "scatter": "serve.replica_scatter"}[scenario]
            with F.fault_scope(F.FaultPlan([F.FaultSpec(site, at=2)])):
                for q in reqs[:6]:
                    try:
                        router.score_rows([q])
                    except OSError:
                        pass
        elif scenario == "dead-owner":
            clients[1].fail_mode = "killed"
            router.score_rows(reqs)
            router.score_rows(reqs)
        elif scenario.startswith("hedge"):
            router.score_rows(reqs)
        elif scenario == "barrier":
            with F.fault_scope(F.FaultPlan([F.FaultSpec("serve.fleet_swap_barrier", at=1)])):
                with pytest.raises(fl.FleetSwapError, match="barrier"):
                    fl.FleetSwapper(router).swap(fdir2)
            fl.FleetSwapper(router).swap(fdir2)
            router.score_rows(reqs)
        elif scenario == "stale":
            fl.FleetSwapper(router).swap(fdir2)
            late = fl.FleetRouter(fl.load_fleet_meta(fdir), clients, stats=stats)
            late.score_rows(reqs)
            late.close()
        snap = router.stats.snapshot()
        return {k: snap[k] for k in COUNTERS}
    finally:
        _close_fleet(router, engines)


@pytest.mark.parametrize("scenario", ["route", "scatter", "dead-owner", "hedge-wins",
                                      "hedge-then-fail", "barrier", "stale"])
def test_chaos_counts_equal_the_jax_fleet(fleet_world, scenario):
    port = _chaos_run("port", fleet_world, scenario)
    jax_ = _chaos_run("jax", fleet_world, scenario)
    assert port == jax_
    if scenario in ("dead-owner", "hedge-then-fail"):
        assert port["degraded_rows"] > 0


# ---------------------------------------------------------------------------
# Smoothed-hinge SVM through the fleet
# ---------------------------------------------------------------------------


class TestSmoothedHingeFleet:
    def test_smoothed_hinge_model_serves_through_fleet(self, tmp_path):
        from photon_ml_tpu.types import TaskType

        rng = np.random.default_rng(7)
        data, truth = make_glmix_data(rng, num_users=6, rows_per_user_range=(4, 8), d_fixed=4,
                                      d_random=2)
        model_dir = str(tmp_path / "svm-model")
        save_synthetic_game_model(model_dir, rng, d_fixed=4, d_random=2, num_users=6,
                                  task=TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
        records = list(game_avro_records(data, range(data.num_rows), truth))
        reqs = serve_requests_from_records(records)
        store_dir = str(tmp_path / "svm-store")
        build_model_store(model_dir, store_dir, bucketer=ShapeBucketer())
        store = ModelStore(store_dir)
        assert store.meta["task"] == "SMOOTHED_HINGE_LOSS_LINEAR_SVM"
        server = ScoringServer(store, shard_sections=SECTIONS, max_batch_rows=16,
                               max_wait_ms=1.0, stats=ServeStats(), device="cpu")
        server.warmup(warm_nnz=8)
        single = server.score_rows(reqs)
        server.close()
        fleet_dir = str(tmp_path / "svm-fleet")
        meta = build_fleet_stores(model_dir, fleet_dir, num_replicas=2, bucketer=ShapeBucketer())
        assert meta["task"] == "SMOOTHED_HINGE_LOSS_LINEAR_SVM"
        engines = _engines(fleet_dir, 2)
        router = FleetRouter(meta, [LocalReplicaClient(e) for e in engines], stats=FleetStats())
        served = router.score_rows(reqs)
        assert np.array_equal(served, single)
        _close_fleet(router, engines)


# ---------------------------------------------------------------------------
# Fleet params
# ---------------------------------------------------------------------------


class TestFleetParams:
    def test_parse_validation(self):
        from photon_ml_tpu_torch.cli.game_params import GameFleetParams

        with pytest.raises(ValueError, match="fleet-dir"):
            GameFleetParams().validate()
        with pytest.raises(ValueError, match="game-model-input-dir"):
            GameFleetParams(fleet_dir="f", build_fleet_stores=True).validate()
        with pytest.raises(ValueError, match="num-buckets"):
            GameFleetParams(fleet_dir="f", replica_id=0, num_fleet_replicas=4,
                            num_buckets=2).validate()
        with pytest.raises(ValueError, match="replica-id"):
            GameFleetParams(fleet_dir="f", replica_id=5, num_fleet_replicas=2).validate()
        with pytest.raises(ValueError, match="replica-addresses"):
            GameFleetParams(fleet_dir="f", num_fleet_replicas=2).validate()
        with pytest.raises(ValueError, match="hedge-ms"):
            GameFleetParams(fleet_dir="f", replica_id=0, hedge_ms=-1.0).validate()
        GameFleetParams(fleet_dir="f", replica_id=0).validate()
        GameFleetParams(fleet_dir="f", num_fleet_replicas=2,
                        replica_addresses=["a:1", "b:2"]).validate()

    def test_mode_resolution(self):
        from photon_ml_tpu_torch.cli.game_params import GameFleetParams

        assert GameFleetParams(fleet_dir="f", build_fleet_stores=True,
                               game_model_input_dir="m").mode() == "build"
        assert GameFleetParams(fleet_dir="f", replica_id=1).mode() == "replica"
        assert GameFleetParams(fleet_dir="f").mode() == "router"

    @pytest.mark.parametrize("argv", [
        ["--fleet-dir", "f", "--build-fleet-stores", "true", "--game-model-input-dir", "m",
         "--num-fleet-replicas", "3", "--num-buckets", "32", "--store-dtype", "int8",
         "--shape-canonicalization", "4:2"],
        ["--fleet-dir", "f", "--replica-id", "1", "--port", "7002", "--host", "0.0.0.0",
         "--heartbeat-dir", "hb", "--feature-shard-id-to-feature-section-keys-map",
         SECTIONS_FLAG, "--max-batch-rows", "32", "--max-wait-ms", "0.5", "--no-warmup",
         "--warm-nnz", "12", "--log-path", "x.log"],
        ["--fleet-dir", "f", "--replica-addresses", " a:1, b:2 ", "--heartbeat-deadline-s",
         "2.5", "--request-timeout-s", "4", "--hedge-ms", "7"],
    ])
    def test_the_fleet_params_parse_as_the_jax_params(self, argv):
        import dataclasses

        from photon_ml_tpu.cli.game_params import parse_fleet_params as jparse
        from photon_ml_tpu_torch.cli.game_params import parse_fleet_params

        port = dataclasses.asdict(parse_fleet_params(argv))
        assert port.pop("device") == "cuda"
        assert port.pop("assert_warm") is False  # the serve driver's gate, for a replica
        assert port == dataclasses.asdict(jparse(argv))
        assert parse_fleet_params(argv + ["--device", "cpu"]).device == "cpu"

    @pytest.mark.parametrize("argv", [
        ["--fleet-dir", "f"],
        ["--fleet-dir", "f", "--replica-id", "2"],
        ["--fleet-dir", "f", "--replica-id", "0", "--hedge-ms", "0"],
        ["--fleet-dir", "f", "--replica-id", "0", "--heartbeat-deadline-s", "0"],
        ["--fleet-dir", "f", "--replica-id", "0", "--max-batch-rows", "0"],
        ["--fleet-dir", "f", "--replica-id", "0", "--shape-canonicalization", "bogus"],
    ])
    def test_the_fleet_params_refuse_as_the_jax_params(self, argv):
        from photon_ml_tpu.cli.game_params import parse_fleet_params as jparse
        from photon_ml_tpu_torch.cli.game_params import parse_fleet_params

        with pytest.raises(ValueError) as jerr:
            jparse(argv)
        with pytest.raises(ValueError) as terr:
            parse_fleet_params(argv)
        assert str(terr.value) == str(jerr.value)

    def test_the_persistent_cache_is_fenced(self):
        """``--persistent-cache`` is ported: it parses as the JAX parser
        parses it; a replica's ``--assert-warm`` needs it."""
        import dataclasses

        from photon_ml_tpu.cli.game_params import parse_fleet_params as jparse
        from photon_ml_tpu_torch.cli.game_params import parse_fleet_params

        argv = ["--fleet-dir", "f", "--replica-id", "0", "--persistent-cache", "/tmp/c"]
        port = dataclasses.asdict(parse_fleet_params(argv))
        port.pop("device"), port.pop("assert_warm")
        assert port == dataclasses.asdict(jparse(argv))
        assert port["persistent_cache_dir"] == "/tmp/c"
        with pytest.raises(ValueError, match="--assert-warm needs --persistent-cache"):
            parse_fleet_params(["--fleet-dir", "f", "--replica-id", "0",
                                "--assert-warm", "true"])


# ---------------------------------------------------------------------------
# the fleet driver
# ---------------------------------------------------------------------------


class TestFleetDriver:
    def test_build_mode_writes_the_jax_drivers_fleet(self, fleet_world, tmp_path):
        from photon_ml_tpu.cli import fleet_driver as jdriver
        from photon_ml_tpu_torch.cli import fleet_driver

        flags = ["--game-model-input-dir", fleet_world["model_dir"], "--num-fleet-replicas",
                 "2", "--build-fleet-stores", "true"]
        fleet_driver.main(["--fleet-dir", str(tmp_path / "t")] + flags)
        jdriver.main(["--fleet-dir", str(tmp_path / "j")] + flags)
        t, j = _tree_bytes(str(tmp_path / "t")), _tree_bytes(str(tmp_path / "j"))
        assert sorted(t) == sorted(j)
        for name in t:
            if not name.endswith(".json"):
                assert t[name] == j[name], name

    def test_a_replica_without_a_card_raises(self, fleet_world, tmp_path):
        """``--device cuda`` (the default) never falls back to the CPU."""
        import torch

        from photon_ml_tpu_torch.cli import fleet_driver

        if torch.cuda.is_available():
            pytest.skip("a card is present: the replica would serve on it")
        with pytest.raises(Exception, match="(?i)cuda|card|device"):
            fleet_driver.main(["--fleet-dir", fleet_world["fleet_dir"], "--replica-id", "0",
                               "--num-fleet-replicas", "2", "--no-warmup"])

    def test_router_mode_serves_json_lines_over_in_process_tcp(self, fleet_world):
        """The router mode's loop over two in-process TCP replica servers:
        responses bitwise the single server's, and a swap command rolls the
        fleet."""
        import io

        from photon_ml_tpu_torch.cli import fleet_driver
        from photon_ml_tpu_torch.cli.game_params import parse_fleet_params

        server = _single_server(fleet_world)
        ref = server.score_rows(fleet_world["requests"])
        server.close()
        engines = _engines(fleet_world["fleet_dir"])
        servers = [tfleet.ReplicaServer(e).start() for e in engines]
        try:
            params = parse_fleet_params([
                "--fleet-dir", fleet_world["fleet_dir"], "--num-fleet-replicas", "2",
                "--replica-addresses", ",".join(s.address for s in servers),
                "--request-timeout-s", "20"])
            lines = [json.dumps({"id": i, "rows": [q]})
                     for i, q in enumerate(fleet_world["requests"][:12])]
            lines.append(json.dumps({"cmd": "swap", "id": "s", "store_dir": fleet_world["fleet2"]}))
            out = io.StringIO()
            drv = fleet_driver.GameFleetDriver(params)
            drv.run(in_stream=io.StringIO("\n".join(lines) + "\n"), out_stream=out)
            resp = [json.loads(x) for x in out.getvalue().splitlines()]
            scores = {r["id"]: r["scores"][0] for r in resp if "scores" in r}
            assert drv.handled == 12
            for i in range(12):
                assert np.float32(scores[i]) == ref[i]
            swap = [r for r in resp if r.get("id") == "s"][0]
            assert swap["swap"]["generation"] == 1 and swap["swap"]["new_compiles"] == 0
            assert all(e.epoch == 1 for e in engines)
        finally:
            for s in servers:
                s.stop()
            for e in engines:
                e.close()


# ---------------------------------------------------------------------------
# Two fleet_driver replica processes over local TCP
# ---------------------------------------------------------------------------


def _spawn_replica(fleet_dir, r, n, hb_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.fleet_driver",
         "--fleet-dir", fleet_dir, "--replica-id", str(r), "--num-fleet-replicas", str(n),
         "--heartbeat-dir", hb_dir,
         "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
         "--max-batch-rows", "16", "--warm-nnz", "8", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, stdin=subprocess.DEVNULL,
        cwd=REPO, env=env)
    return proc


def _await_ready(proc, timeout=90.0):
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    if not sel.select(timeout):
        proc.kill()
        raise AssertionError(f"replica not READY in {timeout}s: {proc.stderr.read()[-2000:]}")
    line = proc.stdout.readline().strip()
    assert line.startswith("READY "), (line, proc.stderr.read()[-2000:])
    return line.split()[1]


def _tcp_shutdown(addr):
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host, int(port)), timeout=5) as s:
            s.settimeout(5)
            s.sendall(b'{"cmd": "shutdown"}\n')
            s.recv(100)
    except OSError:
        pass


def test_two_replica_processes_over_tcp_are_bitwise_swap_and_survive_a_kill(fleet_world,
                                                                            tmp_path):
    """Two ``fleet_driver`` replica processes over local TCP: scores bitwise
    the single server; a fleet swap under 8 clients has no new shape and
    mixes no generation; a killed replica is detected by its heartbeat and
    its rows degrade, counted once, while serving goes on."""
    hb_dir = str(tmp_path / "hb")
    procs = [_spawn_replica(fleet_world["fleet_dir"], r, 2, hb_dir) for r in range(2)]
    addrs = []
    router = None
    try:
        addrs = [_await_ready(p) for p in procs]
        clients = [tfleet.TcpReplicaClient(a, connect_timeout_s=5.0) for a in addrs]
        router = FleetRouter(load_fleet_meta(fleet_world["fleet_dir"]), clients,
                             heartbeat_dir=hb_dir, heartbeat_deadline_s=2.0,
                             request_timeout_s=20.0, hedge_ms=2000.0, probe_cooldown_s=0.5,
                             stats=FleetStats())
        reqs = fleet_world["requests"]
        server = _single_server(fleet_world)
        ref = server.score_rows(reqs)
        server.close()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(lambda q: router.submit_rows([q]), reqs))
        served = np.concatenate([f.result(timeout=60) for f in futs])
        assert np.array_equal(served, ref)

        new_ref = None
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(router.score_rows, [q]) for q in reqs]
            report = FleetSwapper(router, prepare_timeout_s=60.0).swap(fleet_world["fleet2"])
            results = [f.result(timeout=60) for f in futs]
        assert report["new_compiles"] == 0 and report["commit_failures"] == []
        new_ref = router.score_rows(reqs)
        assert not np.any(served == new_ref)
        for i, r in enumerate(results):
            assert r[0] == served[i] or r[0] == new_ref[i]
        assert router.new_request_compiles() == 0

        owners = ServeShardPlan.from_json(fleet_world["meta"]["plan"]).owners_of(
            [q["ids"]["userId"] for q in reqs])
        procs[1].kill()
        procs[1].wait(timeout=30)
        t0 = time.monotonic()
        while 1 in router.live_replicas():
            assert time.monotonic() - t0 < 10.0, "the killed replica was not marked dead"
            time.sleep(0.2)
        before = router.stats.snapshot()["degraded_rows"]
        after_kill = router.score_rows(reqs)
        exact = owners == 0
        assert exact.any()
        np.testing.assert_array_equal(after_kill[exact], new_ref[exact])
        assert router.stats.snapshot()["degraded_rows"] - before == int(np.sum(owners == 1))
    finally:
        if router is not None:
            router.close()
        for a in addrs:
            _tcp_shutdown(a)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


# ---------------------------------------------------------------------------
# Quantized fleets (store_dtype in fleet.json)
# ---------------------------------------------------------------------------


class TestQuantizedFleetMeta:
    def test_mixed_dtype_fleet_refused(self, fleet_world, tmp_path):
        fleet_dir = str(tmp_path / "mixed")
        build_fleet_stores(fleet_world["model_dir"], fleet_dir, num_replicas=2,
                           bucketer=ShapeBucketer(), store_dtype="f32")
        meta = load_fleet_meta(fleet_dir)
        assert (meta.get("store_dtype") or "f32") == "f32"
        build_model_store(fleet_world["model_dir"], replica_store_dir(fleet_dir, 1),
                          bucketer=ShapeBucketer(), store_dtype="int8")
        with pytest.raises(IOError, match="MIXED-DTYPE"):
            load_fleet_meta(fleet_dir)
        # the JAX package refuses the port's mixed fleet the same way
        with pytest.raises(IOError, match="MIXED-DTYPE"):
            jfleet.load_fleet_meta(fleet_dir)

    def test_fleet_meta_carries_pinned_budget(self, fleet_world, tmp_path):
        fleet_dir = str(tmp_path / "int8-fleet")
        meta = build_fleet_stores(fleet_world["model_dir"], fleet_dir, num_replicas=2,
                                  bucketer=ShapeBucketer(), store_dtype="int8")
        assert meta["store_dtype"] == "int8"
        q = meta["random"][0]["quantization"]
        assert 0 < q["realized_max_abs_coeff_err"] <= q["coeff_err_budget"]
        for r in range(2):
            rs = ModelStore(replica_store_dir(fleet_dir, r))
            rq = rs.random[0].quantization
            assert rq["realized_max_abs_coeff_err"] <= q["realized_max_abs_coeff_err"]
            rs.close()
        jmeta = jfleet.build_fleet_stores(fleet_world["model_dir"], str(tmp_path / "j-int8"),
                                          num_replicas=2, bucketer=JShapeBucketer(),
                                          store_dtype="int8")
        assert jmeta["random"] == meta["random"]

    def test_int8_fleet_within_budget_and_swap_free_of_new_shapes(self, fleet_world, tmp_path):
        from game_test_utils import assert_scores_match_store

        fleet_dir = str(tmp_path / "qfleet")
        meta = build_fleet_stores(fleet_world["model_dir"], fleet_dir, num_replicas=2,
                                  bucketer=ShapeBucketer(), store_dtype="int8")
        single = _single_server(fleet_world)
        oracle = single.score_rows(fleet_world["requests"])
        single.close()
        router, engines, _ = _local_fleet(fleet_world, fleet_dir=fleet_dir)
        try:
            served = np.concatenate([router.score_rows([q]) for q in fleet_world["requests"]])
            assert_scores_match_store(served, oracle, meta, fleet_world["requests"], SECTIONS,
                                      err_msg="int8 2-replica fleet vs f32 single store")
            assert not np.array_equal(served, oracle)
            fleet2 = str(tmp_path / "qfleet2")
            build_fleet_stores(fleet_world["model2"], fleet2, num_replicas=2,
                               bucketer=ShapeBucketer(), store_dtype="int8")
            report = FleetSwapper(router).swap(fleet2)
            assert report["new_compiles"] == 0
            assert report["dropped_requests"] == 0
            assert report["commit_failures"] == []
        finally:
            _close_fleet(router, engines)


def test_the_fault_site_registry_equals_the_jax_registry():
    """With the fleet's four ``serve.*`` sites, the port registers every
    site the JAX package does and no other (each fires where JAX fires it:
    tests/test_torch_checkpoint.py holds the literals)."""
    from photon_ml_tpu.resilience import sites as jsites
    from photon_ml_tpu_torch.resilience import sites as tsites

    assert set(tsites.FAULT_SITES) == set(jsites.FAULT_SITES)
    assert set(tsites.PREEMPT_SITES) == set(jsites.PREEMPT_SITES)
    for site in ("serve.route", "serve.replica_scatter", "serve.fleet_swap_barrier",
                 "serve.fleet_delta_rollout"):
        assert tsites.FAULT_SITES[site] == jsites.FAULT_SITES[site]
