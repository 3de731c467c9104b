"""The daily retrain loop of the port (photon_ml_tpu_torch.retrain) held
against the JAX package's (tests/test_retrain.py) on the same inputs.

The planner's file, coordinate and block classifications equal the JAX
planner's; each package loads the other's ``retrain.json``; the warm-start
round trip is bitwise; frozen coordinates and frozen streaming blocks carry
their prior coefficients bitwise; delta block builds write the JAX
package's bytes; the fault sites degrade to a cold run. A module-scoped
driver loop (cold run, all-unchanged rerun, one mutated file) runs both
drivers: the port's delta plan, block statuses and dirty sets equal the JAX
driver's, frozen entities are bitwise the prior run's and dirty blocks
re-solve.
"""

import dataclasses
import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import dense_to_csr, make_glmix_data, write_game_avro
from photon_ml_tpu import retrain as jretrain
from photon_ml_tpu.algorithm.bucketed_random_effect import BucketedDatasetBundle as JBundle
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.algorithm.streaming_random_effect import (
    write_re_entity_blocks as j_write_blocks,
)
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_re_dataset
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.io.index_map import feature_key as jkey
from photon_ml_tpu.io.tensor_cache import TensorCache as JTensorCache
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.retrain.manifest import CoordinateRecord as JRecord
from photon_ml_tpu.retrain.manifest import RetrainManifest as JManifest
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import retrain
from photon_ml_tpu_torch.algorithm.bucketed_random_effect import (
    BucketedDatasetBundle,
    BucketedRandomEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    global_coefficients,
)
from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    StreamingRandomEffectCoordinate,
    write_re_entity_blocks,
)
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.cli.game_params import parse_training_params
from photon_ml_tpu_torch.data.game import (
    RandomEffectDataConfig,
    build_fixed_effect_batch,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.io import avro_data
from photon_ml_tpu_torch.io import model_io
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.io.tensor_cache import CacheStats, TensorCache
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.resilience.sites import FAULT_SITES
from photon_ml_tpu_torch.retrain.manifest import CoordinateRecord, RetrainManifest
from photon_ml_tpu_torch.types import TaskType
from test_torch_game import _port_data
from tolerances import assert_allclose

NUM_USERS = 30
USERS_PER_FILE = 6  # 5 files; mutating one dirties one block of 6 users


def _write_partitioned(train_dir, gd, truth, mutate_file=None, drop_rows=0):
    """The user-partitioned daily layout (tests/test_retrain.py); with
    ``mutate_file`` only that file is rewritten, the others keep their
    stat tokens."""
    user_of_row = gd.ids["userId"]
    os.makedirs(train_dir, exist_ok=True)
    for k in range(NUM_USERS // USERS_PER_FILE):
        rows = np.nonzero((user_of_row >= USERS_PER_FILE * k)
                          & (user_of_row < USERS_PER_FILE * (k + 1)))[0]
        if k == mutate_file and drop_rows:
            rows = rows[:-drop_rows]
        if mutate_file is None or k == mutate_file:
            write_game_avro(os.path.join(train_dir, f"part-{k}.avro"), gd, rows, truth)


def _flags(train_dir, out_dir, extra=()):
    return [
        "--train-input-dirs", train_dir,
        "--output-dir", out_dir,
        "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map",
        "global:fixedFeatures|per_user:userFeatures",
        "--updating-sequence", "fixed,per-user",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations",
        "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
        "--fixed-effect-optimization-configurations", "fixed:20,1e-7,0.01,1,LBFGS,L2",
        "--random-effect-optimization-configurations", "per-user:15,1e-6,0.1,1,LBFGS,L2",
        "--delete-output-dir-if-exists", "true",
        "--re-memory-budget-mb", "0.001",  # blocks of 6 users: one per file
        "--num-iterations", "2",
    ] + list(extra)


def _port(argv):
    return tdriver.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def delta_runs(tmp_path_factory):
    """Both drivers: a cold run, an all-unchanged rerun, then a run after
    the last file lost 2 rows (its users dirty, the other blocks frozen)."""
    base = tmp_path_factory.mktemp("retrain")
    rng = np.random.default_rng(11)
    gd, truth = make_glmix_data(rng, num_users=NUM_USERS, rows_per_user_range=(10, 11),
                                d_fixed=5, d_random=3)
    train_dir = str(base / "train")
    _write_partitioned(train_dir, gd, truth)
    runs = {"base": base, "train_dir": train_dir}
    for pkg, run in (("jax", jdriver.main), ("port", _port)):
        cache = str(base / f"{pkg}-cache")
        out1, out2 = str(base / f"{pkg}-run1"), str(base / f"{pkg}-run2")
        runs[pkg, 1] = run(_flags(train_dir, out1, ["--tensor-cache", cache])), out1
        runs[pkg, 2] = run(_flags(train_dir, out2, ["--tensor-cache", cache,
                                                    "--warm-start-from", out1])), out2
    time.sleep(0.02)  # mtime_ns must move even on coarse filesystems
    _write_partitioned(train_dir, gd, truth, mutate_file=NUM_USERS // USERS_PER_FILE - 1,
                       drop_rows=2)
    for pkg, run in (("jax", jdriver.main), ("port", _port)):
        out3 = str(base / f"{pkg}-run3")
        runs[pkg, 3] = run(_flags(train_dir, out3, [
            "--tensor-cache", str(base / f"{pkg}-cache"),
            "--warm-start-from", runs[pkg, 1][1]])), out3
    return runs


# ---------------------------------------------------------------------------
# planner units, both packages on the same manifests
# ---------------------------------------------------------------------------


def _manifests(tmp_path, files, **over):
    """The same prior manifest in both packages."""
    model_dir = os.path.join(str(tmp_path), "model")
    os.makedirs(model_dir, exist_ok=True)
    kw = dict(output_dir=str(tmp_path), model_dir=model_dir, task="LOGISTIC_REGRESSION",
              file_stats=retrain.file_stat_token(files),
              ingest_inputs={"sections": {}, "id_types": ["userId"]}, ingest_digest="d0",
              updating_sequence=["fixed", "per-user"])
    kw.update(over)
    port = RetrainManifest(coordinates={
        "fixed": CoordinateRecord(kind="fixed", opt_config="cfgA"),
        "per-user": CoordinateRecord(kind="random", opt_config="cfgB")}, **kw)
    jax = JManifest(coordinates={
        "fixed": JRecord(kind="fixed", opt_config="cfgA"),
        "per-user": JRecord(kind="random", opt_config="cfgB")}, **kw)
    return port, jax


def _touch(path, content=b"x"):
    with open(path, "wb") as f:
        f.write(content)


def _plan_summary(plan):
    f = plan.files
    return ((f.unchanged, f.changed, f.new, f.removed),
            {n: (c.status, c.reason) for n, c in plan.coordinates.items()},
            plan.short_circuit, plan.describe_decisions(), plan.frozen_coordinates())


def test_diff_files_matches_jax(tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("a", "b", "c"))
    for p in (a, b, c):
        _touch(p)
    port, jax = _manifests(tmp_path, [a, b, c])
    time.sleep(0.02)
    _touch(b, b"different content entirely")
    d = str(tmp_path / "d")
    _touch(d)
    got = retrain.diff_files(port.stat_by_path(), [a, b, d])
    want = jretrain.diff_files(jax.stat_by_path(), [a, b, d])
    assert (got.unchanged, got.changed, got.new, got.removed) == (
        want.unchanged, want.changed, want.new, want.removed)
    assert got.changed == (os.path.abspath(b),) and got.removed == (os.path.abspath(c),)
    assert got.describe() == want.describe() and not got.clean


SCENARIOS = {
    "unchanged": dict(),
    "changed-file": dict(touch=True),
    "config-change": dict(combo={"fixed": "cfgA", "per-user": "DIFFERENT"}),
    "new-coordinate": dict(sequence=["fixed", "per-user", "per-item"],
                           combo={"fixed": "cfgA", "per-user": "cfgB", "per-item": "cfgC"}),
    "validation-moved": dict(prior_eval={"validate_files": [["v", 1, 2]]},
                             eval={"validate_files": [["v2", 9, 9]]}),
    "multi-combo": dict(combo=None),
    "task-change": dict(task="LINEAR_REGRESSION"),
    "ingest-change": dict(ingest={"sections": {"x": ["y"]}, "id_types": ["userId"]}),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_plan_delta_matches_jax(tmp_path, case):
    sc = SCENARIOS[case]
    a = str(tmp_path / "a")
    _touch(a)
    over = {"eval_identity": sc["prior_eval"]} if "prior_eval" in sc else {}
    port, jax = _manifests(tmp_path, [a], **over)
    if sc.get("touch"):
        time.sleep(0.02)
        _touch(a, b"new day new bytes")
    kw = dict(task=sc.get("task", "LOGISTIC_REGRESSION"),
              updating_sequence=sc.get("sequence", ["fixed", "per-user"]),
              ingest_inputs=sc.get("ingest", port.ingest_inputs),
              combo_configs=sc.get("combo", {"fixed": "cfgA", "per-user": "cfgB"}),
              eval_identity=sc.get("eval"))
    got, want = retrain.plan_delta(port, [a], **kw), jretrain.plan_delta(jax, [a], **kw)
    assert _plan_summary(got) == _plan_summary(want)
    assert got.short_circuit == (case == "unchanged")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_manifest(tmp_path, writer):
    a = str(tmp_path / "a")
    _touch(a)
    port, jax = _manifests(tmp_path, [a], data_cache_key="k123",
                           cost_model={"format": 1, "observations": {}, "drift_log": []})
    (port if writer == "port" else jax).save(str(tmp_path))
    got = RetrainManifest.load(str(tmp_path))
    want = JManifest.load(str(tmp_path))
    assert got.coordinates["fixed"].opt_config == want.coordinates["fixed"].opt_config == "cfgA"
    assert got.data_cache_key == want.data_cache_key == "k123"
    assert got.stat_by_path() == want.stat_by_path()
    assert got.cost_model == want.cost_model
    assert retrain.load_prior_manifest(str(tmp_path)).task == "LOGISTIC_REGRESSION"


def test_manifest_format_and_vanished_model_are_refused(tmp_path):
    a = str(tmp_path / "a")
    _touch(a)
    port, _ = _manifests(tmp_path, [a])
    path = port.save(str(tmp_path))
    raw = json.load(open(path))
    raw["format"] = 999
    json.dump(raw, open(path, "w"))
    with pytest.raises(ValueError, match="format"):
        RetrainManifest.load(str(tmp_path))
    port.save(str(tmp_path))
    shutil.rmtree(port.model_dir)
    with pytest.raises(FileNotFoundError):
        retrain.load_prior_manifest(str(tmp_path))


def test_dirty_probe_reads_natively_and_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    gd, truth = make_glmix_data(rng, num_users=12, rows_per_user_range=(3, 6))
    paths = []
    for k, rows in enumerate(np.array_split(np.arange(gd.num_rows), 3)):
        paths.append(str(tmp_path / f"part-{k}.avro"))
        write_game_avro(paths[-1], gd, rows, truth)
    files = retrain.FileDelta(unchanged=(paths[0],), changed=(paths[1],), new=(paths[2],),
                              removed=())
    before = dict(avro_data.ingest_counts)
    got = retrain.probe_dirty_entities(files, ["userId"])
    assert avro_data.ingest_counts["native_files"] == before["native_files"] + 2
    assert avro_data.ingest_counts["row_loop_files"] == before["row_loop_files"]
    want = jretrain.probe_dirty_entities(
        jretrain.FileDelta(files.unchanged, files.changed, files.new, ()), ["userId"])
    assert got == want and got["userId"]
    assert retrain.dirty_set_digest(got["userId"]) == jretrain.dirty_set_digest(want["userId"])
    empty = retrain.FileDelta(unchanged=tuple(paths), changed=(), new=(), removed=())
    assert retrain.probe_dirty_entities(empty, ["userId"]) == {"userId": set()}


# ---------------------------------------------------------------------------
# fault sites: every unusable prior degrades to a cold run
# ---------------------------------------------------------------------------


def test_delta_plan_fault_site_raises_into_caller(tmp_path):
    assert "retrain.delta_plan" in FAULT_SITES and "io.cache_invalidate" in FAULT_SITES
    a = str(tmp_path / "a")
    _touch(a)
    port, _ = _manifests(tmp_path, [a])
    port.save(str(tmp_path))
    with faults.fault_scope(faults.parse_fault_env("retrain.delta_plan:rate=1.0,seed=1")):
        with pytest.raises(faults.InjectedIOError):
            retrain.load_prior_manifest(str(tmp_path))
    assert retrain.load_prior_manifest(str(tmp_path)).task


@pytest.mark.parametrize("prior", ["injected-fault", "corrupt-json", "malformed-stats"])
def test_an_unusable_prior_degrades_the_driver_to_cold(tmp_path, prior):
    train_dir = str(tmp_path / "train")
    os.makedirs(train_dir)
    a = os.path.join(train_dir, "part-0.avro")
    _touch(a)
    prior_dir = str(tmp_path / "prior")
    os.makedirs(prior_dir)
    port, _ = _manifests(tmp_path / "prior", [a])
    path = port.save(prior_dir)
    if prior == "corrupt-json":
        open(path, "w").write("{this is not json")
    elif prior == "malformed-stats":
        raw = json.load(open(path))
        raw["file_stats"] = [[a, 123]]  # no mtime: a malformed token
        json.dump(raw, open(path, "w"))
    params = parse_training_params(_flags(train_dir, str(tmp_path / "out"),
                                          ["--warm-start-from", prior_dir, "--device", "cpu"]))
    driver = tdriver.GameTrainingDriver(params, logger=_NullLogger())
    if prior == "injected-fault":
        with faults.fault_scope(faults.parse_fault_env("retrain.delta_plan:rate=1.0,seed=1")):
            driver._maybe_plan_delta([a])
    else:
        driver._maybe_plan_delta([a])
    assert driver.delta_plan is None and driver.retrain_prior is None
    assert any("retraining cold" in m for m in driver.logger.warnings)


def test_warm_start_from_the_output_dir_is_refused(tmp_path):
    with pytest.raises(ValueError, match="PRIOR run's output dir"):
        parse_training_params(_flags(str(tmp_path), str(tmp_path / "o"),
                                     ["--warm-start-from", str(tmp_path / "o"),
                                      "--device", "cpu"]))


class _NullLogger:
    def __init__(self):
        self.warnings = []

    def info(self, msg):
        pass

    def warn(self, msg):
        self.warnings.append(msg)

    def close(self):
        pass


# ---------------------------------------------------------------------------
# warm starts: the round trip through a saved model is bitwise
# ---------------------------------------------------------------------------


def _re_dataset(gd):
    cfg = RandomEffectDataConfig(random_effect_id="userId", feature_shard_id="per_user")
    return cfg, build_random_effect_dataset(_port_data(gd), cfg, device="cpu")


def _pos_of_vocab(gd, ds):
    ids = gd.ids["userId"]
    entity_pos = ds.entity_pos.numpy()
    pos = np.full(len(gd.id_vocabs["userId"]), -1, np.int32)
    known = entity_pos >= 0
    pos[ids[known]] = entity_pos[known]
    return pos


def test_dense_warm_round_trip_is_bitwise_and_reads_jax_models(tmp_path, rng):
    gd, _ = make_glmix_data(rng, num_users=8, rows_per_user_range=(5, 9), d_random=3)
    _, ds = _re_dataset(gd)
    ltg = ds.local_to_global.numpy()
    w_local = rng.normal(size=ltg.shape).astype(np.float32)
    wg = global_coefficients(ds, torch.from_numpy(w_local)).numpy()
    imap = IndexMap.build([feature_key(f"u{j}", "") for j in range(3)], add_intercept=False)
    vocab = gd.id_vocabs["userId"]
    pos = _pos_of_vocab(gd, ds)
    means = {raw: wg[pos[vi]] for vi, raw in enumerate(vocab) if pos[vi] >= 0}
    jimap = JIndexMap.build([jkey(f"u{j}", "") for j in range(3)], add_intercept=False)
    for writer, root in (("port", tmp_path / "p"), ("jax", tmp_path / "j")):
        if writer == "port":
            model_io.save_random_effect(str(root), "per-user", TaskType.LOGISTIC_REGRESSION,
                                        means, imap, random_effect_id="userId",
                                        feature_shard_id="per_user")
        else:
            jmodel_io.save_random_effect(str(root), "per-user", JTask.LOGISTIC_REGRESSION,
                                         means, jimap, random_effect_id="userId",
                                         feature_shard_id="per_user")
        back = retrain.random_effect_entity_means(str(root), "per-user", imap)
        w_back = retrain.dense_random_effect_init(back, vocab=vocab, pos_of_vocab=pos,
                                                  local_to_global=ltg)
        want = jretrain.dense_random_effect_init(
            jretrain.random_effect_entity_means(str(root), "per-user", jimap),
            vocab=vocab, pos_of_vocab=pos, local_to_global=ltg)
        valid = ltg >= 0
        assert np.array_equal(w_back[valid], w_local[valid]), writer
        assert np.array_equal(w_back, want), writer
    assert retrain.random_effect_entity_means(str(tmp_path / "p"), "absent", imap) is None


def test_factored_prior_and_absent_fixed_effect_give_no_warm_state(tmp_path):
    imap = IndexMap.build([feature_key("u0", "")], add_intercept=False)
    model_io.save_factored_random_effect(
        str(tmp_path), "per-user", {"u0": np.array([0.5, 0.5])}, np.ones((2, 3), np.float32),
        random_effect_id="userId", feature_shard_id="per_user")
    assert retrain.random_effect_entity_means(str(tmp_path), "per-user", imap) is None
    assert retrain.fixed_effect_init(str(tmp_path), "fixed", imap) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fixed_effect_init_aligns_by_name_as_in_jax(tmp_path, rng, writer):
    """The prior vector realigned to today's index map by feature name: the
    port's vector is the JAX package's bit for bit; a kept feature carries
    its saved value bitwise, a new one starts at 0."""
    saved = [feature_key(f"f{j}", "") for j in range(6)]
    now = [feature_key(f"f{j}", "") for j in range(2, 9)]
    imap = IndexMap.build(saved)
    means = rng.normal(size=len(imap)).astype(np.float32)
    if writer == "port":
        model_io.save_fixed_effect(str(tmp_path), "fixed", TaskType.LOGISTIC_REGRESSION, means,
                                   imap)
    else:
        jmodel_io.save_fixed_effect(str(tmp_path), "fixed", JTask.LOGISTIC_REGRESSION, means,
                                    JIndexMap.build([jkey(f"f{j}", "") for j in range(6)]))
    cur = IndexMap.build(now)
    got = retrain.fixed_effect_init(str(tmp_path), "fixed", cur)
    want = jretrain.fixed_effect_init(str(tmp_path), "fixed",
                                      JIndexMap.build([jkey(f"f{j}", "") for j in range(2, 9)]))
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    for name in list(cur.name_to_index):
        was = imap.name_to_index.get(name)
        assert got[cur.get_index(name)] == (0.0 if was is None else means[was]), name


def _sparse_per_user(gd, rng):
    """``gd`` with each user's rows carrying only a random subset of the
    per-user features, so every entity projects through its own
    ``local_to_global`` (INDEX_MAP)."""
    f = gd.shards["per_user"]
    x = np.zeros((gd.num_rows, f.dim), np.float32)
    for r in range(gd.num_rows):
        x[r, f.indices[f.indptr[r]:f.indptr[r + 1]]] = f.values[f.indptr[r]:f.indptr[r + 1]]
    users = gd.ids["userId"]
    keep = rng.random((int(users.max()) + 1, f.dim)) < 0.6
    keep[np.arange(keep.shape[0]), rng.integers(0, f.dim, keep.shape[0])] = True
    shards = dict(gd.shards)
    shards["per_user"] = dense_to_csr(x * keep[users])
    return dataclasses.replace(gd, shards=shards)


@pytest.mark.parametrize("ladder", ["off", "8:2"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bucketed_warm_stacks_are_the_jax_stacks_bitwise(tmp_path, rng, ladder, writer):
    """``bucketed_random_effect_init`` against the JAX package's on the same
    saved model and the same buckets: every stack bitwise equal. A prior
    exported from seeded stacks comes back into its own bucket lanes bit for
    bit (zeros where a lane's projection has no slot, on ladder padding and
    for entities the prior model lacks)."""
    gd, _ = make_glmix_data(rng, num_users=40, rows_per_user_range=(2, 40), d_random=5)
    gd = _sparse_per_user(gd, rng)
    cfg = RandomEffectDataConfig(random_effect_id="userId", feature_shard_id="per_user")
    jcfg = JReConfig(random_effect_id="userId", feature_shard_id="per_user")
    coord = BucketedRandomEffectCoordinate(_port_data(gd), cfg, TaskType.LOGISTIC_REGRESSION,
                                           bucketer=ladder, device="cpu")
    bundle = coord.bundle
    jbundle = JBundle.build(gd, jcfg, bucketer=ladder)
    assert len(bundle.datasets) == len(jbundle.datasets) >= 3
    seeded = []
    for ds in bundle.datasets:
        w = rng.normal(size=(int(ds.num_entities), int(ds.local_dim))).astype(np.float32)
        seeded.append(np.where(ds.local_to_global.numpy() >= 0, w, 0.0).astype(np.float32))
    means, _ = coord.entity_export_by_raw_id(tuple(torch.from_numpy(w) for w in seeded))
    dropped = set(bundle.vocab[:5])
    means = {raw: row for raw, row in means.items() if raw not in dropped}
    names = [feature_key(f"u{j}", "") for j in range(5)]
    if writer == "port":
        model_io.save_random_effect(str(tmp_path), "per-user", TaskType.LOGISTIC_REGRESSION,
                                    means, IndexMap.build(names, add_intercept=False),
                                    random_effect_id="userId", feature_shard_id="per_user")
    else:
        jmodel_io.save_random_effect(str(tmp_path), "per-user", JTask.LOGISTIC_REGRESSION,
                                     means, JIndexMap.build([jkey(f"u{j}", "") for j in range(5)],
                                                            add_intercept=False),
                                     random_effect_id="userId", feature_shard_id="per_user")
    got = retrain.bucketed_random_effect_init(
        retrain.random_effect_entity_means(str(tmp_path), "per-user",
                                           IndexMap.build(names, add_intercept=False)), bundle)
    want = jretrain.bucketed_random_effect_init(
        jretrain.random_effect_entity_means(
            str(tmp_path), "per-user",
            JIndexMap.build([jkey(f"u{j}", "") for j in range(5)], add_intercept=False)),
        jbundle)
    bucket_of, pos_in_bucket = coord.vocab_position_maps()
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), b
        expect = seeded[b].copy()
        for vi, raw in enumerate(bundle.vocab):
            if raw in dropped and bucket_of[vi] == b:
                expect[pos_in_bucket[vi]] = 0.0
        live = np.zeros(len(expect), bool)
        live[pos_in_bucket[bucket_of == b]] = True
        expect[~live] = 0.0
        assert np.array_equal(g, expect), b


def test_seed_spilled_state_is_the_prior_bitwise(tmp_path, rng):
    gd, _ = make_glmix_data(rng, num_users=12, rows_per_user_range=(4, 8), d_random=3)
    cfg = RandomEffectDataConfig(random_effect_id="userId", feature_shard_id="per_user")
    manifest = write_re_entity_blocks(_port_data(gd), cfg, str(tmp_path / "blocks"),
                                      block_entities=5)
    means = {raw: rng.normal(size=3).astype(np.float32) for raw in gd.id_vocabs["userId"][:7]}
    state = retrain.seed_spilled_state(manifest, means, str(tmp_path / "seed"))
    jcfg = JReConfig(random_effect_id="userId", feature_shard_id="per_user")
    jmanifest = j_write_blocks(gd, jcfg, str(tmp_path / "jblocks"), block_entities=5)
    jstate = jretrain.seed_spilled_state(jmanifest, means, str(tmp_path / "jseed"))
    for i in range(len(manifest.blocks)):
        assert np.array_equal(state.block(i), jstate.block(i)), i
    assert sorted(os.listdir(state.dir)) == sorted(os.listdir(jstate.dir))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        retrain.seed_perhost_spilled_state(manifest, means, str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# frozen coordinates and frozen blocks
# ---------------------------------------------------------------------------


L2 = 1.0  # both coordinates' L2 weight in the descents held against JAX


def _cd(gd):
    task = TaskType.LOGISTIC_REGRESSION
    pdata = _port_data(gd)
    coords = {
        "fixed": FixedEffectCoordinate(
            build_fixed_effect_batch(pdata, "global", dense=True, device="cpu"),
            GLMOptimizationProblem(task=task, regularization=RegularizationContext.l2(L2))),
        "per-user": RandomEffectCoordinate(_re_dataset(gd)[1], task,
                                           regularization=RegularizationContext.l2(L2)),
    }
    loss = losses_mod.for_task(task)
    labels, weights = torch.from_numpy(gd.response), torch.from_numpy(gd.weight)
    return CoordinateDescent(coords, lambda total: torch.sum(weights * loss.loss(total, labels)))


def _jcd(gd):
    """``_cd``'s descent in the JAX package, on the same data."""
    task = JTask.LOGISTIC_REGRESSION
    coords = {
        "fixed": JFixed(j_fe_batch(gd, "global", dense=True),
                        JProblem(task=task, regularization=JReg.l2(L2))),
        "per-user": JRandom(j_re_dataset(gd, JReConfig(random_effect_id="userId",
                                                       feature_shard_id="per_user")), task,
                            regularization=JReg.l2(L2)),
    }
    loss = jlosses.for_task(task)
    labels, weights = jnp.asarray(gd.response), jnp.asarray(gd.weight)
    return JCD(coords, lambda total: jnp.sum(weights * loss.loss(total, labels)))


def _held_against_jax(got, want):
    """A port descent result against the JAX package's at ``solver``."""
    assert len(got.objective_history) == len(want.objective_history)
    assert_allclose(got.objective_history, want.objective_history, kind="solver",
                    dtype=np.float32)
    for name, w in got.coefficients.items():
        assert_allclose(w.numpy(), np.asarray(want.coefficients[name]), kind="solver",
                        err_msg=name)
    assert_allclose(got.total_scores.numpy(), np.asarray(want.total_scores), kind="solver")


def test_a_frozen_coordinate_carries_its_params_bitwise(rng):
    """A frozen coordinate carries its warm start bitwise in both packages;
    the other coordinate's warm solve and the objectives match JAX's."""
    gd, _ = make_glmix_data(rng, num_users=6, rows_per_user_range=(5, 9))
    r1 = _cd(gd).run(2, gd.num_rows)
    init = {k: v.clone() for k, v in r1.coefficients.items()}
    r2 = _cd(gd).run(2, gd.num_rows, initial_params=init, frozen={"per-user"})
    assert torch.equal(r2.coefficients["per-user"], r1.coefficients["per-user"])
    assert not torch.equal(r2.coefficients["fixed"], r1.coefficients["fixed"])
    assert len(r2.objective_history) == 4  # one entry per update, frozen or not
    jinit = {k: jnp.asarray(v.numpy()) for k, v in init.items()}
    j2 = _jcd(gd).run(2, gd.num_rows, initial_params=jinit, frozen={"per-user"})
    assert np.array_equal(np.asarray(j2.coefficients["per-user"]), init["per-user"].numpy())
    _held_against_jax(r2, j2)


def test_run_grid_takes_partial_init_params(rng):
    """Each combo starts from the fixed effect's warm start and a cold
    random effect, as the JAX grid does: every combo held against JAX's."""
    gd, _ = make_glmix_data(rng, num_users=4, rows_per_user_range=(5, 8))
    r1 = _cd(gd).run(1, gd.num_rows)
    lambdas = {"fixed": [0.0, 0.5], "per-user": [0.1, 1.0]}
    results = _cd(gd).run_grid(lambdas, 1, gd.num_rows,
                               init_params={"fixed": r1.coefficients["fixed"]})
    want = _jcd(gd).run_grid({k: jnp.asarray(v) for k, v in lambdas.items()}, 1, gd.num_rows,
                             init_params={"fixed": jnp.asarray(r1.coefficients["fixed"].numpy())})
    assert len(results) == len(want) == 2
    for got, w in zip(results, want):
        _held_against_jax(got, w)


@pytest.mark.parametrize("frozen,init,match", [
    ({"per-user"}, None, "initial_params"),
    ({"nope"}, {}, "not in the updating"),
])
def test_frozen_names_are_checked_with_the_jax_words(rng, frozen, init, match):
    gd, _ = make_glmix_data(rng, num_users=4, rows_per_user_range=(5, 8))
    with pytest.raises(ValueError, match=match):
        _cd(gd).run(1, gd.num_rows, initial_params=init, frozen=frozen)


def test_frozen_streaming_blocks_never_solve(tmp_path, rng):
    gd, _ = make_glmix_data(rng, num_users=15, rows_per_user_range=(5, 9), d_random=3)
    cfg = RandomEffectDataConfig(random_effect_id="userId", feature_shard_id="per_user")
    manifest = write_re_entity_blocks(_port_data(gd), cfg, str(tmp_path / "b"),
                                      block_entities=5)
    task = TaskType.LOGISTIC_REGRESSION
    cold = StreamingRandomEffectCoordinate(manifest=manifest, task=task, device="cpu",
                                           state_root=str(tmp_path / "s0"))
    resid = torch.zeros(gd.num_rows)
    prior, _ = cold.update(resid, cold.initial_coefficients())
    frozen = StreamingRandomEffectCoordinate(manifest=manifest, task=task, device="cpu",
                                             frozen_blocks=frozenset({0, 2}),
                                             state_root=str(tmp_path / "s1"))
    new, summaries = frozen.update(resid + 0.5, prior)
    assert summaries[0] is None and summaries[2] is None and summaries[1] is not None
    for i in (0, 2):
        assert np.array_equal(new.block(i), prior.block(i))
    assert not np.array_equal(new.block(1), prior.block(1))
    first = frozen.score(new)
    assert set(frozen._frozen_scores) == {0, 2}
    assert torch.equal(frozen.score(new), first)
    assert torch.equal(first, cold.score(new))
    with pytest.raises(ValueError, match="out of range"):
        StreamingRandomEffectCoordinate(manifest=manifest, task=task, device="cpu",
                                        frozen_blocks=frozenset({7}))


# ---------------------------------------------------------------------------
# the delta block build: the JAX package's classifications and bytes
# ---------------------------------------------------------------------------


@pytest.fixture()
def prior_blocks(tmp_path, rng):
    gd, _ = make_glmix_data(rng, num_users=20, rows_per_user_range=(6, 10), d_random=3)
    cfg = RandomEffectDataConfig(random_effect_id="userId", feature_shard_id="per_user")
    jcfg = JReConfig(random_effect_id="userId", feature_shard_id="per_user")
    port = write_re_entity_blocks(_port_data(gd), cfg, str(tmp_path / "prior"), block_entities=5)
    jax = j_write_blocks(gd, jcfg, str(tmp_path / "jprior"), block_entities=5)
    return gd, cfg, jcfg, port, jax


def _both_builds(tmp_path, gd, cfg, jcfg, port_prior, jax_prior, dirty, tag, **kw):
    got = retrain.build_delta_streaming_manifest(_port_data(gd), cfg, str(tmp_path / f"p-{tag}"),
                                                 port_prior, dirty, **kw)
    want = jretrain.build_delta_streaming_manifest(gd, jcfg, str(tmp_path / f"j-{tag}"),
                                                   jax_prior, dirty, **kw)
    return got, want


def _deltas(deltas):
    return [(d.index, d.status, d.prior_index, d.reason.split(" (")[0]) for d in deltas]


def _tree_bytes(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("case", ["one-dirty", "rows-lost", "new-entities", "nothing-dirty"])
def test_delta_block_build_matches_jax(tmp_path, prior_blocks, case):
    gd, cfg, jcfg, port_prior, jax_prior = prior_blocks
    vocab = gd.id_vocabs["userId"]
    dirty = {vocab[3]} if case == "one-dirty" else set()
    if case == "rows-lost":
        # an entity that silently lost a row must not reuse its stale payload
        ids = gd.ids["userId"]
        drop = np.nonzero(ids == int(ids[0]))[0][:1]
        from test_retrain import _subset_game_data

        gd = _subset_game_data(gd, np.setdiff1d(np.arange(gd.num_rows), drop))
    if case == "new-entities":
        from test_retrain import _subset_game_data

        ids = gd.ids["userId"]
        sub = _subset_game_data(gd, np.nonzero(ids < 15)[0])
        sub.id_vocabs["userId"] = gd.id_vocabs["userId"][:15]
        port_prior = write_re_entity_blocks(_port_data(sub), cfg, str(tmp_path / "psub"),
                                            block_entities=5)
        jax_prior = j_write_blocks(sub, jcfg, str(tmp_path / "jsub"), block_entities=5)
    (pm, pd), (jm, jd) = _both_builds(tmp_path, gd, cfg, jcfg, port_prior, jax_prior, dirty,
                                      case, block_entities=5)
    assert _deltas(pd) == _deltas(jd)
    statuses = {d.status for d in pd}
    assert {"one-dirty": "dirty", "rows-lost": "dirty", "new-entities": "new",
            "nothing-dirty": "unchanged"}[case] in statuses
    if case == "rows-lost":
        assert [d.reason for d in pd if "row count moved" in d.reason]
    blocks_p, blocks_j = _tree_bytes(pm.dir), _tree_bytes(jm.dir)
    assert sorted(blocks_p) == sorted(blocks_j)
    for name in blocks_p:
        if name.endswith(".npz"):
            assert blocks_p[name] == blocks_j[name], name
    assert json.load(open(os.path.join(pm.dir, "manifest.json")))["blocks"] == \
        json.load(open(os.path.join(jm.dir, "manifest.json")))["blocks"]
    for d in pd:
        if d.status == "unchanged":  # the prior payload, only its row space rewritten
            old = np.load(os.path.join(port_prior.dir, port_prior.blocks[d.prior_index]["file"]))
            new = np.load(os.path.join(pm.dir, pm.blocks[d.index]["file"]))
            for field in ("x", "labels", "weights", "entity_pos", "local_to_global"):
                assert np.array_equal(old[field], new[field]), field


def test_lost_prior_block_and_budget_outgrowth_degrade_as_in_jax(tmp_path, prior_blocks):
    gd, cfg, jcfg, port_prior, jax_prior = prior_blocks
    for prior in (port_prior, jax_prior):
        os.remove(os.path.join(prior.dir, prior.blocks[0]["file"]))
    (pm, pd), (_, jd) = _both_builds(tmp_path, gd, cfg, jcfg, port_prior, jax_prior, set(),
                                     "lost", block_entities=5)
    assert _deltas(pd) == _deltas(jd)
    assert any("unreadable" in d.reason for d in pd)
    assert len(pm.blocks) == len(port_prior.blocks)
    # every entity dirty, a budget the grown blocks cannot keep: re-blocked
    budget = 300
    port_b = write_re_entity_blocks(_port_data(gd), cfg, str(tmp_path / "pb"),
                                    memory_budget_bytes=budget * 4)
    jax_b = j_write_blocks(gd, jcfg, str(tmp_path / "jb"), memory_budget_bytes=budget * 4)
    (pm, pd), (_, jd) = _both_builds(tmp_path, gd, cfg, jcfg, port_b, jax_b,
                                     set(gd.id_vocabs["userId"]), "grown",
                                     memory_budget_bytes=budget)
    assert _deltas(pd) == _deltas(jd)
    assert any("outgrew the budget" in d.reason for d in pd)
    assert all(b["x_bytes"] <= budget for b in pm.blocks)


def test_delta_build_cache_entry_and_hit_match_jax(tmp_path, prior_blocks):
    gd, cfg, jcfg, port_prior, jax_prior = prior_blocks
    key = "k" * 64
    cache = TensorCache(str(tmp_path / "pc"), stats=CacheStats())
    jcache = JTensorCache(str(tmp_path / "jc"))
    m1, d1 = retrain.build_delta_streaming_manifest(
        _port_data(gd), cfg, str(tmp_path / "nb"), port_prior, set(), block_entities=5,
        tensor_cache=cache, cache_key=key)
    m2, d2 = retrain.build_delta_streaming_manifest(
        _port_data(gd), cfg, str(tmp_path / "nb2"), port_prior, set(), block_entities=5,
        tensor_cache=cache, cache_key=key)
    jm, jd = jretrain.build_delta_streaming_manifest(
        gd, jcfg, str(tmp_path / "jnb"), jax_prior, set(), block_entities=5,
        tensor_cache=jcache, cache_key=key)
    assert m2.dir == m1.dir  # served from the cache entry
    assert _deltas(d2) == _deltas(d1) == _deltas(jd)
    assert os.path.relpath(m1.dir, str(tmp_path / "pc")) == os.path.relpath(
        jm.dir, str(tmp_path / "jc"))
    assert {n: b for n, b in _tree_bytes(m1.dir).items() if n.endswith(".npz")} == \
        {n: b for n, b in _tree_bytes(jm.dir).items() if n.endswith(".npz")}


# ---------------------------------------------------------------------------
# the driver loop, both packages
# ---------------------------------------------------------------------------


def test_prior_runs_write_manifests_each_package_reads(delta_runs):
    for pkg in ("jax", "port"):
        out1 = delta_runs[pkg, 1][1]
        m = RetrainManifest.load(out1)
        assert JManifest.load(out1).coordinates.keys() == m.coordinates.keys()
        assert m.coordinates["per-user"].kind == "streaming_random"
        assert os.path.isdir(m.coordinates["per-user"].streaming_manifest_dir)
        assert m.data_cache_key and "cost_model" not in json.load(
            open(os.path.join(out1, "retrain.json")))


def test_unchanged_rerun_short_circuits_bitwise(delta_runs):
    d2, out2 = delta_runs["port", 2]
    out1 = delta_runs["port", 1][1]
    assert d2.delta_plan.short_circuit and d2.results == []
    assert _plan_summary(d2.delta_plan)[1:] == _plan_summary(delta_runs["jax", 2][0].delta_plan)[1:]
    for root, _, files in os.walk(os.path.join(out1, "best")):
        rel = os.path.relpath(root, os.path.join(out1, "best"))
        for f in files:
            with open(os.path.join(root, f), "rb") as fa, \
                    open(os.path.join(out2, "best", rel, f), "rb") as fb:
                assert fa.read() == fb.read(), (rel, f)
    m2 = RetrainManifest.load(out2)
    assert m2.model_dir == os.path.abspath(os.path.join(out2, "best"))
    assert m2.coordinates == RetrainManifest.load(out1).coordinates


def test_delta_plan_blocks_and_dirty_sets_match_jax(delta_runs):
    d3, j3 = delta_runs["port", 3][0], delta_runs["jax", 3][0]
    got, want = _plan_summary(d3.delta_plan), _plan_summary(j3.delta_plan)
    assert [len(x) for x in got[0]] == [len(x) for x in want[0]] and got[1:] == want[1:]
    assert d3.delta_plan.dirty_entities == j3.delta_plan.dirty_entities
    assert len(d3.delta_plan.dirty_entities["userId"]) == USERS_PER_FILE
    assert _deltas(d3.block_deltas["per-user"]) == _deltas(j3.block_deltas["per-user"])
    frozen = d3._frozen_blocks["per-user"]
    assert frozen == j3._frozen_blocks["per-user"]
    assert frozen == {d.index for d in d3.block_deltas["per-user"] if d.status == "unchanged"}
    # blocks follow the sorted raw ids ("u0", "u1", "u10", ...), so the
    # mutated file's users straddle two blocks and three stay frozen
    assert len(frozen) == 3


def test_frozen_entities_are_the_prior_bitwise_and_dirty_ones_moved(delta_runs):
    d3, out3 = delta_runs["port", 3]
    out1 = delta_runs["port", 1][1]
    imap = d3.shard_index_maps["per_user"]
    means1 = model_io.load_random_effect(os.path.join(out1, "best"), "per-user", imap)[0]
    means3 = model_io.load_random_effect(os.path.join(out3, "best"), "per-user", imap)[0]
    m3 = d3.streaming_manifests["per-user"]
    frozen_raws = set()
    for i in d3._frozen_blocks["per-user"]:
        frozen_raws.update(m3.vocab[v] for v in m3.load_block_meta(i, "cpu").entity_ids)
    assert len(frozen_raws) == 3 * USERS_PER_FILE
    for raw in frozen_raws:
        assert np.array_equal(means1[raw], means3[raw]), raw
    dirty = d3.delta_plan.dirty_entities["userId"]
    assert dirty.isdisjoint(frozen_raws)
    assert all(not np.array_equal(means1[r], means3[r]) for r in dirty)


def test_delta_run_is_held_against_the_jax_delta_run(delta_runs):
    """Run 3 of each package (the dirty users warm-started and re-solved,
    the fixed effect warm-started, the rest frozen): objectives, the fixed
    coefficients and every user's coefficients at ``solver``; the frozen
    users bitwise each package's own prior."""
    d3, out3 = delta_runs["port", 3]
    j3, jout3 = delta_runs["jax", 3]
    (_, tres, _), (_, jres, _) = d3.results[0], j3.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    imap, gmap = d3.shard_index_maps["per_user"], d3.shard_index_maps["global"]
    fe = [model_io.load_fixed_effect(os.path.join(o, "best"), "fixed", gmap)[0]
          for o in (out3, jout3)]
    assert_allclose(fe[0], fe[1], kind="solver")
    mine = model_io.load_random_effect(os.path.join(out3, "best"), "per-user", imap)[0]
    theirs = model_io.load_random_effect(os.path.join(jout3, "best"), "per-user", imap)[0]
    assert sorted(mine) == sorted(theirs) and len(mine) == NUM_USERS
    for raw in theirs:
        assert_allclose(mine[raw], theirs[raw], kind="solver", err_msg=raw)
    jprior = model_io.load_random_effect(os.path.join(delta_runs["jax", 1][1], "best"),
                                         "per-user", imap)[0]
    jm3 = j3.streaming_manifests["per-user"]
    frozen = {jm3.vocab[v] for i in j3._frozen_blocks["per-user"]
              for v in jm3.load_block_meta(i).entity_ids}
    assert len(frozen) == 3 * USERS_PER_FILE
    assert all(np.array_equal(theirs[raw], jprior[raw]) for raw in frozen)


def test_delta_run_invalidates_the_superseded_entry_and_chains(delta_runs):
    d1, d3 = delta_runs["port", 1][0], delta_runs["port", 3][0]
    cache = d3._tensor_cache()
    assert not cache.has(d1._data_cache_key) and cache.has(d3._data_cache_key)
    out3 = delta_runs["port", 3][1]
    m = RetrainManifest.load(out3)
    assert os.path.isdir(m.coordinates["per-user"].streaming_manifest_dir)
    assert retrain.load_prior_manifest(out3).model_dir.endswith("best")
    assert jretrain.load_prior_manifest(out3).model_dir.endswith("best")


def test_an_unchanged_coordinate_takes_the_prior_layout_verbatim(delta_runs):
    """Only the fixed lambda moves: the streaming coordinate is unchanged,
    opens the prior block layout as it is and keeps its coefficients."""
    out3 = delta_runs["port", 3][1]
    out4 = str(delta_runs["base"] / "port-run4")
    flags = _flags(delta_runs["train_dir"], out4, ["--warm-start-from", out3])
    flags[flags.index("fixed:20,1e-7,0.01,1,LBFGS,L2")] = "fixed:20,1e-7,0.5,1,LBFGS,L2"
    d4 = _port(flags)
    prior_rec = RetrainManifest.load(out3).coordinates["per-user"]
    assert d4.delta_plan.coordinates["per-user"].status == "unchanged"
    assert d4.delta_plan.coordinates["fixed"].status == "dirty"
    assert os.path.samefile(d4.streaming_manifests["per-user"].dir,
                            prior_rec.streaming_manifest_dir)
    imap = d4.shard_index_maps["per_user"]
    means3 = model_io.load_random_effect(os.path.join(out3, "best"), "per-user", imap)[0]
    means4 = model_io.load_random_effect(os.path.join(out4, "best"), "per-user", imap)[0]
    assert all(np.array_equal(row, means4[raw]) for raw, row in means3.items())
    gmap = d4.shard_index_maps["global"]
    f3 = model_io.load_fixed_effect(os.path.join(out3, "best"), "fixed", gmap)[0]
    f4 = model_io.load_fixed_effect(os.path.join(out4, "best"), "fixed", gmap)[0]
    assert not np.array_equal(f3, f4)


def test_in_memory_and_bucketed_warm_runs_and_the_warm_grid(tmp_path, rng):
    """Without streaming, both drivers warm-start from the same prior (the
    port's cold run): the dense and bucketed random effects' warm stacks and
    the fixed effect's vector are the JAX driver's bit for bit, and the warm
    solves, the saved models and a lambda grid seeded through
    run_grid(init_params=) are held against the JAX driver's at ``solver``."""
    gd, truth = make_glmix_data(rng, num_users=8, rows_per_user_range=(8, 12), d_fixed=4,
                                d_random=3)
    train_dir = str(tmp_path / "train")
    os.makedirs(train_dir)
    write_game_avro(os.path.join(train_dir, "part-0.avro"), gd, range(gd.num_rows), truth)
    base = _flags(train_dir, str(tmp_path / "run1"))
    cut = base.index("--re-memory-budget-mb")
    base = base[:cut] + base[cut + 2:]
    _port(base)
    prior = ["--warm-start-from", str(tmp_path / "run1")]

    def both(tag, flags):
        runs = []
        for pkg, main in (("port", _port), ("jax", jdriver.main)):
            argv = list(flags)
            argv[argv.index("--output-dir") + 1] = str(tmp_path / f"{pkg}-{tag}")
            runs.append((main(argv), str(tmp_path / f"{pkg}-{tag}")))
        return runs

    def models(out, d):
        best = os.path.join(out, "best")
        return (model_io.load_fixed_effect(best, "fixed", d.shard_index_maps["global"])[0],
                model_io.load_random_effect(best, "per-user", d.shard_index_maps["per_user"])[0])

    for extra, attr in ((["--bucketed-random-effects", "true"], "_warm_bucketed"),
                        ([], "_warm_dense_re")):
        flags = list(base)
        flags[flags.index("per-user:15,1e-6,0.1,1,LBFGS,L2")] = "per-user:15,1e-6,0.2,1,LBFGS,L2"
        (d, out), (jd, jout) = both(attr, flags + prior + extra)
        assert d.delta_plan.coordinates["per-user"].status == "dirty"
        assert _plan_summary(d.delta_plan)[1:] == _plan_summary(jd.delta_plan)[1:]
        assert np.array_equal(d._warm_fixed["fixed"], jd._warm_fixed["fixed"])
        mine, theirs = getattr(d, attr)["per-user"], getattr(jd, attr)["per-user"]
        mine, theirs = (mine, theirs) if isinstance(mine, list) else ([mine], [theirs])
        assert len(mine) == len(theirs) >= 1
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(mine, theirs))
        if attr == "_warm_bucketed":
            # the stacks exported back through the buckets' own layout are
            # the prior model's rows, bit for bit
            back = d.combo_coords[0]["per-user"].entity_export_by_raw_id(
                tuple(torch.from_numpy(w) for w in mine))[0]
            prior_rows = models(str(tmp_path / "run1"), d)[1]
            assert sorted(back) == sorted(prior_rows)
            assert all(np.array_equal(back[raw], row) for raw, row in prior_rows.items())
        assert_allclose(d.results[0][1].objective_history, jd.results[0][1].objective_history,
                        kind="solver", dtype=np.float32)
        (fe, re), (jfe, jre) = models(out, d), models(jout, d)
        assert_allclose(fe, jfe, kind="solver")
        assert sorted(re) == sorted(jre)
        for raw in jre:
            assert_allclose(re[raw], jre[raw], kind="solver", err_msg=raw)
    flags = list(base)
    flags[flags.index("per-user:15,1e-6,0.1,1,LBFGS,L2")] = (
        "per-user:15,1e-6,0.1,1,LBFGS,L2;per-user:15,1e-6,1.0,1,LBFGS,L2")
    (d, _), (jd, _) = both("grid", flags + prior + ["--vmapped-grid", "true"])
    assert len(d.results) == len(jd.results) == 2 and d._warm_init() is not None
    for (_, r, _), (_, jr, _) in zip(d.results, jd.results):
        assert_allclose(r.objective_history, jr.objective_history, kind="solver",
                        dtype=np.float32)
        for name, w in r.coefficients.items():
            assert_allclose(w.numpy(), np.asarray(jr.coefficients[name]), kind="solver",
                            err_msg=name)
