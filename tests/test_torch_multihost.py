"""The port's multihost drivers and bring-up against the JAX package (CPU).

The JAX package's multi-process tests are ``slow``; here the port's drivers
run at 2 ranks of a gloo group on the CPU (tests/torch_ranks.py) and are
held against the JAX single-process driver at that test's tolerance
(rtol 5e-3, atol 5e-4, tests/test_multihost.py), on its data (4 training
and 2 validation part files, an off-heap index):

  * ``cli.game_multihost_driver`` at 2 ranks: both ranks' metrics equal, 2
    random-effect part files, the model against the JAX driver's and
    against the port's single-process driver at ``solver``; two runs write
    the same bytes;
  * a checkpointed run extended by one iteration restores the agreed step
    and runs only the new updates;
  * ``cli.game_multihost_scoring_driver`` at 2 ranks against the port's
    scoring driver at ``elementwise``;
  * the single-process driver's ``--distributed`` at one rank writes the
    plain run's model bytes;
  * every path not yet ported raises naming itself (the per-host streaming
    paths are tests/test_torch_perhost_streaming.py's); the bring-up helpers
    (shares, slices, heartbeats, deadlines, backend choice) match the JAX
    package's.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import feature_indexing
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import schemas as jschemas
from photon_ml_tpu.parallel import multihost as jmultihost
from photon_ml_tpu_torch.cli import game_multihost_driver as mhdriver
from photon_ml_tpu_torch.cli import game_params as tparams
from photon_ml_tpu_torch.cli import game_scoring_driver as tscoring
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import model_io
from photon_ml_tpu_torch.io.offheap import load_shard_index_map
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.resilience import faults
from tolerances import assert_allclose
from torch_ranks import init_url, launch

SECTIONS = "global:fixedFeatures|per_user:userFeatures"
JAX_RTOL, JAX_ATOL = 5e-3, 5e-4  # tests/test_multihost.py:440-460


@pytest.fixture(scope="module")
def mh_data(tmp_path_factory):
    """tests/test_multihost.py's data: 18 users, 4 training and 2
    validation part files, and an off-heap index of the training files."""
    from game_test_utils import make_glmix_data

    base = tmp_path_factory.mktemp("mh")
    data, _ = make_glmix_data(np.random.default_rng(21), num_users=18,
                              rows_per_user_range=(8, 20), d_fixed=4, d_random=3)
    schema = {"name": "MhAvro", "type": "record", "namespace": "t", "fields": [
        {"name": "label", "type": "double"},
        {"name": "fixedFeatures", "type": {"type": "array", "items": jschemas.FEATURE}},
        {"name": "userFeatures", "type": {
            "type": "array", "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None}]}
    train, val = base / "train", base / "validate"
    train.mkdir()
    val.mkdir()
    ff, uf = data.shards["global"], data.shards["per_user"]
    vocab = data.id_vocabs["userId"]

    def feats(f, r):
        s, e = f.indptr[r], f.indptr[r + 1]
        return [{"name": f"c{j}", "term": "", "value": float(v)}
                for j, v in zip(f.indices[s:e], f.values[s:e])]

    def record(r):
        return {"label": float(data.response[r]), "fixedFeatures": feats(ff, r),
                "userFeatures": feats(uf, r),
                "metadataMap": {"userId": vocab[data.ids["userId"][r]]}}

    n = int(data.num_rows * 0.85)
    bounds = np.linspace(0, n, 5).astype(int)
    for i in range(4):
        javro.write_container(str(train / f"part-{i}.avro"),
                              (record(r) for r in range(bounds[i], bounds[i + 1])), schema)
    vb = np.linspace(n, data.num_rows, 3).astype(int)
    for i in range(2):
        javro.write_container(str(val / f"part-{i}.avro"),
                              (record(r) for r in range(vb[i], vb[i + 1])), schema)
    idx = str(base / "index")
    feature_indexing.main(["--data-input-dirs", str(train), "--output-dir", idx,
                           "--partition-num", "1",
                           "--feature-shard-id-to-feature-section-keys-map", SECTIONS])
    flags = ["--train-input-dirs", str(train), "--validate-input-dirs", str(val),
             "--evaluator-type", "AUC,PRECISION@5:userId",
             "--task-type", "LOGISTIC_REGRESSION", "--updating-sequence", "fixed,per-user",
             "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
             "--fixed-effect-optimization-configurations", "fixed:40,1e-9,0.1,1,LBFGS,L2",
             "--fixed-effect-data-configurations", "fixed:global,2",
             "--random-effect-optimization-configurations", "per-user:30,1e-9,0.5,1,LBFGS,L2",
             "--random-effect-data-configurations",
             "per-user:userId,per_user,2,-1,0,-1,index_map",
             "--num-iterations", "2", "--offheap-indexmap-dir", idx,
             "--delete-output-dir-if-exists", "true"]
    return base, flags, idx


def _ranks(module, base, argv, world=2, env=None):
    init = init_url(base)
    return launch([["-m", f"photon_ml_tpu_torch.cli.{module}", "--multihost-coordinator", init,
                    "--multihost-num-processes", str(world), "--multihost-process-id", str(r),
                    "--device", "cpu"] + argv for r in range(world)], env=env)


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _models(out_dir, idx):
    ig, iu = load_shard_index_map(idx, "global"), load_shard_index_map(idx, "per_user")
    fe = model_io.load_fixed_effect(os.path.join(out_dir, "best"), "fixed", ig)[0]
    re_means, _, re_id, _ = model_io.load_random_effect(os.path.join(out_dir, "best"),
                                                       "per-user", iu)
    return fe, re_means, re_id


@pytest.fixture(scope="module")
def runs(mh_data):
    """The JAX single-process run, the port's single-process run, and two
    2-rank runs of the multihost driver (the first checkpointed)."""
    base, flags, _ = mh_data
    jd = jdriver.main(["--output-dir", str(base / "jax-sp")] + flags)
    td = tdriver.main(["--output-dir", str(base / "port-sp"), "--device", "cpu"] + flags)
    ckpt = str(base / "mh-ckpt")
    _ranks("game_multihost_driver", base,
           ["--output-dir", str(base / "mh-a"), "--checkpoint-dir", ckpt] + flags)
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "mh-b")] + flags)
    summaries = []
    for r in range(2):
        with open(base / "mh-a" / f"photon-ml-tpu-mh-{r}.json") as f:
            summaries.append(json.load(f))
    return jd, td, summaries, ckpt


def test_two_rank_driver_matches_jax_and_the_single_process_port(mh_data, runs):
    base, _, idx = mh_data
    jd, td, summaries, _ = runs
    # both ranks hold one trajectory and compute the same metrics
    assert summaries[0]["validation_metrics"] == summaries[1]["validation_metrics"]
    assert summaries[0]["objective_history"] == summaries[1]["objective_history"]
    assert [s["num_processes"] for s in summaries] == [2, 2]
    assert {s["backend"] for s in summaries} == {"gloo"}
    parts = os.listdir(base / "mh-a" / "best" / "random-effect" / "per-user" / "coefficients")
    assert sorted(parts) == ["part-00000.avro", "part-00001.avro"]
    fe, re_means, re_id = _models(str(base / "mh-a"), idx)
    jfe, jre, _ = _models(str(base / "jax-sp"), idx)
    tfe, tre, _ = _models(str(base / "port-sp"), idx)
    assert re_id == "userId" and set(re_means) == set(jre) == set(tre)  # real raw ids
    np.testing.assert_allclose(fe, jfe, rtol=JAX_RTOL, atol=JAX_ATOL)
    assert_allclose(fe, tfe, kind="solver")
    for eid in jre:
        np.testing.assert_allclose(re_means[eid], jre[eid], rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=eid)
        assert_allclose(re_means[eid], tre[eid], kind="solver", err_msg=eid)
    jmetrics = jd.results[jd.best_index][2]
    for key in ("AUC", "PRECISION_AT_K@5"):
        assert summaries[0]["validation_metrics"][key] == pytest.approx(jmetrics[key], abs=2e-3)
    assert_allclose(summaries[0]["objective_history"], td.results[0][1].objective_history,
                    kind="solver", dtype=np.float32)
    with open(base / "mh-a" / "retrain.json") as f:
        assert json.load(f)["coordinates"]["per-user"]["kind"] == "random"


def test_two_two_rank_runs_write_equal_bytes(mh_data, runs):
    base, _, _ = mh_data
    a, b = _tree(str(base / "mh-a" / "best")), _tree(str(base / "mh-b" / "best"))
    assert a == b and len(a) == 5  # fixed: id-info + part; per-user: id-info + 2 parts


def test_checkpointed_run_extended_by_one_iteration_resumes_only_the_new_steps(mh_data, runs):
    base, flags, idx = mh_data
    _, _, summaries, ckpt = runs
    # the coordinator alone wrote; retention keeps the last 2 of 4 updates
    assert sorted(os.listdir(os.path.join(ckpt, "combo-0"))) == ["step-3", "step-4"]
    flags3 = list(flags)
    flags3[flags3.index("--num-iterations") + 1] = "3"
    _ranks("game_multihost_driver", base,
           ["--output-dir", str(base / "mh-a3"), "--checkpoint-dir", ckpt] + flags3)
    assert sorted(os.listdir(os.path.join(ckpt, "combo-0"))) == ["step-5", "step-6"]
    with open(base / "mh-a3" / "photon-ml-tpu-mh-1.json") as f:
        resumed = json.load(f)
    # the restored histories, then the 2 new updates
    assert resumed["objective_history"][:4] == summaries[1]["objective_history"]
    assert len(resumed["objective_history"]) == 6
    sp3 = tdriver.main(["--output-dir", str(base / "sp3"), "--device", "cpu"] + flags3)
    assert_allclose(resumed["objective_history"], sp3.results[0][1].objective_history,
                    kind="solver", dtype=np.float32)
    fe, _, _ = _models(str(base / "mh-a3"), idx)
    assert_allclose(fe, _models(str(base / "sp3"), idx)[0], kind="solver")


def test_multihost_scoring_matches_the_port_scoring_driver(mh_data, runs):
    base, flags, idx = mh_data
    score_flags = ["--input-dirs", flags[flags.index("--validate-input-dirs") + 1],
                   "--game-model-input-dir", str(base / "mh-a" / "best"),
                   "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
                   "--offheap-indexmap-dir", idx, "--evaluator-type", "AUC",
                   "--delete-output-dir-if-exists", "true"]
    _ranks("game_multihost_scoring_driver", base,
           ["--output-dir", str(base / "mh-score")] + score_flags)
    sp = tscoring.main(["--output-dir", str(base / "sp-score"), "--device", "cpu"] + score_flags)

    def read(d):
        recs = {}
        for f in sorted(os.listdir(d)):
            for rec in tavro.read_container(os.path.join(d, f)):
                recs[int(rec["uid"])] = rec["predictionScore"]
        return recs

    got, want = read(str(base / "mh-score" / "scores")), read(str(base / "sp-score" / "scores"))
    assert sorted(got) == sorted(want) == list(range(len(want)))
    assert sorted(os.listdir(base / "mh-score" / "scores")) == ["part-00000.avro",
                                                                "part-00001.avro"]
    assert_allclose(np.asarray([got[k] for k in sorted(got)], np.float32),
                    np.asarray([want[k] for k in sorted(want)], np.float32), kind="elementwise")
    assert sp.metrics["AUC"] > 0.5


@pytest.mark.parametrize("extra", [[], ["--bucketed-random-effects", "true"]],
                         ids=["plain", "bucketed"])
def test_one_rank_distributed_run_writes_the_plain_models_bytes(mh_data, extra, monkeypatch):
    base, flags, _ = mh_data
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "pallas")
    common = ["--device", "cpu"] + flags + extra
    plain = tdriver.main(["--output-dir", str(base / "plain")] + common)
    dist = tdriver.main(["--output-dir", str(base / "dist"), "--distributed", "true"] + common)
    assert _tree(str(base / "plain" / "best")) == _tree(str(base / "dist" / "best"))
    assert plain.results[0][1].objective_history == dist.results[0][1].objective_history
    assert "sharding=mesh" in dist.plan.describe()


def test_distributed_keeps_the_jax_refusals(mh_data, tmp_path):
    """--distributed blocks the vmapped grid (a per-combo fallback, as in
    JAX) and turns the delta retrain's warm starts off, logged."""
    _, flags, _ = mh_data
    grid = [f if f != "fixed:40,1e-9,0.1,1,LBFGS,L2" else
            "fixed:40,1e-9,0.1,1,LBFGS,L2;fixed:40,1e-9,1,1,LBFGS,L2" for f in flags]
    params = tparams.parse_training_params(
        ["--output-dir", str(tmp_path / "o"), "--device", "cpu", "--distributed", "true",
         "--vmapped-grid", "true"] + grid)
    driver = tdriver.GameTrainingDriver(params)
    assert driver._vmapped_grid_blocker(params.config_grid()).startswith("--distributed")
    driver.retrain_prior, driver.delta_plan = object(), object()
    driver._prepare_warm_starts()  # refuses before it reads either
    driver.logger.close()
    with open(tmp_path / "o" / "photon-ml-tpu-game.log") as f:
        assert "--distributed solvers manage their own sharded/padded state" in f.read()


FENCED = {
    # the multihost driver compacts only the per-host streaming blocks
    "solve-compaction": (["--solve-compaction", "4"], "--solve-compaction"),
    # --streaming-random-effects and --warm-start-from run now
    # (tests/test_torch_perhost_streaming.py (e) and (g)): they parse and
    # pass the scope checks
    "streaming": (["--streaming-random-effects", "true"], None),
    "warm-start-from": (["--warm-start-from", "prior"], None),
}


@pytest.mark.parametrize("name", sorted(FENCED))
def test_every_fenced_remainder_raises_naming_itself(mh_data, name):
    _, flags, _ = mh_data
    extra, named = FENCED[name]
    if named is None:
        mhdriver._check_multihost_support(
            tparams.parse_training_params(["--output-dir", "unused"] + flags + extra))
    else:
        with pytest.raises((NotImplementedError, ValueError), match=named):
            mhdriver.main(["--output-dir", "unused", "--device", "cpu"] + flags + extra)
    # relaunch adoption and its chunk share run now
    # (tests/test_torch_survivable_loop.py): with no prior layout the vote
    # falls back to the full ingest and the share is the positional one
    import types

    class _Log:
        def __init__(self):
            self.warns = []

        def info(self, msg):
            pass

        def warn(self, msg):
            self.warns.append(msg)

    one = types.SimpleNamespace(process_id=0, num_processes=1)
    log = _Log()
    ns = types.SimpleNamespace(updating_sequence=["per-user"], factored_configs={},
                               random_effect_data_configs={"per-user": None},
                               output_dir=os.path.join("unused", name))
    assert mhdriver._attempt_relaunch_adoption(ns, one, None, log) == {}
    assert any("relaunch re-plan unavailable" in m for m in log.warns)
    assert mhdriver._fe_chunk_share(["a"], {}, one, log) == [("a", 0)]
    # --streaming-random-effects --distributed resolves the per-host
    # streaming plan (tests/test_torch_perhost_streaming.py (j))
    p = tparams.parse_training_params(["--output-dir", "o", "--distributed", "true",
                                       "--streaming-random-effects", "true"] + flags)
    assert p.distributed and p.streaming_random_effects
    for scope in (["--compute-variance", "true"], ["--vmapped-grid", "true"]):
        with pytest.raises(ValueError, match="multihost driver does not implement"):
            mhdriver.main(["--output-dir", "unused", "--device", "cpu"] + flags + scope)


def test_the_multihost_flags_are_stripped_as_jax_strips_them():
    from photon_ml_tpu.cli.game_multihost_driver import _add_multihost_flags as j_strip

    argv = ["--a", "1", "--multihost-coordinator", "h:1", "--multihost-num-processes", "2",
            "--multihost-process-id", "1", "--grid-warm-start", "true", "--b"]
    got, rest = mhdriver._add_multihost_flags(argv)
    want, jrest = j_strip(argv)
    assert rest == jrest == ["--a", "1", "--b"]
    assert got == want
    with pytest.raises(ValueError, match="requires a value"):
        mhdriver._add_multihost_flags(["--multihost-process-id"])


def _places(*hosts):
    """(host, cards, device type) per rank."""
    return [multihost.RankPlace(*h) for h in hosts]


@pytest.mark.parametrize("topology,backend,local", [
    (_places(("a", 0, "cpu"), ("a", 0, "cpu")), "gloo", [0, 1]),
    (_places(("a", 1, "cuda")), "nccl", [0]),
    # two ranks on the one card of one host: NCCL refuses a duplicate GPU
    (_places(("a", 1, "cuda"), ("a", 1, "cuda")), "gloo", [0, 1]),
    # two hosts of two cards, two ranks each: every rank has a card of its
    # own, though the world (4) is larger than either host's card count
    (_places(("a", 2, "cuda"), ("a", 2, "cuda"), ("b", 2, "cuda"), ("b", 2, "cuda")), "nccl",
     [0, 1, 0, 1]),
    # one host over-subscribed makes the whole job gloo
    (_places(("a", 2, "cuda"), ("b", 1, "cuda"), ("a", 2, "cuda"), ("b", 1, "cuda")), "gloo",
     [0, 0, 1, 1]),
    (_places(("a", 1, "cuda"), ("b", 0, "cpu")), "gloo", [0, 0]),
], ids=["cpu", "one-card", "two-ranks-one-card", "two-hosts", "oversubscribed-host",
        "a-cpu-rank"])
def test_the_backend_and_cards_follow_the_whole_jobs_topology(topology, backend, local):
    assert multihost.choose_backend(topology) == backend
    assert [multihost.local_rank(topology, r) for r in range(len(topology))] == local


def test_every_rank_reads_every_ranks_place_from_the_rendezvous_store():
    import threading

    import torch.distributed as dist

    store = dist.HashStore()
    places = _places(("a", 2, "cuda"), ("b", 2, "cuda"), ("a", 2, "cuda"))
    seen = [None] * len(places)

    def rank(r):
        seen[r] = multihost.exchange_topology(store, r, len(places), places[r])

    threads = [threading.Thread(target=rank, args=(r,)) for r in reversed(range(len(places)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert seen == [places] * len(places)


def test_host_rows_from_avro_match_jax(mh_data):
    from photon_ml_tpu.io.offheap import load_shard_index_map as jload
    from photon_ml_tpu.parallel import perhost_ingest as jpi
    from photon_ml_tpu_torch.parallel import perhost_ingest as tpi

    base, _, idx = mh_data
    files = sorted(str(p) for p in (base / "train").iterdir())
    mine = [(f, i) for i, f in enumerate(files) if i % 2 == 1]
    kw = dict(random_effect_id="userId", shard_id="per_user", shard_sections=["userFeatures"],
              row_stride=1 << 12)
    got = tpi.host_rows_from_avro([f for f, _ in mine], [i for _, i in mine],
                                  load_shard_index_map(idx, "per_user"), **kw)
    want = jpi.host_rows_from_avro([f for f, _ in mine], [i for _, i in mine],
                                   jload(idx, "per_user"), **kw)
    assert list(got.entity_raw_ids) == list(want.entity_raw_ids)
    for f in ("row_index", "labels", "weights", "offsets", "feat_idx", "feat_val"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="ordinals"):
        tpi.host_rows_from_avro(files, [0], load_shard_index_map(idx, "per_user"), **kw)


def test_bring_up_helpers_match_jax(tmp_path, monkeypatch):
    mh = multihost.MultihostContext(process_id=1, num_processes=3)
    jmh = jmultihost.MultihostContext(process_id=1, num_processes=3)
    paths = ["c", "a", "e", "b", "d"]
    assert mh.host_shard_paths(paths) == jmh.host_shard_paths(paths)
    for n in (0, 7, 100):
        assert mh.rows_per_host(n) == jmh.rows_per_host(n)
        assert mh.host_row_slice(n) == jmh.host_row_slice(n)
    ages = {0: 1.0, 2: 50.0}
    for grace in (None, 5.0, 100.0):
        assert multihost.lost_hosts(ages, [0, 1, 2], 10.0, grace) == \
            jmultihost.lost_hosts(ages, [0, 1, 2], 10.0, grace)
    monkeypatch.setenv(multihost.BARRIER_TIMEOUT_ENV, "2.5")
    assert multihost.resolve_barrier_timeout(None) == jmultihost.resolve_barrier_timeout(None)
    assert multihost.resolve_barrier_timeout(0) is None
    with pytest.raises(multihost.BarrierTimeoutError, match="did not complete within"):
        multihost._call_with_deadline(lambda: __import__("time").sleep(5), 0.2, "barrier x")
    hb = str(tmp_path / "hb")
    mh.write_heartbeat(hb, step=3)
    assert set(mh.heartbeat_ages(hb)) == {1}
    line = mh.describe_heartbeats(hb)
    assert "host 0: NO HEARTBEAT" in line and "host 1: " in line
    assert mh.lost_hosts(hb, 10.0) == []
    # a barrier's entry fault is retried under the I/O policy (a world of one
    # still runs the site)
    single = multihost.MultihostContext(process_id=0, num_processes=1)
    with faults.fault_scope(faults.parse_fault_env("multihost.barrier:at=1")):
        single.barrier("entry")
    assert single.agree_restore_step(4) == 4
    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize(device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="needs --multihost-coordinator"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")


def test_the_multihost_objective_counts_the_offsets(tmp_path):
    """Queue 3: the JAX multihost driver's training loss leaves the rows'
    offsets out (``loss(scores, labels)``, photon_ml_tpu/cli/
    game_multihost_driver.py), so with offsets its objective history is not
    the single-process driver's. The port's multihost driver counts them
    as both single-process drivers do: its history is theirs."""
    from game_test_utils import make_glmix_data
    from photon_ml_tpu.cli import game_multihost_driver as jmh
    from test_game_drivers import GAME_EXAMPLE_SCHEMA

    data, _ = make_glmix_data(np.random.default_rng(5), num_users=10,
                              rows_per_user_range=(8, 14), d_fixed=3, d_random=2)
    off = np.random.default_rng(1).normal(scale=0.7, size=data.num_rows)
    ff, uf, vocab = data.shards["global"], data.shards["per_user"], data.id_vocabs["userId"]

    def feats(f, r, p):
        s, e = f.indptr[r], f.indptr[r + 1]
        return [{"name": f"{p}{j}", "term": "", "value": float(v)}
                for j, v in zip(f.indices[s:e], f.values[s:e])]

    def record(r):
        return {"uid": str(r), "label": float(data.response[r]),
                "fixedFeatures": feats(ff, r, "f"), "userFeatures": feats(uf, r, "u"),
                "metadataMap": {"userId": vocab[data.ids["userId"][r]]}, "weight": None,
                "offset": float(off[r])}

    (tmp_path / "train").mkdir()
    n = data.num_rows
    for i, (a, b) in enumerate(((0, n // 2), (n // 2, n))):
        javro.write_container(str(tmp_path / "train" / f"part-{i}.avro"),
                              (record(r) for r in range(a, b)), GAME_EXAMPLE_SCHEMA)
    idx = str(tmp_path / "idx")
    feature_indexing.main(["--data-input-dirs", str(tmp_path / "train"), "--output-dir", idx,
                           "--partition-num", "1",
                           "--feature-shard-id-to-feature-section-keys-map", SECTIONS])
    flags = ["--train-input-dirs", str(tmp_path / "train"), "--task-type",
             "LOGISTIC_REGRESSION", "--updating-sequence", "fixed,per-user",
             "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
             "--fixed-effect-optimization-configurations", "fixed:40,1e-9,0.1,1,LBFGS,L2",
             "--fixed-effect-data-configurations", "fixed:global,1",
             "--random-effect-optimization-configurations", "per-user:30,1e-9,0.5,1,LBFGS,L2",
             "--random-effect-data-configurations",
             "per-user:userId,per_user,1,-1,0,-1,index_map", "--num-iterations", "1",
             "--offheap-indexmap-dir", idx, "--delete-output-dir-if-exists", "true"]
    out = lambda name: ["--output-dir", str(tmp_path / name)]
    j_single = jdriver.main(out("j1") + flags).results[0][1].objective_history
    j_multi = jmh.main(out("j2") + flags)["objective_history"]
    t_single = tdriver.main(out("t1") + ["--device", "cpu"] + flags).results[0][1]
    t_multi = mhdriver.main(out("t2") + ["--device", "cpu"] + flags)["objective_history"]
    assert_allclose(t_single.objective_history, j_single, kind="solver", dtype=np.float32)
    assert_allclose(t_multi, t_single.objective_history, kind="solver", dtype=np.float32)
    # the JAX multihost history misses the offsets' share of the loss
    assert abs(j_multi[0] - j_single[0]) > 0.05 * abs(j_single[0])


def test_an_async_checkpointed_run_resumes_at_one_rank(mh_data, tmp_path):
    """--checkpoint-async under the multihost driver (the coordinator
    commits in the background, the fence is a barrier): a 1-rank run in this
    process, then the same run extended by one iteration resumes."""
    base, flags, _ = mh_data
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--checkpoint-dir", ckpt, "--checkpoint-async", "true"] + flags
    first = mhdriver.main(["--output-dir", str(tmp_path / "o2")] + argv)
    assert sorted(os.listdir(os.path.join(ckpt, "combo-0"))) == ["step-3", "step-4"]
    argv[argv.index("--num-iterations") + 1] = "3"
    again = mhdriver.main(["--output-dir", str(tmp_path / "o3")] + argv)
    assert sorted(os.listdir(os.path.join(ckpt, "combo-0"))) == ["step-5", "step-6"]
    assert again["objective_history"][:4] == first["objective_history"]


def _variant(flags, name):
    out = list(flags)
    i = out.index("per-user:userId,per_user,2,-1,0,-1,index_map")
    if name == "bucketed":
        return out + ["--bucketed-random-effects", "true"]
    if name == "random":
        out[i] = "per-user:userId,per_user,2,-1,0,-1,RANDOM=2"
        return out
    out[i] = "per-user:userId,per_user,2,-1,0,-1,IDENTITY"
    j = out.index("--random-effect-optimization-configurations")
    del out[j:j + 2]
    return out + ["--factored-random-effect-optimization-configurations",
                  "per-user:20,1e-6,0.5,1,LBFGS,L2:20,1e-6,1,1,LBFGS,L2:1,2"]


@pytest.mark.parametrize("name", ["bucketed", "random", "factored"])
def test_multihost_random_effect_variants_match_the_single_process_port(mh_data, tmp_path,
                                                                         name):
    """Size buckets, the RANDOM projector and a factored coordinate through
    the multihost driver (one rank, in this process) against the port's
    single-process driver on the same flags, at ``solver``."""
    _, flags, _ = mh_data
    argv = ["--device", "cpu"] + _variant(flags, name)
    single = tdriver.main(["--output-dir", str(tmp_path / "sp")] + argv)
    multi = mhdriver.main(["--output-dir", str(tmp_path / "mh")] + argv)
    want = single.results[single.best_index]
    assert_allclose(multi["objective_history"], want[1].objective_history, kind="solver",
                    dtype=np.float32)
    for key, value in want[2].items():
        assert multi["validation_metrics"][key] == pytest.approx(value, abs=2e-3)
    base = tmp_path / "mh" / "best" / "random-effect" / "per-user"
    assert os.listdir(base / "coefficients") == ["part-00000.avro"]
    if name != "factored":
        return
    # the latent structure, written per host; scored latent-natively by the
    # multihost scoring driver as the scoring driver scores it
    assert os.listdir(base / "latent-factors") == ["part-00000.avro"]
    assert (base / "id-info").read_text().splitlines()[2] == "factored"
    from photon_ml_tpu_torch.cli import game_multihost_scoring_driver as mhscoring

    score_flags = ["--input-dirs", flags[flags.index("--validate-input-dirs") + 1],
                   "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
                   "--offheap-indexmap-dir", flags[flags.index("--offheap-indexmap-dir") + 1],
                   "--device", "cpu", "--delete-output-dir-if-exists", "true"]
    got = mhscoring.main(["--output-dir", str(tmp_path / "mhs"), "--game-model-input-dir",
                          str(tmp_path / "mh" / "best")] + score_flags)["scores"]
    want = tscoring.main(["--output-dir", str(tmp_path / "sps"), "--game-model-input-dir",
                          str(tmp_path / "mh" / "best")] + score_flags).scores
    assert_allclose(got, want, kind="elementwise")
