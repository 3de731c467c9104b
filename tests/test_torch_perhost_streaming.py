"""The port's per-host streaming GAME training against the JAX package
(CPU, 2 gloo ranks through tests/torch_ranks.py):

  (a) ``EntityShardPlan`` (blocks, owners, costs, FE chunk ownership,
      ``replan`` / ``moved_blocks``), the plan sidecars' bytes and a 1-rank
      per-host manifest equal the JAX package's; the plan's blocking is the
      single-host ``plan_entity_blocks`` in block-count and budget mode;
  (b) the 2-rank streaming descent (agree, plan, route, owned blocks, both
      coordinates) is bitwise the port's single-host streaming descent,
      flags off and with compaction, adaptive ordering and the sparse race
      on; the JAX single-process per-host descent holds it at ``solver``;
  (c) a merged ``-0.0`` stays ``-0.0`` at 1 and 2 ranks;
  (d) the fault sites fire and are retried (or raise) as JAX pins them;
  (e) the 2-rank multihost driver with ``--streaming-random-effects
      --solve-compaction 4``: a manifest per rank, two part files, equal
      metrics, bitwise a 1-rank run, against the single-process streaming
      driver at the JAX test's bound;
  (f) that model through the 2-rank multihost scoring driver;
  (g) ``--warm-start-from`` at 2 ranks: unchanged inputs freeze every
      owned block bitwise; a new part file pins the prior blocking by the
      single-process rule (one rule, held by its own test, an over-cap
      entity that lost rows included) and holds against the
      single-process streaming delta run; a fault on one rank makes both
      train cold;
  (h) a rank lost after its first block spill fails the survivor, named;
  (i) a 2-rank run stopped at a block boundary resumes to the same bytes;
  (j) ``--streaming-random-effects --distributed`` at one rank writes the
      plain streaming run's model bytes.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.streaming_fixed_effect import (
    PerHostStreamingFixedEffectCoordinate as JPerHostFE,
)
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.parallel import perhost_streaming as jps
from photon_ml_tpu.parallel.elastic import FleetMembership
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    plan_entity_blocks,
    write_re_entity_blocks,
)
from photon_ml_tpu_torch.compile.plan import ExecutionPlan
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.parallel import perhost_streaming as tps
from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows, csr_to_padded
from photon_ml_tpu_torch.resilience import faults
from test_perhost_streaming import _host_rows as _jax_host_rows
from test_perhost_streaming import _sorted_vocab_data
from test_torch_game import _port_data
from tolerances import assert_allclose
from torch_ranks import run_ranks
from torch_rank_jobs import streaming_coordinates, streaming_descent

TCFG = tgame.RandomEffectDataConfig("userId", "per_user")
JCFG = JReConfig("userId", "per_user")
OFF = dict(solve_compaction="off", sparse_kernel="off", shape_canonicalization="off",
           adaptive_schedule="off")
# tests/test_perhost_streaming.py's worker: 60 users, chunks of 128 rows,
# blocks of 16 entities, LBFGS 6 iterations at 1e-8
PAYLOAD = {"chunk_rows": 128, "block_entities": 16,
           "fe": {"optimizer": "LBFGS", "iters": 6, "tol": 1e-8, "lambda": 0.5},
           "re": {"optimizer": "LBFGS", "iters": 6, "tol": 1e-8, "lambda": 0.2}}


@pytest.fixture(scope="module")
def glmix():
    jdata = _sorted_vocab_data(np.random.default_rng(97), num_users=60,
                               rows_per_user_range=(4, 16), d_fixed=5, d_random=4)
    return jdata, _port_data(jdata)


def _counts(data):
    ids = data.ids["userId"]
    return np.bincount(ids, minlength=int(ids.max()) + 1)


def _port_rows(tdata):
    fi, fv = csr_to_padded(tdata.shards["per_user"], tdata.num_rows)
    vocab = tdata.id_vocabs["userId"]
    return HostRows(entity_raw_ids=[vocab[i] for i in tdata.ids["userId"]],
                    row_index=np.arange(tdata.num_rows, dtype=np.int64),
                    labels=tdata.response.astype(np.float32),
                    weights=tdata.weight.astype(np.float32),
                    offsets=tdata.offset.astype(np.float32), feat_idx=fi, feat_val=fv,
                    global_dim=tdata.shards["per_user"].dim)


def _file_bytes(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


SECTIONS = "global:fixedFeatures|per_user:userFeatures"


def _write_mh_data(base, num_users=96, seed=21):
    """tests/test_torch_multihost.py's layout (4 training and 2 validation
    part files, an off-heap index of the training files) at ``num_users``
    users, enough for several entity blocks a rank. Returns (base, the
    GAME flags, the index dir)."""
    from game_test_utils import make_glmix_data
    from photon_ml_tpu.cli import feature_indexing
    from photon_ml_tpu.io import avro as javro
    from photon_ml_tpu.io import schemas as jschemas

    data, _ = make_glmix_data(np.random.default_rng(seed), num_users=num_users,
                              rows_per_user_range=(8, 20), d_fixed=4, d_random=3)
    schema = {"name": "MhAvro", "type": "record", "namespace": "t", "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "fixedFeatures", "type": {"type": "array", "items": jschemas.FEATURE}},
        {"name": "userFeatures", "type": {
            "type": "array", "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None}]}
    ff, uf = data.shards["global"], data.shards["per_user"]
    vocab = data.id_vocabs["userId"]

    def feats(f, r):
        s, e = f.indptr[r], f.indptr[r + 1]
        return [{"name": f"c{j}", "term": "", "value": float(v)}
                for j, v in zip(f.indices[s:e], f.values[s:e])]

    def record(r, user=None):
        return {"uid": str(r), "label": float(data.response[r]), "fixedFeatures": feats(ff, r),
                "userFeatures": feats(uf, r),
                "metadataMap": {"userId": user or vocab[data.ids["userId"][r]]}}

    n = int(data.num_rows * 0.85)
    splits = {"train": np.linspace(0, n, 5).astype(int),
              "validate": np.linspace(n, data.num_rows, 3).astype(int)}
    for d, bounds in splits.items():
        (base / d).mkdir()
        for i in range(len(bounds) - 1):
            javro.write_container(str(base / d / f"part-{i}.avro"),
                                  (record(r) for r in range(bounds[i], bounds[i + 1])), schema)
    # a delta part file for the retrain: 2 more rows for each of two users,
    # and 6 rows of a new user
    (base / "delta").mkdir()
    again = [r for u in (vocab[0], vocab[1])
             for r in np.nonzero(data.ids["userId"][:n] == vocab.index(u))[0][:2]]
    javro.write_container(str(base / "delta" / "part-0.avro"),
                          [record(int(r)) for r in again]
                          + [record(r, "newuser") for r in range(6)], schema)
    idx = str(base / "index")
    feature_indexing.main(["--data-input-dirs", str(base / "train"), "--output-dir", idx,
                           "--partition-num", "1",
                           "--feature-shard-id-to-feature-section-keys-map", SECTIONS])
    flags = ["--train-input-dirs", str(base / "train"), "--validate-input-dirs",
             str(base / "validate"), "--evaluator-type", "AUC,PRECISION@5:userId",
             "--task-type", "LOGISTIC_REGRESSION", "--updating-sequence", "fixed,per-user",
             "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
             "--fixed-effect-optimization-configurations", "fixed:40,1e-9,0.1,1,LBFGS,L2",
             "--fixed-effect-data-configurations", "fixed:global,2",
             "--random-effect-optimization-configurations", "per-user:30,1e-9,0.5,1,LBFGS,L2",
             "--random-effect-data-configurations",
             "per-user:userId,per_user,1,-1,0,-1,index_map",
             "--num-iterations", "2", "--offheap-indexmap-dir", idx,
             "--delete-output-dir-if-exists", "true"]
    return base, flags, idx


# ---------------------------------------------------------------------------
# (a) the plan, its sidecars and the 1-rank manifest against JAX
# ---------------------------------------------------------------------------


PLAN_CASES = {"16-a-block": dict(block_entities=16), "7-a-block": dict(block_entities=7),
              "budget": dict(memory_budget_bytes=8000),
              "budget-capped": dict(memory_budget_bytes=20000, active_upper_bound=5)}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("procs", [1, 2, 3])
def test_the_plan_is_the_jax_plan_and_the_single_host_blocking(glmix, case, procs):
    jdata, _ = glmix
    counts, dim = _counts(jdata), jdata.shards["per_user"].dim
    kw = PLAN_CASES[case]
    got = tps.EntityShardPlan.build(counts, procs, global_dim=dim, **kw)
    want = jps.EntityShardPlan.build(counts, procs, global_dim=dim, **kw)
    single = plan_entity_blocks(counts, global_dim=dim, **kw)
    assert len(got.blocks) == len(want.blocks) == len(single)
    for a, b, c in zip(got.blocks, want.blocks, single):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    for f in ("owners", "block_of_vocab", "block_costs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.num_entities, got.num_processes, got.hosts, got.version) == \
        (want.num_entities, want.num_processes, want.hosts, want.version)
    for pid in range(procs):
        assert got.owned_block_ids(pid) == want.owned_block_ids(pid)
    assert sorted(g for pid in range(procs) for g in got.owned_block_ids(pid)) == \
        list(range(len(single)))


def test_fe_chunks_replan_and_moved_blocks_match_jax(glmix):
    jdata, _ = glmix
    counts, dim = _counts(jdata), jdata.shards["per_user"].dim
    got = tps.EntityShardPlan.build(counts, 2, global_dim=dim, block_entities=7)
    want = jps.EntityShardPlan.build(counts, 2, global_dim=dim, block_entities=7)
    chunk_costs = [300, 120, 450, 90, 260]
    for owners in (None, [0, 1, 0, 1, 1]):
        g, w = got.with_fe_chunks(chunk_costs, owners), want.with_fe_chunks(chunk_costs, owners)
        assert np.array_equal(g.fe_chunk_owners, w.fe_chunk_owners)
        assert np.array_equal(g.fe_chunk_costs, w.fe_chunk_costs)
        for pid in (0, 1):
            assert g.owned_fe_chunks(pid) == w.owned_fe_chunks(pid)
    with pytest.raises(ValueError, match="disagree on the chunk count"):
        got.with_fe_chunks(chunk_costs, [0, 1])
    with pytest.raises(ValueError, match="no FE chunk ownership"):
        got.owned_fe_chunks(0)
    got, want = got.with_fe_chunks(chunk_costs), want.with_fe_chunks(chunk_costs)
    observed = {0: 17.2, 3: 1e4, 99: 5.0}
    for hosts, obs in (([0, 2, 5], None), ([1, 3], observed)):
        g, w = got.replan(hosts, observed_costs=obs), want.replan(hosts, observed_costs=obs)
        for f in ("owners", "block_costs", "fe_chunk_owners"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert (g.version, g.hosts) == (w.version, w.hosts)
        old = FleetMembership.initial(2)
        new = FleetMembership(version=2, hosts=hosts, binding={h: i % 2 for i, h in
                                                               enumerate(hosts)})
        assert got.moved_blocks(g, old, new) == want.moved_blocks(w, old, new)
        assert g.owned_block_ids(1, new) == w.owned_block_ids(1, new)
        assert g.owned_fe_chunks(0, new) == w.owned_fe_chunks(0, new)


def test_plan_sidecars_are_the_jax_bytes(glmix, tmp_path):
    jdata, _ = glmix
    plan = tps.EntityShardPlan.build(_counts(jdata), 2, global_dim=4, block_entities=16)
    kw = dict(version=3, hosts=[0, 4], binding={0: 0, 4: 1}, block_costs=plan.block_costs,
              num_entities=plan.num_entities, num_processes=2)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tps.write_plan_sidecars(str(tmp_path / "t"), plan.owners, plan.block_of_vocab, **kw)
    jps.write_plan_sidecars(str(tmp_path / "j"), plan.owners, plan.block_of_vocab, **kw)
    assert _file_bytes(tmp_path / "t") == _file_bytes(tmp_path / "j")
    tps.attach_fe_chunks_to_sidecars(str(tmp_path / "t"), [1, 0, 1], [10, 20, 30])
    jps.attach_fe_chunks_to_sidecars(str(tmp_path / "j"), [1, 0, 1], [10, 20, 30])
    assert _file_bytes(tmp_path / "t") == _file_bytes(tmp_path / "j")
    back = tps.EntityShardPlan.from_sidecars(str(tmp_path / "t"))
    jback = jps.EntityShardPlan.from_sidecars(str(tmp_path / "j"))
    assert [b.tolist() for b in back.blocks] == [b.tolist() for b in jback.blocks] == \
        [b.tolist() for b in plan.blocks]
    assert back.fe_chunk_owners.tolist() == [1, 0, 1] and back.version == 3
    # a torn commit (an owners array of another plan) is refused
    np.save(str(tmp_path / "t" / "plan-owners.npy"), plan.owners[::-1].copy())
    with pytest.raises(ValueError, match="torn"):
        tps.load_plan_sidecars(str(tmp_path / "t"))


def _pin_both(tdata, tmp_path, counts_new, dirty, **kw):
    """The per-host pinning and the single-process delta build's pinning
    of the same prior blocking (a 1-rank plan and the single-host block
    files of ``tdata``), on the new per-entity row counts ``counts_new``."""
    from photon_ml_tpu_torch.retrain.delta import _pinned_blocking

    counts, dim = _counts(tdata), tdata.shards["per_user"].dim
    vocab = tdata.id_vocabs["userId"]
    plan = tps.EntityShardPlan.build(counts, 2, global_dim=dim, **kw)
    import dataclasses

    cfg = dataclasses.replace(TCFG, active_upper_bound=kw.get("active_upper_bound"))
    prior = write_re_entity_blocks(tdata, cfg, str(tmp_path / "prior"),
                                   **{k: v for k, v in kw.items() if k != "active_upper_bound"})
    blocks, statuses = tps.pin_prior_blocking(plan, vocab, counts, vocab, counts_new, dirty,
                                              global_dim=dim, **kw)
    single, _, _ = _pinned_blocking(prior, vocab, counts_new, dirty)
    return plan, blocks, statuses, single


@pytest.mark.parametrize("case", ["same", "one-dirty", "rows-lost-over-cap"])
def test_the_per_host_pinning_is_the_single_process_rule(glmix, tmp_path, case):
    """One pinning rule (``retrain.delta.pin_prior_blocks``) for both delta
    builds. An entity above the active-set cap that loses rows in a changed
    file keeps its capped block cost, and it is in no new content, so only
    the uncapped row count shows its block changed: that block re-solves."""
    _, tdata = glmix
    kw = dict(memory_budget_bytes=20000, active_upper_bound=5)
    counts = _counts(tdata)
    vocab = tdata.id_vocabs["userId"]
    new, dirty = counts.copy(), set()
    e = int(np.argmax(counts))
    if case == "one-dirty":
        dirty = {vocab[e]}
    if case == "rows-lost-over-cap":
        new[e] -= 1
        assert new[e] > kw["active_upper_bound"]
    plan, blocks, statuses, single = _pin_both(tdata, tmp_path, new, dirty, **kw)
    ge = int(plan.block_of_vocab[e])
    if case == "rows-lost-over-cap":  # the capped cost cannot see the lost row
        assert int(np.minimum(new[plan.blocks[ge]], 5).sum()) == int(plan.block_costs[ge])
    assert len(blocks) == len(plan.blocks) == len(single)
    for g, (b, st, (ent, st1, prior_i, _)) in enumerate(zip(blocks, statuses, single)):
        assert np.array_equal(b, plan.blocks[g]) and np.array_equal(b, ent)
        assert prior_i == g and st == st1
        assert st == ("unchanged" if case == "same" or g != ge else "dirty"), (g, st)


def _pinned_case_data(counts, dim=64, feats_per_user=2, seed=0):
    """Users ``u000``... with ``counts`` rows each, every user's rows on two
    features of a 64-wide shard: a block's padded stack is far below the
    fresh blocking's estimate. Each user's first rows are the same at any
    count (one generator a user)."""
    ids, indptr, idx, val, y = [], [0], [], [], []
    for u, c in enumerate(counts):
        rng = np.random.default_rng([seed, u])
        fs = np.sort(rng.choice(dim, feats_per_user, replace=False))
        for _ in range(c):
            ids.append(u)
            idx.extend(fs)
            val.extend(rng.normal(size=feats_per_user))
            y.append(float(rng.random() > 0.5))
            indptr.append(len(idx))
    n = len(ids)
    return tgame.GameData(
        response=np.asarray(y, np.float32), offset=np.zeros(n, np.float32),
        weight=np.ones(n, np.float32), ids={"userId": np.asarray(ids, np.int32)},
        id_vocabs={"userId": [f"u{u:03d}" for u in range(len(counts))]},
        shards={"per_user": tgame.HostFeatures(np.asarray(indptr, np.int64),
                                               np.asarray(idx, np.int32),
                                               np.asarray(val, np.float32), dim)})


@pytest.mark.parametrize("grown", [12, 200], ids=["slab-fits", "slab-outgrows"])
def test_a_dirty_pinned_block_grown_past_the_estimate_reblocks_as_the_single_process_build(
        tmp_path, grown):
    """A delta that grows a pinned block's dirty entity: at 12 rows the
    fresh blocking's estimate would split the block but its built slab fits
    the budget, so both builds keep it whole; at 200 rows the slab outgrows
    the budget and both re-block it in its place, the per-host build at 1
    and 2 ranks alike (its owner re-blocks, the ranks renumber)."""
    from photon_ml_tpu_torch.retrain.delta import build_delta_streaming_manifest

    budget, prior_counts = 3000, [3, 4, 5, 5, 6, 6, 7, 8]
    new_counts = [grown] + prior_counts[1:]
    prior = _pinned_case_data(prior_counts)
    new = _pinned_case_data(new_counts)
    prior_man = write_re_entity_blocks(prior, TCFG, str(tmp_path / "prior"),
                                       memory_budget_bytes=budget)
    assert [b["num_entities"] for b in prior_man.blocks][0] == 2  # u000 pinned with u001
    sub = np.zeros(8, np.int64)
    sub[[0, 1]] = np.asarray(new_counts)[[0, 1]]
    assert len(plan_entity_blocks(sub, global_dim=64, memory_budget_bytes=budget)) == 2
    single, deltas = build_delta_streaming_manifest(new, TCFG, str(tmp_path / "single"),
                                                    prior_man, {"u000"},
                                                    memory_budget_bytes=budget)
    want_blocks = [sorted(single.load_block_meta(i, "cpu").entity_ids.tolist())
                   for i in range(len(single.blocks))]
    want_status = [d.status for d in deltas]
    assert want_blocks[:2] == ([[0, 1], [2, 3]] if grown == 12 else [[1], [0]])
    payload = {"data": new, "prior_counts": np.asarray(prior_counts), "budget": budget,
               "dirty": {"u000"}, "outdir": str(tmp_path)}
    for world in (1, 2):
        ranks = run_ranks("torch_rank_jobs:pinned_perhost_build", world, tmp_path, payload)
        arrays = {}
        for r in ranks:
            assert r["blocks"] == want_blocks and r["statuses"] == want_status
            arrays.update(r["arrays"])
        # the same block bytes as the single-process build's
        assert sorted(arrays) == list(range(len(want_blocks)))
        for g, b in enumerate(single.blocks):
            with np.load(os.path.join(single.dir, b["file"])) as z:
                for k in ("x", "labels", "weights", "entity_ids", "row_sel"):
                    assert np.array_equal(z[k], arrays[g][k]), (world, g, k)


@pytest.mark.parametrize("kw", [dict(block_entities=16), dict(memory_budget_bytes=8000)],
                         ids=["16-a-block", "budget"])
def test_a_one_rank_manifest_is_the_jax_manifest_and_the_single_host_blocks(glmix, tmp_path,
                                                                          kw):
    jdata, tdata = glmix
    man = tps.build_perhost_streaming_manifest(_port_rows(tdata), TCFG, str(tmp_path / "t"),
                                               None, 1, 0, **kw)
    jman = jps.build_perhost_streaming_manifest(_jax_host_rows(jdata), JCFG,
                                                str(tmp_path / "j"), None, 1, 0, **kw)
    ref = write_re_entity_blocks(tdata, TCFG, str(tmp_path / "ref"), **kw)
    with open(tmp_path / "t" / "manifest.json") as f, open(tmp_path / "j" / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    assert man.global_block_ids == list(range(len(ref.blocks)))
    for name in ("plan.json", "plan-owners.npy", "plan-block-of.npy"):
        assert _file_bytes(tmp_path / "t")[name] == _file_bytes(tmp_path / "j")[name]
    for b, rb in zip(man.blocks, ref.blocks):
        assert b == rb
        with np.load(os.path.join(man.dir, b["file"])) as z1, \
                np.load(os.path.join(ref.dir, rb["file"])) as z2:
            assert z1.files == z2.files
            for k in z1.files:
                assert np.array_equal(z1[k], z2[k]), (b["file"], k)


# ---------------------------------------------------------------------------
# (b) the 2-rank streaming descent, bitwise the single-host one
# ---------------------------------------------------------------------------


ARMS = {"flags-off": OFF,
        "compaction-adaptive-sparse": dict(OFF, solve_compaction="3", adaptive_schedule="0.0:1",
                                           sparse_kernel="auto")}


def _single_host(tdata, out, plan_kw):
    """The port's single-host streaming descent under ``plan_kw`` and the
    sparse race decisions it made (every rank adopts them)."""
    from photon_ml_tpu_torch.ops import fused_sparse

    fe, re = streaming_coordinates(tdata, PAYLOAD, outdir=out, single_host=True,
                                   plan=ExecutionPlan.resolve(streaming=True, **plan_kw))
    res = streaming_descent((fe, re), tdata)
    decisions = [("sparse", k, v) for k, v in fused_sparse._race_cache.items()]
    return res, re.entity_means_by_raw_id(res.coefficients["per-user"]), re, decisions


@pytest.fixture(scope="module")
def two_rank_runs(glmix, tmp_path_factory):
    """Per arm: the single-host reference and the two ranks' results."""
    _, tdata = glmix
    out = {}
    for arm, plan in ARMS.items():
        base = tmp_path_factory.mktemp(arm)
        ref = _single_host(tdata, str(base), plan)
        out[arm] = ref, run_ranks("torch_rank_jobs:perhost_streaming_cd", 2, base,
                                  dict(PAYLOAD, data=tdata, outdir=str(base), plan=plan,
                                       race_decisions=ref[3]))
    return out


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_two_rank_descent_is_bitwise_the_single_host_descent(two_rank_runs, arm):
    (ref, ref_means, ref_re, _), ranks = two_rank_runs[arm]
    want_fe = ref.coefficients["fixed"].numpy()
    want_total = ref.total_scores.numpy()
    for r in ranks:
        # every rank holds the replicated values, bit for bit
        assert np.array_equal(r["fe"], want_fe)
        assert np.array_equal(r["total"], want_total)
        assert r["objectives"] == list(ref.objective_history)
        assert r["reg"] == float(ref_re.regularization_term(ref.coefficients["per-user"]))
    # owner-computes: disjoint owned blocks covering the blocking
    owned = [set(r["owned"]) for r in ranks]
    assert not owned[0] & owned[1] and owned[0] and owned[1]
    assert owned[0] | owned[1] == set(range(ranks[0]["blocks_total"]))
    merged = {}
    for r in ranks:
        assert not set(merged) & set(r["means"])
        merged.update(r["means"])
    assert sorted(merged) == sorted(ref_means)
    for k, vec in ref_means.items():
        assert np.array_equal(merged[k], vec), k
    # compaction engaged on both ranks of the flags-on arm, and only there
    assert all((r["chunk_dispatches"] > 0) == (arm != "flags-off") for r in ranks)


def test_the_flags_hold_the_flags_off_descent(two_rank_runs):
    """Compaction and the adaptive order are bitwise the one-shot solve; a
    block the race hands a sparse family solves on the slab, whose gradient
    sums in the kernels' flat order, not the dense stack's: its lanes may
    stop an iteration apart, so the arms agree at ``solver``. The JAX slab
    families part from their dense stack the same way (by design:
    ``test_a_slab_family_is_not_bitwise_the_dense_stack_in_either_package``)."""
    (off, off_means, _, _), _ = two_rank_runs["flags-off"]
    (on, on_means, _, _), _ = two_rank_runs["compaction-adaptive-sparse"]
    assert_allclose(on.objective_history, off.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(on.coefficients["fixed"].numpy(), off.coefficients["fixed"].numpy(),
                    kind="solver")
    assert sorted(on_means) == sorted(off_means)


def test_a_slab_family_is_not_bitwise_the_dense_stack_in_either_package(glmix):
    """The question behind the flags-on arm, asked of both packages on one
    block's solve (the worker's LBFGS at 6 iterations, 1e-8, L2 0.2): a
    slab family sums its gradient in its own order, so in JAX (``scatter``,
    ``segment``) as in the port (``pallas``, ``scatter``) the block's
    coefficients are not bitwise the package's own dense stack (``off``);
    each agrees with it at ``solver``. The JAX 2-process gate's bitwise
    claim holds because its race hands every block back to the dense stack
    on the CPU."""
    import jax.numpy as jnp

    from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
    from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    jdata, tdata = glmix
    jds = j_build(jdata, JCFG)
    tds = tgame.build_random_effect_dataset(tdata, TCFG, device="cpu")
    cfg, reg = JConfig(max_iterations=6, tolerance=1e-8), JReg.l2(0.2)
    resid = np.random.default_rng(2).normal(scale=0.3, size=jdata.num_rows).astype(np.float32)

    def jax_block(spec):
        c = JRandom(jds, JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, cfg, reg, sparse_kernel=spec)
        assert (c._slab is None) == (spec == "off")
        return np.asarray(c.update(jnp.asarray(resid), c.initial_coefficients())[0])

    def port_block(spec):
        c = RandomEffectCoordinate(tds, TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                   interop.from_jax_numpy(cfg, "cpu"),
                                   interop.from_jax_numpy(reg, "cpu"), sparse_kernel=spec)
        assert (c.slab is None) == (spec == "off")
        return c.update(torch.from_numpy(resid), c.initial_coefficients())[0].numpy()

    for block, families in ((jax_block, ("scatter", "segment")),
                            (port_block, ("pallas", "scatter"))):
        dense = block("off")
        assert np.array_equal(block("off"), dense)  # the dense stack is deterministic
        for fam in families:
            got = block(fam)
            assert not np.array_equal(got, dense), (block.__name__, fam)
            assert_allclose(got, dense, kind="solver", err_msg=f"{block.__name__} {fam}")


def test_the_jax_single_process_perhost_descent_holds_the_port(glmix, two_rank_runs, tmp_path):
    jdata, _ = glmix
    (ref, ref_means, _, _), _ = two_rank_runs["flags-off"]
    n = jdata.num_rows
    man = jps.build_perhost_streaming_manifest(_jax_host_rows(jdata), JCFG, str(tmp_path / "j"),
                                               None, 1, 0, block_entities=16,
                                               bucketer="off")
    jre = jps.PerHostStreamingRandomEffectCoordinate(
        man, JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, JConfig(max_iterations=6, tolerance=1e-8),
        JReg.l2(0.2), state_root=str(tmp_path / "js"), num_processes=1, sparse_kernel="off")
    gf = jdata.shards["global"]
    x_fe = np.zeros((n, gf.dim), np.float32)
    x_fe[np.repeat(np.arange(n), np.diff(gf.indptr)), gf.indices] = gf.values
    y = jdata.response.astype(np.float32)
    sizes = [min(128, n - c * 128) for c in range(-(-n // 128))]
    loaders = {c: (lambda s=c * 128, e=c * 128 + sizes[c]: {"x": x_fe[s:e], "y": y[s:e]})
               for c in range(len(sizes))}
    jfe = JPerHostFE(sizes, loaders, gf.dim,
                     JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS,
                              JConfig(max_iterations=6, tolerance=1e-8), JReg.l2(0.5)),
                     num_processes=1, bucketer="off")
    import jax.numpy as jnp

    labels, weights = jnp.asarray(y), jnp.asarray(jdata.weight.astype(np.float32))
    jres = JCD({"fixed": jfe, "per-user": jre},
               lambda s: jnp.sum(weights * jlosses.logistic.loss(s, labels))).run(
        num_iterations=2, num_rows=n)
    assert_allclose(ref.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(ref.coefficients["fixed"].numpy(), np.asarray(jres.coefficients["fixed"]),
                    kind="solver")
    jmeans = jre.entity_means_by_raw_id(jres.coefficients["per-user"])
    assert sorted(jmeans) == sorted(ref_means)
    for k in ref_means:
        assert_allclose(ref_means[k], jmeans[k], kind="solver", err_msg=k)


# ---------------------------------------------------------------------------
# (c) the sign of zero, (d) the fault sites
# ---------------------------------------------------------------------------


def _signed_zero_payload():
    scores = np.random.default_rng(3).normal(size=24).astype(np.float32)
    scores[[4, 11]] = -0.0  # a zero feature times a negative coefficient
    scores[7] = 0.0
    return {"scores": scores, "owner": np.arange(24) % 3}


def test_a_merged_negative_zero_stays_negative_zero_at_one_and_two_ranks(tmp_path):
    payload = _signed_zero_payload()
    want = payload["scores"]
    one = tps.merge_disjoint(torch.from_numpy(want.copy()), None, 1)
    ranks = run_ranks("torch_rank_jobs:merge_signed_zero", 2, tmp_path, payload)
    for got in [one.numpy()] + [r["merged"] for r in ranks]:
        assert got.tobytes() == want.tobytes()
        assert np.signbit(got[[4, 11]]).all() and not np.signbit(got[7])
    for r in ranks:
        assert r["merged64"].tobytes() == want.astype(np.float64).tobytes()
    # the JAX merge fills with +0.0 and loses the sign: why the port fills -0.0
    assert not np.signbit(np.float32(0.0) + np.float32(-0.0))


def test_merge_disjoint_devices_keeps_the_jax_refusals():
    ctx = tps.MeshContext.local()
    a = np.random.default_rng(5).normal(size=(1, 7)).astype(np.float32)
    assert np.array_equal(tps.merge_disjoint_devices(a, ctx), a[0])
    with pytest.raises(ValueError, match="leading shard"):
        tps.merge_disjoint_devices(np.zeros((2, 4), np.float32), ctx)
    with faults.fault_scope(faults.parse_fault_env("multihost.streaming_reduce:at=1")):
        assert np.array_equal(tps.merge_disjoint_devices(a, ctx), a[0])


def test_the_fault_sites_fire_and_are_retried(glmix, tmp_path):
    from photon_ml_tpu_torch.resilience.faults import InjectedIOError

    _, tdata = glmix
    build = lambda d: tps.build_perhost_streaming_manifest(
        _port_rows(tdata), TCFG, str(tmp_path / d), None, 1, 0, block_entities=16,
        shared_vocab=tdata.id_vocabs["userId"])
    with faults.fault_scope(faults.parse_fault_env("io.perhost_block_write:at=1")):
        assert len(build("a").blocks) == 4  # survived the injected write failure
    with faults.fault_scope(faults.parse_fault_env("multihost.entity_route:rate=1.0,seed=7")):
        with pytest.raises(InjectedIOError, match="entity_route"):
            build("b")
    a = np.ones((4,), np.float32)
    with faults.fault_scope(faults.parse_fault_env("multihost.streaming_reduce:at=1")):
        assert np.array_equal(tps.merge_disjoint(a, None, 1), a)
    with faults.fault_scope(faults.parse_fault_env("multihost.streaming_reduce:rate=1.0")):
        with pytest.raises(Exception, match="streaming reduce|streaming_reduce"):
            tps.merge_disjoint(a, None, 1)


def test_a_lost_rank_fails_the_survivor_by_name(glmix, tmp_path):
    """(h) Rank 1 dies hard after its first block spill; the survivor's
    barrier fails under a short PHOTON_BARRIER_TIMEOUT (or the backend sees
    the dead peer first), inside this test's own deadline."""
    _, tdata = glmix
    ranks = run_ranks("torch_rank_jobs:lose_a_rank_mid_block", 2, tmp_path,
                      dict(PAYLOAD, data=tdata, outdir=str(tmp_path)), timeout=120,
                      env={"PHOTON_BARRIER_TIMEOUT": "10"}, check=False)
    lost = ranks[1]
    assert lost.returncode == 17 and "LOSTHOST-DYING" in lost.stdout
    survivor = ranks[0]
    assert isinstance(survivor, dict), getattr(survivor, "stderr", "")[-2000:]
    assert survivor["error"] is not None
    assert survivor["error"].startswith(("BarrierTimeoutError", "CollectiveError"))
    assert "host 1" in survivor["heartbeats"]


# ---------------------------------------------------------------------------
# (e)-(g), (i), (j): the drivers
# ---------------------------------------------------------------------------


JAX_RTOL, JAX_ATOL = 5e-3, 5e-4  # tests/test_perhost_streaming.py:592-706
# 7 entity blocks of the 96 users, 3 or 4 a rank
STREAM = ["--streaming-random-effects", "true", "--re-memory-budget-mb", "0.003"]
COMPACT = ["--solve-compaction", "4"]


@pytest.fixture(scope="module")
def mh_stream(tmp_path_factory):
    return _write_mh_data(tmp_path_factory.mktemp("mhs"))


def _ranks(module, base, argv, world=2, env=None, check=True, rank_envs=None):
    from torch_ranks import init_url, launch

    init = init_url(base)
    return launch([["-m", f"photon_ml_tpu_torch.cli.{module}", "--multihost-coordinator",
                    init, "--multihost-num-processes", str(world),
                    "--multihost-process-id", str(r), "--device", "cpu"] + argv
                   for r in range(world)], env=env, check=check, rank_envs=rank_envs)


def _summaries(out_dir, world=2):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"photon-ml-tpu-mh-{r}.json")) as f:
            out.append(json.load(f))
    return out


def _log(out_dir, rank):
    with open(os.path.join(out_dir, f"photon-ml-tpu-mh-{rank}.log")) as f:
        return f.read()


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _models(out_dir, idx):
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.offheap import load_shard_index_map

    best = os.path.join(out_dir, "best")
    fe = model_io.load_fixed_effect(best, "fixed", load_shard_index_map(idx, "global"))[0]
    re, _, re_id, _ = model_io.load_random_effect(best, "per-user",
                                                  load_shard_index_map(idx, "per_user"))
    return fe, re, re_id


@pytest.fixture(scope="module")
def stream_runs(mh_stream):
    """The 2-rank streaming multihost run (compacted), the same command at
    one rank in this process, and the port's single-process streaming
    driver on the same flags."""
    from photon_ml_tpu_torch.cli import game_multihost_driver as mhdriver
    from photon_ml_tpu_torch.cli import game_training_driver as tdriver

    base, flags, _ = mh_stream
    argv = flags + STREAM + COMPACT
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "mh2")] + argv)
    one = mhdriver.main(["--output-dir", str(base / "mh1"), "--device", "cpu"] + argv)
    sp = tdriver.main(["--output-dir", str(base / "sp"), "--device", "cpu"] + argv)
    return one, sp


def test_two_rank_streaming_driver_is_bitwise_its_one_rank_run(mh_stream, stream_runs):
    base, _, idx = mh_stream
    one, sp = stream_runs
    ranks = _summaries(str(base / "mh2"))
    assert ranks[0]["validation_metrics"] == ranks[1]["validation_metrics"]
    assert ranks[0]["objective_history"] == ranks[1]["objective_history"] == \
        one["objective_history"]
    # each rank built only its blocks, under its own manifest dir
    owned = [set(r["streaming_blocks"]["per-user"]) for r in ranks]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    assert owned[0] | owned[1] == set(one["streaming_blocks"]["per-user"]) == set(range(7))
    for r in range(2):
        m = base / "mh2" / "streaming-re" / "per-user" / f"process-{r}"
        with open(m / "manifest.json") as f:
            assert json.load(f)["global_block_ids"] == sorted(owned[r])
        with open(m / "plan.json") as f:
            assert len(json.load(f)["fe_chunk_owners"]) == 4  # one FE chunk a part file
    parts = os.listdir(base / "mh2" / "best" / "random-effect" / "per-user" / "coefficients")
    assert sorted(parts) == ["part-00000.avro", "part-00001.avro"]
    fe2, re2, re_id = _models(str(base / "mh2"), idx)
    fe1, re1, _ = _models(str(base / "mh1"), idx)
    assert re_id == "userId" and set(re2) == set(re1)
    assert np.array_equal(fe2, fe1)
    for k in re1:
        assert np.array_equal(re2[k], re1[k]), k
    # the single-process streaming driver, at the JAX test's bound
    fes, res, _ = _models(str(base / "sp"), idx)
    assert set(res) == set(re2)
    np.testing.assert_allclose(fe2, fes, rtol=JAX_RTOL, atol=JAX_ATOL)
    for k in res:
        np.testing.assert_allclose(re2[k], res[k], rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=k)
    sp_metrics = sp.results[sp.best_index][2]
    assert ranks[0]["validation_metrics"]["AUC"] == pytest.approx(sp_metrics["AUC"], abs=2e-3)
    with open(base / "mh2" / "retrain.json") as f:
        rec = json.load(f)["coordinates"]["per-user"]
    assert rec["kind"] == "streaming_random"
    assert rec["streaming_manifest_dir"].endswith(os.path.join("per-user", "process-0"))


def test_multihost_scoring_of_the_streaming_model(mh_stream, stream_runs):
    """(f) The model's per-host part files are the in-memory layout: the
    2-rank multihost scoring driver scores it as the scoring driver does."""
    from photon_ml_tpu_torch.cli import game_scoring_driver as tscoring
    from photon_ml_tpu_torch.io import avro as tavro

    base, flags, idx = mh_stream
    score_flags = ["--input-dirs", flags[flags.index("--validate-input-dirs") + 1],
                   "--game-model-input-dir", str(base / "mh2" / "best"),
                   "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
                   "--offheap-indexmap-dir", idx, "--evaluator-type", "AUC",
                   "--delete-output-dir-if-exists", "true"]
    _ranks("game_multihost_scoring_driver", base,
           ["--output-dir", str(base / "mh-score")] + score_flags)
    tscoring.main(["--output-dir", str(base / "sp-score"), "--device", "cpu"] + score_flags)

    def read(d):
        recs = {}
        for f in sorted(os.listdir(d)):
            for rec in tavro.read_container(os.path.join(d, f)):
                recs[int(rec["uid"])] = rec["predictionScore"]
        return np.asarray([recs[k] for k in sorted(recs)], np.float32), sorted(recs)

    (got, gk), (want, wk) = read(str(base / "mh-score" / "scores")), \
        read(str(base / "sp-score" / "scores"))
    assert gk == wk
    assert_allclose(got, want, kind="elementwise")


def test_warm_start_from_freezes_or_warms_on_an_agreed_plan(mh_stream, stream_runs):
    """(g) The multihost --warm-start-from: unchanged inputs freeze both
    coordinates (every owned block, on both ranks) and write the prior
    model's coefficients bitwise; a new part file pins the prior blocking
    by the single-process delta build's rule, freezes the blocks whose
    entities have no new rows (their users bitwise the prior's on both
    ranks) and re-solves the rest warm, on a plan both ranks agree, and
    the run holds against the single-process streaming delta run of the
    same files from its own prior: the same frozen users, every
    coefficient and the objectives at the JAX test's bound; the agreement
    fault on rank 1 alone makes both ranks train cold."""
    from photon_ml_tpu_torch.cli import game_training_driver as tdriver

    base, flags, idx = mh_stream
    argv = flags + STREAM + COMPACT + ["--warm-start-from", str(base / "mh2")]
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "warm-same")] + argv)
    fe, re, _ = _models(str(base / "warm-same"), idx)
    fe0, re0, _ = _models(str(base / "mh2"), idx)
    assert np.array_equal(fe, fe0) and set(re) == set(re0)
    for k in re0:
        assert np.array_equal(re[k], re0[k]), k
    digests = [s["delta_digest"] for s in _summaries(str(base / "warm-same"))]
    assert digests[0] == digests[1] is not None
    for r in range(2):
        assert "frozen ['fixed', 'per-user']" in _log(str(base / "warm-same"), r)
    # a new training part file beside the prior's four
    flags2 = list(argv)
    flags2[flags2.index("--train-input-dirs") + 1] = f"{base / 'train'},{base / 'delta'}"
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "warm-new")] + flags2)
    warm = _summaries(str(base / "warm-new"))
    assert warm[0]["delta_digest"] == warm[1]["delta_digest"] is not None
    for r in range(2):
        log = _log(str(base / "warm-new"), r)
        assert "agreed across 2 hosts" in log and "fixed=dirty per-user=dirty" in log
        assert "warm start: ['fixed', 'per-user'] seeded" in log and "; frozen [" not in log
        assert "prior blocking pinned, 3 dirty entities" in log
    frozen_g = [w["frozen_blocks"]["per-user"] for w in warm]
    assert frozen_g[0] and frozen_g[1] and not set(frozen_g[0]) & set(frozen_g[1])
    # the single-process streaming delta run of the same files, from its
    # own prior (the port's single-process streaming run of (e))
    sp_flags = list(flags2)
    sp_flags[sp_flags.index("--warm-start-from") + 1] = str(base / "sp")
    sp = tdriver.main(["--output-dir", str(base / "sp-warm-new"), "--device", "cpu"] + sp_flags)
    sp_frozen = sp._frozen_blocks["per-user"]
    sp_man = sp.streaming_manifests["per-user"]
    sp_users = {sp_man.vocab[v] for i in sp_frozen
                for v in sp_man.load_block_meta(i, "cpu").entity_ids}
    # the frozen blocks' users are the prior's bitwise; the same users froze
    from photon_ml_tpu_torch.parallel.perhost_streaming import EntityShardPlan

    new_plan = EntityShardPlan.from_sidecars(
        str(base / "warm-new" / "streaming-re" / "per-user" / "process-0"))
    with open(base / "warm-new" / "streaming-re" / "per-user" / "process-0"
              / "manifest.json") as f:
        vocab_new = json.load(f)["vocab"]
    frozen_users = {vocab_new[v] for g in frozen_g[0] + frozen_g[1] for v in new_plan.blocks[g]}
    assert sorted(frozen_g[0] + frozen_g[1]) == sorted(sp_frozen)
    assert frozen_users == sp_users and len(frozen_users) > 40
    fe_new, re_new, _ = _models(str(base / "warm-new"), idx)
    fe_sp, re_sp, _ = _models(str(base / "sp-warm-new"), idx)
    _, re_sp0, _ = _models(str(base / "sp"), idx)
    for u in frozen_users:
        assert np.array_equal(re_new[u], re0[u]), u
        assert np.array_equal(re_sp[u], re_sp0[u]), u
    # the two users with new rows re-solved; the new user joined
    assert "newuser" in re_new and "newuser" not in frozen_users
    for u in ("u0", "u1"):
        assert u not in frozen_users and not np.array_equal(re_new[u], re0[u]), u
    # everything else against the single-process delta run
    assert set(re_new) == set(re_sp)
    np.testing.assert_allclose(fe_new, fe_sp, rtol=JAX_RTOL, atol=JAX_ATOL)
    for k in re_sp:
        np.testing.assert_allclose(re_new[k], re_sp[k], rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=k)
    np.testing.assert_allclose(warm[0]["objective_history"],
                               sp.results[sp.best_index][1].objective_history, rtol=JAX_RTOL)
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "warm-fault")] + flags2,
           rank_envs=[{}, {"PHOTON_FAULTS": "retrain.multihost_delta_agree:at=1"}])
    cold = _summaries(str(base / "warm-fault"))
    assert cold[0]["delta_digest"] is None and cold[1]["delta_digest"] is None
    for r in range(2):
        assert "retraining cold everywhere" in _log(str(base / "warm-fault"), r)
    assert "InjectedIOError" in _log(str(base / "warm-fault"), 1)
    # the warm start begins where the prior model left off
    assert warm[0]["objective_history"][0] < cold[0]["objective_history"][0]


def test_a_run_stopped_at_a_block_boundary_resumes_to_the_same_bytes(mh_stream, stream_runs):
    """(i) Both ranks stop after their first block (exit 75, an emergency
    checkpoint in each rank's own directory); a relaunch into another
    output dir restores each rank's spilled state and writes the
    uninterrupted run's bytes."""
    base, flags, _ = mh_stream
    ck = str(base / "ck-stop")
    # the stopped run fills a tensor cache of each rank's blocks; the
    # relaunch reads them back (every rank hits)
    argv = flags + STREAM + COMPACT + ["--checkpoint-dir", ck, "--tensor-cache",
                                       str(base / "tcache")]
    stopped = _ranks("game_multihost_driver", base, ["--output-dir", str(base / "stopped")]
                     + argv, env={"PHOTON_PREEMPT_AT": "block:1"}, check=False)
    assert [o.returncode for o in stopped] == [75, 75], [o.stderr[-2000:] for o in stopped]
    assert sorted(os.listdir(os.path.join(ck, "combo-0"))) == ["process-0", "process-1"]
    _ranks("game_multihost_driver", base, ["--output-dir", str(base / "resumed")] + argv)
    assert _tree(str(base / "resumed" / "best")) == _tree(str(base / "mh2" / "best"))
    for r in range(2):
        # the relaunch's manifest is the rank's cache entry, not a rebuild
        assert not os.path.exists(base / "resumed" / "streaming-re" / "per-user"
                                  / f"process-{r}")
    assert _summaries(str(base / "resumed"))[1]["objective_history"] == \
        _summaries(str(base / "mh2"))[1]["objective_history"]


def test_distributed_streaming_at_one_rank_writes_the_plain_streaming_bytes(mh_stream,
                                                                          monkeypatch):
    """(j) The GAME driver's --streaming-random-effects --distributed: the
    per-host streaming coordinate on a 1-rank group, bitwise the plain
    streaming run."""
    from photon_ml_tpu_torch.cli import game_training_driver as tdriver

    base, flags, _ = mh_stream
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "pallas")
    common = ["--device", "cpu"] + flags + STREAM
    plain = tdriver.main(["--output-dir", str(base / "plain-s")] + common)
    dist = tdriver.main(["--output-dir", str(base / "dist-s"), "--distributed", "true"] + common)
    assert _tree(str(base / "plain-s" / "best")) == _tree(str(base / "dist-s" / "best"))
    assert plain.results[0][1].objective_history == dist.results[0][1].objective_history
    assert "sharding=perhost_streaming" in dist.plan.describe()
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
    )

    assert isinstance(dist.combo_coords[0]["per-user"], PerHostStreamingRandomEffectCoordinate)
