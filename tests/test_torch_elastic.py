"""The port's elastic re-planning (photon_ml_tpu_torch/parallel/elastic.py)
against the JAX package (CPU): tests/test_elastic_reshard.py's cases, each
run through both packages on the same ``make_glmix_data`` inputs.

A simulated fleet builds each rank's manifest from the whole dataset
(routing is the identity at one process, and a block's content does not
depend on its rank), then drives the real session protocol, one thread a
rank: the versioned plan, the re-plan end to end, the drain and resume, the
plan-versioned checkpoint restore, the per-block cache keys and the fault
sites. Both packages' membership, proposal and plan files are held equal
(byte for byte where no clock or path enters them) and readable by the
other package; the new plan and the moved blocks are the same; the re-based
fleet and a drained-and-resumed update are bitwise the port's single-host
streaming run; each fault site records the same fallback.

The two-rank loss and scale-up arms run as gloo ranks
(tests/torch_ranks.py, ``torch_rank_jobs.elastic_streaming_cd``): bitwise
the port's single-host streaming descent, and at ``solver`` against the
JAX package's single-process streaming descent (the JAX package's own
two-process arms are slow-marked).
"""

import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm.streaming_random_effect import (
    StreamingRandomEffectCoordinate as JStreaming,
)
from photon_ml_tpu.algorithm.streaming_random_effect import (
    write_re_entity_blocks as j_write_blocks,
)
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.parallel import elastic as jel
from photon_ml_tpu.parallel import perhost_streaming as jps
from photon_ml_tpu.parallel.perhost_ingest import HostRows as JHostRows
from photon_ml_tpu.parallel.perhost_ingest import csr_to_padded as j_csr_to_padded
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    StreamingRandomEffectCoordinate,
    write_re_entity_blocks,
)
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.parallel import elastic as tel
from photon_ml_tpu_torch.parallel import perhost_streaming as tps
from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows, csr_to_padded
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_perhost_streaming import _sorted_vocab_data
from test_torch_game import _port_data
from tolerances import assert_allclose

pytestmark = pytest.mark.elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = tgame.RandomEffectDataConfig("userId", "per_user")
JCFG = JReConfig("userId", "per_user")
# tests/test_elastic_reshard.py's sizes: 8 entities a block over 40 users
# (5 blocks, so a 3 -> 2 owner re-plan moves blocks), one shape ladder
BLOCK_ENTITIES = 8
LADDER = "8:2.0"
RE_ITERS, RE_TOL, RE_LAMBDA = 6, 1e-8, 0.2
PKGS = {"port": (tel, tps), "jax": (jel, jps)}


@pytest.fixture(scope="module")
def glmix():
    jdata = _sorted_vocab_data(np.random.default_rng(41), num_users=40,
                               rows_per_user_range=(3, 12), d_fixed=4, d_random=3)
    return jdata, _port_data(jdata)


def _rows(pkg, data):
    pad, rows_cls = (csr_to_padded, HostRows) if pkg == "port" else (j_csr_to_padded, JHostRows)
    feats = data.shards["per_user"]
    fi, fv = pad(feats, data.num_rows)
    vocab = data.id_vocabs["userId"]
    return rows_cls(entity_raw_ids=[vocab[i] for i in data.ids["userId"]],
                    row_index=np.arange(data.num_rows, dtype=np.int64),
                    labels=data.response.astype(np.float32),
                    weights=data.weight.astype(np.float32),
                    offsets=data.offset.astype(np.float32), feat_idx=fi, feat_val=fv,
                    global_dim=feats.dim)


def _mem(pkg, version, hosts, binding):
    return PKGS[pkg][0].FleetMembership(version, list(hosts), dict(binding))


def _copy(pkg, m):
    return _mem(pkg, m.version, m.hosts, m.binding)


def _build_fleet(pkg, glmix, base, membership, tag="fleet", **kw):
    """One manifest per physical rank of the membership (the JAX test's
    simulated fleet: the same blocks a real multi-process build writes)."""
    jdata, tdata = glmix
    data = tdata if pkg == "port" else jdata
    el, ps = PKGS[pkg]
    cfg = TCFG if pkg == "port" else JCFG
    rows = _rows(pkg, data)
    return {p: ps.build_perhost_streaming_manifest(
        rows, cfg, os.path.join(str(base), f"{tag}-{pkg}-host{p}"), None, 1, p,
        block_entities=BLOCK_ENTITIES, bucketer=LADDER, shared_vocab=data.id_vocabs["userId"],
        membership=_copy(pkg, membership), **kw)
        for p in sorted(set(membership.binding.values()))}


def _both_fleets(glmix, base, hosts, binding, tag="fleet", **kw):
    return {pkg: _build_fleet(pkg, glmix, base, _mem(pkg, 1, hosts, binding), tag, **kw)
            for pkg in PKGS}


def _coord(man, base, tag, **kw):
    return tps.PerHostStreamingRandomEffectCoordinate(
        man, TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
        OptimizerConfig(max_iterations=RE_ITERS, tolerance=RE_TOL),
        RegularizationContext.l2(RE_LAMBDA), state_root=os.path.join(str(base), f"state-{tag}"),
        ctx=None, num_processes=1, device="cpu", sparse_kernel="off", **kw)


def _jcoord(man, base, tag, **kw):
    return jps.PerHostStreamingRandomEffectCoordinate(
        man, JTask.LOGISTIC_REGRESSION, JOpt.LBFGS,
        JConfig(max_iterations=RE_ITERS, tolerance=RE_TOL), JReg.l2(RE_LAMBDA),
        state_root=os.path.join(str(base), f"jstate-{tag}"), num_processes=1,
        sparse_kernel="off", **kw)


def _reference(glmix, base):
    """The port's single-host streaming coordinate on the same blocking."""
    _, tdata = glmix
    man = write_re_entity_blocks(tdata, TCFG, os.path.join(str(base), "ref-blocks"),
                                 block_entities=BLOCK_ENTITIES, bucketer=LADDER)
    return man, StreamingRandomEffectCoordinate(
        man, TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
        OptimizerConfig(max_iterations=RE_ITERS, tolerance=RE_TOL),
        RegularizationContext.l2(RE_LAMBDA), state_root=os.path.join(str(base), "ref-state"),
        device="cpu", sparse_kernel="off")


def _resid(n, seed=5):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _run_fleet(pkg, fleet_dir, membership, manifests, proposal, *, state_dirs=None,
               epochs=None, rebuild=None, block_cache=None, block_key_base=None, ledgers=None,
               timeout=30):
    """Every physical rank's session concurrently, one thread each (the file
    barrier needs every record before any rank finishes)."""
    el = PKGS[pkg][0]
    phys = sorted(set(membership.binding.values()))
    results, errors = {}, {}

    def run(p):
        try:
            mon = el.ElasticMonitor(str(fleet_dir), _copy(pkg, membership), process_id=p)
            sess = el.ElasticSession(str(fleet_dir), p, len(phys), mon, barrier_timeout=timeout,
                                     block_cache=block_cache, block_key_base=block_key_base)
            results[p] = sess.replan(manifests[p], proposal,
                                     state_dir=(state_dirs or {}).get(p),
                                     epoch=(epochs or {}).get(p, 0),
                                     rebuild_block=(rebuild or {}).get(p),
                                     ledger=(ledgers or {}).get(p))
        except BaseException as e:  # noqa: BLE001 — surfaced to the test below
            errors[p] = e

    threads = [threading.Thread(target=run, args=(p,)) for p in phys]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    if errors:
        raise next(iter(errors.values()))
    return results


def _proposal(pkg, fleet_dir, membership, process_id=0):
    mon = PKGS[pkg][0].ElasticMonitor(str(fleet_dir), _copy(pkg, membership),
                                      process_id=process_id)
    prop = mon.poll(force=True)
    assert prop is not None, "monitor saw no membership change"
    return prop


def _no_clock(prop):
    return {k: v for k, v in prop.items() if k != "proposed_at"}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


PLAN_FILES = ("plan.json", "plan-owners.npy", "plan-block-of.npy", "manifest.json")


def _plan_bytes(d):
    return {f: _read(os.path.join(d, f)) for f in PLAN_FILES}


def _same_blocks(dir_a, dir_b, blocks):
    for b in blocks:
        with np.load(os.path.join(dir_a, b["file"])) as za, \
                np.load(os.path.join(dir_b, b["file"])) as zb:
            # a block served from the cache lists its arrays by name order
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), (b["file"], k)


def _loss_replan(glmix, base, tag, hosts=(0, 1, 2), binding=None, lost=(2,), **kw):
    """Both packages' fleets built, owner(s) ``lost`` declared, each fleet
    re-planned: {pkg: (membership, manifests, proposal, results)}."""
    binding = binding or {0: 0, 1: 1, 2: 1}
    out = {}
    for pkg in PKGS:
        mem = _mem(pkg, 1, hosts, binding)
        manifests = _build_fleet(pkg, glmix, base, mem, tag, **kw.pop("build_kw", {}))
        fleet = os.path.join(str(base), f"{tag}-{pkg}-fleet")
        PKGS[pkg][0].declare_lost_hosts(fleet, list(lost), reason="spot reclamation")
        prop = _proposal(pkg, fleet, mem)
        out[pkg] = (mem, manifests, prop, _run_fleet(pkg, fleet, mem, manifests, prop, **kw),
                    fleet)
    return out


# ---------------------------------------------------------------------------
# the versioned plan
# ---------------------------------------------------------------------------


class TestPlanVersioning:
    def test_build_records_version_hosts_costs(self, glmix, tmp_path):
        fleets = _both_fleets(glmix, tmp_path, [0, 1], {0: 0, 1: 1})
        man = fleets["port"][0]
        assert man.plan_version == 1
        meta, owners, _ = tps.load_plan_sidecars(man.dir)
        assert meta["version"] == 1 and meta["hosts"] == [0, 1]
        assert meta["binding"] == {"0": 0, "1": 1}
        assert len(meta["block_costs"]) == len(owners) == man.num_blocks_total
        for p in (0, 1):
            assert _plan_bytes(fleets["port"][p].dir) == _plan_bytes(fleets["jax"][p].dir)

    def test_default_hosts_match_preversioned_assignment(self, glmix):
        from photon_ml_tpu_torch.parallel.shuffle import balanced_bucket_owners

        jdata, _ = glmix
        counts = np.bincount(jdata.ids["userId"])
        dim = jdata.shards["per_user"].dim
        plan = tps.EntityShardPlan.build(counts, 2, global_dim=dim, block_entities=16)
        jplan = jps.EntityShardPlan.build(counts, 2, global_dim=dim, block_entities=16)
        assert np.array_equal(plan.owners, balanced_bucket_owners(plan.block_costs, 2))
        assert np.array_equal(plan.owners, jplan.owners)

    def test_replan_is_deterministic_and_keeps_blocks(self, glmix):
        jdata, _ = glmix
        counts = np.bincount(jdata.ids["userId"])
        kw = dict(global_dim=jdata.shards["per_user"].dim, block_entities=16, hosts=[0, 1, 2])
        plan, jplan = tps.EntityShardPlan.build(counts, 3, **kw), \
            jps.EntityShardPlan.build(counts, 3, **kw)
        a, b = plan.replan([0, 2]), plan.replan([2, 0])
        assert np.array_equal(a.owners, b.owners) and a.version == b.version == 2
        assert set(a.owners.tolist()) <= {0, 2}
        assert np.array_equal(a.owners, jplan.replan([0, 2]).owners)
        for x, y in zip(plan.blocks, a.blocks):
            assert np.array_equal(x, y)
        assert np.array_equal(plan.block_costs, a.block_costs)
        assert a.replan([0]).version == 3

    def test_delta_is_only_the_changed_owners(self, glmix):
        jdata, _ = glmix
        counts = np.bincount(jdata.ids["userId"])
        moved = {}
        for pkg, (el, ps) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1, 2], {0: 0, 1: 1, 2: 1})
            plan = ps.EntityShardPlan.build(counts, 2, global_dim=jdata.shards["per_user"].dim,
                                            block_entities=16, hosts=mem.hosts)
            mem2 = mem.without([2])
            plan2 = plan.replan(mem2.hosts)
            moved[pkg] = plan.moved_blocks(plan2, mem, mem2)
            old_phys, new_phys = mem.physical_owners(plan.owners), \
                mem2.physical_owners(plan2.owners)
            gids = {g for g, _, _ in moved[pkg]}
            for g in range(len(plan.owners)):
                assert (old_phys[g] != new_phys[g]) == (g in gids)
        assert moved["port"] == moved["jax"]


# ---------------------------------------------------------------------------
# the session protocol (simulated fleet, real files)
# ---------------------------------------------------------------------------


class TestReplanEndToEnd:
    def test_loss_redistributes_blocks_byte_identical(self, glmix, tmp_path):
        """Lose logical owner 2 (its blocks lived on rank 1): the ranks
        agree v2, only the delta blocks move, the two packages write the
        same membership, plan and manifest bytes, and the re-based fleet
        solves to the single-host reference bitwise."""
        runs = _loss_replan(glmix, tmp_path, "loss")
        (_, _, prop, results, fleet), (_, _, jprop, jresults, jfleet) = runs["port"], runs["jax"]
        assert prop["version"] == 2 and prop["hosts"] == [0, 1]
        assert _no_clock(prop) == _no_clock(jprop)
        total = results[0].blocks_total
        assert results[0].plan_version == 2 and results[0].moved == results[1].moved
        assert results[0].moved == jresults[0].moved and 0 < results[0].blocks_moved <= total
        assert [r.incoming for r in results.values()] == [r.incoming for r in jresults.values()]
        owned = results[0].manifest.global_block_ids + results[1].manifest.global_block_ids
        assert sorted(owned) == list(range(total))
        assert _read(os.path.join(fleet, "membership.json")) == \
            _read(os.path.join(jfleet, "membership.json"))
        # each package reads the other's committed membership
        assert jel.read_membership(fleet).to_meta() == tel.read_membership(jfleet).to_meta()
        assert tel.read_membership(fleet).version == 2
        ref_man, ref = _reference(glmix, tmp_path)
        for p, res in results.items():
            assert res.manifest.plan_version == 2
            assert _plan_bytes(res.manifest.dir) == _plan_bytes(jresults[p].manifest.dir)
            _same_blocks(ref_man.dir, res.manifest.dir, res.manifest.blocks)
        n = glmix[1].num_rows
        resid = torch.from_numpy(_resid(n))
        s_ref, _ = ref.update(resid, ref.initial_coefficients())
        ref_means = ref.entity_means_by_raw_id(s_ref)
        merged = {}
        for p, res in results.items():
            coord = _coord(res.manifest, tmp_path, f"post-{p}")
            s, _ = coord.update(resid, coord.initial_coefficients())
            for k, v in coord.entity_means_by_raw_id(s).items():
                assert k not in merged
                merged[k] = v
        assert sorted(merged) == sorted(ref_means)
        for k in ref_means:
            assert np.array_equal(merged[k], ref_means[k]), k

    def test_scale_up_moves_blocks_to_new_owner(self, glmix, tmp_path):
        out = {}
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1], {0: 0, 1: 1})
            manifests = _build_fleet(pkg, glmix, tmp_path, mem)
            fleet = os.path.join(str(tmp_path), f"{pkg}-fleet")
            el.request_scale_up(fleet, {2: 0}, reason="capacity arrived")
            prop = _proposal(pkg, fleet, mem, process_id=1)
            assert prop["hosts"] == [0, 1, 2] and prop["binding"]["2"] == 0
            out[pkg] = prop, _run_fleet(pkg, fleet, mem, manifests, prop)
        (prop, results), (jprop, jresults) = out["port"], out["jax"]
        assert _no_clock(prop) == _no_clock(jprop)
        assert results[0].plan_version == 2 and results[0].moved == jresults[0].moved
        meta, owners, _ = tps.load_plan_sidecars(results[0].manifest.dir)
        assert meta["hosts"] == [0, 1, 2] and set(owners.tolist()) == {0, 1, 2}
        for p in results:
            assert _plan_bytes(results[p].manifest.dir) == _plan_bytes(jresults[p].manifest.dir)

    def test_ledger_rides_replan_and_rebases_to_new_owners(self, glmix, tmp_path):
        """Each rank's ledger rides its ack record, the merged realized costs
        balance the v2 plan, and each rank's re-based sidecar holds exactly
        its new blocks' entries, the JAX package's bytes."""
        import math

        from photon_ml_tpu.optim.convergence import ConvergenceLedger as JLedger
        from photon_ml_tpu_torch.optim.convergence import LEDGER_FILENAME, ConvergenceLedger

        out = {}
        for pkg, ledger_cls in (("port", ConvergenceLedger), ("jax", JLedger)):
            mem = _mem(pkg, 1, [0, 1, 2], {0: 0, 1: 1, 2: 2})
            manifests = _build_fleet(pkg, glmix, tmp_path, mem, tag="led")
            ledgers, expected = {}, {}
            for p, man in manifests.items():
                led = ledger_cls()
                for g in man.global_block_ids:
                    led.observe(g, 0.25 + 0.5 * g, executed=7 * g + 3, epoch=4,
                                under_tolerance=True)
                    led.record_skip(g, epoch=5)
                    expected[g] = led.entry(g)
                ledgers[p] = led.to_json()
            fleet = os.path.join(str(tmp_path), f"led-{pkg}-fleet")
            PKGS[pkg][0].declare_lost_hosts(fleet, [2], reason="spot reclamation")
            prop = _proposal(pkg, fleet, mem)
            out[pkg] = expected, _run_fleet(pkg, fleet, mem, manifests, prop, ledgers=ledgers)
        (expected, results), (jexpected, jresults) = out["port"], out["jax"]
        assert expected == jexpected
        total = results[0].blocks_total
        assert sorted(expected) == list(range(total))
        meta, _, _ = tps.load_plan_sidecars(results[0].manifest.dir)
        for g in range(total):
            e = expected[g]
            assert meta["block_costs"][g] == max(math.ceil(e["executed"] / e["visits"]), 1)
        for p, res in results.items():
            sidecar = ConvergenceLedger.load(res.manifest.dir)
            assert sidecar is not None and sidecar.gids() == sorted(res.manifest.global_block_ids)
            for g in res.manifest.global_block_ids:
                assert sidecar.entry(g) == expected[g]
            assert _read(os.path.join(res.manifest.dir, LEDGER_FILENAME)) == \
                _read(os.path.join(jresults[p].manifest.dir, LEDGER_FILENAME))
            assert _plan_bytes(res.manifest.dir) == _plan_bytes(jresults[p].manifest.dir)
            assert res.decisions[1:] == jresults[p].decisions[1:]  # the blocking verdict

    def test_replan_refuses_binding_outside_cohort(self, glmix, tmp_path):
        for pkg, (el, _) in PKGS.items():
            mem = el.FleetMembership.initial(2)
            manifests = _build_fleet(pkg, glmix, tmp_path, mem, tag="oc")
            fleet = os.path.join(str(tmp_path), f"oc-{pkg}")
            sess = el.ElasticSession(fleet, 0, 2, el.ElasticMonitor(fleet, _copy(pkg, mem), 0))
            bad = dict(mem.with_added({2: 7}).to_meta(), reason="typo")
            with pytest.raises(el.ElasticError, match="orphaned"):
                sess.replan_prepare(manifests[0], bad)

    def test_operator_files_consumed_no_livelock(self, glmix, tmp_path):
        """lost-hosts.json and scale-request.json are archived once folded
        into a committed membership: re-adding a lost owner does not
        ping-pong."""
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1, 2], {0: 0, 1: 1, 2: 1})
            manifests = _build_fleet(pkg, glmix, tmp_path, mem, tag="lv")
            fleet = os.path.join(str(tmp_path), f"lv-{pkg}-fleet")
            el.declare_lost_hosts(fleet, [2])
            results = _run_fleet(pkg, fleet, mem, manifests, _proposal(pkg, fleet, mem))
            assert not os.path.exists(os.path.join(fleet, "lost-hosts.json"))
            assert os.path.exists(os.path.join(fleet, "lost-hosts.json.consumed-v2"))
            mem2 = results[0].membership
            el.request_scale_up(fleet, {2: 1}, reason="capacity back")
            prop2 = _proposal(pkg, fleet, mem2, process_id=1)
            assert prop2["hosts"] == [0, 1, 2]
            results2 = _run_fleet(pkg, fleet, mem2, {p: r.manifest for p, r in results.items()},
                                  prop2)
            assert not os.path.exists(os.path.join(fleet, "scale-request.json"))
            mem3 = results2[0].membership
            assert mem3.to_meta() == {"version": 3, "hosts": [0, 1, 2],
                                      "binding": {"0": 0, "1": 1, "2": 1}}
            for p in (0, 1):
                assert el.ElasticMonitor(fleet, _copy(pkg, mem3), process_id=p).poll(
                    force=True) is None

    def test_plan_sidecar_roundtrip_reconstructs_plan(self, glmix, tmp_path):
        jdata, _ = glmix
        man = _build_fleet("port", glmix, tmp_path, _mem("port", 1, [0, 1, 2],
                                                          {0: 0, 1: 1, 2: 1}), tag="rt")[0]
        built = tps.EntityShardPlan.from_sidecars(man.dir)
        ref = jps.EntityShardPlan.build(np.bincount(jdata.ids["userId"]), 1,
                                        global_dim=jdata.shards["per_user"].dim,
                                        block_entities=BLOCK_ENTITIES, hosts=[0, 1, 2])
        assert built.version == ref.version and built.hosts == ref.hosts
        for f in ("owners", "block_costs", "block_of_vocab"):
            assert np.array_equal(getattr(built, f), getattr(ref, f)), f
        assert len(built.blocks) == len(ref.blocks)
        for a, b in zip(built.blocks, ref.blocks):
            assert np.array_equal(a, b)

    def test_membership_change_restarts_heartbeat_grace(self, tmp_path):
        """A re-added owner's stale heartbeat (or an added one with no beat
        yet) is not lost before one full deadline under the new membership."""
        for pkg, (el, _) in PKGS.items():
            fleet = tmp_path / f"gr-{pkg}"
            (fleet / "heartbeats").mkdir(parents=True)
            now = [1000.0]
            mem = _mem(pkg, 2, [0, 1, 2], {0: 0, 1: 1, 2: 1})
            (fleet / "heartbeats" / "heartbeat-2.json").write_text(
                json.dumps({"process": 2, "time": now[0] - 60, "step": 0}))
            mon = el.ElasticMonitor(str(fleet), _copy(pkg, mem), process_id=0,
                                    heartbeat_deadline=5.0, min_poll_interval=0.0,
                                    clock=lambda: now[0])
            mon.install_membership(_copy(pkg, mem))
            assert mon.poll(force=True) is None
            now[0] += 10.0
            prop = mon.poll(force=True)
            assert prop is not None and 2 not in prop["hosts"]

    def test_physical_owners_diagnostic_for_unknown_max_host(self):
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1, 2], {0: 0, 1: 1, 2: 1}).without([2])
            with pytest.raises(ValueError, match=r"owners \[2\].*membership"):
                mem.physical_owners(np.asarray([0, 2, 1]))
            assert mem.physical_owners(np.asarray([1, 0])).tolist() == [1, 0]

    def test_replan_rejects_version_gap(self, glmix, tmp_path):
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1], {0: 0, 1: 1})
            manifests = _build_fleet(pkg, glmix, tmp_path, mem)
            fleet = os.path.join(str(tmp_path), f"gap-{pkg}")
            sess = el.ElasticSession(fleet, 0, 2, el.ElasticMonitor(fleet, _copy(pkg, mem), 0))
            gap = dict(mem.with_added({2: 0}).to_meta(), version=5)
            with pytest.raises(el.ElasticError, match="does not follow"):
                sess.replan_prepare(manifests[0], gap)


# ---------------------------------------------------------------------------
# the drain and resume, and the plan-versioned restore
# ---------------------------------------------------------------------------


class _StubMonitor:
    """Fires the proposal on the N-th poll."""

    def __init__(self, fire_on, proposal):
        self.calls, self.fire_on, self.proposal = 0, fire_on, proposal

    def poll(self, step=None, force=False):
        self.calls += 1
        return self.proposal if self.calls >= self.fire_on else None


class TestDrainAndResume:
    def test_block_boundary_drain_carries_done_gids(self, glmix, tmp_path):
        """A drain at the first block boundary carries the done blocks by
        global id, as the JAX coordinate's does; a coordinate rebuilt with
        an epoch floor resumes it bitwise the uninterrupted update."""
        n = glmix[1].num_rows
        partials = {}
        for pkg in PKGS:
            mem = _mem(pkg, 1, [0, 1], {0: 0, 1: 0})  # every block on rank 0
            man = _build_fleet(pkg, glmix, tmp_path, mem)[0]
            prop = dict(mem.without([1]).to_meta(), reason="stub")
            make = _coord if pkg == "port" else _jcoord
            coord = make(man, tmp_path, "drain", elastic=_StubMonitor(2, prop))
            resid = torch.from_numpy(_resid(n)) if pkg == "port" else jnp.asarray(_resid(n))
            with pytest.raises(PKGS[pkg][0].ReplanRequired) as ei:
                coord.update(resid, coord.initial_coefficients())
            assert ei.value.proposal["version"] == 2
            partials[pkg] = (man, ei.value.partial)
        man, partial = partials["port"]
        m, jm = partial["meta"], partials["jax"][1]["meta"]
        assert m["kind"] == jm["kind"] == "streaming_re"
        assert m["plan_version"] == jm["plan_version"] == 1
        assert m["done_global_ids"] == jm["done_global_ids"]
        assert len(m["done_global_ids"]) == m["blocks_done"] >= 1
        resid = torch.from_numpy(_resid(n))
        resumed = _coord(man, tmp_path, "drain", initial_epoch=2)
        s_res, _ = resumed.update(resid, resumed.initial_coefficients(), resume=partial)
        plain = _coord(man, tmp_path, "plain")
        s_plain, _ = plain.update(resid, plain.initial_coefficients())
        for i in range(len(man.blocks)):
            assert np.array_equal(s_res.block(i), s_plain.block(i))

    def test_update_entry_drain_has_no_partial(self, glmix, tmp_path):
        for pkg in PKGS:
            mem = _mem(pkg, 1, [0, 1], {0: 0, 1: 0})
            man = _build_fleet(pkg, glmix, tmp_path, mem, tag="entry")[0]
            prop = dict(mem.without([1]).to_meta(), reason="stub")
            make = _coord if pkg == "port" else _jcoord
            coord = make(man, tmp_path, "entry", elastic=_StubMonitor(1, prop))
            n = glmix[1].num_rows
            resid = torch.zeros(n) if pkg == "port" else jnp.zeros(n)
            with pytest.raises(PKGS[pkg][0].ReplanRequired, match="update entry") as ei:
                coord.update(resid, coord.initial_coefficients())
            assert ei.value.partial is None
            # the score entry drains too, before any block streams
            with pytest.raises(PKGS[pkg][0].ReplanRequired, match="score entry"):
                coord.score(coord.initial_coefficients())

    def test_checkpoint_v1_restores_under_v2(self, glmix, tmp_path):
        """References written under plan v1 rebuild under the re-planned v2
        manifest: shapes checked by global id, moved-in coefficient files
        present after the re-base."""
        mem = tel.FleetMembership.initial(2)
        manifests = _build_fleet("port", glmix, tmp_path, mem)
        resid = torch.from_numpy(_resid(glmix[1].num_rows))
        coords = {p: _coord(m, tmp_path, f"ck-{p}") for p, m in manifests.items()}
        states = {p: c.update(resid, c.initial_coefficients())[0] for p, c in coords.items()}
        refs = {p: s.__checkpoint_ref__() for p, s in states.items()}
        assert all(r["kind"] == "perhost_spilled_re_state" and r["plan_version"] == 1
                   for r in refs.values())
        fleet = tmp_path / "ck-fleet"
        tel.declare_lost_hosts(str(fleet), [1])
        prop = _proposal("port", fleet, mem)
        for p, c in coords.items():
            assert c.replan_state_dirs()[-1] == states[p].dir
        results = _run_fleet("port", fleet, mem, manifests, prop,
                             state_dirs={p: c.replan_state_dirs() for p, c in coords.items()},
                             epochs={p: 1 for p in states})
        new_man = results[0].manifest
        assert sorted(new_man.global_block_ids) == list(range(results[0].blocks_total))
        template = _coord(new_man, tmp_path, "ck-post").initial_coefficients()
        assert isinstance(template, tps.PerHostSpilledREState)
        rebuilt = template.__checkpoint_from_ref__(refs[0])
        gid_of = {p: list(manifests[p].global_block_ids) for p in manifests}
        for i, g in enumerate(new_man.global_block_ids):
            src = 0 if g in gid_of[0] else 1
            assert np.array_equal(rebuilt.block(i), states[src].block(gid_of[src].index(g))), g
        # a ref whose recorded file vanished is refused, not zeroed
        os.remove(os.path.join(refs[0]["dir"], f"coefs-g{gid_of[0][0]:05d}.npy"))
        with pytest.raises(tckpt.CheckpointRefError, match="missing"):
            template.__checkpoint_from_ref__(refs[0])

    def test_preelastic_positional_ref_is_refused(self, glmix, tmp_path):
        old_ref = {"kind": "spilled_re_state", "dir": str(tmp_path), "shapes": [],
                   "written": False}
        from photon_ml_tpu.checkpoint import CheckpointRefError as JRefError

        for pkg in PKGS:
            man = _build_fleet(pkg, glmix, tmp_path, _mem(pkg, 1, [0], {0: 0}), tag="old")[0]
            make = _coord if pkg == "port" else _jcoord
            template = make(man, tmp_path, "old").initial_coefficients()
            err = tckpt.CheckpointRefError if pkg == "port" else JRefError
            with pytest.raises(err, match="pre-elastic"):
                template.__checkpoint_from_ref__(old_ref)


# ---------------------------------------------------------------------------
# the per-block cache keys
# ---------------------------------------------------------------------------


class TestOwnedBlockCacheKeys:
    def test_unmoved_blocks_keep_warm_entries_across_topology_change(self, glmix, tmp_path):
        """Per-block entries keyed on the block's identity (no rank scope):
        after a 3 -> 2 rank change every block hits."""
        from photon_ml_tpu_torch.io.tensor_cache import CacheStats, TensorCache

        cold_stats = CacheStats()
        manifests = _build_fleet("port", glmix, tmp_path, tel.FleetMembership.initial(3),
                                 tag="c3", block_cache=TensorCache(str(tmp_path / "bc"),
                                                                   stats=cold_stats),
                                 block_key_base="elastic-cache-test")
        total = manifests[0].num_blocks_total
        cold = cold_stats.snapshot()
        assert cold["hits"] == 0 and cold["writes"] == total
        warm_stats = CacheStats()
        manifests2 = _build_fleet("port", glmix, tmp_path, _mem("port", 2, [0, 1], {0: 0, 1: 1}),
                                  tag="c2", block_cache=TensorCache(str(tmp_path / "bc"),
                                                                    stats=warm_stats),
                                  block_key_base="elastic-cache-test")
        warm = warm_stats.snapshot()
        assert sum(len(m.blocks) for m in manifests2.values()) == total
        assert warm["hits"] == total and warm["misses"] == 0
        # the warm blocks are the cold build's blocks
        ref_man, _ = _reference(glmix, tmp_path)
        for m in manifests2.values():
            _same_blocks(ref_man.dir, m.dir, m.blocks)

    def test_dir_cache_and_block_cache_compose(self, glmix, tmp_path):
        """The dir-level scoped entry and the unscoped per-block entries
        together: a dir hit makes no block-cache traffic."""
        from photon_ml_tpu_torch.io.tensor_cache import (
            CacheStats,
            TensorCache,
            process_shard_scope,
        )

        src = tmp_path / "in.bin"
        src.write_bytes(b"inputs")
        dir_cache = TensorCache(str(tmp_path / "tc"), shard_scope=process_shard_scope(0, 1))
        key = dir_cache.key_for([str(src)], {"kind": "elastic-compose"})
        bstats = CacheStats()
        kw = dict(block_entities=BLOCK_ENTITIES, bucketer=LADDER,
                  shared_vocab=glmix[1].id_vocabs["userId"], tensor_cache=dir_cache,
                  cache_key=key, block_cache=TensorCache(str(tmp_path / "tc"), stats=bstats),
                  block_key_base="compose-test")
        rows = _rows("port", glmix[1])
        man1 = tps.build_perhost_streaming_manifest(rows, TCFG, str(tmp_path / "b1"), None, 1, 0,
                                                    **kw)
        writes = bstats.snapshot()["writes"]
        assert writes == len(man1.blocks)
        man2 = tps.build_perhost_streaming_manifest(rows, TCFG, str(tmp_path / "b2"), None, 1, 0,
                                                    **kw)
        assert man2.dir == man1.dir
        snap = bstats.snapshot()
        assert snap["writes"] == writes and snap["hits"] == 0

    def test_scoped_dir_keys_still_differ_per_topology(self):
        from photon_ml_tpu.io.tensor_cache import process_shard_scope as j_scope
        from photon_ml_tpu_torch.io.tensor_cache import process_shard_scope

        assert process_shard_scope(0, 2) != process_shard_scope(0, 3)
        assert process_shard_scope(0, 2) == j_scope(0, 2)


# ---------------------------------------------------------------------------
# the fault sites
# ---------------------------------------------------------------------------


class TestChaos:
    def test_replan_barrier_fault_falls_back(self, glmix, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_FAULTS", "multihost.replan_barrier:rate=1.0,seed=2")
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1], {0: 0, 1: 0})
            man = _build_fleet(pkg, glmix, tmp_path, mem, tag="bar")[0]
            fleet = str(tmp_path / f"bar-{pkg}")
            el.declare_lost_hosts(fleet, [1])
            prop = _proposal(pkg, fleet, mem)
            sess = el.ElasticSession(fleet, 0, 1, el.ElasticMonitor(fleet, _copy(pkg, mem), 0),
                                     barrier_timeout=5)
            with pytest.raises(el.ReplanBarrierError, match="supervised relaunch"):
                sess.replan(man, prop)
            # the fallback left membership uncommitted
            assert el.read_membership(fleet) is None

    def test_barrier_timeout_names_missing_peer(self, glmix, tmp_path):
        for pkg, (el, _) in PKGS.items():
            mem = el.FleetMembership.initial(2)
            manifests = _build_fleet(pkg, glmix, tmp_path, mem, tag="tm")
            fleet = str(tmp_path / f"tm-{pkg}")
            el.declare_lost_hosts(fleet, [1])
            prop = _proposal(pkg, fleet, mem)
            sess = el.ElasticSession(fleet, 0, 2, el.ElasticMonitor(fleet, _copy(pkg, mem), 0),
                                     barrier_timeout=1.0)
            with pytest.raises(el.ReplanBarrierError, match=r"\[1\]"):
                sess.replan(manifests[0], prop)

    def test_block_transfer_fault_degrades_to_recorded_cold_rebuild(self, glmix, tmp_path,
                                                                   monkeypatch):
        ref_man, _ = _reference(glmix, tmp_path)

        def rebuild(gi):
            with np.load(os.path.join(ref_man.dir, f"block-{gi:05d}.npz")) as z:
                return {k: np.asarray(z[k]) for k in z.files}

        monkeypatch.setenv("PHOTON_FAULTS", "io.block_transfer:rate=1.0,seed=5")
        runs = _loss_replan(glmix, tmp_path, "tf", rebuild={0: rebuild, 1: rebuild})
        for pkg in PKGS:
            results = runs[pkg][3]
            incoming = sorted(g for r in results.values() for g in r.incoming)
            assert incoming and sorted(g for r in results.values() for g in r.rebuilt) == incoming
            assert any("cold rebuild" in d for r in results.values() for d in r.decisions)
            for r in results.values():
                _same_blocks(ref_man.dir, r.manifest.dir, r.manifest.blocks)
        # the same recorded decisions, the fleets' paths apart
        port, jax_ = runs["port"][3], runs["jax"][3]
        assert [d for r in port.values() for d in r.decisions[1:]] == \
            [d.replace("tf-jax-", "tf-port-") for r in jax_.values() for d in r.decisions[1:]]

    def test_block_transfer_fault_without_rebuilder_is_loud(self, glmix, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_FAULTS", "io.block_transfer:rate=1.0,seed=5")
        for pkg, (el, _) in PKGS.items():
            mem = _mem(pkg, 1, [0, 1, 2], {0: 0, 1: 1, 2: 1})
            manifests = _build_fleet(pkg, glmix, tmp_path, mem, tag="tl")
            fleet = str(tmp_path / f"tl-{pkg}")
            el.declare_lost_hosts(fleet, [2])
            prop = _proposal(pkg, fleet, mem)
            with pytest.raises(el.ElasticError, match="missing block"):
                _run_fleet(pkg, fleet, mem, manifests, prop, timeout=3)

    def test_scale_up_with_out_of_cohort_binding_never_publishes(self, tmp_path):
        for pkg, (el, _) in PKGS.items():
            fleet = tmp_path / f"oc2-{pkg}"
            el.request_scale_up(str(fleet), {3: 7}, reason="typo")
            mon = el.ElasticMonitor(str(fleet), el.FleetMembership.initial(2), process_id=0,
                                    num_processes=2)
            assert mon.poll(force=True) is None
            assert not (fleet / "proposals" / "proposal-v2.json").exists()
            el.request_scale_up(str(fleet), {3: 1}, reason="fixed")
            prop = mon.poll(force=True)
            assert prop is not None and prop["binding"]["3"] == 1
        # the operator files are the same bytes, and each package reads the
        # other's proposal
        assert _read(tmp_path / "oc2-port" / "scale-request.json") == \
            _read(tmp_path / "oc2-jax" / "scale-request.json")
        assert _no_clock(jel.pending_proposal(str(tmp_path / "oc2-port"), 1)) == \
            _no_clock(tel.pending_proposal(str(tmp_path / "oc2-jax"), 1))

    def test_degenerate_all_hosts_lost_is_ignored_not_crashed(self, tmp_path):
        for pkg, (el, _) in PKGS.items():
            fleet = tmp_path / f"dg-{pkg}"
            el.declare_lost_hosts(str(fleet), [0, 1], reason="decommission typo")
            mon = el.ElasticMonitor(str(fleet), el.FleetMembership.initial(2), process_id=0)
            assert mon.poll(force=True) is None
        assert _read(tmp_path / "dg-port" / "lost-hosts.json") == \
            _read(tmp_path / "dg-jax" / "lost-hosts.json")

    def test_torn_plan_sidecars_refuse_loudly(self, glmix, tmp_path):
        for pkg, (_, ps) in PKGS.items():
            man = _build_fleet(pkg, glmix, tmp_path, _mem(pkg, 1, [0], {0: 0}), tag="torn")[0]
            owners_path = os.path.join(man.dir, "plan-owners.npy")
            np.save(owners_path, (np.load(owners_path) + 1).astype(np.int32))
            with pytest.raises(ValueError, match="torn"):
                ps.load_plan_sidecars(man.dir)
            with pytest.raises(ValueError, match="torn"):
                PKGS["jax" if pkg == "port" else "port"][1].load_plan_sidecars(man.dir)

    def test_membership_site_is_retried(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_FAULTS", "multihost.membership:at=1")
        for pkg, (el, _) in PKGS.items():
            d = str(tmp_path / f"m-{pkg}")
            el.commit_membership(d, el.FleetMembership.initial(2))
            got = el.read_membership(d)
            assert got is not None and got.version == 1 and got.hosts == [0, 1]
        assert _read(tmp_path / "m-port" / "membership.json") == \
            _read(tmp_path / "m-jax" / "membership.json")

    def test_heartbeat_deadline_detection_proposes_removal(self, tmp_path):
        for pkg, (el, _) in PKGS.items():
            fleet = tmp_path / f"hb-{pkg}"
            (fleet / "heartbeats").mkdir(parents=True)
            (fleet / "heartbeats" / "heartbeat-1.json").write_text(
                json.dumps({"process": 1, "time": time.time() - 60, "step": 0}))
            now = [time.time()]
            mon = el.ElasticMonitor(str(fleet), el.FleetMembership.initial(2), process_id=0,
                                    heartbeat_deadline=5.0, clock=lambda: now[0])
            assert mon.poll(force=True) is None  # inside the start-up grace
            now[0] += 10.0
            prop = mon.poll(force=True)
            assert prop is not None and prop["hosts"] == [0] and "heartbeat" in prop["reason"]
            # this rank's own beat is the JAX package's file
            beat = json.loads((fleet / "heartbeats" / "heartbeat-0.json").read_text())
            assert sorted(beat) == ["process", "step", "time"] and beat["process"] == 0

    def test_missing_heartbeat_respects_startup_grace(self):
        from photon_ml_tpu.parallel.multihost import lost_hosts as j_lost
        from photon_ml_tpu_torch.parallel.multihost import lost_hosts

        cases = [({}, [1], 5.0, 2.0), ({}, [1], 5.0, 9.0), ({1: 7.0}, [1], 5.0, None),
                 ({1: 3.0}, [1], 5.0, None)]
        got = [lost_hosts(a, e, d, missing_grace_elapsed=g) for a, e, d, g in cases]
        assert got == [[], [1], [1], []]
        assert got == [j_lost(a, e, d, missing_grace_elapsed=g) for a, e, d, g in cases]


def test_elastic_module_in_scan_scope():
    """Every fault site the port's elastic module fires is a literal of the
    port's registry and of the JAX package's (the registry test of
    tests/test_torch_checkpoint.py walks every module, this one too)."""
    import ast

    from photon_ml_tpu.resilience import sites as jsites
    from photon_ml_tpu_torch.resilience import sites as tsites

    path = os.path.join(REPO, "photon_ml_tpu_torch", "parallel", "elastic.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fired = {node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
             and isinstance(node.func.value, ast.Name) and node.func.value.id == "faults"
             and node.func.attr == "inject"}
    assert fired == {"multihost.membership", "multihost.replan_barrier", "io.block_transfer",
                     "multihost.relaunch_replan"}
    assert fired <= set(tsites.FAULT_SITES) and fired <= set(jsites.FAULT_SITES)
    for s in fired:
        assert tsites.FAULT_SITES[s] == jsites.FAULT_SITES[s]


# ---------------------------------------------------------------------------
# the two-rank arms: loss and scale-up, bitwise the single-host run
# ---------------------------------------------------------------------------

# tests/elastic_reshard_worker.py's sizes: 60 users, chunks of 128 rows,
# blocks of 16 entities, LBFGS 6 iterations at 1e-8
ARM_PAYLOAD = {"chunk_rows": 128, "block_entities": 16,
               "fe": {"optimizer": "LBFGS", "iters": 6, "tol": 1e-8, "lambda": 0.5},
               "re": {"optimizer": "LBFGS", "iters": 6, "tol": 1e-8, "lambda": 0.2},
               "plan": dict(solve_compaction="off", sparse_kernel="off",
                            shape_canonicalization="off", adaptive_schedule="off")}


@pytest.fixture(scope="module")
def arm_reference(tmp_path_factory):
    """The arms' data, the port's single-host streaming descent on it and
    the JAX package's single-process streaming descent (the reference of
    tests/test_elastic_reshard.py's slow arms)."""
    from photon_ml_tpu.algorithm import CoordinateDescent as JCD
    from photon_ml_tpu.algorithm.streaming_fixed_effect import (
        StreamingFixedEffectCoordinate as JStreamingFE,
    )
    from photon_ml_tpu.ops import losses as jlosses
    from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
    from photon_ml_tpu.optim.streaming import ChunkedGLMSource as JSource
    from photon_ml_tpu_torch.compile.plan import ExecutionPlan
    from torch_rank_jobs import streaming_coordinates, streaming_descent

    jdata = _sorted_vocab_data(np.random.default_rng(97), num_users=60,
                               rows_per_user_range=(4, 16), d_fixed=5, d_random=4)
    tdata = _port_data(jdata)
    base = str(tmp_path_factory.mktemp("arm-ref"))
    fe, re = streaming_coordinates(tdata, ARM_PAYLOAD, outdir=base, single_host=True,
                                   plan=ExecutionPlan.resolve(streaming=True,
                                                              **ARM_PAYLOAD["plan"]))
    ref = streaming_descent((fe, re), tdata)
    ref_means = re.entity_means_by_raw_id(ref.coefficients["per-user"])
    n = jdata.num_rows
    man = j_write_blocks(jdata, JCFG, os.path.join(base, "j-blocks"), block_entities=16)
    jre = JStreaming(man, JTask.LOGISTIC_REGRESSION, JOpt.LBFGS,
                     JConfig(max_iterations=6, tolerance=1e-8), JReg.l2(0.2),
                     state_root=os.path.join(base, "j-state"))
    gf = jdata.shards["global"]
    x_fe = np.zeros((n, gf.dim), np.float32)
    x_fe[np.repeat(np.arange(n), np.diff(gf.indptr)), gf.indices] = gf.values
    jfe = JStreamingFE(JSource.from_arrays(x_fe, jdata.response.astype(np.float32), 128),
                       JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS,
                                JConfig(max_iterations=6, tolerance=1e-8), JReg.l2(0.5)))
    labels = jnp.asarray(jdata.response.astype(np.float32))
    weights = jnp.asarray(jdata.weight.astype(np.float32))
    jref = JCD({"fixed": jfe, "per-user": jre},
               lambda s: jnp.sum(weights * jlosses.logistic.loss(s, labels))).run(
        num_iterations=2, num_rows=n)
    return tdata, ref, ref_means, jref, jre.entity_means_by_raw_id(jref.coefficients["per-user"])


@pytest.mark.parametrize("mode", ["loss", "scaleup"])
def test_two_rank_membership_change_replans_and_stays_bitwise(arm_reference, tmp_path, mode):
    """The loss arm: three logical owners on two ranks, owner 2 reclaimed
    mid-epoch; the scale-up arm: owner 2 added on rank 1. The ranks drain,
    agree plan v2 within the deadline (no supervised-relaunch fallback),
    move only the delta blocks and finish bitwise the single-host run."""
    from torch_ranks import run_ranks

    tdata, ref, ref_means, jref, jmeans = arm_reference
    ranks = run_ranks("torch_rank_jobs:elastic_streaming_cd", 2, tmp_path,
                      dict(ARM_PAYLOAD, data=tdata, outdir=str(tmp_path), mode=mode))
    # a rank whose peer's change landed first drains before its own trigger
    assert any("TRIGGERED" in r["log"] for r in ranks)
    for r in ranks:
        assert any(x.startswith("DRAINED v2") for x in r["log"])
        assert not any("supervised-relaunch" in x for x in r["log"])
        assert [p["version"] for p in r["replans"]] == [2] and r["plan_version"] == 2
        assert r["replans"][0]["rebuilt"] == []
        assert np.array_equal(r["fe"], ref.coefficients["fixed"].numpy())
        assert np.array_equal(r["total"], ref.total_scores.numpy())
        assert r["objectives"] == list(ref.objective_history)
    moved = ranks[0]["replans"][0]["moved"]
    assert moved and moved == ranks[1]["replans"][0]["moved"]
    assert sorted(g for r in ranks for g in r["replans"][0]["incoming"]) == \
        sorted(g for g, _, _ in moved)
    assert sorted(ranks[0]["owned"] + ranks[1]["owned"]) == \
        list(range(ranks[0]["replans"][0]["blocks_total"]))
    merged = {}
    for r in ranks:
        assert not set(merged) & set(r["means"])
        merged.update(r["means"])
    assert sorted(merged) == sorted(ref_means)
    for k, vec in ref_means.items():
        assert np.array_equal(merged[k], vec), k
    # the JAX package's single-process run holds it at the solver tolerance
    assert_allclose(ranks[0]["objectives"], jref.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(ranks[0]["fe"], np.asarray(jref.coefficients["fixed"]), kind="solver")
    for k in ref_means:
        assert_allclose(merged[k], jmeans[k], kind="solver", err_msg=k)
