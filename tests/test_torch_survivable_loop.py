"""The port's relaunch path against the JAX package (CPU):
tests/test_survivable_loop.py's fixed-effect chunk ownership in the
versioned plan, ``relaunch_replan`` and the multihost driver's
``_attempt_relaunch_adoption`` / ``_fe_chunk_share``, each decision and
share held against the JAX functions on the same cohort layout (a fleet of
per-rank manifests built from the whole dataset, one process, the
collective votes passing through).

Then the supervised relaunch end to end through the port's multihost
driver (tests/torch_ranks.py): a 2-rank streaming run stopped after its
first checkpointed iteration, relaunched as 1 rank on the same output dir,
adopts the layout at plan v2 (only the lost rank's blocks and spilled
coefficients copied, the random-effect shard not decoded again) and writes
its uninterrupted 1-rank run's bytes.
"""

import json
import os
import types

import numpy as np
import pytest

from photon_ml_tpu.cli import game_multihost_driver as jmhd
from photon_ml_tpu.parallel import elastic as jel
from photon_ml_tpu.parallel import perhost_streaming as jps
from photon_ml_tpu.parallel.perhost_ingest import host_file_share as j_host_file_share
from photon_ml_tpu.resilience import faults as jfaults
from photon_ml_tpu_torch.cli import game_multihost_driver as mhd
from photon_ml_tpu_torch.parallel import elastic as tel
from photon_ml_tpu_torch.parallel import perhost_streaming as tps
from photon_ml_tpu_torch.parallel.perhost_ingest import host_file_share
from photon_ml_tpu_torch.resilience import faults as tfaults
from test_torch_elastic import BLOCK_ENTITIES, JCFG, LADDER, PKGS, TCFG, _rows, glmix  # noqa: F401
from test_torch_perhost_streaming import STREAM, _ranks, _summaries, _tree, _write_mh_data

pytestmark = pytest.mark.elastic

FAULTS = {"port": tfaults, "jax": jfaults}
DRIVERS = {"port": mhd, "jax": jmhd}


def _build_cohort(pkg, glmix, coord_root, hosts=(0, 1)):
    """One committed ``process-<rank>`` manifest per rank of an identity
    membership over ``hosts``."""
    jdata, tdata = glmix
    data = tdata if pkg == "port" else jdata
    el, ps = PKGS[pkg]
    rows = _rows(pkg, data)
    mem = el.FleetMembership(1, list(hosts), {h: h for h in hosts})
    return {p: ps.build_perhost_streaming_manifest(
        rows, TCFG if pkg == "port" else JCFG, os.path.join(coord_root, f"process-{p}"), None,
        1, p, block_entities=BLOCK_ENTITIES, bucketer=LADDER,
        shared_vocab=data.id_vocabs["userId"],
        membership=el.FleetMembership(mem.version, list(mem.hosts), dict(mem.binding)))
        for p in hosts}


def _cohorts(glmix, base, name="re", hosts=(0, 1)):
    """{pkg: (coord root, manifests)} of both packages' cohorts."""
    out = {}
    for pkg in PKGS:
        root = os.path.join(str(base), f"{name}-{pkg}")
        out[pkg] = root, _build_cohort(pkg, glmix, root, hosts)
    return out


class _Log:
    def __init__(self):
        self.infos, self.warns = [], []

    def info(self, msg):
        self.infos.append(str(msg))

    def warn(self, msg):
        self.warns.append(str(msg))


def _plan_files(d):
    out = {}
    for f in ("plan.json", "plan-owners.npy", "plan-block-of.npy", "manifest.json"):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


# ---------------------------------------------------------------------------
# fixed-effect chunk ownership rides in the versioned plan
# ---------------------------------------------------------------------------


class TestFeChunkPlan:
    @pytest.fixture()
    def plan_dirs(self, glmix, tmp_path):
        return {pkg: os.path.join(root, "process-0")
                for pkg, (root, _) in _cohorts(glmix, tmp_path).items()}

    def test_plan_without_fe_ownership_refuses(self, plan_dirs):
        for pkg, d in plan_dirs.items():
            plan = PKGS[pkg][1].EntityShardPlan.from_sidecars(d)
            assert plan.fe_chunk_owners is None
            with pytest.raises(ValueError, match="no FE chunk ownership"):
                plan.owned_fe_chunks(0)

    def test_explicit_owners_partition_and_validate(self, plan_dirs):
        for pkg, d in plan_dirs.items():
            plan = PKGS[pkg][1].EntityShardPlan.from_sidecars(d)
            fe = plan.with_fe_chunks([5, 3, 2], owners=[0, 1, 0])
            assert fe.owned_fe_chunks(0) == [0, 2] and fe.owned_fe_chunks(1) == [1]
            with pytest.raises(ValueError, match="disagree on the chunk count"):
                plan.with_fe_chunks([5, 3, 2], owners=[0, 1])

    def test_default_owners_cover_every_chunk(self, plan_dirs):
        shares = {}
        for pkg, d in plan_dirs.items():
            plan = PKGS[pkg][1].EntityShardPlan.from_sidecars(d)
            fe = plan.with_fe_chunks([4, 4, 4, 4, 4])
            shares[pkg] = [fe.owned_fe_chunks(h) for h in plan.host_list()]
            assert sorted(c for s in shares[pkg] for c in s) == list(range(5))
        assert shares["port"] == shares["jax"]

    def test_sidecar_round_trip_and_replan_rebase(self, plan_dirs):
        for pkg, d in plan_dirs.items():
            ps = PKGS[pkg][1]
            ps.attach_fe_chunks_to_sidecars(d, [0, 1, 0, 1], [9, 7, 5, 3])
            plan = ps.EntityShardPlan.from_sidecars(d)
            assert plan.fe_chunk_owners.tolist() == [0, 1, 0, 1]
            assert plan.fe_chunk_costs.tolist() == [9, 7, 5, 3]
            assert int(ps.load_plan_sidecars(d)[0]["version"]) == plan.version
            survivor = plan.replan([0])
            assert survivor.version == plan.version + 1
            assert sorted(survivor.owned_fe_chunks(0)) == [0, 1, 2, 3]
            grown = plan.replan([0, 1, 2])
            assert sorted(c for h in (0, 1, 2) for c in grown.owned_fe_chunks(h)) == [0, 1, 2, 3]
        assert _plan_files(plan_dirs["port"]) == _plan_files(plan_dirs["jax"])

    def test_attach_refuses_pre_versioned_sidecars(self, tmp_path):
        d = str(tmp_path / "pre")
        os.makedirs(d)
        np.save(os.path.join(d, "plan-owners.npy"), np.zeros(3, np.int32))
        np.save(os.path.join(d, "plan-block-of.npy"), np.zeros(5, np.int32))
        for pkg in PKGS:
            with pytest.raises(ValueError, match="pre-versioned"):
                PKGS[pkg][1].attach_fe_chunks_to_sidecars(d, [0], [1])


# ---------------------------------------------------------------------------
# the relaunch-time re-plan
# ---------------------------------------------------------------------------


def _seed_state(manifests, base, pkg):
    """One epoch dir a rank holding its blocks' coefficient files (value =
    rank + 1)."""
    roots = {}
    for p, man in manifests.items():
        root = os.path.join(str(base), f"spill-{pkg}-{p}")
        os.makedirs(os.path.join(root, "epoch-0"))
        for b, gid in zip(man.blocks, man.global_block_ids):
            np.save(os.path.join(root, "epoch-0", f"coefs-g{gid:05d}.npy"),
                    np.full((b["num_entities"], b["local_dim"]), float(p + 1), np.float32))
        roots[p] = root
    return roots


class TestRelaunchReplan:
    def test_survivor_adopts_only_moved_blocks(self, glmix, tmp_path):
        results = {}
        for pkg, (root, manifests) in _cohorts(glmix, tmp_path).items():
            el, ps = PKGS[pkg]
            ps.attach_fe_chunks_to_sidecars(manifests[0].dir, [0, 1, 0], [10, 8, 6])
            roots = _seed_state(manifests, tmp_path, pkg)
            res = el.relaunch_replan(root, 0, 1,
                                     state_root_pairs=[({0: roots[0], 1: roots[1]}, roots[0])])
            n_blocks = len(res.plan.owners)
            assert res.plan.version == 2 and res.membership.hosts == [0]
            assert sorted(res.manifest.global_block_ids) == list(range(n_blocks))
            # only the lost rank's blocks were copied
            assert sorted(res.adopted) == sorted(manifests[1].global_block_ids) != []
            by_gid = dict(zip(manifests[1].global_block_ids, manifests[1].blocks))
            for g in res.adopted:
                with open(os.path.join(manifests[1].dir, by_gid[g]["file"]), "rb") as a, \
                        open(os.path.join(manifests[0].dir, by_gid[g]["file"]), "rb") as b:
                    assert a.read() == b.read()
                moved = np.load(os.path.join(roots[0], "epoch-0", f"coefs-g{g:05d}.npy"))
                assert float(moved[0, 0]) == 2.0
            assert res.state_files_adopted == len(res.adopted)
            assert sorted(res.plan.owned_fe_chunks(0, res.membership)) == [0, 1, 2]
            assert any("no re-ingest" in d for d in res.decisions)
            results[pkg] = res, manifests[0].dir
        (res, d), (jres, jd) = results["port"], results["jax"]
        assert res.moved == jres.moved and res.adopted == jres.adopted
        assert np.array_equal(res.plan.owners, jres.plan.owners)
        assert _plan_files(d) == _plan_files(jd)

    def test_chaos_site_fires_at_entry(self, glmix, tmp_path):
        for pkg, (root, _) in _cohorts(glmix, tmp_path).items():
            faults = FAULTS[pkg]
            with faults.fault_scope(faults.FaultPlan(
                    [faults.FaultSpec("multihost.relaunch_replan", at=1)])):
                with pytest.raises(OSError):
                    PKGS[pkg][0].relaunch_replan(root, 0, 1)
            # the failure left the prior layout intact: a retry succeeds
            assert PKGS[pkg][0].relaunch_replan(root, 0, 1).plan.version == 2

    def test_stale_cohort_member_refused(self, glmix, tmp_path):
        for pkg, (root, _) in _cohorts(glmix, tmp_path).items():
            el, ps = PKGS[pkg]
            d0 = os.path.join(root, "process-0")
            meta, owners, block_of = ps.load_plan_sidecars(d0)
            # a re-shard that crashed mid-commit: rank 0 at v2, rank 1 at v1
            ps.write_plan_sidecars(
                d0, owners, block_of, version=2, hosts=[int(h) for h in meta["hosts"]],
                binding={int(h): int(q) for h, q in meta["binding"].items()},
                block_costs=np.asarray(meta["block_costs"], np.int64),
                num_entities=int(meta["num_entities"]),
                num_processes=int(meta["num_processes"]))
            with pytest.raises(el.ElasticError, match="stale"):
                el.relaunch_replan(root, 0, 1)

    def test_empty_root_refused(self, tmp_path):
        os.makedirs(str(tmp_path / "empty"))
        for el, _ in PKGS.values():
            with pytest.raises(el.ElasticError, match="nothing to re-plan"):
                el.relaunch_replan(str(tmp_path / "empty"), 0, 1)


# ---------------------------------------------------------------------------
# the multihost driver's adoption and chunk share (one rank, the votes
# passing through)
# ---------------------------------------------------------------------------


def _one_rank():
    return types.SimpleNamespace(process_id=0, num_processes=1)


def _driver_params(out_dir, pkg):
    return types.SimpleNamespace(updating_sequence=["per-user"], factored_configs={},
                                 random_effect_data_configs={"per-user": TCFG if pkg == "port"
                                                             else JCFG},
                                 output_dir=out_dir)


class TestRelaunchAdoption:
    def _adopt(self, glmix, tmp_path, hosts):
        out = {}
        for pkg in PKGS:
            base = os.path.join(str(tmp_path), pkg)
            if hosts is not None:
                _build_cohort(pkg, glmix, os.path.join(base, "streaming-re", "per-user"), hosts)
            log = _Log()
            out[pkg] = DRIVERS[pkg]._attempt_relaunch_adoption(
                _driver_params(base, pkg), _one_rank(), None, log), log
        return out

    def test_smaller_cohort_adopts(self, glmix, tmp_path):
        out = self._adopt(glmix, tmp_path, (0, 1))
        (adopted, log), (jadopted, _) = out["port"], out["jax"]
        assert set(adopted) == set(jadopted) == {"per-user"}
        res, jres = adopted["per-user"], jadopted["per-user"]
        assert res.plan.version == 2 and res.membership.hosts == [0] and res.adopted
        assert res.adopted == jres.adopted and res.moved == jres.moved
        assert any("adopted per-user at plan v2" in m for m in log.infos)

    def test_same_cohort_is_a_plain_resume(self, glmix, tmp_path):
        for pkg, (adopted, log) in self._adopt(glmix, tmp_path, (0,)).items():
            assert adopted == {}
            assert any("same cohort" in m for m in log.infos) and not log.warns

    def test_no_prior_layout_falls_back_to_ingest(self, tmp_path):
        for pkg, (adopted, log) in self._adopt(None, tmp_path, None).items():
            assert adopted == {}
            assert any("relaunch re-plan unavailable" in m for m in log.warns), pkg


class TestFeChunkShare:
    def _shares(self, glmix, tmp_path, files):
        out = {}
        for pkg, (root, manifests) in _cohorts(glmix, tmp_path).items():
            PKGS[pkg][1].attach_fe_chunks_to_sidecars(manifests[0].dir, [0, 1, 0], [4, 4, 2])
            res = PKGS[pkg][0].relaunch_replan(root, 0, 1)
            log = _Log()
            out[pkg] = DRIVERS[pkg]._fe_chunk_share(files, {"per-user": res}, _one_rank(),
                                                    log), log
        return out

    def test_adopted_plan_drives_the_share(self, glmix, tmp_path):
        files = ["part-0", "part-1", "part-2"]
        out = self._shares(glmix, tmp_path, files)
        (share, log), (jshare, _) = out["port"], out["jax"]
        assert share == jshare and sorted(share) == [(f, c) for c, f in enumerate(files)]
        assert any("re-based plan v2" in m for m in log.infos)

    def test_ownership_width_mismatch_falls_back(self, glmix, tmp_path):
        files = ["part-0", "part-1"]  # the input set changed size
        out = self._shares(glmix, tmp_path, files)
        (share, log), (jshare, _) = out["port"], out["jax"]
        assert share == jshare == host_file_share(files, 1, 0)
        assert any("positional" in m for m in log.infos)

    def test_no_adoption_is_the_positional_share(self):
        files = [f"part-{i}" for i in range(5)]
        for procs, pid in ((1, 0), (2, 1), (3, 2)):
            mh = types.SimpleNamespace(process_id=pid, num_processes=procs)
            assert mhd._fe_chunk_share(files, {}, mh, _Log()) == \
                jmhd._fe_chunk_share(files, {}, mh, _Log()) == \
                host_file_share(files, procs, pid) == j_host_file_share(files, procs, pid)


def test_multihost_fingerprint_is_cohort_invariant():
    """A relaunch onto another cohort resumes the prior checkpoints only if
    the fingerprint leaves out the rank count."""
    import inspect

    src = inspect.getsource(mhd)
    assert '"multihost": True' in src
    assert '"multihost": mh.num_processes' not in src


# ---------------------------------------------------------------------------
# the supervised relaunch through the driver: 2 ranks stopped, 1 relaunched
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def relaunched(tmp_path_factory):
    """The 2-rank streaming run stopped after its first checkpointed
    iteration (exit 75), its 1-rank relaunch on the same output and
    checkpoint dirs, and the uninterrupted 1-rank run."""
    base, flags, _ = _write_mh_data(tmp_path_factory.mktemp("relaunch"))
    ck = str(base / "ck")
    argv = flags + STREAM + ["--checkpoint-dir", ck]
    out = str(base / "run")
    seed = _ranks("game_multihost_driver", base, ["--output-dir", out] + argv,
                  env={"PHOTON_PREEMPT_AT": "cycle:2"}, check=False)
    seed_summaries = [json.load(open(os.path.join(ck, "combo-0", f"process-{r}", d, "meta.json")))
                      for r in range(2) for d in sorted(os.listdir(
                          os.path.join(ck, "combo-0", f"process-{r}"))) if d.startswith("step-")]
    seed_owned = {}
    for r in range(2):
        with open(os.path.join(out, "streaming-re", "per-user", f"process-{r}",
                               "manifest.json")) as f:
            seed_owned[r] = json.load(f)["global_block_ids"]
    relaunch = _ranks("game_multihost_driver", base, ["--output-dir", out] + argv, world=1)
    fresh = _ranks("game_multihost_driver", base, ["--output-dir", str(base / "fresh")] + argv
                   [:-2] + ["--checkpoint-dir", str(base / "ck-fresh")], world=1)
    return (base, seed, seed_summaries, seed_owned, relaunch, fresh)


def test_a_two_rank_run_relaunched_as_one_rank_adopts_and_is_bitwise(relaunched):
    base, seed, seed_steps, seed_owned, relaunch, _ = relaunched
    assert [o.returncode for o in seed] == [75, 75], [o.stderr[-2000:] for o in seed]
    assert max(m["step"] for m in seed_steps) == 2
    summary, = _summaries(str(base / "run"), world=1)
    fresh, = _summaries(str(base / "fresh"), world=1)
    # adoption at plan v2: only the lost rank's blocks were copied
    adopted = summary["adopted"]["per-user"]
    assert adopted["plan_version"] == 2
    assert sorted(adopted["blocks"]) == sorted(seed_owned[1])
    assert adopted["state_files"] >= len(seed_owned[1])
    assert sorted(g for g, _, _ in adopted["moved"]) == sorted(seed_owned[1])
    # the random-effect shard was not decoded again; the fixed effect's was
    assert "per_user" not in summary["decoded_shard_rows"]
    assert summary["decoded_shard_rows"]["global"] == summary["num_rows"]
    assert fresh["decoded_shard_rows"]["per_user"] == fresh["num_rows"]
    assert summary["streaming_blocks"] == fresh["streaming_blocks"]
    # the relaunch resumed at step 2 and writes the uninterrupted run's bytes
    assert summary["objective_history"] == fresh["objective_history"]
    assert summary["validation_metrics"] == fresh["validation_metrics"]
    assert _tree(str(base / "run" / "best")) == _tree(str(base / "fresh" / "best"))
    log = open(os.path.join(str(base / "run"), "photon-ml-tpu-mh-0.log")).read()
    assert "adopted relaunch re-plan v2" in log and "FE chunk ownership from re-based plan" in log
