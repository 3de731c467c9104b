"""Step checkpoints, preemption and the divergence guard of the port (CPU),
against the JAX package where both have the behaviour:

  * a step directory of the port has the JAX package's file set, ``meta.json``
    keys and structure spellings, and the JAX checkpointer restores it;
  * descent stopped by a preemption at any update boundary and resumed from
    its emergency checkpoint ends bitwise equal to the uninterrupted run
    (objective history, coefficients, total scores), sync and async;
  * a corrupted latest step falls back to the previous one; a fingerprint
    mismatch raises;
  * the divergence guard rolls a NaN update back as the JAX guard does;
  * the training driver: ``--max-restarts`` relaunches in-process, a
    subprocess exits 75 and its rerun resumes, both with model bytes equal
    to the uninterrupted run's, as the JAX driver does;
  * every fault and preemption site literal in the port is registered;
  * ``retrain.json`` of the port is the JAX driver's, and the JAX loader
    reads it.
"""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu import checkpoint as jckpt
from photon_ml_tpu import retrain as jretrain
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.algorithm.fixed_effect import FixedEffectCoordinate as JFixed
from photon_ml_tpu.algorithm.random_effect import RandomEffectCoordinate as JRandom
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.resilience import DivergenceGuard as JGuard
from photon_ml_tpu.resilience import faults as jfaults
from photon_ml_tpu.resilience import preemption as jpreemption
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.checkpoint_async import AsyncCheckpointer
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.resilience import DivergenceGuard, faults, preemption, sites
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_game_drivers import COMMON_FLAGS, game_avro_dirs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FE_CFG, RE_CFG = JConfig(max_iterations=25, tolerance=1e-9), JConfig(max_iterations=30, tolerance=1e-8)
FE_REG, RE_REG = JReg.l2(0.05), JReg.l2(0.1)
ITERS = 2  # x 2 coordinates = 4 steps


@pytest.fixture(autouse=True)
def _clean_preemption_state():
    """The preemption flag, poll counters and fault plans are process-wide."""
    for mod in (preemption, jpreemption):
        mod.reset()
    for mod in (faults, jfaults):
        mod.clear()
    yield
    for mod in (preemption, jpreemption):
        mod.reset()
    for mod in (faults, jfaults):
        mod.clear()


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(20260803), num_users=16,
                              rows_per_user_range=(4, 18), d_fixed=4, d_random=3)
    port = tgame.GameData(
        response=data.response, offset=data.offset, weight=data.weight,
        ids=dict(data.ids), id_vocabs=dict(data.id_vocabs),
        shards={k: tgame.HostFeatures(f.indptr, f.indices, f.values, f.dim)
                for k, f in data.shards.items()},
    )
    return data, port


def _cd(glmix, spec="off", guard=None):
    _, data = glmix
    coords = {
        "fixed": FixedEffectCoordinate(
            tgame.build_fixed_effect_batch(data, "global", device="cpu"),
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                                   interop.from_jax_numpy(FE_CFG, "cpu"),
                                   interop.from_jax_numpy(FE_REG, "cpu"))),
        "re": RandomEffectCoordinate(
            tgame.build_random_effect_dataset(data, tgame.RandomEffectDataConfig("userId", "per_user"),
                                              device="cpu"),
            TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
            interop.from_jax_numpy(RE_CFG, "cpu"), interop.from_jax_numpy(RE_REG, "cpu"),
            sparse_kernel=spec),
    }
    labels = torch.from_numpy(data.response)
    return CoordinateDescent(coords, lambda s: torch.sum(tlosses.logistic.loss(s, labels)),
                             divergence_guard=guard)


def _jax_cd(glmix, guard=None):
    data, _ = glmix
    coords = {
        "fixed": JFixed(j_fe_batch(data, "global", dense=True),
                        JProblem(JTask.LOGISTIC_REGRESSION, JOpt.LBFGS, FE_CFG, FE_REG)),
        "re": JRandom(j_build(data, JReConfig("userId", "per_user")), JTask.LOGISTIC_REGRESSION,
                      JOpt.LBFGS, RE_CFG, RE_REG, sparse_kernel="off"),
    }
    labels = jnp.asarray(data.response)
    return JCD(coords, lambda s: jnp.sum(jlosses.logistic.loss(s, labels)),
               divergence_guard=guard)


def _assert_bitwise(a, b):
    assert a.objective_history == b.objective_history
    for name, w in a.coefficients.items():
        assert torch.equal(w, b.coefficients[name]), name
    assert torch.equal(a.total_scores, b.total_scores)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_step_layout_and_meta_equal_jax(glmix, tmp_path):
    n = glmix[0].num_rows
    fp = tckpt.fingerprint({"coordinates": ["fixed", "re"], "num_rows": n})
    assert fp == jckpt.fingerprint({"coordinates": ["fixed", "re"], "num_rows": n})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_cd(glmix).run(ITERS, n, jckpt.CoordinateDescentCheckpointer(jdir, fp, keep=10))
    port = _cd(glmix).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(tdir, fp, keep=10))
    assert _tree(tdir) == _tree(jdir) == [f"step-{s}/{f}" for s in range(1, 5)
                                          for f in ("arrays.npz", "meta.json")]
    for step in range(1, 5):
        metas = []
        for d in (jdir, tdir):
            with open(os.path.join(d, f"step-{step}", "meta.json")) as f:
                metas.append(json.load(f))
            with np.load(os.path.join(d, f"step-{step}", "arrays.npz")) as npz:
                metas[-1]["arrays"] = {k: (npz[k].dtype, npz[k].shape) for k in npz.files}
        jm, tm = metas
        assert sorted(tm) == sorted(jm)
        assert tm["structure"] == jm["structure"]
        assert tm["arrays"] == jm["arrays"] and sorted(tm["checksums"]) == sorted(jm["checksums"])
        assert (tm["step"], tm["fingerprint"], tm["partial"]) == (step, fp, None)
        assert len(tm["objective_history"]) == step
    # the JAX checkpointer restores the port's latest step
    jc = _jax_cd(glmix)
    params = {k: c.initial_coefficients() for k, c in jc.coordinates.items()}
    scores = {k: jnp.zeros((n,)) for k in params}
    got = jckpt.CoordinateDescentCheckpointer(tdir, fp).restore(params, scores, jnp.zeros((n,)))
    assert got.step == 4 and got.objective_history == port.objective_history
    for name in params:
        assert np.array_equal(np.asarray(got.params[name]), port.coefficients[name].numpy())


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("stop", [1, 2, 3])
def test_resume_after_a_stop_at_any_step_is_bitwise(glmix, tmp_path, stop, spec):
    n = glmix[1].num_rows
    clean = _cd(glmix, spec).run(ITERS, n)
    ck_dir = str(tmp_path / "ckpt")
    preemption.install_plan({"cycle": stop})
    with pytest.raises(preemption.Preempted) as err:
        _cd(glmix, spec).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    assert os.path.basename(err.value.checkpoint_path) == f"step-{stop}"
    preemption.reset()
    resumed = _cd(glmix, spec).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    _assert_bitwise(clean, resumed)


def test_async_commits_equal_sync_and_the_emergency_step_is_durable(glmix, tmp_path):
    n = glmix[1].num_rows
    sync = _cd(glmix).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(str(tmp_path / "s"),
                                                                        keep=10))
    with AsyncCheckpointer(tckpt.CoordinateDescentCheckpointer(str(tmp_path / "a"), keep=10)) as ck:
        async_res = _cd(glmix).run(ITERS, n, ck)
    _assert_bitwise(sync, async_res)
    for step in range(1, 5):
        with np.load(str(tmp_path / "s" / f"step-{step}" / "arrays.npz")) as a, \
                np.load(str(tmp_path / "a" / f"step-{step}" / "arrays.npz")) as b:
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
    preemption.install_plan({"cycle": 2})
    ck = AsyncCheckpointer(tckpt.CoordinateDescentCheckpointer(str(tmp_path / "e")))
    with pytest.raises(preemption.Preempted):
        _cd(glmix).run(ITERS, n, ck)
    assert os.path.exists(str(tmp_path / "e" / "step-2" / "arrays.npz"))
    ck.close()
    preemption.reset()
    _assert_bitwise(sync, _cd(glmix).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(
        str(tmp_path / "e"))))


def test_corrupt_latest_step_falls_back_and_fingerprint_mismatch_raises(glmix, tmp_path):
    n = glmix[1].num_rows
    ck_dir = str(tmp_path / "ckpt")
    clean = _cd(glmix).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(ck_dir, "fp"))
    assert sorted(os.listdir(ck_dir)) == ["step-3", "step-4"]
    latest = os.path.join(ck_dir, "step-4", "arrays.npz")
    with open(latest, "r+b") as f:  # flip bytes inside the payload
        f.seek(os.path.getsize(latest) // 2)
        f.write(b"\xff\xfe\xfd\xfc")
    os.makedirs(os.path.join(ck_dir, ".ckpt-stale"))
    ck = tckpt.CoordinateDescentCheckpointer(ck_dir, "fp")
    assert not os.path.exists(os.path.join(ck_dir, ".ckpt-stale"))  # swept
    cd = _cd(glmix)
    params = {k: c.initial_coefficients() for k, c in cd.coordinates.items()}
    scores = {k: torch.zeros(n) for k in params}
    got = ck.restore(params, scores, torch.zeros(n))
    assert got.step == 3 and got.objective_history == clean.objective_history[:3]
    _assert_bitwise(clean, cd.run(ITERS, n, ck))  # step 4 redone from step 3
    with pytest.raises(ValueError, match="fingerprint"):
        _cd(glmix).run(ITERS, n, tckpt.CoordinateDescentCheckpointer(ck_dir, "other"))


def test_bf16_leaf_round_trips_through_its_bit_pattern(tmp_path):
    ck = tckpt.CoordinateDescentCheckpointer(str(tmp_path))
    w = torch.randn(5).to(torch.bfloat16)
    state = tckpt.CheckpointState(3, {"a": w}, {"a": torch.zeros(2)}, torch.zeros(2), [1.0], [])
    ck.save(state)
    with open(tmp_path / "step-3" / "meta.json") as f:
        assert json.load(f)["dtypes"] == {"params.0": "bfloat16"}
    got = ck.restore({"a": torch.zeros(5, dtype=torch.bfloat16)}, {"a": torch.zeros(2)},
                     torch.zeros(2))
    assert got.params["a"].dtype == torch.bfloat16 and torch.equal(got.params["a"], w)


def test_divergence_guard_rolls_back_as_the_jax_guard_does(glmix):
    n = glmix[1].num_rows
    plan = "optim.step:at=2,kind=nan"
    with faults.fault_scope(faults.parse_fault_env(plan)):
        got = _cd(glmix, guard=DivergenceGuard()).run(ITERS, n)
    with jfaults.fault_scope(jfaults.parse_fault_env(plan)):
        want = _jax_cd(glmix, guard=JGuard()).run(ITERS, n)
    assert [(e.coordinate, e.step, e.action) for e in got.guard_events] == \
        [(e.coordinate, e.step, e.action) for e in want.guard_events] == [("re", 2, "rollback")]
    assert all(np.isfinite(got.objective_history)) and len(got.objective_history) == 4
    with faults.fault_scope(faults.parse_fault_env(plan)):
        skipped = _cd(glmix, guard=DivergenceGuard(mode="skip_cycle")).run(ITERS, n)
    assert [e.action for e in skipped.guard_events] == ["skip_cycle"]


def _quickstart(train_dir, val_dir, out, ckpt, *extra):
    return ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
            "--output-dir", out, "--checkpoint-dir", ckpt, "--evaluator-type", "AUC",
            "--num-iterations", "2", *COMMON_FLAGS, *extra]


def _model_bytes(out):
    best = os.path.join(out, "best")
    return {p: open(os.path.join(best, p), "rb").read() for p in _tree(best)}


@pytest.fixture(scope="module")
def clean_driver_run(game_avro_dirs, tmp_path_factory):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    base = tmp_path_factory.mktemp("ckpt-driver")
    out = str(base / "clean")
    tdriver.main(_quickstart(train_dir, val_dir, out, str(base / "clean-ckpt"), "--device", "cpu"))
    return _model_bytes(out)


@pytest.mark.parametrize("async_", ["false", "true"])
def test_max_restarts_relaunch_in_process_like_the_jax_driver(game_avro_dirs, clean_driver_run,  # noqa: F811
                                                             tmp_path, monkeypatch, async_):
    train_dir, val_dir, _ = game_avro_dirs
    monkeypatch.setenv("PHOTON_PREEMPT_AT", "cycle:2")
    argv = _quickstart(train_dir, val_dir, str(tmp_path / "out"), str(tmp_path / "ck"),
                       "--max-restarts", "1", "--checkpoint-async", async_)
    driver = tdriver.main(argv + ["--device", "cpu"])
    assert _model_bytes(str(tmp_path / "out")) == clean_driver_run
    assert len(driver.results[0][1].objective_history) == 4
    jd = jdriver.main(_quickstart(train_dir, val_dir, str(tmp_path / "jout"),
                                  str(tmp_path / "jck"), "--max-restarts", "1",
                                  "--checkpoint-async", async_))
    assert len(jd.results[0][1].objective_history) == 4
    # without a restart budget both drivers exit with the preemption code
    for mod, extra in ((tdriver, ["--device", "cpu"]), (jdriver, [])):
        for pre in (preemption, jpreemption):
            pre.reset()
        with pytest.raises(SystemExit) as err:
            mod.main(_quickstart(train_dir, val_dir, str(tmp_path / f"x-{mod.__name__}"),
                                 str(tmp_path / f"xck-{mod.__name__}"),
                                 "--delete-output-dir-if-exists", "true") + extra)
        assert err.value.code == preemption.PREEMPT_EXIT_CODE == jpreemption.PREEMPT_EXIT_CODE


def test_a_preempted_subprocess_exits_75_and_its_rerun_resumes(game_avro_dirs, clean_driver_run,  # noqa: F811
                                                              tmp_path):
    train_dir, val_dir, _ = game_avro_dirs
    argv = _quickstart(train_dir, val_dir, str(tmp_path / "out"), str(tmp_path / "ck"),
                       "--device", "cpu")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PHOTON_PREEMPT_AT"] = "cycle:3"
    proc = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
                           *argv], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert "step-3" in proc.stderr and sorted(os.listdir(tmp_path / "ck" / "combo-0")) == [
        "step-2", "step-3"]
    tdriver.main(argv)  # the rerun resumes from step 3 (the output dir is cleared)
    assert _model_bytes(str(tmp_path / "out")) == clean_driver_run


def test_a_resume_takes_the_recorded_race_winners_and_refuses_others(game_avro_dirs,  # noqa: F811
                                                                     tmp_path, monkeypatch):
    """Under ``PHOTON_SPARSE_KERNEL=auto`` the driver keeps its race winners
    beside the steps (``races.json``, also in the fingerprint): a resumed
    run takes them and races nothing, and ends bitwise where a run forced
    to the recorded family ends; a resume whose winners differ is refused."""
    import shutil

    from photon_ml_tpu_torch.ops import fused_glm as tfg
    from photon_ml_tpu_torch.ops import fused_sparse as tfs

    train_dir, val_dir, _ = game_avro_dirs
    argv = _quickstart(train_dir, val_dir, str(tmp_path / "out"), str(tmp_path / "ck"),
                       "--device", "cpu")
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "auto")
    monkeypatch.setattr(tfs, "_race_cache", {})
    monkeypatch.setattr(tfs, "_race_reports", {})
    monkeypatch.setenv("PHOTON_PREEMPT_AT", "cycle:2")
    with pytest.raises(SystemExit):
        tdriver.main(argv)
    monkeypatch.delenv("PHOTON_PREEMPT_AT")
    with open(tmp_path / "ck" / tdriver.RACES_FILE) as f:
        (race, key, winner), = json.load(f)
    assert race == "sparse" and key[-2:] == ["cpu", None]
    shutil.copytree(tmp_path / "ck", tmp_path / "ck-other")

    monkeypatch.setattr(tfs, "_race_cache", {})
    monkeypatch.setattr(tfs, "race_sparse_kernels", lambda *a, **kw: pytest.fail("raced"))
    preemption.reset()
    resumed = tdriver.main(argv)
    assert len(resumed.results[0][1].objective_history) == 4
    assert resumed.combo_coords[0]["per-user"].slab is None if winner is None else (
        resumed.combo_coords[0]["per-user"].slab.kernel == winner)
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", winner or "off")
    tdriver.main(_quickstart(train_dir, val_dir, str(tmp_path / "forced"),
                             str(tmp_path / "ck-forced"), "--device", "cpu"))
    assert _model_bytes(str(tmp_path / "out")) == _model_bytes(str(tmp_path / "forced"))

    # another winner in the record: the fingerprint no longer matches
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "auto")
    monkeypatch.setattr(tfs, "_race_cache", {})
    with open(tmp_path / "ck-other" / tdriver.RACES_FILE, "w") as f:
        json.dump([[race, key, "segment" if winner is None else None]], f)
    with pytest.raises(ValueError, match="fingerprint"):
        tdriver.main(_quickstart(train_dir, val_dir, str(tmp_path / "out-other"),
                                 str(tmp_path / "ck-other"), "--device", "cpu"))
    assert tfg.race_log  # the decisions were logged


def _site_literals():
    """(kind, literal) of every faults.inject/corrupt/flag and
    preemption.check call in the port."""
    found = []
    for root, _, files in os.walk(os.path.join(REPO, "photon_ml_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name) and node.args):
                    continue
                owner, attr = node.func.value.id, node.func.attr
                kind = ("fault" if owner == "faults" and attr in ("inject", "corrupt", "flag")
                        else "preempt" if owner == "preemption" and attr == "check" else None)
                if kind is not None:
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), f"{name}: a site must be a literal"
                    found.append((kind, arg.value))
    return found


def test_every_site_literal_is_registered_and_every_entry_used():
    found = _site_literals()
    fault = {s for k, s in found if k == "fault"}
    preempt = {s for k, s in found if k == "preempt"}
    assert fault == set(sites.FAULT_SITES)
    assert preempt == set(sites.PREEMPT_SITES)


def test_retrain_json_is_the_jax_drivers_and_the_jax_loader_reads_it(game_avro_dirs, tmp_path):  # noqa: F811
    train_dir, val_dir, _ = game_avro_dirs
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    flags = ["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
             "--evaluator-type", "AUC", "--num-iterations", "1", *COMMON_FLAGS]
    jdriver.main(flags + ["--output-dir", outs["jax"]])
    tdriver.main(flags + ["--output-dir", outs["port"], "--device", "cpu"])
    loaded = {k: json.load(open(os.path.join(v, "retrain.json"))) for k, v in outs.items()}
    for k, v in outs.items():
        assert loaded[k]["output_dir"] == os.path.abspath(v)
        assert loaded[k]["model_dir"] == os.path.abspath(os.path.join(v, "best"))
        del loaded[k]["output_dir"], loaded[k]["model_dir"]
    assert loaded["port"] == loaded["jax"]
    prior = jretrain.load_prior_manifest(outs["port"])
    assert prior.model_dir == os.path.join(os.path.abspath(outs["port"]), "best")
    assert sorted(prior.coordinates) == ["fixed", "per-user"]
    assert prior.coordinates["fixed"].kind == "fixed"
