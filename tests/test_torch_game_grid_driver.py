"""The port's GAME drivers on the rest of the reference surface against the
JAX drivers (CPU), on the Avro fixture of tests/test_game_drivers.py:

  * a ';'-separated lambda grid with ``--model-output-mode ALL``: the same
    best combo, every combo's objectives and models at the ``solver``
    tolerance of tests/tolerances.py;
  * ``--vmapped-grid true`` (``run_grid``) byte-equal to the port's own
    per-combo run, and the blocker lines the JAX driver logs;
  * down-sampling and Pearson selection through the driver;
  * a factored coordinate: the latent layout byte-equal for equal arrays,
    a round trip to the same ``FactoredState``, each package scoring the
    other's model (device against host oracle at ``elementwise``), resume
    after a preemption bitwise with the JAX checkpoint structure, and
    ``retrain.json`` with the kind ``factored`` equal to the JAX driver's.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import game_scoring_driver as jscoring
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch.algorithm.factored_random_effect import FactoredState
from photon_ml_tpu_torch.cli import game_scoring_driver as tscoring
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.io import model_io as tmodel_io
from photon_ml_tpu_torch.io.index_map import IndexMap
from photon_ml_tpu_torch.resilience import preemption
from test_game_drivers import COMMON_FLAGS, game_avro_dirs  # noqa: F401
from tolerances import assert_allclose

GRID = "fixed:50,1e-7,0.01,1,LBFGS,L2;fixed:50,1e-7,1,1,LBFGS,L2;fixed:50,1e-7,1000,1,LBFGS,L2"
FACTORED = "per-user:20,1e-6,0.1,1,LBFGS,L2:20,1e-6,0.1,1,LBFGS,L2:2,2"
SECTIONS = ["--feature-shard-id-to-feature-section-keys-map",
            "global:fixedFeatures|per_user:userFeatures"]


@pytest.fixture(autouse=True)
def _clean_preemption_state():
    preemption.reset()
    yield
    preemption.reset()


def _flags(dirs, swap=(), drop=(), extra=()):
    train_dir, val_dir, _ = dirs
    flags = list(COMMON_FLAGS)
    for flag, value in swap:
        flags[flags.index(flag) + 1] = value
    for flag in drop:
        i = flags.index(flag)
        del flags[i:i + 2]
    return (["--train-input-dirs", train_dir, "--validate-input-dirs", val_dir,
             "--evaluator-type", "AUC", "--num-iterations", "2"] + flags + list(extra))


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _log(out):
    with open(os.path.join(out, "photon-ml-tpu-game.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def grid_runs(game_avro_dirs, tmp_path_factory):  # noqa: F811
    base = tmp_path_factory.mktemp("grid")
    argv = _flags(game_avro_dirs, swap=[("--fixed-effect-optimization-configurations", GRID)],
                  extra=["--model-output-mode", "ALL"])
    runs = {}
    for label, mod, extra in (("jax", jdriver, []), ("port", tdriver, ["--device", "cpu"]),
                              ("port-grid", tdriver,
                               ["--device", "cpu", "--vmapped-grid", "true"])):
        out = str(base / label)
        runs[label] = (mod.main(argv + extra + ["--output-dir", out]), out)
    return runs


def test_grid_with_all_output_matches_the_jax_driver(grid_runs):
    (jd, jout), (td, tout) = grid_runs["jax"], grid_runs["port"]
    assert len(td.results) == len(jd.results) == 3
    assert td.best_index == jd.best_index
    aucs = [m["AUC"] for _, _, m in td.results]
    assert td.best_index == int(np.argmax(aucs)) and aucs[0] > aucs[2] + 0.01
    for (_, tres, tm), (_, jres, jm) in zip(td.results, jd.results):
        assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                        dtype=np.float32)
        assert_allclose(tm["AUC"], jm["AUC"], kind="solver", dtype=np.float32)
    assert sorted(_tree_bytes(tout)) == sorted(_tree_bytes(jout))
    maps = jd.shard_index_maps
    for sub in ["best"] + [os.path.join("all", str(i)) for i in range(3)]:
        fe_t = tmodel_io.load_fixed_effect(os.path.join(tout, sub), "fixed", maps["global"])[0]
        fe_j = jmodel_io.load_fixed_effect(os.path.join(jout, sub), "fixed", maps["global"])[0]
        assert_allclose(fe_t, fe_j, kind="solver")
        re_t = tmodel_io.load_random_effect(os.path.join(tout, sub), "per-user", maps["per_user"])[0]
        re_j = jmodel_io.load_random_effect(os.path.join(jout, sub), "per-user", maps["per_user"])[0]
        assert sorted(re_t) == sorted(re_j)
        for eid in re_j:
            assert_allclose(re_t[eid], re_j[eid], kind="solver")


def test_vmapped_grid_is_byte_equal_to_the_per_combo_run(grid_runs):
    (td, tout), (gd, gout) = grid_runs["port"], grid_runs["port-grid"]
    assert gd.best_index == td.best_index
    want, got = _tree_bytes(tout), _tree_bytes(gout)
    models = sorted(k for k in want if k.startswith(("best", "all")))
    assert models and models == sorted(k for k in got if k.startswith(("best", "all")))
    for k in models:
        assert got[k] == want[k], k
    for (_, gres, gm), (_, tres, tm) in zip(gd.results, td.results):
        assert gres.objective_history == tres.objective_history
        assert gm == tm and list(gres.timings) == ["(grid)"]
    assert "shared-compile-grid" in gd.timer.totals
    assert "--vmapped-grid: training through the shared-compile grid" in _log(gout)


BLOCKERS = {
    "single combo": ([], [], "grid has a single combo"),
    "beyond lambda": ([("--fixed-effect-optimization-configurations",
                        "fixed:50,1e-7,0.01,1,LBFGS,L2;fixed:15,1e-5,0.01,1,TRON,L2")], [],
                      "combos vary beyond lambda for coordinate 'fixed'"),
    "variance": ([("--fixed-effect-optimization-configurations", GRID)],
                 ["--compute-variance", "true"],
                 "--compute-variance (save-time Hessians need per-combo statics)"),
    "guard": ([("--fixed-effect-optimization-configurations", GRID)],
              ["--divergence-guard", "rollback"],
              "--divergence-guard (per-update host gate cannot enter the compiled cycle)"),
}


@pytest.mark.parametrize("case", sorted(BLOCKERS))
def test_vmapped_grid_blockers_fall_back_with_the_jax_log_line(game_avro_dirs, tmp_path,  # noqa: F811
                                                               case):
    swap, extra, reason = BLOCKERS[case]
    argv = _flags(game_avro_dirs, swap=swap, extra=extra + ["--vmapped-grid", "true",
                                                             "--num-iterations", "1"])
    out = str(tmp_path / "port")
    td = tdriver.main(argv + ["--device", "cpu", "--output-dir", out])
    line = ("--vmapped-grid requested but falling back to the per-combo rebuild grid: "
            + reason)
    assert line in _log(out)
    assert all("(grid)" not in r.timings for _, r, _ in td.results)
    if case == "beyond lambda":  # the JAX driver logs the same line
        jout = str(tmp_path / "jax")
        jdriver.main(argv + ["--output-dir", jout])
        assert line in _log(jout)


def test_down_sampling_and_pearson_through_the_driver(game_avro_dirs, tmp_path):  # noqa: F811
    argv = _flags(game_avro_dirs, swap=[
        ("--fixed-effect-optimization-configurations", "fixed:50,1e-7,0.01,0.5,LBFGS,L2"),
        ("--random-effect-data-configurations",
         "per-user:userId,per_user,1,-1,-1,0.05,INDEX_MAP")])
    jd = jdriver.main(argv + ["--output-dir", str(tmp_path / "jax")])
    td = tdriver.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path / "port")])
    assert td.combo_coords[0]["fixed"].down_sampling_rate == 0.5
    tds, jds = td.re_datasets["per-user"], jd.re_datasets["per-user"]
    for field in ("x", "local_to_global", "feat_idx", "feat_val", "weights"):
        assert getattr(tds, field).numpy().tobytes() == np.asarray(getattr(jds, field)).tobytes()
    assert tds.local_dim < len(td.shard_index_maps["per_user"])
    (_, tres, tm), (_, jres, jm) = td.results[0], jd.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tm["AUC"], jm["AUC"], kind="solver", dtype=np.float32)


def test_latent_layout_files_are_byte_equal_and_round_trip(tmp_path):
    gen = np.random.default_rng(13)
    factors = {f"u{i}": gen.normal(size=3) for i in range(11)}
    matrix = gen.normal(size=(3, 5)).astype(np.float32)
    keys = [f"f{j}\x01" for j in range(4)] + ["(INTERCEPT)"]
    dirs = {}
    for label, io_mod, imap in (("jax", jmodel_io, JIndexMap.build(keys, False)),
                                ("port", tmodel_io, IndexMap.build(keys, False))):
        d = str(tmp_path / label)
        io_mod.save_factored_random_effect(d, "per-user", factors, matrix, "userId", "per_user",
                                           num_files=2, index_map=imap)
        io_mod.save_matrix_factorization(os.path.join(d, "mf"), "userId", "movieId",
                                         factors, {"m0": matrix[:, 0]})
        dirs[label] = d
    assert _tree_bytes(dirs["port"]) == _tree_bytes(dirs["jax"])
    for d in dirs.values():
        assert tmodel_io.is_factored_random_effect(d, "per-user")
        assert not tmodel_io.is_factored_random_effect(d, "other")
        got, mat, re_id, shard = tmodel_io.load_factored_random_effect(d, "per-user")
        assert (re_id, shard) == ("userId", "per_user") and sorted(got) == sorted(factors)
        assert all(np.array_equal(got[k], factors[k]) for k in factors)
        assert np.array_equal(mat, matrix.astype(np.float64))
        assert np.array_equal(tmodel_io.load_latent_matrix(d, "per-user"), mat)
        assert tmodel_io.load_latent_matrix_feature_keys(d, "per-user") == \
            jmodel_io.load_latent_matrix_feature_keys(d, "per-user")
        rows, cols = tmodel_io.load_matrix_factorization(os.path.join(d, "mf"), "userId", "movieId")
        assert sorted(rows) == sorted(factors) and np.array_equal(cols["m0"], matrix[:, 0])
    # realigned by name to a map in another order, as the JAX package does
    shuffled = keys[::-1] + ["new\x01"]
    got = tmodel_io.aligned_latent_matrix(dirs["port"], "per-user", IndexMap.build(shuffled, False),
                                          mat)
    want = jmodel_io.aligned_latent_matrix(dirs["jax"], "per-user",
                                           JIndexMap.build(shuffled, False), mat)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(FileNotFoundError):
        tmodel_io.load_matrix_factorization(dirs["port"], "userId", "movieId")


@pytest.fixture(scope="module")
def factored_runs(game_avro_dirs, tmp_path_factory):  # noqa: F811
    base = tmp_path_factory.mktemp("factored")
    argv = _flags(game_avro_dirs, drop=["--random-effect-optimization-configurations"],
                  extra=["--factored-random-effect-optimization-configurations", FACTORED])
    runs = {}
    for label, mod, extra in (("jax", jdriver, []), ("port", tdriver, ["--device", "cpu"])):
        out = str(base / label)
        runs[label] = (mod.main(argv + extra + ["--output-dir", out,
                                                "--checkpoint-dir", str(base / f"{label}-ck")]),
                       out, str(base / f"{label}-ck"))
    return argv, runs


def test_factored_driver_matches_jax_and_round_trips(factored_runs):
    _, runs = factored_runs
    (jd, jout, _), (td, tout, _) = runs["jax"], runs["port"]
    (_, jres, jm), (_, tres, tm) = jd.results[0], td.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tm["AUC"], jm["AUC"], kind="solver", dtype=np.float32)
    assert sorted(_tree_bytes(tout)) == sorted(_tree_bytes(jout))
    best = os.path.join(tout, "best")
    assert tmodel_io.is_factored_random_effect(best, "per-user")
    factors, matrix, re_id, shard = tmodel_io.load_factored_random_effect(best, "per-user")
    assert (re_id, shard) == ("userId", "per_user")
    state = tres.coefficients["per-user"]
    assert isinstance(state, FactoredState)
    pos = td._entity_position_of_vocab("per-user")
    v = np.zeros(tuple(state.v.shape), np.float32)
    for vi, raw in enumerate(td.train_data.id_vocabs["userId"]):
        if pos[vi] >= 0:
            v[pos[vi]] = factors[raw]
    assert v.tobytes() == state.v.numpy().tobytes()
    assert matrix.astype(np.float32).tobytes() == state.matrix.numpy().tobytes()
    coord = td.combo_coords[0]["per-user"]
    restored = FactoredState(torch.from_numpy(v), torch.from_numpy(matrix.astype(np.float32)))
    assert torch.equal(coord.score(restored), coord.score(state))
    # the flattened coefficients are V M
    flat = tmodel_io.load_random_effect(best, "per-user", td.shard_index_maps["per_user"])[0]
    want = (state.v @ state.matrix).numpy()
    for vi, raw in enumerate(td.train_data.id_vocabs["userId"]):
        assert_allclose(flat[raw], want[pos[vi]], kind="elementwise")
    jfac, jmat, _, _ = jmodel_io.load_factored_random_effect(os.path.join(jout, "best"), "per-user")
    assert_allclose(matrix, jmat, kind="solver", dtype=np.float32)


SCORERS = {"port": (tscoring, ["--device", "cpu"]), "jax": (jscoring, [])}


@pytest.mark.parametrize("scorer_pkg", ["port", "jax"])
def test_each_package_scores_the_others_factored_model(factored_runs, game_avro_dirs,  # noqa: F811
                                                       tmp_path, scorer_pkg):
    _, runs = factored_runs
    _, val_dir, _ = game_avro_dirs
    model_pkg = "jax" if scorer_pkg == "port" else "port"
    common = ["--input-dirs", val_dir, "--game-model-input-dir",
              os.path.join(runs[model_pkg][1], "best"), "--evaluator-type", "AUC",
              "--delete-output-dir-if-exists", "true"] + SECTIONS

    def score(pkg, label, *extra):
        mod, flags = SCORERS[pkg]
        return mod.main(common + flags + list(extra) + ["--output-dir", str(tmp_path / label)])

    device = score(scorer_pkg, "dev")
    host = score(scorer_pkg, "host", "--host-scoring", "true")
    own = score(model_pkg, "own")  # the model's own package, on its device path
    assert_allclose(device.scores, host.scores, kind="elementwise")
    assert_allclose(device.scores, own.scores, kind="elementwise")
    if scorer_pkg == "port":
        with open(os.path.join(str(tmp_path / "dev"), "photon-ml-tpu-scoring.log")) as f:
            assert "entities matched (device, latent-native)" in f.read()
    assert device.metrics["AUC"] > 0.6


def test_factored_checkpoint_has_the_jax_structure_and_resumes_bitwise(factored_runs,
                                                                       tmp_path, monkeypatch):
    argv, runs = factored_runs
    (_, _, jck), (_, tout, tck) = runs["jax"], runs["port"]
    metas = {}
    for label, ck in (("jax", jck), ("port", tck)):
        with open(os.path.join(ck, "combo-0", "step-4", "meta.json")) as f:
            metas[label] = json.load(f)
    assert metas["port"]["structure"] == metas["jax"]["structure"]
    assert metas["port"]["structure"]["params"]["treedef"] == (
        "PyTreeDef({'fixed': *, 'per-user': CustomNode(FactoredState[None], [*, *])})")
    for stop in (1, 3):
        monkeypatch.setenv("PHOTON_PREEMPT_AT", f"cycle:{stop}")
        preemption.reset()
        out = str(tmp_path / f"resumed-{stop}")
        td = tdriver.main(argv + ["--device", "cpu", "--output-dir", out, "--checkpoint-dir",
                                  str(tmp_path / f"ck-{stop}"), "--max-restarts", "1"])
        got, want = _tree_bytes(os.path.join(out, "best")), _tree_bytes(os.path.join(tout, "best"))
        assert got == want
        assert td.results[0][1].objective_history == runs["port"][0].results[0][1].objective_history


def test_retrain_json_records_the_factored_kind_as_the_jax_driver(factored_runs):
    _, runs = factored_runs
    loaded = {}
    for label in ("jax", "port"):
        out = runs[label][1]
        with open(os.path.join(out, "retrain.json")) as f:
            loaded[label] = json.load(f)
        assert loaded[label]["output_dir"] == os.path.abspath(out)
        del loaded[label]["output_dir"], loaded[label]["model_dir"]
    assert loaded["port"] == loaded["jax"]
    assert loaded["port"]["coordinates"]["per-user"]["kind"] == "factored"
