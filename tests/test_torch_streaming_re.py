"""The port's streaming random effect against the JAX package (CPU):

  * ``plan_entity_blocks`` and the written blocks and manifest equal the
    JAX package's for the same counts and budget (ladder off and on);
  * the streaming descent against the port's in-memory descent and
    against the JAX streaming descent, at ``solver``; the entity export
    (means and variances) against the plain coordinate;
  * the state spilled to disk between updates; the pipelined block loop
    bitwise equal to the synchronous one; per-block compaction bitwise
    equal to the one-shot streaming solve; a ``"block"`` preemption
    resumed bitwise; a ``SpilledREState`` checkpointed by reference, and a
    vanished spill dir rejected (restore falls back);
  * the GAME driver with ``--streaming-random-effects`` and
    ``--re-memory-budget-mb`` against the JAX driver, and a warm
    ``--tensor-cache`` run that never calls ``read_game_data``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.algorithm.streaming_random_effect import (
    StreamingRandomEffectCoordinate as JStreaming,
    plan_entity_blocks as j_plan,
    write_re_entity_blocks as j_write,
)
from photon_ml_tpu.algorithm import CoordinateDescent as JCD
from photon_ml_tpu.cli import game_training_driver as jdriver
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
    SpilledREState,
    StreamingRandomEffectCoordinate,
    StreamingREManifest,
    plan_entity_blocks,
    write_re_entity_blocks,
)
from photon_ml_tpu_torch.cli import game_training_driver as tdriver
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.io import avro_data, model_io as tmodel_io
from photon_ml_tpu_torch.io.tensor_cache import TensorCache
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.scheduler import SolveSchedule
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_game_drivers import game_avro_dirs  # noqa: F401
from test_torch_game import _port_data
from test_torch_game_driver import _argv
from tolerances import assert_allclose

TOL = 1e-4  # a decided stopping step in f32 (see tests/test_torch_tron.py)
ITERS = 20
LAMBDA = 0.3
BLOCK = 16
JCFG = JReConfig("userId", "per_user")
TCFG = tgame.RandomEffectDataConfig("userId", "per_user")
FIELDS = tgame.RandomEffectDataset.TENSOR_FIELDS


@pytest.fixture(scope="module")
def glmix():
    jdata, _ = make_glmix_data(np.random.default_rng(41), num_users=60,
                               rows_per_user_range=(4, 24), d_fixed=4, d_random=3)
    resid = (np.random.default_rng(6).normal(size=jdata.num_rows) * 0.3).astype(np.float32)
    return jdata, _port_data(jdata), resid


@pytest.fixture(scope="module")
def manifest(glmix, tmp_path_factory):
    _, tdata, _ = glmix
    return write_re_entity_blocks(tdata, TCFG, str(tmp_path_factory.mktemp("blocks")),
                                  block_entities=BLOCK)


def _port(manifest, optimizer="LBFGS", spec="off", **kw):
    kw.setdefault("state_root", None)
    return StreamingRandomEffectCoordinate(
        manifest, TaskType.LOGISTIC_REGRESSION, OptimizerType[optimizer],
        OptimizerConfig(max_iterations=ITERS, tolerance=TOL), RegularizationContext.l2(LAMBDA),
        sparse_kernel=spec, device="cpu", **kw)


def _descent(coord, tdata):
    labels = torch.from_numpy(tdata.response)
    return CoordinateDescent({"per-user": coord},
                             lambda s: torch.sum(tlosses.logistic.loss(s, labels)))


def _spilled(state):
    return [state.block(i) for i in range(len(state.shapes))]


@pytest.mark.parametrize("kw", [dict(block_entities=7), dict(block_entities=100),
                                dict(memory_budget_bytes=4000),
                                dict(memory_budget_bytes=60000, active_upper_bound=5)],
                         ids=["7-a-block", "100-a-block", "budget", "budget-capped"])
def test_plan_entity_blocks_matches_jax(glmix, kw):
    jdata, _, _ = glmix
    counts = np.bincount(jdata.ids["userId"])
    got = plan_entity_blocks(counts, global_dim=3, **kw)
    want = j_plan(counts, global_dim=3, **kw)
    assert [b.tolist() for b in got] == [b.tolist() for b in want]
    assert sorted(np.concatenate(got).tolist()) == list(range(60))


@pytest.mark.parametrize("ladder", ["off", "8:2"])
@pytest.mark.parametrize("sizing", ["entities", "budget"])
def test_blocks_and_manifest_equal_jax(glmix, tmp_path, ladder, sizing):
    jdata, tdata, _ = glmix
    # the ladder pads the x-stacks the budget is checked on
    sizing = (dict(block_entities=BLOCK) if sizing == "entities"
              else dict(memory_budget_bytes=6000 if ladder == "off" else 26000))
    jm = j_write(jdata, JCFG, str(tmp_path / "jax"), bucketer=ladder, **sizing)
    tm = write_re_entity_blocks(tdata, TCFG, str(tmp_path / "port"), bucketer=ladder, **sizing)
    with open(os.path.join(jm.dir, "manifest.json")) as f, \
            open(os.path.join(tm.dir, "manifest.json")) as g:
        assert json.load(g) == json.load(f)
    assert tm.max_block_bytes == jm.max_block_bytes and len(tm.blocks) >= 1
    for b in tm.blocks:
        with np.load(os.path.join(jm.dir, b["file"])) as zj, \
                np.load(os.path.join(tm.dir, b["file"])) as zt:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype and zt[k].tobytes() == zj[k].tobytes(), k


def test_a_budget_one_entity_cannot_fit_raises_as_in_jax(glmix, tmp_path):
    jdata, tdata, _ = glmix
    with pytest.raises(ValueError) as want:
        j_write(jdata, JCFG, str(tmp_path / "jax"), memory_budget_bytes=6000, bucketer="8:2")
    with pytest.raises(ValueError) as got:
        write_re_entity_blocks(tdata, TCFG, str(tmp_path / "port"), memory_budget_bytes=6000,
                               bucketer="8:2")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def jax_streamed(glmix, tmp_path_factory):
    """The JAX streaming coordinate's two-cycle descent, per optimizer."""
    jdata, _, _ = glmix
    jm = j_write(jdata, JCFG, str(tmp_path_factory.mktemp("jblocks")), block_entities=BLOCK)
    labels = jnp.asarray(jdata.response)
    out = {}
    for opt in ("LBFGS", "TRON"):
        coord = JStreaming(jm, JTask.LOGISTIC_REGRESSION, JOpt[opt],
                           JConfig(max_iterations=ITERS, tolerance=TOL), JReg.l2(LAMBDA),
                           prefetch_depth=0)
        out[opt] = JCD({"per-user": coord},
                       lambda s: jnp.sum(jlosses.logistic.loss(s, labels))).run(
            2, jdata.num_rows)
    return out


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_streaming_descent_matches_jax_and_in_memory(glmix, manifest, jax_streamed, optimizer,
                                                     spec):
    _, tdata, _ = glmix
    n = tdata.num_rows
    got = _descent(_port(manifest, optimizer, spec), tdata).run(2, n)
    want = jax_streamed[optimizer]
    assert_allclose(got.objective_history, want.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(got.total_scores.numpy(), np.asarray(want.total_scores), kind="solver")
    plain = RandomEffectCoordinate(
        tgame.build_random_effect_dataset(tdata, TCFG, device="cpu"),
        TaskType.LOGISTIC_REGRESSION, OptimizerType[optimizer],
        OptimizerConfig(max_iterations=ITERS, tolerance=TOL), RegularizationContext.l2(LAMBDA))
    in_memory = _descent(plain, tdata).run(2, n)
    assert_allclose(got.objective_history, in_memory.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(got.total_scores.numpy(), in_memory.total_scores.numpy(), kind="solver")


def test_entity_export_matches_plain_and_state_is_on_disk(glmix, manifest):
    _, tdata, resid = glmix
    coord = _port(manifest)
    init = coord.initial_coefficients()
    assert not os.path.exists(init.dir)  # the initial state costs no I/O
    state, results = coord.update(torch.from_numpy(resid), init)
    assert isinstance(state, SpilledREState) and len(results) == len(manifest.blocks)
    files = sorted(os.listdir(state.dir))
    assert files == [f"coefs-{i:05d}.npy" for i in range(len(manifest.blocks))]
    second, _ = coord.update(torch.from_numpy(resid), state)
    third, _ = coord.update(torch.from_numpy(resid), second)
    # the previous epoch survives (descent may still read it), older ones go
    assert os.path.isdir(second.dir) and not os.path.exists(state.dir)
    assert third.dir != second.dir

    plain = RandomEffectCoordinate(
        tgame.build_random_effect_dataset(tdata, TCFG, device="cpu"),
        TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
        OptimizerConfig(max_iterations=ITERS, tolerance=TOL), RegularizationContext.l2(LAMBDA))
    pw, _ = plain.update(torch.from_numpy(resid), plain.initial_coefficients())
    first = _port(manifest)
    fstate, _ = first.update(torch.from_numpy(resid), first.initial_coefficients())
    means, variances = first.entity_export_by_raw_id(fstate, torch.from_numpy(resid))
    pos = np.full(len(tdata.id_vocabs["userId"]), -1)
    ep = plain.dataset.entity_pos.numpy()
    pos[tdata.ids["userId"][ep >= 0]] = ep[ep >= 0]
    pg = plain.global_coefficients(pw).numpy()
    pvar = tgame.RandomEffectDataset  # noqa: F841 — the plain variances below
    var_stack = plain.global_coefficients(
        plain.coefficient_variances(pw, torch.from_numpy(resid))).numpy()
    assert sorted(means) == sorted(tdata.id_vocabs["userId"]) == sorted(variances)
    for vi, raw in enumerate(tdata.id_vocabs["userId"]):
        assert_allclose(means[raw], pg[pos[vi]], kind="solver")
        assert_allclose(variances[raw], var_stack[pos[vi]], kind="solver")
    assert first.entity_export_by_raw_id(fstate)[1] is None
    # the validation layout: concatenated block stacks
    stacks = first.global_coefficient_stacks(fstate)
    assert [s.shape[0] for s in stacks] == first.stack_sizes()
    block_of, pos_in = first.vocab_position_maps()
    for vi, raw in enumerate(tdata.id_vocabs["userId"]):
        assert np.array_equal(stacks[block_of[vi]][pos_in[vi]].numpy(), means[raw])


@pytest.mark.parametrize("spec", ["off", "pallas"])
def test_pipelined_is_bitwise_synchronous(glmix, manifest, spec):
    _, tdata, resid = glmix
    outs = []
    for depth in (0, 1, 3):
        coord = _port(manifest, spec=spec, prefetch_depth=depth)
        state, _ = coord.update(torch.from_numpy(resid), coord.initial_coefficients())
        outs.append((_spilled(state), coord.score(state)))
    for blocks, score in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(blocks, outs[0][0]))
        assert torch.equal(score, outs[0][1])


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_per_block_compaction_is_bitwise_one_shot(glmix, manifest, optimizer, spec):
    _, tdata, resid = glmix
    outs = []
    for schedule in (None, SolveSchedule(3), SolveSchedule(2, loop="device")):
        coord = _port(manifest, optimizer, spec, solve_schedule=schedule)
        state, results = coord.update(torch.from_numpy(resid), coord.initial_coefficients())
        outs.append((_spilled(state), results))
    for blocks, results in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(blocks, outs[0][0]))
        for r, r0 in zip(results, outs[0][1]):
            for a, b in zip(r, r0):
                assert (a is None and b is None) or torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("schedule", [None, "chunk"])
def test_block_preemption_resumes_bitwise(glmix, manifest, tmp_path, schedule):
    _, tdata, _ = glmix
    n = tdata.num_rows
    sched = SolveSchedule(3) if schedule else None
    clean = _descent(_port(manifest, solve_schedule=sched), tdata).run(2, n)
    ck_dir = str(tmp_path / "ckpt")
    preemption.install_plan({"block": 2} if schedule is None else {"chunk": 3})
    try:
        with pytest.raises(preemption.Preempted) as err:
            _descent(_port(manifest, solve_schedule=sched), tdata).run(
                2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    finally:
        preemption.reset()
    assert err.value.site == ("block" if schedule is None else "chunk")
    assert err.value.partial["meta"]["kind"] == "streaming_re"
    resumed = _descent(_port(manifest, solve_schedule=sched), tdata).run(
        2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    assert resumed.objective_history == clean.objective_history
    assert torch.equal(resumed.total_scores, clean.total_scores)
    got, want = resumed.coefficients["per-user"], clean.coefficients["per-user"]
    assert all(np.array_equal(a, b) for a, b in zip(_spilled(got), _spilled(want)))


def test_a_block_boundary_drain_leaves_no_prefetch_worker(glmix, manifest):
    """A preemption at a block boundary unwinds out of the block loop: the
    pipeline is closed and its worker joined before the exception leaves
    the update."""
    import threading

    _, tdata, resid = glmix
    coord = _port(manifest, prefetch_depth=2)
    preemption.install_plan({"block": 1})
    try:
        with pytest.raises(preemption.Preempted):
            coord.update(torch.from_numpy(resid), coord.initial_coefficients())
    finally:
        preemption.reset()
    assert not [t for t in threading.enumerate() if t.name == "re-block-prefetch"]


def test_spilled_state_checkpoints_by_reference(glmix, manifest, tmp_path):
    _, tdata, resid = glmix
    coord = _port(manifest)
    state, _ = coord.update(torch.from_numpy(resid), coord.initial_coefficients())
    ck = tckpt.CoordinateDescentCheckpointer(str(tmp_path / "ck"))
    total = torch.zeros(tdata.num_rows)
    for step in (1, 2):
        ck.save(tckpt.CheckpointState(step=step, params={"per-user": state},
                                      scores={"per-user": total}, total_scores=total,
                                      objective_history=[1.0] * step, validation_history=[]))
    with open(os.path.join(ck.directory, "step-2", "meta.json")) as f:
        meta = json.load(f)
    ref = meta["structure"]["params"]["refs"]["0"]
    assert ref == {"kind": "spilled_re_state", "dir": state.dir,
                   "shapes": [list(s) for s in state.shapes], "written": True}
    assert meta["structure"]["params"]["treedef"] == "PyTreeDef({'per-user': *})"
    template = coord.initial_coefficients()
    restored = ck.restore({"per-user": template}, {"per-user": total}, total)
    assert restored.step == 2
    got = restored.params["per-user"]
    assert isinstance(got, SpilledREState) and got.dir == state.dir
    assert all(np.array_equal(a, b) for a, b in zip(_spilled(got), _spilled(state)))
    # step 1 refers to the same dir; a step whose ref still resolves serves,
    # and once the dir is gone every step is refused, never zeros
    import shutil

    shutil.rmtree(state.dir)
    with pytest.raises(tckpt.CheckpointRefError, match="no longer exists"):
        template.__checkpoint_from_ref__(ref)
    assert ck.restore({"per-user": template}, {"per-user": total}, total) is None
    # a ref of other block shapes is refused too
    other = SpilledREState(dir=str(tmp_path / "x"), shapes=[(1, 1)])
    with pytest.raises(tckpt.CheckpointRefError, match="do not match"):
        other.__checkpoint_from_ref__(dict(ref, written=False))


@pytest.mark.parametrize("field", ["frozen_blocks", "elastic", "initial_epoch"])
def test_unported_hooks_raise(manifest, field):
    if field == "frozen_blocks":
        # the delta retrain's skip set is ported (tests/test_torch_retrain.py
        # holds what it does); a block index outside the manifest is refused
        assert _port(manifest, frozen_blocks=frozenset({0})).frozen_blocks == {0}
        with pytest.raises(ValueError, match="out of range"):
            _port(manifest, frozen_blocks=frozenset({len(manifest.blocks)}))
        return
    # the re-plan hooks run now (tests/test_torch_elastic.py holds the
    # protocol): a pending proposal drains at update entry, and an epoch
    # floor numbers the first update's spill above it
    from photon_ml_tpu_torch.parallel.elastic import ReplanRequired

    class _Pending:
        def poll(self, step=None, force=False):
            return {"version": 2, "hosts": [0], "binding": {"0": 0}, "reason": "stub"}

    resid = torch.zeros(manifest.num_rows)
    if field == "elastic":
        coord = _port(manifest, elastic=_Pending())
        with pytest.raises(ReplanRequired, match="update entry") as err:
            coord.update(resid, coord.initial_coefficients())
        assert err.value.partial is None and err.value.proposal["version"] == 2
        return
    coord = _port(manifest, initial_epoch=2)
    state, _ = coord.update(resid, coord.initial_coefficients())
    assert os.path.basename(state.dir) == "epoch-3"
    assert coord.replan_state_dirs() == [coord.initial_coefficients().dir, state.dir]


# ---------------------------------------------------------------------------
# the GAME driver
# ---------------------------------------------------------------------------

BUDGET = ["--re-memory-budget-mb", "0.004"]


@pytest.fixture(scope="module")
def jax_streaming_runs(game_avro_dirs):  # noqa: F811
    train_dir, val_dir, base = game_avro_dirs
    return {opt: jdriver.main(_argv(train_dir, val_dir, os.path.join(base, f"jax-stream-{opt}"),
                                    opt) + BUDGET) for opt in ("LBFGS", "TRON")}


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_driver_streaming_matches_jax_driver(game_avro_dirs, jax_streaming_runs, tmp_path,  # noqa: F811
                                             optimizer):
    train_dir, val_dir, _ = game_avro_dirs
    jd = jax_streaming_runs[optimizer]
    out = str(tmp_path / "port")
    td = tdriver.main(_argv(train_dir, val_dir, out, optimizer) + BUDGET + ["--device", "cpu"])
    tm, jm = td.streaming_manifests["per-user"], jd.streaming_manifests["per-user"]
    assert len(tm.blocks) == len(jm.blocks) >= 2
    assert [b["num_entities"] for b in tm.blocks] == [b["num_entities"] for b in jm.blocks]
    (_, jres, jmetrics), (_, tres, tmetrics) = jd.results[0], td.results[0]
    assert_allclose(tres.objective_history, jres.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(tmetrics["AUC"], jmetrics["AUC"], kind="solver", dtype=np.float32)
    assert_allclose(tres.total_scores.numpy(), np.asarray(jres.total_scores), kind="solver")
    imap = td.shard_index_maps["per_user"]
    t_re = tmodel_io.load_random_effect(os.path.join(out, "best"), "per-user", imap)[0]
    j_re = tmodel_io.load_random_effect(os.path.join(jd.params.output_dir, "best"), "per-user",
                                        imap)[0]
    assert sorted(t_re) == sorted(j_re)
    with open(os.path.join(out, "retrain.json")) as f:
        rec = json.load(f)["coordinates"]["per-user"]
    assert rec["kind"] == "streaming_random"
    assert rec["streaming_manifest_dir"] == os.path.abspath(tm.dir)


@pytest.mark.parametrize("streaming", [False, True], ids=["in-memory", "streaming"])
def test_driver_warm_tensor_cache_never_reads_avro(game_avro_dirs, tmp_path, monkeypatch,  # noqa: F811
                                                   streaming):
    train_dir, val_dir, _ = game_avro_dirs
    extra = ["--device", "cpu", "--tensor-cache", str(tmp_path / "cache")]
    if streaming:
        extra += BUDGET
    cold = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "cold"), "LBFGS") + extra)
    real = avro_data.read_game_data
    calls = []

    def counted(files, *a, **kw):
        calls.append(list(files))
        return real(files, *a, **kw)

    monkeypatch.setattr(avro_data, "read_game_data", counted)
    warm = tdriver.main(_argv(train_dir, val_dir, str(tmp_path / "warm"), "LBFGS") + extra)
    # the warm run reads only the validation files
    train_files = tdriver._input_files([train_dir])
    assert all(set(c).isdisjoint(train_files) for c in calls) and len(calls) == 1
    assert warm.results[0][1].objective_history == cold.results[0][1].objective_history

    def tree_bytes(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
        return out

    assert tree_bytes(str(tmp_path / "warm" / "best")) == tree_bytes(str(tmp_path / "cold" / "best"))
    with open(tmp_path / "warm" / "retrain.json") as f:
        rec = json.load(f)
    assert rec["data_cache_key"] == cold._data_cache_key
    key = rec["coordinates"]["per-user"]["cache_key"]
    assert TensorCache(str(tmp_path / "cache")).has(key)
