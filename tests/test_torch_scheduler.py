"""The port's solve scheduler (photon_ml_tpu_torch/optim/scheduler.py)
against the JAX package's (CPU):

  * ``resolve_schedule`` gives the JAX results, and raises the same errors,
    for every spelling of the JAX tests;
  * ``compacted_solve`` equals the port's one-shot solve bitwise (LBFGS,
    OWL-QN, TRON; the dense stack and the slab families ``scatter`` and
    ``pallas``, whose kernels run their plain version on the CPU), and
    matches the JAX scheduler at the ``solver`` tolerance;
  * a chunk-boundary preemption snapshot (``kind="scheduler"``, numbered
    numpy leaves) resumes bitwise on either loop, and a snapshot of another
    solver is refused;
  * the ledger records the saved lane-iterations and the host reads;
  * inside ``CoordinateDescent`` a drain at a chunk boundary lands in the
    emergency checkpoint and a rerun resumes inside the coordinate, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim import scheduler as jsched
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    entity_lane_fns,
)
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import scheduler
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve, solve_stats
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from game_test_utils import make_glmix_data
from test_torch_game import _port_data
from tolerances import assert_allclose

SOLVERS = {
    "lbfgs-l2": ("LBFGS", 0.5, None, OptimizerConfig(max_iterations=60, tolerance=1e-6)),
    "owlqn-en": ("LBFGS", 0.3, 0.5, OptimizerConfig(max_iterations=60, tolerance=1e-6)),
    "tron": ("TRON", 0.5, None, OptimizerConfig(max_iterations=15, tolerance=1e-4)),
}
FAMILIES = ["off", "scatter", "pallas"]


def _reg(pkg, weight, alpha):
    cls = RegularizationContext if pkg == "torch" else JReg
    return cls.l2(weight) if alpha is None else cls.elastic_net(weight, alpha)


def skewed_lanes(seed=11, e=40, m=10, d=4, hard=4):
    """A few ill-conditioned lanes among many easy ones (the JAX scheduler
    tests' problem), with half the features zero so a slab is sparse."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, m, d)).astype(np.float32)
    x *= rng.random((e, m, d)) < 0.7
    x[:hard] *= np.geomspace(1.0, 32.0, d).astype(np.float32)
    w_true = (rng.normal(size=(e, d)) * 0.5).astype(np.float32)
    z = np.einsum("emd,ed->em", x.astype(np.float64), w_true)
    y = (1.0 / (1.0 + np.exp(-z)) > rng.random((e, m))).astype(np.float32)
    off = (rng.normal(size=(e, m)) * 0.1).astype(np.float32)
    wt = np.where(rng.random((e, m)) < 0.15, 0.0, 1.0).astype(np.float32)
    return x, y, off, wt


def _data(family, arrays):
    x, y, off, wt = (torch.from_numpy(a) for a in arrays)
    feats = x if family == "off" else tfs.build_sparse_slab(x, kernel=family)
    return feats, y, off, wt


def _kw(name):
    opt, weight, alpha, cfg = SOLVERS[name]
    return dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[opt],
                optimizer_config=cfg, regularization=_reg("torch", weight, alpha))


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b):
    """Every field of two OptResults equal bit for bit (NaN history padding
    included)."""
    for name, x, y in zip(a._fields, a, b):
        if x is None or y is None:
            assert x is y, name
            continue
        assert torch.equal(bits(x), bits(y)), name


def one_shot(data, w0, **kw):
    return entity_lane_fns(**kw)[0](*data, w0)


# ---------------------------------------------------------------------------
# spellings
# ---------------------------------------------------------------------------

SPELLINGS = ["off", "false", "0", "none", "", "on", "true", "default", "device", "device:5",
             "DEVICE:12", "5", "12", " 7 ", 0, 3, True, False, "sideways", "-3", "device:off",
             "device:0", "device:x", "1.5"]


def _resolved(fn, spec):
    try:
        s = fn(spec)
    except ValueError as e:
        return ("error", str(e))
    return None if s is None else (s.chunk_size, s.loop, s.bucketer.base, s.bucketer.growth,
                                   s.describe())


@pytest.mark.parametrize("spec", SPELLINGS, ids=[repr(s) for s in SPELLINGS])
def test_resolve_schedule_matches_jax(spec, monkeypatch):
    monkeypatch.delenv("PHOTON_SOLVE_CHUNK", raising=False)
    assert _resolved(scheduler.resolve_schedule, spec) == _resolved(jsched.resolve_schedule, spec)


@pytest.mark.parametrize("env", [None, "9", "off", "device:4", "bad"])
def test_resolve_schedule_reads_the_env_as_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("PHOTON_SOLVE_CHUNK", raising=False)
    else:
        monkeypatch.setenv("PHOTON_SOLVE_CHUNK", env)
    assert _resolved(scheduler.resolve_schedule, None) == _resolved(jsched.resolve_schedule, None)


@pytest.mark.parametrize("kw", [dict(chunk_size=0), dict(loop="sideways")])
def test_schedule_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as got:
        SolveSchedule(**kw)
    with pytest.raises(ValueError) as want:
        jsched.SolveSchedule(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# compacted_solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 5, 64])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_compacted_solve_is_bitwise_the_one_shot(solver, family, chunk):
    data = _data(family, skewed_lanes())
    w0 = torch.zeros(data[1].shape[0], 4)
    kw = _kw(solver)
    res = compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=chunk), **kw)
    assert_bitwise(res, one_shot(data, w0, **kw))


@pytest.fixture(scope="module")
def jax_compacted():
    """The JAX scheduler's results on the dense stack and on its scatter
    slab (the JAX pallas family is the same arithmetic in interpret mode)."""
    arrays = skewed_lanes()
    out = {}
    for solver, (opt, weight, alpha, cfg) in SOLVERS.items():
        for layout in ("dense", "slab"):
            x = jnp.asarray(arrays[0])
            feats = x if layout == "dense" else jfs.build_sparse_slab(arrays[0], bucketer="off",
                                                                      kernel="scatter")
            data = (feats,) + tuple(jnp.asarray(a) for a in arrays[1:])
            out[solver, layout] = jsched.compacted_solve(
                data, jnp.zeros((arrays[0].shape[0], 4), jnp.float32),
                task=JTask.LOGISTIC_REGRESSION, optimizer=JOpt[opt],
                optimizer_config=JConfig(max_iterations=cfg.max_iterations,
                                         tolerance=cfg.tolerance),
                regularization=_reg("jax", weight, alpha), schedule=jsched.SolveSchedule(5))
    return out


def compare_with_jax(got, want):
    """Per-lane objectives at ``solver``; coefficients at ``solver`` on the
    lanes both packages stopped at the same iteration for the same reason
    (an f32 stopping test pins objectives, not coefficients: ROADMAP Queue
    3); the two agree on nearly every lane."""
    assert_allclose(got.value.numpy(), np.asarray(want.value), kind="solver")
    same = ((got.iterations.numpy() == np.asarray(want.iterations))
            & (got.reason.numpy() == np.asarray(want.reason)))
    assert same.mean() >= 0.9
    assert_allclose(got.coefficients.numpy()[same], np.asarray(want.coefficients)[same],
                    kind="solver")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_compacted_solve_matches_jax(solver, family, jax_compacted):
    data = _data(family, skewed_lanes())
    got = compacted_solve(data, torch.zeros(data[1].shape[0], 4),
                          schedule=SolveSchedule(chunk_size=5), **_kw(solver))
    compare_with_jax(got, jax_compacted[solver, "dense" if family == "off" else "slab"])


def test_ledger_records_saved_work_and_host_reads():
    data = _data("off", skewed_lanes(seed=3))
    w0 = torch.zeros(40, 4)
    kw = dict(_kw("lbfgs-l2"), optimizer_config=OptimizerConfig(max_iterations=80,
                                                                tolerance=1e-8))
    solve_stats.reset()
    compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=8), label="skewed", **kw)
    rec = solve_stats.snapshot()[-1]
    assert (rec.label, rec.lanes) == ("skewed", 40)
    assert 0 < rec.executed < rec.baseline and rec.saved == rec.baseline - rec.executed
    assert any(c.batch_lanes < 40 for c in rec.chunks)  # batches shrank onto the ladder
    assert all(c.batch_lanes in (40, 8, 16, 32) for c in rec.chunks)
    assert rec.host_reads > len(rec.chunks) and rec.device_chunks == 0
    totals = solve_stats.totals()
    assert set(totals) == set(jsched.solve_stats.totals()) | {"host_reads"}
    assert totals["saved_lane_iterations"] == rec.saved
    summary = solve_stats.summary()
    assert summary.startswith("solve compaction: 1 solves / 40 lanes;")
    assert "[skewed] active-lane decay (active/batch@limit): 40/40@8" in summary


# ---------------------------------------------------------------------------
# preemption snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resume_loop", ["host", "device"])
@pytest.mark.parametrize("solver", ["lbfgs-l2", "tron"])
def test_chunk_preemption_resumes_bitwise_on_either_loop(solver, resume_loop):
    data = _data("scatter", skewed_lanes(seed=5))
    w0 = torch.zeros(40, 4)
    kw = _kw(solver)
    want = one_shot(data, w0, **kw)
    preemption.reset()
    preemption.install_plan({"chunk": 1})
    try:
        with pytest.raises(preemption.Preempted) as info:
            compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2), label="pre", **kw)
    finally:
        preemption.install_plan(None)
        preemption.reset()
    e = info.value
    assert e.site == "chunk"
    meta, arrays = e.partial["meta"], e.partial["arrays"]
    assert (meta["kind"], meta["label"], meta["limit"]) == ("scheduler", "pre", 2)
    assert sorted(arrays) == sorted(f"state.{i}" for i in range(meta["num_leaves"]))
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    got = compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2, loop=resume_loop),
                          resume=e.partial, **kw)
    assert_bitwise(got, want)


def test_a_snapshot_of_another_solver_is_refused():
    data = _data("off", skewed_lanes(seed=5))
    w0 = torch.zeros(40, 4)
    preemption.install_plan({"chunk": 1})
    try:
        with pytest.raises(preemption.Preempted) as info:
            compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2), **_kw("lbfgs-l2"))
    finally:
        preemption.install_plan(None)
        preemption.reset()
    with pytest.raises(ValueError, match="refusing to resume"):
        compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2),
                        resume=info.value.partial, **_kw("tron"))


# ---------------------------------------------------------------------------
# inside coordinate descent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(77), num_users=40,
                              rows_per_user_range=(3, 30), d_fixed=4, d_random=3)
    return _port_data(data)


def _scheduled_descent(tdata, loop):
    ds = tgame.build_random_effect_dataset(
        tdata, tgame.RandomEffectDataConfig("userId", "per_user"), device="cpu")
    coord = RandomEffectCoordinate(
        ds, TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
        OptimizerConfig(max_iterations=40, tolerance=1e-7), RegularizationContext.l2(0.5),
        sparse_kernel="pallas", solve_schedule=SolveSchedule(chunk_size=3, loop=loop))
    labels = torch.from_numpy(tdata.response)
    return CoordinateDescent({"per-user": coord},
                             lambda s: torch.sum(tlosses.logistic.loss(s, labels)))


@pytest.mark.parametrize("loop,site,poll", [("host", "chunk", 2), ("device", "rung", 1)])
def test_descent_resumes_inside_a_scheduled_update(glmix, tmp_path, loop, site, poll):
    n = glmix.num_rows
    clean = _scheduled_descent(glmix, loop).run(2, n)
    ck_dir = str(tmp_path / "ck")
    preemption.reset()
    preemption.install_plan({site: poll})
    try:
        with pytest.raises(preemption.Preempted) as info:
            _scheduled_descent(glmix, loop).run(2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    finally:
        preemption.install_plan(None)
        preemption.reset()
    assert info.value.site == site and info.value.checkpoint_path is not None
    restored = tckpt.CoordinateDescentCheckpointer(ck_dir).restore(
        *(lambda cd: cd._seeded_state(n))(_scheduled_descent(glmix, loop)))
    assert restored.partial["meta"]["kind"] == "scheduler"
    assert restored.partial["meta"]["coordinate"] == "per-user"
    resumed = _scheduled_descent(glmix, loop).run(2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    assert torch.equal(bits(resumed.coefficients["per-user"]), bits(clean.coefficients["per-user"]))
    assert resumed.objective_history == clean.objective_history
