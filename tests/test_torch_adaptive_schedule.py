"""The port's adaptive bucket scheduling (photon_ml_tpu_torch/optim/
convergence.py and the bucketed coordinate's use of it) against the JAX
package's (CPU):

  * ``resolve_adaptive`` and ``AdaptiveSchedule`` give the JAX results and
    errors for every spelling of the JAX tests;
  * ``ConvergenceLedger`` keeps the JAX entries through the same events,
    and its JSON (and its sidecar file) is read by the JAX loader;
  * the bucketed coordinate under the policy: tolerance 0 changes no bit,
    a skip carries the coefficients forward and is a recorded
    ``PlanDecision`` with the JAX words, the ``optim.block_skip`` fault
    degrades an epoch to visit-everything, and ``ledger_export`` feeds
    ``retrain.json``;
  * a scheduled bucketed update stopped at a bucket or a chunk boundary
    resumes bitwise.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm.bucketed_random_effect import (
    BucketedRandomEffectCoordinate as JBucketed,
)
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.optim import convergence as jconv
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.algorithm.bucketed_random_effect import BucketedRandomEffectCoordinate
from photon_ml_tpu_torch.compile import ShapeBucketer
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import convergence
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.convergence import AdaptiveSchedule, ConvergenceLedger
from photon_ml_tpu_torch.optim.scheduler import SolveSchedule
from photon_ml_tpu_torch.resilience import faults, preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from game_test_utils import make_glmix_data
from test_torch_game import _port_data
from tolerances import assert_allclose

SPELLINGS = ["off", "false", "none", "0", "", "OFF", False, "on", "true", "default", True,
             "1e-4", "1e-4:3", "0.0:1", "0.0", 2.5e-3, 0.0, "nope", "1e-3:x", ":2", "1:2:3",
             "-1", "nan", "1e-3:0"]


def _resolved(fn, spec):
    try:
        s = fn(spec)
    except ValueError as e:
        return ("error", str(e))
    return None if s is None else (s.tolerance, s.patience, s.describe())


@pytest.mark.parametrize("spec", SPELLINGS, ids=[repr(s) for s in SPELLINGS])
def test_resolve_adaptive_matches_jax(spec, monkeypatch):
    monkeypatch.delenv("PHOTON_ADAPTIVE_SCHEDULE", raising=False)
    assert _resolved(convergence.resolve_adaptive, spec) == _resolved(jconv.resolve_adaptive,
                                                                      spec)


@pytest.mark.parametrize("env", [None, "1e-5:4", "off", "bad"])
def test_resolve_adaptive_reads_the_env_as_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("PHOTON_ADAPTIVE_SCHEDULE", raising=False)
    else:
        monkeypatch.setenv("PHOTON_ADAPTIVE_SCHEDULE", env)
    assert _resolved(convergence.resolve_adaptive, None) == _resolved(jconv.resolve_adaptive,
                                                                      None)


def _events(ledger):
    ledger.observe(3, 0.5, executed=40, epoch=1)
    ledger.observe(1, 2e-6, executed=12, epoch=1, under_tolerance=True)
    ledger.record_skip(1, epoch=2)
    ledger.observe(7, 1e-3, executed=9, epoch=2)
    ledger.record_skip(9, epoch=2)
    ledger.observe(3, 0.1, executed=70, epoch=4)
    return ledger


def test_ledger_events_match_jax_and_the_jax_loader_reads_it(tmp_path):
    got, want = _events(ConvergenceLedger()), _events(jconv.ConvergenceLedger())
    assert got.to_json() == want.to_json()
    assert got.order(range(13)) == want.order(range(13))
    assert len(got) == len(want) and got.gids() == want.gids()
    for sched in (AdaptiveSchedule(1e-5, 1), AdaptiveSchedule(1e-2, 2), AdaptiveSchedule(0.0, 1)):
        jsched = jconv.AdaptiveSchedule(sched.tolerance, sched.patience)
        assert [got.should_skip(g, sched) for g in range(13)] == \
            [want.should_skip(g, jsched) for g in range(13)]
    # the JSON and the sidecar file are the JAX package's
    assert jconv.ConvergenceLedger.from_json(json.loads(json.dumps(got.to_json()))).to_json() \
        == want.to_json()
    path = got.save(str(tmp_path))
    assert path.endswith(jconv.LEDGER_FILENAME) and convergence.LEDGER_FILENAME == \
        jconv.LEDGER_FILENAME
    assert jconv.ConvergenceLedger.load(str(tmp_path)).to_json() == want.to_json()
    assert ConvergenceLedger.load(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# the bucketed coordinate
# ---------------------------------------------------------------------------

RE_OPT = dict(max_iterations=12, tolerance=1e-6)


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(11), num_users=24,
                              rows_per_user_range=(3, 30), d_fixed=4, d_random=3)
    return data, _port_data(data)


def _port(tdata, **kw):
    return BucketedRandomEffectCoordinate(
        tdata, tgame.RandomEffectDataConfig("userId", "per_user"), TaskType.LOGISTIC_REGRESSION,
        OptimizerType.LBFGS, OptimizerConfig(**RE_OPT), RegularizationContext.l2(0.3),
        device="cpu", **kw)


def _bits(state):
    return [w.view(torch.int32) for w in state]


def test_ordering_only_mode_is_bitwise(glmix):
    _, tdata = glmix
    resid = torch.zeros(tdata.num_rows)
    off, ordered = _port(tdata), _port(tdata, adaptive=AdaptiveSchedule(0.0, 1))
    s_off, _ = off.update(resid, off.initial_coefficients())
    s_ord, _ = ordered.update(resid, ordered.initial_coefficients())
    for _ in range(2):
        s_off, _ = off.update(resid, s_off)
        s_ord, _ = ordered.update(resid, s_ord)
    assert all(torch.equal(a, b) for a, b in zip(_bits(s_off), _bits(s_ord)))
    assert ordered.skip_decisions == [] and len(ordered.ledger_export()) == len(ordered.buckets)


def test_skips_match_jax_with_recorded_decisions(glmix):
    jdata, tdata = glmix
    policy = (10.0, 1)
    coord = _port(tdata, adaptive=AdaptiveSchedule(*policy))
    jcoord = JBucketed(jdata, JReConfig("userId", "per_user"), JTask.LOGISTIC_REGRESSION,
                       JOpt.LBFGS, JConfig(**RE_OPT), JReg.l2(0.3),
                       adaptive=jconv.AdaptiveSchedule(*policy))
    resid = torch.zeros(tdata.num_rows)
    st, _ = coord.update(resid, coord.initial_coefficients())
    jst, _ = jcoord.update(jnp.zeros(jdata.num_rows), jcoord.initial_coefficients())
    score_1 = coord.score(st)
    st, results = coord.update(resid, st)  # every bucket skips
    jst, _ = jcoord.update(jnp.zeros(jdata.num_rows), jst)
    assert all(r is None for r in results)
    assert torch.equal(coord.score(st), score_1)  # coefficients carried forward
    got = [(d.policy, d.action, d.reason) for d in coord.skip_decisions]
    want = [(d.policy, d.action, d.reason) for d in jcoord.skip_decisions]
    assert got == want and len(got) == len(coord.buckets)
    ledger, jledger = coord.ledger_export(), jcoord._ledger.to_json()
    assert sorted(ledger) == sorted(jledger)
    for g in ledger:
        a, b = dict(ledger[g]), dict(jledger[g])
        assert_allclose(a.pop("score"), b.pop("score"), kind="solver", dtype=np.float32)
        assert abs(a.pop("executed") - b.pop("executed")) <= 2 * 24
        assert a == b
    assert_allclose(coord.score(st).numpy(), np.asarray(jcoord.score(jst)), kind="solver")


def test_block_skip_fault_degrades_the_epoch_to_visit_everything(glmix):
    _, tdata = glmix
    coord = _port(tdata, adaptive=AdaptiveSchedule(10.0, 1))
    resid = torch.zeros(tdata.num_rows)
    st, _ = coord.update(resid, coord.initial_coefficients())
    with faults.fault_scope(faults.FaultPlan([faults.FaultSpec("optim.block_skip", at=1)])):
        st, results = coord.update(resid, st)
    assert all(r is not None for r in results)
    assert not any(e["skips"] for e in coord.ledger_export().values())
    pinned = [d for d in coord.skip_decisions if d.action == "pinned"]
    assert len(pinned) == 1 and "degraded to visit-everything" in pinned[0].reason
    coord.update(resid, st)
    assert any(d.action == "skipped" for d in coord.skip_decisions)


@pytest.mark.parametrize("site,poll", [("bucket", 2), ("chunk", 3), ("rung", 1)])
def test_scheduled_bucketed_update_resumes_bitwise(glmix, site, poll):
    _, tdata = glmix
    loop = "device" if site == "rung" else "host"
    # a fine ladder, so a bucket of a few lanes still hops between rungs
    schedule = SolveSchedule(chunk_size=3, loop=loop, bucketer=ShapeBucketer(2, 2.0))
    resid = torch.from_numpy(np.random.default_rng(4).normal(size=tdata.num_rows)
                             .astype(np.float32) * 0.2)
    clean = _port(tdata, solve_schedule=schedule)
    want, _ = clean.update(resid, clean.initial_coefficients())
    coord = _port(tdata, solve_schedule=schedule)
    preemption.reset()
    preemption.install_plan({site: poll})
    try:
        with pytest.raises(preemption.Preempted) as info:
            coord.update(resid, coord.initial_coefficients())
    finally:
        preemption.install_plan(None)
        preemption.reset()
    meta = info.value.partial["meta"]
    assert meta["kind"] == "bucketed_re" and meta["shapes"] == coord._bucket_shapes()
    assert (meta["inner"] is None) == (site == "bucket")
    got, results = coord.update(resid, coord.initial_coefficients(), resume=info.value.partial)
    assert results[: meta["bucket"]] == (None,) * meta["bucket"]
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(want)))
