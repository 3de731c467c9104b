"""The port's device rung loop (photon_ml_tpu_torch/optim/fused_schedule.py)
against the JAX package's (CPU; on the card each rung is a captured CUDA
graph, held by tests/test_torch_kernel_gpu.py and chip_smoke.py phase 21):

  * ``rung_ladder`` and ``next_lower_rung`` give the JAX lists;
  * ``device_solve`` (the rung loop run eagerly on the CPU) equals the host
    chunk loop and the one-shot solve bitwise, and matches the JAX device
    loop at the ``solver`` tolerance, for LBFGS, OWL-QN and TRON on the
    dense stack and the slab families;
  * its host dispatches are O(#rungs), one ``ChunkRecord`` per rung hop;
  * a rung-boundary preemption snapshot resumes bitwise on either loop;
  * only the injected ``optim.device_drain`` fault degrades to the host
    loop; any other error inside the device loop raises;
  * the scheduled coordinates solve through it with the one-shot bits.
"""

import jax.numpy as jnp
import pytest
import torch

from photon_ml_tpu.compile import ShapeBucketer as JBucketer
from photon_ml_tpu.optim import fused_schedule as jfused
from photon_ml_tpu.optim import scheduler as jsched
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.compile import ShapeBucketer, compile_stats
from photon_ml_tpu_torch.optim import fused_schedule
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.fused_schedule import next_lower_rung, rung_ladder
from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve, solve_stats
from photon_ml_tpu_torch.resilience import faults, preemption
from test_torch_bucketed import _port
from test_torch_bucketed import skewed  # noqa: F401 — the shared fixture
from test_torch_scheduler import (
    FAMILIES,
    SOLVERS,
    _data,
    _kw,
    _reg,
    assert_bitwise,
    compare_with_jax,
    one_shot,
    skewed_lanes,
)

DEVICE = SolveSchedule(chunk_size=5, loop="device")


@pytest.mark.parametrize("base,growth", [(8, 2.0), (4, 1.5), (16, 3.0), (1, 2.0)])
def test_rung_ladder_and_next_lower_rung_match_jax(base, growth):
    b, jb = ShapeBucketer(base, growth), JBucketer(base, growth)
    for lanes in (1, 3, 8, 9, 40, 100, 1024, 20000):
        assert rung_ladder(b, lanes) == jfused.rung_ladder(jb, lanes)
    for rung in range(1, 300):
        assert next_lower_rung(b, rung) == jfused.next_lower_rung(jb, rung)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_device_loop_is_bitwise_the_host_loop_and_the_one_shot(solver, family):
    data = _data(family, skewed_lanes())
    w0 = torch.zeros(40, 4)
    kw = _kw(solver)
    res = compacted_solve(data, w0, schedule=DEVICE, **kw)
    assert_bitwise(res, one_shot(data, w0, **kw))
    assert_bitwise(res, compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=5), **kw))


@pytest.fixture(scope="module")
def jax_device():
    """The JAX device loop's results on the dense stack."""
    arrays = skewed_lanes()
    data = tuple(jnp.asarray(a) for a in arrays)
    return {solver: jsched.compacted_solve(
        data, jnp.zeros((40, 4), jnp.float32), task=JTask.LOGISTIC_REGRESSION,
        optimizer=JOpt[opt], optimizer_config=JConfig(max_iterations=cfg.max_iterations,
                                                      tolerance=cfg.tolerance),
        regularization=_reg("jax", weight, alpha),
        schedule=jsched.SolveSchedule(chunk_size=5, loop="device"))
        for solver, (opt, weight, alpha, cfg) in SOLVERS.items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_device_loop_matches_jax(solver, family, jax_device):
    data = _data(family, skewed_lanes())
    got = compacted_solve(data, torch.zeros(40, 4), schedule=DEVICE, **_kw(solver))
    compare_with_jax(got, jax_device[solver])


def test_dispatches_are_one_a_rung_hop_and_reads_are_few():
    data = _data("off", skewed_lanes(seed=3))
    w0 = torch.zeros(40, 4)
    kw = dict(_kw("lbfgs-l2"), optimizer_config=OptimizerConfig(max_iterations=80,
                                                                tolerance=1e-8))
    solve_stats.reset()
    compile_stats.reset()
    compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=4), label="host", **kw)
    compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=4, loop="device"),
                    label="device", **kw)
    host, dev = solve_stats.snapshot()[-2:]
    assert (dev.executed, dev.baseline) == (host.executed, host.baseline)
    widths = [c.batch_lanes for c in dev.chunks]
    assert widths == sorted(widths, reverse=True) and len(set(widths)) == len(widths)
    assert len(dev.chunks) <= len(rung_ladder(ShapeBucketer(), 40))
    assert dev.device_chunks >= len(dev.chunks) and dev.dispatches < host.dispatches
    assert dev.host_reads < host.host_reads
    # on the CPU the rung body runs eagerly: nothing is captured
    assert compile_stats.snapshot() == {}


@pytest.mark.parametrize("resume_loop", ["host", "device"])
@pytest.mark.parametrize("solver", ["lbfgs-l2", "tron"])
def test_rung_preemption_resumes_bitwise_on_either_loop(solver, resume_loop):
    data = _data("pallas", skewed_lanes(seed=5))
    w0 = torch.zeros(40, 4)
    kw = _kw(solver)
    preemption.reset()
    preemption.install_plan({"rung": 1})
    try:
        with pytest.raises(preemption.Preempted) as info:
            compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2, loop="device"),
                            label="pre", **kw)
    finally:
        preemption.install_plan(None)
        preemption.reset()
    e = info.value
    assert e.site == "rung" and e.partial["meta"]["kind"] == "scheduler"
    got = compacted_solve(data, w0, schedule=SolveSchedule(chunk_size=2, loop=resume_loop),
                          resume=e.partial, **kw)
    assert_bitwise(got, one_shot(data, w0, **kw))


def test_injected_device_drain_fault_degrades_to_the_host_loop(caplog):
    data = _data("scatter", skewed_lanes())
    w0 = torch.zeros(40, 4)
    kw = _kw("lbfgs-l2")
    solve_stats.reset()
    plan = faults.FaultPlan([faults.FaultSpec("optim.device_drain", at=1, kind="fatal")])
    with faults.fault_scope(plan):
        res = compacted_solve(data, w0, schedule=DEVICE, label="drained", **kw)
    assert "degrading to the host chunk loop" in caplog.text
    assert solve_stats.snapshot()[-1].device_chunks == 0  # the host loop ran it
    assert_bitwise(res, one_shot(data, w0, **kw))


def test_any_other_device_loop_error_raises(monkeypatch):
    """No fallback hides the device loop: a failure inside it propagates."""
    def broken(*args, **kwargs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(fused_schedule._RungLoop, "run", broken)
    data = _data("off", skewed_lanes())
    with pytest.raises(RuntimeError, match="capture failed"):
        compacted_solve(data, torch.zeros(40, 4), schedule=DEVICE, **_kw("tron"))


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_bucketed_coordinate_on_the_device_loop_is_bitwise_unscheduled(skewed, optimizer):  # noqa: F811
    _, tdata, resid = skewed
    plain = _port(tdata, optimizer, spec="pallas")
    sched = _port(tdata, optimizer, spec="pallas", solve_schedule=DEVICE)
    r = torch.from_numpy(resid)
    want, _ = plain.update(r, plain.initial_coefficients())
    got, results = sched.update(r, sched.initial_coefficients())
    assert len(got) == len(want) == len(results)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # a second update replays the coordinate's cached rung loops
    again, _ = sched.update(r, got)
    want_again, _ = plain.update(r, want)
    for a, b in zip(again, want_again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
