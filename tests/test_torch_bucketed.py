"""The port's size-bucketed random effect against the JAX package (CPU), on
the skewed entity sizes of tests/test_bucketed_random_effect.py:

  * the geometric partition, and per-bucket datasets byte-equal to the JAX
    package's with the shape ladder off and on;
  * ``update`` with LBFGS and TRON, spec ``off`` and ``pallas`` (the plain
    version of the kernels on the CPU), at the ``solver`` tolerance, with
    the scores and the regularization term (on three buckets of those
    sizes: each JAX bucket compiles its own solve);
  * the driver's exports: ``vocab_position_maps``, ``stack_sizes``,
    ``padded_elements`` and ``entity_export_by_raw_id`` with variances;
  * the coordinate inside ``CoordinateDescent`` (``run`` and ``run_grid``),
    and its tuple state checkpointed and resumed bitwise, a checkpoint of
    other bucket shapes refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm.bucketed_random_effect import (
    BucketedDatasetBundle as JBundle,
    BucketedRandomEffectCoordinate as JBucketed,
    partition_entities_by_size as j_partition,
)
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import checkpoint as tckpt
from photon_ml_tpu_torch.algorithm.bucketed_random_effect import (
    BucketedDatasetBundle,
    BucketedRandomEffectCoordinate,
    partition_entities_by_size,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_bucketed_random_effect import _skewed_glmix
from test_torch_game import _port_data
from tolerances import assert_allclose

SIZES = [3, 5, 6, 9, 17, 33, 150]
TOL = 1e-4  # a decided stopping step in f32 (see tests/test_torch_tron.py)
ITERS = 20
LAMBDA = 0.5
SOLVE_BUCKETS = 3  # buckets of the solve tests: each JAX bucket compiles its own solve
JCFG = JReConfig("userId", "per_user", projector="IDENTITY")
TCFG = tgame.RandomEffectDataConfig("userId", "per_user", projector="IDENTITY")
FIELDS = tgame.RandomEffectDataset.TENSOR_FIELDS


@pytest.fixture(scope="module")
def skewed():
    jdata = _skewed_glmix(np.random.default_rng(5), SIZES)
    resid = (np.random.default_rng(6).normal(size=jdata.num_rows) * 0.3).astype(np.float32)
    return jdata, _port_data(jdata), resid


def _port(tdata, optimizer="LBFGS", spec="off", **kw):
    return BucketedRandomEffectCoordinate(
        tdata, TCFG, TaskType.LOGISTIC_REGRESSION, OptimizerType[optimizer],
        OptimizerConfig(max_iterations=ITERS, tolerance=TOL), RegularizationContext.l2(LAMBDA),
        sparse_kernel=spec, device="cpu", **kw)


class TestPartition:
    def test_geometric_buckets(self):
        counts = np.asarray([0, 1, 2, 3, 9, 64, 1000])
        buckets = partition_entities_by_size(counts, max_buckets=12)
        assert sorted(np.concatenate(buckets).tolist()) == [1, 2, 3, 4, 5, 6]  # entity 0 empty
        assert buckets[-1].tolist() == [6]  # the giant entity is alone in the last bucket
        merged = partition_entities_by_size(counts, max_buckets=2)
        assert sorted(np.concatenate(merged).tolist()) == [1, 2, 3, 4, 5, 6]
        assert len(merged) <= 2
        for max_buckets in (1, 2, 3, 6, 12):
            got = partition_entities_by_size(counts, max_buckets)
            want = j_partition(counts, max_buckets)
            assert [b.tolist() for b in got] == [b.tolist() for b in want]

    def test_empty(self):
        assert partition_entities_by_size(np.zeros(4, np.int64)) == []


@pytest.mark.parametrize("ladder", ["off", "8:2"])
def test_bucket_datasets_are_byte_equal(skewed, ladder):
    jdata, tdata, _ = skewed
    want = JBundle.build(jdata, JCFG, bucketer=ladder)
    got = BucketedDatasetBundle.build(tdata, TCFG, bucketer=ladder, device="cpu")
    assert len(got.buckets) == len(want.buckets) == 6
    assert (got.num_rows, got.vocab) == (want.num_rows, want.vocab)
    for name in ("buckets", "row_sels", "dense_ids"):
        assert [a.tolist() for a in getattr(got, name)] == [a.tolist() for a in getattr(want, name)]
    for tds, jds in zip(got.datasets, want.datasets):
        assert (tds.num_entities, tds.global_dim) == (jds.num_entities, jds.global_dim)
        for f in FIELDS:
            w, g = np.asarray(getattr(jds, f)), getattr(tds, f).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), f
    if ladder != "off":
        assert all(ds.x.shape[0] == 8 for ds in got.datasets)


@pytest.fixture(scope="module")
def jax_solved(skewed):
    """Each optimizer's JAX bucketed update on the same residuals."""
    jdata, _, resid = skewed
    out = {}
    for opt in ("LBFGS", "TRON"):
        coord = JBucketed(jdata, JCFG, JTask.LOGISTIC_REGRESSION, JOpt[opt],
                          JConfig(max_iterations=ITERS, tolerance=TOL), JReg.l2(LAMBDA),
                          max_buckets=SOLVE_BUCKETS)
        state, _ = coord.update(jnp.asarray(resid), coord.initial_coefficients())
        out[opt] = (coord, state)
    return out


@pytest.mark.parametrize("spec", ["off", "pallas"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_update_matches_jax(skewed, jax_solved, optimizer, spec):
    _, tdata, resid = skewed
    jcoord, jstate = jax_solved[optimizer]
    coord = _port(tdata, optimizer, spec, max_buckets=SOLVE_BUCKETS)
    assert all((sub.slab is not None) == (spec == "pallas") for sub in coord._subs)
    state, results = coord.update(torch.from_numpy(resid), coord.initial_coefficients())
    assert isinstance(state, tuple) and len(state) == len(results) == len(jstate)
    for w, jw in zip(state, jstate):
        assert w.shape == jw.shape
        assert_allclose(w.numpy(), np.asarray(jw), kind="solver")
    assert_allclose(coord.score(state).numpy(), np.asarray(jcoord.score(jstate)), kind="solver")
    assert_allclose(float(coord.regularization_term(state)),
                    float(jcoord.regularization_term(jstate)), kind="solver", dtype=np.float32)


def test_exports_match_jax(skewed, jax_solved):
    """On the JAX coordinate's own state, every export the drivers read."""
    _, tdata, resid = skewed
    jcoord, jstate = jax_solved["LBFGS"]
    coord = _port(tdata, max_buckets=SOLVE_BUCKETS)
    state = tuple(torch.from_numpy(np.array(w)) for w in jstate)
    for got, want in zip(coord.vocab_position_maps(), jcoord.vocab_position_maps()):
        assert got.tolist() == want.tolist()
    assert coord.stack_sizes() == jcoord.stack_sizes()
    assert coord.num_entities == jcoord.num_entities == len(SIZES)
    assert coord.padded_elements() == jcoord.padded_elements()
    for g, w in zip(coord.global_coefficient_stacks(state), jcoord.global_coefficient_stacks(jstate)):
        assert_allclose(g.numpy(), np.asarray(w), kind="elementwise")
    means, variances = coord.entity_export_by_raw_id(state, torch.from_numpy(resid))
    jmeans, jvariances = jcoord.entity_export_by_raw_id(jstate, jnp.asarray(resid))
    assert sorted(means) == sorted(jmeans) == sorted(variances) == sorted(jvariances)
    for raw in jmeans:
        assert_allclose(means[raw], np.asarray(jmeans[raw]), kind="elementwise")
        assert_allclose(variances[raw], np.asarray(jvariances[raw]), kind="elementwise")
        assert np.all(variances[raw] > 0)
    assert coord.entity_export_by_raw_id(state)[1] is None


def _descent(coord, tdata):
    labels = torch.from_numpy(tdata.response)
    return CoordinateDescent({"per-user": coord},
                             lambda s: torch.sum(tlosses.logistic.loss(s, labels)))


def test_in_coordinate_descent(skewed, tmp_path):
    """The bucketed coordinate in ``run`` agrees with the unbucketed one at
    the solver tolerance, and ``run_grid`` at the run's lambda gives its
    bits, through its per-iteration checkpoints too."""
    _, tdata, _ = skewed
    n = tdata.num_rows
    bucketed = _descent(_port(tdata), tdata).run(2, n)
    plain = RandomEffectCoordinate(
        tgame.build_random_effect_dataset(tdata, TCFG, device="cpu"),
        TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
        OptimizerConfig(max_iterations=ITERS, tolerance=TOL), RegularizationContext.l2(LAMBDA))
    unbucketed = _descent(plain, tdata).run(2, n)
    assert_allclose(bucketed.objective_history, unbucketed.objective_history, kind="solver",
                    dtype=np.float32)
    assert_allclose(bucketed.total_scores.numpy(), unbucketed.total_scores.numpy(), kind="solver")
    grid = _descent(_port(tdata), tdata).run_grid({"per-user": [LAMBDA]}, 2, n)[0]
    assert grid.objective_history == bucketed.objective_history
    for a, b in zip(grid.coefficients["per-user"], bucketed.coefficients["per-user"]):
        assert torch.equal(a, b)
    # a grid checkpoint holds the tuple with the grid's lane axis, and a
    # finished combo restores from it without another update
    for _ in range(2):
        ck = tckpt.CoordinateDescentCheckpointer(str(tmp_path / "grid"))
        again = _descent(_port(tdata), tdata).run_grid({"per-user": [LAMBDA]}, 2, n,
                                                       checkpointers=[ck])[0]
        assert again.objective_history == grid.objective_history
        for a, b in zip(again.coefficients["per-user"], grid.coefficients["per-user"]):
            assert torch.equal(a, b)


def test_checkpoint_resumes_bitwise_and_refuses_other_buckets(skewed, tmp_path):
    _, tdata, _ = skewed
    n = tdata.num_rows
    clean = _descent(_port(tdata), tdata).run(2, n)
    ck_dir = str(tmp_path / "ckpt")
    preemption.install_plan({"cycle": 1})
    try:
        with pytest.raises(preemption.Preempted):
            _descent(_port(tdata), tdata).run(2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    finally:
        preemption.reset()
    resumed = _descent(_port(tdata), tdata).run(2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))
    assert resumed.objective_history == clean.objective_history
    for a, b in zip(resumed.coefficients["per-user"], clean.coefficients["per-user"]):
        assert torch.equal(a, b)
    assert torch.equal(resumed.total_scores, clean.total_scores)
    # the same number of buckets padded up a ladder: same structure, other shapes
    laddered = _descent(_port(tdata, bucketer="8:2"), tdata)
    with pytest.raises(ValueError, match="refusing to resume"):
        laddered.run(2, n, tckpt.CoordinateDescentCheckpointer(ck_dir))


@pytest.mark.parametrize("field", ["mesh_ctx"])
def test_unported_machinery_raises(skewed, field):
    _, tdata, _ = skewed
    with pytest.raises(NotImplementedError, match=f"{field} .* not yet ported"):
        _port(tdata, **{field: object()})
    # the solve schedule, the adaptive schedule and resume are ported: a
    # payload that is not the coordinate's own progress is refused
    coord = _port(tdata)
    with pytest.raises(ValueError, match="not a bucketed-RE progress snapshot"):
        coord.update(torch.zeros(tdata.num_rows), coord.initial_coefficients(), resume={})
