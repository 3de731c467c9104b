"""The port's process-group mesh and distributed fixed-effect solver
against the JAX package (CPU).

Torch has no single-process multi-device mesh, so a JAX mesh of n virtual
devices (``data_mesh(n)``, tests/conftest.py) is compared with the port at
n ranks of a gloo group, each rank its own process (tests/torch_ranks.py),
rank r holding what device r holds:

  * the pad helpers, stable keys, row priorities, buckets and owner maps
    equal the JAX package's;
  * every collective of ``MeshContext``: the fixed-order sum adds the ranks'
    partials in rank order on every rank; max, min, gather and all_to_all
    are exact; the restore agreement is the collective min;
  * the distributed fixed-effect solve (LBFGS and TRON) at 2 ranks matches
    the JAX package at ``data_mesh(2)`` and the port's local solve at
    ``solver``; at one rank it is bitwise the local solve (the entity-sharded
    solves are the per-host solvers', tests/test_torch_perhost_ingest.py);
  * a collective whose backend is gone raises; nothing answers with a
    process-local value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.data.game import build_fixed_effect_batch as j_fe_batch
from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.features import SparseFeatures as JSparse
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel import mesh as jmesh
from photon_ml_tpu.parallel import shuffle as jshuffle
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops.features import DenseFeatures, SparseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.parallel import distributed as tdist
from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel import shuffle as tshuffle
from test_torch_game import _port_data
from tolerances import assert_allclose
from torch_rank_jobs import _problem
from torch_ranks import run_ranks

FE = [dict(optimizer=o, iters=40, tol=1e-6, **{"lambda": 0.5}) for o in ("LBFGS", "TRON")]


@pytest.fixture(scope="module")
def glmix():
    data, _ = make_glmix_data(np.random.default_rng(17), num_users=9, rows_per_user_range=(5, 18),
                              d_fixed=5, d_random=3)
    return data, _port_data(data)


def _jax_problem(spec):
    return JProblem(JTask.LOGISTIC_REGRESSION, JOpt(spec["optimizer"]),
                    JConfig(max_iterations=spec["iters"], tolerance=spec["tol"]),
                    JReg.l2(spec["lambda"]))


@pytest.fixture(scope="module")
def solves(glmix, tmp_path_factory):
    """One 2-rank run of the distributed fixed-effect solve, and its payload."""
    jdata, tdata = glmix
    fe = tgame.build_fixed_effect_batch(tdata, "global", dense=True, device="cpu")
    payload = {"fe": {"x": fe.features.matrix.numpy(), "y": fe.labels.numpy(),
                      "off": fe.offsets.numpy(), "w": fe.weights.numpy()},
               "fe_problems": FE}
    ranks = run_ranks("torch_rank_jobs:fixed_effect_solves", 2,
                      tmp_path_factory.mktemp("ranks"), payload)
    return payload, ranks


def test_pad_helpers_match_jax(rng):
    a = rng.normal(size=(5, 3)).astype(np.float32)
    for multiple, fill in ((2, 0.0), (4, -1.0), (5, 7.0)):
        assert np.array_equal(tmesh.pad_leading(torch.from_numpy(a), multiple, fill).numpy(),
                              np.asarray(jmesh.pad_leading(jnp.asarray(a), multiple, fill)))
    y, off, w = (rng.normal(size=5).astype(np.float32) for _ in range(3))
    idx = rng.integers(0, 6, (5, 2)).astype(np.int32)
    val = rng.normal(size=(5, 2)).astype(np.float32)
    cases = [(DenseFeatures(torch.from_numpy(a)), JDense(jnp.asarray(a))),
             (SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), 6).with_transpose(),
              JSparse(jnp.asarray(idx), jnp.asarray(val), 6))]
    for tf, jf in cases:
        got = tmesh.pad_rows(GLMBatch(tf, *(torch.from_numpy(v) for v in (y, off, w))), 4)
        want = jmesh.pad_rows(JBatch(jf, *(jnp.asarray(v) for v in (y, off, w))), 4)
        assert got.num_rows == want.num_rows == 8
        for g, j in ((got.labels, want.labels), (got.offsets, want.offsets),
                     (got.weights, want.weights)):
            assert np.array_equal(g.numpy(), np.asarray(j))
        if isinstance(tf, DenseFeatures):
            assert np.array_equal(got.features.matrix.numpy(), np.asarray(want.features.matrix))
        else:
            assert np.array_equal(got.features.indices.numpy(), np.asarray(want.features.indices))
            assert np.array_equal(got.features.values.numpy(), np.asarray(want.features.values))
            assert torch.equal(got.features.t_row, tf.t_row)  # the transpose stays valid


def test_keys_priorities_buckets_and_owner_maps_match_jax(rng):
    raw = [f"user-{i}" for i in range(300)] + ["ü-ñ", "", "x" * 40]
    keys = tshuffle.stable_entity_keys(raw)
    assert keys.dtype == np.uint64
    assert np.array_equal(keys, jshuffle.stable_entity_keys(raw))
    rows = rng.integers(0, 2 ** 31 - 1, len(raw))
    assert np.array_equal(tshuffle.stable_row_priority(keys, rows),
                          jshuffle.stable_row_priority(keys, rows))
    for nb in (1, 64, 4096):
        assert np.array_equal(tshuffle.bucket_of(keys, nb), jshuffle.bucket_of(keys, nb))
    counts = rng.integers(0, 50, 64)
    for n_dev in (1, 2, 3, 8):
        assert np.array_equal(tshuffle.balanced_bucket_owners(counts, n_dev),
                              jshuffle.balanced_bucket_owners(counts, n_dev))
    assert np.array_equal(tshuffle.balanced_owners_over_hosts(counts, [5, 2, 9]),
                          jshuffle.balanced_owners_over_hosts(counts, [5, 2, 9]))
    with pytest.raises(ValueError, match="empty host set"):
        tshuffle.balanced_owners_over_hosts(counts, [])


def test_a_world_of_one_is_the_identity():
    ctx = tmesh.MeshContext.local()
    t = torch.tensor([1.5, -2.0])
    assert ctx.sum(t) is t and torch.equal(ctx.concat(t), t)
    assert ctx.block(7) == (0, 7) and ctx.padded(7) == 7
    assert torch.equal(ctx.all_to_all(t.reshape(1, 2, 1)), t.reshape(1, 2, 1))
    assert tmesh.data_mesh().world == 1
    with pytest.raises(ValueError, match="need 2 devices"):
        tmesh.data_mesh(2)


def test_collectives_at_two_ranks(tmp_path):
    ranks = run_ranks("torch_rank_jobs:collectives", 2, tmp_path)
    f = [np.asarray([0.1 * (r + 1), 1e8, -3.0 * r], np.float32) for r in range(2)]
    for r, got in enumerate(ranks):
        # the fixed-order sum: rank 0's partial plus rank 1's, in float32
        assert np.array_equal(got["sum"], f[0] + f[1])
        assert got["max"].tolist() == [1, 5, 7] and got["min"].tolist() == [0, 4, 0]
        assert got["concat"].tolist() == [0, 5, 0, 1, 4, 7]
        # block s of the received buffer came from rank s's block r
        send = [np.arange(12, dtype=np.int32).reshape(2, 2, 3) + 100 * s for s in range(2)]
        assert np.array_equal(got["a2a"], np.stack([send[s][r] for s in range(2)]))
        assert got["steps"] == [3, None]  # collective min; a rank with none: fresh start
    assert ranks[0]["sum"].tobytes() == ranks[1]["sum"].tobytes()


def test_a_collective_on_a_dead_backend_raises(tmp_path):
    """The JAX package degrades a failed single-process reduce to the local
    value (tests/test_perhost_ingest.py:128); the port raises: a rank that
    answered locally would desynchronize the others. Rank 1 leaves; rank 0's
    fixed-order sum and the shuffle's collective sum both raise."""
    ranks = run_ranks("torch_rank_jobs:dead_peer", 2, tmp_path,
                      env={"PHOTON_COLLECTIVE_TIMEOUT": "20"})
    assert ranks[1] is None and len(ranks[0]) == 2
    for msg in ranks[0]:
        assert msg is not None and "collective all_gather over 2 ranks (gloo) failed" in msg
    mh = multihost.initialize(device="cpu")
    ctx = mh.mesh_context()
    assert ctx.backend == "gloo" and ctx.world == 1
    assert torch.equal(ctx.sum(torch.ones(2)), torch.ones(2))
    multihost.shutdown()


def test_distributed_fixed_effect_matches_jax_and_the_local_solve(glmix, solves):
    jdata, _ = glmix
    payload, ranks = solves
    jctx = jmesh.MeshContext(jmesh.data_mesh(2))
    jbatch = j_fe_batch(jdata, "global")
    fe = payload["fe"]
    local = GLMBatch(DenseFeatures(torch.from_numpy(fe["x"])),
                     *(torch.from_numpy(fe[k]) for k in ("y", "off", "w")))
    for spec in FE:
        got = ranks[0][f"fe-{spec['optimizer']}"]
        assert np.array_equal(got, ranks[1][f"fe-{spec['optimizer']}"])  # one trajectory
        jmodel, _ = jdist.DistributedFixedEffectSolver(_jax_problem(spec), jctx).run(
            jbatch, JNorm.identity())
        assert_allclose(got, np.asarray(jmodel.coefficients.means), kind="solver")
        model, _ = _problem(spec).run(local, NormalizationContext.identity())
        assert_allclose(got, model.coefficients.means.numpy(), kind="solver")
        # one rank: bitwise the local solve
        one, _ = tdist.DistributedFixedEffectSolver(_problem(spec), tmesh.MeshContext.local()
                                                    ).run(local, NormalizationContext.identity())
        assert torch.equal(one.coefficients.means, model.coefficients.means)
