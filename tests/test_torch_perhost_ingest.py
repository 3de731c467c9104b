"""The port's per-host ingest (photon_ml_tpu_torch/parallel/perhost_ingest.py)
against the JAX package (CPU), the port at 2 ranks of a gloo group
(tests/torch_ranks.py) against the JAX package at ``data_mesh(2)``, rank r
against device r:

  * ``exchange_rows``: the same owner map, and each rank receives the rows
    the JAX device receives (the same records; order is the senders');
  * ``per_host_re_dataset`` under INDEX_MAP (plain and capped), size
    buckets, IDENTITY and RANDOM: every integer field equal and every value
    exact, block by block;
  * the per-host solvers (plain and bucketed, the ``pallas`` spec's plain
    version) at ``solver``, their owner-computed scores, routed scoring,
    ``per_host_model_slabs`` and ``densify_row_ids``; and the row-layout
    helpers on one process.
"""

import numpy as np
import pytest

from photon_ml_tpu.parallel import mesh as jmesh
from photon_ml_tpu.parallel import perhost_ingest as jpi
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.parallel import perhost_ingest as tpi
from photon_ml_tpu_torch.parallel.mesh import MeshContext
from tolerances import assert_allclose
from torch_ranks import run_ranks

N, D, K, USERS, NUM_BUCKETS = 400, 30, 4, 57, 64
STRIDE = 1 << 10
BUILDS = {
    "index-map": {},
    "capped": {"active_upper_bound": 5},
    "size-buckets": {"size_buckets": 4},
    "identity": {"projector": "IDENTITY"},
    "random": {"projector": "RANDOM", "projection_dim": 4},
}
SOLVED = ("index-map", "size-buckets")
PROBLEM = dict(optimizer="LBFGS", iters=30, tol=1e-5, **{"lambda": 0.3})
TRAIN_FIELDS = ("row_index", "x", "labels", "base_offsets", "weights", "local_to_global",
                "entity_keys", "entity_mask")
SCORE_FIELDS = ("score_row_index", "score_slot", "score_feat_idx", "score_feat_val")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    users = [f"u{int(u)}" for u in rng.zipf(1.6, N) % USERS]
    fi = np.full((N, K), -1, np.int32)
    fv = np.zeros((N, K), np.float32)
    for r in range(N):
        k = rng.integers(1, K + 1)
        fi[r, :k] = np.sort(rng.choice(D, k, replace=False))
        fv[r, :k] = rng.normal(size=k)
    files = np.sort(rng.integers(0, 6, N))  # 6 files, each decoded wholly by one rank
    within = np.concatenate([np.arange(c) for c in np.bincount(files, minlength=6)])
    payload = dict(raw_ids=users, row_index=np.arange(N, dtype=np.int64),
                   labels=(rng.random(N) > .5).astype(np.float32),
                   weights=(rng.random(N) + .5).astype(np.float32),
                   offsets=rng.normal(size=N).astype(np.float32), feat_idx=fi, feat_val=fv,
                   global_dim=D, owner_rank=files % 2, num_buckets=NUM_BUCKETS,
                   builds={k: dict(v, num_buckets=NUM_BUCKETS) for k, v in BUILDS.items()},
                   strided=files * STRIDE + within, stride=STRIDE)
    rows = jpi.HostRows(users, payload["row_index"], payload["labels"], payload["weights"],
                        payload["offsets"], fi, fv, D)
    return payload, rows


@pytest.fixture(scope="module")
def ingested(data, tmp_path_factory):
    payload, _ = data
    return run_ranks("torch_rank_jobs:ingest", 2, tmp_path_factory.mktemp("ingest"), payload)


@pytest.fixture(scope="module")
def solved(data, tmp_path_factory):
    payload, _ = data
    resid = np.random.default_rng(9).normal(scale=0.3, size=N).astype(np.float32)
    ids = [f"m{i}" for i in range(23)]
    rng = np.random.default_rng(4)
    model = {"ids": ids, "idx": np.sort(rng.integers(0, D, (23, 3)), axis=1).astype(np.int32),
             "val": rng.normal(size=(23, 3)).astype(np.float32), "dim": D}
    payload = dict(payload, builds={k: payload["builds"][k] for k in SOLVED}, problem=PROBLEM,
                   sparse="pallas", resid=resid, model=model)
    return payload, run_ranks("torch_rank_jobs:perhost_solves", 2,
                              tmp_path_factory.mktemp("solved"), payload)


def _jctx():
    return jmesh.MeshContext(jmesh.data_mesh(2))


def test_exchange_rows_delivers_the_jax_devices_rows(data, ingested):
    payload, rows = data
    keys = jpi.stable_entity_keys(rows.entity_raw_ids)
    b = jpi.bucket_of(keys, NUM_BUCKETS)
    from photon_ml_tpu.parallel import shuffle as jshuffle

    owners = jshuffle.balanced_bucket_owners(np.bincount(b, minlength=NUM_BUCKETS), 2)
    ints = np.concatenate([rows.row_index.astype(np.int32)[:, None], rows.feat_idx], axis=1)
    ex = jshuffle.exchange_rows(owners[b], ints, rows.feat_val, _jctx(), 1, 0)
    for r in range(2):
        got = ingested[r]["exchange"]
        assert np.array_equal(got["owners"], owners)
        order_t, order_j = np.argsort(got["ints"][:, 0]), np.argsort(ex.int_rows[r][:, 0])
        assert np.array_equal(got["ints"][order_t], ex.int_rows[r][order_j])
        assert np.array_equal(got["floats"][order_t], ex.float_rows[r][order_j])
    assert sum(len(ingested[r]["exchange"]["ints"]) for r in range(2)) == N


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_per_host_dataset_equals_jax_block_by_block(data, ingested, build):
    payload, rows = data
    want = jpi.per_host_re_dataset(rows, _jctx(), 1, 0, **payload["builds"][build])
    jbuckets = want.buckets if hasattr(want, "buckets") else [want]
    for r in range(2):
        got = ingested[r][build]
        assert np.array_equal(got["owners"], want.bucket_owners)
        for k, v in got["meta"].items():
            assert v == getattr(want, k), k
        assert len(got["buckets"]) == len(jbuckets)
        for gb, jb in zip(got["buckets"], jbuckets):
            for f in TRAIN_FIELDS:
                jv = jpi.local_shards(getattr(jb, f))[r]
                assert jv.dtype == gb[f].dtype and np.array_equal(gb[f], jv), (r, f)
        for f in SCORE_FIELDS:
            assert np.array_equal(got[f], jpi.local_shards(getattr(want, f))[r]), (r, f)
        # the raw ids this rank's entities carry
        assert set(got["raw_ids"].values()) <= set(rows.entity_raw_ids)
    assert (sum(len(ingested[r][build]["raw_ids"]) for r in range(2))
            == len(set(rows.entity_raw_ids)))


@pytest.mark.parametrize("build", SOLVED)
def test_per_host_solver_matches_jax(data, solved, build):
    payload, rows = data
    spayload, ranks = solved
    jctx = _jctx()
    sd = jpi.per_host_re_dataset(rows, jctx, 1, 0, **payload["builds"][build])
    cls = (jpi.PerHostBucketedRandomEffectSolver if hasattr(sd, "buckets")
           else jpi.PerHostRandomEffectSolver)
    solver = cls(sd, JTask.LOGISTIC_REGRESSION, JOpt.LBFGS,
                 JConfig(max_iterations=PROBLEM["iters"], tolerance=PROBLEM["tol"]),
                 JReg.l2(PROBLEM["lambda"]), jctx)
    import jax.numpy as jnp

    jw, _ = solver.update(jnp.asarray(spayload["resid"]), solver.initial_coefficients())
    jws = jw if isinstance(jw, tuple) else (jw,)
    jscore = np.asarray(solver.score(jw))
    jrouted = jpi.score_routed_rows(sd, jw, rows, N, jctx, 1, 0)
    for r in range(2):
        got = ranks[r][build]
        for gw, w in zip(got["w"], jws):
            assert_allclose(gw, jpi.local_shards(w)[r], kind="solver")
        assert_allclose(got["score"], jscore, kind="solver")
        assert_allclose(got["routed"], jrouted, kind="solver")
        # routed scoring of the training rows is the owner-computed score
        assert_allclose(got["routed"], got["score"], kind="elementwise")
        assert_allclose(got["reg"], float(solver.regularization_term(jw)), kind="solver",
                        dtype=np.float32)
    assert ranks[0][build]["score"].tobytes() == ranks[1][build]["score"].tobytes()


def test_model_slabs_and_densified_ids_match_jax(data, solved):
    payload, rows = data
    spayload, ranks = solved
    m = spayload["model"]
    sd, w = jpi.per_host_model_slabs(m["ids"], m["idx"], m["val"], m["dim"], _jctx(), 1, 0,
                                     num_buckets=NUM_BUCKETS)
    for r in range(2):
        gw, keys, l2g = ranks[r]["model_slabs"]
        assert np.array_equal(gw, jpi.local_shards(w)[r])
        assert np.array_equal(keys, jpi.local_shards(sd.entity_keys)[r])
        assert np.array_equal(l2g, jpi.local_shards(sd.local_to_global)[r])
    strided = jpi.HostRows(rows.entity_raw_ids, payload["strided"], rows.labels, rows.weights,
                           rows.offsets, rows.feat_idx, rows.feat_val, D)
    dense = jpi.densify_row_ids(strided, STRIDE, _jctx(), 1).row_index
    got = np.concatenate([ranks[r]["densified"] for r in range(2)])
    want = np.concatenate([dense[payload["owner_rank"] == r] for r in range(2)])
    assert np.array_equal(got, want) and sorted(got.tolist()) == list(range(N))


def test_row_layout_helpers_match_jax(data):
    payload, rows = data
    ctx, jctx = MeshContext.local(), jmesh.MeshContext(jmesh.data_mesh(1))
    files = [f"part-{i}" for i in range(7)]
    for n_proc in (1, 2, 3):
        for pid in range(n_proc):
            assert tpi.host_file_share(files, n_proc, pid) == jpi.host_file_share(files, n_proc,
                                                                                  pid)

    class GD:
        def __init__(self, n, seed):
            self.num_rows = n
            self.response = np.random.default_rng(seed).normal(size=n).astype(np.float32)
            vocab = [f"g{i}" for i in range(5)]
            self.id_vocabs = {"userId": vocab}
            self.ids = {"userId": np.arange(n) % 5}

    decoded = [(0, GD(4, 1)), (2, GD(3, 2)), (1, GD(5, 3))]
    base_t, n_t = tpi.global_row_layout(3, decoded, ctx, 1)
    base_j, n_j = jpi.global_row_layout(3, decoded, jctx, 1)
    assert n_t == n_j == 12 and np.array_equal(base_t, base_j)
    vec = lambda gd: gd.response
    assert np.array_equal(tpi.merge_row_vectors(decoded, base_t, n_t, ctx, 1, vec),
                          np.asarray(jpi.merge_row_vectors(decoded, base_j, n_j, jctx, 1, vec)))
    assert np.array_equal(tpi.merge_group_ids(decoded, base_t, n_t, "userId", ctx, 1),
                          jpi.merge_group_ids(decoded, base_j, n_j, "userId", jctx, 1))
    hi, lo = tpi._pack_u64(np.asarray([0, 1, 2 ** 63 + 5, 2 ** 64 - 1], np.uint64))
    assert np.array_equal(tpi._unpack_u64(hi, lo),
                          np.asarray([0, 1, 2 ** 63 + 5, 2 ** 64 - 1], np.uint64))
    with pytest.raises(ValueError, match="not dense"):
        tpi.per_host_re_dataset(
            tpi.HostRows(rows.entity_raw_ids, payload["strided"], rows.labels, rows.weights,
                         rows.offsets, rows.feat_idx, rows.feat_val, D), ctx)


def test_per_host_factored_coordinate_matches_jax(data, tmp_path):
    from photon_ml_tpu.algorithm.factored_random_effect import MFOptimizationConfig as JMF
    from photon_ml_tpu.parallel.perhost_factored import (
        PerHostFactoredRandomEffectCoordinate as JFactored,
    )

    import jax.numpy as jnp

    payload, rows = data
    resid = np.random.default_rng(13).normal(scale=0.3, size=N).astype(np.float32)
    ranks = run_ranks("torch_rank_jobs:perhost_factored", 2, tmp_path,
                      dict(payload, problem=PROBLEM, resid=resid))
    jctx = _jctx()
    sd = jpi.per_host_re_dataset(rows, jctx, 1, 0, projector="IDENTITY",
                                 num_buckets=NUM_BUCKETS)
    cfg = JConfig(max_iterations=PROBLEM["iters"], tolerance=PROBLEM["tol"])
    reg = JReg.l2(PROBLEM["lambda"])
    coord = JFactored(sd, JTask.LOGISTIC_REGRESSION, mf_config=JMF(2, 2),
                      re_optimizer=JOpt.LBFGS, re_optimizer_config=cfg, re_regularization=reg,
                      latent_optimizer=JOpt.LBFGS, latent_optimizer_config=cfg,
                      latent_regularization=reg, ctx=jctx)
    state, _ = coord.update(jnp.asarray(resid), coord.initial_coefficients())
    w = coord.random_effect_coefficients(state)
    for r in range(2):
        got = ranks[r]
        assert_allclose(got["v"], jpi.local_shards(state.v)[r], kind="solver")
        assert_allclose(got["matrix"], np.asarray(state.matrix), kind="solver")
        assert_allclose(got["w"], jpi.local_shards(w)[r], kind="solver")
        assert_allclose(got["score"], np.asarray(coord.score(state)), kind="solver")
        assert_allclose(got["reg"], float(coord.regularization_term(state)), kind="solver",
                        dtype=np.float32)
    # one trajectory on the replicated matrix; each rank names only its entities
    assert ranks[0]["matrix"].tobytes() == ranks[1]["matrix"].tobytes()
    assert not set(ranks[0]["factors"]) & set(ranks[1]["factors"])
    assert set(ranks[0]["factors"]) | set(ranks[1]["factors"]) == set(rows.entity_raw_ids)
