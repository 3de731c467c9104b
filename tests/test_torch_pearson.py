"""The port's Pearson feature selection against the JAX package (CPU):
``pearson_feature_scores`` within 1e-12 of the JAX scores (both numpy
float64 on the host), and a random-effect dataset built with a
features-to-samples ratio byte-equal to the JAX build, for INDEX_MAP and
IDENTITY, with and without an active cap and an intercept column.
"""

import numpy as np
import pytest

from game_test_utils import make_glmix_data
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.data.game import pearson_feature_scores as j_scores
from photon_ml_tpu_torch.data import game as tgame


def _with_intercept(data):
    """A copy of the per-user shard with a constant last column."""
    f = data.shards["per_user"]
    n = f.num_rows
    dense = np.zeros((n, f.dim + 1), np.float32)
    rows = np.repeat(np.arange(n), np.diff(f.indptr))
    dense[rows, f.indices] = f.values
    dense[:, -1] = 1.0
    mask = dense != 0
    return type(f)(np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int64),
                   np.nonzero(mask)[1].astype(np.int32), dense[mask].astype(np.float32),
                   f.dim + 1)


@pytest.fixture(scope="module")
def datasets():
    data, _ = make_glmix_data(np.random.default_rng(97), num_users=14,
                              rows_per_user_range=(3, 25), d_fixed=3, d_random=9)
    # sparse rows: drop about a third of the per-user values
    f = data.shards["per_user"]
    keep = np.random.default_rng(98).random(len(f.values)) > 0.35
    rows = np.repeat(np.arange(f.num_rows), np.diff(f.indptr))[keep]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=f.num_rows))])
    data.shards["per_user"] = type(f)(indptr.astype(np.int64), f.indices[keep],
                                      f.values[keep], f.dim)
    data.shards["with_intercept"] = _with_intercept(data)
    port = tgame.GameData(
        response=data.response, offset=data.offset, weight=data.weight,
        ids=dict(data.ids), id_vocabs=dict(data.id_vocabs),
        shards={k: tgame.HostFeatures(v.indptr, v.indices, v.values, v.dim)
                for k, v in data.shards.items()},
    )
    return data, port


@pytest.mark.parametrize("shard", ["per_user", "with_intercept"])
@pytest.mark.parametrize("masked", [False, True])
def test_pearson_scores_match_jax(datasets, shard, masked):
    jdata, tdata = datasets
    mask = (np.random.default_rng(3).random(jdata.num_rows) < 0.7 if masked
            else np.ones(jdata.num_rows, bool))
    ids = jdata.ids["userId"]
    want = j_scores(ids, jdata.response, jdata.shards[shard], mask)
    got = tgame.pearson_feature_scores(ids, tdata.response, tdata.shards[shard], mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)
    assert got[2].dtype == np.float64 and np.all((got[2] >= 0) & (got[2] <= 1 + 1e-12))
    if shard == "with_intercept":  # zero variance scores 1: always kept
        assert np.all(got[2][got[1] == tdata.shards[shard].dim - 1] == 1.0)


CASES = {
    "index-map": dict(random_effect_id="userId", feature_shard_id="per_user",
                      features_to_samples_ratio=0.3),
    "index-map-tight": dict(random_effect_id="userId", feature_shard_id="per_user",
                            features_to_samples_ratio=0.05),
    "index-map-capped": dict(random_effect_id="userId", feature_shard_id="with_intercept",
                             features_to_samples_ratio=0.5, active_upper_bound=8,
                             passive_lower_bound=1, num_shards=2),
    "identity": dict(random_effect_id="userId", feature_shard_id="with_intercept",
                     features_to_samples_ratio=0.2, projector="IDENTITY"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_random_effect_dataset_with_a_ratio_is_byte_equal(datasets, case):
    jdata, tdata = datasets
    want = j_build(jdata, JReConfig(**CASES[case]))
    got = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig(**CASES[case]),
                                            device="cpu")
    assert (got.num_entities, got.global_dim) == (want.num_entities, want.global_dim)
    for field in tgame.RandomEffectDataset.TENSOR_FIELDS:
        g, e = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == e.dtype and g.shape == e.shape, field
        assert g.tobytes() == e.tobytes(), field
    if case.startswith("index-map"):
        # the ratio selects: no entity keeps more than its budget
        full = tgame.build_random_effect_dataset(
            tdata, tgame.RandomEffectDataConfig(**{**CASES[case],
                                                   "features_to_samples_ratio": None}),
            device="cpu")
        per_entity = (got.local_to_global.numpy() >= 0).sum(1)
        assert per_entity.sum() < (full.local_to_global.numpy() >= 0).sum()
