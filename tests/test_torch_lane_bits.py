"""A lane's bits, and a scored row's bits, do not depend on the batch.

  * A dense ``(E, M, D)`` random-effect stack contracts through elementwise
    products and ``tree_row_sum`` (ops/features.py, ops/objective.py): a
    lane's margin, transpose, value+gradient and Hessian-vector product are
    bitwise equal whether it rides among 7, 64 or 1000 lanes. The solve
    scheduler, which moves lanes between batches, relies on this.
  * Scoring sums a row's K terms with ``tree_row_sum``
    (``models.game.gather_scores``, ``game_scoring_driver.fixed_contrib``
    and ``factored_contrib``): a row's score is bitwise equal in a batch of
    any row count and at any zero-padded K. Served scores rely on this to
    equal the batch driver's.

Inputs are made from a numpy seed; everything runs on the CPU.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.cli.game_scoring_driver import factored_contrib, fixed_contrib
from photon_ml_tpu_torch.models.game import gather_scores
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective

LANES = (7, 64, 1000)


def _stack(e, m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(e, m, d)) * (rng.random((e, m, d)) < 0.6)).astype(np.float32)
    y = (rng.random((e, m)) < 0.5).astype(np.float32)
    wt = (rng.random((e, m)) < 0.85).astype(np.float32)
    off = (0.1 * rng.normal(size=(e, m))).astype(np.float32)
    w = (0.3 * rng.normal(size=(e, d))).astype(np.float32)
    v = rng.normal(size=(e, d)).astype(np.float32)
    r = rng.normal(size=(e, m)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, y, wt, off, w, v, r)]


def _lane_outputs(x, y, wt, off, w, v, r, loss):
    feats = DenseFeatures(x)
    obj = GLMObjective(loss)
    batch = GLMBatch(feats, y, off, wt)
    norm = NormalizationContext.identity()
    val, grad = obj.value_and_grad(w, batch, norm, 0.5)
    return {"margin": feats.matvec(w), "transpose": feats.rmatvec(r),
            "sq_transpose": feats.sq_rmatvec(r), "value": val, "grad": grad,
            "hvp": obj.hessian_vector(w, v, batch, norm, 0.5),
            "plain_value": obj.value(w, batch, norm, 0.5)}


@pytest.mark.parametrize("loss_name", ["logistic", "poisson"])
@pytest.mark.parametrize("m,d", [(12, 9), (37, 33)])
def test_a_dense_stack_lane_has_the_same_bits_among_7_64_or_1000_lanes(loss_name, m, d):
    loss = getattr(losses, loss_name)
    full = _stack(max(LANES), m, d, seed=m * d)
    if loss_name == "poisson":
        full[1] = torch.floor(3 * full[1] + full[3].abs() * 10)
    keep = torch.from_numpy(np.random.default_rng(1).choice(max(LANES), LANES[0],
                                                            replace=False))
    ref = None
    for n in LANES:
        # a batch of n lanes holding the kept ones, at shuffled positions
        rest = np.setdiff1d(np.arange(max(LANES)), keep.numpy())
        extra = np.random.default_rng(n).choice(rest, n - LANES[0], replace=False)
        ids = torch.from_numpy(np.random.default_rng(n + 1).permutation(
            np.concatenate([keep.numpy(), extra])))
        out = _lane_outputs(*[t.index_select(0, ids) for t in full], loss)
        where = torch.stack([torch.nonzero(ids == k)[0, 0] for k in keep])
        got = {k: t.index_select(0, where) for k, t in out.items()}
        if ref is None:
            ref = got
            continue
        for key in ref:
            assert torch.equal(got[key], ref[key]), f"{key}: lane bits moved at {n} lanes"


def test_the_dense_stack_still_computes_the_products():
    x, y, wt, off, w, v, r = _stack(5, 6, 4, seed=3)
    feats = DenseFeatures(x.double())
    torch.testing.assert_close(feats.matvec(w.double()), torch.einsum("emd,ed->em",
                                                                      x.double(), w.double()))
    torch.testing.assert_close(feats.rmatvec(r.double()), torch.einsum("emd,em->ed",
                                                                       x.double(), r.double()))
    single = DenseFeatures(x[0])
    assert torch.equal(single.matvec(w[0]), x[0] @ w[0])  # one problem: the plain product


def _scoring_rows(n, k, seed):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, k + 1, size=n)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    for i, c in enumerate(nnz):
        idx[i, :c] = rng.choice(40, c, replace=False)
        val[i, :c] = rng.normal(size=c)
    ent = rng.integers(-1, 30, size=n).astype(np.int32)
    slab = rng.normal(size=(30, 40)).astype(np.float32)
    w = rng.normal(size=40).astype(np.float32)
    latent = rng.normal(size=(30, 4)).astype(np.float32)
    matrix = rng.normal(size=(4, 40)).astype(np.float32)
    return [torch.from_numpy(a) for a in (idx, val, ent, slab, w, latent, matrix)]


def _scores(idx, val, ent, slab, w, latent, matrix):
    return {"gather": gather_scores(slab, ent, idx, val), "fixed": fixed_contrib(w, idx, val),
            "factored": factored_contrib(latent, matrix, ent, idx, val)}


def test_scored_rows_have_the_same_bits_at_any_row_count_and_zero_padded_k():
    idx, val, ent, slab, w, latent, matrix = _scoring_rows(1000, 11, seed=5)
    ref = _scores(idx, val, ent, slab, w, latent, matrix)
    assert bool((ref["gather"][ent < 0] == 0).all())
    rng = np.random.default_rng(6)
    for n in (1, 7, 64, 999):
        rows = torch.from_numpy(np.sort(rng.choice(1000, n, replace=False)))
        for k_pad in (11, 12, 16, 32, 45):
            pad = k_pad - idx.shape[1]
            i2 = torch.nn.functional.pad(idx.index_select(0, rows), (0, pad))
            v2 = torch.nn.functional.pad(val.index_select(0, rows), (0, pad))
            got = _scores(i2, v2, ent.index_select(0, rows), slab, w, latent, matrix)
            for key in ref:
                assert torch.equal(got[key], ref[key].index_select(0, rows)), \
                    f"{key}: {n} rows at K={k_pad}"
