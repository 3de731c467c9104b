"""The port's padded-COO ``SparseFeatures`` against the JAX package on the
same numpy inputs (CPU): every method in both transpose layouts (the flat
scatter and the column-sorted segment sum) with f32 and bf16 storage, the
GLM objective's value+gradient, Hessian-vector product and Hessian diagonal
on a sparse batch with and without normalization, the sparse ``to_batch``,
the validators and the column summary on a sparse batch, and interop. All
at the ``elementwise`` tolerance of tests/tolerances.py (one pass).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import validators as jvalidators
from photon_ml_tpu.io.libsvm import HostDataset as JHostDataset
from photon_ml_tpu.io.libsvm import to_batch as j_to_batch
from photon_ml_tpu.ops import features as jfeatures
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.stats import summarize as j_summarize
from photon_ml_tpu.types import DataValidationType as JValidation
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.data import validators as tvalidators
from photon_ml_tpu_torch.io.libsvm import HostDataset, to_batch
from photon_ml_tpu_torch.ops import features as tfeatures
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.ops.objective import GLMBatch as TBatch
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.ops.stats import summarize as t_summarize
from photon_ml_tpu_torch.types import DataValidationType, TaskType
from tolerances import assert_allclose

N, K, D = 300, 7, 5000
STORAGE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _coo(rng, n=N, k=K, d=D):
    """Padded rows of 1..k entries (distinct, sorted columns); pad slots
    carry index 0 and value 0."""
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    for i in range(n):
        m = rng.integers(1, k + 1)
        idx[i, :m] = np.sort(rng.choice(d, size=m, replace=False))
        val[i, :m] = rng.normal(size=m)
    return idx, val


def _pair(idx, val, storage, transpose):
    jdt, tdt = STORAGE[storage]
    jf = jfeatures.SparseFeatures(jnp.asarray(idx), jnp.asarray(val, jdt), D)
    tf = tfeatures.SparseFeatures(torch.from_numpy(idx),
                                  torch.from_numpy(val).to(tdt), D)
    if transpose:
        jf, tf = jf.with_transpose(), tf.with_transpose()
    return jf, tf


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("transpose", [False, True], ids=["scatter", "sorted"])
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_every_method_matches_jax(rng, storage, transpose):
    idx, val = _coo(rng)
    jf, tf = _pair(idx, val, storage, transpose)
    if transpose:
        for f in ("t_idx", "t_row", "t_val"):
            assert np.array_equal(_np(getattr(tf, f)), _np(getattr(jf, f))), f
        assert tf.t_len.sum().item() == N * K
    w = rng.normal(size=D).astype(np.float32)
    d = rng.normal(size=N).astype(np.float32)
    acc = np.float32
    assert tf.num_rows == jf.num_rows == N
    assert_allclose(_np(tf.matvec(torch.from_numpy(w))), _np(jf.matvec(jnp.asarray(w))),
                    kind="elementwise", dtype=acc)
    for fn in ("rmatvec", "sq_rmatvec"):
        got = getattr(tf, fn)(torch.from_numpy(d))
        assert got.dtype == torch.float32 and got.shape == (D,)
        assert_allclose(_np(got), _np(getattr(jf, fn)(jnp.asarray(d))), kind="elementwise",
                        dtype=acc, err_msg=fn)
    assert_allclose(_np(tf.row_sq_norms()), _np(jf.row_sq_norms()), kind="elementwise",
                    dtype=acc)
    small_j = jfeatures.SparseFeatures(jf.indices[:20], jf.values[:20], D)
    small_t = tfeatures.SparseFeatures(tf.indices[:20], tf.values[:20], D)
    assert np.array_equal(_np(small_t.to_dense()), _np(small_j.to_dense()))
    cast_t, cast_j = tf.astype(torch.bfloat16), jf.astype(jnp.bfloat16)
    assert cast_t.values.dtype == torch.bfloat16 and cast_t.dim == D
    assert (cast_t.t_val is None) == (not transpose)
    assert_allclose(_np(cast_t.rmatvec(torch.from_numpy(d))),
                    _np(cast_j.rmatvec(jnp.asarray(d))), kind="elementwise", dtype=acc)


def test_both_layouts_give_the_same_bits(rng):
    """On the CPU the flat scatter and the sorted segment sum add each
    column's entries in the same row order."""
    idx, val = _coo(rng)
    tf = tfeatures.SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D)
    tt = tf.with_transpose()
    d = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    assert torch.equal(tf.rmatvec(d), tt.rmatvec(d))
    assert torch.equal(tf.sq_rmatvec(d), tt.sq_rmatvec(d))


def test_from_scipy_like_and_the_transpose_rule(rng, monkeypatch):
    rows = [([0, 7], [1.0, 2.0]), ([], []), ([4999], [-3.0])]
    jf = jfeatures.from_scipy_like(rows, D)
    tf = tfeatures.from_scipy_like(rows, D, device="cpu")
    assert np.array_equal(tf.indices.numpy(), np.asarray(jf.indices))
    assert np.array_equal(tf.values.numpy(), np.asarray(jf.values))
    wide = tfeatures.SparseFeatures(tf.indices, tf.values, 1 << 17)
    jwide = jfeatures.SparseFeatures(jf.indices, jf.values, 1 << 17)
    # the card's measured default: the sorted view on every sparse batch (the
    # JAX package keeps its v5e default, the scatter layout)
    monkeypatch.delenv(tfeatures.SPARSE_TRANSPOSE_ENV, raising=False)
    assert tfeatures.auto_transpose(wide).t_idx is not None
    assert tfeatures.auto_transpose(tf).t_idx is not None
    assert jfeatures.auto_transpose(jwide).t_idx is None
    monkeypatch.setenv(tfeatures.SPARSE_TRANSPOSE_ENV, "1")  # both packages: the view
    assert tfeatures.auto_transpose(wide).t_idx is not None
    assert jfeatures.auto_transpose(jwide).t_idx is not None
    got, want = tfeatures.auto_transpose(tf), jf.with_transpose()
    for f in ("t_idx", "t_row", "t_val"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    monkeypatch.setenv(tfeatures.SPARSE_TRANSPOSE_ENV, "0")
    assert tfeatures.auto_transpose(wide).t_idx is None
    assert tfeatures.auto_transpose(tf).t_idx is None


LOSSES = ["logistic", "squared", "poisson"]


def _norm_pair(rng):
    factors = rng.uniform(0.5, 2.0, size=D).astype(np.float32)
    shifts = rng.normal(scale=0.1, size=D).astype(np.float32)
    factors[-1], shifts[-1] = 1.0, 0.0  # the intercept column
    return (JNorm(jnp.asarray(factors), jnp.asarray(shifts), D - 1),
            TNorm(torch.from_numpy(factors), torch.from_numpy(shifts), D - 1))


@pytest.mark.parametrize("normalized", [False, True], ids=["identity", "normalized"])
@pytest.mark.parametrize("transpose", [False, True], ids=["scatter", "sorted"])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_objective_on_a_sparse_batch_matches_jax(rng, loss_name, transpose, normalized):
    idx, val = _coo(rng)
    jf, tf = _pair(idx, val, "f32", transpose)
    if loss_name == "poisson":
        y = rng.poisson(1.5, size=N).astype(np.float32)
    elif loss_name == "squared":
        y = rng.normal(size=N).astype(np.float32)
    else:
        y = (rng.random(N) < 0.5).astype(np.float32)
    off = rng.normal(scale=0.2, size=N).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    wt[::17] = 0.0
    jb = JBatch(jf, *(jnp.asarray(a) for a in (y, off, wt)))
    tb = TBatch(tf, *(torch.from_numpy(a) for a in (y, off, wt)))
    if normalized:
        jn, tn = _norm_pair(rng)
    else:
        jn, tn = JNorm.identity(), TNorm.identity()
    jo, to = JObjective(getattr(jlosses, loss_name)), TObjective(getattr(tlosses, loss_name))
    assert not to._use_fused(tb) and not to._use_sparse_fused(tb)
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    (fj, gj), (ft, gt) = jo.value_and_grad(jw, jb, jn, 0.3), to.value_and_grad(tw, tb, tn, 0.3)
    assert_allclose(ft.numpy(), np.asarray(fj), kind="elementwise")
    assert_allclose(gt.numpy(), np.asarray(gj), kind="elementwise")
    assert_allclose(to.hessian_vector(tw, tv, tb, tn, 0.3).numpy(),
                    np.asarray(jo.hessian_vector(jw, jv, jb, jn, 0.3)), kind="elementwise")
    assert_allclose(to.hessian_diagonal(tw, tb, tn, 0.3).numpy(),
                    np.asarray(jo.hessian_diagonal(jw, jb, jn, 0.3)), kind="elementwise")
    assert_allclose(to.mean_prediction(tw, tb, tn).numpy(),
                    np.asarray(jo.mean_prediction(jw, jb, jn)), kind="elementwise")


def _host_dataset(rng, n=40, d=5001):
    idx, val = _coo(rng, n, 5, d)
    lens = (val != 0).sum(1)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    indices = np.concatenate([idx[i, :m] for i, m in enumerate(lens)]).astype(np.int32)
    values = np.concatenate([val[i, :m] for i, m in enumerate(lens)]).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    return (JHostDataset(labels, indptr, indices, values, d),
            HostDataset(labels, indptr, indices, values, d))


def test_sparse_to_batch_validators_and_summary_match_jax(rng):
    jds, tds = _host_dataset(rng)
    jb = j_to_batch(jds, dense=False)
    tb = to_batch(tds, dense=False, device="cpu")
    assert isinstance(tb.features, tfeatures.SparseFeatures) and tb.dim == 5001
    for f in ("indices", "values"):
        assert np.array_equal(getattr(tb.features, f).numpy(), np.asarray(getattr(jb.features, f)))
    for f in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    for vtype in ("VALIDATE_FULL", "VALIDATE_SAMPLE"):
        jvalidators.sanity_check_data(jb, JTask.LOGISTIC_REGRESSION, JValidation(vtype))
        tvalidators.sanity_check_data(tb, TaskType.LOGISTIC_REGRESSION, DataValidationType(vtype))
    sub = tvalidators._subsample(tb, 0.5)
    assert sub.features.t_idx is None and sub.num_rows == jvalidators._subsample(jb, 0.5).num_rows
    bad = TBatch(tfeatures.SparseFeatures(tb.features.indices, tb.features.values * np.inf,
                                          tb.dim), tb.labels, tb.offsets, tb.weights)
    with pytest.raises(ValueError, match="Finite features"):
        tvalidators.sanity_check_data(bad, TaskType.LOGISTIC_REGRESSION)
    js, ts = j_summarize(jb), t_summarize(tb)
    for f in ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1", "norm_l2"):
        assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), kind="elementwise",
                        err_msg=f)


@pytest.mark.parametrize("transpose", [False, True], ids=["scatter", "sorted"])
def test_interop_carries_sparse_features_both_ways(rng, transpose):
    idx, val = _coo(rng)
    jf, _ = _pair(idx, val, "f32", transpose)
    tf = interop.from_jax_numpy(jf, "cpu")
    assert isinstance(tf, tfeatures.SparseFeatures) and tf.dim == D
    assert (tf.t_idx is None) == (not transpose)
    d = rng.normal(size=N).astype(np.float32)
    assert_allclose(tf.rmatvec(torch.from_numpy(d)).numpy(), np.asarray(jf.rmatvec(jnp.asarray(d))),
                    kind="elementwise")
    back = jfeatures.SparseFeatures(**{k: (v if k == "dim" else None if v is None else jnp.asarray(v))
                                       for k, v in interop.to_numpy(tf).items()})
    for f in ("indices", "values", "t_idx", "t_row", "t_val"):
        a, b = getattr(back, f), getattr(jf, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f
