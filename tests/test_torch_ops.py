"""The port's losses, normalization algebra, DenseFeatures and GLMObjective
against the JAX package on the same numpy inputs (CPU), at the
``elementwise`` tolerance of tests/tolerances.py (one pass, no iteration)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.types import NormalizationType as JNormType
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.features import DenseFeatures as TDense
from photon_ml_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.ops.objective import GLMBatch as TBatch
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.types import NormalizationType as TNormType
from photon_ml_tpu_torch.types import TaskType
from tolerances import assert_allclose

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
STORAGE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _labels(rng, loss_name, n):
    if loss_name == "poisson":
        return rng.poisson(1.5, size=n).astype(np.float32)
    if loss_name == "squared":
        return rng.normal(size=n).astype(np.float32)
    return (rng.random(n) < 0.5).astype(np.float32)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_loss_functions_match(rng, loss_name):
    jl, tl = getattr(jlosses, loss_name), getattr(tlosses, loss_name)
    z = rng.normal(scale=3.0, size=257).astype(np.float32)
    z[:4] = [0.0, 1.0, -1.0, 40.0]  # hinge kinks and a large margin
    y = _labels(rng, loss_name, 257)
    for fn in ("loss", "d1", "d2"):
        assert_allclose(getattr(tl, fn)(_t(z), _t(y)).numpy(),
                        np.asarray(getattr(jl, fn)(jnp.asarray(z), jnp.asarray(y))),
                        kind="elementwise", err_msg=f"{loss_name}.{fn}")
    assert_allclose(tl.mean(_t(z)).numpy(), np.asarray(jl.mean(jnp.asarray(z))),
                    kind="elementwise")
    assert tl.twice_differentiable == jl.twice_differentiable
    for task in TaskType:
        assert tlosses.for_task(task).name == jlosses.for_task(task.value).name


def _stats(rng, d, intercept):
    mean = rng.normal(size=d).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    std[1] = 0.0  # zero-variance column gets factor 1
    mag = rng.uniform(0.5, 3.0, size=d).astype(np.float32)
    return mean, std, mag


@pytest.mark.parametrize("norm_type", [t.value for t in TNormType])
def test_normalization_algebra_matches(rng, norm_type):
    d, intercept = 9, 8
    mean, std, mag = _stats(rng, d, intercept)
    jn = JNorm.build(JNormType(norm_type), mean=jnp.asarray(mean), std=jnp.asarray(std),
                     max_magnitude=jnp.asarray(mag), intercept_id=intercept)
    tn = TNorm.build(TNormType(norm_type), mean=_t(mean), std=_t(std),
                     max_magnitude=_t(mag), intercept_id=intercept)
    via_interop = interop.from_jax_numpy(jn, "cpu")
    for ctx in (tn, via_interop):
        for name in ("factors", "shifts"):
            a, b = getattr(ctx, name), getattr(jn, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert_allclose(a.numpy(), np.asarray(b), kind="elementwise")
    w = rng.normal(size=d).astype(np.float32)
    assert_allclose(tn.model_to_original_space(_t(w)).numpy(),
                    np.asarray(jn.model_to_original_space(jnp.asarray(w))), kind="elementwise")
    w_eff = tn.effective_coefficients(_t(w))
    assert_allclose(w_eff.numpy(), np.asarray(jn.effective_coefficients(jnp.asarray(w))),
                    kind="elementwise")
    assert_allclose(tn.margin_shift(w_eff).numpy(),
                    np.asarray(jn.margin_shift(jn.effective_coefficients(jnp.asarray(w)))),
                    kind="elementwise")
    back = interop.to_numpy(tn)
    assert back["intercept_id"] == intercept


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_dense_features_match(rng, storage):
    jdt, tdt = STORAGE[storage]
    x = rng.normal(size=(96, 40)).astype(np.float32)
    w = rng.normal(size=40).astype(np.float32)
    d = rng.normal(size=96).astype(np.float32)
    jf, tf = JDense(jnp.asarray(x, jdt)), TDense(_t(x).to(tdt))
    for name, arg in (("matvec", w), ("rmatvec", d), ("sq_rmatvec", d)):
        got = getattr(tf, name)(_t(arg))
        assert got.dtype == torch.float32  # f32 accumulation for bf16 storage too
        assert_allclose(got.numpy(), np.asarray(getattr(jf, name)(jnp.asarray(arg))),
                        kind="elementwise", err_msg=f"{storage} {name}")


def _batches(rng, loss_name, storage, n=203, d=24):
    """Same batch for both packages: offsets, 1 in 7 rows with weight 0 whose
    offsets make the loss overflow (inf/nan garbage the mask must zero)."""
    jdt, tdt = STORAGE[storage]
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    y = _labels(rng, loss_name, n)
    off = rng.normal(scale=0.3, size=n).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::7] = 0.0
    off[::7] = 1e4 if loss_name == "poisson" else 1e30
    jb = JBatch(JDense(jnp.asarray(x, jdt)), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    tb = TBatch(TDense(_t(x).to(tdt)), _t(y), _t(off), _t(wt))
    return x, jb, tb


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("normalized", [False, True])
def test_objective_matches(rng, loss_name, storage, normalized):
    x, jb, tb = _batches(rng, loss_name, storage)
    d = x.shape[1]
    if normalized:
        jn = JNorm.build(JNormType.STANDARDIZATION, mean=jnp.asarray(x.mean(0)),
                         std=jnp.asarray(x.std(0)), intercept_id=d - 1)
    else:
        jn = JNorm.identity()
    tn = interop.from_jax_numpy(jn, "cpu")
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    jw, tw = jnp.asarray(w), _t(w)
    jo, to = JObjective(getattr(jlosses, loss_name)), TObjective(getattr(tlosses, loss_name))
    l2 = 0.3

    tv, tg = to.value_and_grad(tw, tb, tn, l2)
    jv, jg = jo.value_and_grad(jw, jb, jn, l2)
    assert np.isfinite(tv.item()) and torch.isfinite(tg).all()
    assert_allclose(tv.numpy(), np.asarray(jv), kind="elementwise")
    assert_allclose(tg.numpy(), np.asarray(jg), kind="elementwise")
    assert_allclose(to.value(tw, tb, tn, l2).numpy(), np.asarray(jo.value(jw, jb, jn, l2)),
                    kind="elementwise")
    assert_allclose(to.hessian_diagonal(tw, tb, tn, l2).numpy(),
                    np.asarray(jo.hessian_diagonal(jw, jb, jn, l2)), kind="elementwise")
    if getattr(tlosses, loss_name).twice_differentiable:
        assert_allclose(to.hessian_vector(tw, _t(v), tb, tn, l2).numpy(),
                        np.asarray(jo.hessian_vector(jw, jnp.asarray(v), jb, jn, l2)),
                        kind="elementwise")
    keep = tb.weights > 0  # padding rows' means are garbage by construction
    assert_allclose(to.mean_prediction(tw, tb, tn)[keep].numpy(),
                    np.asarray(jo.mean_prediction(jw, jb, jn))[keep.numpy()], kind="elementwise")
