"""The port's fused value+gradient contract ``(sum wl, X^T d, sum d)``.

On the CPU the port's ``fused_value_grad_parts`` runs its plain version; it
is held against the JAX ``fused_value_grad_parts`` in Pallas interpret mode
for each of the three Pallas families the CUDA kernel replaces (grid, VPU,
manual double-buffered), and against a float64 numpy oracle at an odd D.
The kernel itself runs only on the card: its tests are in
tests/test_torch_kernel_gpu.py.

Tolerances: f32 at ``elementwise``. bf16 at rtol 1e-2 / atol 1e-3, because
d is rounded to bf16 before the gradient product, and a margin that differs
by summation order between the frameworks can land that rounding on the
other side of a bf16 ulp (2^-8 relative) for a row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import fused_glm as jfused
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu_torch.ops import fused_glm as tfused
from photon_ml_tpu_torch.ops import losses as tlosses
from tolerances import assert_allclose

FAMILIES = {"grid": 256, "vpu": jfused.VPU_MARK + 256, "manual": -256}
LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
STORAGE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, loss_name, n, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if loss_name == "poisson":
        y = rng.poisson(1.5, size=n).astype(np.float32)
    elif loss_name == "squared":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = (rng.random(n) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::11] = 0.0
    off = rng.normal(scale=0.2, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.05).astype(np.float32)
    return x, y, wt, off, w


def _check(got, want, storage):
    if storage == "f32":
        for g, e in zip(got, want):
            assert_allclose(g, e, kind="elementwise")
    else:
        for g, e in zip(got, want):
            np.testing.assert_allclose(g, e, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_matches_each_pallas_family(family, loss_name, storage, d):
    jdt, tdt = STORAGE[storage]
    x, y, wt, off, w = _inputs(d + len(loss_name), loss_name, 1000, d)  # ragged N
    want = jfused.fused_value_grad_parts(
        getattr(jlosses, loss_name), jnp.asarray(x, jdt), jnp.asarray(y), jnp.asarray(wt),
        jnp.asarray(off), jnp.asarray(w), block_rows=FAMILIES[family], interpret=True,
    )
    t = lambda a: torch.from_numpy(a)
    xt = t(x).to(tdt)
    if family == "vpu" and storage == "bf16":
        # the VPU family upcasts the bf16 tile and multiplies by the f32 w
        # and f32 d unrounded, unlike the grid and manual families (and the
        # CUDA kernel), which round both to bf16; its arithmetic is the plain
        # version's on f32 storage of the bf16-rounded X
        xt, storage = xt.to(torch.float32), "f32"
    got = tfused.fused_value_grad_parts(getattr(tlosses, loss_name), xt, t(y), t(wt), t(off), t(w))
    assert all(g.dtype == torch.float32 for g in got)
    _check([g.numpy() for g in got], [np.asarray(e) for e in want], storage)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_plain_matches_float64_oracle_at_odd_width(loss_name):
    x, y, wt, off, w = _inputs(7, loss_name, 301, 65)
    wt[5] = 0.0
    off[5] = 1e4  # padding row whose loss overflows: masked to an exact 0
    t = lambda a: torch.from_numpy(a)
    lv, g, sd = tfused.fused_value_grad_parts(getattr(tlosses, loss_name), t(x), t(y), t(wt),
                                              t(off), t(w))
    loss64 = getattr(tlosses, loss_name)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    z = torch.from_numpy(x64 @ w64 + off)
    keep = wt > 0
    l = loss64.loss(z, torch.from_numpy(y.astype(np.float64))).numpy()
    d1 = loss64.d1(z, torch.from_numpy(y.astype(np.float64))).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        wl = np.where(keep, wt * l, 0.0)
        dd = np.where(keep, wt * d1, 0.0)
    assert_allclose(lv.numpy(), wl.sum(), kind="elementwise", dtype=np.float32)
    assert_allclose(g.numpy(), dd @ x64, kind="elementwise", dtype=np.float32)
    assert_allclose(sd.numpy(), dd.sum(), kind="elementwise", dtype=np.float32)


def test_launch_geometry_covers_every_row_once():
    for n, d, dtype in ((262144, 512, torch.bfloat16), (262107, 512, torch.float32),
                        (1000, 65, torch.float32), (5, 4096, torch.float32), (1, 1, torch.bfloat16)):
        tr, grid, rows_per_cta, smem = tfused.launch_geometry(n, d, dtype, sm_count=132)
        assert 1 <= tr <= tfused.MAX_TILE_ROWS and rows_per_cta % tr == 0
        assert (grid - 1) * rows_per_cta < n <= grid * rows_per_cta  # no empty CTA
        assert grid <= tfused.CTAS_PER_SM * 132
        assert smem <= 227 * 1024


def test_objective_dispatch_uses_fused_pieces_with_normalization(rng):
    """With ``fused_block_rows`` set, value_and_grad folds shifts, factors
    and L2 around the fused pieces exactly as the plain path does."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
    from photon_ml_tpu_torch.types import NormalizationType

    x, y, wt, off, w = _inputs(3, "logistic", 300, 9)
    t = lambda a: torch.from_numpy(a)
    batch = GLMBatch(DenseFeatures(t(x)), t(y), t(off), t(wt))
    norm = NormalizationContext.build(NormalizationType.STANDARDIZATION, mean=t(x.mean(0)),
                                      std=t(x.std(0)), intercept_id=8)
    plain = GLMObjective(tlosses.logistic)
    fused = GLMObjective(tlosses.logistic, fused_block_rows=16)
    v0, g0 = plain.value_and_grad(t(w), batch, norm, 0.25)
    v1, g1 = fused.value_and_grad(t(w), batch, norm, 0.25)
    assert_allclose(v1.numpy(), v0.numpy(), kind="elementwise")
    assert_allclose(g1.numpy(), g0.numpy(), kind="elementwise")
