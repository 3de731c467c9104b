"""The CUDA kernels of photon_ml_tpu_torch/csrc/ (fused_glm.cu and
fused_sparse.cu) against their plain PyTorch versions, on the card. Every
test here needs a CUDA card (a kernel has no CPU mode): each carries the
``gpu`` marker and skips where ``torch.cuda`` is unavailable. This file
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Tolerance of the dense kernel: value and gradient relative error, and the
error of sum d over sum |d|, 1e-5 in f32 (summation order only) and 1e-3 in bf16 (the rounding
of d to bf16 can land on the other side of an ulp when the margin's
summation order differs).
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import fused_glm as tfused
from photon_ml_tpu_torch.ops import losses as tlosses

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


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
    off[::11] = 1e4  # padding rows whose loss overflows: masked to 0
    w = (rng.normal(size=d) * 0.05).astype(np.float32)
    return x, y, wt, off, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("loss_name", LOSSES)
def test_kernel_matches_plain_on_card(cuda_device, loss_name, storage):
    tol = 1e-5 if storage == "f32" else 1e-3
    # D=1000, 2048 and 4096 take the 4-, 8- and 16-column stage-1 instantiations
    for n, d in ((4099, 512), (1000, 65), (2051, 1000), (2048, 2048), (1031, 4096)):
        x, y, wt, off, w = _inputs(n + d, loss_name, n, d)
        t = lambda a: torch.from_numpy(a).to(cuda_device)
        args = (getattr(tlosses, loss_name), t(x).to(STORAGE[storage]), t(y), t(wt), t(off), t(w))
        before = tfused.fused_value_grad_kernel.launches
        got = tfused.fused_value_grad_parts(*args)
        again = tfused.fused_value_grad_parts(*args)
        want = tfused.fused_value_grad_parts_plain(*args)
        torch.cuda.synchronize()
        assert tfused.fused_value_grad_kernel.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic
        assert abs(got[0] - want[0]) <= tol * abs(want[0])
        assert torch.linalg.vector_norm(got[1] - want[1]) <= tol * torch.linalg.vector_norm(want[1])
        # sum d is near 0 for balanced labels: its scale is sum |d|
        z = args[1].float() @ args[5].to(args[1].dtype).float() + args[4]
        d_abs = torch.where(args[3] > 0, args[3] * args[0].d1(z, args[2]), torch.zeros_like(z)).abs().sum()
        assert abs(got[2] - want[2]) <= tol * (abs(want[2]) + d_abs)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, y, wt, off, w = (torch.from_numpy(a).to(cuda_device) for a in _inputs(0, "logistic", 64, 8))
    lo = tlosses.logistic
    with pytest.raises(ValueError):
        tfused.fused_value_grad_kernel(lo, x.double(), y, wt, off, w)  # f64 storage
    with pytest.raises(ValueError):
        tfused.fused_value_grad_kernel(lo, x.t(), y[:8], wt[:8], off[:8], w)  # not contiguous
    with pytest.raises(ValueError):
        tfused.fused_value_grad_kernel(lo, x, y.double(), wt, off, w)
    with pytest.raises(ValueError):
        tfused.fused_value_grad_kernel(lo, x, y, wt, off, w.cpu())
    with pytest.raises(ValueError):
        tfused.fused_value_grad_kernel(lo, torch.zeros((4, 4097), device=cuda_device),
                                       y[:4], wt[:4], off[:4], torch.zeros(4097, device=cuda_device))


# --- the sparse-slab GEVM and HVP kernels of csrc/fused_sparse.cu ----------
# Loss sums and gradient/HVP by relative error; sum d and sum c by error
# over |sum| + sum |.|; 1e-5 in f32 and with bf16 values alike (both sides
# compute in f32 on the same promoted values: summation order only).

from photon_ml_tpu_torch.ops import fused_sparse as tsparse  # noqa: E402


def _slab_inputs(seed, loss_name, e, m, d, max_nnz, device, full=False):
    rng = np.random.default_rng(seed)
    x = np.zeros((e, m, d), np.float32)
    nnz = np.full((e, m), max_nnz) if full else rng.integers(1, max_nnz + 1, size=(e, m))
    for i in range(e):
        for r in range(m):
            cols = rng.choice(d, size=nnz[i, r], replace=False)
            x[i, r, cols] = rng.normal(size=nnz[i, r])
    _, y, wt, off, _ = _inputs(seed, loss_name, e * m, 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    w = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    v = rng.normal(size=(e, d)).astype(np.float32)
    vshift = rng.normal(size=e).astype(np.float32)
    slab = tsparse.build_sparse_slab(t(x), kernel="pallas")
    rows = lambda a: t(a.reshape(e, m))
    return slab, rows(y), rows(wt), rows(off), t(w), t(v), t(vshift)


def _close(got, want, tol, scale=None):
    err = torch.linalg.vector_norm((got - want).double())
    ref = torch.linalg.vector_norm(want.double()) if scale is None else scale
    return bool(err <= tol * ref + 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("loss_name", LOSSES)
def test_sparse_kernels_match_plain_on_card(cuda_device, loss_name, storage):
    tol = 1e-5
    # the full width, a ragged M, K=1, an odd D, a wide D, the GAME
    # driver's slab shape (M=12, D=K=9, every slot filled), D=4096 with 10
    # lanes per block, lanes straddling the packed blocks' edge, and a lane
    # too large to stage
    for e, m, d, max_nnz, full in ((256, 64, 2048, 16, False), (128, 37, 2048, 16, False),
                                   (64, 64, 2048, 1, False), (64, 64, 65, 9, False),
                                   (32, 48, 4096, 16, False), (2000, 12, 9, 9, True),
                                   (25, 12, 4096, 9, False), (100, 7, 300, 5, False),
                                   (2, 20000, 24, 4, False)):
        slab, y, wt, off, w, v, vshift = _slab_inputs(e + m + d, loss_name, e, m, d, max_nnz,
                                                      cuda_device, full)
        if storage == "bf16":
            slab = slab.astype(torch.bfloat16)
        loss = getattr(tlosses, loss_name)
        before = (tsparse.sparse_gevm_kernel.launches, tsparse.sparse_hvp_kernel.launches)
        got = tsparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
        again = tsparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
        hvp = tsparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
        hvp_again = tsparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
        want = tsparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w)
        want_hvp = tsparse.fused_hvp_parts_plain(loss, slab, y, wt, off, w, v, vshift)
        torch.cuda.synchronize()
        assert (tsparse.sparse_gevm_kernel.launches, tsparse.sparse_hvp_kernel.launches) == (
            before[0] + 2, before[1] + 2)
        assert all(torch.equal(a, b) for a, b in zip(got + hvp, again + hvp_again))
        z = slab.matvec(w) + off
        d_abs = torch.where(wt > 0, wt * loss.d1(z, y), torch.zeros_like(z)).abs().sum(-1)
        c_abs = (torch.where(wt > 0, wt * loss.d2(z, y), torch.zeros_like(z))
                 * (slab.matvec(v) + vshift[:, None])).abs().sum(-1)
        assert _close(got[0], want[0], tol) and _close(got[1], want[1], tol)
        assert torch.all((got[2] - want[2]).abs() <= tol * (want[2].abs() + d_abs))
        assert _close(hvp[0], want_hvp[0], tol)
        assert torch.all((hvp[1] - want_hvp[1]).abs() <= tol * (want_hvp[1].abs() + c_abs))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("shape", [(256, 64, 2048, 16, False), (2000, 12, 9, 9, True),
                                   (100, 7, 300, 5, False), (25, 12, 4096, 9, False),
                                   (3, 20000, 24, 4, False)])
def test_lane_indirect_launch_equals_the_full_launch_bitwise(cuda_device, shape, storage):
    """Every position of the lane-indirect launch equals its lane's row of
    the full launch, bit for bit, at any lane count and order (the solve
    scheduler's contract), and the plain version of the gathered lanes
    within the kernels' tolerance."""
    e, m, d, max_nnz, full = shape
    slab, y, wt, off, w, v, vshift = _slab_inputs(e + m, "logistic", e, m, d, max_nnz,
                                                  cuda_device, full)
    if storage == "bf16":
        slab = slab.astype(torch.bfloat16)
    loss = tlosses.logistic
    whole = tsparse.fused_value_grad_parts(loss, slab, y, wt, off, w)
    whole_hvp = tsparse.fused_hvp_parts(loss, slab, y, wt, off, w, v, vshift)
    rng = np.random.default_rng(e)
    for n in sorted({1, 2, min(7, e), min(16, e), min(64, e), e}):
        for order in ("ascending", "shuffled"):
            ids = rng.choice(e, size=n, replace=False)
            ids = np.sort(ids) if order == "ascending" else ids
            idt = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
            lanes = tsparse.SlabLanes(slab, idt)
            sel = lambda t: t.index_select(0, idt.long()).contiguous()
            before = (tsparse.sparse_gevm_kernel.launches, tsparse.sparse_hvp_kernel.launches)
            got = tsparse.fused_value_grad_parts(loss, lanes, sel(y), sel(wt), sel(off), sel(w))
            hvp = tsparse.fused_hvp_parts(loss, lanes, sel(y), sel(wt), sel(off), sel(w),
                                          sel(v), sel(vshift))
            torch.cuda.synchronize()
            assert (tsparse.sparse_gevm_kernel.launches,
                    tsparse.sparse_hvp_kernel.launches) == (before[0] + 1, before[1] + 1)
            for a, b in zip(got + hvp, whole + whole_hvp):
                assert torch.equal(a, sel(b)), (n, order)
            want = tsparse.fused_value_grad_parts_plain(loss, lanes, sel(y), sel(wt), sel(off),
                                                        sel(w))
            want_hvp = tsparse.fused_hvp_parts_plain(loss, lanes, sel(y), sel(wt), sel(off),
                                                     sel(w), sel(v), sel(vshift))
            assert _close(got[1], want[1], 1e-5) and _close(hvp[0], want_hvp[0], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 64, 2048, 16), (2000, 12, 9, 9), (100, 7, 300, 5),
                                   (2, 20000, 24, 4)])
def test_sparse_kernel_sums_are_tree_row_sums_of_their_row_values(cuda_device, shape):
    """Handed a buffer, the kernels write their row values; each per-lane
    sum they return is tree_row_sum of those values, bit for bit."""
    e, m, d, max_nnz = shape
    slab, y, wt, off, w, v, vshift = _slab_inputs(sum(shape), "poisson", e, m, d, max_nnz,
                                                  cuda_device)
    lo = tlosses.poisson
    rows, c = torch.empty((2, e, m), device=cuda_device), torch.empty((1, e, m), device=cuda_device)
    sum_wl, grad, sum_d = tsparse.sparse_gevm_kernel(lo, slab, y, wt, off, w, row_values=rows)
    hvp, sum_c = tsparse.sparse_hvp_kernel(lo, slab, y, wt, off, w, v, vshift, row_values=c)
    assert torch.equal(sum_wl, tsparse.tree_row_sum(rows[0]))
    assert torch.equal(sum_d, tsparse.tree_row_sum(rows[1]))
    assert torch.equal(sum_c, tsparse.tree_row_sum(c[0]))
    # the main path's call returns the same values without the buffer
    again = tsparse.fused_value_grad_parts(lo, slab, y, wt, off, w)
    assert all(torch.equal(a, b) for a, b in zip(again, (sum_wl, grad, sum_d)))
    assert all(torch.equal(a, b) for a, b in zip(
        tsparse.fused_hvp_parts(lo, slab, y, wt, off, w, v, vshift), (hvp, sum_c)))
    # one vshift for every lane (the objective's case) is read with stride 0
    one = vshift[:1].reshape(())
    assert all(torch.equal(a, b) for a, b in zip(
        tsparse.fused_hvp_parts(lo, slab, y, wt, off, w, v, one),
        tsparse.fused_hvp_parts(lo, slab, y, wt, off, w, v, one.expand(e).contiguous())))


@pytest.mark.gpu
def test_sparse_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    slab, y, wt, off, w, v, vshift = _slab_inputs(0, "logistic", 8, 16, 32, 4, cuda_device)
    lo = tlosses.logistic
    with pytest.raises(ValueError):
        tsparse.sparse_gevm_kernel(lo, slab.astype(torch.float64), y, wt, off, w)
    with pytest.raises(ValueError):
        tsparse.sparse_gevm_kernel(lo, slab, y.double(), wt, off, w)
    with pytest.raises(ValueError):
        tsparse.sparse_gevm_kernel(lo, slab, y, wt, off, w[:, :31])
    with pytest.raises(ValueError):
        tsparse.sparse_hvp_kernel(lo, slab, y, wt, off, w, v, vshift.cpu())
    with pytest.raises(ValueError):
        tsparse.sparse_hvp_kernel(lo, slab, y, wt, off, w, v.t().contiguous().t(), vshift[:4])
    with pytest.raises(ValueError):
        tsparse.sparse_gevm_kernel(lo, slab, y, wt, off, w.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        tsparse.sparse_gevm_kernel(lo, slab, y, wt, off, w, row_values=torch.empty(
            (1, 8, 16), device=cuda_device))  # GEVM writes two row values
    with pytest.raises(ValueError, match="CUDA"):
        cpu = tsparse.SparseSlab(slab.idx.cpu(), slab.val.cpu(), slab.dim, "pallas")
        tsparse.sparse_gevm_kernel(lo, cpu, y, wt, off, w)


@pytest.mark.gpu
def test_scoring_driver_on_the_card_equals_its_host_oracle(cuda_device, tmp_path):
    """The GAME scoring driver's device path (the fixed-effect matvec and
    the per-entity gather on the card) against its numpy host path, on a
    model the training driver fits on the card."""
    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import schemas

    rng = np.random.default_rng(17)
    schema = {"name": "G", "namespace": "t", "type": "record", "fields": [
        {"name": "label", "type": "double"},
        {"name": "fixedFeatures", "type": {"type": "array", "items": schemas.FEATURE}},
        {"name": "userFeatures", "type": {"type": "array",
                                          "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None}]}

    def records(n, users):
        for _ in range(n):
            yield {"label": float(rng.random() < 0.5),
                   "fixedFeatures": [{"name": f"f{j}", "term": "", "value": float(rng.normal())}
                                     for j in range(4)],
                   "userFeatures": [{"name": f"u{j}", "term": "", "value": float(rng.normal())}
                                    for j in range(3)],
                   "metadataMap": {"userId": f"user{rng.integers(0, users)}"}}

    for name, n, users in (("train", 600, 30), ("score", 300, 40)):  # 10 cold users
        avro_io.write_container(str(tmp_path / name / "part-0.avro"), records(n, users), schema)
    sections = ["--feature-shard-id-to-feature-section-keys-map",
                "global:fixedFeatures|per_user:userFeatures"]
    game_training_driver.main([
        "--train-input-dirs", str(tmp_path / "train"), "--output-dir", str(tmp_path / "model"),
        "--task-type", "LOGISTIC_REGRESSION", "--updating-sequence", "fixed,per-user",
        "--fixed-effect-data-configurations", "fixed:global,1",
        "--random-effect-data-configurations", "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
        "--fixed-effect-optimization-configurations", "fixed:30,1e-7,0.01,1,LBFGS,L2",
        "--random-effect-optimization-configurations", "per-user:30,1e-6,0.1,1,LBFGS,L2",
    ] + sections)
    scores = {}
    for host in ("false", "true"):
        d = game_scoring_driver.main([
            "--input-dirs", str(tmp_path / "score"),
            "--game-model-input-dir", str(tmp_path / "model" / "best"),
            "--output-dir", str(tmp_path / f"scores-{host}"), "--host-scoring", host,
            "--evaluator-type", "AUC"] + sections)
        assert d.device.type == "cuda"
        scores[host] = d.scores
    assert np.all(np.isfinite(scores["false"]))
    np.testing.assert_allclose(scores["false"], scores["true"], rtol=1e-4, atol=1e-5)


def _phase20_bucket_shapes():
    """(E, M) of phase 20's size buckets (chip_smoke.py: 20000 users,
    min(zipf(1.9) + 4, 2048) rows each, 80% of them training rows)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rows = chip_smoke.skewed_rows(chip_smoke.SKEW_USERS, chip_smoke.SKEW_SEED)
    return chip_smoke.expected_buckets(rows)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("loss_name", ["logistic", "squared", "poisson"])
def test_sparse_kernels_are_bitwise_the_plain_version_at_nonzero_w(cuda_device, loss_name,
                                                                   storage):
    """At w != 0 the plain margin adds its K products in the kernels'
    association (``kernel_order_row_sum``), so the kernels' row values (the
    weighted losses and d, functions of z; c, of z and zv) and every output
    of both kernels equal the plain version's bit for bit: at full width, at
    the GAME driver's slab shape and at phase 20's bucket shapes. The
    losses' ``y * z`` is rounded before the subtraction in ``losses.cuh``
    as in torch (unfused, the Poisson loss parted in its last bits:
    tools/sparse_loss_bits.py)."""
    shapes = [(256, 64, 2048, 16, False), (20000, 12, 9, 9, True)]
    shapes += [(e, m, 9, 9, True) for e, m in _phase20_bucket_shapes()]
    loss = getattr(tlosses, loss_name)
    for e, m, d, max_nnz, full in shapes:
        slab, y, wt, off, w, v, vshift = _slab_inputs(e + m + d, loss_name, e, m, d, max_nnz,
                                                      cuda_device, full)
        if storage == "bf16":
            slab = slab.astype(torch.bfloat16)
        assert bool(torch.all(w != 0))
        rows = torch.empty((2, e, m), device=cuda_device)
        c_rows = torch.empty((1, e, m), device=cuda_device)
        got = tsparse.sparse_gevm_kernel(loss, slab, y, wt, off, w, row_values=rows)
        got_hvp = tsparse.sparse_hvp_kernel(loss, slab, y, wt, off, w, v, vshift,
                                            row_values=c_rows)
        z = slab.matvec(w) + off
        masked = lambda x: torch.where(wt > 0, wt * x, torch.zeros_like(x))
        c = masked(loss.d2(z, y)) * (slab.matvec(v) + vshift[:, None])
        assert torch.equal(rows[0], masked(loss.loss(z, y))), (e, m, "wl")
        assert torch.equal(rows[1], masked(loss.d1(z, y))), (e, m, "d")
        assert torch.equal(c_rows[0], c), (e, m, "c")
        want = tsparse.fused_value_grad_parts_plain(loss, slab, y, wt, off, w)
        want_hvp = tsparse.fused_hvp_parts_plain(loss, slab, y, wt, off, w, v, vshift)
        for a, b in zip(got + got_hvp, want + want_hvp):
            assert torch.equal(a, b), (e, m, storage)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 8, 9, 9), (128, 64, 9, 9), (8, 2048, 9, 9),
                                   (100, 7, 300, 5)])
def test_plain_transpose_on_the_card_adds_in_the_kernels_order(cuda_device, shape):
    """On the card the plain transpose (``FlatOrderPlan``) adds each column
    in flat (m, k) order, as the GEVM kernel's column owner does: from the
    kernel's own row derivatives it gives the kernel's gradient bit for
    bit. (The deterministic ``index_add_`` sums long columns in another
    association.)"""
    e, m, d, max_nnz = shape
    slab, y, wt, off, w, _, _ = _slab_inputs(sum(shape), "logistic", e, m, d, max_nnz,
                                             cuda_device, full=max_nnz == d)
    rows = torch.empty((2, e, m), device=cuda_device)
    _, grad, _ = tsparse.sparse_gevm_kernel(tlosses.logistic, slab, y, wt, off, w,
                                            row_values=rows)
    assert torch.equal(slab.rmatvec(rows[1]), grad)


@pytest.mark.gpu
def test_dense_race_forces_without_racing_and_raises_on_a_failed_kernel(cuda_device,
                                                                        monkeypatch):
    for name in ("_autotune_cache", "_autotune_timings", "_autotune_failures"):
        monkeypatch.setattr(tfused, name, {})
    lo, rows = tlosses.logistic, tfused.tile_rows(33, torch.float32)
    monkeypatch.setenv("PHOTON_ML_TPU_FUSED", "1")
    assert tfused.select_fused_block_rows(lo, 1000, 33, torch.float32, "cuda") == rows
    assert tfused._autotune_timings == {}  # nothing raced
    monkeypatch.setenv("PHOTON_ML_TPU_FUSED", "auto")

    def broken(*a, **kw):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(tfused, "fused_value_grad_kernel", broken)
    with pytest.raises(RuntimeError, match="injected launch failure"):
        tfused.select_fused_block_rows(lo, 1000, 33, torch.float32, "cuda")
    report = tfused.autotune_report(lo, 1000, 33, torch.float32, "cuda")
    assert report["winner"] is None
    assert report["candidates"][f"cuda:{rows}"] == {
        "failed": "failed: RuntimeError: injected launch failure"}
    assert "sec_per_pass" in report["candidates"]["matmul"]


@pytest.mark.gpu
def test_sparse_race_raises_when_a_family_fails_on_the_card(cuda_device, monkeypatch):
    from photon_ml_tpu_torch.types import TaskType

    slab, y, wt, off, _, _, _ = _slab_inputs(3, "logistic", 16, 8, 12, 4, cuda_device)

    def broken(*a, **kw):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(tsparse, "fused_value_grad_parts", broken)
    monkeypatch.setattr(tsparse, "_race_cache", {})
    monkeypatch.setattr(tsparse, "_race_reports", {})
    with pytest.raises(RuntimeError, match="family pallas: error: RuntimeError: injected"):
        tsparse.select_sparse_kernel(TaskType.LOGISTIC_REGRESSION, slab, slab.to_dense(), y,
                                     off, wt, spec="auto", label="b0")
    (key, report), = tsparse.race_reports().items()
    assert key[0] == "b0" and "injected launch failure" in report["failed"]
    assert tsparse._race_cache == {}  # nothing was chosen


def _scheduled_problem(device, optimizer, e=96, m=12, d=64, max_nnz=6):
    """A pallas slab problem for the solve scheduler on the card: logistic,
    L2, labels from a planted model, every lane's rows real."""
    slab, y, wt, off, _, _, _ = _slab_inputs(e + m, "logistic", e, m, d, max_nnz, device)
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    cfg = (OptimizerConfig(max_iterations=15, tolerance=1e-5) if optimizer == "TRON"
           else OptimizerConfig(max_iterations=60, tolerance=1e-7))
    kw = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[optimizer],
              optimizer_config=cfg, regularization=RegularizationContext.l2(0.5))
    wt = torch.where(wt > 0, wt, torch.ones_like(wt))
    off = torch.where(off.abs() < 10, off, torch.zeros_like(off))
    return (slab, y, off, wt), torch.zeros((e, d), device=device), kw


def _result_bits(res):
    return [None if t is None else (t.view(torch.int32) if t.dtype == torch.float32 else t)
            for t in res]


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_captured_rung_equals_the_eager_rung_bitwise(cuda_device, optimizer):
    """One rung program of the device loop, replayed from its CUDA graphs,
    leaves the full state bit for bit where the same programs run eagerly
    leave it. The replays launch, through the graphs and not the wrappers,
    the sparse kernels an eager chunk launches: torch.profiler counts them
    against the wrappers' counts of the eager chunks (a fixed-trip chunk
    launches the same kernels whatever its lanes' state)."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.optim import fused_schedule

    counters = (tsparse.sparse_gevm_kernel, tsparse.sparse_hvp_kernel)
    data, w0, kw = _scheduled_problem(cuda_device, optimizer)
    _, init, advance, _ = entity_lane_fns(**kw)
    loops = [fused_schedule._RungLoop(data, init(*data, w0), advance, 4) for _ in range(2)]
    for loop in loops:
        loop.horizon.fill_(kw["optimizer_config"].max_iterations)
    rung = 64
    before = sum(c.launches for c in counters)
    for _ in range(3):
        loops[0].eager_chunk(rung)
    eager = sum(c.launches for c in counters) - before
    assert eager > 0 and eager % 3 == 0
    loops[1].run(rung, key="test")  # captures, then replays the first chunk
    # CUPTI now and then delivers a session no device record, or drops one:
    # up to three sessions, each replaying one chunk
    for attempt in range(3):
        torch.cuda.synchronize()
        before = sum(c.launches for c in counters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loops[1].run(rung, key="test")
            torch.cuda.synchronize()
        assert sum(c.launches for c in counters) == before  # a replay passes no wrapper
        replayed_kernels = sum("sparse_pass" in ev.name for ev in prof.events()
                               if ev.device_type == torch.autograd.DeviceType.CUDA)
        if replayed_kernels == eager // 3:
            break
    assert replayed_kernels == eager // 3
    # the same chunks on both loops: 3 eager; on the graphs, the capturing
    # run and each traced one (a session that traced nothing replayed too)
    replayed = 2 + attempt
    for _ in range(3 - replayed):
        loops[1].run(rung, key="test")
    for _ in range(replayed - 3):
        loops[0].eager_chunk(rung)
    torch.cuda.synchronize()
    for n in loops[0].names:
        a, b = loops[0].state[n], loops[1].state[n]
        assert torch.equal(*(t.view(torch.int32) if t.dtype == torch.float32 else t
                             for t in (a, b))), n
    assert int(loops[0].lim) == int(loops[1].lim) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_scheduled_solves_on_the_card_are_bitwise_the_one_shot(cuda_device, optimizer):
    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve

    data, w0, kw = _scheduled_problem(cuda_device, optimizer)
    want = _result_bits(entity_lane_fns(**kw)[0](*data, w0))
    graphs = {}
    for schedule in (SolveSchedule(4), SolveSchedule(4, loop="device"),
                     SolveSchedule(4, loop="device")):
        got = compacted_solve(data, w0, schedule=schedule, graphs=graphs, **kw)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(_result_bits(got), want)), schedule


@pytest.mark.gpu
def test_device_loop_refuses_the_plain_slab_families_on_the_card(cuda_device):
    """The device loop no longer refuses the plain slab families: a rung's
    lanes transpose on the full slab through its one FlatOrderPlan, so the
    captured rungs are bitwise the host loop and the one-shot solve."""
    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve

    data, w0, kw = _scheduled_problem(cuda_device, "LBFGS")
    for family in ("scatter", "segment"):
        fam = (data[0].with_kernel(family),) + data[1:]
        want = _result_bits(entity_lane_fns(**kw)[0](*fam, w0))
        graphs = {}
        for schedule in (SolveSchedule(4), SolveSchedule(4, loop="device"),
                         SolveSchedule(4, loop="device")):
            got = compacted_solve(fam, w0, schedule=schedule, graphs=graphs, **kw)
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(_result_bits(got), want)), (family, schedule)


def _dense_stack_problem(device, optimizer, e, m, d):
    """A dense (E, M, D) random-effect stack problem: logistic, L2, labels
    from a planted model, a few rows of each lane padded with weight 0."""
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    g = torch.Generator(device="cpu").manual_seed(e + m + d)
    x = torch.randn((e, m, d), generator=g) * (torch.rand((e, m, d), generator=g) < 0.5)
    w_true = torch.randn((e, d), generator=g) * 0.4
    y = (torch.sigmoid(torch.einsum("emd,ed->em", x, w_true)) > torch.rand((e, m), generator=g))
    wt = (torch.rand((e, m), generator=g) < 0.85).float()
    off = torch.randn((e, m), generator=g) * 0.1
    cfg = (OptimizerConfig(max_iterations=15, tolerance=1e-5) if optimizer == "TRON"
           else OptimizerConfig(max_iterations=60, tolerance=1e-7))
    kw = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType[optimizer],
              optimizer_config=cfg, regularization=RegularizationContext.l2(0.5))
    data = tuple(t.to(device) for t in (x, y.float(), off, wt))
    return data, torch.zeros((e, d), device=device), kw


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_dense_stack_compaction_is_bitwise_the_one_shot_on_the_card(cuda_device, optimizer):
    """The dense stack contracts through elementwise products and
    ``tree_row_sum`` (a batched ``torch.matmul`` let cuBLAS choose its
    kernel by the batch count, and compacted lanes parted from the one-shot
    solve's bits on an H100): its compacted solves, host and device loop,
    are bitwise the one-shot solve on the card."""
    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve

    data, w0, kw = _dense_stack_problem(cuda_device, optimizer, 2000, 12, 9)
    want = _result_bits(entity_lane_fns(**kw)[0](*data, w0))
    graphs = {}
    for schedule in (SolveSchedule(2), SolveSchedule(2, loop="device")):
        got = compacted_solve(data, w0, schedule=schedule, graphs=graphs, **kw)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(_result_bits(got), want)), schedule


_SERVE_SCHEMA = {
    "name": "GameExampleAvro", "namespace": "test", "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "fixedFeatures", "type": {"type": "array", "items": {
            "name": "FeatureAvro", "namespace": "com.linkedin.photon.avro.generated",
            "type": "record", "fields": [{"name": "name", "type": "string"},
                                         {"name": "term", "type": "string"},
                                         {"name": "value", "type": "double"}]}}},
        {"name": "userFeatures", "type": {
            "type": "array", "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}


@pytest.mark.gpu
def test_served_scores_equal_the_scoring_driver_on_the_card(cuda_device, tmp_path):
    """Concurrent single-row requests through the server on the card are
    bitwise the batch scoring driver's device scores on the same rows (a
    model and rows made with the port alone, from a numpy seed)."""
    import concurrent.futures

    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.io import avro, model_io
    from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
    from photon_ml_tpu_torch.serve import ModelStore, ScoringServer, ServeStats, build_model_store
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(12)
    fmap = IndexMap.build([feature_key(f"f{j}", "") for j in range(20)], add_intercept=True)
    umap = IndexMap.build([feature_key(f"u{j}", "") for j in range(6)], add_intercept=True)
    model = str(tmp_path / "model")
    task = TaskType.LOGISTIC_REGRESSION
    model_io.save_fixed_effect(model, "fixed", task, rng.normal(size=len(fmap)).astype(np.float32),
                               fmap, feature_shard_id="global")
    model_io.save_random_effect(model, "per-user", task,
                                {f"user{i}": rng.normal(size=len(umap)).astype(np.float32)
                                 for i in range(300)},
                                umap, random_effect_id="userId", feature_shard_id="per_user")
    records, requests = [], []
    for r in range(2000):
        fixed = [{"name": f"f{j}", "term": "", "value": float(rng.normal())}
                 for j in rng.choice(20, rng.integers(1, 12), replace=False)]
        user = [{"name": f"u{j}", "term": "", "value": float(rng.normal())}
                for j in rng.choice(6, rng.integers(1, 6), replace=False)]
        uid = f"user{rng.integers(0, 320)}"  # some users have no model
        offset = float(rng.normal())
        records.append({"uid": str(r), "label": float(rng.integers(0, 2)),
                        "fixedFeatures": fixed, "userFeatures": user,
                        "metadataMap": {"userId": uid}, "offset": offset})
        requests.append({"features": {"fixedFeatures": fixed, "userFeatures": user},
                         "ids": {"userId": uid}, "offset": offset})
    os.makedirs(tmp_path / "in")
    avro.write_container(str(tmp_path / "in" / "part-00000.avro"), records, _SERVE_SCHEMA)
    store = str(tmp_path / "store")
    build_model_store(model, store)
    driver = game_scoring_driver.main([
        "--input-dirs", str(tmp_path / "in"), "--game-model-input-dir", model,
        "--output-dir", str(tmp_path / "scores"),
        "--offheap-indexmap-dir", os.path.join(store, "features"),
        "--feature-shard-id-to-feature-section-keys-map",
        "global:fixedFeatures|per_user:userFeatures", "--device", "cuda"])
    server = ScoringServer(ModelStore(store), shard_sections={
        "global": ["fixedFeatures"], "per_user": ["userFeatures"]},
        max_batch_rows=32, stats=ServeStats(), device=cuda_device)
    server.warmup(warm_nnz=16)
    with concurrent.futures.ThreadPoolExecutor(32) as pool:
        futs = list(pool.map(lambda q: server.submit_rows([q]), requests))
    served = np.concatenate([f.result(timeout=120) for f in futs])
    assert server.new_request_compiles() == 0
    server.close()
    assert np.array_equal(served, driver.scores)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3])
def test_pinned_side_stream_place_is_bitwise_the_synchronous_copy(cuda_device, depth):
    """``pipelined_to_device`` on the card (pinned host memory, H2D on a side
    stream, the consumer's stream waiting on each copy's event) gives the
    blocks the synchronous copy gives, and a kernel reading each block right
    away, while the next block's copy is in flight, reads the copied bits."""
    from photon_ml_tpu_torch.io.pipeline import pipelined_to_device

    rng = np.random.default_rng(depth)
    blocks = [{"x": rng.normal(size=(2048, 513)).astype(np.float32),
               "i": rng.integers(0, 1 << 30, size=4099).astype(np.int64), "_k": k}
              for k in range(8)]
    to_host = lambda b: {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                         for k, v in b.items()}
    sync = [(b["x"].sum(dtype=torch.float64).item(), b["x"].clone(), b["i"].clone())
            for b in pipelined_to_device(lambda: iter(blocks), to_host, cuda_device, 0)]
    got = []
    for b in pipelined_to_device(lambda: iter(blocks), to_host, cuda_device, depth):
        assert b["x"].is_cuda and b["i"].is_cuda
        got.append((b["x"].sum(dtype=torch.float64).item(), b["x"].clone(), b["i"].clone()))
        del b
    assert [g[0] for g in got] == [s[0] for s in sync]
    for (_, gx, gi), (_, sx, si), blk in zip(got, sync, blocks):
        assert torch.equal(gx, sx) and torch.equal(gi, si)
        assert np.array_equal(gx.cpu().numpy(), blk["x"])


@pytest.mark.gpu
def test_compacted_solve_host_reads_equal_the_syncs_the_card_reports(cuda_device):
    """Every sync the host loop makes is a counted host read: the lane ids
    of each compaction are uploaded from pinned memory without one."""
    import warnings

    from photon_ml_tpu_torch.algorithm.random_effect import entity_lane_fns
    from photon_ml_tpu_torch.optim.common import HostReads
    from photon_ml_tpu_torch.optim.scheduler import SolveSchedule, compacted_solve

    for optimizer in ("LBFGS", "TRON"):
        data, w0, kw = _scheduled_problem(cuda_device, optimizer)
        entity_lane_fns(**kw)[0](*data, w0)  # the slab's tables and launch plans, made once
        for schedule in (None, SolveSchedule(4)):
            torch.cuda.synchronize()
            reads0 = HostReads.count
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    if schedule is None:
                        entity_lane_fns(**kw)[0](*data, w0)
                    else:
                        compacted_solve(data, w0, schedule=schedule, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
            assert syncs == HostReads.count - reads0, (optimizer, schedule, syncs)


def _shuffle_payload(world):
    rng = np.random.default_rng(23)
    n, k = 300, 3
    fi = np.sort(rng.integers(0, 40, (n, k)), axis=1).astype(np.int32)
    return dict(raw_ids=[f"u{int(u)}" for u in rng.integers(0, 31, n)],
                row_index=np.arange(n, dtype=np.int64), labels=np.zeros(n, np.float32),
                weights=np.ones(n, np.float32), offsets=np.zeros(n, np.float32), feat_idx=fi,
                feat_val=rng.normal(size=(n, k)).astype(np.float32), global_dim=40,
                owner_rank=np.arange(n) % world, num_buckets=64)


@pytest.mark.gpu
def test_nccl_world_of_one_collectives_on_the_card(cuda_device):
    from photon_ml_tpu_torch.parallel import multihost

    mh = multihost.initialize(device="cuda")
    try:
        ctx = mh.mesh_context()
        assert (ctx.backend, ctx.world, ctx.device.type) == ("nccl", 1, "cuda")
        f = torch.linspace(-1.0, 1.0, 7, device=cuda_device)
        assert torch.equal(ctx.sum(f), f) and ctx.sum(f).device.type == "cuda"
        i = torch.arange(5, device=cuda_device)
        assert torch.equal(ctx.max(i), i) and torch.equal(ctx.concat(i), i)
        send = torch.arange(6, dtype=torch.int32, device=cuda_device).reshape(1, 2, 3)
        assert torch.equal(ctx.all_to_all(send), send)
        host = torch.arange(3, dtype=torch.int64)  # a host tensor is staged onto the card
        assert torch.equal(ctx.sum(host), host) and ctx.sum(host).device.type == "cpu"
        assert mh.agree_restore_step(3) == 3
        mh.barrier("card")
    finally:
        multihost.shutdown()


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_shuffle_the_bytes_one_rank_does(cuda_device, tmp_path):
    from torch_ranks import run_ranks

    two = run_ranks("torch_rank_jobs:card_shuffle", 2, tmp_path, _shuffle_payload(2),
                    device="cuda")
    one = run_ranks("torch_rank_jobs:card_shuffle", 1, tmp_path, _shuffle_payload(1),
                    device="cuda")
    assert [r["backend"] for r in two] == ["gloo", "gloo"] and one[0]["backend"] == "nccl"
    assert {r["device"] for r in two + one} == {"cuda:0"}
    assert two[0]["records"].tobytes() == two[1]["records"].tobytes() == \
        one[0]["records"].tobytes()
    assert len(one[0]["records"]) == 300


@pytest.mark.gpu
def test_nccl_refuses_two_ranks_on_one_card(cuda_device, tmp_path):
    """NCCL's answer to two ranks on one device (the reason two ranks on the
    one card run over gloo): both ranks fail; the words are printed."""
    from torch_ranks import init_url, launch

    script = ("import sys, torch; from photon_ml_tpu_torch.parallel import multihost\n"
              "mh = multihost.initialize(sys.argv[1], 2, int(sys.argv[2]), device='cuda', "
              "backend='nccl')\n"
              "mh.mesh_context().sum(torch.ones(4, device='cuda'))\n")
    init = init_url(tmp_path)
    outs = launch([["-c", script, init, str(r)] for r in range(2)], timeout=150,
                  env={"PHOTON_COLLECTIVE_TIMEOUT": "60"}, check=False)
    assert all(o.returncode != 0 for o in outs)
    for o in outs:
        print("\n".join(ln for ln in o.stderr.splitlines() if "NCCL" in ln or "Error" in ln))
