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
