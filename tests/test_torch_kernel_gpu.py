"""The CUDA kernel of photon_ml_tpu_torch/csrc/fused_glm.cu against its
plain PyTorch version, on the card. Every test here needs a CUDA card (the
kernel has no CPU mode): each carries the ``gpu`` marker and skips where
``torch.cuda`` is unavailable. This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

Tolerance: value and gradient relative error, and the error of sum d over
sum |d|, 1e-5 in f32 (summation order only) and 1e-3 in bf16 (the rounding
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
