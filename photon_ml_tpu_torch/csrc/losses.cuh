// Pointwise GLM losses on the margin z, shared by the port's kernels.
//
// loss ids: 0 logistic (y in {0, 1}), 1 squared, 2 Poisson, 3 smoothed
// hinge on t = (2y - 1) z. Formulas as in photon_ml_tpu_torch/ops/losses.py
// (the loss's kernel_id names it here). A product that a subtraction
// follows is rounded on its own (__fmul_rn), as torch's separate multiply
// and subtract round it: nvcc would otherwise fuse the two into one fma.
#pragma once

#include <cuda_runtime.h>

namespace photon {

// loss value and first derivative dl/dz
__device__ __forceinline__ void loss_and_d1(int loss, float z, float y,
                                            float* l, float* d1) {
  if (loss == 0) {
    *l = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - __fmul_rn(y, z);
    *d1 = 1.f / (1.f + expf(-z)) - y;
  } else if (loss == 1) {
    const float r = z - y;
    *l = 0.5f * r * r;
    *d1 = r;
  } else if (loss == 2) {
    const float e = expf(z);
    *l = e - __fmul_rn(y, z);
    *d1 = e - y;
  } else {
    const float s = 2.f * y - 1.f;
    const float t = s * z;
    if (t <= 0.f) {
      *l = 0.5f - t;
      *d1 = -s;
    } else if (t < 1.f) {
      const float u = 1.f - t;
      *l = 0.5f * u * u;
      *d1 = s * (t - 1.f);
    } else {
      *l = 0.f;
      *d1 = 0.f;
    }
  }
}

// second derivative d2l/dz2 (the smoothed hinge's is its piecewise
// curvature; TRON with that loss is refused before any kernel runs)
__device__ __forceinline__ float loss_d2(int loss, float z, float y) {
  if (loss == 0) {
    const float s = 1.f / (1.f + expf(-z));
    return s * (1.f - s);
  }
  if (loss == 1) return 1.f;
  if (loss == 2) return expf(z);
  const float t = (2.f * y - 1.f) * z;
  return (t > 0.f && t < 1.f) ? 1.f : 0.f;
}

}  // namespace photon
