// Fused per-entity kernels over a padded-COO sparse slab: value + gradient
// (GEVM) and the Hessian-vector product (HVP), every lane in one launch.
//
// A slab holds E lanes (entities); lane e has M rows of K (column, value)
// slots, idx (E, M, K) int32 and val (E, M, K) f32 or bf16, with padding
// slots at column 0 and value 0. For one pointwise loss (ids as in
// losses.cuh) and lane e:
//
//   GEVM   z_m    = sum_k w[e, idx_mk] * val_mk + off_m           (k order)
//          wl_m   = [wt_m > 0] * wt_m * loss(z_m, y_m)     -> row_wl (E, M)
//          d_m    = [wt_m > 0] * wt_m * loss'(z_m, y_m)    -> row_d  (E, M)
//          grad_j = sum_{(m,k): idx_mk = j} val_mk * d_m   -> grad   (E, D)
//   HVP    z_m as above, zv_m = sum_k v[e, idx_mk] * val_mk + vshift_e
//          c_m    = [wt_m > 0] * wt_m * loss''(z_m, y_m) * zv_m -> row_c (E, M)
//          hvp_j  = sum_{(m,k): idx_mk = j} val_mk * c_m   -> hvp    (E, D)
//
// Every product is f32 (a bf16 value is promoted, w and v are never
// rounded to its type) and the row outputs stay unreduced: the wrapper sums
// them with the port's fixed-association tree_row_sum, as the JAX wrappers do.
// The hard [wt > 0] mask gives an exact 0 even when a padding row's loss
// overflows to inf/nan.
//
// Replaces the two Pallas kernels of photon_ml_tpu/ops/fused_sparse.py:
//   :365 _make_gevm_kernel (launched by _gevm_fn, :485)
//   :416 _make_hvp_kernel  (launched by _hvp_fn,  :527)
// The TPU kernels run one lane per call (vmapped over entities), walk row
// blocks in order on one core and scatter grad[idx] += val * d into a VMEM
// accumulator in flat (m, k) order.
//
// What bounds it on an H100: device-memory bytes. Per slot it reads an index
// and a value, gathers one or two f32 coefficients and does two or four
// flops; per lane it writes D gradient columns. There is no reuse for the
// tensor cores or the caches to exploit beyond the lane's coefficient row.
// The bound counts only those bytes; the column tables below are this
// design's own traffic on top (col_start is 4 (D + 1) bytes per lane however
// few columns are populated, perm 4 bytes per real slot).
//
// Design (a simple first version):
//   * one CTA of 256 threads per lane; the grid covers all E lanes;
//   * row phase: thread t takes rows t, t + 256, ...; it gathers w (and v)
//     for the row's K slots straight from device memory (the lane's row of
//     w is small and stays in L1/L2), computes z, the loss terms and d (or
//     c) and writes them to the row outputs;
//   * column phase, after __syncthreads (which makes the row outputs written
//     by the CTA visible to all its threads): the column-owner transpose.
//     perm (E, M*K) lists each lane's non-padding slots stably sorted by
//     column, so each column's slots keep their flat (m, k) order, and
//     col_start (E, D+1) delimits them (both built once per slab by the
//     wrapper in plain PyTorch). Thread t owns columns t, t + 256, ... and
//     sums val * d over its slots in that order, exactly the scatter order
//     of the TPU kernel, with no atomics: two runs give bitwise-equal
//     results.
// Products use __fmul_rn and sums __fadd_rn, so nvcc does not contract them
// into fused multiply-adds: each step rounds as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "losses.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V>
struct Val;

template <>
struct Val<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
};

template <>
struct Val<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// sum_k x[idx_k] * val_k in k order
template <typename V>
__device__ __forceinline__ float row_dot(const int* __restrict__ idx,
                                         const V* __restrict__ val,
                                         const float* __restrict__ x, int k) {
  float acc = 0.f;
  for (int q = 0; q < k; ++q)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(x + idx[q]), Val<V>::f(val[q])));
  return acc;
}

// out[j] = sum over column j's slots, in flat order, of val * row_coef[row];
// row_coef was written earlier in this launch, so it is read with plain
// (coherent) loads
template <typename V>
__device__ __forceinline__ void column_pass(const V* __restrict__ val,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ col_start,
                                            const float* row_coef, int k, int d,
                                            float* __restrict__ out) {
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float acc = 0.f;
    const int end = col_start[j + 1];
    for (int p = col_start[j]; p < end; ++p) {
      const int q = perm[p];
      acc = __fadd_rn(acc, __fmul_rn(Val<V>::f(val[q]), row_coef[q / k]));
    }
    out[j] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    sparse_gevm(const int* __restrict__ idx, const V* __restrict__ val,
                const float* __restrict__ y, const float* __restrict__ wt,
                const float* __restrict__ off, const float* __restrict__ w,
                const int* __restrict__ perm, const int* __restrict__ col_start,
                int m, int k, int d, int loss, float* __restrict__ row_wl,
                float* row_d, float* __restrict__ grad) {
  const long long e = blockIdx.x;
  const long long r0 = e * m;
  const long long s0 = r0 * k;
  const float* lw = w + e * d;
  for (int r = threadIdx.x; r < m; r += kThreads) {
    const long long s = s0 + (long long)r * k;
    const float z = __fadd_rn(row_dot(idx + s, val + s, lw, k), off[r0 + r]);
    float l, g;
    photon::loss_and_d1(loss, z, y[r0 + r], &l, &g);
    const float wi = wt[r0 + r];
    row_wl[r0 + r] = wi > 0.f ? __fmul_rn(wi, l) : 0.f;
    row_d[r0 + r] = wi > 0.f ? __fmul_rn(wi, g) : 0.f;
  }
  __syncthreads();
  column_pass(val + s0, perm + s0, col_start + e * (d + 1), row_d + r0, k, d,
              grad + e * d);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    sparse_hvp(const int* __restrict__ idx, const V* __restrict__ val,
               const float* __restrict__ y, const float* __restrict__ wt,
               const float* __restrict__ off, const float* __restrict__ w,
               const float* __restrict__ v, const float* __restrict__ vshift,
               const int* __restrict__ perm, const int* __restrict__ col_start,
               int m, int k, int d, int loss, float* row_c,
               float* __restrict__ hvp) {
  const long long e = blockIdx.x;
  const long long r0 = e * m;
  const long long s0 = r0 * k;
  const float* lw = w + e * d;
  const float* lv = v + e * d;
  const float shift = vshift[e];
  for (int r = threadIdx.x; r < m; r += kThreads) {
    const long long s = s0 + (long long)r * k;
    // one pass over the row's slots feeds both contractions
    float z = 0.f, zv = 0.f;
    for (int q = 0; q < k; ++q) {
      const int j = idx[s + q];
      const float x = Val<V>::f(val[s + q]);
      z = __fadd_rn(z, __fmul_rn(__ldg(lw + j), x));
      zv = __fadd_rn(zv, __fmul_rn(__ldg(lv + j), x));
    }
    z = __fadd_rn(z, off[r0 + r]);
    zv = __fadd_rn(zv, shift);
    const float wi = wt[r0 + r];
    const float d2 =
        wi > 0.f ? __fmul_rn(wi, photon::loss_d2(loss, z, y[r0 + r])) : 0.f;
    row_c[r0 + r] = __fmul_rn(d2, zv);
  }
  __syncthreads();
  column_pass(val + s0, perm + s0, col_start + e * (d + 1), row_c + r0, k, d,
              hvp + e * d);
}

bool bad_shape(long long lanes, int m, int k, int d) {
  return lanes < 1 || lanes > 2147483647LL || m < 1 || k < 1 || d < 1;
}

}  // namespace

extern "C" {

// Both return a cudaError_t code; 0 means the kernel was launched on
// `stream`. Pointers are device pointers of contiguous tensors: idx, perm
// and col_start int32; val f32 (val_is_bf16 = 0) or bf16; everything else
// f32. Shapes: idx, val, perm (lanes, m, k); y, wt, off and the row
// outputs (lanes, m); w, v and grad/hvp (lanes, d); col_start (lanes, d+1);
// vshift (lanes,).
int photon_sparse_gevm(const void* idx, const void* val, int val_is_bf16,
                       const void* y, const void* wt, const void* off,
                       const void* w, const void* perm, const void* col_start,
                       long long lanes, int m, int k, int d, int loss,
                       void* row_wl, void* row_d, void* grad, void* stream) {
  if (bad_shape(lanes, m, k, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* fy = static_cast<const float*>(y);
  const float* fwt = static_cast<const float*>(wt);
  const float* foff = static_cast<const float*>(off);
  const float* fw = static_cast<const float*>(w);
  const int* ip = static_cast<const int*>(perm);
  const int* ic = static_cast<const int*>(col_start);
  float* owl = static_cast<float*>(row_wl);
  float* od = static_cast<float*>(row_d);
  float* og = static_cast<float*>(grad);
  if (val_is_bf16)
    sparse_gevm<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        ix, static_cast<const __nv_bfloat16*>(val), fy, fwt, foff, fw, ip, ic,
        m, k, d, loss, owl, od, og);
  else
    sparse_gevm<float><<<grid, kThreads, 0, s>>>(
        ix, static_cast<const float*>(val), fy, fwt, foff, fw, ip, ic, m, k, d,
        loss, owl, od, og);
  return (int)cudaGetLastError();
}

int photon_sparse_hvp(const void* idx, const void* val, int val_is_bf16,
                      const void* y, const void* wt, const void* off,
                      const void* w, const void* v, const void* vshift,
                      const void* perm, const void* col_start, long long lanes,
                      int m, int k, int d, int loss, void* row_c, void* hvp,
                      void* stream) {
  if (bad_shape(lanes, m, k, d)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* fy = static_cast<const float*>(y);
  const float* fwt = static_cast<const float*>(wt);
  const float* foff = static_cast<const float*>(off);
  const float* fw = static_cast<const float*>(w);
  const float* fv = static_cast<const float*>(v);
  const float* fs = static_cast<const float*>(vshift);
  const int* ip = static_cast<const int*>(perm);
  const int* ic = static_cast<const int*>(col_start);
  float* oc = static_cast<float*>(row_c);
  float* oh = static_cast<float*>(hvp);
  if (val_is_bf16)
    sparse_hvp<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        ix, static_cast<const __nv_bfloat16*>(val), fy, fwt, foff, fw, fv, fs,
        ip, ic, m, k, d, loss, oc, oh);
  else
    sparse_hvp<float><<<grid, kThreads, 0, s>>>(
        ix, static_cast<const float*>(val), fy, fwt, foff, fw, fv, fs, ip, ic,
        m, k, d, loss, oc, oh);
  return (int)cudaGetLastError();
}

}  // extern "C"
