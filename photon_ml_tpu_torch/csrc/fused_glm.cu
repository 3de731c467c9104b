// Fused GLM value + gradient over a dense feature matrix: one pass over X.
//
// Computes, for one pointwise loss (0 logistic, 1 squared, 2 Poisson,
// 3 smoothed hinge; formulas as in photon_ml_tpu_torch/ops/losses.py):
//
//   z_i  = x_i . round(w) + off_i
//   wl_i = [wt_i > 0] * wt_i * loss(z_i, y_i)
//   d_i  = [wt_i > 0] * wt_i * loss'(z_i, y_i)
//   out  = (sum_i wl_i, sum_i d_i, sum_i round(d_i) * x_i)      all in f32
//
// where round() rounds to the storage type of X (bf16 or f32), so the
// products match the plain PyTorch version (DenseFeatures matvec/rmatvec)
// and accumulation is always f32. The hard [wt > 0] mask zeroes padding
// rows even when their loss overflows to inf/nan.
//
// Replaces the three Pallas schedules of one function in the JAX package:
//   photon_ml_tpu/ops/fused_glm.py:223  _make_kernel        (grid, MXU dots)
//   photon_ml_tpu/ops/fused_glm.py:223  _make_vpu_kernel    (grid, VPU reduce)
//   photon_ml_tpu/ops/fused_glm.py:350  _make_manual_kernel (manual async DMA)
//
// What bounds it on an H100: device-memory bandwidth. One pass moves about
// N*D*s + 12*N bytes (s = 2 for bf16, 4 for f32; y, wt, off are f32) and does
// 4*N*D flops, about 2 flops per byte of X at bf16, far below the card's
// ratio of compute to bandwidth. The two-pass plain version reads X twice
// (once for X w, once for d^T X); this kernel reads each row tile from
// device memory once into shared memory and uses it for both products.
//
// Design (a simple first version):
//   stage 1: each CTA owns a contiguous range of rows and walks it in tiles
//            of tile_rows rows. When rows are 16-byte aligned, the tiles of
//            X (and the tile's y, wt, off) stream into two shared-memory
//            buffers with cp.async, the next tile's copy in flight while the
//            current one is reduced; otherwise each warp loads its rows
//            synchronously. Phase A: one warp per row reduces x_i . w with
//            shuffles, and lane 0 computes wl_i and d_i. Phase B: each thread
//            owns columns tid, tid+256, ... (kCols of them, a template
//            parameter, so no thread loops over empty column slots) and adds
//            round(d_i) * x_ij over the tile's rows from shared memory. The
//            CTA writes its partial (loss, sumd, grad[0..D)) to scratch.
//   stage 2: each output column is summed over the CTA partials by 16
//            threads, each over a fixed strided subset in order, then the 16
//            sums in order.
// No float atomics: every sum runs in a fixed order, so two runs on the same
// inputs give bitwise-equal results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4096;

template <typename T>
struct Storage;

template <>
struct Storage<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Storage<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ void loss_and_d1(int loss, float z, float y,
                                            float* l, float* d1) {
  if (loss == 0) {  // logistic, y in {0, 1}
    *l = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - y * z;
    *d1 = 1.f / (1.f + expf(-z)) - y;
  } else if (loss == 1) {  // squared
    const float r = z - y;
    *l = 0.5f * r * r;
    *d1 = r;
  } else if (loss == 2) {  // Poisson
    const float e = expf(z);
    *l = e - y * z;
    *d1 = e - y;
  } else {  // smoothed hinge on t = (2y - 1) z
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

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the next tile's) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory layout of stage 1 (float offsets, each a multiple of 4 so
// every part stays 16-byte aligned): w | d | y[2] | wt[2] | off[2] | x[2].
struct Layout {
  int d_pad, t_pad;
  __host__ __device__ Layout(int d, int tile_rows)
      : d_pad((d + 3) & ~3), t_pad((tile_rows + 3) & ~3) {}
  __host__ __device__ size_t x_offset() const { return (size_t)d_pad + 7 * t_pad; }
  __host__ __device__ size_t bytes(int tile_rows, int d, int itemsize) const {
    return 4 * x_offset() + 2 * (size_t)tile_rows * d * itemsize;
  }
};

template <typename T, bool kVec, int kCols>
__global__ void __launch_bounds__(kThreads)
    glm_value_grad_stage1(const T* __restrict__ x, const float* __restrict__ y,
                          const float* __restrict__ wt,
                          const float* __restrict__ off,
                          const float* __restrict__ w, long long n, int d,
                          int loss, int tile_rows, long long rows_per_cta,
                          float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(d, tile_rows);
  float* w_s = smem;               // d, rounded to storage
  float* dv_s = w_s + lay.d_pad;   // tile_rows, rounded d_i
  float* row_s = dv_s + lay.t_pad; // y[2], wt[2], off[2]
  T* x_s = reinterpret_cast<T*>(smem + lay.x_offset());
  // buffer b of each staged stream
  auto y_s = [&](int b) { return row_s + b * lay.t_pad; };
  auto wt_s = [&](int b) { return row_s + (2 + b) * lay.t_pad; };
  auto off_s = [&](int b) { return row_s + (4 + b) * lay.t_pad; };
  auto x_buf = [&](int b) { return x_s + (long long)b * tile_rows * d; };
  __shared__ float warp_loss[kWarps];
  __shared__ float warp_sumd[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  float loss_acc = 0.f;  // meaningful in lane 0 of each warp
  float sumd_acc = 0.f;

  const long long r_begin = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min(n, r_begin + rows_per_cta);
  const int ntiles =
      r_end > r_begin ? (int)((r_end - r_begin + tile_rows - 1) / tile_rows) : 0;
  auto rows_of = [&](int t) {
    return (int)min((long long)tile_rows, r_end - r_begin - (long long)t * tile_rows);
  };
  // stage tile t (rows r0 ..) into buffer b: X rows and the row vectors
  auto stage_tile = [&](int t, int b) {
    const long long r0 = r_begin + (long long)t * tile_rows;
    const int rows = rows_of(t);
    if (kVec) {
      const int chunks = (int)((long long)rows * d * sizeof(T) / 16);
      const uint4* src = reinterpret_cast<const uint4*>(x + r0 * d);
      uint4* dst = reinterpret_cast<uint4*>(x_buf(b));
      for (int c = tid; c < chunks; c += kThreads) cp_async<16>(dst + c, src + c);
      if (tid < rows) {
        cp_async<4>(y_s(b) + tid, y + r0 + tid);
        cp_async<4>(wt_s(b) + tid, wt + r0 + tid);
        cp_async<4>(off_s(b) + tid, off + r0 + tid);
      }
    } else if (tid < rows) {
      y_s(b)[tid] = y[r0 + tid];
      wt_s(b)[tid] = wt[r0 + tid];
      off_s(b)[tid] = off[r0 + tid];
    }
  };

  if (kVec && ntiles > 0) stage_tile(0, 0);
  if (kVec) cp_async_commit();
  for (int j = tid; j < d; j += kThreads) w_s[j] = Storage<T>::round(w[j]);

  for (int t = 0; t < ntiles; ++t) {
    const long long r0 = r_begin + (long long)t * tile_rows;
    const int rows = rows_of(t);
    const int b = kVec ? (t & 1) : 0;
    T* xt = x_buf(b);
    if (kVec) {
      if (t + 1 < ntiles) stage_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      stage_tile(t, 0);
    }
    __syncthreads();  // tile t (and w_s) visible to every thread
    // phase A: one warp per row: margin, loss and derivative
    for (int rr = warp; rr < rows; rr += kWarps) {
      T* xs = xt + (long long)rr * d;
      float part = 0.f;
      if (kVec) {
        constexpr int V = 16 / sizeof(T);
        for (int j = lane * V; j < d; j += 32 * V) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xs + j);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int v = 0; v < V; v += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(w_s + j + v);
            part += Storage<T>::to_f(e[v]) * wv.x;
            part += Storage<T>::to_f(e[v + 1]) * wv.y;
            part += Storage<T>::to_f(e[v + 2]) * wv.z;
            part += Storage<T>::to_f(e[v + 3]) * wv.w;
          }
        }
      } else {
        const T* xr = x + (r0 + rr) * (long long)d;
        for (int j = lane; j < d; j += 32) {
          const T e = xr[j];
          xs[j] = e;
          part += Storage<T>::to_f(e) * w_s[j];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        const float z = part + off_s(b)[rr];
        const float wi = wt_s(b)[rr];
        float l, g;
        loss_and_d1(loss, z, y_s(b)[rr], &l, &g);
        const float wl = wi > 0.f ? wi * l : 0.f;
        const float di = wi > 0.f ? wi * g : 0.f;
        loss_acc += wl;
        sumd_acc += di;
        dv_s[rr] = Storage<T>::round(di);
      }
    }
    __syncthreads();
    // phase B: gradient columns from the staged tile
    for (int rr = 0; rr < rows; ++rr) {
      const float di = dv_s[rr];
      const T* xs = xt + (long long)rr * d;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = tid + k * kThreads;
        if (j < d) acc[k] += di * Storage<T>::to_f(xs[j]);
      }
    }
    __syncthreads();  // buffer b and dv_s free for reuse
  }

  if (lane == 0) {
    warp_loss[warp] = loss_acc;
    warp_sumd[warp] = sumd_acc;
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * (d + 2);
  if (tid == 0) {
    float a = 0.f, s = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      a += warp_loss[k];
      s += warp_sumd[k];
    }
    out[0] = a;
    out[1] = s;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = tid + k * kThreads;
    if (j < d) out[2 + j] = acc[k];
  }
}

constexpr int kRedCols = 32;
constexpr int kRedSlices = 16;

__global__ void __launch_bounds__(kRedCols * kRedSlices)
    glm_value_grad_stage2(const float* __restrict__ partials, int grid,
                          int width, float* __restrict__ out) {
  __shared__ float slice_sum[kRedSlices][kRedCols];
  const int j = blockIdx.x * kRedCols + threadIdx.x;
  float s = 0.f;
  if (j < width) {
#pragma unroll 4
    for (int b = threadIdx.y; b < grid; b += kRedSlices)
      s += partials[(long long)b * width + j];
  }
  slice_sum[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kRedSlices; ++k) t += slice_sum[k][threadIdx.x];
    out[j] = t;
  }
}

struct Args {
  const void* x;
  const float *y, *wt, *off, *w;
  long long n;
  int d, loss, tile_rows;
  long long rows_per_cta;
  int grid;
  size_t smem;
  float* partials;
  cudaStream_t stream;
};

template <typename T, bool kVec, int kCols>
cudaError_t launch_stage1(const Args& a) {
  auto kernel = glm_value_grad_stage1<T, kVec, kCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), a.y, a.wt, a.off, a.w, a.n, a.d, a.loss,
      a.tile_rows, a.rows_per_cta, a.partials);
  return cudaGetLastError();
}

// column slots per thread: the next power of two >= ceil(d / kThreads)
template <typename T, bool kVec>
cudaError_t launch_by_width(const Args& a) {
  const int cols = (a.d + kThreads - 1) / kThreads;
  if (cols <= 1) return launch_stage1<T, kVec, 1>(a);
  if (cols <= 2) return launch_stage1<T, kVec, 2>(a);
  if (cols <= 4) return launch_stage1<T, kVec, 4>(a);
  if (cols <= 8) return launch_stage1<T, kVec, 8>(a);
  return launch_stage1<T, kVec, 16>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 means both stages were launched.
// partials: grid x (d + 2) f32 scratch; out: (d + 2) f32 laid out as
// [loss_sum, sum_d, grad_0 .. grad_{d-1}]. smem_bytes must cover the
// stage-1 layout (checked here).
int photon_fused_glm_value_grad(const void* x, int x_is_bf16, const float* y,
                                const float* wt, const float* off,
                                const float* w, long long n, int d, int loss,
                                int tile_rows, long long rows_per_cta,
                                int grid, long long smem_bytes,
                                float* partials, float* out, void* stream) {
  const int itemsize = x_is_bf16 ? 2 : 4;
  if (d < 1 || d > kMaxCols || tile_rows < 1 || grid < 1 || n < 1 ||
      (size_t)smem_bytes < Layout(d, tile_rows).bytes(tile_rows, d, itemsize))
    return (int)cudaErrorInvalidValue;
  const Args a{x, y, wt, off, w, n, d, loss, tile_rows, rows_per_cta, grid,
               (size_t)smem_bytes, partials, static_cast<cudaStream_t>(stream)};
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   ((long long)d * itemsize % 16 == 0);
  cudaError_t err;
  if (x_is_bf16)
    err = vec ? launch_by_width<__nv_bfloat16, true>(a)
              : launch_by_width<__nv_bfloat16, false>(a);
  else
    err = vec ? launch_by_width<float, true>(a) : launch_by_width<float, false>(a);
  if (err != cudaSuccess) return (int)err;
  const int width = d + 2;
  glm_value_grad_stage2<<<(width + kRedCols - 1) / kRedCols,
                          dim3(kRedCols, kRedSlices), 0, a.stream>>>(
      partials, grid, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
