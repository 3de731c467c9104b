// Fused per-entity kernels over a padded-COO sparse slab: value + gradient
// (GEVM) and the Hessian-vector product (HVP), every lane in one launch.
//
// A slab holds E lanes (entities); lane e has M rows of K (column, value)
// slots, idx (E, M, K) int32 and val (E, M, K) f32 or bf16, with padding
// slots at column 0 and value 0. For one pointwise loss (ids as in
// losses.cuh) and lane e:
//
//   GEVM   z_m    = sum_k w[e, idx_mk] * val_mk + off_m
//          wl_m   = [wt_m > 0] * wt_m * loss(z_m, y_m)
//          d_m    = [wt_m > 0] * wt_m * loss'(z_m, y_m)
//          grad_j = sum_{(m,k): idx_mk = j} val_mk * d_m   -> grad (E, D)
//          tree_row_sum(wl), tree_row_sum(d)               -> (E,), (E,)
//   HVP    z_m as above, zv_m = sum_k v[e, idx_mk] * val_mk + vshift_e
//          c_m    = [wt_m > 0] * wt_m * loss''(z_m, y_m) * zv_m
//          hvp_j  = sum_{(m,k): idx_mk = j} val_mk * c_m   -> hvp (E, D)
//          tree_row_sum(c)                                 -> (E,)
//
// Every product is f32 (a bf16 value is promoted, w and v are never
// rounded to its type). The row sums, which the kernel takes itself, use
// the adjacent-pair tree of tree_row_sum (M zero-padded to a power of two):
// the port's fixed association, never a stride-halving shuffle. The transpose sums each column's slots in flat
// (m, k) order. The hard [wt > 0] mask gives an exact 0 even when a padding
// row's loss overflows to inf/nan.
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
// flops; per lane it writes D gradient columns and one or two sums. With
// every lane in flight at once, what a block waits on in sequence (loads
// that depend on loads, phases between barriers) sets the time as much as
// the bytes do, so the design keeps that chain short.
//
// Design:
//   * lanes packed into blocks: a block of 256 threads takes
//     `lanes_per_block` whole lanes (enough for about 1024 slots, more where
//     the grid would otherwise need a second wave), so a lane never spans
//     two blocks and nothing crosses blocks;
//   * staging: the block's lanes are contiguous, so their idx/val, their
//     y/wt/off, their rows of w (and v) and their entries of the column
//     tables are each one contiguous range of device memory. The block
//     copies every range into shared memory with 16-byte cp.async, whole
//     16-byte granules, every thread issuing a share, all in flight together:
//     one round trip for the lanes' table offsets, then one wait (a 1-D bulk
//     TMA copy would need 16-byte-aligned ranges and a barrier per range;
//     these ranges are 1-10 KB and start anywhere). Whether the lanes' data
//     is staged (kStaged), and their rows of w and v (kStageCoef), is the
//     wrapper's plan, a template argument here, so no access branches on it;
//     what is not staged is read from device memory through __ldg (w and v
//     when D is too wide; everything for a lane too large to stage, its row
//     values then in a device scratch);
//   * margins: a group of `row_threads` threads (a power of two, at most
//     32, no more than K needs, and no more than the rows of a block of
//     the shape's own packing leave room for: a function of M and K alone,
//     never of E, so a lane's sums do not depend on the batch it rides in)
//     shares a row; each gathers its slots' coefficients from shared
//     memory and sums its share of them in k order, and the group adds its
//     partials by shuffles in the adjacent-pair order;
//   * loss terms: one thread per row, into shared memory (zero-padded to a
//     power of two rows per lane);
//   * column phase: per-slab tables sized by the non-zeros (built once by
//     the wrapper, SparseSlab.kernel_tables) list each lane's populated
//     columns and, per column, its slots in flat (m, k) order. A thread owns
//     a column and sums val * d over its slots from shared memory in that
//     order: no atomics, bitwise repeatable, the TPU's scatter order. The
//     lanes' gradient rows are zero-filled first with 16-byte stores;
//   * row sums: a warp per lane and sum; each thread first adds its
//     contiguous share of the rows in adjacent pairs, then shuffles finish
//     the tree (lane i adds lane i + s for i a multiple of 2s): level for
//     level the association of tree_row_sum, with no barrier between levels.
//     Nothing else runs per call: one launch.
//   * the lane-indirect launch (a solve scheduler's compacted batch): an
//     int32 (R,) list of lane ids names the lanes of the full slab the R
//     positions take. Position i reads lane ids[i]'s idx/val and its
//     column-table entries from the full slab's tables; w, v, y/wt/off and
//     every output are in compacted order. A block's lanes are then no one
//     range, so it gathers their rows and table entries into shared memory
//     with plain loads (packed, the table entries rebased to the block),
//     and every phase after that is the direct launch's, with the same
//     arithmetic: each position's results equal its lane's from the full
//     launch, bit for bit.
// Products use __fmul_rn and sums __fadd_rn, so nvcc does not contract them
// into fused multiply-adds: each step rounds as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "losses.cuh"

namespace photon {

// A slab's launch description, built once per slab and kernel by the
// wrapper (ops/fused_sparse.py, _SlabPlan mirrors this layout).
struct SlabPlan {
  const int* idx;         // (E, M, K) int32
  const void* val;        // (E, M, K) f32 or bf16
  const int* lane_cols;   // (E + 1,) each lane's first entry in cols/col_end
  const int* lane_slots;  // (E + 1,) each lane's first slot in `slots`
  const int* cols;        // (C,) populated column of each entry
  const int* col_end;     // (C,) end of each entry's slots in `slots`
  const void* slots;      // (nnz,) lane-local slot m * K + k, uint16 or int32
  long long lanes;
  int m, k, d;
  int val_bf16;           // 1: val is bf16
  int slot16;             // 1: slots are uint16
  int lanes_per_block;
  int row_threads;        // threads per row: a power of two, at most 32
  int rows_pow2;          // M rounded up to a power of two
  int table_cols;         // staged table entries a block holds at most
  int table_slots;        // staged slot positions a block holds at most
  int staged;             // 1: slab, y/wt/off, row values, tables in shared memory
  int stage_coef;         // 1: w (and v) staged in shared memory
  int smem_bytes;
  int indirect;           // 1: the lane-indirect launch (its header layout)
};

}  // namespace photon

namespace {

using photon::SlabPlan;

constexpr int kThreads = 256;
// eight resident blocks an SM (32 registers a thread): the wrapper packs
// lanes so that the grid is one such wave where it can (BLOCKS_PER_SM)
constexpr int kMinBlocks = 8;

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

// a load from shared memory, or from device memory through the read-only path
template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// a staged range of n bytes takes 16 more, for the granule rounding of stage()
__host__ __device__ inline long long staged_bytes(long long n) {
  return align16(n) + 16;
}

// Shared-memory layout, in bytes: the lanes' table offsets; when staged,
// two (L, rows_pow2) arrays of row values, y/wt/off, idx, val and the
// block's table entries (table_cols columns and table_slots slots at most);
// then w (and v) when stage_coef.
struct Layout {
  long long rows, rowvec, idx, val, cols, col_end, slots, coef, total;
};

__host__ __device__ inline Layout layout(const SlabPlan& p, bool hvp) {
  const long long l = p.lanes_per_block;
  const long long slots = l * p.m * p.k;
  const bool s = p.staged != 0;
  Layout o;
  // header: the lanes' table offsets (direct), or their ids, both table
  // prefixes and the scan's scratch (indirect)
  o.rows = p.indirect ? align16(4 * (3 * l + 18)) : align16(8 * (l + 1));
  o.rowvec = o.rows + (s ? align16(8 * l * p.rows_pow2) : 0);
  o.idx = o.rowvec + (s ? 3 * staged_bytes(4 * l * p.m) : 0);
  o.val = o.idx + (s ? staged_bytes(4 * slots) : 0);
  o.cols = o.val + (s ? staged_bytes((p.val_bf16 ? 2 : 4) * slots) : 0);
  o.col_end = o.cols + (s ? staged_bytes(4LL * p.table_cols) : 0);
  o.slots = o.col_end + (s ? staged_bytes(4LL * p.table_cols) : 0);
  o.coef = o.slots + (s ? staged_bytes((p.slot16 ? 2LL : 4LL) * p.table_slots) : 0);
  o.total = o.coef + (p.stage_coef ? (hvp ? 2 : 1) * staged_bytes(4 * l * p.d) : 0);
  return o;
}

// Copies the device-memory elements [src, src + n) into shared memory at
// dst with 16-byte cp.async over the whole granules that hold them; returns
// where src's first element landed. Device allocations are 512-byte
// granular, so those granules lie inside src's allocation.
template <typename T>
__device__ __forceinline__ const T* stage(char* dst, const T* src, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~uintptr_t(15);
  const int chunks =
      n > 0 ? (int)((((a + sizeof(T) * n + 15) & ~uintptr_t(15)) - lo) >> 4) : 0;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(lo + 16 * (uintptr_t)i));
  }
  return reinterpret_cast<const T*>(dst + (a - lo));
}

// out[0, n) = 0 with 16-byte stores between a scalar head and tail
__device__ __forceinline__ void zero_fill(float* out, int n) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4);
  const int body = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) out[i] = 0.f;
  float4* v = reinterpret_cast<float4*>(out + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x) out[i] = 0.f;
}

// Adjacent-pair tree over `width` consecutive lanes (a power of two, at most
// 32): lane i adds lane i + s for s = 1, 2, 4, ...; the first lane of each
// group ends with the group's sum, in tree_row_sum's association.
__device__ __forceinline__ float pair_tree(float x, unsigned mask, int width) {
  for (int s = 1; s < width; s <<= 1)
    x = __fadd_rn(x, __shfl_down_sync(mask, x, s, width));
  return x;
}

// The largest i in [0, n) with pre[i] <= x, for an ascending pre with
// pre[0] <= x: the lane of block-local entry x.
__device__ __forceinline__ int lane_of(const int* pre, int n, int x) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// Exclusive prefixes over the block's lanes gl[0, nl) of their column-table
// entries (cpre) and real slots (spre), cpre[nl] and spre[nl] the totals:
// each thread adds a contiguous share of lanes, warps scan by shuffles, the
// eight warp totals meet in scratch (16 ints). Integer sums: exact in any
// order. Ends with a barrier.
__device__ __forceinline__ void lane_prefixes(const SlabPlan& p, const int* gl, int nl,
                                              int* cpre, int* spre, int* scratch) {
  const int per = (nl + kThreads - 1) / kThreads;
  const int lo = min(nl, (int)threadIdx.x * per), hi = min(nl, lo + per);
  int c = 0, s = 0;
  for (int i = lo; i < hi; ++i) {
    const int g = gl[i];
    c += __ldg(p.lane_cols + g + 1) - __ldg(p.lane_cols + g);
    s += __ldg(p.lane_slots + g + 1) - __ldg(p.lane_slots + g);
  }
  int ic = c, is = s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int tc = __shfl_up_sync(0xffffffffu, ic, o);
    const int ts = __shfl_up_sync(0xffffffffu, is, o);
    if (lane >= o) {
      ic += tc;
      is += ts;
    }
  }
  if (lane == 31) {
    scratch[warp] = ic;
    scratch[8 + warp] = is;
  }
  __syncthreads();
  int xc = ic - c, xs = is - s;
  for (int w = 0; w < warp; ++w) {
    xc += scratch[w];
    xs += scratch[8 + w];
  }
  for (int i = lo; i < hi; ++i) {
    cpre[i] = xc;
    spre[i] = xs;
    const int g = gl[i];
    xc += __ldg(p.lane_cols + g + 1) - __ldg(p.lane_cols + g);
    xs += __ldg(p.lane_slots + g + 1) - __ldg(p.lane_slots + g);
  }
  if (threadIdx.x == kThreads - 1) {
    cpre[nl] = xc;
    spre[nl] = xs;
  }
  __syncthreads();
}

// One launch for all lanes. GEVM (kHvp false): out = grad, sum_a = sum wl,
// sum_b = sum d. HVP: out = hvp, sum_a = sum c. rows_out, when not null,
// receives the row values ((wl, d) or (c,), E, M); scratch holds them when
// they are not staged (2 * lanes_per_block * rows_pow2 floats per block).
// kIndirect: position e of the launch is lane lane_ids[e] of the slab
// (p.lanes is then the number of positions); y, wt, off, w, v, vshift and
// the outputs are indexed by position.
template <typename V, typename S, bool kHvp, bool kStaged, bool kStageCoef, bool kIndirect>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sparse_pass(const SlabPlan p, const int* __restrict__ lane_ids, int loss,
                const float* __restrict__ y, const float* __restrict__ wt,
                const float* __restrict__ off, const float* __restrict__ w,
                const float* __restrict__ v, const float* __restrict__ vshift,
                int vshift_stride, float* __restrict__ out, float* __restrict__ sum_a,
                float* __restrict__ sum_b, float* __restrict__ rows_out,
                float* scratch) {
  extern __shared__ __align__(16) char smem[];
  const int m = p.m, k = p.k, d = p.d, pw = p.rows_pow2;
  const long long mk = (long long)m * k;
  const long long e0 = (long long)blockIdx.x * p.lanes_per_block;
  const int nl = (int)min((long long)p.lanes_per_block, p.lanes - e0);
  const int nrows = nl * m;
  const Layout lay = layout(p, kHvp);

  // 1. start the copies that need nothing: slab (direct), row vectors,
  // coefficients
  const int* ix = p.idx + e0 * mk;
  const V* vx = static_cast<const V*>(p.val) + e0 * mk;
  const float* ry = y + e0 * m;
  const float* rwt = wt + e0 * m;
  const float* roff = off + e0 * m;
  const float* cw = w + e0 * d;
  const float* cv = kHvp ? v + e0 * d : nullptr;
  if constexpr (kStaged) {
    const long long vec_b = staged_bytes(4LL * p.lanes_per_block * m);
    if constexpr (!kIndirect) {
      ix = stage(smem + lay.idx, ix, (long long)nrows * k);
      vx = stage(smem + lay.val, vx, (long long)nrows * k);
    }
    ry = stage(smem + lay.rowvec, ry, nrows);
    rwt = stage(smem + lay.rowvec + vec_b, rwt, nrows);
    roff = stage(smem + lay.rowvec + 2 * vec_b, roff, nrows);
  }
  if constexpr (kStageCoef) {
    cw = stage(smem + lay.coef, cw, (long long)nl * d);
    if (kHvp)
      cv = stage(smem + lay.coef + staged_bytes(4LL * p.lanes_per_block * d), cv,
                 (long long)nl * d);
  }

  // 2. the lanes' offsets into the column tables (direct: a slice of the
  // slab's; indirect: the block's own prefixes over its lanes, in their
  // rebased, block-local numbering); meanwhile zero the lanes' gradient
  // rows and the row values' padding
  int* gl = reinterpret_cast<int*>(smem);  // indirect: the block's lane ids
  int* lane_cols = kIndirect ? gl + nl : reinterpret_cast<int*>(smem);
  int* slot_range = lane_cols + nl + 1;  // direct: (first, end) slot; indirect: prefixes
  if constexpr (kIndirect) {
    for (int i = threadIdx.x; i < nl; i += blockDim.x) gl[i] = __ldg(lane_ids + e0 + i);
    __syncthreads();
    lane_prefixes(p, gl, nl, lane_cols, slot_range, slot_range + nl + 1);
  } else {
    for (int i = threadIdx.x; i <= nl; i += blockDim.x) lane_cols[i] = __ldg(p.lane_cols + e0 + i);
    if (threadIdx.x < 2) slot_range[threadIdx.x] = __ldg(p.lane_slots + e0 + threadIdx.x * nl);
  }
  float* rv = kStaged ? reinterpret_cast<float*>(smem + lay.rows)
                      : scratch + (long long)blockIdx.x * 2 * p.lanes_per_block * pw;
  float* rv1 = rv + nl * pw;
  const int pad = pw - m;
  for (int i = threadIdx.x; i < 2 * nl * pad; i += blockDim.x)
    rv[(i / pad) * pw + m + i % pad] = 0.f;
  zero_fill(out + e0 * d, nl * d);
  __syncthreads();

  // 3. the block's column-table entries, then wait for every copy. The
  // entries of a direct block are one range of the tables (entry i of the
  // block is entry c_lo + i, its slots numbered from s_lo); an indirect
  // block numbers its entries and slots from 0 in lane order.
  const int c_lo = kIndirect ? 0 : lane_cols[0], c_hi = lane_cols[nl];
  const int s_lo = kIndirect ? 0 : slot_range[0];
  const int* tcol = p.cols + c_lo;
  const int* tend = p.col_end + c_lo;
  const S* tslot = static_cast<const S*>(p.slots) + s_lo;
  if constexpr (kStaged && kIndirect) {
    int* sidx = reinterpret_cast<int*>(smem + lay.idx);
    V* sval = reinterpret_cast<V*>(smem + lay.val);
    for (int i = threadIdx.x; i < nrows * k; i += kThreads) {
      const int li = (int)(i / mk);
      const long long at = (long long)gl[li] * mk + (i - li * mk);
      sidx[i] = __ldg(p.idx + at);
      sval[i] = static_cast<const V*>(p.val)[at];
    }
    int* scol = reinterpret_cast<int*>(smem + lay.cols);
    int* send = reinterpret_cast<int*>(smem + lay.col_end);
    S* sslot = reinterpret_cast<S*>(smem + lay.slots);
    for (int c = threadIdx.x; c < c_hi; c += kThreads) {
      const int li = lane_of(lane_cols, nl, c);
      const int g = gl[li];
      const int ge = __ldg(p.lane_cols + g) + c - lane_cols[li];
      scol[c] = __ldg(p.cols + ge);
      send[c] = __ldg(p.col_end + ge) - __ldg(p.lane_slots + g) + slot_range[li];
    }
    for (int s = threadIdx.x; s < slot_range[nl]; s += kThreads) {
      const int li = lane_of(slot_range, nl, s);
      const int g = gl[li];
      sslot[s] = static_cast<const S*>(p.slots)[__ldg(p.lane_slots + g) + s - slot_range[li]];
    }
    ix = sidx;
    vx = sval;
    tcol = scol;
    tend = send;
    tslot = sslot;
  } else if constexpr (kStaged) {
    tcol = stage(smem + lay.cols, tcol, c_hi - c_lo);
    tend = stage(smem + lay.col_end, tend, c_hi - c_lo);
    tslot = stage(smem + lay.slots, tslot, slot_range[1] - s_lo);
  }
  if constexpr (kStaged || kStageCoef) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  // an unstaged indirect block reads its lanes' rows from the full slab
  constexpr bool kFar = kIndirect && !kStaged;
  auto lane_idx = [&](int li) -> const int* {
    return kFar ? p.idx + (long long)gl[li] * mk : ix + li * mk;
  };
  auto lane_val = [&](int li) -> const V* {
    return kFar ? static_cast<const V*>(p.val) + (long long)gl[li] * mk : vx + li * mk;
  };

  // 4. margins: a group of tpr threads per row; z (GEVM) into rv1, z and zv
  // (HVP) into rv1 and rv
  const int tpr = p.row_threads;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const unsigned mask =
      tpr == 32 ? 0xffffffffu : ((1u << tpr) - 1u) << ((threadIdx.x & 31) & ~(unsigned)(tpr - 1));
  for (int r = grp; r < nrows; r += kThreads / tpr) {
    const int li = r / m;
    const int q0 = (r - li * m) * k;
    const int* lix = lane_idx(li) + q0;
    const V* lvx = lane_val(li) + q0;
    const float* lw = cw + li * d;
    float z = 0.f, zv = 0.f;
    for (int q = t; q < k; q += tpr) {
      const int j = ld<kStaged>(lix + q);
      const float x = Val<V>::f(ld<kStaged>(lvx + q));
      z = __fadd_rn(z, __fmul_rn(ld<kStageCoef>(lw + j), x));
      if (kHvp) zv = __fadd_rn(zv, __fmul_rn(ld<kStageCoef>(cv + li * d + j), x));
    }
    z = pair_tree(z, mask, tpr);
    if (kHvp) zv = pair_tree(zv, mask, tpr);
    if (t == 0) {
      const int at = li * pw + r - li * m;
      rv1[at] = z;
      if (kHvp) rv[at] = zv;
    }
  }
  __syncthreads();

  // 5. loss terms, one thread per row: (wl, d) into (rv, rv1), or c into rv
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int li = r / m;
    const int at = li * pw + r - li * m;
    const float z = __fadd_rn(rv1[at], ld<kStaged>(roff + r));
    const float wi = ld<kStaged>(rwt + r);
    if (kHvp) {
      const float zv = __fadd_rn(rv[at], __ldg(vshift + (e0 + li) * vshift_stride));
      const float d2 =
          wi > 0.f ? __fmul_rn(wi, photon::loss_d2(loss, z, ld<kStaged>(ry + r))) : 0.f;
      rv[at] = __fmul_rn(d2, zv);
    } else {
      float l, g;
      photon::loss_and_d1(loss, z, ld<kStaged>(ry + r), &l, &g);
      rv[at] = wi > 0.f ? __fmul_rn(wi, l) : 0.f;
      rv1[at] = wi > 0.f ? __fmul_rn(wi, g) : 0.f;
    }
  }
  __syncthreads();
  constexpr int nrv = kHvp ? 1 : 2;
  if (rows_out != nullptr) {
    for (int i = threadIdx.x; i < nrv * nrows; i += kThreads) {
      const int a = i / nrows, r = i - a * nrows, li = r / m;
      rows_out[(a * p.lanes + e0) * m + r] = rv[(a * nl + li) * pw + r - li * m];
    }
  }

  // 6. column phase: a thread owns a populated column of one of the lanes
  const float* coef_rows = kHvp ? rv : rv1;
  // q / k as a multiply-shift: exact for 16-bit slot positions
  const unsigned long long inv_k = ((1ULL << 32) + k - 1) / k;
  for (int c = c_lo + threadIdx.x; c < c_hi; c += kThreads) {
    const int lo = lane_of(lane_cols, nl, c);  // lane_cols[lo] <= c < lane_cols[lo + 1]
    const int i = c - c_lo;
    int beg, end, col;
    const S* sl = tslot;
    if constexpr (kFar) {
      // the full slab's own entry and global slot numbering
      const int ge = __ldg(p.lane_cols + gl[lo]) + c - lane_cols[lo];
      beg = ge == 0 ? 0 : __ldg(p.col_end + ge - 1);
      end = __ldg(p.col_end + ge);
      col = __ldg(p.cols + ge);
      sl = static_cast<const S*>(p.slots);
    } else {
      beg = (i == 0 ? s_lo : ld<kStaged>(tend + i - 1)) - s_lo;
      end = ld<kStaged>(tend + i) - s_lo;
      col = ld<kStaged>(tcol + i);
    }
    const float* rc = coef_rows + lo * pw;
    const V* lval = lane_val(lo);
    float acc = 0.f;
    for (int s = beg; s < end; ++s) {
      const int q = (int)ld<kStaged>(sl + s);
      const int row = sizeof(S) == 2 ? (int)((q * inv_k) >> 32) : q / k;
      acc = __fadd_rn(acc, __fmul_rn(Val<V>::f(ld<kStaged>(lval + q)), rc[row]));
    }
    out[(e0 + lo) * d + col] = acc;
  }

  __syncthreads();

  // 7. row sums: a warp per (sum, lane)
  const int lane = threadIdx.x & 31, width = pw < 32 ? pw : 32, share = pw / width;
  for (int u = threadIdx.x >> 5; u < nrv * nl; u += kThreads / 32) {
    float* x = rv + u * pw + lane * share;
    float acc = 0.f;
    if (lane < width) {
      for (int s = 1; s < share; s <<= 1)
        for (int i = 0; i < share; i += 2 * s) x[i] = __fadd_rn(x[i], x[i + s]);
      acc = x[0];
    }
    acc = pair_tree(acc, 0xffffffffu, width);
    if (lane == 0) (u < nl ? sum_a : sum_b)[e0 + u % nl] = acc;
  }
}

// Once per kernel and process: the most dynamic shared memory a block may
// have, and the SM's carveout at its largest shared share, so that the
// resident blocks the plan counts on fit (the settings hold for the card
// that is current then; the port drives one card).
template <typename V, typename S, bool kHvp, bool kStaged, bool kStageCoef, bool kIndirect>
int configure() {
  auto kernel = sparse_pass<V, S, kHvp, kStaged, kStageCoef, kIndirect>;
  static int done = 0;
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return (int)err;
}

struct Args {
  const int* lane_ids;
  int loss;
  const float *y, *wt, *off, *w, *v, *vshift;
  int vs;
  float *out, *sum_a, *sum_b, *rows_out, *scratch;
  cudaStream_t stream;
};

template <typename V, typename S, bool kHvp, bool kStaged, bool kStageCoef, bool kIndirect>
int launch(const SlabPlan& p, const Args& a) {
  auto kernel = sparse_pass<V, S, kHvp, kStaged, kStageCoef, kIndirect>;
  const int err = configure<V, S, kHvp, kStaged, kStageCoef, kIndirect>();
  if (err != 0) return err;
  const long long blocks = (p.lanes + p.lanes_per_block - 1) / p.lanes_per_block;
  kernel<<<(unsigned)blocks, kThreads, p.smem_bytes, a.stream>>>(
      p, a.lane_ids, a.loss, a.y, a.wt, a.off, a.w, a.v, a.vshift, a.vs, a.out, a.sum_a,
      a.sum_b, a.rows_out, a.scratch);
  return (int)cudaGetLastError();
}

template <typename V, typename S, bool kHvp, bool kIndirect>
int launch_plan(const SlabPlan& p, const Args& a) {
  if (p.staged) {
    if (p.stage_coef) return launch<V, S, kHvp, true, true, kIndirect>(p, a);
    return launch<V, S, kHvp, true, false, kIndirect>(p, a);
  }
  if (p.stage_coef) return launch<V, S, kHvp, false, true, kIndirect>(p, a);
  return launch<V, S, kHvp, false, false, kIndirect>(p, a);
}

template <typename V, typename S, bool kHvp>
int launch_mode(const SlabPlan& p, const Args& a) {
  if (p.indirect) return launch_plan<V, S, kHvp, true>(p, a);
  return launch_plan<V, S, kHvp, false>(p, a);
}

bool bad_plan(const SlabPlan* p, bool hvp, const void* lane_ids) {
  if (p == nullptr || p->lanes < 1 || p->lanes > 2147483647LL || p->m < 1 ||
      p->k < 1 || p->d < 1 || p->lanes_per_block < 1)
    return true;
  if ((p->indirect != 0) != (lane_ids != nullptr)) return true;
  const int t = p->row_threads;
  if (t < 1 || t > 32 || (t & (t - 1)) != 0) return true;
  if (p->rows_pow2 < p->m || (p->rows_pow2 & (p->rows_pow2 - 1)) != 0) return true;
  if (p->table_cols < 0 || p->table_slots < 0) return true;
  if ((long long)p->lanes_per_block * p->m * p->k > 2147483647LL ||
      (long long)p->lanes_per_block * p->d > 2147483647LL)
    return true;
  const long long need = layout(*p, hvp).total;
  return need != p->smem_bytes || need > 227 * 1024;
}

template <bool kHvp>
int dispatch(const SlabPlan* p, const void* lane_ids, int loss, const void* y,
             const void* wt, const void* off, const void* w, const void* v,
             const void* vshift, int vs, void* out, void* sum_a, void* sum_b,
             void* rows_out, void* scratch, void* stream) {
  if (bad_plan(p, kHvp, lane_ids)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int*>(lane_ids), loss,
               static_cast<const float*>(y), static_cast<const float*>(wt),
               static_cast<const float*>(off), static_cast<const float*>(w),
               static_cast<const float*>(v), static_cast<const float*>(vshift), vs,
               static_cast<float*>(out), static_cast<float*>(sum_a),
               static_cast<float*>(sum_b), static_cast<float*>(rows_out),
               static_cast<float*>(scratch), static_cast<cudaStream_t>(stream)};
  if (p->val_bf16) {
    if (p->slot16) return launch_mode<__nv_bfloat16, uint16_t, kHvp>(*p, a);
    return launch_mode<__nv_bfloat16, int, kHvp>(*p, a);
  }
  if (p->slot16) return launch_mode<float, uint16_t, kHvp>(*p, a);
  return launch_mode<float, int, kHvp>(*p, a);
}

}  // namespace

extern "C" {

// Both return a cudaError_t code; 0 means the kernel was launched on
// `stream`. `plan` is a host pointer to the launch's SlabPlan; lane_ids is
// null for the direct launch, else the device int32 (plan->lanes,) lane
// ids of the lane-indirect one (plan->indirect set). The others are device
// pointers of contiguous f32 tensors, indexed by launch position: y, wt,
// off (lanes, m); w, v, grad/hvp (lanes, d); the sums (lanes,); vshift
// (lanes,) with stride 1, or one value for every lane with stride 0.
// rows_out ((2 or 1), lanes, m) may be null; scratch is null when the plan
// stages the rows.
int photon_sparse_gevm(const photon::SlabPlan* plan, const void* lane_ids, int loss,
                       const void* y, const void* wt, const void* off, const void* w,
                       void* grad, void* sum_wl, void* sum_d, void* rows_out,
                       void* scratch, void* stream) {
  return dispatch<false>(plan, lane_ids, loss, y, wt, off, w, nullptr, nullptr, 0, grad,
                         sum_wl, sum_d, rows_out, scratch, stream);
}

int photon_sparse_hvp(const photon::SlabPlan* plan, const void* lane_ids, int loss,
                      const void* y, const void* wt, const void* off, const void* w,
                      const void* v, const void* vshift, int vshift_stride,
                      void* hvp, void* sum_c, void* rows_out, void* scratch,
                      void* stream) {
  if (vshift_stride != 0 && vshift_stride != 1) return (int)cudaErrorInvalidValue;
  return dispatch<true>(plan, lane_ids, loss, y, wt, off, w, v, vshift, vshift_stride, hvp,
                        sum_c, nullptr, rows_out, scratch, stream);
}

}  // extern "C"
