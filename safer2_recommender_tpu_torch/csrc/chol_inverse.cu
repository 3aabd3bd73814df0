// Batched inverse Cholesky factor of small SPD systems:
//
//     out[n] = inv(chol(a[n] + diag(ridge[n])))      (lower triangular)
//
// for a [N, r, r], ridge [N, r], out [N, r, r], float32, batch-major,
// r in {8, 16, 32, 64}. Only the lower triangle of a is read; out is
// exactly zero above the diagonal.
//
// Replaces two Pallas kernels of the JAX package:
//   * safer2_recommender_tpu/ops/block_chol.py::_leaf_kernel (launched
//     by _leaf_lane): the column-by-column leaf for r <= 32;
//   * safer2_recommender_tpu/ops/block_chol.py::_lane_matmul_kernel
//     (launched by _lane_matmul): the batched 32x32 products of the
//     r = 64 recursion (_rec_lane).
// One kernel covers the whole <= 64 subtree: at r = 64 the elimination
// simply runs 64 steps, so there is no 2x2 block recursion and no
// batched product between launches.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores, 700 W): the function reads the lower triangle of a system and
// its ridge, 4 r (r + 1) / 2 + 4 r bytes, writes 4 r^2 and needs about
// 2 r^3 / 3 FLOP (r^3 / 3 for the factor, as many for its inverse),
// about r / 9 FLOP per byte, below the card's ~20 FLOP/byte ridge.
// So a full launch is bound by bytes: 30.5 us at [4096, 64, 64], 7.7 us
// at [4096, 32, 32], 6.9 us at the largest ML-1M dim-512 shape
// [928, 64, 64], 15.3 us at the 50k synthetic set's most frequent
// [2048, 64, 64], 2.3 us at ML-1M dim 512's most frequent [304, 64, 64].
// But most main-path launches hold fewer systems than the card has room
// for at once (one wave: 132 SMs x 8 systems at r = 64, x 40 at 32, x 96
// at 16, x 256 at 8): every ML-1M dim-512 launch does, and [304, 64, 64]
// is bound by the latency of one system, r dependent elimination steps,
// not by its bytes; the full and near-full shapes above are bound by
// bytes and issue. So the design cuts the work and the latency of a step
// first and keeps the arithmetic in registers, off shared memory.
//
// The algorithm: right-looking elimination that forms the factor and its
// inverse in the same step. Step j takes the pivot p = a[j][j] +
// ridge[j] (the ridge is added lazily, as _leaf_kernel does), clamps it
// at 1e-30 before rsqrtf, scales column j into L[:, j] and applies two
// rank-1 updates at once: the trailing matrix a[i][k] -= L[i][j] L[k][j]
// and the inverse X[j, :] *= 1/L[j][j], X[i, :] -= L[i][j] X[j, :] for
// i > j (X starts as the identity). Both updates need only column j, so
// a step is one broadcast of that column and independent FMAs: O(1)
// depth, no serial dot product.
//
// The layout: thread t of a system owns one register array v[r]: the
// lower-triangle "hook" of a through (t, t), that is row t left of the
// diagonal and column t below it. Until step t the thread applies the
// trailing update to its hook; at step t column t of the factor is
// final, and column t of X is that column times -1/p_t, so the thread
// keeps it as it is and remembers the scale; after step t it updates
// its X column. Every thread runs the same FMAs at every step (m > j),
// with no branch on its role and no predicate per element, the r x r
// system lives in r registers per thread, and nothing divides at run
// time. Thread c stores column c of X (row by row, coalesced), with
// exact zeros above the diagonal.
//   * r <= 32: a system is a group of r lanes of one warp (r = 8 packs
//     4 systems in a warp, 16 two), column j is broadcast with
//     __shfl_sync, and there is no shared memory and no barrier; a
//     block of 128 threads holds 128 / r systems and masks the ragged
//     tail of N (an idle group computes on zeros and stores nothing).
//   * r = 64: a system is a block of two warps; column j goes through a
//     double-buffered 2 x 64 float array in shared memory, read as
//     float4, with one __syncthreads per step (64 per system, not 128).
// Every loop is unrolled at compile time so v stays in registers (the
// step and column indices are constants). Arithmetic is plain f32 FMA:
// no TF32, no tensor cores.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch (or cudaErrorMisalignedAddress if a is not 16-byte aligned:
// rows are read as float4).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpBlock = 128;  // threads per block for r <= 32

// Column j of the system reaches every thread of it: lanes of a warp.
template <int R>
struct ShuffleColumn {
  static constexpr bool kVector = false;
  float w;
  __device__ __forceinline__ void publish(float x, int /*t*/, int /*j*/) {
    w = x;
  }
  __device__ __forceinline__ float get(int m) const {
    return __shfl_sync(kFullMask, w, m, R);
  }
};

// Column j of the system reaches every thread of it: the threads of a
// block, through shared memory, read four at a time. Two buffers, so
// step j + 1 may write while a slow thread still reads step j's column.
template <int R>
struct SharedColumn {
  static constexpr bool kVector = true;
  float4 (*buf)[R / 4];
  int cur;
  __device__ __forceinline__ void publish(float x, int t, int j) {
    reinterpret_cast<float*>(buf[j & 1])[t] = x;
    __syncthreads();
    cur = j & 1;
  }
  __device__ __forceinline__ float get(int m) const {
    return reinterpret_cast<const float*>(buf[cur])[m];
  }
  __device__ __forceinline__ float4 get4(int q) const { return buf[cur][q]; }
};

// Thread t's share of one system. On entry v[m] is a[t][m] for m <= t
// (row t) and a[m][t] for m > t (column t), both from the lower
// triangle. Step j:
//   * thread j publishes its pivot with the ridge, threads > j their
//     entry of column j (what threads < j publish is not read);
//   * every thread but j scales v[j] by 1/L[j][j] and subtracts
//     coef * column j from v[m], m > j, with coef = v[j] / L[j][j]:
//     for t > j this is the trailing update of row t and column t of a;
//     for t < j it is the update of column t of X;
//   * thread j keeps v[m], m > j, as they are: from here on they hold
//     column j of X divided by scale = -1/p_j (X[m][j] = -L[m][j] /
//     L[j][j] = scale * a[m][j]), so the switch from a to X costs
//     nothing, and the later updates need no rescaling (the scale
//     cancels). v[j] becomes X[j][j] = 1/L[j][j].
// No thread branches on its role: every step is the same FMAs for all.
// Returns thread t's scale; X[i][t] is scale * v[i] for i > t.
template <int R, class Column>
__device__ __forceinline__ float eliminate(float (&v)[R], float rt, int t,
                                           Column& col) {
  float scale = 1.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool pivot = t == j;
    col.publish(pivot ? v[j] + rt : v[j], t, j);
    const float inv = rsqrtf(fmaxf(col.get(j), 1e-30f));
    const float x = (pivot ? 1.f : v[j]) * inv;
    v[j] = x;
    const float coef = pivot ? 0.f : x * inv;
    if (pivot) scale = -inv * inv;
    if constexpr (Column::kVector) {
#pragma unroll
      for (int q = (j + 1) / 4; q < R / 4; ++q) {
        const float4 s4 = col.get4(q);
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e > j) v[4 * q + e] = fmaf(-coef, s[e], v[4 * q + e]);
        }
      }
    } else {
#pragma unroll
      for (int m = j + 1; m < R; ++m) {
        v[m] = fmaf(-coef, col.get(m), v[m]);  // all lanes shuffle
      }
    }
  }
  return scale;
}

// v[m] = a[t][m] for m <= t (row t, read as float4) and a[m][t] for
// m > t (column t: lane t reads element t of each row, so a warp reads
// consecutive words); zeros for an idle group.
template <int R>
__device__ __forceinline__ void load_hook(const float* __restrict__ a,
                                          const float* __restrict__ ridge,
                                          int64_t sys, int t, bool valid,
                                          float (&v)[R], float& rt) {
  const float* mat = a + sys * R * R;
  const float4* row = reinterpret_cast<const float4*>(mat + t * R);
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && 4 * q <= t) f = __ldg(row + q);
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int m = 1; m < R; ++m) {
    if (m > t) v[m] = valid ? __ldg(mat + m * R + t) : 0.f;
  }
  rt = valid ? __ldg(ridge + sys * R + t) : 0.f;
}

// Column t of X = inv(L): scale * v[i] below the diagonal, v[t] on it,
// exact zeros above; lane t writes element t of each row.
template <int R>
__device__ __forceinline__ void store_column(float* __restrict__ out,
                                             int64_t sys, int t, float scale,
                                             const float (&v)[R]) {
  float* o = out + sys * R * R + t;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    o[i * R] = i > t ? scale * v[i] : (i == t ? v[i] : 0.f);
  }
}

// r <= 32: 128 / R systems per block, R lanes each.
template <int R>
__global__ void __launch_bounds__(kWarpBlock)
    chol_inverse_warp_kernel(const float* __restrict__ a,
                             const float* __restrict__ ridge,
                             float* __restrict__ out, long long n) {
  static_assert(R == 8 || R == 16 || R == 32, "warp kernel takes r <= 32");
  const int t = threadIdx.x % R;
  const int64_t sys =
      static_cast<int64_t>(blockIdx.x) * (kWarpBlock / R) + threadIdx.x / R;
  const bool valid = sys < n;
  float v[R];
  float rt;
  load_hook<R>(a, ridge, valid ? sys : 0, t, valid, v, rt);
  ShuffleColumn<R> col;
  const float scale = eliminate<R>(v, rt, t, col);
  if (valid) store_column<R>(out, sys, t, scale, v);
}

// r = 64: one system per block of 64 threads.
__global__ void __launch_bounds__(64)
    chol_inverse_block64_kernel(const float* __restrict__ a,
                                const float* __restrict__ ridge,
                                float* __restrict__ out) {
  constexpr int R = 64;
  __shared__ float4 buf[2][R / 4];
  const int t = threadIdx.x;
  const int64_t sys = blockIdx.x;
  float v[R];
  float rt;
  load_hook<R>(a, ridge, sys, t, true, v, rt);
  SharedColumn<R> col{buf, 0};
  const float scale = eliminate<R>(v, rt, t, col);
  store_column<R>(out, sys, t, scale, v);
}

template <int R>
cudaError_t launch_warp(const float* a, const float* ridge, float* out,
                        long long n, cudaStream_t stream) {
  constexpr long long per_block = kWarpBlock / R;
  const long long blocks = (n + per_block - 1) / per_block;
  chol_inverse_warp_kernel<R>
      <<<static_cast<unsigned>(blocks), kWarpBlock, 0, stream>>>(a, ridge,
                                                                 out, n);
  return cudaGetLastError();
}

template <int R>
cudaError_t resident_warp(int* systems) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, chol_inverse_warp_kernel<R>, kWarpBlock, 0);
  *systems = blocks * (kWarpBlock / R);
  return err;
}

}  // namespace

// Systems of size r that one SM holds at once (the occupancy the
// compiled kernel allows): one wave of a launch is this times the SMs.
extern "C" int frt_chol_inverse_resident(int r, int* systems_per_sm) {
  switch (r) {
    case 8:
      return static_cast<int>(resident_warp<8>(systems_per_sm));
    case 16:
      return static_cast<int>(resident_warp<16>(systems_per_sm));
    case 32:
      return static_cast<int>(resident_warp<32>(systems_per_sm));
    case 64:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          systems_per_sm, chol_inverse_block64_kernel, 64, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int frt_chol_inverse_f32(const void* a, const void* ridge,
                                    void* out, long long n, int r,
                                    void* stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* pa = static_cast<const float*>(a);
  const float* pr = static_cast<const float*>(ridge);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 8:
      return static_cast<int>(launch_warp<8>(pa, pr, po, n, s));
    case 16:
      return static_cast<int>(launch_warp<16>(pa, pr, po, n, s));
    case 32:
      return static_cast<int>(launch_warp<32>(pa, pr, po, n, s));
    case 64:
      chol_inverse_block64_kernel<<<static_cast<unsigned>(n), 64, 0, s>>>(
          pa, pr, po);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
