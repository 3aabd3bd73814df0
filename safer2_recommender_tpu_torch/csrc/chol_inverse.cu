// Batched inverse Cholesky factor of small SPD systems:
//
//     out[n] = inv(chol(a[n] + diag(ridge[n])))      (lower triangular)
//
// for a [N, r, r], ridge [N, r], out [N, r, r], float32, batch-major,
// r in {8, 16, 32, 64}.
//
// Replaces two Pallas kernels of the JAX package:
//   * safer2_recommender_tpu/ops/block_chol.py::_leaf_kernel (launched
//     by _leaf_lane): the column-by-column leaf for r <= 32;
//   * safer2_recommender_tpu/ops/block_chol.py::_lane_matmul_kernel
//     (launched by _lane_matmul): the batched 32x32 products of the
//     r = 64 recursion (_rec_lane).
// One kernel covers the whole <= 64 subtree: at r = 64 the column loop
// simply runs 64 steps, so there is no 2x2 block recursion and no
// batched product between launches.
//
// What bounds it on an H100: per system it does about r^3/3 f32 FMAs
// for the factor plus r^3/6 for the inverse (r^3 FLOP in all), against
// 2 * r^2 * 4 bytes of device traffic (read a, write out), i.e. r/8
// FLOP per byte -- 8 at r = 64, below the card's ~20 f32 FLOP/byte
// ridge point (67 TFLOP/s over 3.35 TB/s), but
// the bytes are few too: at r <= 64 a system is a chain of r dependent
// steps, so the kernel is bound by latency (one barrier pair per
// column) and by how many systems are in flight (occupancy), not by
// bandwidth or arithmetic.
//
// What the design does about it: one thread block per system, the
// whole matrix and its inverse resident in shared memory (at r = 64,
// 2 * 64 * 65 * 4 B = 33 KB with a one-column pad against bank
// conflicts), so each of the r steps touches only shared memory, and
// thousands of independent blocks keep every SM busy while any one
// block waits at a barrier. The ridge is added lazily to each pivot as
// its column is read, as _leaf_kernel does, and the pivot is clamped at
// 1e-30 before rsqrtf, so zero or rank-deficient systems stay finite
// where they can (the caller scrubs rows that do not). Only the lower
// triangle of the trailing matrix is updated. Arithmetic is plain f32
// FMA: no TF32, no tensor cores. Packing several small systems per
// block (or one per warp) and mma for the trailing update are the
// obvious next steps; they are left for a later change.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

template <int R>
__global__ void chol_inverse_kernel(const float* __restrict__ a,
                                    const float* __restrict__ ridge,
                                    float* __restrict__ out) {
  constexpr int LD = R + 1;  // padded leading dimension
  __shared__ float sa[R * LD];
  __shared__ float sinv[R * LD];
  __shared__ float scol[R];
  __shared__ float sridge[R];

  const int64_t sys = blockIdx.x;
  const float* ga = a + sys * R * R;
  float* go = out + sys * R * R;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < R * R; e += nt) {
    const int i = e / R, k = e % R;
    sa[i * LD + k] = ga[e];
    sinv[i * LD + k] = 0.f;
  }
  for (int i = tid; i < R; i += nt) sridge[i] = ridge[sys * R + i];
  __syncthreads();

  for (int j = 0; j < R; ++j) {
    const float inv_piv =
        rsqrtf(fmaxf(sa[j * LD + j] + sridge[j], 1e-30f));
    // Cholesky column j, rows >= j, with the ridge on the pivot only.
    for (int i = j + tid; i < R; i += nt) {
      const float v = sa[i * LD + j] + (i == j ? sridge[j] : 0.f);
      scol[i] = v * inv_piv;
    }
    __syncthreads();
    // Write L[:, j], apply the rank-1 update to the trailing lower
    // triangle (rows i > j, columns j < k <= i) and, independently,
    // form inverse row j from rows < j:
    //   inv[j, c] = (delta_jc - sum_{c <= k < j} L[j, k] inv[k, c]) / L[j, j]
    const int m = R - j;
    for (int e = tid; e < m * m; e += nt) {
      const int i = j + e / m, k = j + e % m;
      if (k == j) {
        sa[i * LD + j] = scol[i];
      } else if (k <= i) {
        sa[i * LD + k] -= scol[i] * scol[k];
      }
    }
    for (int c = tid; c <= j; c += nt) {
      float acc = (c == j) ? 1.f : 0.f;
      for (int k = c; k < j; ++k) acc -= sa[j * LD + k] * sinv[k * LD + c];
      sinv[j * LD + c] = acc * inv_piv;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * R; e += nt) {
    go[e] = sinv[(e / R) * LD + e % R];
  }
}

template <int R>
cudaError_t launch(const float* a, const float* ridge, float* out,
                   long long n, cudaStream_t stream) {
  constexpr int threads = R * R < 256 ? R * R : 256;
  chol_inverse_kernel<R><<<static_cast<unsigned>(n), threads, 0, stream>>>(
      a, ridge, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frt_chol_inverse_f32(const void* a, const void* ridge,
                                    void* out, long long n, int r,
                                    void* stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const float* pa = static_cast<const float*>(a);
  const float* pr = static_cast<const float*>(ridge);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 8:
      return static_cast<int>(launch<8>(pa, pr, po, n, s));
    case 16:
      return static_cast<int>(launch<16>(pa, pr, po, n, s));
    case 32:
      return static_cast<int>(launch<32>(pa, pr, po, n, s));
    case 64:
      return static_cast<int>(launch<64>(pa, pr, po, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
