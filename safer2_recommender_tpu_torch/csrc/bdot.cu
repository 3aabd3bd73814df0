// Chained batched product of small square matrices:
//
//     acc = x[n];  repeat n_dots times:  acc = (acc @ x[n]) * scale
//     out[n] = acc
//
// for x [N, h, h] float32, batch-major, h in {32, 64, 128}.
//
// Replaces the Pallas kernel of scripts/probe_bdot.py::pallas_bdot, a
// timing probe of the batched [N, 32..128, same] products that the
// blocked Cholesky factorization issues when d > 64
// (ops/block_chol.py::_factor_rec / _trsm_right). The TPU version cut
// the batch into blocks of bn matrices per grid step to fill VMEM; that
// blocking is a TPU choice and is not carried over.
//
// What bounds it on an H100: each product is 2 h^3 FLOP against no
// device traffic at all (both operands stay in shared memory for the
// whole chain), so over 8 products the kernel does 16 h^3 FLOP per
// 2 h^2 * 4 bytes read and written: 256 FLOP/byte at h = 128, far above
// the card's ~20 f32 FLOP/byte ridge point. It is bound by f32 FMA
// issue (67 TFLOP/s outside the tensor cores) and by how fast shared
// memory feeds the FMAs.
//
// What the design does about it: one thread block per matrix with 256
// threads; x and acc live in shared memory (2 h (h+1) * 4 bytes, 130 KB
// at h = 128, so the kernel takes dynamic shared memory above the 48 KB
// default). Each thread owns a TM x TN register tile of the product
// (strided rows and columns, so a warp reads consecutive columns of x
// and a broadcast element of acc), accumulates it with f32 FMAs over
// the full depth, and after a barrier writes the scaled tile back into
// acc. This is the HIGHEST-precision semantics of the TPU probe: plain
// f32 FMA, no TF32, no tensor cores. A TF32 mma or wgmma variant is
// later work.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int H, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    bdot_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_dots, float scale) {
  constexpr int LD = H + 1;  // padded leading dimension
  constexpr int BX = H / TN;  // threads along columns
  constexpr int BY = H / TM;  // threads along rows
  static_assert(BX * BY == kThreads, "tile does not cover the matrix");
  extern __shared__ float smem[];
  float* sx = smem;
  float* sacc = smem + H * LD;

  const int64_t mat = blockIdx.x;
  const float* gx = x + mat * H * H;
  float* go = out + mat * H * H;
  const int tid = threadIdx.x;
  const int tx = tid % BX;
  const int ty = tid / BX;

  for (int e = tid; e < H * H; e += kThreads) {
    const float v = gx[e];
    sx[(e / H) * LD + e % H] = v;
    sacc[(e / H) * LD + e % H] = v;
  }
  __syncthreads();

  for (int t = 0; t < n_dots; ++t) {
    float c[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sacc[(ty + i * BY) * LD + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sx[k * LD + tx + j * BX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
    __syncthreads();  // every thread has read acc before it is overwritten
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        sacc[(ty + i * BY) * LD + tx + j * BX] = c[i][j] * scale;
    __syncthreads();
  }

  for (int e = tid; e < H * H; e += kThreads) {
    go[e] = sacc[(e / H) * LD + e % H];
  }
}

template <int H, int TM, int TN>
cudaError_t launch(const float* x, float* out, long long n, int n_dots,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = 2 * H * (H + 1) * sizeof(float);
  // Above 48 KB a block may use dynamic shared memory only after this
  // opt-in; it is a cheap host call, so it is made before every launch.
  cudaError_t err = cudaFuncSetAttribute(
      bdot_kernel<H, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bdot_kernel<H, TM, TN><<<static_cast<unsigned>(n), kThreads, smem, stream>>>(
      x, out, n_dots, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frt_bdot_f32(const void* x, void* out, long long n, int h,
                            int n_dots, float scale, void* stream) {
  if (n < 0 || n > INT_MAX || n_dots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32:
      return static_cast<int>(launch<32, 2, 2>(px, po, n, n_dots, scale, s));
    case 64:
      return static_cast<int>(launch<64, 4, 4>(px, po, n, n_dots, scale, s));
    case 128:
      return static_cast<int>(launch<128, 8, 8>(px, po, n, n_dots, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
