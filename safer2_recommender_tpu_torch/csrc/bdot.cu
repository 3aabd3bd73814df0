// Batched power of small square matrices on the tensor cores:
//
//     out[n] = x[n]^m * scale^(m - 1),   m = n_dots + 1,
//
// for x [N, h, h] float32, batch-major, h in {32, 64, 128}: the value of
// the chain  acc = x; repeat n_dots times: acc = (acc @ x) * scale.
//
// Replaces scripts/probe_bdot.py:27 (pallas_bdot), a timing probe of the
// batched [N, 32..128, same] products that the blocked Cholesky
// factorization issues when d > 64 (ops/block_chol.py::_factor_rec /
// _trsm_right). The TPU kernel ran the chain, one dot per step, over
// blocks of matrices sized to fill VMEM; that blocking is a TPU choice
// and is not carried over.
//
// What bounds it on an H100 SXM at 700 W, at N = 4096 and 8 dots: the 4
// products of x^9 (probes/bdot.py::bound: x read once and out written
// once at 3.35 TB/s; the products at 495 TFLOP/s dense TF32, over the
// number of TF32 passes):
//
//     h     HIGHEST (3 TF32 passes)      DEFAULT (1 TF32 pass)
//     128   0.4165 ms by operations      0.1603 ms by bytes
//      64   0.0521 ms by operations      0.0401 ms by bytes
//      32   0.0100 ms by bytes           0.0100 ms by bytes
//
// What the design does about it:
//  * Repeated squaring: the products follow the bits of m from the top,
//    a square for each bit below it and a product with x for each set
//    one (4 at m = 9, where the chain runs 8). Each product is scaled
//    once: y_a y_b s = x^(a+b) s^(a+b-1), the chain's value in exact
//    arithmetic.
//  * Tensor cores through mma.sync m16n8k8 tf32, f32 accumulators. PASSES
//    = 3 (HIGHEST, 3xTF32) splits each operand into big = rna(a) and
//    small = rna(a - big) and accumulates small*big and big*small, then
//    big*big; small*small (about 2^-22 of a product) is dropped. PASSES =
//    1 (DEFAULT) is the big*big pass alone, the nearest analog on this
//    card of the TPU's single bf16 pass. The split is made in registers
//    as each fragment is loaded, with integer adds and ands on the bits:
//    cvt.rna.tf32.f32 gives the same values, but the kernel built with it
//    takes 15% longer at h = 128 (1.33 against 1.16 ms). Measured on an
//    H100 SXM at 700 W by probes/bdot_design.py, as are the numbers below.
//  * The tensor cores' f32 sums cut toward zero, an error that grows with
//    the depth: summed straight into the accumulators, the three passes
//    left 1.1e-5 of max|float64| at h = 128 and 13 dots, ten times f32's.
//    Each k-step's passes therefore sum from zero and join the
//    accumulators in a rounded f32 add: 9e-7, f32's level, for 10% more
//    time (1.16 against 1.06 ms).
//  * What bounds the route: mma.sync tf32 issues at 320 TFLOP/s with its
//    operands in registers (65% of the dense rate), so three passes at
//    h = 128 cannot beat 0.64 ms. Of the distance to 1.16 ms the split
//    is 0.19 ms (0.97 ms with operands fed unsplit) and the rounded adds
//    0.10 ms; loads from shared memory cost nothing measurable. wgmma
//    would reach the dense rate but was not taken: its tf32 B operand
//    comes from shared memory, K-major, in its own swizzled layout; the
//    product is then best formed transposed (C^T = R^T L^T, R^T from
//    registers), which needs L's big and small halves as two more h x h
//    buffers (no room for the next x at h = 128), and R's register loads
//    avoid bank conflicts in that layout only with the columns stored
//    interleaved across 16-byte groups, which 16-byte copies of x
//    cannot produce.
//  * A fragments come by ldmatrix (four 8 x 4 word blocks in one
//    instruction), B fragments as single words; the next k-step's
//    fragments are loaded while the current one multiplies.
//  * Operands stay in shared memory: x, y and the next x, 3 h^2 floats
//    (192 KB at h = 128). A product's tile stays in the warps' registers
//    until a barrier, then is written back into y, scaled.
//  * A swizzle, no padding: element (r, c) lives at r h + (c ^ s(r)),
//    s(r) = (r & 3) << 3 | (r & 4). Each phase of an A ldmatrix reads 4
//    words at column k0 (+4) of 8 rows r0 + g (g < 8): banks
//    (k0 ^ s(g)) + 0..3, all 32 apart; a B fragment reads rows k0 + t
//    (t < 4) at columns n0 + g: banks n0 ^ g ^ (t << 3), all 32 apart. A
//    pad of 4 words would serve A and not B, one of 8 B and not A. s(r)
//    moves whole groups of 4 words, so 16-byte copies and the float2
//    stores of a tile stay aligned and free of conflicts.
//  * A persistent grid of one wave (SMs x blocks resident on one). A
//    block holds UNITS units of one matrix each: 1 of 8 warps at h = 128,
//    4 of 2 warps at h = 64, 8 of 1 warp at h = 32. A unit walks the
//    batch, its matrix index advancing by the number of units, and loads
//    its next matrix with 16-byte cp.async into its second x buffer while
//    it multiplies the current one. A unit synchronises alone (bar.sync
//    on its own barrier, or __syncwarp), so a ragged tail holds no one.
//  * Global loads and stores move 16 bytes per thread, a unit's threads
//    on consecutive addresses.
//  * The opt-in to more than 48 KB of shared memory and the occupancy
//    query run once per instantiation and device, not at every launch.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() (or cudaErrorMisalignedAddress if x or
// out does not start on 16 bytes) so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;

// Warp tile (WM x WN) and matrices per block (UNITS) at each h.
template <int H>
struct Tile;
template <>
struct Tile<32> {
  static constexpr int WM = 32, WN = 32, UNITS = 8;
};
template <>
struct Tile<64> {
  static constexpr int WM = 64, WN = 32, UNITS = 4;
};
template <>
struct Tile<128> {
  static constexpr int WM = 64, WN = 32, UNITS = 1;
};

template <int H>
struct Geometry {
  static constexpr int kWarpsN = H / Tile<H>::WN;
  static constexpr int kUnitThreads = 32 * (H / Tile<H>::WM) * kWarpsN;
  static constexpr int kThreads = kUnitThreads * Tile<H>::UNITS;
  static constexpr int kMat = H * H;  // floats per matrix
  static constexpr int kSmem =
      3 * kMat * Tile<H>::UNITS * static_cast<int>(sizeof(float));
  static_assert(kSmem <= 232448, "a block's buffers exceed shared memory");
};

// Column swizzle of row r (see the note above).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

// The bits of a rounded to TF32 as cvt.rna.tf32.f32 rounds them: to
// nearest, ties away from zero, the low 13 bits clear. Integer add and
// and, not cvt: see the note on the split below.
__device__ __forceinline__ uint32_t tf32_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// d += a b over one 16 x 8 x 8 tile. With g = lane / 4, t = lane % 4:
// a holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds (t, g),
// (t + 4, g); d holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big = rna(v), a TF32 value, so v - big is exact; small = v - big plus
// half a TF32 ulp, which the tensor cores' cut to the top 19 bits turns
// into rna(v - big) (3 passes only).
template <int PASSES>
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_bits(v);
  if constexpr (PASSES == 3) {
    small = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
  }
}

// The barrier of one unit: its own named barrier, or the warp's.
template <int THREADS>
__device__ __forceinline__ void unit_sync(int id) {
  if constexpr (THREADS == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
  }
}

// Copy one matrix from global memory into a swizzled buffer, 16 bytes a
// thread, without waiting.
template <int H>
__device__ __forceinline__ void load_async(float* dst, const float* src,
                                           int ut) {
  constexpr int kVec = H / 4, kStep = Geometry<H>::kUnitThreads;
#pragma unroll
  for (int i = 0; i < H * kVec / kStep; ++i) {
    const int v = ut + i * kStep;
    const int r = v / kVec, c = (v % kVec) * 4;
    const uint32_t s = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + r * H + (c ^ swz(r))));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src + 4 * v)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until all but the most recent group of this thread's copies landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Write a swizzled buffer out as one row-major matrix, 16 bytes a thread.
template <int H>
__device__ __forceinline__ void store(const float* src, float* dst, int ut) {
  constexpr int kVec = H / 4, kStep = Geometry<H>::kUnitThreads;
#pragma unroll
  for (int i = 0; i < H * kVec / kStep; ++i) {
    const int v = ut + i * kStep;
    const int r = v / kVec, c = (v % kVec) * 4;
    reinterpret_cast<float4*>(dst)[v] =
        *reinterpret_cast<const float4*>(src + r * H + (c ^ swz(r)));
  }
}

// The A fragments of one m16n8k8 tile, rows row..row + 15 at columns
// k0..k0 + 7, in one instruction: lane l gives the address of row
// row + (l & 7) + 8 ((l >> 3) & 1) at column k0 + 4 (l >> 4), four
// words that the swizzle keeps together; as 32-bit words, matrix q of
// the four lands in d[q] at (l / 4, l % 4), the m16n8k8 layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const float* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(s)
      : "memory");
}

// The raw (f32) fragments of k-step k0: A by ldmatrix from pa (this
// lane's row), B as single words from pb (row t) at columns colb[j].
template <int H, int MT, int NT>
__device__ __forceinline__ void load_fragments(
    const float* pa, int ua, const float* pb, const int (&colb)[NT], int k0,
    uint32_t (&ra)[MT][4], float (&rb)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) ldmatrix_x4(ra[i], pa + 16 * i * H + (k0 ^ ua));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    rb[j][0] = pb[k0 * H + colb[j]];
    rb[j][1] = pb[(k0 + 4) * H + (colb[j] ^ 4)];
  }
}

// smem[dst] = (smem[a] @ smem[b]) * scale for one unit; a, b and dst are
// word offsets of swizzled H x H buffers, and dst may be a or b.
template <int H, int PASSES>
__device__ __forceinline__ void product(float* smem, int a, int b, int dst,
                                        float scale, int ut, int bar) {
  using G = Geometry<H>;
  constexpr int WM = Tile<H>::WM, WN = Tile<H>::WN;
  constexpr int MT = WM / 16, NT = WN / 8;
  const int warp = ut >> 5, lane = ut & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / G::kWarpsN) * WM;
  const int col0 = (warp % G::kWarpsN) * WN;
  // A: this lane's ldmatrix row; column k0 + 4 (lane >> 4) of it is
  // k0 ^ ua. B: column n0 + g of row k0 + t is n0 ^ g ^ (t << 3), as
  // s(k0 + t) = t << 3; row k0 + t + 4 flips bit 2 as well.
  const int lr = lane & 7;
  const float* pa = smem + a + (row0 + lr + 8 * ((lane >> 3) & 1)) * H;
  const int ua = (4 * (lane >> 4)) ^ swz(lr);
  const float* pb = smem + b + t * H;
  int colb[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) colb[j] = (col0 + 8 * j) ^ g ^ (t << 3);

  float c[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  uint32_t ra[MT][4];
  float rb[NT][2];
  load_fragments<H>(pa, ua, pb, colb, 0, ra, rb);
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 8) {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split<PASSES>(__uint_as_float(ra[i][e]), ab[i][e], as[i][e]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) split<PASSES>(rb[j][e], bb[j][e], bs[j][e]);
    // the next k-step's loads fly while this one multiplies (past the
    // last step, a harmless reload of the first)
    load_fragments<H>(pa, ua, pb, colb, (k0 + 8) & (H - 1), ra, rb);
    if constexpr (PASSES == 3) {
      // The tensor cores' f32 sums cut toward zero, an error that grows
      // with the depth and does not average out; each k-step's three
      // passes therefore sum from zero and join c in a rounded add.
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float d[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], as[i], bb[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ab[i], bs[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(d[j], ab[i], bb[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][j][e] += d[j][e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(c[i][j], ab[i], bb[j]);
    }
  }

  unit_sync<G::kUnitThreads>(bar);  // every warp has read a and b
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = dst + (row0 + 16 * i + g) * H;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (col0 + 8 * j + 2 * t) ^ swz(g);
      *reinterpret_cast<float2*>(smem + r + col) =
          make_float2(c[i][j][0] * scale, c[i][j][1] * scale);
      *reinterpret_cast<float2*>(smem + r + 8 * H + col) =
          make_float2(c[i][j][2] * scale, c[i][j][3] * scale);
    }
  }
  unit_sync<G::kUnitThreads>(bar);  // the product is whole before it is read
}

template <int H, int PASSES>
__global__ void __launch_bounds__(Geometry<H>::kThreads,
                                  Tile<H>::UNITS == 8 ? 2 : 1)
    bdot_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long n, unsigned long long m, float scale) {
  using G = Geometry<H>;
  constexpr int kUnits = Tile<H>::UNITS;
  extern __shared__ __align__(16) float smem[];
  const int unit = threadIdx.x / G::kUnitThreads;
  const int ut = threadIdx.x % G::kUnitThreads;
  const int bar = unit + 1;  // barrier 0 is __syncthreads'
  const long long units = static_cast<long long>(gridDim.x) * kUnits;
  long long mat = static_cast<long long>(blockIdx.x) * kUnits + unit;
  if (mat >= n) return;
  // this unit's buffers: x at base and base + kMat (alternating), y after
  const int base = 3 * G::kMat * unit;
  const int sy = base + 2 * G::kMat;
  const int top = 63 - __clzll(static_cast<long long>(m));

  load_async<H>(smem + base, x + mat * G::kMat, ut);
  cp_async_commit();
  for (int cur = 0; mat < n; mat += units, cur ^= 1) {
    if (mat + units < n) {
      load_async<H>(smem + base + (cur ^ 1) * G::kMat,
                    x + (mat + units) * G::kMat, ut);
    }
    cp_async_commit();  // an empty group at the tail keeps the count
    cp_async_wait_prior();
    unit_sync<G::kUnitThreads>(bar);
    const int sx = base + cur * G::kMat;
    int y = sx;
    // bit b of m: square y, then, if the bit is set, multiply y by x
    for (int b = top - 1, mul = 0; b >= 0;) {
      product<H, PASSES>(smem, y, mul ? sx : y, sy, scale, ut, bar);
      y = sy;
      if (!mul && ((m >> b) & 1)) {
        mul = 1;
      } else {
        mul = 0;
        --b;
      }
    }
    store<H>(smem + y, out + mat * G::kMat, ut);
    unit_sync<G::kUnitThreads>(bar);  // read out before the buffers refill
  }
}

template <int H, int PASSES>
cudaError_t launch(const float* x, float* out, long long n,
                   unsigned long long m, float scale, cudaStream_t stream) {
  using G = Geometry<H>;
  constexpr int kUnits = Tile<H>::UNITS;
  // One wave of blocks on each device, found at the first launch there.
  static std::atomic<int> wave[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = dev < kMaxDevices ? wave[dev].load(std::memory_order_relaxed)
                                 : 0;
  if (blocks == 0) {
    err = cudaFuncSetAttribute(bdot_kernel<H, PASSES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bdot_kernel<H, PASSES>, G::kThreads, G::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    if (dev < kMaxDevices) wave[dev].store(blocks, std::memory_order_relaxed);
  }
  const long long need = (n + kUnits - 1) / kUnits;
  if (need < blocks) blocks = static_cast<int>(need);
  bdot_kernel<H, PASSES><<<blocks, G::kThreads, G::kSmem, stream>>>(
      x, out, n, m, scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_h(const float* x, float* out, long long n,
                     unsigned long long m, float scale, int passes,
                     cudaStream_t stream) {
  return passes == 3 ? launch<H, 3>(x, out, n, m, scale, stream)
                     : launch<H, 1>(x, out, n, m, scale, stream);
}

}  // namespace

// out = x^(n_dots + 1) * scale^n_dots for n matrices of size h; passes is
// 3 (HIGHEST, 3xTF32) or 1 (DEFAULT, one TF32 pass).
extern "C" int frt_bdot_f32(const void* x, void* out, long long n, int h,
                            int n_dots, float scale, int passes,
                            void* stream) {
  if (n < 0 || n_dots < 0 || (passes != 1 && passes != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
      16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  const unsigned long long m = static_cast<unsigned long long>(n_dots) + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 32:
      return static_cast<int>(launch_h<32>(px, po, n, m, scale, passes, s));
    case 64:
      return static_cast<int>(launch_h<64>(px, po, n, m, scale, passes, s));
    case 128:
      return static_cast<int>(launch_h<128>(px, po, n, m, scale, passes, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Matrices one block holds at size h (0 for a size the kernel does not
// take).
extern "C" int frt_bdot_matrices_per_block(int h) {
  switch (h) {
    case 32:
      return Tile<32>::UNITS;
    case 64:
      return Tile<64>::UNITS;
    case 128:
      return Tile<128>::UNITS;
    default:
      return 0;
  }
}
