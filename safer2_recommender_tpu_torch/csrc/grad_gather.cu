// One gradient step of a bucket of CVaR-MF's rows, gathered, summed and
// written back in one pass:
//
//     h[n]   = sum over l < length[n] of  s[n, l] (v_l . x[n] - 1) v_l
//     g[n]   = c0[n] x[n] + c1[n] xg[n] + h[n]           (xg = x @ G)
//     x[n]  <- x[n] - eta g[n]                            (in place)
//
//     v_l = other[col_ids[n, l]],  s[n, l] = rc[n] * vec[col_ids[n, l]]
//     w = weight[row] (or 1),  rc = w / max(length, 1) (or 1 without a
//     weight),  c1 = c1_scalar * w,  c0 = c0_vec[row] (or c0_scalar)
//
// for a bucket of N rows padded to `width` slots, float32 throughout:
// the subgradient step u <- u - eta (A u - rhs) of the reference's
// cvar_mf.h:88-134 (users: w the dual weight) and :282-295 (items: vec
// the normalized dual weight, c0 the item's ridge). x is the bucket's
// rows of `self`, read as `assemble.read_rows` reads them (a window of
// a contiguous bucket, else each row id clamped into the table), and a
// row is written back where `assemble.scatter_bucket` writes it (a
// window row with a history; a row whose id lies in the table). The
// epilogue rounds each product and sum as the torch expressions it
// replaces do (no FMA contraction), so it adds no rounding of its own to
// h's. `x @ G`, a plain large product, stays a torch.matmul.
//
// It replaces no TPU kernel: the JAX package leaves this product to XLA,
// which gathers the [N, L, d] slab and fuses the passes over it. The
// port's plain torch route writes that slab and about ten slab-sized
// temporaries of it (the mask, `rowwise_dot`'s product, the two weighted
// `row_sums`), so an MSD epoch at d = 512 spent ~1.2 s in passes of
// device memory over work the card does in ~7.5 ms; and with h alone in
// a kernel, the ~20 torch ops a bucket left around it held the device
// idle for the host.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): each real slot reads one 4 d byte row of `other` and does 4 d
// FLOPs (a dot and an axpy), 1/4 FLOP a byte gathered, so the gather's
// bytes bound it. At d = 512 an MSD side holds ~27.77M slots, 56.9 GB of
// gathered rows: ~17 ms at 3.35 TB/s where they come from device memory
// (the item step's 0.97 GB user table); the user step gathers from the
// 84 MB item table, much of it from L2. The compulsory bytes (each
// distinct row of `other`, x, xg and the new rows once) are far fewer,
// so a share of the roofline against them stays low.
//
// The design, to gather each real slot's row once and write nothing the
// size of the slab:
//   * A block of 8 warps takes one row n and a chunk of `chunk` slots of
//     it (blockIdx.x = n, blockIdx.y = the chunk). A warp takes the
//     chunk's slots l = l0 + warp + 8 i in order and loops only over
//     l < length[n]: padded slots have weight 0, so skipping them is the
//     same sum.
//   * A warp reads 32 slots' column ids with one load (lane k holds slot
//     k's id and its weight s), then walks them, broadcasting each id by
//     shuffle. Lane k owns the float4 columns k + 32 j (j < NV) of the
//     row: 16-byte loads, neighbouring lanes on neighbouring addresses.
//     The next slot's row is loaded before the current one is used
//     (register double-buffering), to hide the gather's latency.
//   * The dot v . x is each lane's FMAs over its columns, then a
//     butterfly of shuffles (every lane ends with the same bits: each
//     step adds the same two operands on both partners), so every lane
//     forms the same t = s (dot - 1) and adds t v into its NV float4
//     accumulators (16 registers a lane at d = 512).
//   * The 8 warps' accumulators meet in shared memory and are summed in
//     warp order. A row of one chunk finishes in its block: the epilogue
//     and the write-back. A longer row writes one partial h a chunk, and
//     a second kernel sums a row's partials in chunk order, in groups of
//     16 (a fixed tree, no atomics), and finishes the row. Every chunk is
//     the same size, so the zipf-head rows of hundreds of thousands of
//     slots are split into as many blocks as any other work of their
//     size, and do not set the tail.
//   * Any width d, any layout: where d is a multiple of 4 and every
//     table 16-byte aligned, a lane's columns are float4 loads and
//     stores; otherwise the same columns are read and written one float
//     at a time (zeros past d), with the same arithmetic. A row of more
//     than 1,024 columns (8 float4 a lane) is too wide for a warp's
//     registers: a first kernel forms each real slot's t = s (v . x - 1)
//     over the whole row (a warp a slot, the same butterfly) into `dots`
//     [N, width], and the main kernel then runs once for each 1,024-wide
//     tile of columns, reading t instead of forming it. That reads each
//     slot's row twice, once for the dot and once for the tiles.
// Each block reads its own row of `self` before it writes it, and no
// other block writes that row (a tile's block writes only its columns);
// the split rows are written by the second launch, after every partial
// has read x. Two calls on the same input give the same bits. Arithmetic
// is plain f32: no TF32, no tensor cores, no bf16.
//
// The C entry point launches on the caller's stream, allocates nothing
// (the caller passes `part`, [splits, N, d], when splits > 1, and `dots`,
// [N, width], when d > 1024) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take (d < 1,
// splits > 65535, N >= 2^31, N x width >= 2^34 slots past d = 1024, a
// missing buffer).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumGroup = 16;   // partials summed in groups of this many
constexpr int kMaxCols = 1024;  // columns a warp holds: 8 float4 a lane

struct StepArgs {
  // the four float tables start at this launch's first column; a row of
  // each is `ld` floats apart, and the launch takes `cols` of them
  const float* other;        // [R_other, ld], gathered
  const long long* col_ids;  // [N, width]
  const long long* length;   // [N]
  const long long* row_ids;  // [N]; pad rows hold self_rows
  float* self;               // [self_rows, ld]: x is read here, then written
  const float* xg;           // [N, ld]: x @ G
  const float* weight;       // [weight_len] by row id, or null (w = 1)
  const float* c0_vec;       // [c0_len] by row id, or null (c0 = c0)
  const float* vec;          // by column id, or null (1)
  float* part;               // [splits, N, ld] when splits > 1
  float* dots;               // [N, width]: each slot's t, when ld > kMaxCols
  long long n_rows, width, self_rows, row_start, weight_len, c0_len;
  float c0, c1, eta;
  int ld, cols, chunk, splits;
};

// A row's place in `self` and its scalars.
struct Row {
  long long x_row;   // the row of `self` that x is read from
  bool write;        // written back?
  float rc, c0, c1;
};

__device__ __forceinline__ Row row_of(const StepArgs& a, long long n,
                                      long long len) {
  const long long rid = a.row_ids[n];
  Row r;
  if (a.row_start >= 0) {   // a contiguous bucket's window
    r.x_row = a.row_start + n;
    r.write = len > 0;
  } else {
    r.x_row = min(rid, a.self_rows - 1);
    r.write = rid < a.self_rows;
  }
  float w = 1.f;
  r.rc = 1.f;
  if (a.weight != nullptr) {
    w = a.weight[min(rid, a.weight_len - 1)];
    r.rc = __fdiv_rn(w, static_cast<float>(max(len, 1LL)));
  }
  r.c0 = a.c0_vec == nullptr ? a.c0 : a.c0_vec[min(rid, a.c0_len - 1)];
  r.c1 = __fmul_rn(a.c1, w);
  return r;
}

// s = rc * vec[c], a slot's weight.
__device__ __forceinline__ float slot_weight(const StepArgs& a, const Row& r,
                                             long long c) {
  return a.vec == nullptr ? r.rc : r.rc * __ldg(a.vec + c);
}

// x - eta ((c0 x + c1 xg) + h), each step rounded as torch rounds it.
__device__ __forceinline__ float finish(const Row& r, float eta, float x,
                                        float xg, float h) {
  const float ax0 = __fadd_rn(__fmul_rn(r.c0, x), __fmul_rn(r.c1, xg));
  return __fsub_rn(x, __fmul_rn(eta, __fadd_rn(ax0, h)));
}

// Columns 4q .. 4q + 3 of a row (zeros at and past `cols`), through the
// read-only cache (kRO: `other`, which no launch writes) or not.
template <bool kVec, bool kRO>
__device__ __forceinline__ float4 load4(const float* row, int q, int cols) {
  if (kVec) {
    const float4* p = reinterpret_cast<const float4*>(row) + q;
    return kRO ? __ldg(p) : *p;
  }
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * q + k;
    e[k] = c < cols ? (kRO ? __ldg(row + c) : row[c]) : 0.f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int q, int cols,
                                       float4 v) {
  if (kVec) {
    reinterpret_cast<float4*>(row)[q] = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * q + k < cols) row[4 * q + k] = e[k];
}

template <int NV, bool kVec>
__device__ __forceinline__ void load_row(const StepArgs& a, long long c,
                                         int d4, int lane, float4 (&v)[NV]) {
  const float* row = a.other + c * a.ld;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = lane + 32 * j;
    v[j] = q < d4 ? load4<kVec, true>(row, q, a.cols)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// kTiled: the slots' t come from `dots` (d > kMaxCols), not formed here.
template <int NV, bool kVec, bool kTiled>
__global__ void __launch_bounds__(kThreads) grad_gather_kernel(StepArgs a) {
  __shared__ float4 red[kWarps][32 * NV];
  const long long n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d4 = (a.cols + 3) / 4;
  const long long len = a.length[n];
  const long long l0 = static_cast<long long>(blockIdx.y) * a.chunk;
  // a chunk past the row's end writes no partial: the sum reads none
  if (a.splits > 1 && l0 >= len) return;
  const long long l1 = min(len, l0 + a.chunk);
  const Row r = row_of(a, n, len);

  float* xrow = a.self + r.x_row * a.ld;
  float4 xr[NV], acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = lane + 32 * j;
    xr[j] = !kTiled && q < d4 ? load4<kVec, false>(xrow, q, a.cols)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long long* cols = a.col_ids + n * a.width;

  for (long long base = l0 + warp; base < l1; base += 32LL * kWarps) {
    // lane k holds the id and the weight (or t) of the warp's k-th slot
    const long long mine = base + static_cast<long long>(kWarps) * lane;
    long long my_c = 0;
    float my_s = 0.f;
    if (mine < l1) {
      my_c = cols[mine];
      my_s = kTiled ? a.dots[n * a.width + mine] : slot_weight(a, r, my_c);
    }
    const int cnt = static_cast<int>(
        min(32LL, (l1 - base + kWarps - 1) / kWarps));
    float4 v[NV];
    load_row<NV, kVec>(a, __shfl_sync(kFull, my_c, 0), d4, lane, v);
    for (int i = 0; i < cnt; ++i) {
      float4 nxt[NV];
      const long long c_next = __shfl_sync(kFull, my_c, (i + 1) & 31);
      if (i + 1 < cnt) {
        load_row<NV, kVec>(a, c_next, d4, lane, nxt);
      } else {
#pragma unroll
        for (int j = 0; j < NV; ++j) nxt[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float s = __shfl_sync(kFull, my_s, i);
      float t = s;
      if (!kTiled) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          p = fmaf(v[j].x, xr[j].x, p);
          p = fmaf(v[j].y, xr[j].y, p);
          p = fmaf(v[j].z, xr[j].z, p);
          p = fmaf(v[j].w, xr[j].w, p);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(kFull, p, off);
        t = s * (p - 1.f);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        acc[j].x = fmaf(t, v[j].x, acc[j].x);
        acc[j].y = fmaf(t, v[j].y, acc[j].y);
        acc[j].z = fmaf(t, v[j].z, acc[j].z);
        acc[j].w = fmaf(t, v[j].w, acc[j].w);
        v[j] = nxt[j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NV; ++j) red[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (a.splits == 1 && !r.write) return;
  const float* xgrow = a.xg + n * a.ld;
  float* prow = a.splits == 1 ? nullptr :
      a.part + (static_cast<long long>(blockIdx.y) * a.n_rows + n) * a.ld;
  for (int q = threadIdx.x; q < d4; q += kThreads) {
    float4 h = red[0][q];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      h.x += red[w][q].x;
      h.y += red[w][q].y;
      h.z += red[w][q].z;
      h.w += red[w][q].w;
    }
    if (a.splits > 1) {
      store4<kVec>(prow, q, a.cols, h);
      continue;
    }
    const float4 x = load4<kVec, false>(xrow, q, a.cols);
    const float4 xg = load4<kVec, false>(xgrow, q, a.cols);
    store4<kVec>(xrow, q, a.cols,
                 make_float4(finish(r, a.eta, x.x, xg.x, h.x),
                             finish(r, a.eta, x.y, xg.y, h.y),
                             finish(r, a.eta, x.z, xg.z, h.z),
                             finish(r, a.eta, x.w, xg.w, h.w)));
  }
}

// d > kMaxCols: each real slot's t = s (v . x - 1) over the whole row
// into dots[n, l], a warp a slot (lane-strided FMAs, then the butterfly).
__global__ void __launch_bounds__(kThreads) grad_gather_dot_kernel(
    StepArgs a) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= a.n_rows * a.width) return;
  const long long n = slot / a.width;
  const long long len = a.length[n];
  if (slot - n * a.width >= len) return;   // padded: never read
  const Row r = row_of(a, n, len);
  const long long c = a.col_ids[slot];
  const float* v = a.other + c * a.ld;
  const float* x = a.self + r.x_row * a.ld;
  float p = 0.f;
  for (int k = lane; k < a.ld; k += 32) p = fmaf(__ldg(v + k), x[k], p);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p += __shfl_xor_sync(kFull, p, off);
  if (lane == 0) a.dots[slot] = slot_weight(a, r, c) * (p - 1.f);
}

// A split row: h = its chunks' partials (those that hold slots) in
// chunk order, summed in groups of kSumGroup, then the epilogue and the
// write-back. One thread an entry, over all ld columns.
__global__ void grad_gather_sum_kernel(StepArgs a) {
  const int d = a.ld;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.n_rows * d) return;
  const long long n = idx / d;
  const long long c = idx - n * d;
  const long long len = a.length[n];
  const Row r = row_of(a, n, len);
  if (!r.write) return;
  const int used = static_cast<int>(
      min(static_cast<long long>(a.splits), (len + a.chunk - 1) / a.chunk));
  const long long stride = a.n_rows * d;
  float h = 0.f;
  for (int g = 0; g < used; g += kSumGroup) {
    float group = 0.f;
    const int end = min(used, g + kSumGroup);
    for (int k = g; k < end; ++k) group += a.part[k * stride + idx];
    h += group;
  }
  float* x = a.self + r.x_row * d + c;
  *x = finish(r, a.eta, *x, a.xg[idx], h);
}

template <int NV, bool kVec, bool kTiled>
cudaError_t launch_main(const StepArgs& a, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(a.n_rows), static_cast<unsigned>(a.splits));
  grad_gather_kernel<NV, kVec, kTiled><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch(const StepArgs& a, cudaStream_t stream) {
  cudaError_t err;
  if (a.ld <= kMaxCols) {
    const int d4 = (a.ld + 3) / 4;
    if (d4 <= 32)
      err = launch_main<1, kVec, false>(a, stream);
    else if (d4 <= 64)
      err = launch_main<2, kVec, false>(a, stream);
    else if (d4 <= 128)
      err = launch_main<4, kVec, false>(a, stream);
    else
      err = launch_main<8, kVec, false>(a, stream);
  } else {
    const long long slots = a.n_rows * a.width;
    grad_gather_dot_kernel<<<static_cast<unsigned>(
        (slots + kWarps - 1) / kWarps), kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    for (int c0 = 0; c0 < a.ld && err == cudaSuccess; c0 += kMaxCols) {
      StepArgs t = a;
      t.other += c0;
      t.self += c0;
      t.xg += c0;
      if (t.part != nullptr) t.part += c0;
      t.cols = a.ld - c0 < kMaxCols ? a.ld - c0 : kMaxCols;
      err = launch_main<8, kVec, true>(t, stream);
    }
  }
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long entries = a.n_rows * a.ld;
  const unsigned blocks = static_cast<unsigned>((entries + 255) / 256);
  grad_gather_sum_kernel<<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

bool misaligned(const void* p) {
  return p != nullptr && reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
}

}  // namespace

// other [R_other, d], col_ids [N, width] int64, length and row_ids [N]
// int64, self [self_rows, d] (x read, new rows written), xg [N, d],
// weight [weight_len] or null, c0_vec [c0_len] or null (each by row id,
// clamped as read_rows clamps), vec (by column id) or null, part
// [splits, N, d] (unused when splits == 1), dots [N, width] (unused when
// d <= 1024); all float32 but the ids, contiguous, on one device.
// row_start >= 0 marks a contiguous bucket whose window starts there.
// Slots [l0, l0 + chunk) of a row go to chunk l0 / chunk;
// splits = ceil(width / chunk).
extern "C" int frt_grad_gather_f32(
    const void* other, const void* col_ids, const void* length,
    const void* row_ids, void* self, const void* xg, const void* weight,
    const void* c0_vec, const void* vec, void* part, void* dots,
    long long n_rows, long long width, long long self_rows,
    long long row_start, long long weight_len, long long c0_len, float c0,
    float c1, float eta, int d, int chunk, int splits, void* stream) {
  if (n_rows <= 0) return 0;
  if (d <= 0 || chunk <= 0 || splits <= 0 || splits > 65535 ||
      n_rows > 0x7fffffffLL || self_rows <= 0 ||
      (splits > 1 && part == nullptr) ||
      (d > kMaxCols && (dots == nullptr ||
                         n_rows * width / kWarps >= 0x7fffffffLL)) ||
      (weight != nullptr && weight_len <= 0) ||
      (c0_vec != nullptr && c0_len <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
  a.other = static_cast<const float*>(other);
  a.col_ids = static_cast<const long long*>(col_ids);
  a.length = static_cast<const long long*>(length);
  a.row_ids = static_cast<const long long*>(row_ids);
  a.self = static_cast<float*>(self);
  a.xg = static_cast<const float*>(xg);
  a.weight = static_cast<const float*>(weight);
  a.c0_vec = static_cast<const float*>(c0_vec);
  a.vec = static_cast<const float*>(vec);
  a.part = static_cast<float*>(part);
  a.dots = static_cast<float*>(dots);
  a.n_rows = n_rows;
  a.width = width;
  a.self_rows = self_rows;
  a.row_start = row_start;
  a.weight_len = weight_len;
  a.c0_len = c0_len;
  a.c0 = c0;
  a.c1 = c1;
  a.eta = eta;
  a.ld = d;
  a.cols = d;
  a.chunk = chunk;
  a.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && !misaligned(other) && !misaligned(self) &&
                    !misaligned(xg) && !misaligned(part);
  return static_cast<int>(vec4 ? launch<true>(a, s) : launch<false>(a, s));
}
