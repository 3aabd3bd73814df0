"""What the ``bdot`` kernel's design choices cost on the GPU.

    python -m safer2_recommender_tpu_torch.probes.bdot_design

Builds variants of ``csrc/bdot.cu``, each made by replacing one piece of
its text and built under a name of its own:
- ``kernel``: the source as it is;
- ``cvt_split``: the TF32 split by ``cvt.rna.tf32.f32`` instead of
  integer ops on the bits (the same values);
- ``direct_sum``: the three 3xTF32 passes summed straight into the
  accumulators instead of from zero at each k-step;
- ``no_split``: operands fed to the tensor cores unsplit (timing only:
  the values are wrong);
- ``no_loads``: fragments made in registers, no shared-memory loads in
  the k loop (timing only).
It holds the variants that compute the function against the plain
version at [4096, h, h] and 8 dots, and at "highest" against the float64
chain at 8 and 13 dots; at "default" it also holds a second plain
version (the same rounded operands multiplied in float64) against the
first, the spread that any kernel of TF32 operands shows against either.
Then it times every variant in turns from CUDA graphs at each h and
precision. Last, the issue rate of ``mma.sync`` m16n8k8 tf32 with its
operands in registers (16 independent accumulators a warp; 4, 8 and 16
warps on every SM): the ceiling of the kernel's route. A machine
without CUDA is an error.
"""

from __future__ import annotations

import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import torch

from safer2_recommender_tpu_torch import native, probes
from safer2_recommender_tpu_torch.ops import bdot as bdot_op

N = 4096
N_DOTS = 8
SCALE = 1e-2
F64_DOTS = (8, 13)
TIMING_ONLY = ("no_split", "no_loads")
_DIR = os.path.join(native.BUILD_DIR, "bdot_design")

_SPLIT = """  big = tf32_bits(v);
  if constexpr (PASSES == 3) {
    small = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
  }
"""
_ZERO_D = """        float d[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
"""
_ADD_D = """#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][j][e] += d[j][e];
"""
_LOADS = """  for (int i = 0; i < MT; ++i) ldmatrix_x4(ra[i], pa + 16 * i * H + (k0 ^ ua));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    rb[j][0] = pb[k0 * H + colb[j]];
    rb[j][1] = pb[(k0 + 4) * H + (colb[j] ^ 4)];
  }
"""

# variant: [(text of bdot.cu, its replacement), ...]
SUBSTITUTIONS: Dict[str, List[Tuple[str, str]]] = {
    "cvt_split": [(_SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  big &= 0xffffe000u;
  if constexpr (PASSES == 3) {
    const float rest = v - __uint_as_float(big);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
  }
""")],
    "direct_sum": [(_ZERO_D, "        float (&d)[NT][4] = c[i];\n"),
                   (_ADD_D, "")],
    "no_split": [(_SPLIT, """  big = __float_as_uint(v);
  if constexpr (PASSES == 3) small = big;
""")],
    "no_loads": [(_LOADS, """  for (int i = 0; i < MT; ++i)
    for (int e = 0; e < 4; ++e)
      ra[i][e] = __float_as_uint(pa[ua] + float(k0 + i + e));
  for (int j = 0; j < NT; ++j) {
    rb[j][0] = pb[colb[j]] + float(k0 + j);
    rb[j][1] = pb[colb[j]] - float(k0 + j);
  }
""")],
}

MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void mma_rate(float* out, int iters) {
  float c[16][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x + 1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int frt_mma_rate(void* out, int blocks, int threads, int iters,
                            void* stream) {
  mma_rate<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def variants(src: str) -> Dict[str, str]:
    """{name: source} of every variant of ``src`` (bdot.cu's text)."""
    out = {"kernel": src}
    for name, subs in SUBSTITUTIONS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: the text it replaces is not in "
                                 "bdot.cu exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(name: str, text: str) -> ctypes.CDLL:
    os.makedirs(_DIR, exist_ok=True)
    path = os.path.join(_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    flags = [native.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    return ctypes.CDLL(native.build_shared(f"bdot_design_{name}", [path],
                                           flags))


def _launcher(lib: ctypes.CDLL):
    lib.frt_bdot_f32.restype = ctypes.c_int
    lib.frt_bdot_f32.argtypes = bdot_op.build_kernel().frt_bdot_f32.argtypes

    def call(x: torch.Tensor, n_dots: int, precision: str) -> torch.Tensor:
        out = torch.empty_like(x)
        err = lib.frt_bdot_f32(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], n_dots,
            SCALE, bdot_op.PASSES[precision],
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant launch failed: cudaError {err}")
        return out
    return call


def plain_f64(x: torch.Tensor, n_dots: int, precision: str) -> torch.Tensor:
    """``bdot_ref`` with each product in float64 on the same operands
    (rounded to f32, and to TF32 at "default", before each product)."""
    rnd = (bdot_op.round_tf32 if bdot_op.PASSES[precision] == 1
           else (lambda t: t))
    m = n_dots + 1
    y = x
    for bit in range(m.bit_length() - 2, -1, -1):
        y = (torch.bmm(rnd(y).double(), rnd(y).double()) * SCALE).float()
        if m >> bit & 1:
            y = (torch.bmm(rnd(y).double(), rnd(x).double()) * SCALE).float()
    return y


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def mma_rate(device) -> Dict[int, float]:
    """{warps per SM: TFLOP/s} of mma.sync m16n8k8 tf32 from registers."""
    lib = _build("mma_rate", MMA_RATE_SRC)
    lib.frt_mma_rate.restype = ctypes.c_int
    lib.frt_mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    iters, rates = 4096, {}
    for warps in (4, 8, 16):
        out = torch.empty(sms * warps * 32, device=device)
        ms = probes.cuda_ms(lambda: lib.frt_mma_rate(
            out.data_ptr(), sms, warps * 32, iters,
            torch.cuda.current_stream().cuda_stream), iters=10)
        flop = 2.0 * 16 * 8 * 8 * 16 * iters * warps * sms
        rates[warps] = flop / (ms * 1e-3) / 1e12
    return rates


def run(device="cuda") -> dict:
    """Build, check and time the variants, then the mma.sync rate."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe measures the GPU; give a CUDA device")
    with open(bdot_op._SRC) as f:
        texts = variants(f.read())
    with ThreadPoolExecutor(len(texts)) as ex:
        libs = dict(zip(texts, ex.map(lambda kv: _build(*kv), texts.items())))
    calls = {name: _launcher(lib) for name, lib in libs.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for h in bdot_op.SIZES:
        x = torch.randn((N, h, h), generator=gen, device=device) * 0.1
        xd = x.double()
        chain = {0: xd}
        for d in range(1, max(F64_DOTS) + 1):
            chain[d] = torch.bmm(chain[d - 1], xd) * SCALE
        for precision in bdot_op.PASSES:
            want = bdot_op.bdot_ref(x, N_DOTS, SCALE, precision)
            row = {"h": h, "precision": precision, "errors": {}}
            for name, call in calls.items():
                if name in TIMING_ONLY:
                    continue
                err = {"plain": _rel(call(x, N_DOTS, precision), want)}
                if precision == "highest":
                    for d in F64_DOTS:
                        err[f"float64_{d}_dots"] = _rel(call(x, d, precision),
                                                        chain[d])
                row["errors"][name] = err
            if precision == "default":
                row["errors"]["plain_f64"] = {
                    "plain": _rel(plain_f64(x, N_DOTS, precision), want)}
            fns = {name: (lambda call=call: call(x, N_DOTS, precision))
                   for name, call in calls.items()}
            row["graph_ms"] = probes.in_turns(fns, probes.graph_ms)
            rows.append(row)
            print(f"[probe bdot_design] h={h} {precision}: graph ms "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row["graph_ms"].items())
                  + "; errors " + ", ".join(
                      f"{k} " + "/".join(f"{e:.2e}" for e in v.values())
                      for k, v in row["errors"].items()), flush=True)
        del x, xd, chain
    rates = mma_rate(device)
    print("[probe bdot_design] mma.sync m16n8k8 tf32 from registers: "
          + ", ".join(f"{w} warps/SM {r:.1f} TFLOP/s"
                      for w, r in rates.items()), flush=True)
    return {"rows": rows, "mma_rate": rates}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
