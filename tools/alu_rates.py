#!/usr/bin/env python3
"""Instruction rates of one CUDA card for the fused DP kernel's arithmetic.

    PYTHONPATH=src python3 tools/alu_rates.py

Builds a small probe (nvcc, sm_90a, into the port's build directory) in
which every thread runs 8 independent chains of one operation: float add
(FADD), float min (FMNMX), compare-and-select (FSETP + FSEL), integer
min, and a bit test with an integer select (LOP3 + ISETP + SEL). 8 blocks
of 256 threads an SM; each SM records, with ``clock64``, the cycles from
its first block's start to its last block's end and counts the blocks it
ran, so the rate holds however many blocks were resident at once. Prints, for each probe, the instructions it
compiled to (from ``cuobjdump``) and the operations per SM per clock,
then the card's name and power limit. The tiled fused DP kernel's group
loop is 4 adds, 3 mins, a compare and two selects per 4 candidates; these
rates say what that mix can issue at.
"""

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = r"""
#include <cuda_runtime.h>
#define RING(OP) \
  _Pragma("unroll 4") for (int it = 0; it < iters; ++it) { \
    OP(0, 1) OP(1, 2) OP(2, 3) OP(3, 4) OP(4, 5) OP(5, 6) OP(6, 7) OP(7, 0) }
#define FADD_OP(i, j) a##i = a##i + a##j;
#define FMIN_OP(i, j) a##i = fminf(a##i, a##j);
#define FSEL_OP(i, j) a##i = (a##j < a##i) ? a##j : a##i;
#define IMIN_OP(i, j) q##i = min(q##i, q##j);
#define SEL_OP(i, j) q##i = (q##i & 1) ? q##j : q##i;
#define HEAD \
  __syncthreads(); const long long t0 = clock64(); \
  float a0 = x[threadIdx.x], a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, \
        a4 = a0 + 4, a5 = a0 + 5, a6 = a0 + 6, a7 = a0 + 7; \
  int q0 = threadIdx.x * (int)x[0], q1 = q0 ^ 3, q2 = q0 ^ 5, q3 = q0 ^ 7, \
      q4 = q0 ^ 9, q5 = q0 ^ 11, q6 = q0 ^ 13, q7 = q0 ^ 15;
#define TAIL \
  out[blockIdx.x * blockDim.x + threadIdx.x] = \
      a0 + a1 + a2 + a3 + a4 + a5 + a6 + a7 + q0 + q1 + q2 + q3 + q4 + q5 + q6 + q7; \
  __syncthreads(); \
  if (threadIdx.x == 0) { \
    unsigned sm; \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); \
    atomicMin(&sm_first[sm], (unsigned long long)t0); \
    atomicMax(&sm_last[sm], (unsigned long long)clock64()); \
    atomicAdd(&sm_blocks[sm], 1u); \
  }
#define PROBE(name, OP) \
  __global__ void name(const float* x, float* out, unsigned long long* sm_first, \
                       unsigned long long* sm_last, unsigned* sm_blocks, int iters) { \
    HEAD RING(OP) TAIL }
PROBE(probe_fadd, FADD_OP)
PROBE(probe_fmnmx, FMIN_OP)
PROBE(probe_fsel, FSEL_OP)
PROBE(probe_imin, IMIN_OP)
PROBE(probe_sel, SEL_OP)
extern "C" int alu_probe(int which, const void* x, void* out, void* sm_first,
                         void* sm_last, void* sm_blocks, int blocks, int threads, int iters,
                         void* stream) {
  void (*probes[])(const float*, float*, unsigned long long*, unsigned long long*,
                   unsigned*, int) = {probe_fadd, probe_fmnmx, probe_fsel, probe_imin,
                                      probe_sel};
  probes[which]<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<unsigned long long*>(sm_first), static_cast<unsigned long long*>(sm_last),
      static_cast<unsigned*>(sm_blocks), iters);
  return cudaGetLastError();
}
"""

PROBES = ["float add", "float min", "compare + select", "integer min", "bit test + select"]


def main() -> int:
    if not torch.cuda.is_available():
        print("alu_rates: no CUDA card", file=sys.stderr)
        return 1
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "alu_rates.cu", out_dir / "libalu_rates.so"
    src.write_text(SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    mix = {}
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = re.search(r"probe_(\w+?)P", block.split("\n", 1)[0])
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?P\w+\s+)?([A-Z][A-Z0-9_.]+)", block))
        if name:
            mix[name.group(1)] = ", ".join(f"{op} x{n}" for op, n in ops.most_common(3))
    lib = ctypes.CDLL(str(lib_path))
    lib.alu_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.alu_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 20000
    x = torch.rand(1024, device="cuda")
    out = torch.empty(blocks * threads, device="cuda")
    first = torch.empty(sms, dtype=torch.int64, device="cuda")
    last = torch.empty(sms, dtype=torch.int64, device="cuda")
    ran = torch.empty(sms, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for which, label in enumerate(PROBES):
        for n in (10, iters):  # a warm-up launch, then the measured one
            first.fill_(-1)  # all ones: the largest unsigned value, for atomicMin
            last.zero_()
            ran.zero_()
            code = lib.alu_probe(which, x.data_ptr(), out.data_ptr(), first.data_ptr(),
                                 last.data_ptr(), ran.data_ptr(), blocks, threads, n, stream)
            if code != 0:
                raise RuntimeError(f"alu_probe {label}: launch failed ({code})")
        torch.cuda.synchronize()
        used = ran > 0
        ops = ran[used].double() * threads * iters * 8  # 8 chains a thread
        rate = float((ops / (last[used] - first[used]).double()).median())
        key = ["fadd", "fmnmx", "fsel", "imin", "sel"][which]
        print(f"{label}: {rate:.1f} operations per SM per clock ({mix.get(key, '?')})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
