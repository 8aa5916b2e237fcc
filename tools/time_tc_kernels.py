#!/usr/bin/env python3
"""Time the port's two tensor-core kernels at their serving shapes.

    PYTHONPATH=src python3 tools/time_tc_kernels.py

On one CUDA card: the flash-attention kernel (B 4 x H 32 folded, S 2048,
D 128, bf16, causal) on its wgmma and CUDA-core variants, and the W8A16
kernel at M 8192, K 4096, N 11008 with bf16 and float32 x, beside
dequantize-to-bf16 + bf16 ``torch.matmul`` + scale. CUDA events over ten
launches after two warm-up launches; prints milliseconds per launch. A
quick check between full ``chip_smoke.py`` runs, which time the same
kernels beside their bounds.
"""

import sys

import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.quant_matmul import kernel as QK


def timed(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("time_tc_kernels: no CUDA card", file=sys.stderr)
        return 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((128, 2048, 128), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    pos = torch.arange(2048, dtype=torch.int32, device=dev)
    print("flash wgmma", timed(lambda: FA.flash_attention_kernel(q, k, v, pos, pos,
                                                                 scale=128 ** -0.5)))
    print("flash simt", timed(lambda: FA.flash_attention_kernel(
        q, k, v, pos, pos, scale=128 ** -0.5, variant="simt"), 3))
    x = torch.randn((8192, 4096), generator=g, device=dev)
    w = torch.randint(-128, 128, (4096, 11008), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((11008,), generator=g, device=dev) * 0.01
    xb = x.bfloat16()
    print("w8a16 bf16", timed(lambda: QK.w8a16_matmul_kernel(xb, w, ws)))
    print("w8a16 f32", timed(lambda: QK.w8a16_matmul_kernel(x, w, ws)))
    print("bf16 yardstick", timed(lambda: (xb @ w.to(torch.bfloat16)).float() * ws))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
