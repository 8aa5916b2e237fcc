#!/usr/bin/env python3
"""Time the port's tensor-core kernels at their main-path shapes.

    PYTHONPATH=src python3 tools/time_tc_kernels.py

On one CUDA card: the flash-attention kernel (B 4 x H 32 folded, S 2048,
D 128, bf16, causal) on its wgmma and CUDA-core variants; the W8A16
kernel at M 8192, K 4096, N 11008 with bf16 and float32 x, beside
dequantize-to-bf16 + bf16 ``torch.matmul`` + scale; the W8A8 kernel at
the same shape on its wgmma and mma.sync variants, beside ``torch._int_mm``
plus the epilogue; and the SSD scan on one zamba2-1.2b Mamba2 layer (B 4
x 64 heads folded, S 2048, ph 64, ds 64, chunk 128) in bf16 and float32,
beside its plain version (no PyTorch call computes the scan). CUDA
events over ten launches (three for the plain versions) after two
warm-up launches; prints milliseconds per launch and, last, the card's
name and power limit. For the W8A8 and SSD wrappers, which run more
than one CUDA kernel per call, a profiled run of five calls prints each
kernel's device milliseconds per call. A quick check between full
``chip_smoke.py`` runs, which time the same kernels beside their bounds.
"""

import subprocess
import sys

import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.quant_matmul import kernel as QK
from repro_torch.kernels.ssm_scan import kernel as SK


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


def kernel_ms(fn, calls=5):
    """{CUDA kernel name: device ms per call} over a profiled run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key[:60]] = us / calls / 1e3
    return out


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
    a = torch.randint(-128, 128, (8192, 4096), generator=g, device=dev, dtype=torch.int8)
    a_scale = torch.tensor([0.03], device=dev)
    a_zp = torch.tensor([-5], dtype=torch.int32, device=dev)
    print("w8a8 wgmma", timed(lambda: QK.quant_matmul_kernel(a, w, a_scale, a_zp, ws)))
    print("  by kernel", kernel_ms(lambda: QK.quant_matmul_kernel(a, w, a_scale, a_zp, ws)))
    print("w8a8 mma", timed(lambda: QK.quant_matmul_kernel(a, w, a_scale, a_zp, ws,
                                                           variant="mma")))

    def int_mm_epilogue():
        acc = torch._int_mm(a, w)
        colsum = w.sum(0, dtype=torch.int32)
        return (acc.float() - a_zp.float() * colsum.float()) * a_scale * ws

    print("w8a8 yardstick", timed(int_mm_epilogue))
    sp = torch.nn.functional.softplus
    for dtype in (torch.bfloat16, torch.float32):
        xs = torch.randn((256, 2048, 64), generator=g, device=dev).to(dtype)
        bs, cs = ((torch.randn((4, 2048, 64), generator=g, device=dev) * 0.5).to(dtype)
                  for _ in range(2))
        dA = -sp(torch.randn((256, 2048), generator=g, device=dev))
        dt = sp(torch.randn((256, 2048), generator=g, device=dev))
        print(f"ssd {str(dtype)[6:]}", timed(lambda: SK.ssm_scan_kernel(xs, bs, cs, dA, dt)))
        print("  by kernel", kernel_ms(lambda: SK.ssm_scan_kernel(xs, bs, cs, dA, dt)))
        print(f"ssd {str(dtype)[6:]} plain",
              timed(lambda: SK.ssm_scan_plain(xs, bs, cs, dA, dt), 3))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
