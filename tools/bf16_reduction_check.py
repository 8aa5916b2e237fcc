#!/usr/bin/env python3
"""Do bf16 products on the card round once from float32 accumulation?

    PYTHONPATH=src python3 tools/bf16_reduction_check.py

``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(on by default) lets cuBLAS reduce split-K partial sums in bf16. The LM
path's bf16 projections assume one rounding of a float32 sum, as the
reference's ``preferred_element_type=float32`` products do. On one CUDA
card this runs ``torch.matmul`` in bf16 with the flag on and off at
deepseek-7b's up-projection (8,192 x 4,096 -> 11,008: a prefill step of
4 x 2,048 tokens) and at decode rows (2 and 4 x 4,096 -> 11,008, and 2 x
4,096 -> 4,096, where cuBLAS is likelier to split K), and holds each
against ``(x.float() @ w.float()).to(bfloat16)`` (IEEE float32, TF32
off) and against the float64 product rounded once to bf16. Prints, per
shape and flag, the elements that differ and the largest difference in
bf16 ulps; then whether the two flags gave bit-equal results; last, the
card's name and power limit.
"""

import subprocess
import sys

import torch

SHAPES = (("up-projection, prefill 4 x 2048", 8192, 4096, 11008),
          ("up-projection, decode 4 rows", 4, 4096, 11008),
          ("up-projection, decode 2 rows", 2, 4096, 11008),
          ("attention out, decode 2 rows", 2, 4096, 4096))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place of the larger magnitude."""
    a, b = a.float(), b.float()
    ulp = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)
    return int(((a - b).abs() / ulp).max().round())


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_reduction_check: no CUDA card", file=sys.stderr)
        return 1
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    dev = torch.device("cuda")
    same_everywhere = True
    try:
        for label, M, K, N in SHAPES:
            g = torch.Generator(device=dev).manual_seed(M + N)
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(torch.bfloat16)
            f32 = (x.float() @ w.float()).to(torch.bfloat16)
            f64 = (x.double() @ w.double()).to(torch.bfloat16)
            got = {}
            for flag in (True, False):
                matmul.allow_bf16_reduced_precision_reduction = flag
                got[flag] = torch.matmul(x, w)
                torch.cuda.synchronize()
            for flag, out in got.items():
                print(f"{label} ({M} x {K} -> {N}), allow_bf16_reduced_precision_reduction="
                      f"{flag}: vs float32 product rounded once: "
                      f"{int((out != f32).sum())} of {out.numel()} differ, at most "
                      f"{ulps(out, f32)} ulp; vs float64 product rounded once: "
                      f"{int((out != f64).sum())} differ, at most {ulps(out, f64)} ulp")
            equal = torch.equal(got[True], got[False])
            same_everywhere &= equal
            print(f"  flag on == flag off, bit for bit: {equal}; the float32 reference vs "
                  f"the float64 one: {int((f32 != f64).sum())} differ")
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved
    print(f"the flag changed no product: {same_everywhere}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
