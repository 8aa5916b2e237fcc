#!/usr/bin/env python3
"""How far do equally valid arithmetic orders move the hybrids' logits?

    PYTHONPATH=src python3 tools/hybrid_logit_sensitivity.py

zamba2-1.2b and xlstm-1.3b at full width on one CUDA card, seeded random
weights made on the card, in bfloat16 and in float32 (the same draws):
``make_prefill_step`` on 2 x 1,024 tokens run six ways that compute the
same function in another order:

* ``kernel``: the SSD kernel and the flash kernel (the model path);
* ``twin``: the reference's chunk body and chunked attention (no kernel);
* ``body + flash`` and ``kernel + chunked``: one of the two swapped;
* ``kernel, scan_chunk / 2``: the Mamba2 and mLSTM chunk halved;
* ``twin, kv_chunk 256``: chunked attention in 256-row tiles.

Prints, per config and type, every pair's largest last-position logit
difference over the logits' std (real vocab slots), then the card's name
and power limit. A whole-model comparison in a type can only tell a fault
apart from rounding where it stays well under the spread these pairs
show.
"""

import subprocess
import sys
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import ssm
from repro_torch.models import transformer as T


def prefill(cfg, params, tokens, body: bool) -> torch.Tensor:
    """The last position's logits, the Mamba2 chunk loop on the chunk body
    where ``body``."""
    scan = ssm.mamba_scan
    if body:
        ssm.mamba_scan = ssm.mamba_scan_plain
    try:
        out = make_prefill_step(cfg)(params, {"tokens": tokens})
    finally:
        ssm.mamba_scan = scan
    torch.cuda.synchronize()
    return out


def gap(a: torch.Tensor, b: torch.Tensor, vocab: int) -> float:
    a, b = a[..., :vocab].double(), b[..., :vocab].double()
    return float((a - b).abs().max() / b.std())


def main() -> int:
    if not torch.cuda.is_available():
        print("hybrid_logit_sensitivity: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        for dtype in ("bfloat16", "float32"):
            cfg = replace(get_config(arch), use_flash_kernel=True, dtype=dtype)
            chunked = replace(cfg, use_flash_kernel=False)
            params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
            tokens = torch.randint(0, cfg.vocab, (2, 1024), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(1))
            runs = {
                "kernel": prefill(cfg, params, tokens, False),
                "twin": prefill(chunked, params, tokens, True),
                "body + flash": prefill(cfg, params, tokens, True),
                "kernel + chunked": prefill(chunked, params, tokens, False),
                "kernel, scan_chunk / 2": prefill(replace(cfg, scan_chunk=cfg.scan_chunk // 2),
                                                  params, tokens, False),
                "twin, kv_chunk 256": prefill(replace(chunked, kv_chunk=256, q_chunk=256),
                                              params, tokens, True),
            }
            names = list(runs)
            print(f"{arch} {dtype}: largest last-position logit difference over std")
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    print(f"  {a} vs {b}: {gap(runs[a], runs[b], cfg.vocab):.4f}")
            del params, runs
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
