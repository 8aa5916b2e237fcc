#!/usr/bin/env python3
"""How much does the chunk body's prefix sum move the Mamba2 scan on the card?

    PYTHONPATH=src python3 tools/ssd_prefix_sum_check.py

Builds zamba2-1.2b at full width (bf16, seeded weights made on the card)
and runs one prefill step of 2 x 1,024 tokens, keeping the scan inputs
(x, B, C, dA, dt) of each of the 33 Mamba2 layers. On each layer's inputs
it runs, on the card: the SSD kernel (float32 x, B, C, as the model path
hands them over); the chunk body ``ssm.mamba_scan_plain`` (its prefix sums
correctly rounded: summed in float64, rounded once); the same body with
the device's own float32 ``torch.cumsum`` (the reference's arithmetic,
``jnp.cumsum`` in float32); and the body in float64 throughout (float64
inputs, prefix sums and products): the yardstick. Prints per layer each
float32 version's share of the SSD kernel's contract (``atol 1e-4 + rtol
2e-4 |want|``, the reference kernel test's float32 tolerance) against the
float64 run and the kernel's against each body, and the largest |cum|
within a chunk; then the float32
cumsum's largest error on the card and on the CPU on one layer's chunks;
last, the card's name and power limit.
"""

import inspect
import subprocess
import sys
from dataclasses import replace

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import ssm
from repro_torch.models import transformer as T


def variant(name: str, **subs):
    """``ssm.mamba_scan_plain`` recompiled as ``name`` with its source's
    ``subs`` replaced (the float64 body, the device-cumsum body)."""
    src = inspect.getsource(ssm.mamba_scan_plain).replace("def mamba_scan_plain",
                                                          f"def {name}")
    for old, new in subs.items():
        src = src.replace(old, new)
    ns = {"torch": torch, "F": F, "_segsum": ssm._segsum, "_cumsum": ssm._cumsum}
    exec(src, ns)
    return ns[name]


def device_segsum(dA):
    cs = torch.cumsum(dA, dim=-1)
    C = dA.shape[-1]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dA.device))
    return torch.where(mask, cs[..., :, None] - cs[..., None, :], -torch.inf)


def share(got, want) -> float:
    diff = (got.double() - want).abs()
    return float((diff / (1e-4 + 2e-4 * want.abs())).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_prefix_sum_check: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    body64 = variant("body64", **{".float()": ".double()", "torch.float32": "torch.float64",
                                  "dac[:, k], dtc[:, k]": "dac[:, k].double(), dtc[:, k].double()",
                                  "_cumsum(dak, 1)": "torch.cumsum(dak, 1)"})
    body_device = variant("body_device", **{"_segsum(": "device_segsum(",
                                            "_cumsum(dak, 1)": "torch.cumsum(dak, 1)"})
    body_device.__globals__["device_segsum"] = device_segsum
    cfg = replace(get_config("zamba2-1.2b"), use_flash_kernel=True)
    params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    kept, scan = [], ssm.mamba_scan

    def keep(*args):
        kept.append(args)
        return scan(*args)

    ssm.mamba_scan = keep
    try:
        make_prefill_step(cfg)(params, {"tokens": tokens})
    finally:
        ssm.mamba_scan = scan
    torch.cuda.synchronize()
    print(f"zamba2-1.2b prefill step 2 x 1024: {len(kept)} Mamba2 scans; share of the SSD "
          f"contract against the float64 body (and the kernel's against each body), per "
          f"layer:")
    names = ("kernel", "body", "body, device float32 cumsum", "kernel vs body",
             "kernel vs the device-cumsum body")
    worst = dict.fromkeys(names, 0.0)
    for i, (x, b, c, dA, dt, chunk) in enumerate(kept):
        want = body64(x, b, c, dA, dt, chunk)
        got = {"kernel": scan(x, b, c, dA, dt, chunk),
               "body": ssm.mamba_scan_plain(x, b, c, dA, dt, chunk),
               "body, device float32 cumsum": body_device(x, b, c, dA, dt, chunk)}
        B, S, H = dA.shape
        cum = dA.reshape(B, S // chunk, chunk, H).double().cumsum(2).abs().max()
        shares = {k: share(v, want) for k, v in got.items()}
        shares["kernel vs body"] = share(got["kernel"], got["body"].double())
        shares["kernel vs the device-cumsum body"] = share(
            got["kernel"], got["body, device float32 cumsum"].double())
        worst = {k: max(worst[k], v) for k, v in shares.items()}
        print(f"  layer {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
              + f"; max |cum| in a chunk {float(cum):.1f}")
    print("worst: " + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))
    dA = kept[0][3]
    B, S, H = dA.shape
    chunks = dA.reshape(B, S // 128, 128, H).transpose(2, 3)
    exact = chunks.double().cumsum(-1)
    for where, t in (("card", chunks), ("cpu", chunks.cpu())):
        err = (t.cumsum(-1).double().cpu() - exact.cpu()).abs().max()
        print(f"float32 torch.cumsum on the {where}, layer 0's chunks: max abs error "
              f"{float(err):.4g} (float64 prefix sums rounded once: "
              f"{float((exact.float().double() - exact).abs().max()):.4g})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
