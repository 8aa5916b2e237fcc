#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths (``repro_torch``; nothing of JAX or of the
reference package ``repro``) on the card and fails on any fault:

1. device: the card's name and power limit, the torch and CUDA versions;
2. build: every source under ``src/repro_torch/csrc`` with ``nvcc`` for
   sm_90a, one ``nvcc`` per source, all started together;
3. DP kernels against their plain PyTorch versions on the card (dense and
   both fused kernels, tiled and one block per scenario, x float32/float64
   x sum/max, S = 4,099, tie-rich inputs with ~15% +inf and frozen rows, a
   heterogeneous ``bank_idx`` case): tables and parents exactly equal, and
   in float64 equal to the numpy oracle; then the wrapper's fused variant
   rule held to the C entry's over L 2..300 x both types x banks of 1-40
   matrices;
4. the planning path: ``sweep()`` on a 32,768-scenario grid at full model
   width (MobileNet-V2, L = 54; ResNet50, L = 52; four protocols, fleets
   of 2-5 ESP32s, 32 loss rates x 32 rate scales), then a grid with
   heterogeneous device mixes and one with energy budgets (dense kernel),
   with the launch counters read around these three runs only (both
   fused launches of the first and every one of the second on the tiled
   kernel). Each
   result equals the same sweep run on the plain versions; the float32
   fused path agrees with ``backend="torch"`` within a stated tolerance;
   float64 on the card equals ``backend="numpy"`` exactly;
5. DP times with CUDA events at S = 65,536, N = 5, L = 54, float32,
   beside each kernel's bound; the tiled fused kernel and the first one
   in turns on the path's bank and on the device-mix shape (4 matrices, a
   row per scenario and slot); the sweep's scenarios/s and wall time,
   and a profiled run's device busy time and idle share;
6. the two flash-attention kernels against their plain version on the
   card, after the wrapper's routing rule is held to the C entry's for
   every head dim: float32 on the CUDA-core kernel, bfloat16 on the wgmma
   kernel (the path's) and on the CUDA-core kernel; MHA / GQA (group 4) /
   MQA, ragged 100/100, q a suffix of a longer kv, D 64 over a ragged
   1,000-row kv, D 160 with ragged Sq, D 256, and both full-width shapes
   the serving path launches (4 x 2048 x 32 x 128 over 2,048 kv rows, and
   over the 2,080-row cache), within the reference kernel test's
   tolerances (at full width in bf16, a tighter atol set from the
   measured error), each case printing the share of its limit used;
   cross-checked against ``scaled_dot_product_attention`` as a yardstick;
7. the serving path's prefill step at full width: deepseek-7b (30 layers,
   d 4096, bf16, ``use_flash_kernel=True``, seeded random weights made
   on the card), ``make_prefill_step`` on 4 prompts x 2048 tokens: 30
   flash launches, all of the wgmma kernel, logits held to the same step
   on the plain attention path (``use_flash_kernel=False``) within a
   stated tolerance;
8. cached serving: ``prefill`` into a cache of 2048 + 32 rows (30
   launches of the wgmma kernel), then 32 greedy ``serve_step``s (0
   launches); the prefill's
   last-position logits are held to the plain-attention twin's as in 7,
   and the tokens equal the twin's wherever its top-two logit gap
   exceeds twice the logits tolerance;
9. ``Server`` at full width: 4 slots, 8 staggered requests of 8-64 prompt
   tokens, 16 new tokens each (0 flash launches: the server prefills
   token by token through the decode step); every request's tokens
   equal serving it alone on a 4-slot server, exactly;
10. serving times beside the card line: the wgmma flash kernel, the
   CUDA-core kernel on the same bf16 input, the plain version and
   ``scaled_dot_product_attention`` at the full-width shape beside the
   kernel's bound; the prefill step's wall time and tokens/s;
   ms per ``serve_step`` over three windows, the per-step spread with its
   host enqueue time, and the allocator's retries and cudaMalloc calls
   over those steps; ``Server`` tokens/s; traced runs of a prefill
   step and a ``serve_step`` (device busy time, idle share, launches);
11. the int8 GEMMs: the wrapper's W8A8 variant rule is held to the C
   entry's (K 1..300, activations off 16-byte alignment); both W8A8
   kernels (``wgmma`` where K % 16 == 0, ``mma.sync`` on every case) equal
   the plain version exactly in float32 and bfloat16 output (ragged 100 x
   200 x 300, one row, ragged M with N 1000, MobileNet-V2's Logits head
   64 x 1280 x 1000, the full-width deepseek-7b up-projection 8192 x 4096
   x 11008, a_zp != 0 with |acc| > 2^24, K 100 with N 48, K 37 with N
   40, and one row of K 200 against N 1000); the W8A16 kernel, float32
   and bfloat16 x, float32 and bfloat16 out, within the reference test's
   rtol; then the path: ``quant_linear`` and ``w8a16_linear`` on x (4,
   2048, 4096) bf16 against seeded random up-projection weights and on
   the Logits head, with the launch counters read around these four calls
   only (two launches of each GEMM, both W8A8 launches on ``wgmma``);
   ``quant_linear`` equal to the W8A8 kernel's plain version on the same
   quantized activations and, while |acc| <= 2^24, to the integer path;
   ``w8a16_linear`` against its plain path; and the reference tests'
   relative error against the float linear;
12. the SSD scan: ``ssm_scan`` on one zamba2-1.2b Mamba2 layer (B 4,
   S 2048, 64 heads of 64, ds 64), float32 and bfloat16, with the launch
   counter read around these two calls only; each against the chunked
   plain version and the sequential oracle, then ragged S = 1000 with
   chunks of 128 and 16 and ds 128 at chunk 128 (every case with B and
   C shared by the heads of a batch row); the kernels' arithmetic
   mirrored in PyTorch (``ssm_scan_pieces``) at full width against the
   same two, with the share of each limit it uses;
13. times at full width beside the card line: each int8 GEMM and the SSD
   kernels, the plain version and the PyTorch yardstick (``torch._int_mm``
   plus the epilogue; for W8A16 with bf16 x, dequantize to bf16 plus a
   bf16 ``torch.matmul`` and the scale, with the float32 one beside it;
   none for the scan) beside the bound; W8A8 on both kernels in turns;
   the SSD in bfloat16 and float32, each beside a bound that counts the
   flops its causal mask keeps (C Bᵀ once per batch row) times the bf16
   piece products each needs at the bf16 tensor-core rate, with the
   float32 CUDA-core bound of the same flops beside it; W8A16 with
   float32 x; the ops' wall times and a traced ``quant_linear``;
14. the paper's solvers, the planner and degradation surfaces on the card,
   with the launch counters read around this phase only (both DP kernels
   must launch): (a) ``plan_split_batch`` on 2,048 MobileNet-V2 and
   2,048 ResNet50 cost models (4 protocols x 8 loss rates x 16 rate
   scales x fleets of 2-5 as a per-model list) on ``backend=None`` (the
   dense kernel, float32), equal to the same call on ``device="cpu"``;
   float64 on the card equal to ``backend="numpy"``; a variant bank with
   an accuracy floor and an energy budget, each equal on the card and the
   CPU; (b) a MobileNet-V2 ``batched_dp`` surface family (4 protocols, 32
   packet-time scales x 32 loss rates, the refit floor joining each
   packet-time axis: 4,192 nodes; fleets 2-5):
   unbudgeted on the fused kernel (its launch on the tiled kernel),
   node-identical to the build on the CPU, and within the fused/dense
   float32 tolerance of ``backend="torch"`` (differing nodes counted);
   budgeted on the dense kernel, node-identical to ``backend="torch"``;
   (c) ``compare_solvers`` (beam, greedy, first-fit, random-fit, brute
   force, the scalar DP) and ``plan_split(solver="batched_dp")`` on the
   card for both models over ESP-NOW at N 2-5: brute force equal to the
   DP's optimum, the card's DP cost within 4·N·eps32 of it and its plan's
   float64-repriced regret within 1e-12 relative (an exact tie),
   each solver's latency, regret and host wall time; (d) the launches by
   path, the host wall times of (a) and (b) beside their twins, and a
   traced build of (b) (device busy time, idle share, the kernel's share);
15. a JSON line of per-kernel results, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no card is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
F32_EPS = float(np.finfo(np.float32).eps)

# Published peaks of the H100 SXM5 (80GB HBM3) at its 700 W limit, the
# card every run of this script has used (NVIDIA data sheet): bytes/s of
# device memory, and fp32 instructions/s off the tensor cores. The sheet's
# 67 TFLOP/s counts an FMA as two operations; the kernels issue adds and
# compares, one per lane per cycle, so half of it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# dense bf16 tensor-core peak (not the 1,979 TFLOP/s sparsity figure)
BF16_FLOPS_PER_S = 989e12
# dense int8 tensor-core peak, and fp32 FMAs off the tensor cores counted
# as two operations each (the sheet's 67 TFLOP/s)
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

# the reference kernel test's tolerances (tests/test_kernels.py:133, :151)
FLASH_TOL = {"float32": (1e-3, 2e-5), "bfloat16": (2e-2, 2e-2)}
# bf16 at full width, where rows see ~1,000 keys and |out| is ~0.04: rtol
# covers a one-ulp difference of the bf16 output at any magnitude (an ulp
# is <= 2^-7 relative); atol is twice the largest error measured at the
# prefill step's shape (0.00195, one ulp in [0.25, 0.5))
FLASH_TOL_FULL_BF16 = (2e-2, 4e-3)
# prefill logits, kernel vs the plain-attention twin: max |diff| <= this
# times the twin's std. The kernel keeps the probabilities in float32
# (the reference kernel's arithmetic); the twin's chunked attention
# rounds them to bf16 before PV, and 30 layers compound the difference.
LOGITS_TOL = 0.25
# W8A16 kernel vs plain: the same float32 products summed in another
# order. rtol is the reference kernel test's (tests/test_kernels.py:87,
# :96), by output type (bfloat16 adds one rounding); atol is rtol times
# the output's rms, as those tests' outputs are O(1) and these grow with K
W8A16_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# SSD kernel vs its plain version and the sequential oracle: the
# reference kernel test's (rtol, atol) in float32 (tests/test_kernels.py
# :188); in bfloat16 both round a float32 result once, so one bf16 ulp
# (2^-7 relative) on top, and an atol of 1e-3 for outputs near 0
SSD_TOL = {"float32": (2e-4, 1e-4), "bfloat16": (2 ** -7 + 2e-4, 1e-3)}
# (label, M, K, N) of phase 11
GEMM_CASES = [("ragged", 100, 200, 300), ("one row", 1, 4096, 11008),
              ("ragged M, N 1000", 33, 1280, 1000),
              ("MobileNet-V2 Logits head", 64, 1280, 1000),
              ("full width (deepseek-7b up-projection, 4 x 2048 tokens)", 8192, 4096, 11008),
              ("K 100, no multiple of 8 (bf16 x without TMA)", 37, 100, 48),
              ("K 37, N 40 (x and w without TMA)", 19, 37, 40),
              ("one row, K 200 (W8A8 on mma.sync only)", 1, 200, 1000)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tie_rich_C(S, N, L, seed, inf_frac=0.15):
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 41, size=(S, N, L, L)) / 4.0
    C[rng.random_sample(C.shape) < inf_frac] = np.inf
    il = np.tril_indices(L, -1)
    C[:, :, il[0], il[1]] = np.inf
    return C


def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries finite on both sides; +-inf must sit
    at the same places."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    if not torch.equal(torch.isinf(a), torch.isinf(b)):
        return float("inf")
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def check_tables(name, got, want, oracle=None) -> float:
    """Exact equality of (dp0, dps, args); returns the max abs error."""
    import torch

    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    same = all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(got, want))
    if not same or err != 0.0:
        raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
    if oracle is not None:
        from repro_torch.core import sweep as PS

        dp_per_k, parents = PS._dp_tables_to_numpy(
            *(t.cpu().numpy() for t in got), *oracle[0])
        want_k, want_p = oracle[1]
        if not (all(np.array_equal(x, y) for x, y in zip(dp_per_k, want_k))
                and np.array_equal(parents, want_p)):
            raise AssertionError(f"{name}: float64 kernel != numpy oracle")
    return err


def phase_kernels(dev, S=4099) -> dict[str, float]:
    """Each kernel against its plain version on ``dev``; max abs errors."""
    import torch

    from repro_torch.core import cuda_dp as CD
    from repro_torch.core import sweep as PS
    from repro_torch.kernels import build

    errs = {"dense_dp": 0.0, "fused_dp": 0.0}
    cases = [(N, L, dtype, combine)
             for N, L in ((2, 52), (5, 54))
             for dtype in (torch.float32, torch.float64)
             for combine in ("sum", "max")]
    for i, (N, L, dtype, combine) in enumerate(cases):
        rng = np.random.RandomState(100 + i)
        ns = rng.randint(1, N + 1, size=S)
        ns_t = torch.from_numpy(ns.astype(np.int32)).to(dev)
        f64 = dtype == torch.float64
        tag = f"N={N} L={L} {str(dtype)[6:]} {combine}"

        C = tie_rich_C(S, N, L, seed=200 + i)
        C_t = torch.from_numpy(C).to(dev, dtype)
        oracle = ((S, N, L), PS._dp_numpy(C, combine, ns)) if f64 else None
        errs["dense_dp"] = max(errs["dense_dp"], check_tables(
            f"dense_dp {tag}", CD.dense_dp(C_t, ns_t, combine),
            CD.dense_dp_plain(C_t, ns_t, combine), oracle))

        # fused: a shared stack, and (N = 5) a bank gathered per scenario
        B = 3 if N == 5 else N
        bank = tie_rich_C(1, B, L, seed=300 + i)[0]
        tx = rng.randint(0, 9, size=(S, L)) / 4.0
        tx[:, -1] = 0.0
        bank_idx = rng.randint(0, B, size=(S, N)) if N == 5 else None
        idx = np.tile(np.arange(N), (S, 1)) if bank_idx is None else bank_idx
        args = (torch.from_numpy(bank).to(dev, dtype),
                torch.from_numpy(tx).to(dev, dtype), ns_t, combine,
                None if bank_idx is None else
                torch.from_numpy(bank_idx.astype(np.int32)).to(dev))
        C = bank[idx] + tx[:, None, None, :]
        oracle = ((S, N, L), PS._dp_numpy(C, combine, ns)) if f64 else None
        want = CD.fused_dp_plain(*args)
        for variant in (None, "per_scenario"):  # the rule's pick (tiled), the first kernel
            errs["fused_dp"] = max(errs["fused_dp"], check_tables(
                f"fused_dp ({variant or 'tiled'}) {tag}"
                f"{' bank_idx' if bank_idx is not None else ''}",
                CD.fused_dp(*args, variant=variant), want, oracle))
        print(f"  ok {tag}: dense and both fused kernels == plain"
              f"{' == numpy oracle' if f64 else ''}")
    lib = build.load("split_dp.cu").lib
    banks = (1, 2, 3, 4, 5, 6, 8, 9, 12, 13, 17, 18, 20, 40)
    for dtype in (torch.float32, torch.float64):
        for L in range(2, 301):
            for B in banks:
                if bool(lib.split_dp_fused_variant(B, L, int(dtype == torch.float64))) \
                        != (CD._fused_variant(B, L, dtype) == "tiled"):
                    raise AssertionError(f"fused_dp: _fused_variant({B}, {L}, {dtype}) "
                                         "!= the C entry's rule")
    print(f"  ok the wrapper's fused variant rule == split_dp_fused_variant for both "
          f"types, L 2..300, banks of {banks[0]}..{banks[-1]} matrices")
    return errs


def grids():
    """(main 32,768-scenario grid, device-mix grid, energy-budget grid,
    float64 subgrid) at full model width."""
    from repro_torch.core import profiles as PP
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.core.sweep import ScenarioGrid

    models = {"mobilenet_v2": PP.mobilenet_cost_profile(),
              "resnet50": PP.resnet50_cost_profile()}
    loss = tuple(float(x) for x in np.linspace(0.0, 0.3, 32))
    rate = tuple(float(x) for x in np.linspace(1 / 16, 1.0, 32))
    main = ScenarioGrid(models=models, links=dict(PP.PROTOCOLS),
                        n_devices=(2, 3, 4, 5), loss_p=loss, rate_scale=rate,
                        devices=(PP.ESP32,))
    fast = DeviceProfile("gateway", compute_scale=0.05)
    mixes = ScenarioGrid(
        models=models, links=dict(PP.PROTOCOLS), n_devices=(2, 3, 4, 5),
        loss_p=loss[::4], rate_scale=rate[::4], devices=(PP.ESP32,),
        device_mixes={"gateway_tail": (PP.ESP32,) * 4 + (fast,),
                      "alternating": (PP.ESP32, fast) * 2 + (PP.ESP32,)})
    powered = replace(PP.ESP32, active_power_w=0.5)
    links = {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2)
             for p, lk in PP.PROTOCOLS.items()}
    budgets = ScenarioGrid(models=models, links=links, n_devices=(2, 3, 4, 5),
                           loss_p=loss[::4], rate_scale=rate[::4],
                           devices=(powered,), energy_budgets=(None, 1.0, 0.4))
    sub = replace(main, loss_p=loss[::4], rate_scale=rate[::4])
    return main, mixes, budgets, sub


def rows_equal(a, b) -> bool:
    return a.n_scenarios == b.n_scenarios and all(
        (p.scenario, p.splits, p.feasible, p.objective_cost_s,
         p.total_latency_s, p.device_s, p.transmission_s)
        == (q.scenario, q.splits, q.feasible, q.objective_cost_s,
            q.total_latency_s, q.device_s, q.transmission_s)
        for p, q in zip(a.rows, b.rows))


def fused_vs_dense_f32(a, b, n_max=5) -> tuple[int, float]:
    """The fused float32 path builds C[s,k] as f32(local) + f32(tx), the
    dense one as f32(local64 + tx64): <= 1 ulp per entry, so costs agree
    within 4 * N * eps32 relative and plans differ only where both price
    (float64, from the bank and TX) within that tolerance. Returns the
    number of differing plans and the largest relative cost gap."""
    tol = 4 * n_max * F32_EPS
    differ, worst = 0, 0.0
    for p, q in zip(a.rows, b.rows):
        if p.feasible != q.feasible:
            raise AssertionError(f"feasibility differs: {p.scenario.describe()}")
        if not p.feasible:
            continue
        gap = abs(p.objective_cost_s - q.objective_cost_s) / q.objective_cost_s
        worst = max(worst, gap)
        if gap > tol:
            raise AssertionError(f"cost gap {gap} > {tol}: {p.scenario.describe()}")
        if p.splits != q.splits:
            differ += 1
            pa = p.device_s + p.transmission_s
            qa = q.device_s + q.transmission_s
            if abs(pa - qa) > tol * qa:
                raise AssertionError(
                    f"plans differ beyond a float32 tie: {p.scenario.describe()}")
    return differ, worst


def phase_main_path() -> dict:
    """Run the main path with the launch counters zeroed around it, then
    hold every result to the plain path and the float64 oracle."""
    import torch

    from repro_torch.core import cuda_dp as CD
    from repro_torch.core.sweep import sweep

    main, mixes, budgets, sub = grids()
    CD.reset_launch_counts()
    res_main = sweep(main)
    per_sweep = (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES)
    res_mixes = sweep(mixes)
    mix_fused = (CD.FUSED_LAUNCHES - per_sweep[1], CD.FUSED_TILED_LAUNCHES - per_sweep[2])
    res_budgets = sweep(budgets)
    launches = {"dense_dp": CD.DENSE_LAUNCHES, "fused_dp": CD.FUSED_LAUNCHES}
    by_variant = {"tiled": CD.FUSED_TILED_LAUNCHES,
                  "per_scenario": CD.FUSED_LAUNCHES - CD.FUSED_TILED_LAUNCHES}
    print(f"  main path: {main.size} + {mixes.size} (device mixes) + "
          f"{budgets.size} (energy budgets) scenarios; launches {launches}, fused by "
          f"kernel {by_variant}; the {main.size}-scenario sweep alone: dense "
          f"{per_sweep[0]}, fused {per_sweep[1]} ({per_sweep[2]} tiled); the device-mix "
          f"sweep: fused {mix_fused[0]} ({mix_fused[1]} tiled)")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} was not launched on the main path")
    if per_sweep[1:] != (2, 2) or mix_fused[0] == 0 or mix_fused[0] != mix_fused[1]:
        raise AssertionError("the sweeps' fused launches did not all run the tiled kernel")
    for res in (res_main, res_mixes, res_budgets):
        rows = res.rows
        if not all(r.feasible == np.isfinite(r.total_latency_s) for r in rows) \
                or not any(r.feasible for r in rows):
            raise AssertionError("sweep rows are not consistent")

    for name, grid, res in (("main", main, res_main), ("mixes", mixes, res_mixes),
                            ("budgets", budgets, res_budgets)):
        plain = sweep(grid, device="cpu")
        if not rows_equal(res, plain):
            raise AssertionError(f"{name}: sweep on the card != plain versions")
        dense = sweep(grid, backend="torch")
        if name == "budgets":  # both run the dense recurrence on one C
            if not rows_equal(res, dense):
                raise AssertionError("budgets: cuda != torch")
            print(f"  {name}: == plain versions (cpu) == backend='torch'")
        else:
            differ, worst = fused_vs_dense_f32(res, dense)
            print(f"  {name}: == plain versions (cpu); vs backend='torch': "
                  f"{differ} of {grid.size} plans differ at float32 ties, "
                  f"max relative cost gap {worst:.3g} "
                  f"(tolerance {4 * 5 * F32_EPS:.3g})")
    for name, grid in (("float64 subgrid", sub), ("float64 budgets", budgets)):
        got = sweep(grid, dtype=torch.float64)
        if not rows_equal(got, sweep(grid, backend="numpy")):
            raise AssertionError(f"{name}: cuda float64 != numpy")
        print(f"  {name} ({grid.size} scenarios): cuda float64 == numpy")
    return {"launches": launches, "by_variant": by_variant, "per_sweep": per_sweep,
            "main": main}


def timed_ms(fn, reps) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(dev, card, launches, S=65536, N=5, L=54) -> dict:
    """Each kernel and its plain version at S x N x L, float32, every row
    live, beside its bound: the bytes it must move (each C or bank entry
    the recurrence reads, each other input and each output once) over the
    memory rate, or its adds and compares over the fp32 rate."""
    import torch

    from repro_torch.core import cuda_dp as CD

    g = torch.Generator(device=dev).manual_seed(0)

    def tie_rich(*shape):
        x = torch.randint(1, 41, shape, generator=g, device=dev).float() / 4
        return x.masked_fill(torch.rand(shape, generator=g, device=dev) < 0.15,
                             float("inf"))

    C = tie_rich(S, N, L, L)
    # the fused kernel as sweep() launches it on a homogeneous fleet: a
    # bank of (first device, later device) local-cost matrices and a
    # per-scenario row index for each device slot
    bank = tie_rich(2, L, L)
    bank_idx = torch.ones((S, N), dtype=torch.int32, device=dev)
    bank_idx[:, 0] = 0
    tx = torch.randint(0, 9, (S, L), generator=g, device=dev).float() / 4
    ns = torch.full((S,), N, dtype=torch.int32, device=dev)
    steps = int((ns.clamp(1, N) - 1).sum())  # live device steps k >= 2
    cand = steps * (L - 1) * L  # each reads rows 1..L-1 of its (L, L) matrix
    out_bytes = S * L * 4 + S * (N - 1) * L * (4 + 4) + S * 4  # dp0, dps, args, ns
    work = {
        "dense_dp": (lambda: CD.dense_dp(C, ns), lambda: CD.dense_dp_plain(C, ns),
                     (S * L + cand) * 4 + out_bytes,  # C[s,0,0,:] + live rows
                     2 * cand),  # combine, compare
        "fused_dp": (lambda: CD.fused_dp(bank, tx, ns, bank_idx=bank_idx),
                     lambda: CD.fused_dp_plain(bank, tx, ns, bank_idx=bank_idx),
                     (bank.numel() + tx.numel() + (S + steps)) * 4 + out_bytes,
                     3 * cand),  # build add, combine, compare
    }
    out = {}
    for name, (kernel, plain, nbytes, ops) in work.items():
        plain_a = timed_ms(plain, 3)
        ms = timed_ms(kernel, 20)
        plain_ms = min(plain_a, timed_ms(plain, 3))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms; bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB in {bytes_ms:.4f} ms, {ops / 1e9:.2f} G "
              f"ops in {ops_ms:.4f} ms) at S={S} N={N} L={L} float32; "
              f"{launches[name]} launches on the main path [{card}]")

    # the fused kernels in turns on the same inputs (first kernel, tiled,
    # tiled, first kernel): the path's bank, then the device-mix grid's
    # shape (4 matrices, a row drawn per scenario and slot, so the tiled
    # kernel builds its costs again at most steps); the bound is the same
    bank4 = tie_rich(4, L, L)
    idx4 = torch.randint(0, 4, (S, N), generator=g, device=dev, dtype=torch.int32)
    fused = out["fused_dp"]
    for tag, bk, idx in (("path", bank, bank_idx), ("device mix", bank4, idx4)):
        tiled = CD.fused_dp(bk, tx, ns, bank_idx=idx)
        first = CD.fused_dp(bk, tx, ns, bank_idx=idx, variant="per_scenario")
        if not all(torch.equal(x, y) for x, y in zip(tiled, first)):
            raise AssertionError(f"fused_dp {tag}: tiled kernel != first kernel")
        turns = [timed_ms(lambda: CD.fused_dp(bk, tx, ns, bank_idx=idx, variant=v), 20)
                 for v in ("per_scenario", "tiled", "tiled", "per_scenario")]
        t_ms, ps_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        nbytes = (bk.numel() + tx.numel() + (S + steps)) * 4 + out_bytes
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * cand / FP32_OPS_PER_S) * 1e3
        if tag == "path":
            fused.update(ms=t_ms, per_scenario_ms=ps_ms)
        else:
            fused.update(mix_ms=t_ms, mix_per_scenario_ms=ps_ms, mix_bound_ms=bound)
        print(f"  fused_dp {tag}, B={bk.shape[0]}: tiled {t_ms:.4f} ms, first kernel "
              f"{ps_ms:.4f} ms (in turns: {', '.join(f'{t:.4f}' for t in turns)}); bound "
              f"{bound:.4f} ms; tiled at {bound / t_ms:.1%} of it, "
              f"{ps_ms / t_ms:.2f}x the first kernel [{card}]")
    return out


def phase_sweep(grid, card, fused_per_sweep) -> None:
    """The main-path sweep at steady state (kernel built, card warm): its
    own timing split, the whole call's wall time, and a traced run's
    device busy time by operation and the device's idle share."""
    from repro_torch.core.sweep import sweep

    t0 = time.perf_counter()
    res = sweep(grid)
    wall = time.perf_counter() - t0
    print(f"  sweep {res.n_scenarios} scenarios: {res.scenarios_per_sec:.1f} "
          f"scenarios/s, build_time_s {res.build_time_s:.4f}, solve_time_s "
          f"{res.solve_time_s:.4f}, whole call {wall:.4f} s; fused launches "
          f"per sweep {fused_per_sweep} [{card}]")
    traced_run("sweep", lambda: sweep(grid), card)


# ---------------------------------------------------------------------------
# The serving path: deepseek-7b on the flash-attention kernel
# ---------------------------------------------------------------------------


def fold(x):
    """(B, S, H, D) -> (B*H, S, D), as the flash wrapper folds."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D)


def flash_case(dev, B, Sq, Skv, H, Hkv, D, dtype, seed, q0=None):
    """Seeded q, k, v in model layout; q sits at positions q0.. (default:
    the last Sq kv positions)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    q0 = Skv - Sq if q0 is None else q0
    qpos = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=dev)
    kpos = torch.arange(Skv, dtype=torch.int32, device=dev)
    return q, k, v, qpos, kpos


def phase_flash(dev) -> float:
    """Both flash kernels (through the wrapper) against their plain version
    on the card: every case in float32 (the CUDA-core kernel) and in bf16
    on the wrapper's pick (the wgmma kernel wherever D is a multiple of
    16) and on the CUDA-core kernel; returns the largest max abs error.
    The wrapper's routing rule is first held to the C entry's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    lib = build.load("flash_attention.cu").lib
    for dtype in (torch.float32, torch.bfloat16):
        for D in range(1, FA.MAX_HEAD_DIM + 1):
            if bool(lib.flash_attention_variant(int(dtype == torch.bfloat16), D)) \
                    != (FA._variant(dtype, D) == "wgmma"):
                raise AssertionError(f"flash: _variant({dtype}, {D}) != the C entry's rule")
    print("  ok the wrapper's variant rule == flash_attention_variant for both types, "
          f"D 1..{FA.MAX_HEAD_DIM}")
    cases = [  # label, B, Sq, Skv, H, Hkv, D, first q position (None: Skv - Sq)
        ("MHA", 2, 256, 256, 8, 8, 128, None),
        ("GQA group 4", 2, 256, 256, 8, 2, 128, None),
        ("MQA", 2, 192, 192, 8, 1, 64, None),
        ("ragged 100/100", 2, 100, 100, 4, 2, 32, None),
        ("q suffix of a longer kv", 2, 96, 2080, 4, 4, 128, None),
        ("D 64, ragged Skv 1000 (not a multiple of the 64-row kv tile)", 2, 200, 1000, 8, 2,
         64, None),
        ("D 160 (stablelm-12b), ragged Sq 130", 2, 130, 130, 4, 2, 160, None),
        ("D 256", 1, 256, 256, 4, 4, 256, None),
        ("full width (prefill step)", 4, 2048, 2048, 32, 32, 128, None),
        # prefill into the 2,080-row cache: the unwritten 32-row kv tail
        # is masked for every q row, and its tile is skipped
        ("full width (prefill into the cache)", 4, 2048, 2080, 32, 32, 128, 0),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for i, (label, B, Sq, Skv, H, Hkv, D, q0) in enumerate(cases):
            full = label.startswith("full width")
            rtol, atol = FLASH_TOL_FULL_BF16 if full and name == "bfloat16" \
                else FLASH_TOL[name]
            q, k, v, qpos, kpos = flash_case(dev, B, Sq, Skv, H, Hkv, D, dtype, 10 + i, q0)
            (B, Sq, H, D), (Skv, Hkv) = q.shape, k.shape[1:3]
            scale = D ** -0.5
            want = attention_ref(fold(q), fold(k), fold(v), qpos, kpos, scale)
            want = want.reshape(B, H, Sq, D).transpose(1, 2)
            variants = [FA._variant(dtype, D)] + (["simt"] if name == "bfloat16" else [])
            notes = []
            for variant in dict.fromkeys(variants):
                if variant == FA._variant(dtype, D):  # the path's own call
                    got = FA.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos,
                                             scale=scale)
                else:
                    got = FA.flash_attention_kernel(
                        fold(q).contiguous(), fold(k).contiguous(), fold(v).contiguous(),
                        qpos, kpos, scale=scale, variant=variant,
                    ).reshape(B, H, Sq, D).transpose(1, 2)
                torch.cuda.synchronize()
                err, used = within(got, want, rtol, atol)
                if used > 1.0:
                    raise AssertionError(f"flash {label} {name} {variant}: kernel != plain "
                                         f"version (max abs err {err}, rtol {rtol}, atol {atol})")
                worst = max(worst, err)
                notes.append(f"{variant} max abs err {err:.3g} ({used:.3f} of the limit)")
                if int(qpos[0]) == 0 and variant == variants[0]:
                    # causal SDPA (top-left aligned) is the same function
                    rep = H // Hkv
                    sdpa = F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
                        v.repeat_interleave(rep, 2).transpose(1, 2), is_causal=True,
                        scale=scale).transpose(1, 2)
                    notes.append(f"vs scaled_dot_product_attention (yardstick) "
                                 f"{float((got.float() - sdpa.float()).abs().max()):.3g}")
            print(f"  ok {label} B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} D={D} {name} "
                  f"(rtol {rtol}, atol {atol}): {'; '.join(notes)}")
    return worst


def lm_setup(dev):
    """deepseek-7b at full width on the card, seeded random weights, and
    its plain-attention twin config."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = replace(get_config("deepseek-7b"), use_flash_kernel=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    print(f"  deepseek-7b: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} G parameters "
          f"made on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, replace(cfg, use_flash_kernel=False), params


def prompts(dev, cfg, B=4, P=2048):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)


def phase_prefill(dev, cfg, twin, params) -> dict:
    """``make_prefill_step`` on 4 x 2048 tokens: 30 flash launches; the
    last-position logits against the plain-attention twin's."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.steps import make_prefill_step

    batch = {"tokens": prompts(dev, cfg)}
    FA.reset_launch_count()
    got = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    launches, wgmma = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    if launches != cfg.n_layers or wgmma != cfg.n_layers:
        raise AssertionError(f"prefill step: {launches} flash launches, {wgmma} of the "
                             f"wgmma kernel; expected {cfg.n_layers} of it")
    want = make_prefill_step(twin)(params, batch)
    real = slice(0, cfg.vocab)
    if got.shape != (4, cfg.vocab_padded) or not bool(torch.isfinite(got[:, real]).all()):
        raise AssertionError(f"prefill step: bad logits {tuple(got.shape)}")
    err = float((got[:, real] - want[:, real]).abs().max())
    std = float(want[:, real].std())
    same = (got[:, real].argmax(-1) == want[:, real].argmax(-1)).tolist()
    print(f"  prefill step 4 x 2048: {launches} flash launches ({wgmma} wgmma); last-position logits "
          f"vs the plain-attention twin: max abs err {err:.4g} = {err / std:.4f} x "
          f"std {std:.4g} (tolerance {LOGITS_TOL} x std); argmax equal {same}")
    if err > LOGITS_TOL * std:
        raise AssertionError("prefill step: kernel logits beyond tolerance of the twin")
    return {"launches": launches, "wgmma": wgmma, "tol": LOGITS_TOL * std}


def phase_cached(dev, cfg, twin, params, tol, n_decode=32) -> dict:
    """``prefill`` into a 2048 + 32 cache, then greedy ``serve_step``s; the
    twin decodes the same tokens. The prefill's last-position logits are
    held to the twin's within LOGITS_TOL x its std, as in phase 7; at
    every step, wherever the twin's top-two logit gap exceeds 2 x tol,
    the kernel model's token must equal its argmax."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as T

    tokens = prompts(dev, cfg)
    B, P = tokens.shape
    max_seq = P + n_decode
    real = slice(0, cfg.vocab)
    counts, wgmma = {}, {}
    exact = decisive = 0
    ours, theirs = T.init_cache(cfg, B, max_seq, device=dev), T.init_cache(cfg, B, max_seq, device=dev)
    for i in range(n_decode + 1):
        step = {"tokens": tokens} if i == 0 else {"tokens": tok[:, None], "cur_index": P + i - 1}
        run = T.prefill if i == 0 else T.serve_step
        FA.reset_launch_count()
        logits, ours = run(cfg, params, step, ours)
        torch.cuda.synchronize()
        counts[run.__name__] = counts.get(run.__name__, 0) + FA.FLASH_LAUNCHES
        wgmma[run.__name__] = wgmma.get(run.__name__, 0) + FA.FLASH_WGMMA_LAUNCHES
        twin_logits, theirs = run(twin, params, step, theirs)
        if i == 0:
            err = float((logits[:, -1, real] - twin_logits[:, -1, real]).abs().max())
            std = float(twin_logits[:, -1, real].std())
            print(f"  prefill into the cache: last-position logits vs the twin: max abs "
                  f"err {err:.4g} = {err / std:.4f} x std {std:.4g} (tolerance "
                  f"{LOGITS_TOL} x std)")
            if err > LOGITS_TOL * std:
                raise AssertionError("prefill into the cache: kernel logits beyond "
                                     "tolerance of the twin")
        tok = logits[:, -1, real].argmax(-1)
        top2 = twin_logits[:, -1, real].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = tok == twin_logits[:, -1, real].argmax(-1)
        if bool((clear & ~agree).any()):
            raise AssertionError(f"cached serving step {i}: tokens differ from the "
                                 f"twin where its top-two gap exceeds {2 * tol:.4g}")
        exact += int(agree.sum())
        decisive += int(clear.sum())
        if not bool(torch.isfinite(logits[:, -1, real]).all()) or bool((tok < 0).any()):
            raise AssertionError(f"cached serving step {i}: bad logits")
    if counts != {"prefill": cfg.n_layers, "serve_step": 0} or wgmma != counts:
        raise AssertionError(f"cached serving: flash launches {counts} (wgmma {wgmma}), "
                             f"expected {cfg.n_layers} of the wgmma kernel in prefill and "
                             f"0 in serve_step")
    total = B * (n_decode + 1)
    print(f"  prefill into a {max_seq}-row cache + {n_decode} serve_steps: flash "
          f"launches {counts}, of the wgmma kernel {wgmma}; tokens equal to the twin's in {exact} of {total} "
          f"(row, step) picks; {decisive} had a top-two gap > {2 * tol:.4g}, and "
          f"all of those agree")
    return {"counts": counts, "wgmma": wgmma, "exact": exact, "total": total, "cache": ours}


def serve_requests(params, cfg, reqs, slots=4, max_seq=128, stagger=True):
    """Serve ``reqs`` [(rid, prompt, max_new)] on a fresh ``Server``;
    staggered: two at a time, with ticks between the admissions."""
    from repro_torch.runtime.server import Request, Server

    srv = Server(cfg, params, slots=slots, max_seq=max_seq)
    out = {rid: [] for rid, _, _ in reqs}
    pending = list(reqs)
    while pending or srv.queue or srv.active:
        for rid, prompt, max_new in pending[:2] if stagger else pending:
            srv.submit(Request(rid, prompt, max_new_tokens=max_new))
        pending = pending[2:] if stagger else []
        for _ in range(3 if pending else 10_000):
            if not (srv.queue or srv.active):
                break
            for rid, tok in srv.step():
                out[rid].append(tok)
    return out


def phase_server(params, cfg) -> dict:
    """``Server`` at full width: 8 staggered requests on 4 slots; every
    request drains with in-vocab tokens equal to serving it alone."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA

    rng = np.random.RandomState(7)
    reqs = [(rid, rng.randint(0, cfg.vocab, size=int(n)).astype(np.int32), 16)
            for rid, n in enumerate(rng.randint(8, 65, size=8))]
    FA.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve_requests(params, cfg, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.FLASH_LAUNCHES
    n_tokens = sum(len(t) for t in got.values())
    if launches != 0:
        raise AssertionError(f"Server: {launches} flash launches, expected 0")
    if any(len(t) != 16 or not all(0 <= x < cfg.vocab for x in t) for t in got.values()):
        raise AssertionError("Server: a request did not drain with in-vocab tokens")
    for rid, prompt, max_new in reqs:
        alone = serve_requests(params, cfg, [(rid, prompt, max_new)], stagger=False)
        if alone[rid] != got[rid]:
            raise AssertionError(f"Server: request {rid} differs from serving it alone")
    print(f"  Server 4 slots, 8 requests (prompts {sorted(len(p) for _, p, _ in reqs)} "
          f"tokens), 16 new tokens each: all drained, {launches} flash launches; each "
          f"request's tokens == serving it alone (exact)")
    return {"wall_s": wall, "tokens": n_tokens,
            "prompt_tokens": sum(len(p) for _, p, _ in reqs)}


def traced_run(label, fn, card) -> dict | None:
    """One traced run of ``fn``: wall time, device busy time and idle
    share, kernel launches, and the device time of the largest ops.
    Returns the wall and busy ms and the device ms by op (``None`` when
    the trace holds no device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    ops = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    if busy_ms == 0.0:
        print(f"  traced {label}: device time not measured (no device events)")
        return None
    top = "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                    for e in ops[:8])
    print(f"  traced {label}: wall {wall * 1e3:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / 1e3 / wall:.4f}, {launches} kernel launches "
          f"[{card}]")
    print(f"  device time by op: {top}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "ops": {e.key: e.self_device_time_total / 1e3 for e in ops}}


def phase_serving_times(dev, cfg, params, cache, server, card) -> dict:
    """The flash kernel, its plain version and SDPA at the full-width
    shape beside the kernel's bound; prefill step, serve_step and Server
    rates; traced runs of a prefill step and a serve_step."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    B, S, H, D = 4, 2048, cfg.n_heads, cfg.head_dim
    q, k, v, qpos, kpos = flash_case(dev, B, S, S, H, cfg.n_kv_heads, D, torch.bfloat16, 99)
    qf, kf, vf = fold(q), fold(k), fold(v)
    scale = D ** -0.5
    # the work these positions need: the (q, k) pairs the mask keeps, and
    # q, out and the kv rows up to the last q position, each moved once
    pairs = B * H * int((kpos[None, :] <= qpos[:, None]).sum())
    live_kv = int((kpos <= qpos.max()).sum())
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * H * S * D + 2 * B * cfg.n_kv_heads * live_kv * D)
    flops_ms, bytes_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    def kernel(variant=None):
        return FA.flash_attention_kernel(qf, kf, vf, qpos, kpos, scale=scale, variant=variant)

    if FA._variant(q.dtype, D) != "wgmma":
        raise AssertionError("flash: the serving shape does not take the wgmma kernel")
    # in turns: plain, CUDA-core kernel, wgmma kernel, wgmma, CUDA-core, plain
    plain_a = timed_ms(lambda: attention_ref(qf, kf, vf, qpos, kpos, scale), 3)
    simt_a = timed_ms(lambda: kernel("simt"), 3)
    ms = min(timed_ms(kernel, 10), timed_ms(kernel, 10))
    simt_ms = min(simt_a, timed_ms(lambda: kernel("simt"), 3))
    plain_ms = min(plain_a, timed_ms(lambda: attention_ref(qf, kf, vf, qpos, kpos, scale), 3))
    lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                             scale=scale), 10)
    flash = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(flops_ms, bytes_ms),
                 bound_by="operations" if flops_ms >= bytes_ms else "bytes",
                 library_ms=lib_ms, simt_ms=simt_ms)
    print(f"  flash_attention B={B} S={S} H={H} D={D} bf16 causal: wgmma kernel {ms:.4f} ms "
          f"(CUDA-core kernel {simt_ms:.4f} ms; plain {plain_ms:.3f} ms; "
          f"scaled_dot_product_attention {lib_ms:.4f} ms; bound "
          f"{flash['bound_ms']:.4f} ms by {flash['bound_by']}: {flops / 1e9:.1f} G flops "
          f"in {flops_ms:.4f} ms, {nbytes / 1e6:.1f} MB in {bytes_ms:.4f} ms; "
          f"{ms / flash['bound_ms']:.1f}x the bound; the kernel issues 1.5x the flops, "
          f"P V twice) [{card}]")

    step = make_prefill_step(cfg)
    batch = {"tokens": prompts(dev, cfg)}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_tok = batch["tokens"].numel()
    print(f"  prefill step 4 x 2048: {min(walls):.4f} s ({n_tok / min(walls):.1f} "
          f"tokens/s; runs {', '.join(f'{w:.4f}' for w in walls)} s) [{card}]")

    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)

    def decode(i):
        T.serve_step(cfg, params, {"tokens": tok, "cur_index": 2048 + i % 32}, cache)

    for i in range(2):
        decode(i)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    windows = []  # three windows of 10 back-to-back steps: the rate
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(10):
            decode(i)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 10 * 1e3)
    enq, walls = [], []  # 10 steps one at a time: host enqueue vs wall
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        walls.append((time.perf_counter() - t0) * 1e3)
    mem1 = torch.cuda.memory_stats()
    step_ms = float(np.median(windows))
    print(f"  serve_step, 4 rows over a {cache['k'].shape[2]}-row cache: {step_ms:.3f} "
          f"ms per step ({4e3 / step_ms:.1f} tokens/s), median of windows of 10 "
          f"steps: {', '.join(f'{w:.3f}' for w in windows)} ms [{card}]")
    print(f"  serve_step one at a time: wall min/median/max {min(walls):.3f} / "
          f"{float(np.median(walls)):.3f} / {max(walls):.3f} ms, host enqueue "
          f"{min(enq):.3f} / {float(np.median(enq)):.3f} / {max(enq):.3f} ms; over "
          f"the 40 steps: allocator retries "
          f"{mem1.get('num_alloc_retries', 0) - mem0.get('num_alloc_retries', 0)}, "
          f"cudaMalloc calls {mem1.get('num_device_alloc', 0) - mem0.get('num_device_alloc', 0)}, "
          f"reserved {mem0['reserved_bytes.all.current'] / 2**30:.2f} -> "
          f"{mem1['reserved_bytes.all.current'] / 2**30:.2f} GiB [{card}]")
    srv_rate = server["tokens"] / server["wall_s"]
    print(f"  Server (phase 9 run): {server['tokens']} generated tokens and "
          f"{server['prompt_tokens']} prompt tokens in {server['wall_s']:.3f} s: "
          f"{srv_rate:.2f} generated tokens/s [{card}]")

    traced_run("prefill step", lambda: step(params, batch), card)
    traced_run("serve_step", lambda: T.serve_step(cfg, params, {"tokens": tok,
                                                                "cur_index": 2048}, cache),
               card)
    return flash


# ---------------------------------------------------------------------------
# The int8 GEMM and SSD scan paths
# ---------------------------------------------------------------------------


def int8(g, shape, dev, lo=-128):
    import torch

    return torch.randint(lo, 128, shape, generator=g, device=dev, dtype=torch.int8)


def within(got, want, rtol, atol) -> tuple[float, float]:
    """(max abs error, share of the limit atol + rtol |want| used); a
    non-finite output uses the whole limit and more."""
    import torch

    diff = (got.float() - want.float()).abs()
    used = float((diff / (atol + rtol * want.float().abs())).max())
    if not bool(torch.isfinite(got.float()).all()):
        used = float("inf")
    return float(diff.max()), used


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def phase_gemm_kernels(dev) -> dict[str, float]:
    """Both int8 GEMM kernels against their plain versions on the card;
    returns the largest max abs error of each."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import kernel as QK
    from repro_torch.kernels.quant_matmul.ref import int_matmul, quant_matmul_ref

    errs = {"w8a8_matmul": 0.0, "w8a16_matmul": 0.0}
    lib = build.load("quant_matmul.cu").lib
    buf = torch.zeros((64,), dtype=torch.int8, device=dev)
    for off in range(16):
        ptr = buf[off:].data_ptr()
        for K in range(1, 301):
            if bool(lib.quant_matmul_w8a8_variant(K, ptr)) != (QK._variant(K, ptr) == "wgmma"):
                raise AssertionError(f"w8a8: _variant({K}, +{off}) != the C entry's rule")
    print("  ok the wrapper's W8A8 variant rule == quant_matmul_w8a8_variant for K 1..300 "
          "at 16 alignments")
    a_scale = torch.tensor([0.03], device=dev)

    def w8a8_exact(label, args):
        """Both W8A8 kernels where the rule picks wgmma, else the mma one,
        equal to the plain version in float32 and bfloat16 out."""
        variants = [QK._variant(args[0].shape[1], args[0].data_ptr())]
        variants += ["mma"] if variants[0] == "wgmma" else []
        for variant in variants:
            for out in (torch.float32, torch.bfloat16):
                got = QK.quant_matmul_kernel(*args, out_dtype=out, variant=variant)
                torch.cuda.synchronize()
                if not torch.equal(got, QK.quant_matmul_plain(*args, out_dtype=out)):
                    raise AssertionError(f"w8a8 {label} {variant} {out}: kernel != plain version")
        return "/".join(variants)

    for i, (label, M, K, N) in enumerate(GEMM_CASES):
        g = torch.Generator(device=dev).manual_seed(500 + i)
        a, w = int8(g, (M, K), dev), int8(g, (K, N), dev)
        ws8 = torch.rand((N,), generator=g, device=dev) * 0.099 + 0.001
        a_zp = torch.tensor([-5], dtype=torch.int32, device=dev)
        ran = w8a8_exact(label, (a, w, a_scale, a_zp, ws8))
        x = torch.randn((M, K), generator=g, device=dev)
        ws16 = torch.rand((N,), generator=g, device=dev) * 0.049 + 0.001
        worst = 0.0
        for x_dtype in (torch.float32, torch.bfloat16):
            for out in (torch.float32, torch.bfloat16):
                got = QK.w8a16_matmul_kernel(x.to(x_dtype), w, ws16, out_dtype=out)
                torch.cuda.synchronize()
                want = QK.w8a16_matmul_plain(x.to(x_dtype), w, ws16, out_dtype=out)
                rtol = W8A16_RTOL[str(out)[6:]]
                err, used = within(got, want, rtol, rtol * rms(want))
                if used > 1.0:
                    raise AssertionError(f"w8a16 {label} x {x_dtype} out {out}: kernel != "
                                         f"plain version (max abs err {err}, {used:.3f} of "
                                         f"the limit)")
                errs["w8a16_matmul"] = max(errs["w8a16_matmul"], err)
                worst = max(worst, used)
        print(f"  ok {label} M={M} K={K} N={N}: w8a8 ({ran}) == plain (float32 and bfloat16 out); "
              f"w8a16 (float32/bfloat16 x, float32/bfloat16 out) within rtol "
              f"{W8A16_RTOL}, atol rtol x rms: {worst:.3f} of the limit")
    for zp in (-37, 91):  # |acc| > 2^24: f32(acc) rounds, and one FMA differs
        g = torch.Generator(device=dev).manual_seed(600 + zp)
        a, w = int8(g, (64, 4096), dev, 90), int8(g, (4096, 512), dev, 90)
        ws8 = torch.rand((512,), generator=g, device=dev) * 0.099 + 0.001
        args = (a, w, a_scale, torch.tensor([zp], dtype=torch.int32, device=dev), ws8)
        acc_max = int(int_matmul(a, w).abs().max())
        ran = w8a8_exact(f"a_zp={zp}", args)
        got = QK.quant_matmul_kernel(*args)
        ref = quant_matmul_ref(*args)
        differ = int((got != ref).sum())
        print(f"  ok a_zp={zp}, max |acc| {acc_max} > 2^24: w8a8 ({ran}) == plain (float32 "
              f"and bfloat16 out); vs the int32-subtracting quant_matmul_ref {differ} of "
              f"{got.numel()} outputs differ, by at most "
              f"{float(((got - ref).abs() / ref.abs()).max()):.3g} relative")
    return errs


def phase_gemm_path(dev, tokens=(4, 2048), d=4096, d_ff=11008, head=(64, 1280, 1000)) -> dict:
    """``quant_linear`` and ``w8a16_linear`` on the full-width
    up-projection and the Logits head, with the launch counters zeroed
    around these four calls; each held to its plain path and, as in the
    reference tests, to the float linear."""
    import torch

    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.quant_matmul import kernel as QK
    from repro_torch.kernels.quant_matmul import ops as QO
    from repro_torch.kernels.quant_matmul.ref import int_matmul

    g = torch.Generator(device=dev).manual_seed(3)
    cases = {  # label: (x, float weights)
        "deepseek-7b up-projection": (
            torch.randn((*tokens, d), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((d, d_ff), generator=g, device=dev) * 0.02),
        # pooled ReLU6 features of 64 images: non-negative, so a_zp = -128
        "MobileNet-V2 Logits head": (
            torch.rand(head[:2], generator=g, device=dev) * 6,
            torch.randn(head[1:], generator=g, device=dev) * 0.05),
    }
    wq = {k: quantize(w, axis=1, symmetric=True) for k, (_, w) in cases.items()}
    torch.cuda.synchronize()
    QK.reset_launch_counts()
    outs = {k: (QO.quant_linear(x, wq[k]), QO.w8a16_linear(x, wq[k]))
            for k, (x, _) in cases.items()}
    torch.cuda.synchronize()
    launches = {"w8a8_matmul": QK.W8A8_LAUNCHES, "w8a16_matmul": QK.W8A16_LAUNCHES}
    by_variant = {"wgmma": QK.W8A8_WGMMA_LAUNCHES,
                  "mma": QK.W8A8_LAUNCHES - QK.W8A8_WGMMA_LAUNCHES}
    print(f"  path: quant_linear and w8a16_linear on {', '.join(cases)}: launches {launches}; "
          f"W8A8 by kernel {by_variant}")
    for kernel, n in launches.items():
        if n != len(cases):
            raise AssertionError(f"{kernel} was launched {n} times on the main path, "
                                 f"not {len(cases)}")
    if by_variant["wgmma"] != len(cases):
        raise AssertionError(f"W8A8 ran {by_variant} on the main path, not the wgmma kernel "
                             f"{len(cases)} times")
    for label, (x, w) in cases.items():
        y8, y16 = outs[label]
        K = x.shape[-1]
        shape = (*x.shape[:-1], w.shape[1])
        for name, y in (("quant_linear", y8), ("w8a16_linear", y16)):
            if tuple(y.shape) != shape or y.dtype != x.dtype \
                    or not bool(torch.isfinite(y.float()).all()):
                raise AssertionError(f"{label} {name}: bad output {tuple(y.shape)} {y.dtype}")
        # the kernel's own plain version on the same quantized activations:
        # exact at any |acc|; the integer path (quant_matmul_ref) too
        # while |acc| <= 2^24, where f32(acc) is exact
        xa = quantize(x.reshape(-1, K))
        acc_max = int(int_matmul(xa.values, wq[label].values).abs().max())
        kernel_plain8 = QK.quant_matmul_plain(
            xa.values, wq[label].values, xa.scale.reshape(1), xa.zero_point.reshape(1),
            wq[label].scale).reshape(shape).to(x.dtype)
        if not torch.equal(y8, kernel_plain8):
            raise AssertionError(f"{label}: quant_linear kernel path != the W8A8 kernel's "
                                 f"plain version")
        plain8 = QO.quant_linear(x, wq[label], use_kernel=False)
        integer_equal = torch.equal(y8, plain8)
        if acc_max <= 2 ** 24 and not integer_equal:
            raise AssertionError(f"{label}: quant_linear kernel path != integer path")
        plain16 = QK.w8a16_matmul_plain(x.reshape(-1, K), wq[label].values,
                                        wq[label].scale).reshape(shape).to(x.dtype)
        rtol = W8A16_RTOL[str(x.dtype)[6:]]
        err16, used16 = within(y16, plain16, rtol, rtol * rms(plain16))
        if used16 > 1.0:
            raise AssertionError(f"{label}: w8a16_linear kernel path != plain path")
        ref = x.float().reshape(-1, K) @ w
        rel8 = float((y8.float().reshape(ref.shape) - ref).norm() / ref.norm())
        rel16 = float((y16.float().reshape(ref.shape) - ref).norm() / ref.norm())
        print(f"  ok {label} x {tuple(x.shape)} {str(x.dtype)[6:]}: quant_linear == the "
              f"kernel's plain version; vs the integer path "
              f"{'equal' if integer_equal else 'not equal'} (max |acc| {acc_max}, "
              f"a_zp {int(xa.zero_point)}); "
              f"w8a16_linear vs plain path max abs err {err16:.3g} ({used16:.3f} of the "
              f"limit); relative error vs the float linear {rel8:.4f} (< 0.02) and "
              f"{rel16:.4f} (< 0.01)")
        if not (rel8 < 0.02 and rel16 < 0.01):
            raise AssertionError(f"{label}: quantized linear too far from the float linear")
    return {"launches": launches, "by_variant": by_variant,
            "x": cases["deepseek-7b up-projection"][0], "wq": wq["deepseek-7b up-projection"]}


def ssd_inputs(dev, B, S, H, ph, ds, dtype, seed):
    """Model-layout inputs drawn as the reference kernel test draws them."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, ph), generator=g, device=dev).to(dtype)
    b = (torch.randn((B, S, ds), generator=g, device=dev) * 0.5).to(dtype)
    c = (torch.randn((B, S, ds), generator=g, device=dev) * 0.5).to(dtype)
    dA = -F.softplus(torch.randn((B, S, H), generator=g, device=dev))
    dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev))
    return x, b, c, dA, dt


def fold_scan(x, b, c, dA, dt):
    """Model layout -> the kernels' folded layout, b and c kept per batch
    row (one group of H heads)."""
    B, S, H, ph = x.shape
    return (x.transpose(1, 2).reshape(B * H, S, ph).contiguous(), b, c,
            dA.transpose(1, 2).reshape(B * H, S).contiguous(),
            dt.transpose(1, 2).reshape(B * H, S).contiguous())


def check_scan(label, got, folded, chunk, dtype_name) -> float:
    """y (folded) against the chunked plain version and the sequential
    oracle; returns the max abs error against the plain version."""
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_plain
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    rtol, atol = SSD_TOL[dtype_name]
    err, used = within(got, ssm_scan_plain(*folded, chunk=chunk), rtol, atol)
    err_seq, used_seq = within(got, ssm_scan_ref(*folded), rtol, atol)
    if max(used, used_seq) > 1.0:
        raise AssertionError(f"ssd {label} {dtype_name}: kernel beyond tolerance (plain "
                             f"{err}, {used:.3f} of the limit; sequential {err_seq}, "
                             f"{used_seq:.3f})")
    print(f"  ok {label} {dtype_name} chunk {chunk}: vs chunked plain max abs err {err:.3g} "
          f"({used:.3f} of the limit), vs sequential oracle {err_seq:.3g} ({used_seq:.3f}); "
          f"rtol {rtol:.4g}, atol {atol}")
    return err


def phase_ssd(dev, B=4, S=2048, H=64, ph=64, ds=64, ragged=(2, 1000, 8)) -> dict:
    """``ssm_scan`` at full width, launch counter zeroed around the two
    calls; then the outputs and ragged cases against the plain version
    and the oracle."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ops as SO

    # default: one zamba2-1.2b Mamba2 layer (d_inner 4096 = 64 heads of 64)
    dtypes = (torch.float32, torch.bfloat16)
    inputs = {dt_: ssd_inputs(dev, B, S, H, ph, ds, dt_, 40) for dt_ in dtypes}
    torch.cuda.synchronize()
    SK.reset_launch_count()
    ys = {dt_: SO.ssm_scan(*inputs[dt_]) for dt_ in dtypes}
    torch.cuda.synchronize()
    launches = SK.SSD_LAUNCHES
    print(f"  path: ssm_scan B={B} S={S} H={H} ph={ph} ds={ds} float32 and bfloat16: "
          f"{launches} launches")
    if launches == 0:
        raise AssertionError("ssd_scan was not launched on the main path")
    err = 0.0
    for dt_ in dtypes:
        y = ys[dt_]
        if tuple(y.shape) != (B, S, H, ph) or y.dtype != dt_:
            raise AssertionError(f"ssm_scan: bad output {tuple(y.shape)} {y.dtype}")
        got = y.transpose(1, 2).reshape(B * H, S, ph)
        err = max(err, check_scan("full width (zamba2-1.2b layer)", got,
                                  fold_scan(*inputs[dt_]), 128, str(dt_)[6:]))
    for chunk in (128, 16):
        for dt_ in dtypes:
            folded = fold_scan(*ssd_inputs(dev, *ragged[:2], ragged[2], ph, ds, dt_, 41))
            got = SK.ssm_scan_kernel(*folded, chunk=chunk)
            err = max(err, check_scan(f"ragged S={ragged[1]} (B {ragged[0]}, H {ragged[2]})",
                                      got, folded, chunk, str(dt_)[6:]))
    for dt_ in dtypes:  # the widest state the kernels take, at chunk 128 and ph 64
        folded = fold_scan(*ssd_inputs(dev, 2, 300, 4, ph, 128, dt_, 42))
        got = SK.ssm_scan_kernel(*folded, chunk=128)
        err = max(err, check_scan("ds 128, ragged S=300 (B 2, H 4)", got, folded, 128,
                                  str(dt_)[6:]))
    # the kernels' arithmetic (rescaled rows, bf16 pieces) in plain PyTorch
    for dt_ in dtypes:
        folded = fold_scan(*inputs[dt_])
        mirror = SK.ssm_scan_pieces(*folded, chunk=128)
        check_scan("full width, the kernels' arithmetic mirrored (ssm_scan_pieces)", mirror,
                   folded, 128, str(dt_)[6:])
        got = ys[dt_].transpose(1, 2).reshape(B * H, S, ph)
        print(f"    kernel vs its mirror: max abs diff "
              f"{float((got.float() - mirror.float()).abs().max()):.3g}")
    return {"launches": launches, "err": err, "inputs": inputs}


def phase_quant_times(dev, card, gemm, ssd) -> dict:
    """Each kernel, its plain version and the PyTorch yardstick at the
    full-width shape, beside its bound; the ops' wall times."""
    import torch

    from repro_torch.kernels.quant_matmul import kernel as QK
    from repro_torch.kernels.quant_matmul import ops as QO
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ops as SO

    out = {}
    x, wq = gemm["x"], gemm["wq"]
    M, K = x.numel() // x.shape[-1], x.shape[-1]
    N = wq.values.shape[1]
    g = torch.Generator(device=dev).manual_seed(7)
    a, w = int8(g, (M, K), dev), wq.values
    a_scale = torch.tensor([0.03], device=dev)
    a_zp = torch.tensor([-5], dtype=torch.int32, device=dev)
    ws = wq.scale
    xb = x.reshape(M, K)

    def int_mm_epilogue():
        acc = torch._int_mm(a, w)
        colsum = w.sum(0, dtype=torch.int32)
        return (acc.float() - a_zp.float() * colsum.float()) * a_scale * ws

    try:  # the yardstick is only timed; where it refuses, it is left out
        int_mm_epilogue()
    except RuntimeError as err:
        print(f"  torch._int_mm refused {M} x {K} x {N}: {str(err)[:200]}")
        int_mm_epilogue = None

    def dequant_matmul():
        return xb.float() @ (w.float() * ws)

    def dequant_matmul_bf16():  # the same tensor cores: bf16 weights, bf16 GEMM, scale
        return (xb @ w.to(torch.bfloat16)).float() * ws

    flops = 2 * M * N * K
    work = {  # name: (kernel, plain, library, bytes moved, ops, peak)
        "w8a8_matmul": (lambda: QK.quant_matmul_kernel(a, w, a_scale, a_zp, ws),
                        lambda: QK.quant_matmul_plain(a, w, a_scale, a_zp, ws),
                        int_mm_epilogue, M * K + K * N + 4 * N + 8 + 4 * M * N,
                        flops, INT8_OPS_PER_S),
        "w8a16_matmul": (lambda: QK.w8a16_matmul_kernel(xb, w, ws),
                         lambda: QK.w8a16_matmul_plain(xb, w, ws), dequant_matmul_bf16,
                         2 * M * K + K * N + 4 * N + 4 * M * N, flops, BF16_FLOPS_PER_S),
    }
    B, S, H, ph = ssd["inputs"][torch.bfloat16][0].shape
    ds = ssd["inputs"][torch.bfloat16][1].shape[2]
    ck = 128
    n_chunks = -(-S // ck)
    # per chunk of r rows: C Bᵀ on the r (r + 1) / 2 pairs the causal mask
    # keeps, once per batch row (its H heads share B and C); per head, the
    # masked (C Bᵀ ∘ L)(dt x), C h and the state update Bᵀ(dt x). Each
    # product runs as bf16 piece products: with bf16 inputs C Bᵀ as one and
    # the rest as three (one operand float32); with float32 inputs six.
    rows = [min(ck, S - i * ck) for i in range(n_chunks)]

    def ssd_flops(cb_pieces, pieces):
        return sum(2 * B * (r * (r + 1) // 2 * ds * cb_pieces
                            + H * pieces * (r * (r + 1) // 2 * ph + 2 * r * ds * ph))
                   for r in rows)

    cuda_core_ms = ssd_flops(1, 1) / FP32_FLOPS_PER_S * 1e3
    folded = {}
    for dt_, (cb_pieces, pieces) in ((torch.bfloat16, (1, 3)), (torch.float32, (6, 6))):
        folded[dt_] = fold_scan(*ssd["inputs"][dt_])
        size = dt_.itemsize
        nbytes = size * (2 * B * H * S * ph + 2 * B * S * ds) + 4 * 2 * B * H * S
        work[f"ssd_scan {str(dt_)[6:]}"] = (
            lambda f=folded[dt_]: SK.ssm_scan_kernel(*f, chunk=ck),
            lambda f=folded[dt_]: SK.ssm_scan_plain(*f, chunk=ck), None, nbytes,
            ssd_flops(cb_pieces, pieces), BF16_FLOPS_PER_S)
    for name, (kernel, plain, library, nbytes, ops, peak) in work.items():
        plain_a = timed_ms(plain, 3)
        if name == "w8a8_matmul":  # in turns: wgmma, mma, mma, wgmma
            mma = lambda: QK.quant_matmul_kernel(a, w, a_scale, a_zp, ws, variant="mma")
            ms_a, mma_a = timed_ms(kernel, 10), timed_ms(mma, 10)
            mma_ms, ms = min(mma_a, timed_ms(mma, 10)), min(ms_a, timed_ms(kernel, 10))
        else:
            ms = timed_ms(kernel, 10)
        plain_ms = min(plain_a, timed_ms(plain, 3))
        lib_ms = None
        if library is not None:
            lib_ms = timed_ms(library, 10)
        if name == "w8a16_matmul":
            # the float32 yardstick beside the bf16 one, and float32 x: three
            # bf16 pieces, three times the bf16 products
            f32_ms, x32 = timed_ms(dequant_matmul, 10), xb.float()
            x32_ms = timed_ms(lambda: QK.w8a16_matmul_kernel(x32, w, ws), 10)
            print(f"  w8a16_matmul M={M} K={K} N={N} float32 x: {x32_ms:.4f} ms (bound "
                  f"{3 * ops / peak * 1e3:.4f} ms: three bf16 pieces); dequantize + float32 "
                  f"torch.matmul {f32_ms:.4f} ms (the PR 14 yardstick) [{card}]")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         library_ms=lib_ms)
        if name.startswith("ssd_scan"):
            shape = f"B={B} S={S} H={H} ph={ph} ds={ds} chunk {ck} {name[9:]}"
        else:
            shape = f"M={M} K={K} N={N}" + (" bf16 x" if name == "w8a16_matmul" else "")
        lib = "" if lib_ms is None else f"; PyTorch yardstick {lib_ms:.4f} ms"
        if name == "w8a16_matmul":
            lib = f"; dequantize-to-bf16 + bf16 torch.matmul + scale {lib_ms:.4f} ms"
        if name == "w8a8_matmul":
            out[name]["mma_ms"] = mma_ms
            lib += f"; the mma.sync kernel {mma_ms:.4f} ms"
        if name.startswith("ssd_scan"):
            out[name]["cuda_core_bound_ms"] = cuda_core_ms
            lib += (f"; the same flops once each on the float32 CUDA cores: "
                    f"{cuda_core_ms:.4f} ms")
        print(f"  {name.split()[0]} {shape}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}; bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}: {ops / 1e9:.1f} G "
              f"ops in {ops_ms:.4f} ms, {nbytes / 1e6:.1f} MB in {bytes_ms:.4f} ms; "
              f"{ms / out[name]['bound_ms']:.1f}x the bound) [{card}]")
    xs, bs, cs, dAs, dts = ssd["inputs"][torch.bfloat16]

    for label, fn in (("quant_linear", lambda: QO.quant_linear(x, wq)),
                      ("w8a16_linear", lambda: QO.w8a16_linear(x, wq)),
                      ("ssm_scan", lambda: SO.ssm_scan(xs, bs, cs, dAs, dts))):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  {label} whole call: {min(walls):.3f} ms (runs "
              f"{', '.join(f'{w_:.3f}' for w_ in walls)} ms) [{card}]")
    # where quant_linear's time goes beside its GEMM: quantizing the
    # activations (one traced run; later traces in the same process have
    # come back without device events on this machine)
    traced_run("quant_linear", lambda: QO.quant_linear(x, wq), card)
    return out


# ---------------------------------------------------------------------------
# The paper's solvers, the planner and degradation surfaces (phase 14)
# ---------------------------------------------------------------------------


def plans_equal(a, b) -> bool:
    """Every ``SplitPlan`` field but ``planner_time_s`` equal, plan by plan."""
    return len(a) == len(b) and all(
        replace(p, planner_time_s=0.0) == replace(q, planner_time_s=0.0)
        for p, q in zip(a, b))


def powered_links():
    """The paper's four protocols with radio powers, so energy binds."""
    from repro_torch.core import profiles as PP

    return {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2)
            for p, lk in PP.PROTOCOLS.items()}


def planner_fleet(profile, n_loss=8, n_rate=16):
    """4 protocols x ``n_loss`` loss rates x ``n_rate`` rate scales x
    fleets of 2-5 cost models of one graph (2,048 at the defaults) on
    powered ESP32s, and the per-model fleet sizes."""
    from repro_torch.core import profiles as PP
    from repro_torch.core.latency import SplitCostModel

    dev = replace(PP.ESP32, active_power_w=0.5)
    models, ns = [], []
    for base in powered_links().values():
        for lp in np.linspace(0.0, 0.3, n_loss):
            for rs in np.linspace(1 / 16, 1.0, n_rate):
                link = replace(base, loss_p=float(lp),
                               rate_bytes_per_s=base.rate_bytes_per_s * float(rs))
                for n in (2, 3, 4, 5):
                    models.append(SplitCostModel(profile=profile, devices=(dev,),
                                                 link=link))
                    ns.append(n)
    return models, ns


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def median_peak_energy(models, plans) -> float:
    """The median, over the feasible plans, of a plan's largest per-device
    energy: a per-device budget there binds about half of the plans."""
    peaks = []
    for m, p in zip(models, plans):
        if p.total_latency_s < float("inf"):
            efn = m.energy_segment_fn()
            peaks.append(max(efn(s.first_layer, s.last_layer, s.device)
                             for s in p.segments))
    return float(np.median(peaks))


def phase_plan_batch(card, floor=0.96) -> None:
    """(a) ``plan_split_batch`` on 2,048 MobileNet-V2 and 2,048 ResNet50
    cost models: the card (``backend=None``: the dense kernel) against the
    plain version on the CPU, float64 on the card against numpy, then a
    variant bank with an accuracy floor and an energy budget that binds
    about half of the plans."""
    import torch

    from repro_torch.core import cuda_dp as CD
    from repro_torch.core import profiles as PP
    from repro_torch.core.planner import plan_split_batch

    bank = PP.esp32_variant_bank()
    walls = {}
    for name, prof in (("mobilenet_v2", PP.mobilenet_cost_profile()),
                       ("resnet50", PP.resnet50_cost_profile())):
        models, ns = planner_fleet(prof)
        before = CD.DENSE_LAUNCHES
        got, walls[f"{name} card"] = timed_call(lambda: plan_split_batch(models, ns))
        if CD.DENSE_LAUNCHES != before + 1:
            raise AssertionError(f"plan_split_batch {name}: {CD.DENSE_LAUNCHES - before} "
                                 "dense launches, expected 1")
        plain, walls[f"{name} cpu"] = timed_call(
            lambda: plan_split_batch(models, ns, device="cpu"))
        if not plans_equal(got, plain):
            raise AssertionError(f"plan_split_batch {name}: card != device='cpu'")
        f64 = plan_split_batch(models, ns, dtype=torch.float64)
        oracle, walls[f"{name} numpy"] = timed_call(
            lambda: plan_split_batch(models, ns, backend="numpy"))
        if not plans_equal(f64, oracle):
            raise AssertionError(f"plan_split_batch {name}: card float64 != numpy")
        feasible = sum(p.total_latency_s < float("inf") for p in got)
        print(f"  plan_split_batch {name}: {len(models)} cost models (fleets 2-5), "
              f"{feasible} feasible; card == device='cpu' (float32), card float64 "
              f"== numpy; wall card {walls[f'{name} card']:.3f} s, cpu "
              f"{walls[f'{name} cpu']:.3f} s, numpy {walls[f'{name} numpy']:.3f} s [{card}]")
        budget = median_peak_energy(models, got)
        for label, kw in (("variant bank, floor", dict(variants=bank, accuracy_floor=floor)),
                          (f"energy budget {budget:.4g} J", dict(energy_budget=budget))):
            on_card, walls[f"{name} {label} card"] = timed_call(
                lambda: plan_split_batch(models, ns, **kw))
            if not plans_equal(on_card, plan_split_batch(models, ns, device="cpu", **kw)):
                raise AssertionError(f"plan_split_batch {name} {label}: card != cpu")
            moved = sum(p.splits != q.splits for p, q in zip(on_card, got))
            ok = sum(p.total_latency_s < float("inf") for p in on_card)
            extra = ""
            if "variants" in kw:
                counts = np.bincount([p.variant for p in on_card if p.variant is not None],
                                     minlength=len(bank))
                extra = f", plans by variant {counts.tolist()}"
            print(f"    {label}: card == device='cpu'; {ok} feasible, {moved} plans "
                  f"differ from the unconstrained ones{extra}; wall "
                  f"{walls[f'{name} {label} card']:.3f} s")


def surface_family_args(n_pt=32, n_loss=32):
    """MobileNet-V2 over the four protocols, 32 packet-time scales x 32
    loss rates (the refit floor joins each packet-time axis, a new row
    except where it is the nominal packet time: 4,192 nodes), fleets
    2-5."""
    from repro_torch.core import profiles as PP
    from repro_torch.core.latency import SplitCostModel

    model = SplitCostModel(profile=PP.mobilenet_cost_profile(),
                           devices=(replace(PP.ESP32, active_power_w=0.5),),
                           link=PP.ESP_NOW)
    return (model, powered_links(), (2, 3, 4, 5)), dict(
        pt_scale=tuple(float(x) for x in np.geomspace(1.0, 512.0, n_pt)),
        loss_p=tuple(float(x) for x in np.linspace(0.0, 0.3, n_loss)),
        solver="batched_dp")


def nodes_of(family):
    """{(n, protocol): surface arrays} of a surface family."""
    return {(n, name): (p.splits, p.chunk_bytes, p.latency_s, p.runner_splits,
                        p.runner_latency_s)
            for n, s in family.items() for name, p in s.protocols.items()}


def families_equal(a, b) -> bool:
    na, nb = nodes_of(a), nodes_of(b)
    return na.keys() == nb.keys() and all(
        all(np.array_equal(x, y) for x, y in zip(na[k], nb[k])) for k in na)


def fused_vs_dense_nodes(fused, dense, model, protocols) -> tuple[int, int, float]:
    """Nodes of two float32 builds (fused: f32(local) + f32(tx); dense:
    f32(local64 + tx64)) whose best plans differ, checked to be float32
    near-ties: each plan repriced in float64 at the node's own link within
    4 * N * eps32 of the other. Returns (differing nodes, nodes, the
    largest relative gap)."""
    from repro_torch.core import surface as SF

    differ = total = 0
    worst = 0.0
    for n, s in fused.items():
        tol = 4 * n * F32_EPS
        for name, p in s.protocols.items():
            q = dense[n].protocols[name]
            if not np.array_equal(np.isfinite(p.latency_s), np.isfinite(q.latency_s)):
                raise AssertionError(f"surfaces n={n} {name}: feasibility differs")
            for i, pt in enumerate(p.packet_time_s):
                for j, lp in enumerate(p.loss_p):
                    total += 1
                    a, b = p.node(i, j), q.node(i, j)
                    if a.splits == b.splits:
                        if a.__dict__ != b.__dict__:
                            raise AssertionError(f"surfaces n={n} {name}: same plan, "
                                                 "different node")
                        continue
                    differ += 1
                    m = replace(model, link=SF.refit_link(protocols[name], pt, lp))
                    ca = m.end_to_end_s(a.splits, with_overheads=False)
                    cb = m.end_to_end_s(b.splits, with_overheads=False)
                    gap = abs(ca - cb) / cb
                    worst = max(worst, gap)
                    if gap > tol:
                        raise AssertionError(f"surfaces n={n} {name} ({pt}, {lp}): plans "
                                             f"differ beyond a float32 tie ({gap})")
    return differ, total, worst


def phase_surface_family(card, budget=1.5) -> tuple:
    """(b) A DP surface family on the card: unbudgeted on the fused kernel
    (every launch on the tiled kernel), node-identical to the same build on
    the CPU; budgeted on the dense kernel, node-identical to
    ``backend="torch"``; the unbudgeted family against ``backend="torch"``
    within the fused/dense float32 tolerance. Returns the build's
    arguments."""
    from repro_torch.core import cuda_dp as CD
    from repro_torch.core.surface import build_surfaces

    args, kw = surface_family_args()
    walls = {}
    before = (CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES, CD.DENSE_LAUNCHES)
    fam, walls["fused card"] = timed_call(lambda: build_surfaces(*args, **kw))
    launched = (CD.FUSED_LAUNCHES - before[0], CD.FUSED_TILED_LAUNCHES - before[1],
                CD.DENSE_LAUNCHES - before[2])
    if launched != (1, 1, 0):
        raise AssertionError(f"unbudgeted surface family: (fused, tiled, dense) "
                             f"launches {launched}, expected (1, 1, 0)")
    nodes = fam[5].n_nodes
    plain, walls["fused cpu"] = timed_call(lambda: build_surfaces(*args, device="cpu", **kw))
    if not families_equal(fam, plain):
        raise AssertionError("unbudgeted surface family: card != device='cpu'")
    dense, walls["torch card"] = timed_call(lambda: build_surfaces(*args, backend="torch", **kw))
    _, walls["numpy"] = timed_call(lambda: build_surfaces(*args, backend="numpy", **kw))
    differ, total, worst = fused_vs_dense_nodes(fam, dense, args[0], args[1])
    print(f"  surface family: MobileNet-V2, {nodes} nodes x fleets {args[2]}; fused "
          f"kernel (1 launch, tiled) == device='cpu' node for node; vs "
          f"backend='torch': {differ} of {total} nodes differ, all float32 ties "
          f"(max relative gap {worst:.3g}); wall card {walls['fused card']:.3f} s, cpu "
          f"{walls['fused cpu']:.3f} s, torch on the card {walls['torch card']:.3f} s, "
          f"numpy {walls['numpy']:.3f} s [{card}]")
    before = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES
    fam_b, walls["budget card"] = timed_call(
        lambda: build_surfaces(*args, energy_budget=budget, **kw))
    if (CD.DENSE_LAUNCHES - before[0], CD.FUSED_LAUNCHES - before[1]) != (1, 0):
        raise AssertionError("budgeted surface family did not take one dense launch")
    twin, walls["budget torch card"] = timed_call(
        lambda: build_surfaces(*args, energy_budget=budget, backend="torch", **kw))
    if not families_equal(fam_b, twin):
        raise AssertionError("budgeted surface family: cuda != backend='torch'")
    moved = sum(int((x[0] != y[0]).any(axis=-1).sum())
                for x, y in zip(nodes_of(fam_b).values(), nodes_of(fam).values()))
    print(f"  budgeted family (E <= {budget} J): dense kernel == backend='torch' node "
          f"for node; the budget moved the plan of {moved} of {4 * nodes} nodes; wall "
          f"card {walls['budget card']:.3f} s, torch on the card "
          f"{walls['budget torch card']:.3f} s [{card}]")
    return args, kw


def phase_compare_solvers(card) -> None:
    """(c) The paper's Figs. 3-4 quantities: every scalar solver and the
    card's DP on MobileNet-V2 and ResNet50 over ESP-NOW at N 2-5."""
    from repro_torch.core import profiles as PP
    from repro_torch.core import solvers as SV
    from repro_torch.core.planner import compare_solvers, plan_split

    names = ("beam", "greedy", "first_fit", "random_fit", "brute_force", "optimal_dp")
    for model_name in ("mobilenet_v2", "resnet50"):
        model = PP.paper_cost_model(model_name, "esp_now")
        L = model.profile.num_layers
        fn = model.cost_segment_fn()
        for N in (2, 3, 4, 5):
            plans = compare_solvers(model, N, solvers=names)
            opt = plans["optimal_dp"].objective_cost_s
            if plans["brute_force"].objective_cost_s != opt:
                raise AssertionError(f"{model_name} N={N}: brute force "
                                     f"{plans['brute_force'].objective_cost_s} != "
                                     f"optimal_dp {opt}")
            dp, wall = timed_call(lambda: plan_split(model, N, solver="batched_dp"))
            if opt == float("inf"):  # no split fits the devices' memory
                if dp.objective_cost_s != opt or any(
                        p.objective_cost_s != opt for p in plans.values()):
                    raise AssertionError(f"{model_name} N={N}: a solver found a plan "
                                         "where the DP found none")
                print(f"  {model_name} N={N} esp_now: infeasible for every solver "
                      f"(segments exceed the ESP32's memory)")
                continue
            # the float32 cost within 4*N*eps32; the plan, repriced in
            # float64, optimal up to the reference tests' exact-tie bound
            # (tests/test_pallas_dp.py: |regret| <= 1e-12 relative)
            tol = 4 * N * F32_EPS
            regret = SV.total_cost(fn, dp.splits, L) - opt
            if abs(dp.objective_cost_s - opt) > tol * opt or abs(regret) > 1e-12 * opt:
                raise AssertionError(f"{model_name} N={N}: card DP {dp.objective_cost_s} "
                                     f"(repriced regret {regret}) vs optimum {opt}")
            rows = [(n, p.total_latency_s, p.objective_cost_s - opt, p.planner_time_s)
                    for n, p in plans.items()]
            rows.append(("batched_dp (card)", dp.total_latency_s, regret, wall))
            print(f"  {model_name} N={N} esp_now: " + "; ".join(
                f"{n} {lat:.4f} s (regret {reg:.3g} s, {t * 1e3:.1f} ms)"
                for n, lat, reg, t in rows))
    print(f"  brute force == optimal_dp everywhere; the card's DP cost within "
          f"4*N*eps32 of the optimum, its plan's float64 regret within 1e-12 "
          f"relative (an exact tie) [{card}]")


def phase_planner(card) -> dict:
    """Phase 14 with the launch counters zeroed just before it and read
    just after: both DP kernels must launch."""
    from repro_torch.core import cuda_dp as CD

    CD.reset_launch_counts()
    counts = {}

    def mark(path):
        counts[path] = (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES)

    print("  (a) plan_split_batch at full width")
    phase_plan_batch(card)
    mark("plan_split_batch")
    print("  (b) a DP surface family")
    args, kw = phase_surface_family(card)
    mark("surfaces")
    print("  (c) compare_solvers")
    phase_compare_solvers(card)
    mark("compare_solvers")
    launches = {"dense_dp": CD.DENSE_LAUNCHES, "fused_dp": CD.FUSED_LAUNCHES}
    tiled = CD.FUSED_TILED_LAUNCHES
    by_path, prev = {}, (0, 0, 0)
    for path, now in counts.items():
        by_path[path] = {"dense_dp": now[0] - prev[0], "fused_dp": now[1] - prev[1]}
        prev = now
    print(f"  (d) launches in this phase: {launches} (fused on the tiled kernel: "
          f"{tiled}); by path {by_path}")
    if not launches["dense_dp"] or not launches["fused_dp"] or tiled != launches["fused_dp"]:
        raise AssertionError("phase 14: a DP kernel was not launched (or a fused launch "
                             "left the tiled kernel)")
    from repro_torch.core.surface import build_surfaces

    trace = traced_run("surface family (fused)", lambda: build_surfaces(*args, **kw), card)
    if trace is not None:
        share = sum(ms for k, ms in trace["ops"].items() if "fused_dp" in k) / trace["busy_ms"]
        kernel_ms = share * trace["busy_ms"]
        print(f"  surface family: the fused kernel {kernel_ms:.4f} ms, its share of "
              f"device busy time {share:.4f}, of the wall {kernel_ms / trace['wall_ms']:.6f} "
              f"[{card}]")
    return {"launches": launches, "tiled": tiled, "by_path": by_path}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.sweep import sweep
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # float32 products in full float32 (no TF32; PyTorch's default, stated
    # here): the float32 plain attention of phase 6 and the Server's
    # float32 cache need it. The LM head's inputs are bfloat16 values,
    # which TF32 holds exactly.
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"== 1 device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(build.SIGNATURES)) as pool:
        libs = list(pool.map(build.load, build.SIGNATURES))
    print(f"== 2 build: {', '.join(f'{b.path.name} in {b.build_time_s:.2f} s' for b in libs)}"
          f" ({time.perf_counter() - t0:.2f} s wall, one nvcc per source in parallel)")
    for built in libs:
        for line in built.log.splitlines():
            if ("Used" in line and "registers" in line) or "Compiling entry" in line \
                    or "spill stores" in line or "C7511" in line:
                print("  " + line.strip())

    print("== 3 DP kernels against their plain versions on the card")
    errs = phase_kernels(dev)

    print("== 4 planning path")
    path = phase_main_path()

    print("== 5 planning times")
    times = phase_times(dev, card, path["launches"])
    phase_sweep(path["main"], card, path["per_sweep"][1])

    print("== 6 flash kernels (wgmma and CUDA-core) against their plain version on the card")
    errs["flash_attention"] = phase_flash(dev)

    print("== 7 serving path: prefill step at full width")
    cfg, twin, params = lm_setup(dev)
    pre = phase_prefill(dev, cfg, twin, params)

    print("== 8 serving path: cached prefill and decode")
    cached = phase_cached(dev, cfg, twin, params, pre["tol"])

    print("== 9 serving path: Server at full width")
    server = phase_server(params, cfg)
    flash_launches = pre["launches"] + sum(cached["counts"].values())
    wgmma_launches = pre["wgmma"] + sum(cached["wgmma"].values())

    print("== 10 serving times")
    times["flash_attention"] = phase_serving_times(dev, cfg, params, cached["cache"],
                                                   server, card)
    del params, cached  # 13.8 GB of weights and a 4.1 GB cache
    torch.cuda.empty_cache()

    print("== 11 int8 GEMMs: kernels against their plain versions, then the path")
    errs.update(phase_gemm_kernels(dev))
    gemm = phase_gemm_path(dev)

    print("== 12 SSD scan: the path, then the kernel against its plain version and "
          "the sequential oracle")
    ssd = phase_ssd(dev)
    errs["ssd_scan"] = ssd["err"]

    print("== 13 int8 GEMM and SSD scan times")
    times.update(phase_quant_times(dev, card, gemm, ssd))
    # the path's SSD timing is bfloat16's; float32's goes beside it
    f32 = times.pop("ssd_scan float32")
    times["ssd_scan"] = {**times.pop("ssd_scan bfloat16"), "f32_ms": f32["ms"],
                         "f32_bound_ms": f32["bound_ms"], "f32_plain_ms": f32["plain_ms"]}

    print("== 14 the paper's solvers, the planner and degradation surfaces on the card")
    planner = phase_planner(card)

    kernels = []
    by_variant = {"tiled": path["by_variant"]["tiled"] + planner["tiled"],
                  "per_scenario": path["by_variant"]["per_scenario"]
                  + planner["launches"]["fused_dp"] - planner["tiled"]}
    for name, line in (("dense_dp", 150), ("fused_dp", 170)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/split_dp.cu",
            "replaces": f"src/repro/core/pallas_dp.py:{line}",
            "launches": path["launches"][name] + planner["launches"][name],
            "launches_by_path": {"sweep": path["launches"][name],
                                 **{k: v[name] for k, v in planner["by_path"].items()}},
            "max_abs_err": errs[name], **times[name], "library_ms": None,
            **({"launches_by_variant": by_variant} if name == "fused_dp" else {}),
        })
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
        "launches": flash_launches, "max_abs_err": errs["flash_attention"],
        "launches_by_variant": {"wgmma": wgmma_launches,
                                "simt": flash_launches - wgmma_launches},
        **times["flash_attention"],
    })
    for name, source, replaces, launches in (
            ("w8a8_matmul", "quant_matmul.cu", "quant_matmul/kernel.py:31",
             gemm["launches"]["w8a8_matmul"]),
            ("w8a16_matmul", "quant_matmul.cu", "quant_matmul/kernel.py:123",
             gemm["launches"]["w8a16_matmul"]),
            ("ssd_scan", "ssm_scan.cu", "ssm_scan/kernel.py:40", ssd["launches"])):
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
            "max_abs_err": errs[name], **times[name],
            **({"launches_by_variant": gemm["by_variant"]} if name == "w8a8_matmul" else {}),
            # one launch = one call of the C entry, which runs three CUDA kernels
            **({"launch_is": "ssm_scan_fwd call (3 kernels)"} if name == "ssd_scan" else {}),
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
