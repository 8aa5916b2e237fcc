#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's planning path (``repro_torch``; nothing of JAX or of the
reference package ``repro``) on the card and fails on any fault:

1. device: the card's name and power limit, the torch and CUDA versions;
2. build: ``src/repro_torch/csrc/split_dp.cu`` with ``nvcc`` for sm_90a;
3. kernels against their plain PyTorch versions on the card (dense and
   fused x float32/float64 x sum/max, S = 4,099, tie-rich inputs with
   ~15% +inf and frozen rows, a heterogeneous ``bank_idx`` case): tables
   and parents exactly equal, and in float64 equal to the numpy oracle;
4. the main path: ``sweep()`` on a 32,768-scenario grid at full model
   width (MobileNet-V2, L = 54; ResNet50, L = 52; four protocols, fleets
   of 2-5 ESP32s, 32 loss rates x 32 rate scales), then a grid with
   heterogeneous device mixes and one with energy budgets (dense kernel),
   with the launch counters read around these three runs only. Each
   result equals the same sweep run on the plain versions; the float32
   fused path agrees with ``backend="torch"`` within a stated tolerance;
   float64 on the card equals ``backend="numpy"`` exactly;
5. times with CUDA events at S = 65,536, N = 5, L = 54, float32, beside
   each kernel's bound; the main-path sweep's scenarios/s and wall time,
   and a profiled run's device busy time and idle share;
6. a JSON line of per-kernel results, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no card is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
        errs["fused_dp"] = max(errs["fused_dp"], check_tables(
            f"fused_dp {tag}{' bank_idx' if bank_idx is not None else ''}",
            CD.fused_dp(*args), CD.fused_dp_plain(*args), oracle))
        print(f"  ok {tag}: dense and fused == plain"
              f"{' == numpy oracle' if f64 else ''}")
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
    per_sweep = (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES)
    res_mixes = sweep(mixes)
    res_budgets = sweep(budgets)
    launches = {"dense_dp": CD.DENSE_LAUNCHES, "fused_dp": CD.FUSED_LAUNCHES}
    print(f"  main path: {main.size} + {mixes.size} (device mixes) + "
          f"{budgets.size} (energy budgets) scenarios; launches {launches}; "
          f"the {main.size}-scenario sweep alone: dense {per_sweep[0]}, "
          f"fused {per_sweep[1]}")
    for kernel, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kernel} was not launched on the main path")
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
    return {"launches": launches, "per_sweep": per_sweep, "main": main}


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
    return out


def phase_sweep(grid, card, fused_per_sweep) -> None:
    """The main-path sweep at steady state (kernel built, card warm): its
    own timing split, the whole call's wall time, and a traced run's
    device busy time by operation and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sweep import sweep

    t0 = time.perf_counter()
    res = sweep(grid)
    wall = time.perf_counter() - t0
    print(f"  sweep {res.n_scenarios} scenarios: {res.scenarios_per_sec:.1f} "
          f"scenarios/s, build_time_s {res.build_time_s:.4f}, solve_time_s "
          f"{res.solve_time_s:.4f}, whole call {wall:.4f} s; fused launches "
          f"per sweep {fused_per_sweep} [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(grid)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if busy_ms == 0.0:
        print("  traced sweep: device time not measured (the profiler saw no "
              "device events)")
        return
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in ops[:5])
    print(f"  traced sweep: wall {traced:.4f} s, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / 1e3 / traced:.4f} [{card}]")
    print(f"  device time by op: {top}")


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
    card = card_line()
    print(f"== 1 device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    built = build.load()
    print(f"== 2 build: {built.path.name} in {built.build_time_s:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    print("== 3 kernels against their plain versions on the card")
    errs = phase_kernels(dev)

    print("== 4 main path")
    path = phase_main_path()

    print("== 5 times")
    times = phase_times(dev, card, path["launches"])
    phase_sweep(path["main"], card, path["per_sweep"][1])

    kernels = []
    for name, line in (("dense_dp", 150), ("fused_dp", 170)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/split_dp.cu",
            "replaces": f"src/repro/core/pallas_dp.py:{line}",
            "launches": path["launches"][name], "max_abs_err": errs[name],
            **times[name], "library_ms": None,
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
