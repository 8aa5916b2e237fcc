#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths (``repro_torch``; nothing of JAX or of the
reference package ``repro``) on the card and fails on any fault:

1. device: the card's name, power limit and clocks (SM, memory, maximum
   SM; read again before phase 15 and at the end), the torch and CUDA
   versions;
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
   1,000-row kv, D 160 with ragged Sq, D 256, both full-width shapes
   the serving path launches (4 x 2048 x 32 x 128 over 2,048 kv rows, and
   over the 2,080-row cache) and granite-34b's prefill (2 x 1024, 48 query
   heads on one kv head: group 48), within the reference kernel test's
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
15. the planner tier, online replanning and the fleet gateway on the card,
   with the launch counters read around this phase only (both DP kernels
   must launch; the counts by path must add up to the phase's totals):
   (a) phase 14's two 2,048-model batches through
   ``PlannerService().plan(models_spec(...))`` and its JSON round trip,
   equal to the kwargs call; ``solve_from_json`` on a ``tensor_spec``
   over the MobileNet-V2 batch's stacked ``C`` equal to
   ``PlannerService().solve``; a ``backend="pallas"`` spec refused;
   (b) ``fleet_managers(solver="optimal_dp")`` for fleets 2-5 on the
   default surface axes with a ``ManualExecutor``, on the card (float32)
   and on ``device="cpu"``, through one drift trace (1x, 100x, 2000x
   nominal, back to 1x): equal decision histories and families, every
   rebuilt family equal to ``build_sync`` of its request, the dense
   launches equal to the exact re-solves and the fused ones to the
   builds; (c) ``surface_parity_report`` empty in float64 on the card,
   and in float32 every differing node a float64 tie; (d) a
   ``FleetGateway`` (``solver="optimal_dp"``) at ``gateway_load.py``'s
   full size, 10,000 sessions over fleets 2-5: registration, 3 waves of
   observes, tokens on 2,000 sessions, a 10% storm on the background
   thread until every drifted session adopted, the audits (no stale
   adoption, one shared rebuilder, QoS percentiles == numpy), the fused
   launches equal to the family build plus the thread's rebuilds, and a
   traced storm in a fresh ``spawn`` process (device busy time, idle
   share); (e) one rebuild on
   a ``spawn`` process pool with ``device="cuda"``, node-identical to the
   thread-built family. Every step's wall time beside its
   ``backend="numpy"`` twin;
16. split execution of the paper's CNNs on the card, with the launch
   counters read around this phase only (the dense DP kernel must
   launch, the fused one must not): (a) ``plan_split(solver="batched_dp")``
   for MobileNet-V2 and ResNet50 over ESP-NOW at N 2-5, each plan equal
   to the same call on ``device="cpu"`` (float32), and the quickstart's
   beam plan; (b) MobileNet-V2 0.35 and ResNet50 at 224 px with seeded
   weights and inputs, at batch 1 and 64: ``run_split`` without the wire
   at every feasible plan's splits, the beam plan's and MobileNet-V2's
   paper cuts (7, 48, 51) ``torch.equal`` to ``run_unsplit``; the card
   within 1e-4 x rms of the CPU on the same weights and input (the share
   of the limit used); with the int8 wire every hop record (boundary,
   bytes, packets, modeled seconds) equal to the CPU run's, at batch 1
   the paper cuts' bytes 175,616 / 2,744 / 5,488, and top-1 agreement
   with the unsplit output; (c) medians of CUDA-event-timed calls:
   unsplit ms, images/s and TFLOP/s at both batches, the wire-split run
   and its encode + decode per hop, and a traced batch-1 forward with
   the wire in a fresh ``spawn`` process (idle share, device ms by class:
   convolutions, GEMM, quantization, the rest);
17. the rest of LM serving at full width, bf16, seeded random weights
   made on the card, one config at a time: stablelm-12b (parallel
   residual), granite-moe-1b-a400m and qwen3-moe-235b-a22b (MoE; the
   latter cut to 4 of 94 layers), minicpm3-4b (MLA), musicgen-medium
   (audio codes), qwen2-vl-72b (vision embeds, M-RoPE, the int8 KV cache;
   cut to 8 of 80 layers), granite-34b (MQA: 48 query heads on one kv
   head, GELU MLP; cut to 16 of 88 layers), each with
   ``use_flash_kernel=True`` beside its
   plain-attention twin (``False``): (a) ``make_prefill_step`` on 2 x 1024
   with the flash launches counted (one wgmma launch a layer, 0 for MLA,
   which runs the chunked core directly as the reference does) and every
   layer's attention output held to ``plain_attention`` on its q, k, v
   within the flash contract's full-width bf16 limit; (b) the
   last-position logits against the twin's within 0.25 x std (MoE: the
   twin takes the kernel run's expert picks, hence its keep mask,
   computes its own gates, and the tolerance is the larger of 0.25 and
   the root-sum-square of the per-layer relative attention errors of (a);
   the picks the twin's own router would have changed are printed);
   (c) ``prefill`` into a 1024 + 16 cache and 16 greedy ``serve_step``s,
   the twin fed the same inputs (greedy picks equal wherever its top-two
   gap is decisive); qwen2-vl's int8 codes and scales written by the card
   equal the CPU quantizer's on the same k and v, bit for bit; minicpm3's
   absorbed decode against the unabsorbed path each step; (d) ``Server``
   on the five token-frontend configs, 5 staggered requests, each equal
   to serving it alone (MoE: at a capacity factor of E / top_k, where no
   expert drops); (e) peak memory, prefill s and tokens/s, ms per
   ``serve_step``, flash / plain / SDPA ms at each prefill shape beside the
   bound, and one traced ``serve_step`` per config in a fresh ``spawn``
   process (idle share);
18. pipeline planning and the example twins on the card: (a)
   ``plan_pipeline`` on every config's full-size ``arch_layer_graph``
   (batch 8 x 1,024 tokens) over H100 stages at 2, 4 and 8 stages on
   NVLink and InfiniBand, beam and the exact DP: the splits and the
   bottleneck, both solvers infeasible together where the weights do not
   fit (qwen3-moe at 2 and 4 stages, qwen2-vl at 2), the DP never above
   the beam and the beam within 1.02 x the DP except on qwen2-vl's memory
   cliff at 4 and 8 stages (printed with its ratio), the host walls; (b)
   the four example twins (``torch_fleet_sweep``,
   ``torch_adaptive_replanning``, ``torch_pareto_frontier``,
   ``torch_serve_split_llm``) on ``cuda`` while a ``spawn`` worker runs
   them on ``cpu``: every printed line equal (walls masked), the served
   tokens, hops and hop seconds equal (else the first differing
   ``serve_step`` and the CPU's top-two logit gap there), and the DP
   launches around the card run, by twin (fused: the sweeps; dense: the
   fleet twin's energy-budget grid; the adaptive twin's managers solve
   with the beam on the host, as the reference example's do);
19. the SSM and hybrid models at full depth and width, seeded random
   weights made on the card in bf16 and, from the same draws, in
   float32, ``use_flash_kernel=True``, one config at a time: zamba2-1.2b
   (38 layers: 33 Mamba2, d_inner 4,096 = 64 heads of 64, ds 64, chunk
   128, and one shared attention block applied at 5 positions, 32 heads
   of 64) and xlstm-1.3b (42 mLSTM, 6 sLSTM, 4 heads of 1,024, chunk
   512): (a) the bf16 ``make_prefill_step`` on 2 x 1024 with the SSD
   launches (one per Mamba2 layer, 33) and the flash launches (5, all
   wgmma) counted, every Mamba2 scan's float32 y held to the reference's
   chunk body on the card on its own inputs within the SSD contract and
   every shared-attention call to ``attention_ref`` within the flash
   contract; (b) the logits against the twin (the chunk body, chunked
   attention: no kernel) in float32 within 2.5e-3 x std (the
   root-sum-square of the path's kernel contracts), and in bf16 printed
   beside the gap from halving ``scan_chunk`` (equally valid bf16 orders
   of zamba2 differ 0.2-0.7 x std at random init); (c) a 128-token prompt
   fed token by token through ``serve_step`` (no launch): every Mamba2
   and mLSTM layer's streamed outputs against its chunked form on the
   same inputs within 2.5e-3 x rms (float32), and the last logits against
   the uncached forward at position 127, held in float32 where halving
   the chunk moves the forward less than the tolerance (zamba2; xlstm's
   stack turns float32 rounding into several std), bf16 printed; (d)
   ``Server`` at ``reduced()`` size in float32, card tokens == CPU tokens
   (the CPU run's smallest top-two gap printed), and at full width 2
   requests with tokens/s (a request beside another need not equal it
   alone: the recurrent steps ignore positions, as the reference's); (e)
   the prefill step's wall and tokens/s, ms per ``serve_step`` over 16
   steps, peak memory, the SSD kernel and flash at the prefill shapes
   beside their bounds, and traced ``serve_step``s (and zamba2's prefill
   step) in a fresh ``spawn`` process (idle share);
20. training (``repro_torch.optim``, ``launch.steps.make_train_step``,
   ``checkpoint.store``, ``runtime.train_loop.Trainer``,
   ``runtime.compression``): (a) for each of the ten configs at
   ``reduced()`` size in float32, microbatch 0's loss and gradients and
   one ``make_train_step`` over 2 microbatches on the card against the
   CPU on the same seeded weights and batch (the MoE configs replay the
   CPU run's expert picks): loss within 1e-5 relative, gradients within
   1e-4 x each leaf's largest |value| (microbatch 0's; the step's first
   moment too, plus a bf16 accumulator's roundings:
   ``accumulator_roundings``; the share of 1e-4 x rms printed beside),
   updated parameters within the larger of 1e-4 x rms and what the
   gradient bound can move a first AdamW step, wherever the update's
   sign is determined (|g| > 2 x that bound; the rest, under 1%, counted,
   each within 2 lr: ``step_used``), no flash or SSD launch around the
   step, and zamba2's prefill after it one SSD launch per Mamba2 layer;
   both kernel ops raise on grad-requiring CUDA inputs; (c) deepseek-7b
   at full width (2 of 30 layers, bf16): one microbatch's gradients with
   remat == without, bit for bit, and the peak memory of each; (d) int8
   compression of a full-width gradient leaf on the card == the CPU bit
   for bit, ``wire_bytes`` > 3.9x, one compressed step finite; (b) the
   ``Trainer`` at full width (bf16 params, float32 moments, 8
   microbatches of 1 x 2,048, remat): 4 steps without a restart (stopped
   before a fifth, so it saves nothing), then 4 with ``ckpt_every=2``
   killed at step 3 and resumed from step 2's checkpoint:
   the losses equal within rel_tol 1e-5 (bit-equality printed); the step
   wall, tokens/s, peak memory and 6 N tokens / wall against the bf16
   peak; (e) ``examples/torch_train_pipeline_lm.py`` at its defaults:
   ``LEARNING``, the resume line, the plans;
21. the multi-device layer (``core.shard``, ``parallel.pipeline``):
   (a) the sharded backend in one process at phase 5's shape (S 65,536,
   N 5, L 54, float32, per-scenario fleet sizes), every card a shard:
   ``sharded_optimal_dp``, ``batched_optimal_dp(backend="sharded")`` and
   the all-k solve each node-identical to ``backend="cuda"`` (splits,
   costs, feasibility; differing nodes printed, 0 required), and
   ``sweep(backend="sharded")`` on phase 4's main grid equal to
   ``backend="torch"`` (the same dense recurrence on the same ``C``),
   with the dense launches of these calls counted; (b) the distributed
   seam: 4 ranks (``torch.multiprocessing`` spawn, gloo, a
   ``MeshSpec(kind="distributed", coordinator="127.0.0.1:<free port>")``)
   on ``cuda:{rank % count}`` solve S 16,387 (padded to 16,388), N 5, L
   54 with per-scenario fleet sizes; every rank's result equals the
   single-process ``backend="cuda"`` solve node for node, and rank 0
   prints the ranks' dense launches; a failed rank fails the phase; (c)
   the pipeline at deepseek-7b's full width (d 4096, 32 heads of 128,
   d_ff 11,008, bf16, flash kernel; 8 of 30 layers) over 4 stages on the
   card, plans ``uniform_split(8, 4)`` and ``(3, 5, 7)``, 8 microbatches
   of 1 x 2,048 embedded tokens: the outputs bit-equal to the same 8
   blocks in order per microbatch, the flash launches equal to ticks x
   stages x max depth (88 and 132), the per-tick ring payload beside the
   plan's ``boundary_act_bytes``, the wall and tokens/s of each plan;
22. the launch tooling (``parallel.sharding``, ``launch.mesh``,
   ``launch.steps.build_cell``, ``launch.dryrun``) and the pipeline's
   gradients: (a) deepseek-7b's cells at full width on a 1 x 1 ("data",
   "model") mesh over a one-rank NCCL group (an in-memory store, no
   rendezvous), every argument laid out by its sharding: prefill_32k
   (30 layers, 32,768 tokens, batch cut from 32 to 1: 30 flash launches,
   all wgmma), decode_32k (a 32,768-row cache of random rows, batch cut
   from 128 to 2: 32.2 GB of bf16 cache) and train_4k (4 of 30 layers,
   batch cut from 256 to 8: 8 microbatches of 1 x 4,096, the cell's
   ``accum_shardings``), each bit-equal to the same step without a mesh
   on the same weights and inputs (the train step on a copy: loss, norm,
   weights and moments, as the step returns them, gathered whole), each
   wall beside the meshless step's, and the peak allocated bytes beside
   ``run_cell``'s argument bytes on this mesh and what it counts the step
   as holding beyond them (``launch.steps.gathered_bytes``); on this mesh
   the tensor-parallel plan is the identity (a "model" axis of one rank)
   and no collective runs;
   (b) in ``spawn`` processes that hold the fake backend (run beside (a)
   and (c); the main process never holds it), ``run_cell`` for every
   config x its applicable shapes on both production meshes: 64 records,
   each one's per-device argument, resident and step bytes (the step's:
   with what it gathers), its counts (``parallel.op_analysis``): flops
   (products and the rest), bytes accessed, collectives by kind with
   their ring wire bytes, ``temp_bytes``, and ``fits`` on step + temp
   against the card's ``total_memory``, with the totals; (c)
   deepseek-7b's blocks at full width (4 of 30, bf16,
   attention on the chunked core as in training) through the pipeline over
   2 stages, 4 microbatches of 1 x 2,048: every stacked weight's gradient
   within 2 (M - 1) u sum_m |g_m| of the blocks in order's, the input's
   bit-equal, 0 flash launches; the group form refuses autograd on the
   one-rank group and, under ``no_grad``, equals the blocks in order;
   (d) (a)'s prefill_32k cell once more under the op counter on the card
   (30 more flash launches) against the same cell counted on ``meta``
   tensors over a one-rank fake world in one more ``spawn`` process:
   flops, bytes, collectives and kernel ops equal, the card's peak above
   the call's start within ``COUNTED_PEAK_BAND`` of the trace's peak;
23. the reference's tensor-parallel compute plan at full width
   (``parallel.tensor_parallel``): deepseek-7b's cells (d 4,096, 32
   heads, ff 11,008, vocab 102,400, bf16) over gloo ranks that share the
   card (tcp on a free port; NCCL refuses two ranks on one GPU, so every
   collective is staged through the host), each against the meshless
   step on the same weights and inputs, run first in this process and
   freed before the spawn, within the bounds of ``TP_ULP``'s note:
   prefill_32k (batch cut from 32 to 1), decode_32k (batch cut from 128
   to 2, a random 32,768-row cache made layer by layer, each rank keeping
   its heads) and train_4k (batch 2 of 256 as 2 microbatches of 1 x
   4,096) on a (1, 2) ("data", "model") mesh of ranks 0 and 1, then
   prefill_32k at batch 2 on a (2, 2) mesh of all 4 ranks of one spawn,
   every cell cut to 4 of 30 layers; run on the card while phase 22's
   dry-run processes finish; the weights made in turns (one rank at a
   time holds the whole model while it takes its shards); the prefill
   cells' flash launches, 4 a rank, all wgmma, on H / m = 16 local heads;
   per rank the cell's wall, peak memory and the collectives' count,
   bytes and wall by kind;
24. a JSON line of per-kernel results (the DP rows' launches by path
   with ``"examples"`` and ``"sharded"``; flash with granite-34b's and
   zamba2's launches and their prefill shapes' times, ``"pipeline"``,
   ``"build_cell"``, ``"counted_cell"`` and ``"tensor_parallel"``;
   the SSD scan's launches by path and its time at zamba2's prefill
   shape; ``"training"``: 0 for both), the card's memory size, the card
   line, and the last line ``{"ok": true, "device": {...}}``.

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
from types import SimpleNamespace

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


def smi(fields: str) -> str:
    """The first card's ``fields`` as ``nvidia-smi --query-gpu`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, and its SM clock, memory clock and
    maximum SM clock when read: printed beside every number kept."""
    return smi("name,power.limit,clocks.sm,clocks.mem,clocks.max.sm")


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
        # granite-34b's prefill: MQA, 48 query heads on one kv head
        ("full width (granite-34b prefill, group 48)", 2, 1024, 1024, 48, 1, 128, None),
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


def serve_requests(params, cfg, reqs, slots=4, max_seq=128, stagger=True, server=None):
    """Serve ``reqs`` [(rid, prompt, max_new)] on a fresh ``Server`` (or
    ``server``, a subclass); staggered: two at a time, with ticks between
    the admissions."""
    from repro_torch.runtime.server import Request, Server

    srv = (server or Server)(cfg, params, slots=slots, max_seq=max_seq)
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
    Returns the wall and busy ms, the device ms by kernel, and by host op
    with the ops inside it (``None`` when the trace holds no device
    events)."""
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
    # kernels only: a ``record_function`` range also comes back as a device
    # event (a user annotation) spanning the kernels inside it
    ops = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
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
            "ops": {e.key: e.self_device_time_total / 1e3 for e in ops},
            # each host op or annotated range: the device time of the
            # kernels it and the ops inside it launched
            "by_cpu_op": {e.key: e.device_time_total / 1e3 for e in events
                          if e.device_type == DeviceType.CPU}}


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


def ssd_work(B, S, H, ph, ds, ck, dtype) -> tuple[int, int, int]:
    """(bytes, bf16 piece flops, plain flops) of one scan call: x, b, c of
    ``dtype``, float32 dA, dt read once and y written once; per chunk of
    r rows C Bᵀ on the r (r + 1) / 2 pairs the causal mask keeps, once per
    batch row (its H heads share B and C), and per head the masked (C Bᵀ
    ∘ L)(dt x), C h and the state update Bᵀ(dt x). Each product runs as
    bf16 piece products: with bf16 inputs C Bᵀ as one and the rest as
    three (one operand float32); with float32 inputs six."""
    import torch

    rows = [min(ck, S - i * ck) for i in range(-(-S // ck))]
    cb_pieces, pieces = (1, 3) if dtype == torch.bfloat16 else (6, 6)

    def flops(cb, per_head):
        return sum(2 * B * (r * (r + 1) // 2 * ds * cb
                            + H * per_head * (r * (r + 1) // 2 * ph + 2 * r * ds * ph))
                   for r in rows)

    nbytes = dtype.itemsize * (2 * B * H * S * ph + 2 * B * S * ds) + 4 * 2 * B * H * S
    return nbytes, flops(cb_pieces, pieces), flops(1, 1)


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
    cuda_core_ms = ssd_work(B, S, H, ph, ds, ck, torch.float32)[2] / FP32_FLOPS_PER_S * 1e3
    folded = {}
    for dt_ in (torch.bfloat16, torch.float32):
        folded[dt_] = fold_scan(*ssd["inputs"][dt_])
        nbytes, flops, _ = ssd_work(B, S, H, ph, ds, ck, dt_)
        work[f"ssd_scan {str(dt_)[6:]}"] = (
            lambda f=folded[dt_]: SK.ssm_scan_kernel(*f, chunk=ck),
            lambda f=folded[dt_]: SK.ssm_scan_plain(*f, chunk=ck), None, nbytes,
            flops, BF16_FLOPS_PER_S)
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


# ---------------------------------------------------------------------------
# The planner tier, online replanning and the fleet gateway (phase 15)
# ---------------------------------------------------------------------------

# one MobileNet-V2 cut's activation: the hop the gateway benchmark meters
NBYTES = 5488
# benchmarks/gateway_load.py's full mode: its surface axes, 10,000
# sessions, 3 waves of observes, tokens on 2,000 sessions, a 10% storm at
# 100x nominal (one EWMA step lands at 20.8x: off the 16x surface)
GATEWAY_GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}
GATEWAY_SESSIONS = 10_000
GATEWAY_SIZES = (2, 3, 4, 5)
STEADY_WAVES = 3
TOKEN_SESSIONS = 2_000
TOKENS_PER_SESSION = 2
STORM_FACTOR = 100.0
ADOPTION_TIMEOUT_S = 120.0
# the traced storm drifts another 10% of the fleet past the surfaces the
# first storm built (re-centred up to about 83x)
TRACED_STORM_FACTOR = 10_000.0
# the replanning trace of (b): (factor x nominal hop latency, steps). The
# default surface reaches 512x: 100x stays on it, 2000x leaves it
REPLAN_TRACE = ((1.0, 3), (100.0, 6), (2000.0, 6), (2000.0, 6), (1.0, 30), (1.0, 4))


def batched_equal(a, b) -> bool:
    """Two ``BatchedSolverResult``s equal in every field but the wall time."""
    arrays = ("splits", "cost_s", "feasible", "n_devices_s", "variant")
    return (a.solver, a.backend, a.n_devices) == (b.solver, b.backend, b.n_devices) and all(
        (getattr(a, k) is None and getattr(b, k) is None)
        or np.array_equal(getattr(a, k), getattr(b, k)) for k in arrays)


def phase_spec_tier(card) -> None:
    """(a) The spec tier on phase 14's batches: ``PlannerService().plan``
    on a ``models_spec`` (and on its JSON round trip) equal to the kwargs
    call on the card; ``solve_from_json`` on a ``tensor_spec`` over the
    MobileNet-V2 batch's stacked ``C`` equal to ``PlannerService().solve``;
    a spec naming ``backend="pallas"`` refused. Each wall beside its
    ``backend="numpy"`` twin."""
    from repro_torch.core import profiles as PP
    from repro_torch.core import sweep as SW
    from repro_torch.core.planner import plan_split_batch
    from repro_torch.core.spec import (PlannerService, PlanSpec, models_spec,
                                       solve_from_json, tensor_spec)

    for name, prof in (("mobilenet_v2", PP.mobilenet_cost_profile()),
                       ("resnet50", PP.resnet50_cost_profile())):
        models, ns = planner_fleet(prof)
        kwargs, t_kw = timed_call(lambda: plan_split_batch(models, ns))
        spec = models_spec(models, n_devices=ns)
        via_spec, t_spec = timed_call(lambda: PlannerService().plan(spec, models))
        again, t_json = timed_call(
            lambda: PlannerService().plan(PlanSpec.from_json(spec.to_json()), models))
        _, t_np = timed_call(lambda: plan_split_batch(models, ns, backend="numpy"))
        if not (plans_equal(via_spec, kwargs) and plans_equal(again, kwargs)):
            raise AssertionError(f"spec tier {name}: PlannerService().plan != kwargs call")
        print(f"  {name}: PlannerService().plan(models_spec) == plan_split_batch (kwargs) "
              f"== the spec's JSON round trip, {len(models)} cost models; wall kwargs "
              f"{t_kw:.3f} s, spec {t_spec:.3f} s, JSON spec {t_json:.3f} s, numpy twin "
              f"{t_np:.3f} s [{card}]")
    models, ns = planner_fleet(PP.mobilenet_cost_profile())
    C = SW.stack_cost_tensors(models, ns)
    spec = tensor_spec(C, n_devices=ns)
    in_proc, t_in = timed_call(lambda: PlannerService().solve(spec, C))
    via_json, t_json = timed_call(lambda: solve_from_json(spec.to_json(), C))
    if not batched_equal(via_json, in_proc):
        raise AssertionError("solve_from_json != PlannerService().solve")
    _, t_np = timed_call(lambda: SW.solve_batched(C, backend="numpy", n_devices=ns))
    print(f"  tensor_spec over the stacked C {C.shape} ({C.nbytes / 1e6:.1f} MB float64): "
          f"solve_from_json == PlannerService().solve; wall {t_json:.3f} s, in process "
          f"{t_in:.3f} s, numpy twin {t_np:.3f} s [{card}]")
    refused = None
    try:
        PlannerService().solve(tensor_spec(C[:8], backend="pallas"), C[:8])
    except ValueError as e:
        refused = str(e)
    if refused is None or "not ported" not in refused:
        raise AssertionError(f"a backend='pallas' spec was not refused by name ({refused})")
    print(f"  a spec naming backend='pallas' is refused: {refused}")


def replan_fleet(**kw):
    """MobileNet-V2 managers (``solver="optimal_dp"``) for fleets of 2-5 on
    the default surface axes, sharing one rebuilder on a ``ManualExecutor``."""
    from repro_torch.core import profiles as PP
    from repro_torch.core.adaptive import fleet_managers
    from repro_torch.core.async_replan import ManualExecutor

    ex = ManualExecutor()
    fleet = fleet_managers(PP.paper_cost_model("mobilenet_v2", "esp_now"),
                           dict(PP.PROTOCOLS), (2, 3, 4, 5), solver="optimal_dp",
                           async_rebuild=ex, **kw)
    return fleet, ex, next(iter(fleet.values())).rebuilder


def drive_replans(fleet, ex, rebuilder) -> list:
    """Each manager's hops on its current protocol along ``REPLAN_TRACE``,
    the queued rebuilds run after each stage. Returns each completed
    build's request and family, taken as the build publishes it."""
    from repro_torch.core import profiles as PP

    built = []
    for factor, steps in REPLAN_TRACE:
        for _ in range(steps):
            for m in fleet.values():
                p = m.current.protocol
                m.observe(p, NBYTES, factor * PP.PROTOCOLS[p].transmission_latency_s(NBYTES))
        req = rebuilder.inflight()
        ex.run_all()
        if req is not None:
            built.append((req, {n: s for n, (g, s) in rebuilder._results.items()
                                if g == req.generation}))
    return built


def phase_replanning(card) -> None:
    """(b) ``fleet_managers(solver="optimal_dp")`` with a ``ManualExecutor``
    on the card (float32) and on ``device="cpu"``, one drift trace through
    both: equal decision histories and rebuilt and adopted families, each
    rebuilt family equal to ``build_sync`` of its request; the card's
    launches equal to the exact re-solves (dense) and the builds (fused)."""
    import torch

    from repro_torch.core import cuda_dp as CD

    runs = {}
    for label, kw in (("card", {}), ("cpu", dict(device="cpu")),
                      ("numpy", dict(backend="numpy"))):
        before = (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES)
        t0 = time.perf_counter()
        fleet, ex, rb = replan_fleet(dtype=torch.float32, **kw)
        built = drive_replans(fleet, ex, rb)
        runs[label] = dict(fleet=fleet, rb=rb, built=built, wall=time.perf_counter() - t0,
                           launched=(CD.DENSE_LAUNCHES - before[0],
                                     CD.FUSED_LAUNCHES - before[1]))
    on_card, cpu = runs["card"], runs["cpu"]

    def history(fleet):
        return {n: [d.__dict__ for d in m.history] for n, m in fleet.items()}

    if history(on_card["fleet"]) != history(cpu["fleet"]):
        raise AssertionError("replanning: card decision histories != device='cpu'")
    if [r.generation for r, _ in on_card["built"]] != [r.generation for r, _ in cpu["built"]] \
            or not all(families_equal(a, b)
                       for (_, a), (_, b) in zip(on_card["built"], cpu["built"])):
        raise AssertionError("replanning: card rebuilt families != device='cpu'")
    if not families_equal({n: m.surface for n, m in on_card["fleet"].items()},
                          {n: m.surface for n, m in cpu["fleet"].items()}):
        raise AssertionError("replanning: card adopted surfaces != device='cpu'")
    rb = on_card["rb"]
    counters = {n: m.counters() for n, m in on_card["fleet"].items()}
    resolves = sum(c["exact_fallbacks"] for c in counters.values()) + len(counters)
    expected = (resolves, 1 + rb.builds_completed)
    if on_card["launched"] != expected:
        raise AssertionError(f"replanning: launches (dense, fused) {on_card['launched']}, "
                             f"expected {expected} (re-solves; family + rebuilds)")
    swaps = sum(c["surface_swaps"] for c in counters.values())
    if not on_card["built"] or not swaps or resolves == len(counters):
        raise AssertionError("replanning: the trace made no rebuild, swap or re-solve")
    for req, fam in on_card["built"]:
        if not families_equal(fam, rb.build_sync(req)):
            raise AssertionError(f"replanning: generation {req.generation} != build_sync")
    decisions = sum(len(m.history) for m in on_card["fleet"].values())
    nodes = sum(m.surface.n_nodes for m in on_card["fleet"].values())
    print(f"  fleets 2-5 on the default axes: {decisions} decisions, {resolves} exact "
          f"re-solves (dense, the 4 initial ones included), {rb.builds_completed} rebuilds "
          f"(fused; sizes {[r.sizes for r, _ in on_card['built']]}), {swaps} swaps, "
          f"{nodes} adopted nodes at the end: card == device='cpu' decision "
          f"for decision, field by field, and node for node; every rebuilt family == "
          f"build_sync of its request; launches (dense, fused) {on_card['launched']}")
    print(f"  wall card {on_card['wall']:.3f} s, cpu {cpu['wall']:.3f} s, numpy twin "
          f"{runs['numpy']['wall']:.3f} s [{card}]")
    for n, m in on_card["fleet"].items():
        print(f"    n={n}: " + "; ".join(f"{d.protocol} {d.splits} @{d.step}"
                                         for d in m.history))


def surface_ties(manager) -> tuple[int, int, float]:
    """Every node of a float32 manager's surface against the exact re-solve
    at its state, as ``surface_parity_report`` forces it: the nodes whose
    plans differ must be float32 near-ties, both plans repriced in float64
    at the node's link within 4 * N * eps32. Returns (differing nodes,
    nodes, the largest relative gap)."""
    tol = 4 * manager.n_devices * F32_EPS
    solver = manager._batched_solver_name()
    differ = total = 0
    worst = 0.0
    for name, ps in manager.surface.protocols.items():
        est = manager.estimators[name]
        saved = (est._packet_time_s, est._loss)
        for i, pt in enumerate(ps.packet_time_s):
            for j, lp in enumerate(ps.loss_p):
                total += 1
                est._packet_time_s, est._loss = pt, lp
                link = est.current_profile()
                plan = manager._batched_plans([link], solver)[0]
                node = ps.node(i, j)
                if plan.splits == node.splits:
                    continue
                differ += 1
                model = manager._model_for(link)
                a = model.end_to_end_s(plan.splits, with_overheads=False)
                b = model.end_to_end_s(node.splits, with_overheads=False)
                gap = abs(a - b) / b
                worst = max(worst, gap)
                if not gap <= tol:
                    raise AssertionError(f"surface parity n={manager.n_devices} {name} "
                                         f"({pt}, {lp}): {plan.splits} vs {node.splits}, "
                                         f"not a float32 tie ({gap})")
        est._packet_time_s, est._loss = saved
    return differ, total, worst


def phase_surface_parity(card) -> None:
    """(c) ``surface_parity_report`` on the card in float64 is empty for
    every fleet size (fused surface, dense re-solves); in float32 the
    differing nodes are counted and each is a float64 tie."""
    import torch

    from repro_torch.core.adaptive import surface_parity_report

    walls = {}
    for label, kw in (("card", dict(dtype=torch.float64)), ("numpy", dict(backend="numpy"))):
        fleet, _, rb = replan_fleet(**kw)
        t0 = time.perf_counter()
        bad = {n: surface_parity_report(m) for n, m in fleet.items()}
        walls[label] = time.perf_counter() - t0
        rb.shutdown()
        if any(bad.values()):
            raise AssertionError(f"surface parity ({label}): "
                                 f"{ {n: b[:3] for n, b in bad.items() if b} }")
        nodes = sum(m.surface.n_nodes for m in fleet.values())
    fleet, _, rb = replan_fleet(dtype=torch.float32)
    t0 = time.perf_counter()
    ties = {n: surface_ties(m) for n, m in fleet.items()}
    walls["card float32"] = time.perf_counter() - t0
    rb.shutdown()
    differ = sum(d for d, _, _ in ties.values())
    total = sum(t for _, t, _ in ties.values())
    worst = max(w for _, _, w in ties.values())
    print(f"  float64 on the card: surface_parity_report empty for fleets 2-5 ({nodes} "
          f"nodes); float32: {differ} of {total} nodes differ, each a float64 tie (largest "
          f"relative gap {worst:.3g}); wall float64 report {walls['card']:.3f} s, float32 "
          f"{walls['card float32']:.3f} s, numpy twin {walls['numpy']:.3f} s [{card}]")


def gateway_storm(gw, sids, factor) -> dict:
    """Drift ``sids`` at ``factor`` x nominal on the real background thread
    until each has adopted a surface built after the storm began (at most
    ``ADOPTION_TIMEOUT_S``); as ``gateway_load.py``'s storm phase."""
    gen0 = gw.rebuilder.generation
    req0, started0 = gw.rebuilder.requests, gw.rebuilder.builds_started
    t0 = time.perf_counter()
    rounds, remaining = 0, list(sids)
    while remaining and time.perf_counter() - t0 < ADOPTION_TIMEOUT_S:
        rounds += 1
        for sid in remaining:
            sess = gw.sessions[sid]
            gw.submit_observe(sid, NBYTES,
                              sess.meter.link.transmission_latency_s(NBYTES) * factor)
        gw.pump()
        remaining = [s for s in remaining
                     if not any(g > gen0 for _, g in gw.sessions[s].handle.adoptions)]
        if remaining:
            time.sleep(0.005)  # a build in flight on the worker thread
    wall = time.perf_counter() - t0
    if remaining:
        raise AssertionError(f"gateway storm: {len(remaining)} of {len(sids)} sessions "
                             f"never adopted within {ADOPTION_TIMEOUT_S} s")
    requests = gw.rebuilder.requests - req0
    started = gw.rebuilder.builds_started - started0
    return {"drifted": len(sids), "rounds": rounds, "adoption_wait_s": wall,
            "rebuild_requests": requests, "builds_started": started,
            "coalesce_x": requests / max(1, started)}


def settle(gw):
    """Snapshot until no rebuild is queued or in flight (a snapshot
    publishes finished builds and launches queued ones). Returns the first
    snapshot taken while the rebuilder was idle before and after it, which
    therefore holds every finished build."""
    t0 = time.perf_counter()
    while True:
        idle = gw.rebuilder.inflight() is None and not gw.rebuilder._queued
        snap = gw.snapshot()
        if idle and gw.rebuilder.inflight() is None and not gw.rebuilder._queued:
            return snap
        if time.perf_counter() - t0 > ADOPTION_TIMEOUT_S:
            raise AssertionError("gateway: the rebuilds never settled")
        time.sleep(0.005)


def make_gateway(backend=None):
    """``gateway_load.py``'s gateway with ``solver="optimal_dp"`` over
    fleets 2-5."""
    from repro_torch.core import profiles as PP
    from repro_torch.runtime.gateway import FleetGateway

    return FleetGateway(PP.paper_cost_model("mobilenet_v2", "esp_now"), dict(PP.PROTOCOLS),
                        GATEWAY_SIZES, solver="optimal_dp", surface_grid=GATEWAY_GRID,
                        max_pending=2 * GATEWAY_SESSIONS, backend=backend)


def traced_storm(card) -> dict:
    """In a fresh process (a trace late in a long process has come back
    without device events on this machine): the gateway at full size, the
    100x storm untraced (it starts the worker thread), then a storm on
    another 10% of the fleet at ``TRACED_STORM_FACTOR`` under the
    profiler. Returns the trace and the storm's report."""
    gw = make_gateway()
    try:
        for i in range(GATEWAY_SESSIONS):
            gw.register(f"s{i}", GATEWAY_SIZES[i % len(GATEWAY_SIZES)], bytes_per_token=NBYTES)
        sids, tenth = list(gw.sessions), GATEWAY_SESSIONS // 10
        gateway_storm(gw, sids[-tenth:], STORM_FACTOR)
        settle(gw)
        storm = {}
        trace = traced_run("gateway storm (a fresh process)", lambda: storm.update(
            gateway_storm(gw, sids[-2 * tenth:-tenth], TRACED_STORM_FACTOR)), card)
        if settle(gw).counters["stale_adoption_violations"]:
            raise AssertionError("gateway: a stale adoption in the traced storm")
        return {"trace": trace, "storm": storm}
    finally:
        gw.close()


def gateway_run(card, backend=None) -> dict:
    """``gateway_load.py``'s full mode on a ``FleetGateway`` with
    ``solver="optimal_dp"`` over fleets 2-5: registration, 3 waves of
    in-envelope observes, a token loop over 2,000 sessions, a 10% drift
    storm on the real background thread, the audits."""
    from repro_torch.core import cuda_dp as CD
    from repro_torch.runtime.stats import percentile

    before = CD.FUSED_LAUNCHES
    t0 = time.perf_counter()
    gw = make_gateway(backend)
    rep = {"family_s": time.perf_counter() - t0}
    try:
        samples = []
        t0 = time.perf_counter()
        for i in range(GATEWAY_SESSIONS):
            t1 = time.perf_counter()
            gw.register(f"s{i}", GATEWAY_SIZES[i % len(GATEWAY_SIZES)], bytes_per_token=NBYTES)
            samples.append(time.perf_counter() - t1)
        rep["register_s"] = time.perf_counter() - t0
        rep["register_us_p50"] = percentile(samples, 50.0) * 1e6
        rep["register_us_p99"] = percentile(samples, 99.0) * 1e6
        sids = list(gw.sessions)
        t0 = time.perf_counter()
        for _ in range(STEADY_WAVES):
            for sid in sids:
                gw.submit_observe(sid, NBYTES,
                                  gw.sessions[sid].meter.link.transmission_latency_s(NBYTES))
            gw.pump()
        rep["steady_s"] = time.perf_counter() - t0
        p50, p99 = gw.qos.fleet_percentiles()
        rep["observe_us_p50"], rep["observe_us_p99"] = p50 * 1e6, p99 * 1e6
        t0 = time.perf_counter()
        for _ in range(TOKENS_PER_SESSION):
            for sid in sids[:TOKEN_SESSIONS]:
                gw.submit_token(sid)
            gw.pump()
        rep["tokens_s"] = time.perf_counter() - t0
        p50, p99 = gw.token_window.percentiles((50.0, 99.0))
        rep["token_us_p50"], rep["token_us_p99"] = p50 * 1e6, p99 * 1e6
        tenth = GATEWAY_SESSIONS // 10
        rep["storm"] = gateway_storm(gw, sids[-tenth:], STORM_FACTOR)
        snap = settle(gw)
        req = gw.rebuilder.last_request
        thread_built = {n: gw.fanout.latest(n)[1] for n in req.sizes}
        if any(gw.fanout.latest(n)[0] != req.generation for n in req.sizes):
            raise AssertionError("gateway: the last build was not published")
        oracle = np.asarray(gw.qos.global_window.values())
        if not (snap.p50_s == float(np.percentile(oracle, 50.0))
                and snap.p99_s == float(np.percentile(oracle, 99.0))):
            raise AssertionError("gateway: QoS percentiles != the numpy oracle")
        if snap.counters["stale_adoption_violations"]:
            raise AssertionError(f"gateway: {snap.counters['stale_adoption_violations']} "
                                 "stale adoptions")
        if {id(s.handle._fanout.rebuilder) for s in gw.sessions.values()} != {id(gw.rebuilder)}:
            raise AssertionError("gateway: the sessions do not share one rebuilder")
        if gw.rebuild_errors or snap.counters.get("events_shed", 0):
            raise AssertionError(f"gateway: {gw.rebuild_errors} rebuild errors, "
                                 f"{snap.counters.get('events_shed', 0)} events shed")
        rep["builds"] = gw.rebuilder.builds_completed
        rep["fused"] = CD.FUSED_LAUNCHES - before
        if not families_equal(thread_built, gw.rebuilder.build_sync(req)):
            raise AssertionError("gateway: a thread-built family != build_sync")
    finally:
        gw.close()
    return rep


def phase_gateway(card) -> None:
    """(d) The gateway at full size on the card, beside its numpy twin; the
    fused launches equal the family build plus the rebuilds the worker
    thread ran; a traced storm in a fresh ``spawn`` process."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    card_rep = gateway_run(card)
    twin = gateway_run(card, backend="numpy")
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as pool:
        traced = pool.submit(traced_storm, card).result()
    if card_rep["fused"] != 1 + card_rep["builds"]:
        raise AssertionError(f"gateway: {card_rep['fused']} fused launches, expected 1 + "
                             f"{card_rep['builds']} builds (family + rebuilds)")
    for label, rep in (("card", card_rep), ("numpy twin", twin)):
        st = rep["storm"]
        print(f"  {label}: family {rep['family_s']:.3f} s; registration "
              f"{GATEWAY_SESSIONS} sessions in {rep['register_s']:.3f} s "
              f"({GATEWAY_SESSIONS / rep['register_s']:.1f}/s, p50 "
              f"{rep['register_us_p50']:.2f} us, p99 {rep['register_us_p99']:.2f} us); "
              f"steady {STEADY_WAVES * GATEWAY_SESSIONS} observes in {rep['steady_s']:.3f} s, "
              f"p50 {rep['observe_us_p50']:.2f} us, p99 {rep['observe_us_p99']:.2f} us; "
              f"tokens {TOKENS_PER_SESSION * TOKEN_SESSIONS} in {rep['tokens_s']:.3f} s (p50 "
              f"{rep['token_us_p50']:.2f} us, p99 {rep['token_us_p99']:.2f} us); storm "
              f"{st['drifted']} sessions at {STORM_FACTOR:g}x: {st['rebuild_requests']} "
              f"requests -> {st['builds_started']} builds (coalesce_x "
              f"{st['coalesce_x']:.1f}), all adopted in {st['rounds']} rounds, "
              f"{st['adoption_wait_s']:.4f} s [{card}]")
    print(f"  audits (card and twin): zero stale adoptions, one shared rebuilder, QoS "
          f"p50/p99 == np.percentile, the storm's last thread-built family == build_sync "
          f"of its request; fused launches {card_rep['fused']} = 1 family + "
          f"{card_rep['builds']} rebuilds on the worker thread")
    trace, st = traced["trace"], traced["storm"]
    if trace is None:
        print("  traced storm: device busy time not measured (the trace held no device events)")
    else:
        kernel_ms = sum(ms for k, ms in trace["ops"].items() if "fused_dp" in k)
        print(f"  traced storm ({st['drifted']} sessions at {TRACED_STORM_FACTOR:g}x, "
              f"{st['builds_started']} builds, {st['adoption_wait_s']:.4f} s): device busy "
              f"{trace['busy_ms']:.4f} ms, idle share "
              f"{1 - trace['busy_ms'] / trace['wall_ms']:.6f}, the fused kernel "
              f"{kernel_ms:.4f} ms [{card}]")


def phase_pool_rebuild(card) -> None:
    """(e) One rebuild on a ``spawn`` process pool with ``device="cuda"``
    (the spec's JSON and the device name cross the boundary; the child
    launches the fused kernel): node for node the family the worker thread
    builds for the same request. The numpy twin goes through the same
    pool."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core import profiles as PP
    from repro_torch.core.async_replan import SurfaceRebuilder

    model = PP.paper_cost_model("mobilenet_v2", "esp_now")
    states = {"esp_now": (PP.ESP_NOW.packet_time_s() * 2000.0, 0.05),
              "ble": (PP.BLE.packet_time_s() * 700.0, 0.2)}
    sizes = (2, 3, 4, 5)
    pool = ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"))
    families, walls, requests = {}, {}, {}
    try:
        for label, executor, kw in (("thread", None, dict(device="cuda")),
                                    ("spawn", pool, dict(device="cuda")),
                                    ("spawn numpy", pool, dict(backend="numpy"))):
            rb = SurfaceRebuilder(model, dict(PP.PROTOCOLS), solver="batched_dp",
                                  executor=executor, **kw)
            t0 = time.perf_counter()
            for n in sizes:
                rb.request(n, states)
            got = None
            while got is None and time.perf_counter() - t0 < ADOPTION_TIMEOUT_S:
                got = rb.poll(2)  # the first poll launches the build
                if got is None:
                    time.sleep(0.005)
            walls[label] = time.perf_counter() - t0
            if got is None:
                raise AssertionError(f"{label} rebuild never adopted")
            families[label] = {2: got, **{n: rb.poll(n) for n in sizes[1:]}}
            requests[label] = rb.last_request
            rb.shutdown()
            if label == "thread" and not families_equal(families[label],
                                                        rb.build_sync(rb.last_request)):
                raise AssertionError("thread-built family != build_sync")
    finally:
        pool.shutdown(wait=True)
    if requests["spawn"].sizes != sizes or not families_equal(families["spawn"],
                                                              families["thread"]):
        raise AssertionError("spawn-pool rebuild != the thread-built family")
    nodes = sum(s.n_nodes for s in families["spawn"].values())
    print(f"  spawn pool, device='cuda': fleets {sizes}, {nodes} nodes == the "
          f"thread-built family (== build_sync) node for node; wall spawn {walls['spawn']:.3f} s (the "
          f"worker's start included), thread {walls['thread']:.3f} s, numpy twin on the "
          f"warm pool {walls['spawn numpy']:.3f} s [{card}]")


def phase_replan_tier(card) -> dict:
    """Phase 15 with the launch counters zeroed just before it and read
    just after: both DP kernels must launch, and the counts by path add up
    to the phase's totals."""
    from repro_torch.core import cuda_dp as CD

    CD.reset_launch_counts()
    counts = {}

    def mark(path):
        counts[path] = (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES)

    t0 = time.perf_counter()
    print("  (a) the spec tier")
    phase_spec_tier(card)
    mark("spec_tier")
    print("  (b) online replanning, deterministic")
    phase_replanning(card)
    mark("replanning")
    print("  (c) surface parity")
    phase_surface_parity(card)
    mark("surface_parity")
    print("  (d) the gateway at full size")
    phase_gateway(card)
    mark("gateway")
    print("  (e) a process-pool rebuild")
    phase_pool_rebuild(card)
    mark("pool_rebuild")
    launches = {"dense_dp": CD.DENSE_LAUNCHES, "fused_dp": CD.FUSED_LAUNCHES}
    tiled = CD.FUSED_TILED_LAUNCHES
    by_path, prev = {}, (0, 0, 0)
    for path, now in counts.items():
        by_path[path] = {"dense_dp": now[0] - prev[0], "fused_dp": now[1] - prev[1]}
        prev = now
    summed = {k: sum(p[k] for p in by_path.values()) for k in launches}
    print(f"  launches in this phase: {launches} (fused on the tiled kernel: {tiled}); by "
          f"path {by_path}; wall {time.perf_counter() - t0:.1f} s")
    if summed != launches:
        raise AssertionError(f"phase 15: launches by path {summed} != totals {launches}")
    if not launches["dense_dp"] or not launches["fused_dp"] or tiled != launches["fused_dp"]:
        raise AssertionError("phase 15: a DP kernel was not launched (or a fused launch "
                             "left the tiled kernel)")
    return {"launches": launches, "tiled": tiled, "by_path": by_path}


# ---------------------------------------------------------------------------
# Split execution of the paper's CNNs with the int8 wire (phase 16)
# ---------------------------------------------------------------------------

# MobileNet-V2 0.35 at 224 px, batch 1, its paper cuts: (boundary, int8
# bytes shipped); block_2_expand ships 56x56x48 main plus a 56x56x8 skip
PAPER_HOPS = (("block_2_expand", 175_616), ("block_15_project_BN", 2_744),
              ("block_16_project_BN", 5_488))
# card vs CPU on the same weights and input: max |diff| <= this x rms.
# float32 sums in another order give ~1e-6; TF32 would give ~1e-3
CNN_TOL = 1e-4
CNN_BATCHES = (1, 64)


def cnn_models() -> dict:
    """The paper's two CNNs at full width: MobileNet-V2 at the width and
    image size of ``paper_cost_model("mobilenet_v2")`` and ResNet50, 224 px."""
    from repro_torch.models.mobilenetv2 import MobileNetV2
    from repro_torch.models.resnet50 import ResNet50

    return {"mobilenet_v2": MobileNetV2(width=0.35, image_size=224),
            "resnet50": ResNet50(image_size=224)}


def median_ms(fn, reps) -> float:
    """The median of ``reps`` calls, each timed alone with CUDA events
    (the end event waited for), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def hop_records(trace) -> list:
    return [(h.boundary_layer, h.nbytes, h.n_packets, h.sim_latency_s) for h in trace.hops]


def phase_cnn_plans(card) -> dict:
    """(a) ``plan_split(solver="batched_dp")`` on the card (the dense
    kernel) for both CNNs over ESP-NOW at N 2-5, each plan equal to the
    same call on ``device="cpu"`` (float32); the quickstart's beam plan.
    Returns each model's split sets to execute."""
    from repro_torch.core import profiles as PP
    from repro_torch.core.planner import plan_split

    cuts = {}
    for name in cnn_models():
        model = PP.paper_cost_model(name, "esp_now")
        cuts[name] = []
        for n in (2, 3, 4, 5):
            got = plan_split(model, n, solver="batched_dp")
            want = plan_split(model, n, solver="batched_dp", device="cpu")
            if not plans_equal([got], [want]):
                raise AssertionError(f"{name} N={n}: card plan {got.splits} != cpu "
                                     f"{want.splits}")
            feasible = got.total_latency_s < float("inf")
            if feasible:
                cuts[name].append(got.splits)
            print(f"  {name} N={n}: card == cpu, splits {got.splits}, latency "
                  f"{got.total_latency_s:.4f} s" + ("" if feasible else
                                                   " (infeasible: nothing to execute)"))
    beam = plan_split(PP.paper_cost_model("mobilenet_v2", "esp_now"), 3, solver="beam",
                      beam_width=8)
    print(f"  quickstart beam (mobilenet_v2, N=3, width 8): splits {beam.splits}, latency "
          f"{beam.total_latency_s:.4f} s")
    cuts["mobilenet_v2"] += [beam.splits, paper_cuts(cnn_models()["mobilenet_v2"])]
    return {name: list(dict.fromkeys(c)) for name, c in cuts.items()}


def paper_cuts(model) -> tuple:
    """MobileNet-V2's paper split points as chain indices; () elsewhere."""
    names = model.layer_names
    return tuple(names.index(b) + 1 for b, _ in PAPER_HOPS if b in names)


def boundary_carries(model, params, x, splits) -> dict:
    """The carry after each split layer of one forward pass."""
    out, carry = {}, x
    for i, name in enumerate(model.layer_names, start=1):
        carry = model.apply_layer(name, params[name], carry)
        if i in splits:
            out[name] = carry
    return out


def cnn_model_phase(name, model, cuts, card) -> dict:
    """(b) and (c) for one CNN at batches 1 and 64, seeded weights and
    inputs on the card and the CPU: split == unsplit bit for bit on the
    card; the card within ``CNN_TOL`` x rms of the CPU; int8-wire hop
    records == the CPU run's (and ``PAPER_HOPS`` at batch 1); then unsplit
    and wire-split times, images/s and the wire's cost per hop."""
    import torch

    from repro_torch.core import executor as EX
    from repro_torch.core import profiles as PP
    from repro_torch.models.graph import mobilenet_v2_graph, resnet50_graph

    dev = torch.device("cuda")
    params = {d: model.init(torch.Generator().manual_seed(0), device=d) for d in (dev, "cpu")}
    graph = (mobilenet_v2_graph(model.width, model.image_size) if name == "mobilenet_v2"
             else resnet50_graph(model.image_size))
    timed_cut = cuts[-1]  # the paper cuts (MobileNet-V2), the N=5 plan (ResNet50)
    out = {}
    for batch in CNN_BATCHES:
        x = torch.randn(model.input_shape(batch), generator=torch.Generator().manual_seed(batch))
        xd = x.to(dev)
        ref = EX.run_unsplit(model, params[dev], xd)["h"]
        for splits in cuts:
            got, _ = EX.run_split(model, params[dev], xd, splits)
            if not torch.equal(got["h"], ref):
                raise AssertionError(f"{name} batch {batch}: split at {splits} != unsplit")
        t0 = time.perf_counter()
        cpu = EX.run_unsplit(model, params["cpu"], x)["h"]
        cpu_s = time.perf_counter() - t0
        want = cpu.double()
        err = float((ref.cpu().double() - want).abs().max() / want.square().mean().sqrt())
        if not err <= CNN_TOL:
            raise AssertionError(f"{name} batch {batch}: card vs cpu {err:.3g} x rms > {CNN_TOL}")
        same_top1 = float((ref.argmax(-1).cpu() == cpu.argmax(-1)).float().mean())
        print(f"  (b) {name} batch {batch}: split == unsplit bit for bit at {len(cuts)} split "
              f"sets {cuts}; card vs cpu max |diff| {err:.3g} x rms ({err / CNN_TOL:.4f} of "
              f"the {CNN_TOL:g} limit), top-1 equal on {same_top1:.0%} (cpu forward "
              f"{cpu_s:.2f} s)")
        for splits in cuts:
            wire, trace = EX.run_split(model, params[dev], xd, splits, link=PP.ESP_NOW,
                                       quantize_wire=True)
            _, cpu_trace = EX.run_split(model, params["cpu"], x, splits, link=PP.ESP_NOW,
                                        quantize_wire=True)
            if hop_records(trace) != hop_records(cpu_trace):
                raise AssertionError(f"{name} batch {batch} at {splits}: hop records "
                                     f"{hop_records(trace)} != cpu {hop_records(cpu_trace)}")
            top1 = float((wire["h"].argmax(-1) == ref.argmax(-1)).float().mean())
            print(f"      int8 wire at {splits}: hops == cpu "
                  + ", ".join(f"{b} {nb:,} B / {pk} packets / {s * 1e3:.2f} ms"
                              for b, nb, pk, s in hop_records(trace))
                  + f"; top-1 agreement with unsplit {top1:.0%}")
            if batch == 1 and splits == paper_cuts(model):
                if [h[:2] for h in hop_records(trace)] != list(PAPER_HOPS):
                    raise AssertionError(f"paper cuts: {hop_records(trace)} != {PAPER_HOPS}")
                out["paper_hops_checked"] = True
        # (c) times
        reps = 30 if batch == 1 else 10
        unsplit_ms = median_ms(lambda: EX.run_unsplit(model, params[dev], xd), reps)
        split_ms = median_ms(lambda: EX.run_split(model, params[dev], xd, timed_cut,
                                                  link=PP.ESP_NOW, quantize_wire=True), reps)
        hops = {b: median_ms(lambda c=c: EX._wire_encode(c), reps)
                for b, c in boundary_carries(model, params[dev], xd, timed_cut).items()}
        tflops = graph.total_flops * batch / (unsplit_ms / 1e3) / 1e12
        out[batch] = {"unsplit_ms": unsplit_ms, "split_ms": split_ms, "hops_ms": hops}
        print(f"  (c) {name} batch {batch}: unsplit {unsplit_ms:.4f} ms "
              f"({batch / unsplit_ms * 1e3:.1f} images/s, {tflops:.3f} TFLOP/s of the graph's "
              f"{graph.total_flops * batch / 1e9:.2f} GFLOP, {tflops / (FP32_FLOPS_PER_S / 1e12):.4f}"
              f" of the fp32 peak); int8-wire split at {timed_cut} {split_ms:.4f} ms "
              f"(+{split_ms - unsplit_ms:.4f}); encode + decode per hop "
              + ", ".join(f"{b} {ms:.4f} ms" for b, ms in hops.items())
              + f"; medians of {reps} calls (CUDA events) [{card}]")
    return out


def traced_cnn_forward(card, reps=5) -> dict | None:
    """In a fresh process (a trace late in a long process has come back
    without device events on this machine): MobileNet-V2 at 224 px, batch
    1, through its paper cuts with the int8 wire, warmed up, then traced:
    the card's idle share and its device time by class (convolutions, the
    Logits GEMM, the wire's quantization, the other elementwise, pooling
    and reduction ops)."""
    import torch

    from repro_torch.core import executor as EX
    from repro_torch.core import profiles as PP

    model = cnn_models()["mobilenet_v2"]
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    x = torch.randn(model.input_shape(1), generator=torch.Generator().manual_seed(1)).cuda()
    def run():
        for _ in range(reps):
            EX.run_split(model, params, x, paper_cuts(model), link=PP.ESP_NOW, quantize_wire=True)

    run()
    trace = traced_run(f"{reps} batch-1 MobileNet-V2 forwards with the int8 wire "
                       "(a fresh process)", run, card)
    if trace is None:
        return None
    by_op = trace["by_cpu_op"]
    classes = {"conv": by_op.get("aten::conv2d", 0.0), "gemm": by_op.get("aten::matmul", 0.0),
               "quantization": by_op.get("wire_encode", 0.0)}
    classes["elementwise"] = trace["busy_ms"] - sum(classes.values())
    return {"wall_ms": trace["wall_ms"], "busy_ms": trace["busy_ms"], "classes": classes,
            "reps": reps}


def phase_cnn(card) -> dict:
    """Phase 16 with the DP launch counters zeroed just before it and read
    just after: the dense kernel must launch (the plans of (a))."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.core import cuda_dp as CD

    CD.reset_launch_counts()
    t0 = time.perf_counter()
    print("  (a) plans on the card")
    cuts = phase_cnn_plans(card)
    launches = {"dense_dp": CD.DENSE_LAUNCHES, "fused_dp": CD.FUSED_LAUNCHES}
    if not launches["dense_dp"] or launches["fused_dp"]:
        raise AssertionError(f"phase 16: the plans launched {launches}; expected the "
                             "dense DP kernel only")
    print(f"  dense DP launches in (a): {launches['dense_dp']}")
    times = {}
    for name, model in cnn_models().items():
        times[name] = cnn_model_phase(name, model, cuts[name], card)
        torch.cuda.empty_cache()
    if not times["mobilenet_v2"].get("paper_hops_checked"):
        raise AssertionError("phase 16: the paper cuts' hop bytes were not checked")
    print(f"  paper cuts at batch 1: {', '.join(f'{b} {nb:,} B' for b, nb in PAPER_HOPS)} "
          f"(== the reference's)")
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as pool:
        traced = pool.submit(traced_cnn_forward, card).result()
    if traced is None:
        print("  traced forward: device time by class not measured (no device events)")
    else:
        n = traced["reps"]
        print(f"  traced forward, per forward: wall {traced['wall_ms'] / n:.4f} ms, device busy "
              f"{traced['busy_ms'] / n:.4f} ms, idle share "
              f"{1 - traced['busy_ms'] / traced['wall_ms']:.4f}; device ms by class "
              + ", ".join(f"{k} {v / n:.4f}" for k, v in traced["classes"].items())
              + f" [{card}]")
    if (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES) != (launches["dense_dp"], launches["fused_dp"]):
        raise AssertionError("phase 16: a DP kernel launched outside the plans of (a)")
    print(f"  launches in this phase: {launches}; wall {time.perf_counter() - t0:.1f} s")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# The rest of LM serving at full width (phase 17)
# ---------------------------------------------------------------------------

# (config, layers run; None: all): full width everywhere; the three largest
# configs cut in depth to fit one 80 GB card with their caches and twins
FAMILIES = (("stablelm-12b", None), ("granite-moe-1b-a400m", None),
            ("qwen3-moe-235b-a22b", 4), ("minicpm3-4b", None),
            ("musicgen-medium", None), ("qwen2-vl-72b", 8), ("granite-34b", 16))
FAMILY_B, FAMILY_P, FAMILY_DECODE = 2, 1024, 16
# the reference's Server sends "tokens" only: the token-frontend configs
SERVER_FAMILIES = ("stablelm-12b", "granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
                   "minicpm3-4b", "granite-34b")


class AttentionProbe:
    """While entered, every ``attention_core`` call of a flash-kernel run
    (Sq > 8) is checked on its own q, k and v: the kernel output against
    the kernel's plain version (``attention_ref``, float32 probabilities:
    the flash contract, within its full-width bf16 limit), and against
    ``plain_attention`` (the twin's arithmetic: probabilities rounded to
    bf16 before PV, outside the contract), as max abs error, share of the
    limit and error over the plain output's std."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention.ref import attention_ref
        from repro_torch.models import layers as L

        self.L, self.ref, self.core, self.layers = L, attention_ref, L.attention_core, []
        L.attention_core = self._core
        return self

    def __exit__(self, *exc):
        self.L.attention_core = self.core

    def _core(self, cfg, q, k, v, q_positions, kv_positions):
        import math

        out = self.core(cfg, q, k, v, q_positions, kv_positions)
        if cfg.use_flash_kernel and q.shape[1] > 8:
            B, Sq, H, D = q.shape
            k, v = k.to(q.dtype), v.to(q.dtype)
            scale = 1.0 / math.sqrt(D)
            ref = self.ref(fold(q), fold(k), fold(v), q_positions[0], kv_positions, scale)
            err, used = within(out, ref.reshape(B, H, Sq, D).transpose(1, 2),
                               *FLASH_TOL_FULL_BF16)
            del ref
            plain = self.L.plain_attention(q, k, v, q_positions=q_positions,
                                           kv_positions=kv_positions, scale=scale)
            plain_err, plain_used = within(out, plain, *FLASH_TOL_FULL_BF16)
            self.layers.append({"err": err, "used": used, "plain_err": plain_err,
                                "plain_used": plain_used,
                                "rel": plain_err / float(plain.float().std())})
        return out


class QuantProbe:
    """While entered, keeps every ``quantize_kv`` call's input and
    outputs (the int8 cache's k and v of each layer)."""

    def __enter__(self):
        from repro_torch.models import layers as L

        self.L, self.quantize, self.calls = L, L.quantize_kv, []
        L.quantize_kv = self._quantize
        return self

    def __exit__(self, *exc):
        self.L.quantize_kv = self.quantize

    def _quantize(self, t):
        vals, scale = self.quantize(t)
        self.calls.append((t, vals, scale))
        return vals, scale


class RoutingTape:
    """Each MoE layer's expert choice (``MoE.select``), recorded in the
    kernel run and replayed in the twin's: the twin takes the kernel
    run's (token, slot) picks, hence its keep mask, and computes its own
    router probabilities and gates. ``changed`` counts, per replayed
    call, the picks the twin's own router would not have made."""

    def __init__(self, model):
        from repro_torch.models import layers as L

        self.top_k, self.moes = L.top_k_lower_index, [b.ff for b in model.blocks]
        self.tape, self.pos, self.replaying, self.changed = [], 0, False, []
        for moe in self.moes:
            moe.select = self._select

    def record(self):
        self.tape, self.replaying = [], False

    def replay(self):
        self.pos, self.replaying, self.changed = 0, True, []

    def close(self):
        for moe in self.moes:
            del moe.select

    def _select(self, probs, k):
        own = self.top_k(probs, k)
        if not self.replaying:
            self.tape.append(own)
            return own
        forced = self.tape[self.pos]
        self.pos += 1
        self.changed.append(int((forced[..., :, None] != own[..., None, :]).all(-1).sum()))
        return forced


def family_setup(dev, arch, n_layers):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = replace(full, use_flash_kernel=True, n_layers=n_layers or full.n_layers)
    if n_layers:
        print(f"  {arch}: depth cut to {n_layers} of {full.n_layers} layers at full width "
              f"(all {full.n_layers} take {full.n_params * 2 / 1e9:.1f} GB of bf16 weights; "
              f"the card holds 80 GB)")
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    feats = [n for n, on in (("parallel residual", cfg.parallel_residual),
                             (f"MoE {cfg.n_experts} experts top-{cfg.top_k}", cfg.is_moe),
                             (f"MLA (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
                              f"qk {cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim}, v "
                              f"{cfg.v_head_dim})", cfg.use_mla),
                             (f"{cfg.n_codebooks} codebooks", cfg.n_codebooks),
                             (f"M-RoPE {cfg.mrope_sections}", cfg.mrope_sections),
                             ("int8 KV cache", cfg.kv_cache_dtype == "int8"),
                             (f"frontend {cfg.frontend}", cfg.frontend != "none")) if on]
    print(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {'; '.join(feats)}; "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} G parameters made "
          f"on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, replace(cfg, use_flash_kernel=False), params


def family_batch(dev, cfg, S, seed=1) -> dict:
    """Seeded inputs for the config's frontend: tokens, codes, or embeds
    of the embedding table's scale in the compute type."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.frontend == "vision_embeds":
        x = torch.randn((FAMILY_B, S, cfg.d_model), generator=g, device=dev) * 0.02
        return {"embeds": x.to(torch.bfloat16)}
    shape = (FAMILY_B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    key = "codes" if cfg.frontend == "audio_codes" else "tokens"
    return {key: torch.randint(0, cfg.vocab, shape, generator=g, device=dev)}


def family_feed(cfg, params, last) -> dict:
    """The next step's input from the last position's logits (B, [K,] Vp):
    the greedy token or codes; on the vision path the greedy token's
    embedding (a text token's embeds)."""
    tok = last[..., :cfg.vocab].argmax(-1)
    if cfg.frontend == "vision_embeds":
        return {"embeds": params.embed.table[tok][:, None]}
    return {"codes" if cfg.frontend == "audio_codes" else "tokens": tok[:, None]}


def logits_err(got, want, cfg) -> tuple[float, float]:
    """(max abs error, the twin's std) over the real vocab slots."""
    g, w = got[..., :cfg.vocab].float(), want[..., :cfg.vocab].float()
    return float((g - w).abs().max()), float(w.std())


def family_prefill_step(dev, cfg, twin, params, tape) -> dict:
    """(a) the prefill step with every layer's attention held to
    ``plain_attention``; (b) its last-position logits against the
    plain-attention twin's (MoE: on the kernel run's expert picks)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.steps import make_prefill_step

    batch = family_batch(dev, cfg, FAMILY_P)
    if tape:
        tape.record()
    FA.reset_launch_count()
    with AttentionProbe() as probe:
        got = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
    launches, wgmma = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    expect = 0 if cfg.use_mla else cfg.n_layers
    if launches != expect or wgmma != expect or len(probe.layers) != expect:
        raise AssertionError(f"{cfg.name} prefill step: {launches} flash launches ({wgmma} "
                             f"wgmma, {len(probe.layers)} probed); expected {expect}")
    worst = max(probe.layers, key=lambda e: e["used"], default=None)
    if worst is not None and worst["used"] > 1.0:
        raise AssertionError(f"{cfg.name}: a layer's flash output beyond the contract "
                             f"(max abs err {worst['err']}, {worst['used']:.3f} of the limit)")
    rel = [e["rel"] for e in probe.layers]  # vs plain_attention, over its std
    # MoE: independent per-layer attention errors of relative size rel_l
    # reach the logits in quadrature (root-sum-square), never tighter than
    # the dense rule; the twin takes the kernel run's expert picks
    rss = float(np.sqrt(np.sum(np.square(rel)))) if rel else 0.0
    tol = max(LOGITS_TOL, rss) if cfg.is_moe else LOGITS_TOL
    if tape:
        tape.replay()
    want = make_prefill_step(twin)(params, batch)
    if tape and tape.pos != len(tape.tape):
        raise AssertionError(f"{cfg.name}: the twin replayed {tape.pos} of "
                             f"{len(tape.tape)} expert choices")
    shape = (FAMILY_B,) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (cfg.vocab_padded,)
    if tuple(got.shape) != shape or not bool(torch.isfinite(got[..., :cfg.vocab]).all()):
        raise AssertionError(f"{cfg.name} prefill step: bad logits {tuple(got.shape)}")
    err, std = logits_err(got, want, cfg)
    same = float((got[..., :cfg.vocab].argmax(-1) == want[..., :cfg.vocab].argmax(-1))
                 .float().mean())
    if probe.layers:
        check = (f"each layer's flash output on its own q, k, v: vs the kernel's plain "
                 f"version (the contract: rtol {FLASH_TOL_FULL_BF16[0]}, atol "
                 f"{FLASH_TOL_FULL_BF16[1]}) share of the limit by layer "
                 f"{[round(e['used'], 3) for e in probe.layers]}, worst {worst['used']:.3f}, "
                 f"max abs err {max(e['err'] for e in probe.layers):.4g}; vs "
                 f"plain_attention (bf16 probabilities) worst "
                 f"{max(e['plain_used'] for e in probe.layers):.3f} of "
                 f"it, max abs err {max(e['plain_err'] for e in probe.layers):.4g}, over its "
                 f"std by layer {[round(r, 4) for r in rel]}")
    else:
        check = "MLA runs the chunked attention core directly, as the reference: no flash call"
    print(f"  (a) prefill step {FAMILY_B} x {FAMILY_P}: {launches} flash launches ({wgmma} "
          f"wgmma); {check}")
    rule = (f"max(0.25, root-sum-square of the per-layer errors {rss:.4f})" if cfg.is_moe
            else "0.25")
    print(f"  (b) last-position logits {tuple(got.shape)} vs the plain-attention twin: max "
          f"abs err {err:.4g} = {err / std:.4f} x std {std:.4g} (tolerance {tol:.4f} x std: "
          f"{rule}); argmax equal on {same:.0%}")
    if tape:
        print(f"      MoE: the twin took the kernel run's expert picks (and so its keep "
              f"mask); picks its own router would have changed, by layer: {tape.changed} "
              f"of {tape.tape[0].numel()}")
    if err > tol * std:
        raise AssertionError(f"{cfg.name} prefill step: kernel logits beyond tolerance")
    return {"launches": launches, "wgmma": wgmma, "tol": tol, "batch": batch}


def check_int8_cache(cfg, calls, cache):
    """Each layer's int8 codes and scales written by the card equal
    ``quantize_kv`` of the same k and v on the CPU, bit for bit, and
    the cache rows hold them."""
    import torch

    from repro_torch.models import layers as L

    if len(calls) != 2 * cfg.n_layers:
        raise AssertionError(f"int8 cache: {len(calls)} quantizer calls")
    for i, (t, vals, scale) in enumerate(calls):
        layer, name = divmod(i, 2)
        want_vals, want_scale = L.quantize_kv(t.cpu())
        kv = "kv"[name]
        rows = slice(0, t.shape[1])
        if not (torch.equal(vals.cpu(), want_vals) and torch.equal(scale.cpu(), want_scale)
                and torch.equal(cache[kv][layer, :, rows].cpu(), want_vals)
                and torch.equal(cache[kv + "_scale"][layer, :, rows].cpu(), want_scale)):
            raise AssertionError(f"int8 cache layer {layer} {kv}: card != CPU quantizer")
    print(f"      int8 cache: the codes and scales of all {cfg.n_layers} layers' k and v "
          f"written by the card == quantize_kv on the CPU on the same input (bit for bit)")


def family_cached(dev, cfg, twin, params, tape, tol) -> dict:
    """(c) ``prefill`` into a 1024 + 16 cache, then greedy ``serve_step``s;
    the twin decodes the same inputs. MLA: each step also on the
    unabsorbed path (on a copy of the cache) against the absorbed one."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as T

    max_seq = FAMILY_P + FAMILY_DECODE
    ours = T.init_cache(cfg, FAMILY_B, max_seq, device=dev)
    theirs = T.init_cache(cfg, FAMILY_B, max_seq, device=dev)
    counts = {"prefill": 0, "serve_step": 0}
    wgmma = dict(counts)
    agree = decisive = total = 0
    mla_err = 0.0
    feed = family_batch(dev, cfg, FAMILY_P)
    changed = []
    for i in range(FAMILY_DECODE + 1):
        step = feed if i == 0 else {**feed, "cur_index": FAMILY_P + i - 1}
        run = T.prefill if i == 0 else T.serve_step
        if cfg.use_mla and i:
            before = {k: v.clone() for k, v in ours.items()}
        if tape:
            tape.record()
        FA.reset_launch_count()
        with QuantProbe() as quant:
            logits, ours = run(cfg, params, step, ours)
            torch.cuda.synchronize()
        counts[run.__name__] += FA.FLASH_LAUNCHES
        wgmma[run.__name__] += FA.FLASH_WGMMA_LAUNCHES
        if tape:
            tape.replay()
        twin_logits, theirs = run(twin, params, step, theirs)
        if tape:
            changed.append(sum(tape.changed))
        last, twin_last = logits[:, -1], twin_logits[:, -1]
        if cfg.use_mla and i:
            flat, _ = run(replace(cfg, mla_absorbed_decode=False), params, step, before)
            err, std = logits_err(last, flat[:, -1], cfg)
            mla_err = max(mla_err, err / std)
            del before
        if i == 0:
            err, std = logits_err(last, twin_last, cfg)
            print(f"  (c) prefill into the {max_seq}-row cache ("
                  + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]}" for k, v in ours.items())
                  + f"): last-position logits vs the twin: max abs err {err:.4g} = "
                  f"{err / std:.4f} x std (tolerance {tol:.4f} x std)")
            if err > tol * std:
                raise AssertionError(f"{cfg.name} prefill into the cache: beyond tolerance")
            tol_abs = tol * std
            if cfg.kv_cache_dtype == "int8":
                check_int8_cache(cfg, quant.calls, ours)
        real = slice(0, cfg.vocab)
        tok = last[..., real].argmax(-1)
        top2 = twin_last[..., real].topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol_abs
        same = tok == twin_last[..., real].argmax(-1)
        if bool((clear & ~same).any()) or not bool(torch.isfinite(last[..., real]).all()):
            raise AssertionError(f"{cfg.name} step {i}: picks differ from the twin's where "
                                 f"its top-two gap exceeds {2 * tol_abs:.4g}")
        agree, decisive, total = agree + int(same.sum()), decisive + int(clear.sum()), \
            total + same.numel()
        feed = family_feed(cfg, params, last)
    expect = {"prefill": 0 if cfg.use_mla else cfg.n_layers, "serve_step": 0}
    if counts != expect or wgmma != counts:
        raise AssertionError(f"{cfg.name} cached serving: flash launches {counts} "
                             f"(wgmma {wgmma}), expected {expect}")
    print(f"      + {FAMILY_DECODE} greedy serve_steps: flash launches {counts} (wgmma "
          f"{wgmma}); greedy picks equal to the twin's in {agree} of {total}; {decisive} had "
          f"a top-two gap > {2 * tol_abs:.4g}, all of those agree"
          + (f"; the twin took the kernel run's expert picks at every step (its own router "
             f"would have changed {sum(changed)})" if tape else ""))
    if cfg.use_mla:
        print(f"      MLA: absorbed (latent-space) decode vs the unabsorbed path on the same "
              f"cache, every step: max abs err over std {mla_err:.4f} (tolerance {LOGITS_TOL})")
        if mla_err > LOGITS_TOL:
            raise AssertionError(f"{cfg.name}: absorbed decode beyond tolerance")
    return {"launches": counts, "wgmma": wgmma, "cache": ours}


def family_server(cfg, params) -> None:
    """(d) ``Server``, 4 slots, 5 staggered requests: drained, in-vocab,
    no flash launch; each request's tokens == serving it alone. MoE slots
    share expert capacity (idle slots route too), so that equality holds
    at a capacity factor of E / top_k (no drop); at the config's own
    factor the run must drain."""
    from repro_torch.kernels.flash_attention import ops as FA

    rng = np.random.RandomState(7)
    reqs = [(rid, rng.randint(0, cfg.vocab, size=n).astype(np.int32), 4)
            for rid, n in enumerate((5, 3, 7, 4, 6))]
    runs = [(cfg, not cfg.is_moe)]
    if cfg.is_moe:
        runs.append((replace(cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k), True))
    notes = []
    for c, alone_check in runs:
        FA.reset_launch_count()
        got = serve_requests(params, c, reqs, max_seq=64)
        if FA.FLASH_LAUNCHES:
            raise AssertionError(f"{cfg.name} Server: {FA.FLASH_LAUNCHES} flash launches")
        if any(len(t) != 4 or not all(0 <= x < cfg.vocab for x in t) for t in got.values()):
            raise AssertionError(f"{cfg.name} Server: a request did not drain")
        note = f"capacity factor {c.moe_capacity_factor}: drained" if cfg.is_moe else "drained"
        if alone_check:
            for rid, prompt, max_new in reqs:
                if serve_requests(params, c, [(rid, prompt, max_new)], stagger=False,
                                  max_seq=64)[rid] != got[rid]:
                    raise AssertionError(f"{cfg.name} Server: request {rid} != alone")
            note += ", each request's tokens == serving it alone (exact)"
        notes.append(note)
    print(f"  (d) Server 4 slots, 5 staggered requests (prompts 3-7 tokens), 4 new tokens "
          f"each, 0 flash launches: {'; '.join(notes)}")


def flash_at(dev, cfg, card) -> dict:
    """The wgmma flash kernel, its plain version and SDPA at the config's
    prefill shape, beside the kernel's bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, H, Hkv, D = FAMILY_B, FAMILY_P, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, qpos, kpos = flash_case(dev, B, S, S, H, Hkv, D, torch.bfloat16, 77)
    qf, kf, vf = fold(q), fold(k), fold(v)
    scale = D ** -0.5
    pairs = B * H * int((kpos[None, :] <= qpos[:, None]).sum())
    flops, nbytes = 4 * D * pairs, 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    flops_ms, bytes_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rep = H // Hkv
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k.repeat_interleave(rep, 2),
                                               v.repeat_interleave(rep, 2)))
    ms = timed_ms(lambda: FA.flash_attention_kernel(qf, kf, vf, qpos, kpos, scale=scale), 10)
    plain_ms = timed_ms(lambda: attention_ref(qf, kf, vf, qpos, kpos, scale), 3)
    lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                             scale=scale), 10)
    bound = max(flops_ms, bytes_ms)
    by = "operations" if flops_ms >= bytes_ms else "bytes"
    print(f"      flash at the prefill shape (B {B} S {S} H {H} Hkv {Hkv} D {D} bf16 causal): "
          f"wgmma kernel {ms:.4f} ms; plain {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"{lib_ms:.4f} ms; bound {bound:.4f} ms by {by} ({flops / 1e9:.2f} G flops, "
          f"{nbytes / 1e6:.1f} MB); {ms / bound:.1f}x the bound [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "shape": f"B {B} S {S} H {H} Hkv {Hkv} D {D}"}


def family_times(dev, cfg, params, cache, card) -> dict:
    """(e) the prefill step's wall and tokens/s, ms per serve_step."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    step, batch = make_prefill_step(cfg), family_batch(dev, cfg, FAMILY_P)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    feed = family_feed(cfg, params, step(params, batch))
    decode = lambda i: T.serve_step(cfg, params, {**feed, "cur_index": FAMILY_P + i % 16},
                                    cache)
    decode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        decode(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    n = FAMILY_B * FAMILY_P
    print(f"  (e) prefill step {FAMILY_B} x {FAMILY_P}: {min(walls):.4f} s ({n / min(walls):.1f} "
          f"tokens/s; runs {', '.join(f'{w:.4f}' for w in walls)} s); serve_step "
          f"{step_ms:.3f} ms per step over 10 ({FAMILY_B * 1e3 / step_ms:.1f} tokens/s at "
          f"{FAMILY_B} rows) [{card}]")
    return {"prefill_s": min(walls), "step_ms": step_ms}


def traced_family_steps(card) -> dict:
    """In a fresh process (a trace late in a long process has come back
    without device events): each config built as in
    phase 17, a 1024-token prefill into its 1040-row cache, two warm-up
    ``serve_step``s, then one traced: wall, device busy and idle share."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    out = {}
    for arch, n_layers in FAMILIES:
        full = get_config(arch)
        cfg = replace(full, use_flash_kernel=True, n_layers=n_layers or full.n_layers)
        params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        cache = T.init_cache(cfg, FAMILY_B, FAMILY_P + FAMILY_DECODE, device=dev)
        logits, cache = T.prefill(cfg, params, family_batch(dev, cfg, FAMILY_P), cache)
        feed = family_feed(cfg, params, logits[:, -1])
        step = lambda: T.serve_step(cfg, params, {**feed, "cur_index": FAMILY_P}, cache)
        step()
        step()
        trace = traced_run(f"{arch} serve_step, {FAMILY_B} rows (a fresh process)", step, card)
        out[arch] = None if trace is None else {"wall_ms": trace["wall_ms"],
                                                "busy_ms": trace["busy_ms"]}
        del params, cache, logits
        torch.cuda.empty_cache()
    return out


def phase_lm_families(dev, card) -> dict:
    """Phase 17: the seven configs one at a time, each freed before the
    next; flash launches counted per config around its runs only."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    t_phase = time.perf_counter()
    launches, wgmma, by_config = {}, 0, {}
    for arch, n_layers in FAMILIES:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, twin, params = family_setup(dev, arch, n_layers)
        tape = RoutingTape(params) if cfg.is_moe else None
        pre = family_prefill_step(dev, cfg, twin, params, tape)
        cached = family_cached(dev, cfg, twin, params, tape, pre["tol"])
        if tape:
            tape.close()
        if arch in SERVER_FAMILIES:
            family_server(cfg, params)
        launches[arch] = pre["launches"] + sum(cached["launches"].values())
        wgmma += pre["wgmma"] + sum(cached["wgmma"].values())
        family_times(dev, cfg, params, cached["cache"], card)
        if not cfg.use_mla:
            by_config[arch] = flash_at(dev, cfg, card)
        print(f"  {arch}: {launches[arch]} flash launches on its paths; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        del params, cached, pre, tape  # the tape holds the MoE modules too
        torch.cuda.empty_cache()
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as pool:
        traced = pool.submit(traced_family_steps, card).result()
    print("  traced serve_step idle share by config: " + ", ".join(
        f"{a} " + ("not measured" if t is None else
                   f"{1 - t['busy_ms'] / t['wall_ms']:.4f} (wall {t['wall_ms']:.2f} ms, busy "
                   f"{t['busy_ms']:.2f} ms)") for a, t in traced.items()) + f" [{card}]")
    print(f"  phase 17: flash launches by config {launches} (all wgmma: "
          f"{wgmma == sum(launches.values())}); {time.perf_counter() - t_phase:.1f} s")
    if wgmma != sum(launches.values()):
        raise AssertionError("phase 17: a flash launch took the CUDA-core kernel")
    return {"launches": launches, "wgmma": wgmma, "by_config": by_config}


# ---------------------------------------------------------------------------
# Pipeline planning and the example twins (phase 18)
# ---------------------------------------------------------------------------

PIPELINE_STAGES = (2, 4, 8)
PIPELINE_BATCH, PIPELINE_SEQ = 8, 1024
# (config, stages) where a beam of 16 ends more than 2% above the exact
# DP on H100 stages, on both links: qwen2-vl-72b's memory cliff (the same
# set ``tests/test_torch_pipeline.py`` pins); any other gap fails
BEAM_MISSES = {("qwen2-vl-72b", 4), ("qwen2-vl-72b", 8)}
TWINS = ("torch_fleet_sweep", "torch_adaptive_replanning", "torch_pareto_frontier",
         "torch_serve_split_llm")
# host walls and rates in the twins' lines differ from run to run
TWIN_WALLS = ((r"in [0-9.]+ ms \([0-9,]+ scenarios/s\)", "in <wall> ms (<rate> scenarios/s)"),
              (r"built in [0-9]+ ms", "built in <wall> ms"),
              (r"\[[0-9]+ us/observe\]", "[<wall> us/observe]"),
              (r"frontiers in [0-9.]+ ms", "frontiers in <wall> ms"),
              (r"in [0-9.]+s \([0-9.]+ tok/s on \w+\)", "in <wall>s (<rate> tok/s)"))


def phase_pipeline_plans(card) -> dict:
    """(a) ``plan_pipeline`` on every config's full-size graph over H100
    stages: beam and the exact DP at 2, 4 and 8 stages on NVLink and
    InfiniBand; both agree on feasibility, the DP is never above the beam
    and the beam is within 2% of it outside :data:`BEAM_MISSES`."""
    import math

    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core import profiles as P
    from repro_torch.core.planner import plan_pipeline
    from repro_torch.models.graph import arch_layer_graph

    hw = P.H100_SXM
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  (a) plan_pipeline on {hw.name} stages ({hw.peak_flops / 1e12:g} TFLOP/s bf16, "
          f"{hw.hbm_bytes_per_s / 1e12:g} TB/s, {hw.hbm_bytes:,} B of memory, 90% of it "
          f"usable); this card reports total_memory {total:,} B [{card}]")
    walls = {"beam": [], "optimal_dp": []}
    misses, infeasible = [], []
    for arch in ARCH_IDS:
        g = arch_layer_graph(get_config(arch), PIPELINE_BATCH, PIPELINE_SEQ)
        for link in (P.NVLINK, P.INFINIBAND):
            parts = []
            for n in PIPELINE_STAGES:
                plans = {}
                for solver in walls:
                    t0 = time.perf_counter()
                    plans[solver] = plan_pipeline(g, n, link=link, solver=solver)
                    walls[solver].append(time.perf_counter() - t0)
                beam, opt = (plans[k].objective_cost_s for k in ("beam", "optimal_dp"))
                where = f"{arch} {n} stages {link.name}"
                if math.isinf(beam) or math.isinf(opt):
                    if beam != opt:
                        raise AssertionError(f"{where}: beam {beam} s, DP {opt} s")
                    infeasible.append(where)
                    parts.append(f"{n}: infeasible (both)")
                    continue
                if opt > beam:
                    raise AssertionError(f"{where}: the exact DP {opt} above the beam {beam}")
                within = beam <= opt * 1.02
                if within == ((arch, n) in BEAM_MISSES):
                    raise AssertionError(f"{where}: beam / DP {beam / opt:.4f}; the known "
                                         f"gaps are {sorted(BEAM_MISSES)}")
                part = f"{n}: {plans['beam'].splits} {beam * 1e3:.4f} ms"
                if not within:
                    misses.append(where)
                    part += (f" (DP {plans['optimal_dp'].splits} {opt * 1e3:.4f} ms: beam "
                             f"{beam / opt:.3f}x)")
                parts.append(part)
            print(f"  {arch} ({g.num_layers} nodes, {g.total_params * 2 / 1e9:.1f} GB bf16) "
                  f"{link.name}: bottleneck by stages " + "; ".join(parts))
    n_plans = len(walls["beam"])
    print(f"      {2 * n_plans} plans; infeasible (weights over the stages' memory) in "
          f"{len(infeasible)}: {', '.join(infeasible)}; beam above 1.02 x the DP in "
          f"{len(misses)}: {', '.join(misses)}; host walls: beam "
          f"{sum(walls['beam']):.3f} s in all (max {max(walls['beam']) * 1e3:.1f} ms), DP "
          f"{sum(walls['optimal_dp']):.3f} s (max {max(walls['optimal_dp']) * 1e3:.1f} ms)")
    return {"plans": 2 * n_plans, "beam_s": sum(walls["beam"]),
            "dp_s": sum(walls["optimal_dp"]), "misses": misses, "infeasible": infeasible}


def twins_run(device) -> dict:
    """The four example twins' ``main`` on ``device``: their printed lines
    (walls masked) and, for the serve twin, its tokens and, per
    ``serve_step`` call of its ``Server``, each slot's greedy pick and the
    top-two logit gap. A ``spawn`` worker runs the CPU side."""
    import contextlib
    import importlib.util
    import io
    import re

    from repro_torch.core import cuda_dp as CD
    from repro_torch.models import transformer as T

    out = {"lines": {}, "walls": {}, "dp": {}}
    calls = []
    step = T.serve_step

    def recording_step(cfg, params, inputs, cache):
        logits, cache = step(cfg, params, inputs, cache)
        top2 = logits[:, 0, :cfg.vocab].float().topk(2, dim=-1)
        calls.append((top2.indices[:, 0].tolist(),
                      (top2.values[:, 0] - top2.values[:, 1]).tolist()))
        return logits, cache

    T.serve_step = recording_step
    try:
        for name in TWINS:
            spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            before = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                result = mod.main(device)
            out["walls"][name] = time.perf_counter() - t0
            out["dp"][name] = {"dense_dp": CD.DENSE_LAUNCHES - before[0],
                               "fused_dp": CD.FUSED_LAUNCHES - before[1]}
            lines = buf.getvalue().splitlines()
            for pattern, repl in TWIN_WALLS:
                lines = [re.sub(pattern, repl, line) for line in lines]
            out["lines"][name] = lines
            if name == "torch_serve_split_llm":
                out["serve"] = {"results": result["results"], "hops": result["hops"],
                                "hop_seconds": result["hop_seconds"], "calls": calls}
    finally:
        T.serve_step = step
    return out


def phase_twins(card) -> dict:
    """(b) the four example twins on the card while a ``spawn`` worker runs
    them on the CPU: every line equal (walls masked), the served tokens
    equal; the DP launches around the card run counted."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.core import cuda_dp as CD

    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as pool:
        cpu_run = pool.submit(twins_run, "cpu")
        before = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES
        t0 = time.perf_counter()
        gpu = twins_run("cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        after = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES
        cpu = cpu_run.result()
    launches = {"dense_dp": after[0] - before[0], "fused_dp": after[1] - before[1]}
    tiled = after[2] - before[2]
    for name in TWINS:
        got, want = gpu["lines"][name], cpu["lines"][name]
        if got != want:
            diff = next(i for i, (a, b) in enumerate(zip(got + [""], want + [""])) if a != b)
            raise AssertionError(f"{name}: the card's line {diff} differs from the CPU's:\n"
                                 f"  {got[diff] if diff < len(got) else '<none>'}\n  "
                                 f"{want[diff] if diff < len(want) else '<none>'}")
        print(f"  (b) {name}: {len(got)} lines on the card == the CPU's (walls masked); "
              f"card {gpu['walls'][name]:.2f} s, CPU {cpu['walls'][name]:.2f} s; DP launches "
              f"{gpu['dp'][name]}; last: {got[-1].strip()}")
    ours, theirs = gpu["serve"], cpu["serve"]
    if ours["results"] != theirs["results"]:
        first = next(i for i, (a, b) in enumerate(zip(ours["calls"], theirs["calls"]))
                     if a[0] != b[0])
        slot = next(j for j, (a, b) in enumerate(zip(ours["calls"][first][0],
                                                     theirs["calls"][first][0])) if a != b)
        raise AssertionError(f"serve twin: tokens differ first at serve_step call {first}, "
                             f"slot {slot}; the CPU's top-two logit gap there "
                             f"{theirs['calls'][first][1][slot]:.4g}")
    gaps = [g for _, row in theirs["calls"] for g in row]
    print("      " + "\n      ".join(gpu["lines"]["torch_serve_split_llm"]))
    print(f"      serve twin: {sum(map(len, ours['results'].values()))} tokens of "
          f"{len(ours['results'])} requests == the CPU's; {ours['hops']} hops, "
          f"{ours['hop_seconds']:.6f} s == the CPU's; smallest CPU top-two gap over its "
          f"{len(theirs['calls'])} serve_step calls {min(gaps):.4g}")
    if launches["fused_dp"] < 1 or launches["dense_dp"] < 1:
        raise AssertionError(f"twins on the card: DP launches {launches}")
    print(f"      DP launches around the card run: dense {launches['dense_dp']}, fused "
          f"{launches['fused_dp']} ({tiled} tiled); card side {t_card:.1f} s [{card}]")
    return {"launches": launches, "tiled": tiled}


def phase_planning_twins(card) -> dict:
    """Phase 18: pipeline planning over H100 stages, then the twins."""
    t0 = time.perf_counter()
    plans = phase_pipeline_plans(card)
    t1 = time.perf_counter()
    twins = phase_twins(card)
    print(f"  phase 18: pipeline plans {t1 - t0:.1f} s, twins {time.perf_counter() - t1:.1f} "
          f"s; {time.perf_counter() - t0:.1f} s")
    return {**twins, "pipeline": plans}


# ---------------------------------------------------------------------------
# SSM and hybrid models at full width (phase 19)
# ---------------------------------------------------------------------------

HYBRIDS = ("zamba2-1.2b", "xlstm-1.3b")
# (c): prompt tokens streamed through serve_step; (e): serve_step timing window
HYBRID_STREAM, HYBRID_DECODE = 128, 16
# (b), (c) in float32, max |diff| over std: the root-sum-square of the
# contract rtols of the kernel calls a zamba2 prefill makes (33 SSD calls
# at 2e-4, 5 float32 flash calls at 1e-3); xlstm's paths (no kernel) are
# held to the same. In bf16 equally valid orders of zamba2 at random init
# already differ 0.20-0.70 x std (tools/hybrid_logit_sensitivity.py), so
# the bf16 gaps are printed beside the gap from halving scan_chunk.
HYBRID_F32_TOL = float(np.sqrt(33 * 2e-4 ** 2 + 5 * 1e-3 ** 2))


class ScanProbe:
    """While entered, every ``ssm.mamba_scan`` call (one per Mamba2 layer)
    is checked on its own inputs: the SSD kernel's float32 y against the
    reference's chunk body (``mamba_scan_plain``) run on the card on the
    same tensors, within the kernel's contract (``SSD_TOL["float32"]``:
    rtol 2e-4, atol 1e-4). With ``plain=True`` each call runs the chunk
    body instead, unchecked (the twin)."""

    def __init__(self, plain=False):
        self.plain, self.layers = plain, []

    def __enter__(self):
        from repro_torch.models import ssm

        self.ssm, self.scan = ssm, ssm.mamba_scan
        ssm.mamba_scan = self._scan
        return self

    def __exit__(self, *exc):
        self.ssm.mamba_scan = self.scan

    def _scan(self, x, b, c, dA, dt, chunk):
        if self.plain:
            return self.ssm.mamba_scan_plain(x, b, c, dA, dt, chunk)
        y = self.scan(x, b, c, dA, dt, chunk)
        err, used = within(y, self.ssm.mamba_scan_plain(x, b, c, dA, dt, chunk),
                           *SSD_TOL["float32"])
        self.layers.append({"err": err, "used": used, "y": str(y.dtype)[6:],
                            "shape": tuple(x.shape)})
        return y


def hybrid_counts(run) -> tuple:
    """(result, {"ssd", "flash", "wgmma"} launches) of ``run()``, the
    counters zeroed just before it and read just after."""
    import torch

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import kernel as SK

    SK.reset_launch_count()
    FA.reset_launch_count()
    out = run()
    torch.cuda.synchronize()
    return out, {"ssd": SK.SSD_LAUNCHES, "flash": FA.FLASH_LAUNCHES,
                 "wgmma": FA.FLASH_WGMMA_LAUNCHES}


def check_counts(what, cfg, counts, bf16=True) -> None:
    """One SSD launch per Mamba2 layer and one flash launch per application
    of an attention block (Sq > 8), of the wgmma kernel in bf16 and of
    the CUDA-core kernel in float32."""
    n_attn = cfg.pattern.count("attn")
    want = {"ssd": cfg.pattern.count("mamba"), "flash": n_attn, "wgmma": n_attn if bf16 else 0}
    if counts != want:
        raise AssertionError(f"{cfg.name} {what}: launches {counts}, expected {want}")


def hybrid_setup(dev, arch):
    """The config at full width, its twin config (chunked attention) and
    the seeded weights made on the card in bf16 and, from the same draws,
    in float32."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = replace(get_config(arch), use_flash_kernel=True)
    t0 = time.perf_counter()
    params, params32 = (T.init_params(replace(cfg, dtype=dt_), device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(0))
                        for dt_ in ("bfloat16", "float32"))
    torch.cuda.synchronize()
    kinds = {k: cfg.pattern.count(k) for k in dict.fromkeys(cfg.pattern)}
    mixers = (f"Mamba2 d_inner {cfg.d_inner} = {cfg.d_inner // cfg.ssm_head_dim} heads of "
              f"{cfg.ssm_head_dim}, ds {cfg.ssm_state}" if "mamba" in kinds else
              f"mLSTM / sLSTM d_inner {cfg.d_inner} = {cfg.n_heads} heads of "
              f"{cfg.d_inner // cfg.n_heads}")
    print(f"  {arch}: {cfg.n_layers} layers {kinds}"
          + (" (one shared attention block)" if cfg.shared_attn else "")
          + f", d {cfg.d_model}, {mixers}, chunk {cfg.scan_chunk}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {sum(p.numel() for p in params.parameters()) / 1e9:.3f} G "
          f"parameters made on the card in bf16 and float32 (the same draws) in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, replace(cfg, use_flash_kernel=False), params, params32


def hybrid_prefill_step(dev, cfg, twin, params, params32) -> dict:
    """(a) the bf16 prefill step 2 x 1024 with every Mamba2 scan and every
    attention call held to its plain version on its own inputs; (b) its
    last-position logits against the twin's (the chunk body, chunked
    attention), in float32 within ``HYBRID_F32_TOL`` x std, in bf16 beside
    the gap from halving ``scan_chunk``."""
    import torch

    from repro_torch.launch.steps import make_prefill_step

    batch = family_batch(dev, cfg, FAMILY_P)
    counts = {}
    with AttentionProbe() as attn, ScanProbe() as scan:
        got, counts["prefill step (a)"] = hybrid_counts(
            lambda: make_prefill_step(cfg)(params, batch))
    check_counts("prefill step", cfg, counts["prefill step (a)"])
    if (len(scan.layers), len(attn.layers)) != (cfg.pattern.count("mamba"),
                                                cfg.pattern.count("attn")):
        raise AssertionError(f"{cfg.name}: probed {len(scan.layers)} scans and "
                             f"{len(attn.layers)} attention calls")
    notes = []
    if scan.layers:
        worst = max(scan.layers, key=lambda e: e["used"])
        if worst["used"] > 1.0 or {e["y"] for e in scan.layers} != {"float32"}:
            raise AssertionError(f"{cfg.name}: a Mamba2 scan beyond the SSD contract or not "
                                 f"float32 ({worst})")
        notes.append(f"every Mamba2 scan {scan.layers[0]['shape']} (float32 x, B, C) vs the "
                     f"chunk body on the card (rtol {SSD_TOL['float32'][0]}, atol "
                     f"{SSD_TOL['float32'][1]}): share of the limit by layer "
                     f"{[round(e['used'], 3) for e in scan.layers]}, worst "
                     f"{worst['used']:.3f}, max abs err "
                     f"{max(e['err'] for e in scan.layers):.4g}")
    if attn.layers:
        worst = max(attn.layers, key=lambda e: e["used"])
        if worst["used"] > 1.0:
            raise AssertionError(f"{cfg.name}: a shared-attention flash call beyond the "
                                 f"contract ({worst})")
        notes.append(f"every shared-attention flash call vs attention_ref (rtol "
                     f"{FLASH_TOL_FULL_BF16[0]}, atol {FLASH_TOL_FULL_BF16[1]}): share by "
                     f"call {[round(e['used'], 3) for e in attn.layers]}, worst "
                     f"{worst['used']:.3f}; vs plain_attention worst "
                     f"{max(e['plain_used'] for e in attn.layers):.3f}")
    if not notes:
        notes.append("no kernel on this path (mLSTM and sLSTM run PyTorch ops)")
    print(f"  (a) prefill step {FAMILY_B} x {FAMILY_P}, bf16: launches "
          f"{counts['prefill step (a)']}; " + "; ".join(notes))
    if tuple(got.shape) != (FAMILY_B, cfg.vocab_padded) \
            or not bool(torch.isfinite(got[..., :cfg.vocab]).all()):
        raise AssertionError(f"{cfg.name} prefill step: bad logits {tuple(got.shape)}")
    with ScanProbe(plain=True):
        want, twin_counts = hybrid_counts(lambda: make_prefill_step(twin)(params, batch))
    half = replace(cfg, scan_chunk=cfg.scan_chunk // 2)
    other, counts["prefill step, scan_chunk / 2 (b)"] = hybrid_counts(
        lambda: make_prefill_step(half)(params, batch))
    check_counts("prefill step, scan_chunk / 2", cfg, counts["prefill step, scan_chunk / 2 (b)"])
    cfg32, twin32 = replace(cfg, dtype="float32"), replace(twin, dtype="float32")
    got32, counts["prefill step float32 (b)"] = hybrid_counts(
        lambda: make_prefill_step(cfg32)(params32, batch))
    check_counts("float32 prefill step", cfg, counts["prefill step float32 (b)"], bf16=False)
    with ScanProbe(plain=True):
        want32, twin32_counts = hybrid_counts(lambda: make_prefill_step(twin32)(params32, batch))
    if any(twin_counts.values()) or any(twin32_counts.values()):
        raise AssertionError(f"{cfg.name}: the twin launched {twin_counts}, {twin32_counts}")
    err32, std32 = logits_err(got32, want32, cfg)
    err, std = logits_err(got, want, cfg)
    floor, _ = logits_err(other, got, cfg)
    print(f"  (b) last-position logits {tuple(got.shape)} vs the twin (chunk body, chunked "
          f"attention, no kernel): float32 max abs err {err32:.4g} = {err32 / std32:.5f} x std "
          f"{std32:.4g} (tolerance {HYBRID_F32_TOL:.5f} x std); bf16 {err / std:.4f} x std "
          f"{std:.4g}, and the kernel run vs itself at scan_chunk {half.scan_chunk} "
          f"{floor / std:.4f} x std (equally valid bf16 orders)")
    if not err32 <= HYBRID_F32_TOL * std32:
        raise AssertionError(f"{cfg.name} prefill step: float32 logits beyond tolerance")
    return {"counts": counts, "batch": batch}


class RecurrentProbe:
    """While entered, keeps each recurrent block's one-token steps (the
    mixer's input and output per ``serve_step``): ``check()`` then runs
    every Mamba2 and mLSTM layer's chunked form on that layer's streamed
    inputs and holds the streamed outputs to it (max |diff| <=
    ``HYBRID_F32_TOL`` x the layer output's rms); sLSTM has one form, so
    its sequence run on the same inputs is only printed."""

    def __enter__(self):
        from repro_torch.models import ssm

        self.ssm, self.steps = ssm, {}
        self.saved = {name: getattr(ssm, name) for name in ("mamba_step", "mlstm_step",
                                                            "slstm_forward")}
        for name, fn in self.saved.items():
            setattr(ssm, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ssm, name, fn)

    def _wrap(self, name, fn):
        def step(cfg, p, x, cache=None):
            y, new = fn(cfg, p, x, cache)
            _, _, xs, ys = self.steps.setdefault(id(p), (name, p, [], []))
            xs.append(x)
            ys.append(y)
            return y, new
        return step

    def check(self, cfg) -> list:
        import torch

        forms = {"mamba_step": self.ssm.mamba_chunked, "mlstm_step": self.ssm.mlstm_chunked}
        out = []
        for name, p, xs, ys in self.steps.values():
            x, y = torch.cat(xs, 1), torch.cat(ys, 1)
            if name in forms:
                want = forms[name](cfg, p, x, chunk=cfg.scan_chunk)
            else:
                want, _ = self.saved["slstm_forward"](cfg, p, x)
            used = float((y - want).abs().max() / (HYBRID_F32_TOL * want.float().square()
                                                   .mean().sqrt()))
            out.append((name.split("_")[0], used))
        return out


def hybrid_stream(dev, cfg, params, params32) -> dict:
    """(c) a 128-token prompt fed token by token through ``serve_step``
    from a fresh cache, as the ``Server`` feeds it, in bf16 and in
    float32: (1) each Mamba2 and mLSTM layer's streamed outputs against
    its chunked form on the same inputs (float32, :class:`RecurrentProbe`);
    (2) the last step's logits against the uncached forward's at position
    127, the float32 gap held to ``HYBRID_F32_TOL`` x std where halving
    the chunk the prompt takes moves the float32 forward less than that (a
    stack that turns rounding into whole std cannot be compared whole),
    the bf16 gap printed. The streamed steps launch no kernel. Returns the bf16
    stream's cache and last logits for (e)."""
    from repro_torch.models import transformer as T

    tokens = family_batch(dev, cfg, HYBRID_STREAM, seed=2)["tokens"]
    counts, gaps, out, layers = {}, {}, {}, []
    for name, p, c in (("bf16", params, cfg), ("float32", params32, replace(cfg, dtype="float32"))):
        path = f"forward S={HYBRID_STREAM}" + (" float32" if name == "float32" else "") + " (c)"
        full, counts[path] = hybrid_counts(
            lambda: T.forward(c, p, {"tokens": tokens})[0][:, -1])
        check_counts(path, cfg, counts[path], bf16=name == "bf16")
        cache = T.init_cache(c, FAMILY_B, HYBRID_STREAM + HYBRID_DECODE, device=dev)

        def stream():
            nonlocal cache
            for t in range(HYBRID_STREAM):
                logits, cache = T.serve_step(c, p, {"tokens": tokens[:, t:t + 1],
                                                    "cur_index": t}, cache)
            return logits[:, 0]

        t0 = time.perf_counter()
        with RecurrentProbe() as probe:
            last, stream_counts = hybrid_counts(stream)
        wall = time.perf_counter() - t0
        if any(stream_counts.values()):
            raise AssertionError(f"{cfg.name}: serve_steps launched {stream_counts}")
        err, std = logits_err(last, full, cfg)
        gaps[name] = (err / std, wall)
        out[name] = {"cache": cache, "last": last}
        if name == "float32":
            layers = probe.check(c)
            # half the chunk the stream's prompt actually takes, so the
            # arithmetic moves (a chunk at or above S covers it whole)
            half = replace(c, scan_chunk=min(c.scan_chunk, HYBRID_STREAM) // 2)
            path = f"forward S={HYBRID_STREAM} float32, scan_chunk / 2 (c)"
            other, counts[path] = hybrid_counts(
                lambda: T.forward(half, p, {"tokens": tokens})[0][:, -1])
            check_counts(path, cfg, counts[path], bf16=False)
            floor_err, floor_std = logits_err(other, full, cfg)
            floor = floor_err / floor_std
        del probe
    checked = [u for kind, u in layers if kind != "slstm"]
    slstm = [u for kind, u in layers if kind == "slstm"]
    comparable = floor <= HYBRID_F32_TOL
    print(f"  (c) {HYBRID_STREAM} prompt tokens through serve_step (no kernel launch; "
          f"{gaps['float32'][1]:.2f} s float32, {gaps['bf16'][1]:.2f} s bf16): each of the "
          f"{len(checked)} Mamba2 / mLSTM layers' streamed outputs vs its chunked form on the "
          f"same inputs (float32), share of the limit ({HYBRID_F32_TOL:.5f} x rms) worst "
          f"{max(checked):.4f}, by layer {[round(u, 4) for u in checked]}"
          + (f"; sLSTM sequence vs steps (one form) {[round(u, 4) for u in slstm]}" if slstm
             else "")
          + f"; last logits vs the uncached forward at position {HYBRID_STREAM - 1}: float32 "
          f"{gaps['float32'][0]:.5f} x std, the float32 forward vs itself at scan_chunk "
          f"{min(cfg.scan_chunk, HYBRID_STREAM) // 2} {floor:.5f} x std ("
          + ("comparable: tolerance" if comparable else "not comparable whole: above")
          + f" {HYBRID_F32_TOL:.5f}), bf16 {gaps['bf16'][0]:.4f} x std")
    if max(checked) > 1.0:
        raise AssertionError(f"{cfg.name}: a layer's recurrent steps beyond tolerance of its "
                             f"chunked form")
    if comparable and not gaps["float32"][0] <= HYBRID_F32_TOL:
        raise AssertionError(f"{cfg.name}: recurrent decode beyond tolerance of the chunked forms")
    return {"counts": counts, **out["bf16"]}


def gap_server(gaps: list):
    """A ``Server`` that appends to ``gaps`` each step's smallest top-two
    logit gap over the slots it steps (position >= 0)."""
    import torch

    from repro_torch.runtime.server import Server

    class GapServer(Server):
        def _decode(self, tokens, positions):
            logits = super()._decode(tokens, positions)
            live = torch.from_numpy(positions >= 0).to(logits.device)
            top2 = logits[:, 0, :self.cfg.vocab][live].topk(2, dim=-1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
            return logits

    return GapServer


def hybrid_server(dev, arch, card) -> None:
    """(d) ``Server``: at ``reduced()`` size in float32, weights seeded on
    the CPU and moved, 3 staggered requests on 2 slots served on the card
    and on the CPU give the same tokens (the smallest top-two gap of the
    CPU run printed); at full width 2 staggered requests, tokens/s. A
    request beside another need not equal it alone (the recurrent steps
    ignore positions, as the reference's), so that is not checked."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    small = get_config(arch).reduced()
    cpu = T.init_params(small, generator=torch.Generator().manual_seed(0), device="cpu")
    card_model = T.Transformer(small, device=dev)
    card_model.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(7)
    reqs = [(rid, rng.randint(0, small.vocab, size=n).astype(np.int32), 6)
            for rid, n in enumerate((5, 3, 7))]
    gaps = []
    want = serve_requests(cpu, small, reqs, slots=2, max_seq=32, server=gap_server(gaps))
    got = serve_requests(card_model, small, reqs, slots=2, max_seq=32)
    gap = min(gaps)
    if got != want:
        raise AssertionError(f"{arch} reduced Server: card tokens {got} != CPU {want} (the "
                             f"CPU run's smallest top-two gap {gap:.4g})")
    print(f"  (d) reduced Server (float32, 2 slots, 3 staggered requests, 6 new tokens each): "
          f"card tokens == CPU tokens; the CPU run's smallest top-two logit gap {gap:.4g}")


def hybrid_full_server(cfg, params, card) -> dict:
    """(d) at full width: 2 requests (8 and 5 prompt tokens, 8 new each) on
    2 slots, the second admitted a tick later."""
    import torch

    rng = np.random.RandomState(8)
    reqs = [(rid, rng.randint(0, cfg.vocab, size=n).astype(np.int32), 8)
            for rid, n in enumerate((8, 5))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, counts = hybrid_counts(lambda: serve_requests(params, cfg, reqs, slots=2,
                                                         max_seq=32))
    wall = time.perf_counter() - t0
    if any(counts.values()):
        raise AssertionError(f"{cfg.name} Server: launched {counts}")
    if any(len(t) != 8 or not all(0 <= x < cfg.vocab for x in t) for t in got.values()):
        raise AssertionError(f"{cfg.name} Server: a request did not drain")
    n = sum(len(t) for t in got.values())
    print(f"      full-width Server, 2 slots, 2 requests (8 and 5 prompt tokens, 8 new each): "
          f"drained, no kernel launch; {wall:.3f} s, {n / wall:.1f} generated tokens/s "
          f"({(n + 13) / wall:.1f} incl. prompt tokens) [{card}]")
    return {"wall_s": wall, "tokens": n}


def ssd_at(dev, cfg, card) -> dict:
    """The SSD kernel, its plain version (``ssm_scan_plain``) at zamba2's
    prefill shape (B 2 x S 1,024, float32 x, B, C: the model path's), beside
    the bound."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as SK

    H, ph, ds, ck = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, cfg.scan_chunk
    inputs = ssd_inputs(dev, FAMILY_B, FAMILY_P, H, ph, ds, torch.float32, 43)
    folded = fold_scan(*inputs)
    nbytes, flops, plain_flops = ssd_work(FAMILY_B, FAMILY_P, H, ph, ds, ck, torch.float32)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    plain_a = timed_ms(lambda: SK.ssm_scan_plain(*folded, chunk=ck), 3)
    ms = timed_ms(lambda: SK.ssm_scan_kernel(*folded, chunk=ck), 10)
    plain_ms = min(plain_a, timed_ms(lambda: SK.ssm_scan_plain(*folded, chunk=ck), 3))
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"      SSD at the prefill shape (B {FAMILY_B} S {FAMILY_P} H {H} ph {ph} ds {ds} chunk "
          f"{ck}, float32 x, B, C): kernel {ms:.4f} ms; plain {plain_ms:.3f} ms; bound "
          f"{bound:.4f} ms by {by} ({flops / 1e9:.2f} G bf16 piece flops in {ops_ms:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB in {bytes_ms:.4f} ms; the {plain_flops / 1e9:.2f} G flops "
          f"once each on the float32 CUDA cores {plain_flops / FP32_FLOPS_PER_S * 1e3:.4f} ms); "
          f"{ms / bound:.1f}x the bound; no PyTorch call computes it [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "shape": f"B {FAMILY_B} S {FAMILY_P} H {H} ph {ph} ds {ds} "
                                         f"chunk {ck} float32"}


def hybrid_times(dev, cfg, params, stream, card) -> dict:
    """(e) the prefill step's wall and tokens/s (launches counted), ms per
    ``serve_step`` over 16 greedy steps on the streamed cache."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    step, batch = make_prefill_step(cfg), family_batch(dev, cfg, FAMILY_P)
    walls = []

    def timed():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    _, counts = hybrid_counts(timed)
    cache, tok = stream["cache"], stream["last"][:, :cfg.vocab].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(HYBRID_DECODE):
        logits, cache = T.serve_step(cfg, params, {"tokens": tok, "cur_index":
                                                   HYBRID_STREAM + i}, cache)
        tok = logits[:, 0, :cfg.vocab].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / HYBRID_DECODE * 1e3
    n = FAMILY_B * FAMILY_P
    print(f"  (e) prefill step {FAMILY_B} x {FAMILY_P}: {min(walls):.4f} s ({n / min(walls):.1f} "
          f"tokens/s; runs {', '.join(f'{w:.4f}' for w in walls)} s; launches {counts}); "
          f"serve_step {step_ms:.3f} ms per step over {HYBRID_DECODE} greedy steps after the "
          f"{HYBRID_STREAM}-token prompt ({FAMILY_B * 1e3 / step_ms:.1f} tokens/s at "
          f"{FAMILY_B} rows) [{card}]")
    return {"prefill_s": min(walls), "step_ms": step_ms, "counts": counts}


def traced_hybrid_steps(card) -> dict:
    """In a fresh process: each config built as in phase 19, 8 prompt
    tokens streamed, two warm-up ``serve_step``s, one traced; then for
    zamba2 one traced prefill step (2 x 1024) after a warm-up."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    out = {}
    for arch in HYBRIDS:
        cfg = replace(get_config(arch), use_flash_kernel=True)
        params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        cache = T.init_cache(cfg, FAMILY_B, 16, device=dev)
        tokens = family_batch(dev, cfg, 8)["tokens"]
        for t in range(8):
            _, cache = T.serve_step(cfg, params, {"tokens": tokens[:, t:t + 1], "cur_index": t},
                                    cache)
        step = lambda: T.serve_step(cfg, params, {"tokens": tokens[:, :1], "cur_index": 8},
                                    cache)
        step()
        step()
        out[arch] = {"serve_step": traced_run(f"{arch} serve_step, {FAMILY_B} rows (a fresh "
                                              f"process)", step, card)}
        if "mamba" in cfg.pattern:  # xlstm's prefill is 127k launches of sLSTM steps
            prefill, batch = make_prefill_step(cfg), family_batch(dev, cfg, FAMILY_P)
            prefill(params, batch)
            out[arch]["prefill"] = traced_run(f"{arch} prefill step {FAMILY_B} x {FAMILY_P} (a "
                                              f"fresh process)", lambda: prefill(params, batch),
                                              card)
        for key, trace in out[arch].items():
            out[arch][key] = None if trace is None else {
                "wall_ms": trace["wall_ms"], "busy_ms": trace["busy_ms"],
                "top": sorted(trace["ops"].items(), key=lambda kv: -kv[1])[:4]}
        del params, cache
        torch.cuda.empty_cache()
    return out


def phase_hybrids(dev, card) -> dict:
    """Phase 19: zamba2-1.2b and xlstm-1.3b at full depth and width, one
    at a time, each freed before the next; then the traced steps in a
    fresh process."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    t_phase = time.perf_counter()
    launches, by_path, ssd, flash = {}, {}, None, None
    for arch in HYBRIDS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, twin, params, params32 = hybrid_setup(dev, arch)
        pre = hybrid_prefill_step(dev, cfg, twin, params, params32)
        stream = hybrid_stream(dev, cfg, params, params32)
        del params32
        hybrid_server(dev, arch, card)
        hybrid_full_server(cfg, params, card)
        times = hybrid_times(dev, cfg, params, stream, card)
        paths = {**pre["counts"], **stream["counts"], "prefill step timing (e)": times["counts"]}
        by_path[arch] = paths
        launches[arch] = {k: sum(c[k] for c in paths.values()) for k in ("ssd", "flash",
                                                                         "wgmma")}
        if "mamba" in cfg.pattern:
            ssd = ssd_at(dev, cfg, card)
        if "attn" in cfg.pattern:
            flash = flash_at(dev, cfg, card)
        print(f"  {arch}: launches on its paths {launches[arch]} (by path {paths}); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        del params, pre, stream, times
        torch.cuda.empty_cache()
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as pool:
        traced = pool.submit(traced_hybrid_steps, card).result()
    for arch, runs in traced.items():
        print(f"  traced {arch}: " + "; ".join(
            f"{what} " + ("not measured" if t is None else
                          f"idle share {1 - t['busy_ms'] / t['wall_ms']:.4f} (wall "
                          f"{t['wall_ms']:.2f} ms, busy {t['busy_ms']:.2f} ms; top "
                          + ", ".join(f"{k[:40]} {v:.2f} ms" for k, v in t["top"]) + ")")
            for what, t in runs.items()) + f" [{card}]")
    print(f"  phase 19: launches by config {launches}; {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "by_path": by_path, "ssd_at": ssd, "flash_at": flash,
            "traced": traced}


# ---------------------------------------------------------------------------
# Phase 20: training
# ---------------------------------------------------------------------------

# the full-width training runs are cut to 2 of 30 layers to keep the script
# within its time limit (4 until PR 33: the checkpoints' 19.8 GB took 36-45 s
# to save and ~55 s to restore)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, TRAIN_LR = "deepseek-7b", 2, 2048, 1e-3
# the Trainer's crash-and-resume run: steps, checkpoint period, failure step
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 4, 2, 3


def step_used(got: dict, want: dict, clipped: dict, extra: dict, lr: float,
              eps: float = 1e-8) -> tuple[float, int]:
    """Updated parameters after one AdamW step from zero moments, card
    against CPU. ``clipped`` is the CPU step's clipped mean gradient (its
    first moment over 1 - b1); its card-vs-CPU bound is T = 1e-4 x its
    largest |value| (``leaf_share``) plus ``extra`` (elementwise: the
    roundings of a bfloat16 accumulator).
    At step 1 delta = g / (|g| + eps) + wd p, so an error of T in g moves
    delta by at most T eps / (|g| - T + eps)^2. Where |g| > 2T each
    parameter is held within the larger of 1e-4 x rms(p) and lr times
    that; returns the largest share of that bound used, and the count of
    the rest (|g| <= 2T: the update's sign is open; each within 2 lr +
    4 ulp32, else fail)."""
    import torch

    used, loose = 0.0, 0
    for k, w in want.items():
        g, w64 = clipped[k].double().abs(), w.double()
        T = 1e-4 * float(g.max()) + extra[k]
        diff = (got[k].double() - w64).abs()
        firm = g > 2 * T
        bound = torch.clamp_min(lr * T * eps / (g - T + eps).clamp_min(eps) ** 2,
                                1e-4 * float(w64.square().mean().sqrt()))
        if firm.any():
            used = max(used, float((diff[firm] / bound[firm]).max()))
        ulp = torch.from_numpy(np.spacing(w.float().abs().numpy()).astype(np.float64))
        if (diff[~firm] > 2 * lr + 4 * ulp[~firm]).any():
            raise AssertionError(f"{k}: an update beyond 2 lr where |g| <= 2T")
        loose += int((~firm & (diff > 4 * ulp)).sum())
    return used, loose


def leaf_share(got: dict, want: dict, extra: dict | None = None, rms: bool = False) -> float:
    """The largest share any element uses of 1e-4 x its leaf's largest
    |value| (of 1e-4 x its rms with ``rms``), plus ``extra`` elementwise
    where given. A gradient's float32 rounding scales with its leaf's
    magnitude, and sLSTM gradients run to ~25 x their rms."""
    worst = 0.0
    for k, w in want.items():
        w64 = w.double()
        scale = float(w64.square().mean().sqrt()) if rms else float(w64.abs().max())
        limit = 1e-4 * max(scale, 1e-30)
        if extra is not None:
            limit = limit + extra[k]
        worst = max(worst, float(((got[k].double() - w64).abs() / limit).max()))
    return worst


def train_card_vs_cpu(dev, arch) -> dict:
    """(a) ``reduced()`` float32, 2 microbatches, the same seeded weights
    and batch on both devices: microbatch 0's loss and gradients, then one
    ``make_train_step`` (lr 1e-3). MoE configs replay the CPU run's
    expert picks on the card (``RoutingTape``): float32 near-ties flip
    top-k between devices. No kernel launches around the card's run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import loss_and_grads, make_prefill_step, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = replace(get_config(arch).reduced(), train_microbatches=2)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = T.Transformer(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    batch = SyntheticLMData(cfg, 4, 24, seed=1).batch_at(0)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    tapes = [RoutingTape(m) for m in (cpu, gpu)] if cfg.is_moe else None

    def run(model):
        loss0, grads = loss_and_grads(cfg, model, {k: v[0] for k, v in batch.items()})
        _, opt, metrics = step(model, adamw_init(model), batch)
        return (float(loss0), {k: g.cpu() for k, g in grads.items()}, float(metrics["loss"]),
                {k: v.cpu() for k, v in model.state_dict().items()},
                {k: v.cpu() for k, v in opt["mu"].items()}, float(metrics["grad_norm"]))

    if tapes:
        tapes[0].record()
    want = run(cpu)
    if tapes:
        tapes[1].tape = [t.to(dev) for t in tapes[0].tape]
        tapes[1].replay()
    got, counts = hybrid_counts(lambda: run(gpu))
    changed = None
    if tapes:
        if tapes[1].pos != len(tapes[1].tape):
            raise AssertionError(f"{arch}: replayed {tapes[1].pos} of {len(tapes[1].tape)} picks")
        changed = sum(tapes[1].changed)
        for tape in tapes:
            tape.close()
    if any(counts.values()):
        raise AssertionError(f"{arch} train step launched {counts}")
    loss_gap = max(abs(got[0] - want[0]) / abs(want[0]), abs(got[2] - want[2]) / abs(want[2]))
    grad_used = leaf_share(got[1], want[1])
    grad_rms = leaf_share(got[1], want[1], rms=True)
    clipped = {k: mu.double() / 0.1 for k, mu in want[4].items()}  # mu / (1 - b1)
    extra = accumulator_roundings(cfg, clipped, want[1], want[5])
    moment_used = leaf_share(got[4], want[4], {k: 0.1 * e for k, e in extra.items()})
    param_used, loose = step_used(got[3], want[3], clipped, extra, TRAIN_LR)
    n = sum(w.numel() for w in want[3].values())
    if (loss_gap > 1e-5 or grad_used > 1.0 or moment_used > 1.0 or param_used > 1.0
            or loose > 1e-2 * n):
        raise AssertionError(f"{arch}: loss gap {loss_gap:.3g} (limit 1e-5), gradients "
                             f"{grad_used:.3g} and first moment {moment_used:.3g} of their "
                             f"bounds, parameters {param_used:.3g} of theirs, {loose} of {n} "
                             f"updates undetermined")
    prefill = None
    if "mamba" in cfg.pattern:
        _, prefill = hybrid_counts(lambda: make_prefill_step(cfg)(gpu, batch_of(batch)))
        if prefill["ssd"] != cfg.pattern.count("mamba"):
            raise AssertionError(f"{arch}: a prefill after the train step launched {prefill}")
    print(f"    {arch}: loss gap {loss_gap:.3g} rel (limit 1e-5); microbatch 0's gradients "
          f"{grad_used:.4f} of 1e-4 x max|g| ({grad_rms:.4f} of 1e-4 x rms); the step's first "
          f"moment {moment_used:.4f} and updated parameters {param_used:.4f} of their bounds "
          f"({loose} of {n} updates within 2T of a zero gradient; accumulator "
          f"{cfg.grad_accum_dtype})"
          + ("" if changed is None else f"; replayed MoE picks, {changed} the card's router "
             "would change")
          + ("" if prefill is None else f"; prefill after it: {prefill}")
          + f"; launches {counts}")
    return {"loss_gap": loss_gap, "grad_used": grad_used, "grad_rms": grad_rms,
            "moment_used": moment_used, "param_used": param_used, "loose": loose,
            "counts": counts}


def accumulator_roundings(cfg, clipped: dict, grads0: dict, grad_norm: float) -> dict:
    """Elementwise bound, in clipped-gradient units, on what a bfloat16
    gradient accumulator's roundings can differ between two devices whose
    float32 gradients differ in the last bits: each of the N microbatch
    casts and each sum may round to the other neighbour, one bf16 ulp
    (<= 2^-7 x the value) apiece. With 2 microbatches that is 2^-7 x
    (|g0| + |g1| + |g0 + g1|), times clip / N (g1 from the accumulated sum
    and microbatch 0's gradient). Zero for a float32 accumulator."""
    if cfg.grad_accum_dtype == "float32":
        return {k: 0.0 for k in clipped}
    n, scale = cfg.train_microbatches, min(1.0, 1.0 / grad_norm)
    out = {}
    for k, g in clipped.items():
        acc, g0 = g * n / scale, grads0[k].double()
        out[k] = scale / n * 2.0 ** -7 * (g0.abs() + (acc - g0).abs() + acc.abs())
    return out


def batch_of(batch: dict) -> dict:
    """Microbatch 0 of a training batch, without its labels."""
    return {k: v[0] for k, v in batch.items() if k != "labels"}


def ops_refuse_autograd(dev) -> None:
    """(a) both kernel ops raise on grad-requiring CUDA inputs."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssm_scan.ops import ssm_scan

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 16, 2, 16), generator=g, device=dev) for _ in range(3))
    pos = torch.arange(16, dtype=torch.int32, device=dev)
    x = torch.randn((1, 24, 2, 8), generator=g, device=dev)
    b, c = (torch.randn((1, 24, 4), generator=g, device=dev) for _ in range(2))
    dt = torch.rand((1, 24, 2), generator=g, device=dev)
    calls = {"flash_attention": (q, lambda: flash_attention(q, k, v, q_positions=pos,
                                                            kv_positions=pos, scale=0.25)),
             "ssm_scan": (x, lambda: ssm_scan(x, b, c, -dt, dt, chunk=8))}
    for name, (leaf, call) in calls.items():
        leaf.requires_grad_(True)
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on a grad-requiring CUDA input")
    print("    both kernel ops raise RuntimeError on grad-requiring CUDA inputs")


def full_width_train_cfg():
    """deepseek-7b at full width (d 4,096, 32 heads of 128, d_ff 11,008,
    vocab 102,400), bf16, remat, 8 microbatches, cut to 2 of 30 layers."""
    from repro_torch.configs import get_config

    return replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


class Crash(RuntimeError):
    pass


def timed_store(root, walls: dict):
    """A ``CheckpointStore`` that records each save's and restore's wall."""
    from repro_torch.checkpoint.store import CheckpointStore

    class TimedStore(CheckpointStore):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            out = super().save(step, tree, extra)
            walls.setdefault("save", []).append(time.perf_counter() - t0)
            return out

        def restore(self, template, step=None):
            t0 = time.perf_counter()
            out = super().restore(template, step)
            walls.setdefault("restore", []).append(time.perf_counter() - t0)
            return out

    return TimedStore(root, keep=1)


def train_full_width(dev, card, n_params: int) -> dict:
    """(b) the ``Trainer`` at full width: a run of ``TRAIN_STEPS`` steps
    without a restart, then a run with ``ckpt_every=TRAIN_CKPT_EVERY``
    killed at step ``TRAIN_CRASH_AT``, then a resume from its newest
    checkpoint to the end. The resumed losses equal the uninterrupted
    run's within rel_tol 1e-5 (the reference test's bound); the step
    wall, tokens/s, peak memory and 6 N tokens / wall against the bf16
    peak from the uninterrupted run's steps after the first."""
    import math
    import tempfile

    import torch

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    cfg = full_width_train_cfg()
    data = SyntheticLMData(cfg, global_batch=cfg.train_microbatches, seq_len=TRAIN_SEQ)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    walls, out = {}, {}

    def fail_at(at):
        def hook(step):
            if step == at:
                raise Crash()
        return hook

    def crashing_run(trainer) -> list:
        try:
            trainer.run()
        except Crash:
            return trainer.history
        raise AssertionError("the injected failure did not fire")

    SK.reset_launch_count()
    FA.reset_launch_count()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        # the uninterrupted run: steps 0..TRAIN_STEPS-1 of a longer run,
        # stopped before step TRAIN_STEPS, so it writes no checkpoint (each
        # is 19.8 GB and ~40 s)
        a = Trainer(cfg, data, timed_store(Path(tmp) / "a", walls),
                    TrainLoopConfig(total_steps=TRAIN_STEPS + 1, ckpt_every=TRAIN_STEPS + 1),
                    opt_cfg=opt_cfg, failure_hook=fail_at(TRAIN_STEPS), device=dev)
        ref = crashing_run(a)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if a.store.steps():
            raise AssertionError(f"the uninterrupted run saved {a.store.steps()}")
        del a
        torch.cuda.empty_cache()
        store = timed_store(Path(tmp) / "b", walls)
        loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY)
        before = crashing_run(Trainer(cfg, data, store, loop, opt_cfg=opt_cfg,
                                      failure_hook=fail_at(TRAIN_CRASH_AT), device=dev))
        torch.cuda.empty_cache()
        if store.latest_step() != TRAIN_CKPT_EVERY:
            raise AssertionError(f"newest checkpoint {store.latest_step()}, expected "
                                 f"{TRAIN_CKPT_EVERY}")
        after = Trainer(cfg, data, store, loop, opt_cfg=opt_cfg, device=dev).run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    counts = {"ssd": SK.SSD_LAUNCHES, "flash": FA.FLASH_LAUNCHES}
    losses = {r.step: r.loss for r in ref}
    if sorted(losses) != list(range(TRAIN_STEPS)) or not all(
            math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"uninterrupted losses {losses}")
    if [r.step for r in after] != list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)):
        raise AssertionError(f"resumed at {[r.step for r in after]}")
    gaps = [abs(r.loss - losses[r.step]) / abs(losses[r.step]) for r in before + after]
    if any(counts.values()) or max(gaps) > 1e-5:
        raise AssertionError(f"resume gaps {gaps} (limit 1e-5), launches {counts}")
    bit_equal = all(r.loss == losses[r.step] for r in before + after)
    wall = float(np.median([r.wall_s for r in ref[1:]]))
    tokens = cfg.train_microbatches * TRAIN_SEQ
    mfu = 6 * n_params * tokens / wall / BF16_FLOPS_PER_S
    print(f"  (b) {TRAIN_ARCH} full width, {TRAIN_LAYERS} of 30 layers ({n_params:,} params; "
          f"bf16, float32 moments, remat, {cfg.train_microbatches} microbatches of 1 x "
          f"{TRAIN_SEQ}): losses {', '.join(f'{losses[s]:.5f}' for s in sorted(losses))}; "
          f"step walls {', '.join(f'{r.wall_s:.3f}' for r in ref)} s (the first builds); "
          f"median after the first {wall:.4f} s, {tokens / wall:,.0f} tokens/s, 6 N tokens / wall "
          f"{6 * n_params * tokens / wall / 1e12:.1f} TFLOP/s = {mfu:.4f} of the 989 TFLOP/s "
          f"bf16 peak; peak {out['peak_gb']:.1f} GB allocated; launches {counts} [{card}]")
    print(f"      crash at step {TRAIN_CRASH_AT}, resumed from step {TRAIN_CKPT_EVERY}: losses "
          f"{[round(r.loss, 6) for r in before + after]} vs the uninterrupted run's, max gap "
          f"{max(gaps):.3g} rel (limit 1e-5); bit-equal: {bit_equal}; checkpoint save walls "
          f"{', '.join(f'{w:.2f}' for w in walls.get('save', []))} s (background thread), "
          f"restore {', '.join(f'{w:.2f}' for w in walls.get('restore', []))} s [{card}]")
    return {"step_s": wall, "tokens_per_s": tokens / wall, "mfu": mfu, "n_params": n_params,
            "bit_equal": bit_equal, "max_gap": max(gaps), **out, "walls": walls}


def train_remat(dev, card) -> tuple:
    """(c) one microbatch (1 x 2,048) of the full-width model: gradients
    with ``remat`` equal those without bit for bit; the peak memory and
    wall of each. Returns the model and the gradients for (d)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import transformer as T

    cfg = full_width_train_cfg()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    mb = {k: v[0] for k, v in SyntheticLMData(cfg, cfg.train_microbatches, TRAIN_SEQ,
                                              seed=1).batch_at(0).items()}
    runs = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(replace(cfg, remat=remat), model, mb)
        torch.cuda.synchronize()
        runs[remat] = {"loss": loss, "grads": grads, "wall": time.perf_counter() - t0,
                       "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    on, off = runs[True], runs[False]
    same = torch.equal(on["loss"], off["loss"]) and all(
        torch.equal(g, off["grads"][k]) for k, g in on["grads"].items())
    print(f"  (c) remat, one microbatch 1 x {TRAIN_SEQ}: gradients with remat == without, bit "
          f"for bit: {same}; peak above the weights and earlier gradients "
          f"{on['peak_gb']:.2f} GB with remat, {off['peak_gb']:.2f} GB without; walls "
          f"{on['wall']:.3f} / {off['wall']:.3f} s (the first builds) [{card}]")
    if not same:
        raise AssertionError("remat changed the gradients")
    return model, off["grads"]


def train_compression(dev, model, grads, card) -> dict:
    """(d) ``compress_decompress`` on the card == the CPU bit for bit on a
    full-width gradient leaf (an up-projection, 4,096 x 11,008) with a
    seeded error buffer; ``wire_bytes`` over every leaf; one compressed
    train step at full width, finite."""
    import math

    import torch

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.compression import (
        compress_decompress,
        init_error_feedback,
        wire_bytes,
    )
    from repro_torch.runtime.train_loop import make_compressed_train_step

    name = "blocks.0.ff.w_in"
    g = grads[name]
    err = torch.randn(g.shape, generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev) * float(g.float().abs().max()) * 0.004
    got = compress_decompress(g, err)
    want = compress_decompress(g.cpu(), err.cpu())
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    comp, raw = wire_bytes(grads)
    del grads, got, err
    torch.cuda.empty_cache()
    cfg = full_width_train_cfg()
    opt = dict(adamw_init(model), error_feedback=init_error_feedback(model))
    batch = SyntheticLMData(cfg, cfg.train_microbatches, TRAIN_SEQ, seed=2).batch_at(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt, metrics = make_compressed_train_step(cfg, AdamWConfig(lr=TRAIN_LR))(model, opt, batch)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t0
    finite = math.isfinite(loss) and math.isfinite(float(metrics["grad_norm"])) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    print(f"  (d) compression: {name} {tuple(g.shape)} on the card == CPU bit for bit: {equal}; "
          f"wire bytes {comp:,} vs {raw:,} float32 ({raw / comp:.3f}x); one compressed step at "
          f"full width: loss {loss:.5f}, finite: {finite}, {wall:.3f} s [{card}]")
    if not (equal and finite and raw / comp > 3.9):
        raise AssertionError("compression check failed")
    return {"ratio": raw / comp, "step_s": wall}


def train_twin(card) -> dict:
    """(e) ``examples/torch_train_pipeline_lm.py`` at its defaults on the
    card: its lines, the ``LEARNING`` verdict, the resume, the plans."""
    import contextlib
    import importlib.util
    import io

    name = "torch_train_pipeline_lm"
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = mod.main(device="cuda")
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"      | {line}")
    hist = result["history"]
    _, _, fell = mod.learning([r.loss for r in hist])
    steps = [r.wall_s for r in hist[1:]]
    if not (fell and hist[0].step == result["resumed_from"]
            and any(line.startswith("beam PP plan over infiniband") for line in lines)):
        raise AssertionError("the training twin did not learn, resume or plan")
    print(f"  (e) the training twin at its defaults: LEARNING, resumed at step "
          f"{result['resumed_from']} after the crash at {result['crash_at']}; {wall:.1f} s, "
          f"median step {np.median(steps) * 1e3:.2f} ms [{card}]")
    return {"wall_s": wall, "step_ms": float(np.median(steps)) * 1e3}


def phase_training(dev, card) -> dict:
    """Phase 20: training, (a)-(e)."""
    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    print("  (a) reduced train step, card == CPU (float32, 2 microbatches):")
    card_cpu = {arch: train_card_vs_cpu(dev, arch) for arch in ARCH_IDS}
    ops_refuse_autograd(dev)
    t_a = time.perf_counter() - t_phase
    model, grads = train_remat(dev, card)
    n_params = T.param_count(model)
    comp = train_compression(dev, model, grads, card)
    del model, grads
    torch.cuda.empty_cache()
    full = train_full_width(dev, card, n_params)
    twin = train_twin(card)
    print(f"  phase 20: {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    return {"card_cpu": card_cpu, "full": full, "compression": comp, "twin": twin}


# --------------------------------------------------------------------------
# Phase 21: the multi-device layer
# --------------------------------------------------------------------------

SHARD_S, SHARD_N, SHARD_L = 65536, 5, 54
RANKS, RANK_S = 4, 16387  # no multiple of 4: the last shard is padded
PIPE_LAYERS, PIPE_M, PIPE_SEQ = 8, 8, 2048
PIPE_TIMED = 3  # timed runs of each plan after the checked one
RANK_DEADLINE_S = 300


def shard_inputs(S, N, L, seed):
    """A tie-rich float64 ``C`` and per-scenario fleet sizes, from a seed."""
    C = tie_rich_C(S, N, L, seed)
    return C, np.random.RandomState(seed + 1).randint(1, N + 1, size=S)


def differing_nodes(got, want) -> int:
    """Scenarios whose splits, cost or feasibility differ."""
    return int(((got.splits != want.splits).any(axis=1) | (got.cost_s != want.cost_s)
                | (got.feasible != want.feasible)).sum())


def shard_solves_in_one_process(card) -> int:
    """(a): the sharded backend on every card of this process; returns the
    dense launches of the sharded calls."""
    import torch

    from repro_torch.core import cuda_dp as CD
    from repro_torch.core import shard as SH
    from repro_torch.core.sweep import batched_optimal_dp, sweep

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(21)
    shape = (SHARD_S, SHARD_N, SHARD_L, SHARD_L)
    C_t = torch.randint(1, 41, shape, generator=g, device="cuda").float() / 4
    C_t.masked_fill_(torch.rand(shape, generator=g, device="cuda") < 0.15, float("inf"))
    C = C_t.cpu().double().numpy()
    del C_t
    ns = np.random.RandomState(21).randint(1, SHARD_N + 1, size=SHARD_S)
    main = grids()[0]
    t_inputs = time.perf_counter() - t0
    want = batched_optimal_dp(C, backend="cuda", n_devices=ns)
    want_k = batched_optimal_dp(C, backend="cuda", return_all_k=True)
    want_sweep = sweep(main, backend="torch")
    CD.reset_launch_counts()
    t0 = time.perf_counter()
    got = {"sharded_optimal_dp": SH.sharded_optimal_dp(C, n_devices=ns),
           "batched_optimal_dp(backend='sharded')": batched_optimal_dp(
               C, backend="sharded", n_devices=ns)}
    got_k = SH.sharded_optimal_dp(C, return_all_k=True)
    got_sweep = sweep(main, backend="sharded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fused = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES
    shards = SH.scenario_shards()
    print(f"  (a) {shards} shard(s), one per card, S={SHARD_S} N={SHARD_N} L={SHARD_L} "
          f"float32 (C {C.size * 4 / 1e9:.2f} GB on the card), per-scenario fleet sizes; "
          f"inputs in {t_inputs:.1f} s")
    for name, res in got.items():
        diff = differing_nodes(res, want)
        print(f"  {name}: {diff} nodes differ from backend='cuda' "
              f"(wall {res.wall_time_s:.3f} s vs {want.wall_time_s:.3f} s)")
        if diff or res.backend != "sharded":
            raise AssertionError(f"{name} != backend='cuda'")
    diff_k = sum(differing_nodes(got_k[n], want_k[n]) for n in want_k)
    print(f"  all-k (fleets 1..{SHARD_N}): {diff_k} nodes differ from backend='cuda'")
    if diff_k:
        raise AssertionError("sharded all-k != backend='cuda'")
    if not rows_equal(got_sweep, want_sweep):
        raise AssertionError("sweep(backend='sharded') != sweep(backend='torch')")
    print(f"  sweep(main, backend='sharded') on {main.size} scenarios == backend='torch' "
          f"(the same dense recurrence on the same C; the default 'cuda' sweep runs the "
          f"fused kernel, phase 4)")
    expected = shards * (len(got) + 1 + 2)  # two solves, all-k, the sweep's two models
    print(f"  dense launches of the sharded calls: {launches} (expected {expected}), "
          f"fused {fused}; {wall:.1f} s for the four calls [{card}]")
    if launches != expected or fused:
        raise AssertionError("the sharded calls did not launch one dense kernel per shard")
    return launches


def shard_rank(rank, world, port, out_dir):
    """One rank of (b): the distributed sharded solve on ``cuda:{rank % count}``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import cuda_dp as CD
    from repro_torch.core import shard as SH
    from repro_torch.core.spec import MeshSpec

    C, ns = shard_inputs(RANK_S, SHARD_N, SHARD_L, seed=2100)
    CD.reset_launch_counts()
    spec = MeshSpec(kind="distributed", coordinator=f"127.0.0.1:{port}",
                    num_processes=world, process_id=rank)
    res = SH.sharded_optimal_dp(C, n_devices=ns, mesh_spec=spec)
    torch.cuda.synchronize()
    counts = [None] * world
    dist.all_gather_object(counts, (CD.DENSE_LAUNCHES, str(SH.mesh_from_spec(spec).devices[rank])))
    if rank == 0:
        print(f"  rank 0: the ranks' dense launches and devices {counts}", flush=True)
    np.savez(Path(out_dir) / f"rank{rank}.npz", splits=res.splits, cost_s=res.cost_s,
             feasible=res.feasible, n_devices_s=res.n_devices_s,
             launches=CD.DENSE_LAUNCHES)
    dist.barrier()
    dist.destroy_process_group()


def shard_ranks(card) -> int:
    """(b): 4 ranks of a gloo group on the card(s); every rank's result ==
    the single-process ``backend="cuda"`` solve. Returns the ranks' dense
    launches."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core.sweep import batched_optimal_dp

    C, ns = shard_inputs(RANK_S, SHARD_N, SHARD_L, seed=2100)
    want = batched_optimal_dp(C, backend="cuda", n_devices=ns)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.spawn(shard_rank, args=(RANKS, port, out), nprocs=RANKS, join=False)
        deadline = time.monotonic() + RANK_DEADLINE_S
        while not ctx.join(timeout=1):  # a failed rank raises here
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the ranks did not finish in {RANK_DEADLINE_S} s")
        ranks = [dict(np.load(Path(out) / f"rank{r}.npz")) for r in range(RANKS)]
    wall = time.perf_counter() - t0
    launches = 0
    for r, got in enumerate(ranks):
        diff = differing_nodes(SimpleNamespace(**got), want)
        if diff or not np.array_equal(got["n_devices_s"], want.n_devices_s):
            raise AssertionError(f"rank {r}: {diff} nodes differ from backend='cuda'")
        launches += int(got["launches"])
    print(f"  (b) {RANKS} ranks (gloo, tcp://127.0.0.1:{port}), S={RANK_S} padded to "
          f"{RANK_S + (-RANK_S) % RANKS}: every rank == single-process backend='cuda' "
          f"node for node; {launches} dense launches in all; {wall:.1f} s with the spawn "
          f"[{card}]")
    if launches != RANKS:
        raise AssertionError(f"the ranks launched {launches} dense kernels, not {RANKS}")
    return launches


def pipeline_at_full_width(dev, card) -> dict:
    """(c): deepseek-7b's blocks (8 of 30) through the 4-stage pipeline."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.planner import stage_cost_profile, uniform_split
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as T
    from repro_torch.models.graph import arch_layer_graph
    from repro_torch.parallel import pipeline as PP

    S = 4
    cfg = replace(get_config("deepseek-7b"), n_layers=PIPE_LAYERS, use_flash_kernel=True)
    model = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(21),
                          device=dev)
    stacked = PP.stack_blocks(model)
    tokens = torch.randint(0, cfg.vocab, (PIPE_M, PIPE_SEQ),
                           generator=torch.Generator(device=dev).manual_seed(22), device=dev)
    with torch.no_grad():
        x = model.embed(tokens)[:, None]  # (M, 1, 2048, 4096)
    pos = torch.arange(PIPE_SEQ, dtype=torch.int32, device=dev).expand(1, PIPE_SEQ)
    apply = PP.transformer_block_apply(model, cfg, pos)
    block_mb = sum(t[0].numel() * t.element_size() for t in stacked.values()) / 1e6
    print(f"  (c) deepseek-7b {PIPE_LAYERS} of {get_config('deepseek-7b').n_layers} layers "
          f"(d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"{cfg.dtype}): {block_mb:.1f} MB a block, {PIPE_LAYERS * block_mb / 1e3:.2f} GB "
          f"stacked; {PIPE_M} microbatches of 1 x {PIPE_SEQ} tokens over {S} stages")
    want = []
    with torch.no_grad(), model.float32_scope():
        for h in x:
            for block in model.blocks:
                h = block(cfg, h, pos, None, 0, False)
            want.append(h)
    want = torch.stack(want)
    prof = stage_cost_profile(arch_layer_graph(cfg, 1, PIPE_SEQ))
    payload = x[0].numel() * x.element_size()
    out = {"launches": 0}
    for name, splits in (("uniform", uniform_split(PIPE_LAYERS, S)), ("uneven", (3, 5, 7))):
        plan = SimpleNamespace(splits=splits)
        ranges = PP.stage_assignment(plan, PIPE_LAYERS)
        depth = max(b - a + 1 for a, b in ranges)
        FA.reset_launch_count()
        got = PP.run_pipeline(plan, apply, stacked, PIPE_LAYERS, x, devices=[dev] * S)
        torch.cuda.synchronize()
        launches, wgmma = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
        expected = (PIPE_M + S - 1) * S * depth
        err = float((got.float() - want.float()).abs().max())
        walls = []
        for _ in range(PIPE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            PP.run_pipeline(plan, apply, stacked, PIPE_LAYERS, x, devices=[dev] * S)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        # block b of the pipeline is node b + 1 of the graph (node 0 embeds)
        bounds = [prof.boundary_act_bytes(b + 1) for b in splits]
        print(f"  {name} plan {splits} (stage depths {[b - a + 1 for a, b in ranges]}, "
              f"max {depth}): {launches} flash launches ({wgmma} wgmma; expected "
              f"{PIPE_M + S - 1} ticks x {S} stages x {depth} = {expected}); output vs the "
              f"8 blocks in order: bit-equal {torch.equal(got, want)}, max abs diff {err}; "
              f"ring payload {payload:,} B a tick, boundary_act_bytes {bounds}; "
              f"median of {PIPE_TIMED} runs {wall * 1e3:.1f} ms (min {min(walls) * 1e3:.1f}, "
              f"max {max(walls) * 1e3:.1f}), {PIPE_M * PIPE_SEQ / wall:,.0f} tokens/s [{card}]")
        if launches != expected or wgmma != expected:
            raise AssertionError(f"pipeline {name}: {launches} flash launches, not {expected}")
        if not torch.equal(got, want):
            raise AssertionError(f"pipeline {name}: output != the blocks in order")
        if any(b != payload for b in bounds):
            raise AssertionError(f"pipeline {name}: payload != boundary_act_bytes")
        out[name] = {"ms": wall * 1e3, "ms_runs": [w * 1e3 for w in walls],
                     "launches": launches}
        out["launches"] += launches
    return out


def phase_multi_device(dev, card) -> dict:
    """Phase 21: (a) the sharded backend in one process, (b) over 4 ranks,
    (c) the pipeline at deepseek-7b's full width."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    sharded = shard_solves_in_one_process(card)
    t_a = time.perf_counter() - t0
    sharded += shard_ranks(card)
    t_b = time.perf_counter() - t0 - t_a
    pipe = pipeline_at_full_width(dev, card)
    print(f"  phase 21: {time.perf_counter() - t0:.1f} s ((a) {t_a:.1f} s, (b) {t_b:.1f} s)")
    return {"sharded": sharded, "pipeline": pipe["launches"], "pipe": pipe}


CELL_ARCH = "deepseek-7b"
# the three cells of phase 22 (a), each cut to one card: (shape, batch,
# layers); the reference's batches are 32, 128 and 256, its depth 30
CELL_CUTS = {"prefill_32k": (1, 30), "decode_32k": (2, 30), "train_4k": (8, 4)}
GRAD_LAYERS, GRAD_M, GRAD_SEQ = 4, 4, 2048  # (c): 2 stages of 2 layers


def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group brought up
    from an in-memory store (no rendezvous on the network)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return make_host_mesh(model_parallel=1)


def cell_shape(name):
    from repro_torch.configs import SHAPES, ShapeSpec

    full = SHAPES[name]
    return ShapeSpec(name, full.kind, full.seq_len, CELL_CUTS[name][0])


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cell_memory(cfg, kind, args, shardings) -> tuple[int, int, float]:
    """(``run_cell``'s argument bytes of these arguments on this mesh, the
    bytes it counts the step as gathering beyond them, the step's peak
    allocated bytes so far)."""
    import torch

    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.steps import gathered_bytes

    return (sum(argument_bytes(a, s) for a, s in zip(args, shardings)),
            sum(gathered_bytes(cfg, kind, args, shardings).values()),
            torch.cuda.max_memory_allocated())


def serving_cells(dev, mesh, card) -> dict:
    """(a) prefill_32k and decode_32k at full width on the 1 x 1 mesh, each
    bit-equal to the same step without a mesh on the same weights. On one
    rank ``distribute`` copies every sharded leaf, so the model takes the
    DTensors' local tensors as its parameters (one copy of the weights on
    the card), and the cache is laid out one entry at a time, each
    original let go as its copy is made."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.steps import build_cell, make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.parallel.op_analysis import count_step
    from repro_torch.parallel.sharding import distribute

    cfg = replace(get_config(CELL_ARCH), use_flash_kernel=True)
    model, t_init = timed(lambda: T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(2200), device=dev))
    g = torch.Generator(device=dev).manual_seed(2201)
    out = {}

    shape = cell_shape("prefill_32k")
    step, args, sh = build_cell(cfg, shape, mesh)
    batch = {"tokens": torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                                     generator=g, device=dev, dtype=torch.int32)}
    params = distribute(dict(model.named_parameters()), sh[0])
    left = model.load_state_dict({k: v.to_local() for k, v in params.items()}, strict=False,
                                 assign=True)
    if left.missing_keys or left.unexpected_keys:
        raise AssertionError(f"the model's parameters != the cell's: {left}")
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_count()
    got, wall = timed(lambda: step(params, distribute(batch, sh[1])))
    launches, wgmma = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    arg_bytes, gathered, peak = cell_memory(cfg, shape.kind, args, sh)
    want, wall_ref = timed(lambda: make_prefill_step(cfg)(model, batch))
    equal = torch.equal(got, want)
    # the step returns a view of the whole (1, 32,768, Vp) float32 logits:
    # keep no result of the timed call
    warm = timed(lambda: step(params, distribute(batch, sh[1])))[1]
    print(f"  (a) {CELL_ARCH} at full width ({cfg.n_layers} layers, {cfg.dtype}, flash kernel), weights "
          f"made in {t_init:.1f} s; mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on a one-rank "
          f"NCCL group")
    print(f"  prefill_32k (batch {shape.global_batch} of 32, {shape.seq_len} tokens): logits "
          f"{tuple(got.shape)} bit-equal to make_prefill_step without a mesh: {equal}; "
          f"{launches} flash launches ({wgmma} wgmma) in the cell; walls: the cell's first call "
          f"{wall:.3f} s, no mesh {wall_ref:.3f} s, the cell again {warm:.3f} s; peak "
          f"allocated {peak / 1e9:.2f} GB beside run_cell's argument bytes "
          f"{arg_bytes / 1e9:.3f} GB + gathered {gathered / 1e9:.3f} GB [{card}]")
    if not equal or launches != cfg.n_layers or wgmma != cfg.n_layers:
        raise AssertionError(f"prefill cell: equal {equal}, {launches} flash launches "
                             f"({wgmma} wgmma), expected {cfg.n_layers}")
    out["prefill_32k"] = {"wall_s": wall, "wall_no_mesh_s": wall_ref, "wall_again_s": warm,
                          "peak_bytes": peak, "argument_bytes": arg_bytes,
                          "gathered_bytes": gathered, "launches": launches}
    del got, want
    torch.cuda.empty_cache()
    # (d)'s card run: the same cell once more under the op counter; the peak
    # is taken above what is allocated when the call starts (its arguments)
    inputs = distribute(batch, sh[1])
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_count()
    (got, trace), wall = timed(lambda: count_step(step, params, inputs))
    out["prefill_32k"]["counted"] = {
        "summary": trace_summary(trace), "wall_s": wall, "launches": FA.FLASH_LAUNCHES,
        "peak_above_start": torch.cuda.max_memory_allocated() - start}
    out["prefill_32k"]["counted_launches"] = FA.FLASH_LAUNCHES
    if FA.FLASH_LAUNCHES != cfg.n_layers:
        raise AssertionError(f"counted prefill cell: {FA.FLASH_LAUNCHES} flash launches")
    del got, inputs
    torch.cuda.empty_cache()

    shape = cell_shape("decode_32k")
    step, args, sh = build_cell(cfg, shape, mesh)
    if any(tuple(sh[0][k].placements) != tuple(p.placements) for k, p in params.items()):
        raise AssertionError("decode_32k lays the weights out unlike prefill_32k")
    cache, t_cache = timed(lambda: T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                                device=dev))
    for t in cache.values():
        t.normal_(generator=g)
    last = shape.seq_len - 1
    inputs = {"tokens": torch.randint(0, cfg.vocab, (shape.global_batch, 1), generator=g,
                                      device=dev, dtype=torch.int32),
              "cur_index": torch.tensor(last, dtype=torch.int32, device=dev)}
    before = cache["k"][:, :, last].clone()
    cache = {k: distribute({k: cache.pop(k)}, {k: sh[2][k]})[k] for k in list(cache)}
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_count()
    (got, _), wall = timed(lambda: step(params, distribute(inputs, sh[1]), cache))
    arg_bytes, gathered, peak = cell_memory(cfg, shape.kind, args, sh)
    local = {k: v.to_local() for k, v in cache.items()}
    written = {k: v[:, :, last].clone() for k, v in local.items()}
    # the step without a mesh on the same cache writes the same row again
    (want, _), wall_ref = timed(lambda: make_decode_step(cfg)(model, inputs, local))
    equal = torch.equal(got, want) and all(torch.equal(written[k], local[k][:, :, last])
                                           for k in local)
    warm = timed(lambda: step(params, distribute(inputs, sh[1]), cache))[1]
    cache_gb = sum(t.numel() * t.element_size() for t in local.values()) / 1e9
    print(f"  decode_32k (batch {shape.global_batch} of 128, a {shape.seq_len}-row cache of "
          f"{cache_gb:.1f} GB made in {t_cache:.1f} s, random rows, the step at row {last}): "
          f"logits and the written cache row bit-equal to make_decode_step without a mesh: "
          f"{equal}; the row changed: {not torch.equal(before, written['k'])}; flash launches "
          f"{FA.FLASH_LAUNCHES}; walls: the cell's first call {wall * 1e3:.1f} ms, no mesh "
          f"{wall_ref * 1e3:.1f} ms, the cell again {warm * 1e3:.1f} ms; peak allocated "
          f"{peak / 1e9:.2f} GB beside run_cell's argument bytes {arg_bytes / 1e9:.3f} GB "
          f"+ gathered {gathered / 1e9:.3f} GB [{card}]")
    if not equal or torch.equal(before, written["k"]):
        raise AssertionError("decode cell != make_decode_step without a mesh")
    out["decode_32k"] = {"wall_s": wall, "wall_no_mesh_s": wall_ref, "wall_again_s": warm,
                         "peak_bytes": peak, "argument_bytes": arg_bytes, "gathered_bytes": gathered}
    return out


def training_cell(dev, mesh, card) -> tuple[dict, object]:
    """(a) train_4k at full width, 4 of 30 layers, 8 microbatches of 1 x
    4,096 with the cell's ``accum_shardings``: loss, norm, every weight
    and moment the step returns (gathered whole) bit-equal to
    ``make_train_step(accum_shardings=None)`` on a copy of the same
    weights. Returns the record and the copy."""
    import torch

    from repro_torch.configs import effective_microbatches, get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import distribute

    layers = CELL_CUTS["train_4k"][1]
    cfg = replace(get_config(CELL_ARCH), n_layers=layers)
    shape = cell_shape("train_4k")
    n = effective_microbatches(cfg, shape, 1)
    models = [T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(2202),
                            device=dev) for _ in range(2)]
    opts = [adamw_init(dict(m.named_parameters())) for m in models]
    g = torch.Generator(device=dev).manual_seed(2203)
    batch = {k: torch.randint(0, cfg.vocab, (n, shape.global_batch // n, shape.seq_len),
                              generator=g, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step, args, sh = build_cell(cfg, shape, mesh)
    params = distribute(dict(models[0].named_parameters()), sh[0])
    opt = distribute(opts[0], sh[1])
    model, opt_ref = models[1], opts[1]
    del models, opts  # the cell's arguments are copies where they are sharded
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_count()
    (params, opt, got), wall = timed(lambda: step(params, opt, distribute(batch, sh[2])))
    arg_bytes, gathered, peak = cell_memory(cfg, shape.kind, args, sh)
    (_, opt_ref, want), wall_ref = timed(lambda: make_train_step(cfg, n_microbatches=n)(
        model, opt_ref, batch))
    same = {"metrics": all(torch.equal(got[k], want[k]) for k in want),
            "weights": all(torch.equal(params[k].full_tensor(), p)
                           for k, p in model.named_parameters()),
            "moments": all(torch.equal(opt[m][k].full_tensor(), opt_ref[m][k])
                           for m in ("mu", "nu") for k in opt_ref[m])}
    # a second step of the cell, timed warm (the first built its template
    # and met the allocator's growth and the group's first collective)
    warm = timed(lambda: step(params, opt, distribute(batch, sh[2])))[1]
    print(f"  train_4k ({layers} of 30 layers, {T.param_count(model):,} params, {cfg.dtype}, "
          f"float32 moments, remat; batch {shape.global_batch} of 256 as {n} microbatches of "
          f"{shape.global_batch // n} x {shape.seq_len}, the cell's accum_shardings): loss "
          f"{float(got['loss']):.6f}, grad norm {float(got['grad_norm']):.6f}; bit-equal to "
          f"make_train_step(accum_shardings=None) on a copy: {same}; flash launches "
          f"{FA.FLASH_LAUNCHES}; walls: the cell's first step {wall:.3f} s, no mesh "
          f"{wall_ref:.3f} s, the cell's second step {warm:.3f} s; peak allocated "
          f"{peak / 1e9:.2f} GB (both copies) beside run_cell's argument bytes "
          f"{arg_bytes / 1e9:.3f} GB + gathered {gathered / 1e9:.3f} GB [{card}]")
    if not all(same.values()):
        raise AssertionError(f"train cell != the step without a mesh: {same}")
    del opt, opt_ref, params
    torch.cuda.empty_cache()
    return {"wall_s": wall, "wall_no_mesh_s": wall_ref, "wall_again_s": warm,
            "peak_bytes": peak, "argument_bytes": arg_bytes, "gathered_bytes": gathered}, model


def pipeline_gradients(dev, model, card) -> dict:
    """(c) the pipeline's gradients at full width: ``model``'s blocks (4 of
    30) over 2 stages, 4 microbatches of 1 x 2,048, attention on the
    chunked core as in training. Each stacked weight's gradient within
    2 (M - 1) u sum_m |g_m| (bf16's u, M per-microbatch terms) of the
    blocks in order's, the input's equal; the group form refuses
    autograd on the one-rank group and, under no_grad, equals the blocks
    in order."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.parallel import pipeline as PP

    cfg = replace(get_config(CELL_ARCH), n_layers=GRAD_LAYERS)
    assert not cfg.use_flash_kernel
    for p in model.parameters():
        p.requires_grad_(True)
    stacked = PP.stack_blocks(model)
    g = torch.Generator(device=dev).manual_seed(2204)
    with torch.no_grad():
        x = model.embed(torch.randint(0, cfg.vocab, (GRAD_M, GRAD_SEQ), generator=g,
                                      device=dev))[:, None].clone()
    x.requires_grad_(True)
    head = torch.randn(x.shape, generator=g, device=dev)
    pos = torch.arange(GRAD_SEQ, dtype=torch.int32, device=dev).expand(1, GRAD_SEQ)
    apply = PP.transformer_block_apply(model, cfg, pos)
    plan = SimpleNamespace(splits=(GRAD_LAYERS // 2,))
    leaves = [*stacked.values(), x]

    def in_order(xs):
        outs = []
        for h in xs:
            for i in range(GRAD_LAYERS):
                h = apply({k: v[i] for k, v in stacked.items()}, h)
            outs.append(h)
        return torch.stack(outs)

    def through_pipeline():
        out = PP.run_pipeline(plan, apply, stacked, GRAD_LAYERS, x, devices=[dev] * 2)
        return torch.autograd.grad(torch.sum(out.float() * head), leaves)

    FA.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    got, wall = timed(through_pipeline)
    peak = torch.cuda.max_memory_allocated()
    want, wall_ref = timed(lambda: torch.autograd.grad(
        torch.sum(in_order(x).float() * head), leaves))
    again = timed(through_pipeline)[1]
    sizes = [torch.zeros(t.shape, device=dev) for t in stacked.values()]
    for m in range(GRAD_M):
        xm = x[m:m + 1].detach().requires_grad_(True)
        terms = torch.autograd.grad(torch.sum(in_order(xm).float() * head[m:m + 1]),
                                    list(stacked.values()))
        for s, t in zip(sizes, terms):
            s += t.float().abs()
    u = torch.finfo(x.dtype).eps / 2
    shares = []
    for name, a, b, s in zip(stacked, got, want, sizes):
        limit = 2 * (GRAD_M - 1) * u * s
        gap = (a.float() - b.float()).abs()
        if not bool((gap <= limit).all()):
            raise AssertionError(f"pipeline gradient of {name} beyond 2 (M - 1) u sum |g_m|")
        shares.append(float((gap / limit.clamp_min(torch.finfo(torch.float32).tiny)).max()))
    input_equal = torch.equal(got[-1], want[-1])
    grad_equal = sum(torch.equal(a, b) for a, b in zip(got, want))
    refused = None
    try:
        PP.run_pipeline(SimpleNamespace(splits=()), apply, stacked, GRAD_LAYERS, x,
                        group=dist.group.WORLD)
    except RuntimeError as e:
        refused = str(e)
    with torch.no_grad():
        fwd = PP.run_pipeline(SimpleNamespace(splits=()), apply, stacked, GRAD_LAYERS, x,
                              group=dist.group.WORLD)
        fwd_equal = torch.equal(fwd, in_order(x))
    for p in model.parameters():
        p.requires_grad_(False)
    print(f"  (c) pipeline gradients: {CELL_ARCH} blocks at full width, {GRAD_LAYERS} of 30 "
          f"layers over 2 stages, {GRAD_M} microbatches of 1 x {GRAD_SEQ}, {cfg.dtype}, chunked "
          f"attention (flash launches {FA.FLASH_LAUNCHES}): every stacked weight's gradient "
          f"within 2 (M - 1) u sum_m |g_m| of the blocks in order's (largest share of the "
          f"limit {max(shares):.4f}; {grad_equal - input_equal} of {len(stacked)} bit-equal), "
          f"the input's bit-equal: {input_equal}; forward + backward: the pipeline {wall:.3f} s, "
          f"in order {wall_ref:.3f} s, the pipeline again {again:.3f} s ({(GRAD_M + 1) * 2 * 2} "
          f"block applications to {GRAD_M * GRAD_LAYERS}); peak {peak / 1e9:.2f} GB; the group "
          f"form under "
          f"autograd raised: {refused is not None}; under no_grad (1 stage on the one-rank "
          f"group) bit-equal to the blocks in order: {fwd_equal} [{card}]")
    if not input_equal or refused is None or "has no backward" not in refused or not fwd_equal \
            or FA.FLASH_LAUNCHES:
        raise AssertionError("pipeline gradients on the card")
    return {"max_share": max(shares), "wall_s": wall, "wall_in_order_s": wall_ref,
            "wall_again_s": again}


# (b) runs in this many spawn processes, the cells of each mesh split
# round-robin over half of them
DRYRUN_WORKERS = 6
# (d): the card's peak above the memory the counted call starts from, as a
# share of the trace's peak (``peak_bytes``: ``temp_bytes`` and the
# returned logits' storage, live at the peak), stated before the run: the
# card allocates what the trace allocates, in the same order, plus the
# allocator's 512-byte rounding and cuBLAS's workspace (tens of MB), and
# the trace has no allocation the card lacks
COUNTED_PEAK_BAND = (0.98, 1.05)


def dryrun_records(capacity: int, cells: list, multi_pod: bool) -> list:
    """(b), in a ``spawn`` process: ``cells`` on one production mesh under
    the fake backend, each record with its counts (its lines kept from
    stdout)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    with contextlib.redirect_stdout(io.StringIO()):
        return dryrun.run_cells(cells, [multi_pod], capacity_bytes=capacity)


def trace_summary(trace) -> dict:
    """An ``op_analysis.OpTrace``'s figures, comparable across processes."""
    return {"flops_products": trace.flops_products, "flops_other": trace.flops_other,
            "bytes": trace.bytes_accessed,
            "collectives": sorted([list(c) for c in trace.collectives]),
            "kernels": dict(trace.kernels), "temp": trace.temp_bytes, "peak": trace.peak_bytes,
            "ops": trace.n_ops}


def fake_cell_counts() -> dict:
    """(d)'s fake run, in a ``spawn`` process: (a)'s prefill_32k cell (its
    config, batch and 1 x 1 mesh) counted on ``meta`` tensors over a
    one-rank fake world."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    cfg = replace(get_config(CELL_ARCH), use_flash_kernel=True)
    with dryrun.fake_world(1):
        return trace_summary(dryrun.count_cell(cfg, cell_shape("prefill_32k"),
                                               make_host_mesh(device="cpu")))


# the dry run's collective totals over the 64 records on the plan that
# gathered every expert for its MoE call and every sequence-split decode
# cache for its layer (PERF.md §6), GB
DRYRUN_GATHERED_PLAN_GB = {"all": 48991.4, "all-gather": 30615.8, "all-reduce": 18375.6}


def print_dryrun(records: list, capacity: int, card) -> None:
    from repro_torch.launch.dryrun import all_cells

    want = {(a, s, m) for a, s in all_cells() for m in ("16x16", "2x16x16")}
    got = {(r["arch"], r["shape"], r["mesh"]) for r in records}
    print(f"  (b) the dry run in {DRYRUN_WORKERS} spawn processes holding the fake backend: "
          f"{len(records)} records (every config x its applicable shapes on 16x16 and "
          f"2x16x16); per device: argument / resident / step GB (step: resident + what the "
          f"port's step gathers, the weights whole among it), temp GB (the trace's peak beyond "
          f"the arguments and outputs), fits on step + temp against total_memory "
          f"{capacity / 1e9:.2f} GB; flops (products + the rest), bytes accessed, collective "
          f"output MB and ring wire MB by kind [{card}]")
    short = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
             "all-to-all": "a2a", "collective-permute": "cp"}
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        mem, coll = r["memory"], r["collectives_weighted"]
        kinds = " ".join(f"{short.get(k, k)} {coll['bytes'][k] / 1e6:.1f}/"
                         f"{coll['wire_bytes'][k] / 1e6:.1f} x{coll['counts'][k]}"
                         for k in sorted(coll["bytes"]))
        print(f"    {r['arch']} {r['shape']}@{r['mesh']}: {mem['argument_bytes'] / 1e9:.3f}/"
              f"{mem['resident_bytes'] / 1e9:.3f}/{mem['step_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_bytes'] / 1e9:.3f} GB {'fits' if r['fits'] else 'OVER'}; flops "
              f"{r['flops_products_per_device']:.4e} + {r['flops_other_per_device']:.4e}, "
              f"bytes {r['bytes_per_device']:.4e}; {kinds} (count {r['count_s']:.1f} s)")
    if got != want or len(records) != 64:
        raise AssertionError(f"dry run: {len(records)} records, missing {sorted(want - got)}")
    for r in records:
        if not (r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
                and r["memory"]["temp_bytes"] > 0 and r["collectives"]["total_bytes"] > 0):
            raise AssertionError(f"dry run: {r['arch']} {r['shape']} {r['mesh']} counts nothing")
    totals: dict = {}
    for r in records:
        for k, v in r["collectives_weighted"]["bytes"].items():
            totals[k] = totals.get(k, 0) + v
    print(f"    totals over the {len(records)} records: flops "
          f"{sum(r['flops_per_device'] for r in records):.4e} "
          f"({sum(r['flops_products_per_device'] for r in records):.4e} in products), bytes "
          f"{sum(r['bytes_per_device'] for r in records):.4e}, collectives "
          f"{sum(r['collectives']['total_bytes'] for r in records) / 1e9:.1f} GB "
          f"({', '.join(f'{k} {v / 1e9:.1f}' for k, v in sorted(totals.items()))}; the plan "
          f"that gathered experts and split caches: {DRYRUN_GATHERED_PLAN_GB['all']} GB, "
          f"all-gather {DRYRUN_GATHERED_PLAN_GB['all-gather']}, all-reduce "
          f"{DRYRUN_GATHERED_PLAN_GB['all-reduce']}), wire "
          f"{sum(r['collectives_weighted']['total_wire_bytes'] for r in records) / 1e9:.1f} GB, "
          f"temp {sum(r['memory']['temp_bytes'] for r in records) / 1e9:.1f} GB; "
          f"{sum(r['fits'] for r in records)} of {len(records)} fit on step + temp "
          f"({sum(r['memory']['step_bytes'] <= capacity for r in records)} on step alone); build "
          f"walls {min(r['build_s'] for r in records):.2f}-"
          f"{max(r['build_s'] for r in records):.2f} s, count walls "
          f"{min(r['count_s'] for r in records):.2f}-{max(r['count_s'] for r in records):.2f} s")


def check_counted_cell(real: dict, fake: dict, card) -> dict:
    """(d): (a)'s prefill_32k cell counted on the card against the same
    cell counted on ``meta`` tensors: flops, bytes, collectives and kernel
    ops equal; the card's peak within :data:`COUNTED_PEAK_BAND` of the
    trace's."""
    got, want = real["summary"], fake
    ratio = real["peak_above_start"] / want["peak"]
    print(f"  (d) the op counter on the card over (a)'s prefill_32k cell: flops "
          f"{got['flops_products']:.6e} products + {got['flops_other']:.6e} other (meta trace "
          f"{want['flops_products']:.6e} + {want['flops_other']:.6e}), bytes {got['bytes']:.6e} "
          f"(trace {want['bytes']:.6e}), {len(got['collectives'])} collectives "
          f"{sum(c[1] for c in got['collectives']) / 1e9:.3f} GB (trace "
          f"{len(want['collectives'])}, {sum(c[1] for c in want['collectives']) / 1e9:.3f} GB), "
          f"kernel ops {got['kernels']} (trace {want['kernels']}), {real['launches']} flash "
          f"launches; peak above the call's start {real['peak_above_start'] / 1e9:.3f} GB vs the "
          f"trace's peak {want['peak'] / 1e9:.3f} GB (ratio {ratio:.4f}, band "
          f"{COUNTED_PEAK_BAND}) and temp {want['temp'] / 1e9:.3f} GB (ratio "
          f"{real['peak_above_start'] / want['temp']:.4f}); the counted call {real['wall_s']:.3f} s "
          f"[{card}]")
    same = {k: got[k] == want[k] for k in ("flops_products", "flops_other", "bytes",
                                           "collectives", "kernels")}
    if not all(same.values()) or not COUNTED_PEAK_BAND[0] <= ratio <= COUNTED_PEAK_BAND[1]:
        raise AssertionError(f"counted cell: equal {same}, peak ratio {ratio:.4f}")
    return {"peak_ratio": ratio, "temp_ratio": real["peak_above_start"] / want["temp"],
            "flops": got["flops_products"] + got["flops_other"]}


def phase_launch_tooling(dev, card, beside=None) -> dict:
    """Phase 22: (a) the cells on a 1 x 1 mesh, (b) the dry run (in spawn
    processes beside (a) and (c)), (c) the pipeline's gradients, (d) the
    op counter on (a)'s prefill cell on the card against the same cell's
    trace on ``meta`` tensors (in one more spawn process). ``beside``: a
    phase run on the card while (b)'s processes finish (phase 23); its
    result is returned under ``"beside"``."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import all_cells

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    capacity = torch.cuda.get_device_properties(0).total_memory
    with ProcessPoolExecutor(max_workers=DRYRUN_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        fake = pool.submit(fake_cell_counts)
        cells, split = all_cells(), DRYRUN_WORKERS // 2
        dry = [pool.submit(dryrun_records, capacity, cells[i::split], multi_pod)
               for multi_pod in (False, True) for i in range(split)]
        mesh = one_rank_mesh()
        try:
            cells = serving_cells(dev, mesh, card)
            torch.cuda.empty_cache()
            cells["train_4k"], model = training_cell(dev, mesh, card)
            grads = pipeline_gradients(dev, model, card)
            del model
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        t_ac = time.perf_counter() - t0
        ahead = beside() if beside is not None else None
        records = [r for task in dry for r in task.result()]
        fake = fake.result()
    print_dryrun(records, capacity, card)
    counted = check_counted_cell(cells["prefill_32k"].pop("counted"), fake, card)
    print(f"  phase 22: {time.perf_counter() - t0:.1f} s ((a), (c) and (d)'s card run "
          f"{t_ac:.1f} s)")
    return {"cells": cells, "grads": grads, "records": len(records), "counted": counted,
            "launches": cells["prefill_32k"]["launches"],
            "counted_launches": cells["prefill_32k"]["counted_launches"], "beside": ahead}


TP_ARCH = "deepseek-7b"
# phase 23's cells over gloo ranks that share the card: (config, ("data",
# "model") mesh, shape, batch, layers). The reference's batches are 32, 128
# and 256. deepseek-7b's cells are cut to 4 of 30 layers to fit the
# script's time limit: every row-parallel product's float32 partial crosses
# the host through gloo (0.54 GB a product at 32,768 tokens, about a second
# each, PERF.md §6 PR 33); train_4k also to 2 microbatches of 1 x 4,096, so
# that two ranks' weights, float32 moments and activations fit one card
# beside each other. The others exercise the plan's expert parallelism and
# split-KV decode at full width, cut deeper still (qwen3-moe 2 of 94 layers:
# 4.83 GB of experts a layer; granite-moe 4 of 24; granite-34b 2 of 88; a
# decode cell at batch 2 takes 3 layers, since the cache rule reads a
# stacked cache whose depth equals the batch as unstacked): qwen3-moe's
# prefill and decode hold 64 of its 128
# experts a rank (flash on 32 of its 64 heads); granite-moe's train step
# runs the experts' backward on 16 of 32 experts a rank; granite-34b's one
# kv head splits its cache's sequence over "model" at batch 2 and over
# "data" at batch 1 on (2, 2); minicpm3's latent cache splits over "model"
TP_CELLS = {
    "prefill_32k": (TP_ARCH, (1, 2), "prefill_32k", 1, 4),
    "decode_32k": (TP_ARCH, (1, 2), "decode_32k", 2, 4),
    "train_4k": (TP_ARCH, (1, 2), "train_4k", 2, 4),
    "prefill_32k on 2 x 2": (TP_ARCH, (2, 2), "prefill_32k", 2, 4),
    "qwen3-moe prefill_32k": ("qwen3-moe-235b-a22b", (1, 2), "prefill_32k", 1, 2),
    "qwen3-moe decode_32k": ("qwen3-moe-235b-a22b", (1, 2), "decode_32k", 2, 3),
    "granite-moe train_4k": ("granite-moe-1b-a400m", (1, 2), "train_4k", 2, 4),
    "granite-34b decode_32k": ("granite-34b", (1, 2), "decode_32k", 2, 3),
    "granite-34b decode_32k on 2 x 2": ("granite-34b", (2, 2), "decode_32k", 1, 2),
    "minicpm3 decode_32k": ("minicpm3-4b", (1, 2), "decode_32k", 2, 3),
}
TP_WORLD = 4  # one spawn: a (1, 2) mesh takes ranks 0 and 1, the others wait
TP_SEEDS = {"weights": 2300, "inputs": 2301, "cache": 2302}
TP_DEADLINE_S = 900
# A tensor-parallel cell against the meshless step on the same weights, in
# bf16. Each row-parallel product (attention's wo and the FFN's out, two a
# block) sums float32 partials over "model" and rounds once, where the
# meshless GEMM rounds its own float32 sum of the same products once: the
# two land up to one bf16 ulp apart, and a deep bf16 stack carries such
# gaps as equally valid orders of its sums do. So the serving cells' logits
# and written cache rows are held to LOGITS_TOL x the meshless values' std,
# the bound phases 7 and 17 hold bf16 logits to at full width (a first
# bound of (2 L + 1) x 2^-8 x std, one ulp a product carried with gain one,
# was refuted on the card: PERF.md §6 PR 33). The train step's loss lies
# within 2 (2 L + 1) x 2^-8 x its logits' std (cross entropy moves at most
# twice the largest logit change) and its gradient norm within
# 2 (2 L + 1) x 2^-8 relative (the backward runs each product twice more).
# The MoE's float32 combine summed over "model" is such a product too, and
# split-KV decode reorders two float32 sums. The MoE cells replay the
# meshless run's expert picks (bf16 noise flips top-k at near-ties and the
# flips compound: ROADMAP §3's trap), each rank counting the picks its own
# router would change
TP_ULP = 2.0 ** -8
# a decode cache's entries, each layer's from its own seed
TP_ENTRY = {"k": 0, "v": 1, "c_kv": 0, "k_rope": 1}


def tp_cell(name):
    """(config, shape) of phase 23's cell ``name``."""
    from repro_torch.configs import SHAPES, ShapeSpec, get_config

    arch, _, shape_name, batch, layers = TP_CELLS[name]
    full = SHAPES[shape_name]
    cfg = replace(get_config(arch), n_layers=layers, use_flash_kernel=full.kind != "train")
    return cfg, ShapeSpec(shape_name, full.kind, full.seq_len, batch)


def tp_inputs(cfg, shape, dev) -> dict:
    """The cell's seeded inputs on the card (train: (N, B / N, S))."""
    import torch

    from repro_torch.configs import effective_microbatches

    g = torch.Generator(device=dev).manual_seed(TP_SEEDS["inputs"])
    B, S = shape.global_batch, shape.seq_len

    def tok(*size):
        return torch.randint(0, cfg.vocab, size, generator=g, device=dev, dtype=torch.int32)

    if shape.kind == "prefill":
        return {"tokens": tok(B, S)}
    if shape.kind == "decode":
        return {"tokens": tok(B, 1), "cur_index": torch.tensor(S - 1, dtype=torch.int32,
                                                               device=dev)}
    n = effective_microbatches(cfg, shape, 1)
    return {"tokens": tok(n, B // n, S), "labels": tok(n, B // n, S)}


def tp_cache_layer(cfg, shape, layer: int, entry: str, dev):
    """Layer ``layer``'s random ``entry`` of the decode cache, (B, S, Hkv,
    Dh) for "k" and "v", (B, S, rank) for MLA's "c_kv" and "k_rope", bf16
    from its own seed: the meshless run and every rank make the same rows,
    each rank keeping its shard."""
    import torch

    if cfg.use_mla:
        tail = (cfg.kv_lora_rank if entry == "c_kv" else cfg.qk_rope_head_dim,)
    else:
        tail = (cfg.n_kv_heads, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(TP_SEEDS["cache"] * 1000 + 2 * layer
                                                + TP_ENTRY[entry])
    return torch.randn((shape.global_batch, shape.seq_len, *tail), generator=g, device=dev,
                       dtype=torch.bfloat16)


def tp_model(cfg, dev):
    import torch

    from repro_torch.models import transformer as T

    return T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(
        TP_SEEDS["weights"]), device=dev)


def tp_reference(dev, name) -> dict:
    """The meshless step of phase 23's cell ``name`` on the card, on the
    weights and inputs the ranks make: what the ranks are held to, on the
    host, and its wall; a MoE cell's expert picks (``"tape"``, in call
    order) for the ranks to replay."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    cfg, shape = tp_cell(name)
    model = tp_model(cfg, dev)
    inputs = tp_inputs(cfg, shape, dev)
    tape = RoutingTape(model) if cfg.is_moe else None
    # the logits' scale over the real vocab: padded slots hold -1e30 in both runs
    if shape.kind == "prefill":
        logits, wall = timed(lambda: make_prefill_step(cfg)(model, inputs))
        out = {"logits": logits.float().cpu()}
        out["std"] = float(out["logits"][..., :cfg.vocab].std())
    elif shape.kind == "decode":
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
        for layer in range(cfg.n_layers):
            for k in cache:
                cache[k][layer].copy_(tp_cache_layer(cfg, shape, layer, k, dev))
        (logits, cache), wall = timed(lambda: make_decode_step(cfg)(model, inputs, cache))
        rows = {k: v[:, :, shape.seq_len - 1].float().cpu() for k, v in cache.items()}
        out = {"logits": logits.float().cpu(), "rows": rows,
               "row_std": {k: float(v.std()) for k, v in rows.items()}}
        out["std"] = float(out["logits"][..., :cfg.vocab].std())
        del cache
    else:
        with torch.no_grad():  # the logits' scale, before the step moves the weights
            logits, _ = T.forward(cfg, model, {"tokens": inputs["tokens"][0]})
            std = float(logits[..., :cfg.vocab].float().std())
            del logits
        opt = adamw_init(dict(model.named_parameters()))
        n = inputs["tokens"].shape[0]
        if tape is not None:
            tape.record()  # the step's picks only
        (_, _, metrics), wall = timed(lambda: make_train_step(cfg, n_microbatches=n)(
            model, opt, inputs))
        out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "std": std}
        del opt
    if tape is not None:
        out["tape"] = [t.cpu() for t in tape.tape]
        tape.close()
    del model, inputs
    torch.cuda.empty_cache()
    out["wall_s"] = wall
    return out


def tp_collective_stats() -> tuple[dict, list]:
    """Counts, bytes and walls of the tensor-parallel layer's collectives in
    this process, by kind (the host-staged gloo calls of
    ``parallel.tensor_parallel``, timed around each call with its copies),
    and the shape of this rank's piece of every all-gather."""
    from repro_torch.parallel import tensor_parallel as TP

    stats: dict = {}
    gathered: list = []

    def timed_call(kind, fn, nbytes):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            entry = stats.setdefault(kind, [0, 0, 0.0])
            entry[0] += 1
            entry[1] += nbytes(args, out)
            entry[2] += time.perf_counter() - t0
            return out
        return call

    TP._all_reduce_ = timed_call("all-reduce", TP._all_reduce_,
                                 lambda a, out: out.numel() * out.element_size())
    pieces = timed_call("all-gather", TP._pieces,
                        lambda a, out: sum(p.numel() * p.element_size() for p in out))

    def gather(t, group, n):
        gathered.append(tuple(t.shape))
        return pieces(t, group, n)

    TP._pieces = gather
    TP._all_to_all = timed_call("all-to-all", TP._all_to_all,
                                lambda a, out: sum(p.numel() * p.element_size() for p in out))
    return stats, gathered


def tp_mesh(layout):
    """A ("data", "model") mesh of ``layout`` over the first ranks of the
    world (every rank makes it; the others are outside it)."""
    import math

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda", torch.arange(math.prod(layout)).reshape(layout),
                      mesh_dim_names=("data", "model"))


class PickReplay:
    """A rank's MoE layers (every instance: the cells' template models are
    the steps' own) take the meshless run's picks in call order
    (``MoE.select``), counting the picks their own router would change,
    and record the experts each call holds (``w_in``'s first dim)."""

    def __init__(self):
        from repro_torch.models import layers as L

        self.L, self.own, self.tape = L, L.top_k_lower_index, None
        self.select, self.forward = L.MoE.select, L.MoE._forward
        self.pos, self.changed, self.experts = 0, 0, []
        replay = self

        def select(moe, probs, k):
            if replay.tape is None:
                return replay.own(probs, k)
            forced = replay.tape[replay.pos].to(probs.device)
            replay.pos += 1
            mine = replay.own(probs, k)
            replay.changed += int((forced[..., :, None] != mine[..., None, :]).all(-1).sum())
            return forced

        def forward(moe, cfg, x, partial=False):
            replay.experts.append(moe.w_in.shape[0])
            return replay.forward(moe, cfg, x, partial)

        L.MoE.select, L.MoE._forward = select, forward

    def start(self, tape):
        self.tape, self.pos, self.changed, self.experts = tape, 0, 0, []


def written_row(t, pos: int):
    """This rank's block of row ``pos`` of the stacked cache entry DTensor
    ``t`` (L, B, S, ...): ``({dim of the (L, B, ...) row: offset}, block)``,
    or None where the rank holds no part of that row."""
    from torch.distributed.tensor import Shard

    mesh, local = t.device_mesh, t.to_local()
    coord, index = mesh.get_coordinate(), {}
    for i, p in enumerate(t.placements):  # major mesh dim first
        if isinstance(p, Shard):
            index[p.dim] = index.get(p.dim, 0) * mesh.size(i) + coord[i]
    first = {d: k * local.shape[d] for d, k in index.items()}
    s0 = first.pop(2, 0)
    if not s0 <= pos < s0 + local.shape[2]:
        return None
    return ({d - (d > 2): o for d, o in first.items()},
            local[:, :, pos - s0].float().cpu())


def tp_rank(rank, world, port, names, out_dir):
    """One gloo rank of phase 23 on the shared card: each cell of ``names``
    built on its mesh (a rank outside it waits at the barriers), the
    weights made in turns (one rank at a time holds the whole model while
    it takes its shards; the serving cells of one config, mesh and depth
    share them), the step run once, its results, wall, peak memory, flash
    launches with the heads they ran on, collectives, the pieces its
    all-gathers moved, a MoE cell's replayed picks and the experts each MoE
    call held, saved for the parent."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    stats, gathered = tp_collective_stats()
    replay = PickReplay()
    tapes = torch.load(Path(out_dir) / "tapes.pt")
    heads = []
    flash = L.flash_attention

    def counted_flash(q, k, v, **kw):
        heads.append(q.shape[2])
        return flash(q, k, v, **kw)

    L.flash_attention = counted_flash
    out, meshes, weights = {}, {}, {}
    for name in names:
        cfg, shape = tp_cell(name)
        layout = TP_CELLS[name][1]
        if layout not in meshes:
            meshes[layout] = tp_mesh(layout)
        mesh = meshes[layout]
        inside = mesh.get_coordinate() is not None
        step, _, sh = build_cell(cfg, shape, mesh)
        # a train step updates its weights
        key = (cfg.name, layout, cfg.n_layers, shape.kind == "train")
        if key not in weights:  # every rank keeps the same keys: the barriers match
            weights.clear()
            torch.cuda.empty_cache()
            made = None
            for turn in range(world):
                if turn == rank and inside:
                    model = tp_model(cfg, dev)
                    made = SH.distribute(dict(model.named_parameters()), sh[0])
                    del model
                    torch.cuda.empty_cache()
                dist.barrier()
            weights[key] = made
        if not inside:
            dist.barrier()
            dist.barrier()
            continue
        params = weights[key]
        inputs = SH.distribute(tp_inputs(cfg, shape, dev),
                               sh[2] if shape.kind == "train" else sh[1])
        cache = opt = None
        if shape.kind == "decode":
            cache = {}
            for k, s in sh[2].items():  # layer by layer, each rank keeping its shard
                local = None
                for i in range(cfg.n_layers):
                    layer = tp_cache_layer(cfg, shape, i, k, dev)
                    spec = tuple(s.spec) + (None,) * (layer.dim() + 1 - len(s.spec))
                    part = TP.take_shard(layer, mesh, (None,) * layer.dim(), spec[1:])
                    if local is None:  # the cache's type: the model's, as init_cache's
                        local = torch.empty((cfg.n_layers, *part.shape),
                                            dtype=L.torch_dtype(cfg.dtype), device=dev)
                    local[i].copy_(part)
                    del layer
                cache[k] = DTensor.from_local(local, mesh, s.placements, run_check=False)
            args = (params, inputs, cache)
        elif shape.kind == "train":
            opt = adamw_init({k: p.to_local() for k, p in params.items()})
            opt = {"mu": {k: DTensor.from_local(t, mesh, sh[1]["mu"][k].placements,
                                                run_check=False) for k, t in opt["mu"].items()},
                   "nu": {k: DTensor.from_local(t, mesh, sh[1]["nu"][k].placements,
                                                run_check=False) for k, t in opt["nu"].items()},
                   "step": DTensor.from_local(opt["step"], mesh, sh[1]["step"].placements,
                                              run_check=False)}
            args = (params, opt, inputs)
        else:
            args = (params, inputs)
        replay.start(tapes.get(name))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launch_count()
        heads.clear()
        stats.clear()
        gathered.clear()
        dist.barrier()
        t0 = time.perf_counter()
        res = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": FA.FLASH_LAUNCHES, "wgmma": FA.FLASH_WGMMA_LAUNCHES,
               "heads": sorted(set(heads)), "collectives": {k: list(v) for k, v in stats.items()},
               "coordinate": tuple(mesh.get_coordinate()), "gathered": list(gathered),
               "experts": list(replay.experts), "picks": (replay.pos, replay.changed)}
        if shape.kind == "prefill":
            rec["logits"] = res.float().cpu()
        elif shape.kind == "decode":
            logits, cache = res
            rec["logits"] = logits.float().cpu()
            rec["rows"] = {k: written_row(v, shape.seq_len - 1) for k, v in cache.items()}
            rec["entries"] = sorted({tuple(v.to_local().shape[1:]) for v in cache.values()})
        else:
            rec.update(loss=float(res[2]["loss"]), grad_norm=float(res[2]["grad_norm"]))
        out[name] = rec
        del res, args, params, inputs, cache, opt
        torch.cuda.empty_cache()
        dist.barrier()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def tp_ranks(world: int, names: list, tapes: dict) -> list:
    """Phase 23's ``names`` over ``world`` spawned gloo ranks on the card
    (tcp on a free port), the MoE cells replaying ``tapes`` (``{cell:
    picks}``): each rank's records of the cells whose mesh it is in, in
    rank order."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        torch.save(tapes, Path(out) / "tapes.pt")
        ctx = mp.spawn(tp_rank, args=(world, port, names, out), nprocs=world, join=False)
        deadline = time.monotonic() + TP_DEADLINE_S
        while not ctx.join(timeout=1):  # a failed rank raises here
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the ranks did not finish in {TP_DEADLINE_S} s")
        return [torch.load(Path(out) / f"rank{r}.pt") for r in range(world)]


def assembled_row(want, blocks: list):
    """Row blocks (:func:`written_row`) of the ranks put together into a
    tensor of ``want``'s shape; every element must be covered."""
    import torch

    full = torch.full(want.shape, float("nan"))
    for offsets, block in blocks:
        index = tuple(slice(offsets.get(d, 0), offsets.get(d, 0) + block.shape[d])
                      for d in range(block.dim()))
        full[index] = block
    if torch.isnan(full).any():
        raise AssertionError("the ranks' written rows do not cover the cache row")
    return full


def tp_check(name, ref, ranks, card) -> int:
    """Every rank's result of cell ``name`` within phase 23's bounds of the
    meshless step (:data:`TP_ULP`'s note); the flash launches (layers per
    rank on the prefill cells, on H / m heads, all wgmma; none in decode
    and training); a decode cell's all-gathers moving no cache entry; a
    MoE cell's every call on the rank's E / m experts, all of its
    replayed picks taken. Prints the per-rank walls, peaks and
    collectives. Returns the cell's flash launches over its ranks."""
    import torch

    cfg, shape = tp_cell(name)
    mesh, L = TP_CELLS[name][1], cfg.n_layers
    m = mesh[1]
    ranks = [r for r in ranks if name in r]
    shares = []
    if shape.kind == "train":
        loss_tol = 2 * (2 * L + 1) * TP_ULP * ref["std"]
        norm_tol = 2 * (2 * L + 1) * TP_ULP * ref["grad_norm"]
        for r in ranks:
            shares += [abs(r[name]["loss"] - ref["loss"]) / loss_tol,
                       abs(r[name]["grad_norm"] - ref["grad_norm"]) / norm_tol]
        detail = (f"loss {ranks[0][name]['loss']:.6f} vs {ref['loss']:.6f}, grad norm "
                  f"{ranks[0][name]['grad_norm']:.6f} vs {ref['grad_norm']:.6f}")
    else:
        tol = LOGITS_TOL * ref["std"]
        for r in ranks:
            shares.append(float((r[name]["logits"] - ref["logits"]).abs().max()) / tol)
        detail = f"logits {tuple(ranks[0][name]['logits'].shape)} (std {ref['std']:.4f})"
    ok = True
    if shape.kind == "decode":
        for k, want in ref["rows"].items():
            got = assembled_row(want, [r[name]["rows"][k] for r in ranks
                                       if r[name]["rows"][k] is not None])
            shares.append(float((got - want).abs().max()) / (LOGITS_TOL * ref["row_std"][k]))
        entries = {tuple(e) for e in ranks[0][name]["entries"]}
        cache_gathers = sum(tuple(p) in entries for r in ranks for p in r[name]["gathered"])
        ok = ok and cache_gathers == 0
        detail += (f", the written cache rows ({', '.join(ref['rows'])}) put together from the "
                   f"ranks' blocks; local cache entries {sorted(entries)} per layer, "
                   f"{cache_gathers} all-gathers of one")
    if cfg.is_moe:
        experts = {e for r in ranks for e in r[name]["experts"]}
        taken = {r[name]["picks"][0] for r in ranks}
        ok = ok and experts == {cfg.n_experts // m} and taken == {len(ref["tape"])}
        detail += (f"; every MoE call on {sorted(experts)} of {cfg.n_experts} experts "
                   f"({len(ranks[0][name]['experts'])} calls a rank), {len(ref['tape'])} "
                   f"replayed picks calls, picks each rank's router would change "
                   f"{[r[name]['picks'][1] for r in ranks]}")
    want_launches = L if shape.kind == "prefill" else 0
    launches = sum(r[name]["launches"] for r in ranks)
    ok_flash = all(r[name]["launches"] == want_launches and r[name]["wgmma"] == want_launches
                   and r[name]["heads"] == ([cfg.n_heads // m] if want_launches else [])
                   for r in ranks)
    print(f"  {name} ({cfg.name}, {'x'.join(map(str, mesh))} (data, model), {len(ranks)} ranks, "
          f"batch {shape.global_batch}, {L} layers, {shape.seq_len} tokens): {detail}; largest "
          f"share of its bound {max(shares):.4f}; flash launches per rank "
          f"{[r[name]['launches'] for r in ranks]} on {ranks[0][name]['heads']} local heads; "
          f"meshless {ref['wall_s']:.3f} s [{card}]")
    for i, r in enumerate(ranks):
        rec = r[name]
        coll = ", ".join(f"{k} x{n} {b / 1e9:.3f} GB {w:.2f} s"
                         for k, (n, b, w) in sorted(rec["collectives"].items()))
        print(f"    rank {i} {rec['coordinate']}: wall {rec['wall_s']:.3f} s, peak "
              f"{rec['peak_bytes'] / 1e9:.2f} GB; {coll}")
    if max(shares) > 1 or not ok_flash or not ok:
        raise AssertionError(f"{name}: share of the bound {max(shares):.4f}, flash {ok_flash}, "
                             f"cache and experts {ok}")
    return launches


def phase_tensor_parallel(dev, card) -> dict:
    """Phase 23: the reference's tensor-parallel plan at full width over
    gloo ranks that share the card, each cell against the meshless step on
    the same weights, run first in this process and freed before the
    spawn. deepseek-7b (d 4,096, 32 heads, ff 11,008, vocab 102,400):
    prefill_32k (batch 1 of 32), decode_32k (batch 2 of 128, a 32,768-row
    cache of random rows) and train_4k (batch 2 of 256 as 2 microbatches
    of 1 x 4,096) on a (1, 2) ("data", "model") mesh of 2 ranks,
    prefill_32k at batch 2 on a (2, 2) mesh of 4 ranks, 4 of 30 layers;
    expert parallelism (qwen3-moe's prefill_32k and decode_32k, granite-
    moe's train_4k, on the meshless run's picks) and split-KV decode
    (granite-34b on (1, 2) and (2, 2), minicpm3's latent cache), all in one
    spawn of 4 ranks (:data:`TP_CELLS`). Per rank: the wall, peak memory
    and the tensor-parallel collectives (count, bytes, wall by kind,
    host-staged through gloo)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    refs = {name: tp_reference(dev, name) for name in TP_CELLS}
    t_ref = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ranks = tp_ranks(TP_WORLD, list(TP_CELLS),
                     {n: r["tape"] for n, r in refs.items() if "tape" in r})
    t_ranks = time.perf_counter() - t0 - t_ref
    launches = {n: tp_check(n, refs[n], ranks, card) for n in TP_CELLS}
    print(f"  phase 23: {time.perf_counter() - t0:.1f} s (meshless references {t_ref:.1f} s, "
          f"{TP_WORLD} ranks {t_ranks:.1f} s with their spawn) [{card}]")
    return {"launches": sum(launches.values()), "by_cell": launches}


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
    flash_launches = deepseek_launches = pre["launches"] + sum(cached["counts"].values())
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

    card = card_line()  # the clocks after 14 phases of load
    print(f"== 15 the planner tier, online replanning and the fleet gateway on the card [{card}]")
    replan = phase_replan_tier(card)

    card = card_line()
    print(f"== 16 split execution of the paper's CNNs with the int8 wire on the card [{card}]")
    cnn = phase_cnn(card)

    card = card_line()
    print("== 17 the rest of LM serving at full width: parallel residual, MoE, MLA, audio "
          f"codes, M-RoPE with vision embeds and the int8 KV cache [{card}]")
    families = phase_lm_families(dev, card)
    flash_launches += sum(families["launches"].values())
    wgmma_launches += families["wgmma"]

    card = card_line()
    print(f"== 18 pipeline planning over H100 stages and the example twins on the card [{card}]")
    twins = phase_planning_twins(card)

    card = card_line()
    print(f"== 19 SSM and hybrid models at full width: zamba2-1.2b (Mamba2 with shared "
          f"attention) and xlstm-1.3b (mLSTM, sLSTM) [{card}]")
    hybrids = phase_hybrids(dev, card)
    zamba = hybrids["launches"]["zamba2-1.2b"]
    flash_launches += zamba["flash"]
    wgmma_launches += zamba["wgmma"]

    card = card_line()
    print(f"== 20 training: AdamW, the microbatched train step, checkpoints, the fault-tolerant "
          f"Trainer and gradient compression; {TRAIN_ARCH} at full width [{card}]")
    training = phase_training(dev, card)
    # the train path launches no kernel (the ops refuse autograd)
    train_launches = {k: sum(r["counts"][k] for r in training["card_cpu"].values())
                      for k in ("ssd", "flash")}

    card = card_line()
    print(f"== 21 the multi-device layer: the sharded DP backend in one process and over "
          f"{RANKS} ranks, the pipeline at deepseek-7b's full width [{card}]")
    multi = phase_multi_device(dev, card)
    flash_launches += multi["pipeline"]
    wgmma_launches += multi["pipeline"]

    card = card_line()
    print(f"== 22 the launch tooling: {CELL_ARCH}'s cells on a 1 x 1 mesh (build_cell: "
          f"prefill_32k, decode_32k, train_4k), the dry run on the production meshes with its "
          f"counts, the pipeline's gradients, the op counter on the card; phase 23 runs on the "
          f"card while the dry run's processes finish [{card}]")

    def phase_23():
        print(f"== 23 the reference's tensor-parallel compute plan: {TP_ARCH}'s cells, expert "
              f"parallelism (qwen3-moe, granite-moe) and split-KV decode (granite-34b, "
              f"minicpm3) at full width over gloo ranks that share the card [{card_line()}]")
        return phase_tensor_parallel(dev, card)

    launch = phase_launch_tooling(dev, card, beside=phase_23)
    flash_launches += launch["launches"] + launch["counted_launches"]
    wgmma_launches += launch["launches"] + launch["counted_launches"]
    tp = launch["beside"]
    flash_launches += tp["launches"]
    wgmma_launches += tp["launches"]

    kernels = []
    by_variant = {"tiled": path["by_variant"]["tiled"] + planner["tiled"] + replan["tiled"]
                  + twins["tiled"],
                  "per_scenario": path["by_variant"]["per_scenario"]
                  + planner["launches"]["fused_dp"] - planner["tiled"]
                  + replan["launches"]["fused_dp"] - replan["tiled"]
                  + twins["launches"]["fused_dp"] - twins["tiled"]}
    for name, line in (("dense_dp", 150), ("fused_dp", 170)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/split_dp.cu",
            "replaces": f"src/repro/core/pallas_dp.py:{line}",
            "launches": (path["launches"][name] + planner["launches"][name]
                         + replan["launches"][name] + cnn["launches"][name]
                         + twins["launches"][name]
                         + (multi["sharded"] if name == "dense_dp" else 0)),
            "launches_by_path": {"sweep": path["launches"][name],
                                 **{k: v[name] for k, v in planner["by_path"].items()},
                                 **{k: v[name] for k, v in replan["by_path"].items()},
                                 "cnn_plans": cnn["launches"][name],
                                 "examples": twins["launches"][name],
                                 **({"sharded": multi["sharded"]} if name == "dense_dp"
                                    else {})},
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
        "launches_by_path": {"deepseek-7b": deepseek_launches, **families["launches"],
                             "zamba2-1.2b": zamba["flash"], "training": train_launches["flash"],
                             "pipeline": multi["pipeline"], "build_cell": launch["launches"],
                             "counted_cell": launch["counted_launches"],
                             "tensor_parallel": tp["launches"]},
        **times["flash_attention"],
        "by_config": {**families["by_config"], "zamba2-1.2b": hybrids["flash_at"]},
    })
    for name, source, replaces, launches in (
            ("w8a8_matmul", "quant_matmul.cu", "quant_matmul/kernel.py:31",
             gemm["launches"]["w8a8_matmul"]),
            ("w8a16_matmul", "quant_matmul.cu", "quant_matmul/kernel.py:123",
             gemm["launches"]["w8a16_matmul"]),
            ("ssd_scan", "ssm_scan.cu", "ssm_scan/kernel.py:40",
             ssd["launches"] + zamba["ssd"])):
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
            "max_abs_err": errs[name], **times[name],
            **({"launches_by_variant": gemm["by_variant"]} if name == "w8a8_matmul" else {}),
            # one launch = one call of the C entry, which runs three CUDA kernels
            **({"launch_is": "ssm_scan_fwd call (3 kernels)",
                "launches_by_path": {"ssm_scan op": ssd["launches"],
                                     "zamba2-1.2b": zamba["ssd"],
                                     "training": train_launches["ssd"]},
                "by_config": {"zamba2-1.2b": hybrids["ssd_at"]}} if name == "ssd_scan" else {}),
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s; clocks now [{card_line()}]")
    print(json.dumps({"kernels": kernels}))
    print(f"device memory: torch.cuda.get_device_properties(0).total_memory = "
          f"{torch.cuda.get_device_properties(0).total_memory:,} B")
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
