"""Exact split DP on hand-written CUDA kernels (``backend="cuda"``).

The port's counterpart of ``repro.core.pallas_dp``. Two kernels in
``repro_torch/csrc/split_dp.cu`` run the batched exact split DP:

* **dense** (:func:`dense_dp`) consumes a prebuilt ``C[S, N, L, L]``;
  it runs ``batched_optimal_dp(backend="cuda")`` and the energy-budgeted
  groups of ``sweep`` (which mask a materialised ``C`` first). Its
  arithmetic is the plain dense recurrence, so its tables and parents are
  bit-identical to :func:`dense_dp_plain` (``backend="torch"``) and, in
  float64, to the numpy oracle ``sweep._dp_numpy``.
* **fused** (:func:`fused_dp`) consumes ``(bank, bank_idx, tx)`` and
  builds ``C[s, k, a, b] = bank[bank_idx[s, k], a, b] + tx[s, b]`` in the
  working type inside the reduction, so ``C`` never exists; it runs
  ``sweep(backend="cuda")``. Heterogeneous device mixes take one launch:
  the kernel gathers each scenario's stack from the bank itself. Like the
  reference's fused kernel it rounds ``f(local) + f(tx)`` where the dense
  path rounds ``f(local64 + tx64)``, a <= 1 ulp difference in float32.
  Two kernels compute it, picked by a shape rule fixed before the launch
  (:func:`_fused_variant`, twin of the C entry ``split_dp_fused_variant``):
  ``"tiled"`` (tiles of scenarios, the bank in shared memory, each
  thread's costs in registers, a split first-minimum reduction) wherever
  ``L <= 65`` and the bank fits a block's shared memory, which covers
  every shape ``sweep`` launches; ``"per_scenario"`` (the first design,
  one block per scenario) elsewhere. :func:`fused_dp_split_mirror` is the
  tiled kernel's reduction in PyTorch.

Each kernel has a plain PyTorch version here (:func:`dense_dp_plain`,
:func:`fused_dp_plain`). A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
:data:`DENSE_LAUNCHES` / :data:`FUSED_LAUNCHES` count kernel launches,
:data:`FUSED_TILED_LAUNCHES` those of the fused launches that ran the
tiled kernel.

Recurrence, per device step ``k = 2..N``::

    cand[s, a, b] = dp[s, a] (+ or max) C[s, k-1, a+1, b],  a = 0..L-2
    dp'[s, b]     = min_a cand,  arg = first argmin + 1 (-1 if not finite)

and rows with ``ns[s] < k`` are frozen (dp carried, args -1).
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import sweep as SW
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.kernels import build

__all__ = [
    "DENSE_LAUNCHES",
    "FUSED_LAUNCHES",
    "FUSED_TILED_LAUNCHES",
    "FUSED_VARIANTS",
    "MAX_L",
    "cuda_dp_tables",
    "cuda_fused_dp_tables",
    "cuda_fused_optimal_dp",
    "cuda_optimal_dp",
    "dense_dp",
    "dense_dp_plain",
    "fused_dp",
    "fused_dp_plain",
    "fused_dp_split_mirror",
    "plain_dp_tables",
    "reset_launch_counts",
]

# Kernel launches since the last reset_launch_counts(); bumped only where
# a wrapper launches its kernel, never by the plain versions, and under
# _COUNT_LOCK: surface rebuilds launch from a worker thread, and an
# unguarded ``+= 1`` there could lose a count.
DENSE_LAUNCHES = 0
FUSED_LAUNCHES = 0
FUSED_TILED_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

FUSED_VARIANTS = ("tiled", "per_scenario")

# Longest layer chain a block's shared-memory dp rows take: two rows of
# MAX_L float64 entries stay under the 48 KB a block gets without opt-in.
MAX_L = 2048

# The tiled fused kernel (csrc/split_dp.cu; keep these equal to its
# kGroup, kTiledMaxGroups, kTiledMaxThreads and kSmemLimit): candidates in
# groups of 4, at most 16 groups of costs in registers (L <= 65), at most
# 224 threads a block, and the 227 KB of shared memory a block may use.
GROUP = 4
TILED_MAX_GROUPS = 16
TILED_MAX_THREADS = 224
SMEM_LIMIT = 232_448


def reset_launch_counts() -> None:
    global DENSE_LAUNCHES, FUSED_LAUNCHES, FUSED_TILED_LAUNCHES
    with _COUNT_LOCK:
        DENSE_LAUNCHES = 0
        FUSED_LAUNCHES = 0
        FUSED_TILED_LAUNCHES = 0


def _tile_scenarios(L: int) -> int:
    """Scenarios per tile of the tiled kernel (C twin ``tile_scenarios``):
    the count in ``[1, max(1, 224 // L)]`` whose (scenario, b) pairs fill
    the largest share of the block's 32-lane warps, the larger on a tie."""
    best, best_live, best_lanes = 1, 0, 1
    for st in range(1, max(1, TILED_MAX_THREADS // L) + 1):
        live = st * L
        lanes = -(-live // 32) * 32
        if live * best_lanes >= best_live * lanes:
            best, best_live, best_lanes = st, live, lanes
    return best


def _col_stride(L: int, dtype: torch.dtype) -> int:
    """Entries of a staged cost column (C twin ``col_stride``): the
    ``4 * ceil((L-1)/4)`` candidate costs, padded so a column spans 16 bytes
    modulo 32 (neighbouring threads' 16-byte loads on distinct banks)."""
    elt = 8 if dtype == torch.float64 else 4
    w = -(-(L - 1) // GROUP) * GROUP
    while w * elt % 32 != 16:
        w += 1
    return w


def _tiled_smem_bytes(B: int, L: int, dtype: torch.dtype) -> int:
    """Shared memory of one tiled block: the bank of ``B`` (L, L) matrices
    transposed into B * L cost columns of :func:`_col_stride` entries, row
    0 of every matrix, then two dp rows of ``round4(L)`` entries per
    scenario of the tile."""
    elt = 8 if dtype == torch.float64 else 4
    row0 = -(-B * L // 4) * 4
    dp_rows = 2 * _tile_scenarios(L) * (-(-L // 4) * 4)
    return (B * L * _col_stride(L, dtype) + row0 + dp_rows) * elt


def _fused_variant(B: int, L: int, dtype: torch.dtype) -> str:
    """The fused kernel ``split_dp_fused`` runs for a bank of ``B`` (L, L)
    matrices in ``dtype`` (C twin ``split_dp_fused_variant``): ``"tiled"``
    where the L - 1 costs fit 16 groups of 4 registers and the bank with the
    tile's dp rows fits a block's shared memory, else ``"per_scenario"``."""
    fits = (B >= 1 and L >= 2 and -(-(L - 1) // GROUP) <= TILED_MAX_GROUPS
            and _tiled_smem_bytes(B, L, dtype) <= SMEM_LIMIT)
    return "tiled" if fits else "per_scenario"


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' on-card yardstick)
# ---------------------------------------------------------------------------


def _step_plain(dp, ck_shift, ns, k: int, combine: str):
    """One device step: ``ck_shift[s, a, b]`` is the step's cost of
    candidate ``a`` (parent ``a + 1``) ending at ``b``, shape (S, L-1, L)."""
    if combine == "sum":
        cand = dp[:, :-1, None] + ck_shift
    else:
        cand = torch.maximum(dp[:, :-1, None], ck_shift)
    ndp, first = cand.min(dim=1)  # first minimum, like numpy / jnp.argmin
    arg = torch.where(torch.isfinite(ndp), first.to(torch.int32) + 1, -1)
    act = (ns >= k)[:, None]
    return torch.where(act, ndp, dp), torch.where(act, arg, -1)


def _new_tables(S: int, N: int, L: int, dtype, device):
    return (torch.empty((S, N - 1, L), dtype=dtype, device=device),
            torch.empty((S, N - 1, L), dtype=torch.int32, device=device))


def dense_dp_plain(C: torch.Tensor, ns: torch.Tensor, combine: str = "sum"):
    """``(dp0, dps, args)`` of the dense recurrence in plain PyTorch."""
    S, N, L, _ = C.shape
    dp = C[:, 0, 0, :].clone()
    dp0 = dp
    dps, args = _new_tables(S, N, L, C.dtype, C.device)
    for k in range(2, N + 1):
        dp, arg = _step_plain(dp, C[:, k - 1, 1:, :], ns, k, combine)
        dps[:, k - 2], args[:, k - 2] = dp, arg
    return dp0, dps, args


def fused_dp_plain(bank: torch.Tensor, tx: torch.Tensor, ns: torch.Tensor,
                   combine: str = "sum", bank_idx: torch.Tensor | None = None):
    """``(dp0, dps, args)`` of the fused recurrence in plain PyTorch:
    each step's costs are ``bank[row, 1:, :] + tx`` in the working type."""
    S, L = tx.shape
    N = bank.shape[0] if bank_idx is None else bank_idx.shape[1]

    def step_costs(k: int):  # (S, L, L) or a shared (L, L) for device k
        if bank_idx is None:
            return bank[k - 1]
        # dead slots (k > ns) may hold anything: read row 0 there instead
        return bank[torch.where(ns >= k, bank_idx[:, k - 1], 0).long()]

    dp = step_costs(1)[..., 0, :] + tx
    dp0 = dp
    dps, args = _new_tables(S, N, L, tx.dtype, tx.device)
    for k in range(2, N + 1):
        ck = step_costs(k)[..., 1:, :] + tx[:, None, :]
        dp, arg = _step_plain(dp, ck, ns, k, combine)
        dps[:, k - 2], args[:, k - 2] = dp, arg
    return dp0, dps, args


def fused_dp_split_mirror(bank: torch.Tensor, tx: torch.Tensor, ns: torch.Tensor,
                          combine: str = "sum",
                          bank_idx: torch.Tensor | None = None):
    """``(dp0, dps, args)`` of the fused recurrence as the tiled kernel
    reduces it, in plain PyTorch: scenarios in tiles of
    :func:`_tile_scenarios` (the last one partial); per step, candidates
    ``a`` in groups of 4 padded with +inf, each group's minimum (``fmin``),
    two running (value, group) minima over the even and the odd groups with
    a strict ``<``, merged by strict value then the lower group; then the
    winning group's lowest ``a`` whose candidate equals the minimum, and
    that candidate as the value. The kernel builds a thread's costs once
    per bank row and keeps them across steps; they are the same bits as
    building them each step, as here. Launches nothing; equals
    :func:`fused_dp_plain` bit for bit."""
    S, L = tx.shape
    N = bank.shape[0] if bank_idx is None else bank_idx.shape[1]
    ng = -(-(L - 1) // GROUP)
    width = ng * GROUP  # candidates a = 0..width-1, +inf past L-2
    st = _tile_scenarios(L)
    dp0 = torch.empty((S, L), dtype=tx.dtype, device=tx.device)
    dps, args = _new_tables(S, N, L, tx.dtype, tx.device)
    inf = torch.tensor(float("inf"), dtype=tx.dtype, device=tx.device)
    for lo in range(0, S, st):
        t, n = tx[lo:lo + st], ns[lo:lo + st]
        T = t.shape[0]

        def row(k: int):  # device k's bank row; dead slots are never read
            if bank_idx is None:
                return torch.full((T,), k - 1, dtype=torch.long, device=t.device)
            return torch.where(n >= k, bank_idx[lo:lo + st, k - 1], 0).long()

        dp = bank[row(1), 0, :] + t
        dp0[lo:lo + st] = dp
        for k in range(2, N + 1):
            c = torch.full((T, width, L), float("inf"), dtype=t.dtype, device=t.device)
            c[:, :L - 1] = bank[row(k), 1:, :] + t[:, None, :]
            d = torch.zeros((T, width), dtype=t.dtype, device=t.device)
            d[:, :min(width, L)] = dp[:, :width]
            if combine == "sum":
                v = d[:, :, None] + c
            else:
                v = torch.where(c > d[:, :, None], c, d[:, :, None])
            q = v.view(T, ng, GROUP, L)
            m = torch.fmin(torch.fmin(q[:, :, 0], q[:, :, 1]),
                           torch.fmin(q[:, :, 2], q[:, :, 3]))  # (T, ng, L)
            chains = []
            for parity in (0, 1):
                mc = torch.full((T, L), float("inf"), dtype=t.dtype, device=t.device)
                gc = torch.full((T, L), -1, dtype=torch.long, device=t.device)
                for g in range(parity, ng, 2):
                    better = m[:, g] < mc
                    mc = torch.where(better, m[:, g], mc)
                    gc = torch.where(better, g, gc)
                chains.append((mc, gc))
            (m0, g0), (m1, g1) = chains
            odd = (m1 < m0) | ((m1 == m0) & (g1 < g0))
            mw, gw = torch.where(odd, m1, m0), torch.where(odd, g1, g0)
            best = inf.expand(T, L).clone()
            first = torch.zeros((T, L), dtype=torch.long, device=t.device)
            for j in reversed(range(GROUP)):
                a = gw * GROUP + j
                va = v.gather(1, a.clamp(0, width - 1)[:, None, :])[:, 0]
                hit = (gw >= 0) & (a < L - 1) & (va == mw)
                best = torch.where(hit, va, best)
                first = torch.where(hit, a, first)
            arg = torch.where(torch.isfinite(best), first.to(torch.int32) + 1, -1)
            act = (n >= k)[:, None]
            dp = torch.where(act, best, dp)
            dps[lo:lo + st, k - 2] = dp
            args[lo:lo + st, k - 2] = torch.where(act, arg, -1)
    return dp0, dps, args


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_common(name, ns, combine, S, N, L, dtype, device, tensors):
    if combine not in ("sum", "max"):
        raise ValueError(f"unknown combine {combine!r}")
    resolve_dtype(dtype)
    for what, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if ns.dtype != torch.int32 or ns.shape != (S,):
        raise ValueError(f"{name}: ns must be int32 of shape ({S},), "
                         f"got {ns.dtype} {tuple(ns.shape)}")
    if S < 1 or N < 2:
        raise ValueError(f"{name}: needs S >= 1 and N >= 2 (the host answers "
                         f"the trivial cases), got S={S}, N={N}")
    if not 2 <= L <= MAX_L:
        raise ValueError(f"{name}: L must lie in [2, {MAX_L}], got {L}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dense_dp(C: torch.Tensor, ns: torch.Tensor, combine: str = "sum"):
    """The dense kernel: ``C`` (S, N, L, L) float32/float64, ``ns`` (S,)
    int32 on the same device -> ``(dp0, dps, args)``. A CPU tensor runs
    :func:`dense_dp_plain`; a CUDA tensor launches the kernel."""
    global DENSE_LAUNCHES
    if C.dim() != 4 or C.shape[2] != C.shape[3]:
        raise ValueError(f"dense_dp: C must be (S, N, L, L), got {tuple(C.shape)}")
    S, N, L, _ = C.shape
    _check_common("dense_dp", ns, combine, S, N, L, C.dtype, C.device,
                  {"C": C, "ns": ns})
    if C.device.type == "cpu":
        return dense_dp_plain(C, ns, combine)
    dp0 = torch.empty((S, L), dtype=C.dtype, device=C.device)
    dps, args = _new_tables(S, N, L, C.dtype, C.device)
    built = build.load()
    with torch.cuda.device(C.device):
        code = built.lib.split_dp_dense(
            C.data_ptr(), ns.data_ptr(), dp0.data_ptr(), dps.data_ptr(),
            args.data_ptr(), S, N, L, int(C.dtype == torch.float64),
            int(combine == "max"), _stream_ptr(C.device))
    build.check_launch(built, code, "dense_dp")
    with _COUNT_LOCK:
        DENSE_LAUNCHES += 1
    return dp0, dps, args


def fused_dp(bank: torch.Tensor, tx: torch.Tensor, ns: torch.Tensor,
             combine: str = "sum", bank_idx: torch.Tensor | None = None, *,
             variant: str | None = None):
    """The fused kernel: ``bank`` (B, L, L) and ``tx`` (S, L) of one
    floating type, ``ns`` (S,) int32 and ``bank_idx`` (S, N) int32 (or
    ``None``: ``bank`` is then the shared (N, L, L) stack) on one device
    -> ``(dp0, dps, args)``. Live ``bank_idx`` entries must lie in
    ``[0, B)``; the caller checks that on the host. A CPU tensor runs
    :func:`fused_dp_plain`; a CUDA tensor launches the kernel
    :func:`_fused_variant` names. ``variant="per_scenario"`` forces the
    first kernel (any shape; for timing and tests); ``"tiled"`` is refused
    where the rule would not pick it."""
    global FUSED_LAUNCHES, FUSED_TILED_LAUNCHES
    if bank.dim() != 3 or bank.shape[1] != bank.shape[2]:
        raise ValueError(f"fused_dp: bank must be (B, L, L), got {tuple(bank.shape)}")
    L = bank.shape[1]
    if tx.dim() != 2 or tx.shape[1] != L or tx.dtype != bank.dtype:
        raise ValueError(f"fused_dp: tx must be (S, {L}) of {bank.dtype}, "
                         f"got {tuple(tx.shape)} {tx.dtype}")
    S = tx.shape[0]
    tensors = {"bank": bank, "tx": tx, "ns": ns}
    if bank_idx is None:
        N = bank.shape[0]
    else:
        if bank_idx.dtype != torch.int32 or bank_idx.dim() != 2 \
                or bank_idx.shape[0] != S:
            raise ValueError(f"fused_dp: bank_idx must be int32 ({S}, N), "
                             f"got {bank_idx.dtype} {tuple(bank_idx.shape)}")
        N = bank_idx.shape[1]
        tensors["bank_idx"] = bank_idx
    _check_common("fused_dp", ns, combine, S, N, L, bank.dtype, bank.device,
                  tensors)
    B = bank.shape[0]
    chosen = _fused_variant(B, L, bank.dtype)
    if variant not in (None, *FUSED_VARIANTS) or (variant == "tiled" and chosen != "tiled"):
        raise ValueError(f"fused_dp: variant {variant!r} cannot run a bank of "
                         f"{B} x ({L}, {L}) {bank.dtype} (it takes {chosen!r})")
    if bank.device.type == "cpu":
        return fused_dp_plain(bank, tx, ns, combine, bank_idx)
    chosen = variant or chosen
    dp0 = torch.empty((S, L), dtype=bank.dtype, device=bank.device)
    dps, args = _new_tables(S, N, L, bank.dtype, bank.device)
    built = build.load()
    entry = built.lib.split_dp_fused if chosen == "tiled" \
        else built.lib.split_dp_fused_per_scenario
    with torch.cuda.device(bank.device):
        code = entry(
            bank.data_ptr(), None if bank_idx is None else bank_idx.data_ptr(),
            tx.data_ptr(), ns.data_ptr(), dp0.data_ptr(), dps.data_ptr(),
            args.data_ptr(), S, N, L, B, int(bank.dtype == torch.float64),
            int(combine == "max"), _stream_ptr(bank.device))
    build.check_launch(built, code, f"fused_dp ({chosen})")
    with _COUNT_LOCK:
        FUSED_LAUNCHES += 1
        FUSED_TILED_LAUNCHES += int(chosen == "tiled")
    return dp0, dps, args


# ---------------------------------------------------------------------------
# Host entries (twins of pallas_dp_tables / pallas_*_optimal_dp)
# ---------------------------------------------------------------------------


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _trivial_tables(dp0: np.ndarray, Sn: int, N: int, L: int):
    """Host-side tables for the kernel-free cases (N == 1 or S == 0)."""
    dps = np.zeros((Sn, max(N - 1, 0), L), dtype=dp0.dtype)
    args = np.full((Sn, max(N - 1, 0), L), -1, dtype=np.int32)
    return SW._dp_tables_to_numpy(dp0, dps, args, Sn, N, L)


def _to_host_tables(out, Sn: int, N: int, L: int):
    dp0, dps, args = (t.cpu().numpy() for t in out)
    return SW._dp_tables_to_numpy(dp0, dps, args, Sn, N, L)


def _dense_tables(C, combine, ns, device, dtype, fn):
    C = np.ascontiguousarray(C, dtype=np.float64)
    Sn, N, L, _ = C.shape
    ns_arr = SW._normalize_ns(ns, Sn, N)
    dev, dtype = resolve_device(device), resolve_dtype(dtype)
    if N == 1 or Sn == 0:
        return _trivial_tables(C[:, 0, 0, :].astype(_np_dtype(dtype)), Sn, N, L)
    Ct = torch.from_numpy(C).to(device=dev, dtype=dtype)
    nst = torch.from_numpy(ns_arr.astype(np.int32)).to(dev)
    return _to_host_tables(fn(Ct, nst, combine), Sn, N, L)


def cuda_dp_tables(C: np.ndarray, combine: str = "sum",
                   ns: np.ndarray | None = None, *, device=None,
                   dtype: torch.dtype = torch.float32):
    """(dp_per_k, parents) from the dense kernel, the twin of
    ``pallas_dp_tables``: ``C`` is a float64 (S, N, L, L) host tensor,
    cast to ``dtype`` on ``device``."""
    return _dense_tables(C, combine, ns, device, dtype, dense_dp)


def plain_dp_tables(C: np.ndarray, combine: str = "sum",
                    ns: np.ndarray | None = None, *, device=None,
                    dtype: torch.dtype = torch.float32):
    """(dp_per_k, parents) from :func:`dense_dp_plain` on ``device`` —
    the port's ``backend="torch"``, counterpart of the reference's
    vmapped ``lax.scan`` DP."""
    return _dense_tables(C, combine, ns, device, dtype, dense_dp_plain)


def _fused_tables(bank, bank_idx, tx, combine, ns_arr, device, dtype):
    """(dp_per_k, parents) of the fused kernel; ``bank_idx`` (S, N) int
    rows into ``bank`` or ``None`` (``bank`` is the (N, L, L) stack)."""
    Sn, L = tx.shape
    N = bank.shape[0] if bank_idx is None else bank_idx.shape[1]
    dev, dtype = resolve_device(device), resolve_dtype(dtype)
    np_dtype = _np_dtype(dtype)
    if N == 1 or Sn == 0:
        first = bank[0] if bank_idx is None else bank[bank_idx[:, 0]]
        dp0 = first[..., 0, :].astype(np_dtype) + tx.astype(np_dtype)
        return _trivial_tables(dp0, Sn, N, L)
    bank_t = torch.from_numpy(bank).to(device=dev, dtype=dtype)
    tx_t = torch.from_numpy(tx).to(device=dev, dtype=dtype)
    ns_t = torch.from_numpy(ns_arr.astype(np.int32)).to(dev)
    idx_t = None if bank_idx is None else \
        torch.from_numpy(bank_idx.astype(np.int32)).to(dev)
    return _to_host_tables(fused_dp(bank_t, tx_t, ns_t, combine, idx_t),
                           Sn, N, L)


def cuda_fused_dp_tables(local: np.ndarray, tx: np.ndarray,
                         combine: str = "sum", ns: np.ndarray | None = None,
                         *, device=None, dtype: torch.dtype = torch.float32):
    """(dp_per_k, parents) WITHOUT materialising ``C``: ``local`` is the
    shared (N, L, L) local-cost stack, ``tx`` the (S, L) transmission
    vectors. Twin of ``pallas_fused_dp_tables``."""
    local = np.ascontiguousarray(local, dtype=np.float64)
    tx = np.ascontiguousarray(tx, dtype=np.float64)
    if local.ndim != 3 or local.shape[1] != local.shape[2]:
        raise ValueError(f"local must be (N, L, L), got {local.shape}")
    N, L, _ = local.shape
    if tx.ndim != 2 or tx.shape[1] != L:
        raise ValueError(f"tx must be (S, {L}), got {tx.shape}")
    return _fused_tables(local, None, tx, combine,
                         SW._normalize_ns(ns, tx.shape[0], N), device, dtype)


def cuda_optimal_dp(
    C: np.ndarray,
    combine: str = "sum",
    return_all_k: bool = False,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Exact split DP on the dense kernel: the entry behind
    ``batched_optimal_dp(backend="cuda")``, twin of ``pallas_optimal_dp``."""
    Sn, N, L, ns = SW._validate_dp_inputs(C, return_all_k, n_devices)
    t0 = time.perf_counter()
    dp_per_k, parents = cuda_dp_tables(C, combine, ns=ns, device=device,
                                       dtype=dtype)
    return SW._results_from_dp_tables(dp_per_k, parents, L, N, Sn, "cuda",
                                      ns, return_all_k, t0)


def cuda_fused_optimal_dp(
    bank: np.ndarray,
    bank_idx: np.ndarray | None,
    tx: np.ndarray,
    combine: str = "sum",
    return_all_k: bool = False,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Exact split DP from compact profiles, ``C`` never built: the entry
    behind ``sweep(backend="cuda")``, twin of ``pallas_fused_optimal_dp``.

    ``bank`` is the (B, L, L) local-cost bank (or, with ``bank_idx=None``,
    the shared (N, L, L) stack), ``bank_idx`` (S, N) rows into it,
    ``tx`` the (S, L) transmission vectors. Heterogeneous mixes run in
    ONE launch: the kernel gathers each scenario's stack; device slots
    beyond a scenario's own fleet size are never read."""
    bank = np.ascontiguousarray(bank, dtype=np.float64)
    tx = np.ascontiguousarray(tx, dtype=np.float64)
    if tx.ndim != 2:
        raise ValueError(f"tx must be (S, L), got {tx.shape}")
    Sn, L = tx.shape
    if bank.ndim != 3 or bank.shape[1:] != (L, L):
        raise ValueError(f"bank must be (B, {L}, {L}), got {bank.shape}")
    if return_all_k and n_devices is not None:
        raise ValueError("return_all_k and per-scenario n_devices "
                         "are mutually exclusive")
    if bank_idx is None:
        N = bank.shape[0]
    else:
        bank_idx = np.asarray(bank_idx, dtype=np.int64)
        if bank_idx.ndim != 2 or bank_idx.shape[0] != Sn:
            raise ValueError(
                f"bank_idx must be ({Sn}, N), got {bank_idx.shape}")
        N = bank_idx.shape[1]
    ns_arr = SW._normalize_ns(n_devices, Sn, N)
    ns = None if n_devices is None else ns_arr
    if bank_idx is not None:
        live = np.arange(N)[None, :] < ns_arr[:, None]
        bad = live & ((bank_idx < 0) | (bank_idx >= bank.shape[0]))
        if bad.any():
            raise ValueError(f"bank_idx rows must lie in [0, {bank.shape[0]})")
    t0 = time.perf_counter()
    dp_per_k, parents = _fused_tables(bank, bank_idx, tx, combine, ns_arr,
                                      device, dtype)
    return SW._results_from_dp_tables(dp_per_k, parents, L, N, Sn, "cuda",
                                      ns, return_all_k, t0)
