"""The tiled fused DP kernel's reduction and its variant rule, on the CPU.

``repro_torch.core.cuda_dp`` runs the fused recurrence on one of two CUDA
kernels, picked by a shape rule (``_fused_variant``, twin of the C entry
``split_dp_fused_variant``). The tiled kernel reduces each step's
candidates in its own order: tiles of scenarios, groups of 4 candidates,
two running (value, group) minima over the even and the odd groups,
merged by strict value then the lower group, and the winning group
resolved to its first candidate equal to the minimum.
``fused_dp_split_mirror`` is that reduction in PyTorch. Here it is held
bit for bit to the plain version ``fused_dp_plain`` and to the
reference's numpy DP on the materialised ``C`` (float64), on seeded
numpy inputs: tie-rich quarter-integer costs with ~15% +inf, random
fleet sizes (frozen rows) and junk in the dead ``bank_idx`` slots."""

import numpy as np
import pytest
import torch

from repro.core import sweep as RS
from repro_torch.core import cuda_dp as CD

COMBINES = ("sum", "max")
DTYPES = (torch.float32, torch.float64)


def fused_case(S, N, L, B, seed, lo=1, hi=41, inf_frac=0.15):
    """(bank, bank_idx with junk in dead slots, tx, ns) as numpy arrays."""
    rng = np.random.RandomState(seed)
    bank = rng.randint(lo, hi, size=(B, L, L)) / 4.0
    bank[rng.random_sample(bank.shape) < inf_frac] = np.inf
    tx = rng.randint(0, 9, size=(S, L)) / 4.0
    ns = rng.randint(1, N + 1, size=S)
    bank_idx = rng.randint(0, B, size=(S, N))
    dead = np.arange(N)[None, :] >= ns[:, None]
    return bank, np.where(dead, 10**6, bank_idx), tx, ns


def as_torch(bank, bank_idx, tx, ns, dtype):
    return (torch.from_numpy(bank).to(dtype), torch.from_numpy(tx).to(dtype),
            torch.from_numpy(ns.astype(np.int32)),
            None if bank_idx is None else torch.from_numpy(bank_idx.astype(np.int32)))


def live_only(bank_idx, ns):
    """``bank_idx`` with dead slots set to row 0, as the plain version
    reads every slot."""
    if bank_idx is None:
        return None
    return torch.where(torch.arange(bank_idx.shape[1])[None, :] < ns[:, None].long(),
                       bank_idx, 0)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# L 2..65 spans 1..16 groups of 4; the sweep's 52 and 54; S is no
# multiple of the tile
@pytest.mark.parametrize("hetero", [False, True], ids=["shared", "bank_idx"])
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("L", [2, 5, 31, 33, 52, 54, 65])
def test_split_mirror_equals_plain(L, dtype, combine, hetero):
    N = 5 if hetero else 4
    B = 3 if hetero else N
    S = 3 * CD._tile_scenarios(L) + 1
    bank, bank_idx, tx, ns = fused_case(S, N, L, B, seed=L + 10 * hetero)
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, bank_idx if hetero else None, tx, ns, dtype)
    got = CD.fused_dp_split_mirror(bank_t, tx_t, ns_t, combine, idx_t)
    assert_same(got, CD.fused_dp_plain(bank_t, tx_t, ns_t, combine, live_only(idx_t, ns_t)))
    assert CD.FUSED_LAUNCHES == CD.FUSED_TILED_LAUNCHES == 0


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("hetero", [False, True], ids=["shared", "bank_idx"])
def test_split_mirror_matches_numpy_on_materialised_C_f64(combine, hetero):
    S, N, L = 61, 5, 54
    bank, bank_idx, tx, ns = fused_case(S, N, L, B=3, seed=20 + hetero)
    idx = np.where(np.arange(N)[None, :] < ns[:, None], bank_idx, 0)
    if not hetero:
        bank, idx = bank[[0, 1, 1, 1, 1]], np.tile(np.arange(N), (S, 1))
    C = bank[idx] + tx[:, None, None, :]  # built in float64
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, idx if hetero else None, tx, ns,
                                         torch.float64)
    dp0, dps, args = CD.fused_dp_split_mirror(bank_t, tx_t, ns_t, combine, idx_t)
    got = RS._dp_tables_to_numpy(dp0.numpy(), dps.numpy(), args.numpy(), S, N, L)
    want = RS._dp_numpy(C, combine, ns)
    for x, y in zip(got[0], want[0]):
        assert np.array_equal(x, y)
    assert np.array_equal(got[1], want[1])


def split_ties(v, L):
    """Counts, over the (scenario, b) outputs of candidate values ``v``
    (S, L-1, L), of minima that tie across the reduction's boundaries:
    (first minimum in an odd group with an equal value in a later even
    group, the same with even and odd swapped, an equal value in a later
    group of the same parity, an equal value later in the same group)."""
    ng = -(-(L - 1) // CD.GROUP)
    pad = torch.full((v.shape[0], ng * CD.GROUP - (L - 1), L), float("inf"),
                     dtype=v.dtype)
    v = torch.cat([v, pad], 1)
    best, first = v.min(dim=1)
    fin = torch.isfinite(best)
    eq = (v == best[:, None, :]) & fin[:, None, :]
    a = torch.arange(v.shape[1])[None, :, None]
    later = eq & (a > first[:, None, :])
    group = a // CD.GROUP
    fgroup = (first // CD.GROUP)[:, None, :]
    odd_first = (fgroup % 2 == 1)
    cross = later & (group % 2 != fgroup % 2)
    return (int((cross & odd_first).any(1).sum()), int((cross & ~odd_first).any(1).sum()),
            int((later & (group % 2 == fgroup % 2) & (group != fgroup)).any(1).sum()),
            int((later & (group == fgroup)).any(1).sum()))


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_split_mirror_keeps_first_minimum_across_split_boundaries(dtype, combine):
    """Costs of 0.25 or 0.5 with dp rows flattened to few values: most
    minima tie, on purpose across the reduction's boundaries (an odd group
    before an equal even one, an even group before an equal odd one, two
    groups of one chain, two places in one group). A merge that preferred
    the later chain or group, or a last-minimum resolve, would give other
    args; the mirror must give the plain version's."""
    S, N, L = 40, 3, 54
    bank, bank_idx, tx, ns = fused_case(S, N, L, B=2, seed=30, lo=1, hi=3, inf_frac=0.05)
    tx[:] = 0.0
    ns[:] = N
    bank_idx[:, 0], bank_idx[:, 1:] = 0, 1  # every slot live: no junk
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, bank_idx, tx, ns, dtype)
    want = CD.fused_dp_plain(bank_t, tx_t, ns_t, combine, idx_t)
    dp1 = want[0]
    c = bank_t[idx_t[:, 1].long(), 1:, :] + tx_t[:, None, :]
    v = dp1[:, :-1, None] + c if combine == "sum" else torch.maximum(dp1[:, :-1, None], c)
    counts = split_ties(v, L)
    assert min(counts) >= 20, counts  # every kind of tie occurs, many times
    assert_same(CD.fused_dp_split_mirror(bank_t, tx_t, ns_t, combine, idx_t), want)


def test_split_mirror_frozen_rows_and_dead_slots():
    """Dead slots hold rows far outside the bank and are never read;
    frozen rows carry dp and write args -1, as in the plain version."""
    S, N, L = 45, 5, 33
    bank, bank_idx, tx, ns = fused_case(S, N, L, B=4, seed=40)
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, bank_idx, tx, ns, torch.float32)
    dp0, dps, args = CD.fused_dp_split_mirror(bank_t, tx_t, ns_t, "sum", idx_t)
    for k in range(2, N + 1):
        frozen = ns_t < k
        prev = dp0 if k == 2 else dps[:, k - 3]
        assert bool(frozen.any())
        assert torch.equal(dps[frozen, k - 2], prev[frozen])
        assert bool((args[frozen, k - 2] == -1).all())
    assert_same((dp0, dps, args),
                CD.fused_dp_plain(bank_t, tx_t, ns_t, "sum", live_only(idx_t, ns_t)))


def test_split_mirror_all_inf_rows():
    """A column whose every candidate is +inf: value +inf, arg -1."""
    S, N, L = 9, 3, 20
    bank, bank_idx, tx, ns = fused_case(S, N, L, B=2, seed=50)
    bank[1, :, 7] = np.inf
    bank_idx[:, 1:] = 1
    ns[:] = N
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, bank_idx, tx, ns, torch.float64)
    dp0, dps, args = CD.fused_dp_split_mirror(bank_t, tx_t, ns_t, "sum", idx_t)
    assert bool(torch.isinf(dps[:, :, 7]).all()) and bool((args[:, :, 7] == -1).all())
    assert_same((dp0, dps, args), CD.fused_dp_plain(bank_t, tx_t, ns_t, "sum", idx_t))


# ---------------------------------------------------------------------------
# the variant rule
# ---------------------------------------------------------------------------

F32, F64 = torch.float32, torch.float64

# (B, L, dtype, kernel): the sweep's banks (2 matrices; the device-mix
# grid's 4) at MobileNet-V2's L 54 and ResNet50's 52, the edges of the
# register budget (L 65 takes 16 groups of 4, L 66 would need 17), the
# reference's 300-layer test shape, and banks at the shared-memory limit
# and one matrix past it (float32 L 54: 17 matrices take 225,792 bytes of
# the 232,448 with the tile's dp rows, 18 take 238,960; float64: 8 and 9)
VARIANT_TABLE = [
    (2, 54, F32, "tiled"), (4, 54, F32, "tiled"), (2, 52, F32, "tiled"),
    (4, 52, F32, "tiled"), (2, 54, F64, "tiled"), (4, 54, F64, "tiled"),
    (5, 2, F32, "tiled"), (5, 2, F64, "tiled"), (1, 65, F32, "tiled"),
    (1, 65, F64, "tiled"), (1, 66, F32, "per_scenario"), (1, 66, F64, "per_scenario"),
    (3, 300, F32, "per_scenario"), (1, 300, F64, "per_scenario"),
    (17, 54, F32, "tiled"), (18, 54, F32, "per_scenario"),
    (8, 54, F64, "tiled"), (9, 54, F64, "per_scenario"),
    (12, 65, F32, "tiled"), (13, 65, F32, "per_scenario"),
    (0, 54, F32, "per_scenario"),
]


@pytest.mark.parametrize("B,L,dtype,kernel", VARIANT_TABLE,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_variant_rule_table(B, L, dtype, kernel):
    assert CD._fused_variant(B, L, dtype) == kernel


def test_variant_rule_shared_memory_edges():
    """The tiled kernel takes a bank exactly while the staged bank and the
    tile's dp rows fit the 227 KB a block may use."""
    for dtype in DTYPES:
        for L in (17, 33, 52, 54, 65):
            fit = [B for B in range(1, 1000)
                   if CD._tiled_smem_bytes(B, L, dtype) <= CD.SMEM_LIMIT]
            top = max(fit)
            assert fit == list(range(1, top + 1))
            assert CD._fused_variant(top, L, dtype) == "tiled"
            assert CD._fused_variant(top + 1, L, dtype) == "per_scenario"
    assert CD._tiled_smem_bytes(17, 54, F32) == 225_792
    assert CD._tiled_smem_bytes(18, 54, F32) == 238_960


def test_staged_cost_columns_avoid_bank_conflicts():
    """A staged cost column holds the 4 * ceil((L-1)/4) candidates and spans
    16 bytes modulo 32, so the 16-byte loads of 8 threads on neighbouring
    columns (one shared-memory wavefront) fall on 8 distinct 4-bank groups."""
    for dtype, elt in ((F32, 4), (F64, 8)):
        for L in range(2, 66):
            w = CD._col_stride(L, dtype)
            assert -(-(L - 1) // 4) * 4 <= w < -(-(L - 1) // 4) * 4 + 32 // elt
            assert w * elt % 32 == 16
            for first in range(L):
                groups = {((first + j) * w * elt // 16) % 8 for j in range(8)}
                assert len(groups) == 8


@pytest.mark.parametrize("L,tile,threads", [(54, 4, 224), (52, 3, 160), (32, 7, 224),
                                            (33, 6, 224), (65, 3, 224), (2, 112, 224)])
def test_tiles_fill_the_lanes(L, tile, threads):
    """Scenarios per tile and the block's lanes; at the sweep's L 52 and 54
    over 90% of the lanes hold a (scenario, b) pair."""
    st = CD._tile_scenarios(L)
    assert st == tile and -(-st * L // 32) * 32 == threads <= CD.TILED_MAX_THREADS
    if L in (52, 54):
        assert st * L / threads >= 0.9


def test_cpu_wrapper_checks_the_variant():
    """On the CPU the wrapper runs the plain version whatever kernel it
    names, after the same checks as on the card."""
    bank, bank_idx, tx, ns = fused_case(7, 3, 12, B=2, seed=60)
    bank_t, tx_t, ns_t, idx_t = as_torch(bank, bank_idx, tx, ns, torch.float32)
    idx_t = live_only(idx_t, ns_t)
    want = CD.fused_dp_plain(bank_t, tx_t, ns_t, "sum", idx_t)
    for variant in (None, "tiled", "per_scenario"):
        assert_same(CD.fused_dp(bank_t, tx_t, ns_t, "sum", idx_t, variant=variant), want)
    with pytest.raises(ValueError, match="variant"):
        CD.fused_dp(bank_t, tx_t, ns_t, "sum", idx_t, variant="dense")
    wide = torch.zeros((2, 300, 300))
    with pytest.raises(ValueError, match="per_scenario"):
        CD.fused_dp(wide, torch.zeros((2, 300)), torch.ones(2, dtype=torch.int32),
                    variant="tiled")
    assert CD.FUSED_LAUNCHES == CD.FUSED_TILED_LAUNCHES == 0
