"""The port's DP kernels' plain versions against the JAX reference.

Every CUDA kernel of ``repro_torch.core.cuda_dp`` has a plain PyTorch
version, which the kernel wrappers run for CPU tensors. Here that
version, through the port's host entries, is held to the reference on
the same inputs, made from a numpy seed:

* dense: ``repro.core.sweep._dp_numpy`` (float64), ``_dp_jax`` (float32)
  and ``pallas_dp_tables(interpret=True)`` (float32);
* fused: ``pallas_fused_dp_tables(interpret=True)`` and
  ``pallas_fused_optimal_dp`` (float32), numpy DP on the materialised
  ``C`` (float64).

The inputs are tie-rich (quarter-integer costs) with ~15% +inf and random
per-scenario fleet sizes (frozen rows). Min, max and add are exact in
IEEE arithmetic and both sides take the first minimum, so every
comparison is exact equality."""

import numpy as np
import pytest
import torch

from repro.core import pallas_dp as PD
from repro.core import sweep as RS
from repro_torch.core import cuda_dp as CD
from repro_torch.core import sweep as PS

INF = float("inf")
COMBINES = ("sum", "max")


def make_C(S, N, L, seed, inf_frac=0.15):
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 41, size=(S, N, L, L)) / 4.0
    C[rng.random_sample(C.shape) < inf_frac] = INF
    il = np.tril_indices(L, -1)
    C[:, :, il[0], il[1]] = INF  # a > b is not a segment
    return C


def make_ns(S, N, seed):
    return np.random.RandomState(seed + 1).randint(1, N + 1, size=S)


def make_fused(S, N, L, B, seed):
    """(bank, bank_idx, tx): a tie-rich local-cost bank and tx rows."""
    rng = np.random.RandomState(seed)
    bank = make_C(1, B, L, seed)[0]
    bank_idx = rng.randint(0, B, size=(S, N))
    tx = rng.randint(0, 9, size=(S, L)) / 4.0
    tx[:, -1] = 0.0
    return bank, bank_idx, tx


def assert_tables_equal(a, b):
    (dpa, pa), (dpb, pb) = a, b
    assert len(dpa) == len(dpb)
    for x, y in zip(dpa, dpb):
        assert x.shape == y.shape
        assert np.array_equal(x, y)
    assert np.array_equal(pa, pb)


def assert_results_equal(a, b):
    assert np.array_equal(a.splits, b.splits)
    assert np.array_equal(a.cost_s, b.cost_s)
    assert np.array_equal(a.feasible, b.feasible)


# ---------------------------------------------------------------------------
# dense kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("S,N,L", [(257, 5, 54), (300, 4, 52), (9, 2, 5)])
def test_dense_plain_matches_numpy_f64(S, N, L, combine):
    C = make_C(S, N, L, seed=S + N)
    ns = make_ns(S, N, seed=S)
    got = CD.plain_dp_tables(C, combine, ns, device="cpu", dtype=torch.float64)
    assert_tables_equal(got, RS._dp_numpy(C, combine, ns))
    assert_tables_equal(got, PS._dp_numpy(C, combine, ns))


@pytest.mark.parametrize("combine", COMBINES)
def test_dense_plain_matches_dp_jax_f32(combine):
    C, ns = make_C(257, 5, 54, seed=3), make_ns(257, 5, seed=3)
    got = CD.plain_dp_tables(C, combine, ns, device="cpu")
    assert_tables_equal(got, RS._dp_jax(C, combine, ns))


@pytest.mark.parametrize("combine", COMBINES)
def test_dense_plain_matches_pallas_dense_f32(combine):
    C, ns = make_C(65, 5, 54, seed=4), make_ns(65, 5, seed=4)
    got = CD.cuda_dp_tables(C, combine, ns, device="cpu")
    assert_tables_equal(got, PD.pallas_dp_tables(C, combine, ns, interpret=True))
    res = CD.cuda_optimal_dp(C, combine, n_devices=ns, device="cpu")
    assert_results_equal(res, PD.pallas_optimal_dp(C, combine, n_devices=ns,
                                                   interpret=True))


@pytest.mark.parametrize("combine", COMBINES)
def test_dense_all_k_matches_reference(combine):
    C = make_C(64, 5, 54, seed=5)
    got = CD.cuda_optimal_dp(C, combine, return_all_k=True, device="cpu",
                             dtype=torch.float64)
    want = RS.batched_optimal_dp(C, combine, backend="numpy", return_all_k=True)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5]
    for n in want:
        assert_results_equal(got[n], want[n])


# ---------------------------------------------------------------------------
# fused kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combine", COMBINES)
def test_fused_plain_matches_pallas_fused_f32(combine):
    local, _, tx = make_fused(300, 5, 54, B=5, seed=6)
    ns = make_ns(300, 5, seed=6)
    got = CD.cuda_fused_dp_tables(local, tx, combine, ns, device="cpu")
    assert_tables_equal(
        got, PD.pallas_fused_dp_tables(local, tx, combine, ns, interpret=True))


@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("hetero", [False, True], ids=["shared", "bank_idx"])
def test_fused_plain_matches_numpy_on_materialised_C_f64(combine, hetero):
    bank, bank_idx, tx = make_fused(257, 5, 54, B=3, seed=7)
    ns = make_ns(257, 5, seed=7)
    if not hetero:
        bank, bank_idx = bank[[0, 1, 1, 1, 1]], np.tile(np.arange(5), (257, 1))
    C = bank[bank_idx] + tx[:, None, None, :]  # built in float64
    got = CD.cuda_fused_optimal_dp(bank, bank_idx if hetero else None, tx,
                                   combine, n_devices=ns, device="cpu",
                                   dtype=torch.float64)
    assert_results_equal(got, RS.batched_optimal_dp(C, combine, n_devices=ns))
    idx = torch.from_numpy(bank_idx.astype(np.int32)) if hetero else None
    dp0, dps, args = CD.fused_dp(torch.from_numpy(bank), torch.from_numpy(tx),
                                 torch.from_numpy(ns.astype(np.int32)),
                                 combine, idx)
    assert_tables_equal(
        RS._dp_tables_to_numpy(dp0.numpy(), dps.numpy(), args.numpy(), 257, 5, 54),
        RS._dp_numpy(C, combine, ns))


def test_fused_bank_idx_matches_pallas_fused_optimal_dp():
    # few distinct stacks: the reference compiles one kernel per subgroup
    bank, bank_idx, tx = make_fused(40, 3, 54, B=2, seed=8)
    ns = make_ns(40, 3, seed=8)
    got = CD.cuda_fused_optimal_dp(bank, bank_idx, tx, "sum", n_devices=ns,
                                   device="cpu")
    want = PD.pallas_fused_optimal_dp(bank, bank_idx, tx, "sum", n_devices=ns,
                                      interpret=True)
    assert_results_equal(got, want)


def test_fused_dead_slots_are_never_read():
    bank, bank_idx, tx = make_fused(64, 4, 20, B=3, seed=9)
    ns = make_ns(64, 4, seed=9)
    dead = np.arange(4)[None, :] >= ns[:, None]
    junk = np.where(dead, 10**6, bank_idx)  # out of range, but dead
    got = CD.cuda_fused_optimal_dp(bank, junk, tx, n_devices=ns, device="cpu",
                                   dtype=torch.float64)
    want = CD.cuda_fused_optimal_dp(bank, np.where(dead, 0, bank_idx), tx,
                                    n_devices=ns, device="cpu",
                                    dtype=torch.float64)
    assert_results_equal(got, want)
    live_bad = np.where(dead, 0, bank_idx)
    live_bad[0, 0] = 3
    with pytest.raises(ValueError, match="bank_idx"):
        CD.cuda_fused_optimal_dp(bank, live_bad, tx, n_devices=ns, device="cpu")


# ---------------------------------------------------------------------------
# trivial cases the host answers, and the wrappers' CPU dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,N", [(17, 1), (0, 4)], ids=["N1", "S0"])
def test_trivial_cases_match_reference(S, N):
    C = make_C(S, N, 12, seed=10)
    assert_results_equal(CD.cuda_optimal_dp(C, device="cpu"),
                         RS.batched_optimal_dp(C, backend="jax"))
    local = make_C(1, N, 12, seed=10)[0]
    tx = np.random.RandomState(10).randint(0, 9, size=(S, 12)) / 4.0
    assert_tables_equal(
        CD.cuda_fused_dp_tables(local, tx, device="cpu"),
        PD.pallas_fused_dp_tables(local, tx, interpret=True))


def test_frozen_rows_carry_dp_and_mark_args():
    C = make_C(50, 4, 16, seed=11)
    ns = make_ns(50, 4, seed=11)
    Ct = torch.from_numpy(C)
    nst = torch.from_numpy(ns.astype(np.int32))
    dp0, dps, args = CD.dense_dp(Ct, nst)
    for k in range(2, 5):
        frozen = torch.from_numpy(ns < k)
        prev = dp0 if k == 2 else dps[:, k - 3]
        assert torch.equal(dps[frozen, k - 2], prev[frozen])
        assert bool((args[frozen, k - 2] == -1).all())


def test_cpu_wrappers_run_the_plain_versions():
    C = torch.from_numpy(make_C(33, 3, 10, seed=12))
    ns = torch.from_numpy(make_ns(33, 3, seed=12).astype(np.int32))
    for a, b in zip(CD.dense_dp(C, ns, "max"), CD.dense_dp_plain(C, ns, "max")):
        assert torch.equal(a, b)
    bank, tx = C[0], C[:, 0, 0, :].clone()
    tx[torch.isinf(tx)] = 0.0
    for a, b in zip(CD.fused_dp(bank, tx, ns), CD.fused_dp_plain(bank, tx, ns)):
        assert torch.equal(a, b)
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0
