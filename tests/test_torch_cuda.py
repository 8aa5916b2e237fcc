"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (a CUDA kernel has
no CPU mode). On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The kernel and its plain version run on the same card tensors and must
agree exactly; the sweep on the card must equal the sweep on the plain
versions on the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.core import cuda_dp as CD
from repro_torch.core import profiles as PP
from repro_torch.core.sweep import ScenarioGrid, sweep

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def tie_rich(S, N, L, seed):
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 41, size=(S, N, L, L)) / 4.0
    C[rng.random_sample(C.shape) < 0.15] = np.inf
    return C, rng.randint(1, N + 1, size=S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("N,L", [(2, 7), (5, 54), (3, 300)])
def test_kernels_equal_plain(card, N, L, combine, dtype):
    C, ns = tie_rich(129, N, L, seed=N * L)
    C_t = torch.from_numpy(C).to(card, dtype)
    ns_t = torch.from_numpy(ns.astype(np.int32)).to(card)
    for a, b in zip(CD.dense_dp(C_t, ns_t, combine),
                    CD.dense_dp_plain(C_t, ns_t, combine)):
        assert torch.equal(a, b)
    bank, tx = C_t[0], C_t[:, 0, 0].nan_to_num(posinf=0.0)
    idx = torch.from_numpy(np.random.RandomState(L).randint(
        0, N, size=(129, N)).astype(np.int32)).to(card)
    for bank_idx in (None, idx):
        for a, b in zip(CD.fused_dp(bank, tx, ns_t, combine, bank_idx),
                        CD.fused_dp_plain(bank, tx, ns_t, combine, bank_idx)):
            assert torch.equal(a, b)


def test_sweep_on_card_equals_plain(card):
    grid = ScenarioGrid(
        models={"mobilenet_v2": PP.mobilenet_cost_profile(),
                "resnet50": PP.resnet50_cost_profile()},
        links=dict(PP.PROTOCOLS), n_devices=(2, 3, 4, 5),
        loss_p=(None, 0.1), rate_scale=(1.0, 0.25), devices=(PP.ESP32,))
    before = CD.FUSED_LAUNCHES
    got, want = sweep(grid), sweep(grid, device="cpu")
    assert CD.FUSED_LAUNCHES == before + 2
    assert [(r.splits, r.objective_cost_s) for r in got.rows] == \
        [(r.splits, r.objective_cost_s) for r in want.rows]
