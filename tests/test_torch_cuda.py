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


# (B, Sq, Skv, H, Hkv, D): MHA, GQA (group 4), MQA, ragged, q a suffix of
# a longer kv (prefill into a cache), and the full-width prefill shape
FLASH_SHAPES = [
    (2, 128, 128, 8, 8, 64),
    (2, 256, 256, 8, 2, 128),
    (1, 192, 192, 4, 1, 32),
    (2, 100, 100, 4, 2, 16),
    (1, 96, 2080, 4, 4, 128),
    (4, 2048, 2048, 32, 32, 128),
]
# the reference kernel test's tolerances (tests/test_kernels.py)
FLASH_TOL = {torch.float32: dict(rtol=1e-3, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# bf16 at full width (B*H = 128), where |out| is ~0.04: rtol covers a
# one-ulp difference of the bf16 output at any magnitude, atol is twice
# the largest error measured at the prefill step's shape
FULL_WIDTH_BF16_TOL = dict(rtol=2e-2, atol=4e-3)


def check_flash(card, B, Sq, Skv, H, Hkv, D, dtype, q0):
    """The kernel on seeded inputs, q at positions q0.., against its plain
    version; one launch counted."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=card).manual_seed(Sq + Skv + D)
    q = torch.randn((B * H, Sq, D), generator=g, device=card).to(dtype)
    k = torch.randn((B * Hkv, Skv, D), generator=g, device=card).to(dtype)
    v = torch.randn((B * Hkv, Skv, D), generator=g, device=card).to(dtype)
    qpos = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=card)
    kpos = torch.arange(Skv, dtype=torch.int32, device=card)
    before = FA.FLASH_LAUNCHES
    got = FA.flash_attention_kernel(q, k, v, qpos, kpos, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert FA.FLASH_LAUNCHES == before + 1 and got.dtype == dtype
    want = attention_ref(q, k, v, qpos, kpos, D ** -0.5)
    tol = FULL_WIDTH_BF16_TOL if dtype == torch.bfloat16 and B * H == 128 \
        else FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_equals_plain(card, shape, dtype):
    B, Sq, Skv, H, Hkv, D = shape
    check_flash(card, B, Sq, Skv, H, Hkv, D, dtype, q0=Skv - Sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_prefill_into_cache(card, dtype):
    """``prefill`` into a 2,080-row cache: q at positions 0..2047, the
    unwritten 32-row kv tail masked for every row and its tile skipped."""
    check_flash(card, 4, 2048, 2080, 32, 32, 128, dtype, q0=0)


def test_flash_kernel_skipped_q_tile_writes_zero(card):
    """Every kv tile starts after the q tile's last position: all are
    skipped and the output is 0 / max(0, 1e-30) = 0, as in the reference."""
    from repro_torch.kernels.flash_attention import ops as FA

    q = torch.randn((2, 64, 32), device=card)
    k = torch.randn((2, 128, 32), device=card)
    out = FA.flash_attention_kernel(
        q, k, k, torch.arange(64, dtype=torch.int32, device=card),
        torch.arange(1000, 1128, dtype=torch.int32, device=card), scale=0.2)
    assert torch.equal(out, torch.zeros_like(out))
