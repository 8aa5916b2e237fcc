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


def fused_both_variants(bank, tx, ns, combine, bank_idx):
    """Both fused kernels (the rule's pick, then the first kernel forced)
    against the plain version, exactly; the launch counters say which
    kernel ran."""
    want = CD.fused_dp_plain(bank, tx, ns, combine, bank_idx)
    tiled = CD._fused_variant(bank.shape[0], bank.shape[1], bank.dtype) == "tiled"
    for variant in (None, "per_scenario"):
        before = CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES
        got = CD.fused_dp(bank, tx, ns, combine, bank_idx, variant=variant)
        torch.cuda.synchronize()
        ran_tiled = variant is None and tiled
        assert (CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES) == \
            (before[0] + 1, before[1] + ran_tiled)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# L 2..65 take the tiled fused kernel (1..16 groups of 4, 31/32/33 and
# 64/65 around group and warp edges, the sweep's 52 and 54), 300 the first;
# S = 129 is no multiple of any tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("N,L", [(2, 7), (5, 54), (3, 300), (4, 2), (4, 31), (4, 32),
                                 (4, 33), (5, 52), (3, 64), (3, 65)])
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
        fused_both_variants(bank, tx, ns_t, combine, bank_idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_bank_at_shared_memory_limit(card, dtype):
    """The largest bank of (54, 54) matrices the tiled kernel stages (17 in
    float32, 8 in float64) and one matrix more, which takes the first
    kernel; a forced tiled launch of the larger bank is refused."""
    top = {torch.float32: 17, torch.float64: 8}[dtype]
    rng = np.random.RandomState(top)
    for B, kernel in ((top, "tiled"), (top + 1, "per_scenario")):
        assert CD._fused_variant(B, 54, dtype) == kernel
        bank = torch.from_numpy(tie_rich(1, B, 54, seed=B)[0][0]).to(card, dtype)
        tx = torch.from_numpy(rng.randint(0, 9, size=(301, 54)) / 4.0).to(card, dtype)
        ns = torch.from_numpy(rng.randint(1, 6, size=301).astype(np.int32)).to(card)
        idx = torch.from_numpy(rng.randint(0, B, size=(301, 5)).astype(np.int32)).to(card)
        fused_both_variants(bank, tx, ns, "sum", idx)
    with pytest.raises(ValueError, match="variant"):
        CD.fused_dp(bank, tx, ns, "sum", idx, variant="tiled")


def test_fused_variant_rule_is_the_c_entrys(card):
    """``_fused_variant`` names the kernel ``split_dp_fused`` runs, for L
    2..300, both types and banks of 1 to 40 matrices."""
    from repro_torch.kernels import build

    lib = build.load("split_dp.cu").lib
    for dtype in (torch.float32, torch.float64):
        for L in range(2, 301):
            for B in (1, 2, 3, 4, 5, 6, 8, 9, 12, 13, 17, 18, 20, 40):
                assert bool(lib.split_dp_fused_variant(B, L, int(dtype == torch.float64))) \
                    == (CD._fused_variant(B, L, dtype) == "tiled"), (B, L, dtype)


def test_sweep_on_card_equals_plain(card):
    grid = ScenarioGrid(
        models={"mobilenet_v2": PP.mobilenet_cost_profile(),
                "resnet50": PP.resnet50_cost_profile()},
        links=dict(PP.PROTOCOLS), n_devices=(2, 3, 4, 5),
        loss_p=(None, 0.1), rate_scale=(1.0, 0.25), devices=(PP.ESP32,))
    before = CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES
    got, want = sweep(grid), sweep(grid, device="cpu")
    assert (CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert [(r.splits, r.objective_cost_s) for r in got.rows] == \
        [(r.splits, r.objective_cost_s) for r in want.rows]


def planner_models():
    """32 MobileNet-V2 cost models on powered ESP32s: the four protocols
    with radio powers, 8 loss rates, and fleets of 2-5 per model."""
    from dataclasses import replace

    from repro_torch.core.latency import SplitCostModel

    dev = replace(PP.ESP32, active_power_w=0.5)
    models = [SplitCostModel(profile=PP.mobilenet_cost_profile(), devices=(dev,),
                             link=replace(lk, tx_power_w=0.3, rx_power_w=0.2,
                                          loss_p=0.04 * i))
              for lk in PP.PROTOCOLS.values() for i in range(8)]
    return models, [2 + i % 4 for i in range(len(models))]


def no_times(plans):
    from dataclasses import replace

    return [replace(p, planner_time_s=0.0) for p in plans]


@pytest.mark.parametrize("kw", [{}, {"energy_budget": 1.5},
                                {"variants": PP.esp32_variant_bank(), "accuracy_floor": 0.96},
                                {"dtype": torch.float64}],
                         ids=["plain", "budget", "variants", "float64"])
def test_plan_split_batch_on_card_equals_plain(card, kw):
    from repro_torch.core.planner import plan_split_batch

    models, ns = planner_models()
    before = CD.DENSE_LAUNCHES
    got = plan_split_batch(models, ns, **kw)
    assert CD.DENSE_LAUNCHES == before + 1
    assert no_times(got) == no_times(plan_split_batch(models, ns, device="cpu", **kw))


def surface_args():
    from dataclasses import replace

    from repro_torch.core.latency import SplitCostModel

    model = SplitCostModel(profile=PP.mobilenet_cost_profile(),
                           devices=(replace(PP.ESP32, active_power_w=0.5),), link=PP.ESP_NOW)
    links = {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2) for p, lk in PP.PROTOCOLS.items()}
    return (model, links, (2, 3, 5)), dict(pt_scale=(1.0, 2.0, 8.0, 64.0),
                                           loss_p=(0.0, 0.1, 0.3), solver="batched_dp")


def surface_nodes(family):
    return {(n, name): (p.splits.tolist(), p.chunk_bytes.tolist(), p.latency_s.tolist(),
                        p.runner_splits.tolist(), p.runner_latency_s.tolist())
            for n, s in family.items() for name, p in s.protocols.items()}


def test_budgeted_surfaces_on_card_equal_plain(card):
    from repro_torch.core.surface import build_surfaces

    args, kw = surface_args()
    before = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES
    got = build_surfaces(*args, energy_budget=1.5, **kw)
    assert (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES) == (before[0] + 1, before[1])
    assert surface_nodes(got) == surface_nodes(
        build_surfaces(*args, energy_budget=1.5, device="cpu", **kw))


def test_unbudgeted_surfaces_on_card_equal_fused_plain(card):
    """One launch of the tiled fused kernel; node for node the same family
    as its plain version (``device="cpu"``)."""
    from repro_torch.core.surface import build_surfaces

    args, kw = surface_args()
    before = CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES, CD.DENSE_LAUNCHES
    got = build_surfaces(*args, **kw)
    assert (CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES, CD.DENSE_LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert surface_nodes(got) == surface_nodes(build_surfaces(*args, device="cpu", **kw))


# (B, Sq, Skv, H, Hkv, D): MHA, GQA (group 4), MQA, ragged, q a suffix of
# a longer kv (prefill into a cache), the full-width prefill shape, and
# head dims that take the wgmma kernel's other paths in bf16: D 64 over a
# ragged 1,000-row kv, stablelm-12b's 160 (64-column products plus
# 16-column ones; Sq 130 leaves a q tile of 2 rows), 48 and 256
FLASH_SHAPES = [
    (2, 128, 128, 8, 8, 64),
    (2, 256, 256, 8, 2, 128),
    (1, 192, 192, 4, 1, 32),
    (2, 100, 100, 4, 2, 16),
    (1, 96, 2080, 4, 4, 128),
    (4, 2048, 2048, 32, 32, 128),
    (1, 200, 1000, 8, 2, 64),
    (2, 130, 130, 4, 2, 160),
    (2, 64, 64, 2, 1, 48),
    (1, 256, 256, 4, 4, 256),
]
# the reference kernel test's tolerances (tests/test_kernels.py)
FLASH_TOL = {torch.float32: dict(rtol=1e-3, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# bf16 at full width (B*H = 128), where |out| is ~0.04: rtol covers a
# one-ulp difference of the bf16 output at any magnitude, atol is twice
# the largest error measured at the prefill step's shape
FULL_WIDTH_BF16_TOL = dict(rtol=2e-2, atol=4e-3)


def check_flash(card, B, Sq, Skv, H, Hkv, D, dtype, q0, variant=None):
    """The kernel ``variant`` (None: the wrapper's pick) on seeded inputs, q
    at positions q0.., against its plain version; one launch counted, of
    the wgmma kernel where that one ran."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=card).manual_seed(Sq + Skv + D)
    q = torch.randn((B * H, Sq, D), generator=g, device=card).to(dtype)
    k = torch.randn((B * Hkv, Skv, D), generator=g, device=card).to(dtype)
    v = torch.randn((B * Hkv, Skv, D), generator=g, device=card).to(dtype)
    qpos = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=card)
    kpos = torch.arange(Skv, dtype=torch.int32, device=card)
    before = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    got = FA.flash_attention_kernel(q, k, v, qpos, kpos, scale=D ** -0.5, variant=variant)
    torch.cuda.synchronize()
    wgmma = (variant or FA._variant(dtype, D)) == "wgmma"
    assert (FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES) == (before[0] + 1, before[1] + wgmma)
    assert got.dtype == dtype
    want = attention_ref(q, k, v, qpos, kpos, D ** -0.5)
    tol = FULL_WIDTH_BF16_TOL if dtype == torch.bfloat16 and B * H == 128 \
        else FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_equals_plain(card, shape, dtype):
    B, Sq, Skv, H, Hkv, D = shape
    check_flash(card, B, Sq, Skv, H, Hkv, D, dtype, q0=Skv - Sq)


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_simt_kernel_equals_plain_in_bf16(card, shape):
    """The CUDA-core kernel, which bf16 no longer takes by default, still
    holds the same tolerances on bf16 inputs."""
    B, Sq, Skv, H, Hkv, D = shape
    check_flash(card, B, Sq, Skv, H, Hkv, D, torch.bfloat16, q0=Skv - Sq, variant="simt")


def test_flash_variant_rule_is_the_c_entrys(card):
    """``_variant`` names the kernel ``flash_attention_fwd`` runs, for both
    types and every head dim."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FA

    lib = build.load("flash_attention.cu").lib
    for dtype in (torch.float32, torch.bfloat16):
        for D in range(1, FA.MAX_HEAD_DIM + 1):
            assert bool(lib.flash_attention_variant(int(dtype == torch.bfloat16), D)) \
                == (FA._variant(dtype, D) == "wgmma"), (dtype, D)


def test_flash_variants_agree_on_masked_rows(card):
    """kv positions start at 50: in the first 64-row kv tile, q rows at
    positions 0..49 see only masked keys and take uniform weights over that
    tile (the reference's arithmetic); the next tile starts past the first
    64 q rows and is skipped for them. Both kernels apply the 64-row skip
    rule, so they agree there, and elsewhere with the plain version."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((2, S, 64), generator=g, device=card).to(torch.bfloat16)
               for S in (128, 256, 256))
    qpos = torch.arange(128, dtype=torch.int32, device=card)
    kpos = torch.arange(50, 306, dtype=torch.int32, device=card)
    got = FA.flash_attention_kernel(q, k, v, qpos, kpos, scale=0.125)
    want = FA.flash_attention_kernel(q, k, v, qpos, kpos, scale=0.125, variant="simt")
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    uniform = v[:, :64].float().mean(1, keepdim=True).expand(2, 50, 64)
    torch.testing.assert_close(got[:, :50].float(), uniform, **FLASH_TOL[torch.bfloat16])
    plain = attention_ref(q, k, v, qpos, kpos, 0.125)
    torch.testing.assert_close(got[:, 50:].float(), plain[:, 50:].float(),
                               **FLASH_TOL[torch.bfloat16])


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


def test_flash_wgmma_kernel_skipped_q_tile_writes_zero(card):
    from repro_torch.kernels.flash_attention import ops as FA

    q = torch.randn((2, 64, 32), device=card).to(torch.bfloat16)
    k = torch.randn((2, 128, 32), device=card).to(torch.bfloat16)
    before = FA.FLASH_WGMMA_LAUNCHES
    out = FA.flash_attention_kernel(
        q, k, k, torch.arange(64, dtype=torch.int32, device=card),
        torch.arange(1000, 1128, dtype=torch.int32, device=card), scale=0.2)
    assert FA.FLASH_WGMMA_LAUNCHES == before + 1
    assert torch.equal(out, torch.zeros_like(out))


# (M, K, N): ragged, one row, a wide ragged N, the MobileNet-V2 Logits head,
# the full-width deepseek-7b MLP up-projection over 4 x 2,048 tokens, a K
# that is no multiple of 8 (bf16 x read without TMA) with N 48 (w by TMA),
# K 37, N 40 (x of either type and w read without TMA), and one row of K
# 200 against N 1000 (W8A8 on its mma.sync kernel: K % 16 != 0)
GEMM_SHAPES = [(100, 200, 300), (1, 64, 17), (33, 1280, 1000), (64, 1280, 1000),
               (8192, 4096, 11008), (37, 100, 48), (19, 37, 40), (1, 200, 1000)]


def int8(g, shape, card, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device=card, dtype=torch.int8)


def w8a8_case(card, M, K, N, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    a, w = int8(g, (M, K), card), int8(g, (K, N), card)
    ws = torch.rand((N,), generator=g, device=card) * 0.1 + 0.001
    a_scale = torch.tensor([0.03], device=card)
    a_zp = torch.tensor([-5], dtype=torch.int32, device=card)
    return a, w, a_scale, a_zp, ws


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_kernel_equals_plain_exactly(card, shape, out_dtype):
    """The kernel the variant rule picks (wgmma where K % 16 == 0)."""
    from repro_torch.kernels.quant_matmul import kernel as QK

    M, K, N = shape
    args = w8a8_case(card, M, K, N, M + K + N)
    before, before_wgmma = QK.W8A8_LAUNCHES, QK.W8A8_WGMMA_LAUNCHES
    got = QK.quant_matmul_kernel(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert QK.W8A8_LAUNCHES == before + 1 and got.dtype == out_dtype
    wgmma = QK._variant(K, args[0].data_ptr()) == "wgmma"
    assert wgmma == (K % 16 == 0)
    assert QK.W8A8_WGMMA_LAUNCHES == before_wgmma + wgmma
    want = QK.quant_matmul_plain(*args, out_dtype=out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_mma_variant_equals_plain_exactly(card, shape, out_dtype):
    """The mma.sync kernel, forced, at every shape (it takes any K)."""
    from repro_torch.kernels.quant_matmul import kernel as QK

    M, K, N = shape
    args = w8a8_case(card, M, K, N, M + K + N)
    before_wgmma = QK.W8A8_WGMMA_LAUNCHES
    got = QK.quant_matmul_kernel(*args, out_dtype=out_dtype, variant="mma")
    torch.cuda.synchronize()
    assert QK.W8A8_WGMMA_LAUNCHES == before_wgmma
    assert torch.equal(got, QK.quant_matmul_plain(*args, out_dtype=out_dtype))


def test_w8a8_variant_rule_is_the_c_entrys(card):
    """``_variant`` names the kernel ``quant_matmul_w8a8`` runs, for every
    K up to 300 and activation addresses off 16-byte alignment; the wgmma
    variant is refused where the rule does not pick it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.quant_matmul import kernel as QK

    lib = build.load("quant_matmul.cu").lib
    buf = torch.zeros((64,), dtype=torch.int8, device=card)
    for off in range(16):
        ptr = buf[off:].data_ptr()
        for K in range(1, 301):
            assert bool(lib.quant_matmul_w8a8_variant(K, ptr)) == (QK._variant(K, ptr) == "wgmma")
    args = w8a8_case(card, 4, 200, 16, 1)
    with pytest.raises(ValueError):
        QK.quant_matmul_kernel(*args, variant="wgmma")


@pytest.mark.parametrize("zp", [-37, 91])
def test_w8a8_kernel_fma_epilogue_beyond_2_24(card, zp):
    """int8 values near 100 make |acc| > 2^24, where f32(acc) rounds: the
    kernel's one-FMA epilogue must still equal the plain version bit for
    bit (and so differ from the int32-subtracting reference there), on the
    wgmma kernel the rule picks (K 4096) and on the mma.sync kernel."""
    from repro_torch.kernels.quant_matmul import kernel as QK
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    g = torch.Generator(device=card).manual_seed(zp + 100)
    a, w = int8(g, (64, 4096), card, 90), int8(g, (4096, 512), card, 90)
    ws = torch.rand((512,), generator=g, device=card) * 0.1 + 0.001
    args = (a, w, torch.tensor([0.03], device=card),
            torch.tensor([zp], dtype=torch.int32, device=card), ws)
    before_wgmma = QK.W8A8_WGMMA_LAUNCHES
    got = QK.quant_matmul_kernel(*args)
    assert QK.W8A8_WGMMA_LAUNCHES == before_wgmma + 1
    assert torch.equal(got, QK.quant_matmul_plain(*args))
    assert not torch.equal(got, quant_matmul_ref(*args))
    assert torch.equal(QK.quant_matmul_kernel(*args, variant="mma"), got)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["out-f32", "out-bf16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["x-f32", "x-bf16"])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a16_kernel_equals_plain(card, shape, x_dtype, out_dtype):
    """Both sum float32 products of the same values, in another order (the
    kernel forms them on the bf16 tensor cores, float32 x as three bf16
    pieces): the reference kernel test's rtol (1e-4 in float32, 2e-2 for a
    bfloat16 output: one rounding), with atol scaled to the output's rms,
    as the reference test's outputs are O(1) and these grow with K."""
    from repro_torch.kernels.quant_matmul import kernel as QK

    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g, device=card).to(x_dtype)
    w = int8(g, (K, N), card)
    ws = torch.rand((N,), generator=g, device=card) * 0.05 + 0.001
    before = QK.W8A16_LAUNCHES
    got = QK.w8a16_matmul_kernel(x, w, ws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert QK.W8A16_LAUNCHES == before + 1 and got.dtype == out_dtype
    want = QK.w8a16_matmul_plain(x, w, ws, out_dtype=out_dtype).float()
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    rms = float(want.square().mean().sqrt())
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol * rms)


# (BH, BG, S, ph, ds, chunk): the reference kernel test's shapes, a shared
# B/C group, ragged S, one zamba2-1.2b Mamba2 layer (4 x 64 heads), a chunk
# of 50 (no multiple of 16) with ds 4, odd widths with groups of 3 heads,
# ds 128 at chunk 128 and ph 64, and ragged S with chunk 16 in groups of 2
SSD_SHAPES = [(4, 4, 64, 16, 8, 16), (3, 3, 100, 16, 8, 32), (1, 1, 256, 64, 64, 128),
              (2, 2, 37, 8, 8, 16), (8, 2, 1000, 64, 64, 128), (8, 2, 1000, 64, 64, 16),
              (256, 4, 2048, 64, 64, 128), (2, 1, 50, 8, 4, 128), (6, 2, 257, 33, 17, 64),
              (8, 2, 300, 64, 128, 128), (4, 2, 999, 24, 40, 16)]
# the reference kernel test's tolerance in float32; in bfloat16 both round
# the same float32 result, so one bf16 ulp (2^-7 relative) on top
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2 ** -7 + 2e-4, atol=1e-3)}


def ssd_inputs(g, BH, BG, S, ph, ds, card, dtype):
    sp = torch.nn.functional.softplus
    x = torch.randn((BH, S, ph), generator=g, device=card).to(dtype)
    b = (torch.randn((BG, S, ds), generator=g, device=card) * 0.5).to(dtype)
    c = (torch.randn((BG, S, ds), generator=g, device=card) * 0.5).to(dtype)
    dA = -sp(torch.randn((BH, S), generator=g, device=card))
    dt = sp(torch.randn((BH, S), generator=g, device=card))
    return x, b, c, dA, dt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_kernel_equals_plain(card, shape, dtype):
    from repro_torch.kernels.ssm_scan import kernel as SK

    BH, BG, S, ph, ds, ck = shape
    g = torch.Generator(device=card).manual_seed(BH * S + ph)
    args = ssd_inputs(g, BH, BG, S, ph, ds, card, dtype)
    before = SK.SSD_LAUNCHES
    got = SK.ssm_scan_kernel(*args, chunk=ck)
    torch.cuda.synchronize()
    assert SK.SSD_LAUNCHES == before + 1 and got.dtype == dtype
    want = SK.ssm_scan_plain(*args, chunk=ck)
    torch.testing.assert_close(got.float(), want.float(), **SSD_TOL[dtype])


def test_ssd_kernel_matches_sequential_ref(card):
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    g = torch.Generator(device=card).manual_seed(5)
    args = ssd_inputs(g, 8, 2, 300, 64, 64, card, torch.float32)
    torch.testing.assert_close(SK.ssm_scan_kernel(*args, chunk=128), ssm_scan_ref(*args),
                               **SSD_TOL[torch.float32])


def test_ssd_op_mixed_types_launch_in_float32(card):
    """bfloat16 x with float32 b, c: the op launches the kernel on float32
    copies and returns bfloat16, equal to the plain version's rounding."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ops as SO

    g = torch.Generator(device=card).manual_seed(6)
    B, S, H, ph, ds = 2, 300, 4, 64, 64
    x = torch.randn((B, S, H, ph), generator=g, device=card).to(torch.bfloat16)
    b = torch.randn((B, S, ds), generator=g, device=card) * 0.5
    c = torch.randn((B, S, ds), generator=g, device=card) * 0.5
    dA = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g, device=card))
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g, device=card))
    before = SK.SSD_LAUNCHES
    got = SO.ssm_scan(x, b, c, dA, dt)
    torch.cuda.synchronize()
    assert SK.SSD_LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, *t.shape[3:]).contiguous()
    want = SK.ssm_scan_plain(fold(x).float(), b, c, fold(dA), fold(dt))
    torch.testing.assert_close(fold(got).float(), want.to(torch.bfloat16).float(),
                               **SSD_TOL[torch.bfloat16])


def test_launch_counts_are_exact_across_threads(card):
    """Eight threads launch both DP kernels at once (rebuilds launch from a
    worker thread): the counters lose no launch."""
    from concurrent.futures import ThreadPoolExecutor

    C, ns = tie_rich(65, 4, 54, seed=3)
    Ct = torch.tensor(C, dtype=torch.float32, device=card)
    nst = torch.tensor(ns, dtype=torch.int32, device=card)
    bank, tx = Ct[0], Ct[:, 0, 0].contiguous()

    def launch(_):
        for _ in range(25):
            CD.dense_dp(Ct, nst)
            CD.fused_dp(bank, tx, nst)
        torch.cuda.synchronize()

    before = CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(launch, range(8)))
    assert (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES, CD.FUSED_TILED_LAUNCHES) == \
        (before[0] + 200, before[1] + 200, before[2] + 200)


# ---------------------------------------------------------------------------
# Split execution of the CNNs: cuDNN convolutions, no kernel of the port's
# ---------------------------------------------------------------------------

def cnn_case(card, name):
    """A CNN at a small size with the same seeded weights and input on the
    card and on the CPU."""
    from repro_torch.models.mobilenetv2 import MobileNetV2
    from repro_torch.models.resnet50 import ResNet50

    model = (MobileNetV2(width=0.35, image_size=96) if name == "mobilenet_v2"
             else ResNet50(image_size=64))
    x = torch.randn(model.input_shape(2), generator=torch.Generator().manual_seed(1))
    return model, {dev: (model.init(torch.Generator().manual_seed(0), device=dev), x.to(dev))
                   for dev in (card, "cpu")}


@pytest.mark.parametrize("name", ["mobilenet_v2", "resnet50"])
def test_cnn_on_card_matches_cpu(card, name):
    """Card within 1e-4 x rms of the CPU on the same weights and input:
    TF32 convolutions (~1e-3 relative) would fail this, even with the
    caller's process-wide TF32 flags on."""
    from repro_torch.core.executor import run_unsplit

    model, runs = cnn_case(card, name)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = run_unsplit(model, *runs[card])["h"].cpu().double()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = run_unsplit(model, *runs["cpu"])["h"].double()
    assert (got - want).abs().max() <= 1e-4 * want.square().mean().sqrt()
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name,splits", [("mobilenet_v2", (7, 48, 51)),
                                         ("mobilenet_v2", (1, 2, 30, 53)),
                                         ("resnet50", (5, 20, 35, 50))])
def test_split_equals_unsplit_on_card(card, name, splits):
    """Bit for bit on the card without the wire; with it, every hop
    record equals the CPU run's."""
    from repro_torch.core.executor import run_split, run_unsplit

    model, runs = cnn_case(card, name)
    ref = run_unsplit(model, *runs[card])
    out, _ = run_split(model, *runs[card], splits)
    assert torch.equal(out["h"], ref["h"])
    hops = {}
    for dev in (card, "cpu"):
        _, trace = run_split(model, *runs[dev], splits, link=PP.ESP_NOW, quantize_wire=True)
        hops[dev] = [(h.boundary_layer, h.nbytes, h.n_packets, h.sim_latency_s)
                     for h in trace.hops]
    assert hops[card] == hops["cpu"] and len(hops["cpu"]) == len(splits)


# ---------------------------------------------------------------------------
# Quantizers on the card against the CPU, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,symmetric", [(None, False), (None, True), (1, True), (0, False)])
def test_quantize_on_card_equals_cpu(card, axis, symmetric):
    """Scales, zero points and codes equal the CPU's on the same input:
    the scales divide by 255 or 127 correctly rounded, as the reference
    does (a CUDA tensor divided by a Python number multiplies by its
    reciprocal instead, one ulp off on some inputs)."""
    from repro_torch.core.quantization import quantize

    g = torch.Generator().manual_seed(11)
    for trial in range(20):
        x = torch.randn((64, 96), generator=g) * (0.01 + trial)
        got, want = quantize(x.to(card), axis, symmetric), quantize(x, axis, symmetric)
        for name in ("values", "scale", "zero_point"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), (trial, name)


def test_int8_kv_quantizer_on_card_equals_cpu(card):
    from repro_torch.models.layers import quantize_kv

    g = torch.Generator().manual_seed(12)
    t = torch.randn((2, 64, 8, 128), generator=g) * torch.rand((2, 64, 8, 1), generator=g) * 9
    t[1, 3] = 0.0  # zero rows: scale 1
    for dtype in (torch.float32, torch.bfloat16):
        got, want = quantize_kv(t.to(dtype).to(card)), quantize_kv(t.to(dtype))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


# ---------------------------------------------------------------------------
# LM serving layers on the card against the CPU: MoE, MLA, the int8 cache
# ---------------------------------------------------------------------------

def lm_pair(card, arch, **kw):
    """The reduced float32 config's model with the same seeded weights on
    the card and on the CPU."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = replace(get_config(arch).reduced(), **{"use_flash_kernel": True, **kw})
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = T.Transformer(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    return cfg, {card: gpu, "cpu": cpu}


def lm_steps(cfg, model, dev, n_decode=3):
    """Prefill 24 tokens into a 32-row cache and ``n_decode`` greedy
    ``serve_step``s: the logits of each and the final cache, on the CPU."""
    from repro_torch.models import transformer as T

    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(1))
    cache = T.init_cache(cfg, 2, 32, device=dev)
    logits, cache = T.prefill(cfg, model, {"tokens": tokens.to(dev)}, cache)
    out = [logits.cpu()]
    for i in range(n_decode):
        tok = out[-1][:, -1, :cfg.vocab].argmax(-1)[:, None]
        logits, cache = T.serve_step(cfg, model, {"tokens": tok.to(dev), "cur_index": 24 + i},
                                     cache)
        out.append(logits.cpu())
    return out, {k: v.cpu() for k, v in cache.items()}


@pytest.mark.parametrize("arch,kw", [("granite-moe-1b-a400m", {}),
                                     ("granite-moe-1b-a400m", {"moe_group_size": 16,
                                                               "moe_capacity_factor": 0.5}),
                                     ("minicpm3-4b", {}),
                                     ("minicpm3-4b", {"mla_absorbed_decode": False})],
                         ids=["moe", "moe-overflow", "mla-absorbed", "mla-expanded"])
def test_moe_and_mla_serving_on_card_match_cpu(card, arch, kw):
    """Prefill (the flash kernel for GQA layers; MLA runs none) and
    greedy decode on the card within rtol 1e-4 / atol 1e-5 of the CPU's
    plain path, float32, with the same greedy picks; the MoE keeps the
    same (token, slot) pairs."""
    cfg, models = lm_pair(card, arch, **kw)
    picks = {}
    for dev, model in models.items():
        if cfg.is_moe:
            from repro_torch.models.layers import top_k_lower_index

            picks[dev] = []
            for block in model.blocks:
                block.ff.select = lambda p, k, rec=picks[dev]: rec.append(
                    top_k_lower_index(p, k).cpu()) or rec[-1].to(p.device)
    got, got_cache = lm_steps(cfg, models[card], card)
    want, want_cache = lm_steps(cfg, models["cpu"], "cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    for k in want_cache:
        torch.testing.assert_close(got_cache[k], want_cache[k], rtol=1e-4, atol=1e-5)
    if cfg.is_moe:
        assert all(torch.equal(a, b) for a, b in zip(picks[card], picks["cpu"]))


def test_int8_cache_on_card_equals_cpu_quantizer(card):
    """qwen2-vl reduced, bf16: the card's int8 codes and scales equal the
    CPU quantizer's on the same k and v, bit for bit; a bf16 prefill
    launches the wgmma flash kernel over the dequantized cache."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = replace(get_config("qwen2-vl-72b").reduced(), use_flash_kernel=True,
                  dtype="bfloat16")
    model = T.init_params(cfg, generator=torch.Generator(device=card).manual_seed(0),
                          device=card)
    calls = []
    quantize = L.quantize_kv
    L.quantize_kv = lambda t: calls.append((t, *quantize(t))) or calls[-1][1:]
    try:
        g = torch.Generator(device=card).manual_seed(1)
        x = (torch.randn((2, 40, cfg.d_model), generator=g, device=card) * 0.02).bfloat16()
        cache = T.init_cache(cfg, 2, 48, device=card)
        FA.reset_launch_count()
        T.prefill(cfg, model, {"embeds": x}, cache)
        torch.cuda.synchronize()
    finally:
        L.quantize_kv = quantize
    assert FA.FLASH_WGMMA_LAUNCHES == cfg.n_layers
    assert cache["k"].dtype == torch.int8 and len(calls) == 2 * cfg.n_layers
    for i, (t, vals, scale) in enumerate(calls):
        want_vals, want_scale = L.quantize_kv(t.cpu())
        assert torch.equal(vals.cpu(), want_vals) and torch.equal(scale.cpu(), want_scale)
        name = "kv"[i % 2]
        assert torch.equal(cache[name][i // 2, :, :40].cpu(), want_vals)
        assert torch.equal(cache[name + "_scale"][i // 2, :, :40].cpu(), want_scale)


def float32_settings() -> dict:
    """Every process-wide setting that decides how a float32 or bf16
    product runs on the card."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    names = [(matmul, "allow_tf32"), (cudnn, "allow_tf32"), (cudnn, "benchmark"),
             (cudnn, "deterministic"), (matmul, "allow_bf16_reduced_precision_reduction")]
    return {f"{type(obj).__name__}.{name}": getattr(obj, name) for obj, name in names}


def test_float32_lm_on_card_ignores_the_callers_tf32(card):
    """deepseek-7b reduced, float32, plain attention, at d 256 with 4
    heads of 64 and a 1,024-token vocab: a prefill of 2 x 24 tokens and 4
    greedy ``serve_step``s on the card within 1e-4 x rms of the CPU on
    the same weights, with the caller's TF32 flags on, as in
    ``test_cnn_on_card_matches_cpu``. TF32 products in the attention
    scores, the PV product or the LM head would put the card far outside
    that (at ``reduced()``'s own d 64 the flags change no logit, hence
    the wider model). The model scopes IEEE float32 per call and restores
    the caller's settings."""
    cfg, models = lm_pair(card, "deepseek-7b", use_flash_kernel=False, d_model=256,
                          head_dim=64, d_ff=512, vocab=1024)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        callers = float32_settings()
        got, _ = lm_steps(cfg, models[card], card, n_decode=4)
        assert float32_settings() == callers
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want, _ = lm_steps(cfg, models["cpu"], "cpu", n_decode=4)
    assert len(got) == len(want) == 5
    for step, (g, w) in enumerate(zip(got, want)):
        g, w = g.double(), w.double()
        used = float((g - w).abs().max() / (1e-4 * w.square().mean().sqrt()))
        assert used <= 1.0, f"step {step}: {used:.4g} x the limit (1e-4 x rms)"


# ---------------------------------------------------------------------------
# SSM and hybrid models: the SSD kernel on the Mamba2 prefill path
# ---------------------------------------------------------------------------

SSD_CONTRACT = dict(rtol=2e-4, atol=1e-4)  # the reference kernel test's, float32


def mamba_on_card(card, cfg, S, seed):
    """A seeded float32 Mamba2 mixer on the card, its input (1, S, d) of
    unit rms, and ``mamba_chunked`` run twice: the kernel's y and output
    (with the scan's inputs recorded), then the plain chunk body's on the
    same card tensors."""
    from repro_torch.models import ssm as S_

    g = torch.Generator(device=card).manual_seed(seed)
    mixer = S_.Mamba2(cfg, device=card, dtype=torch.float32)
    with torch.no_grad():
        mixer.init_weights(g)
        x = torch.randn((2, S, cfg.d_model), generator=g, device=card)
    seen, scan = [], S_.mamba_scan
    try:
        S_.mamba_scan = lambda *a: seen.append((a, scan(*a))) or seen[-1][1]
        with torch.no_grad():
            got = S_.mamba_chunked(cfg, mixer, x, chunk=cfg.scan_chunk)
        S_.mamba_scan = S_.mamba_scan_plain
        with torch.no_grad():
            want = S_.mamba_chunked(cfg, mixer, x, chunk=cfg.scan_chunk)
    finally:
        S_.mamba_scan = scan
    torch.cuda.synchronize()
    (args, y), = seen
    return args, y, got, want


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mamba_chunked_kernel_equals_plain_body_on_card(card, width):
    """zamba2-1.2b's Mamba2 mixer, float32, at ``reduced()`` size (8 heads
    of 16, ds 16, chunk 16; S 40: a ragged tail) and one full-width layer
    (64 heads of 64, ds 64, chunk 128; S 1,000): the kernel's y against
    the reference's chunk body on the same card inputs within the
    kernel's contract, one launch per call, x, B and C handed over as
    float32; the mixer's output within the contract's rtol and its atol
    times the output's rms."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.models import ssm as S_

    full = get_config("zamba2-1.2b")
    cfg, S = (replace(full.reduced(), dtype="float32"), 40) if width == "reduced" else \
        (replace(full, dtype="float32"), 1000)
    SK.reset_launch_count()
    (x, b, c, dA, dt, chunk), y, got, want = mamba_on_card(card, cfg, S, seed=5)
    assert SK.SSD_LAUNCHES == 1 and chunk == cfg.scan_chunk
    assert x.dtype == b.dtype == c.dtype == y.dtype == torch.float32
    torch.testing.assert_close(y, S_.mamba_scan_plain(x, b, c, dA, dt, chunk), **SSD_CONTRACT)
    rms = float(want.square().mean().sqrt())
    torch.testing.assert_close(got, want, rtol=SSD_CONTRACT["rtol"],
                               atol=SSD_CONTRACT["atol"] * rms)


def test_ssd_launches_once_per_mamba_layer(card):
    """zamba2 reduced on the card: a prefill step launches the SSD kernel
    once per Mamba2 layer (2) and the flash kernel once per application
    of the shared attention block (2); decode steps launch neither."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    cfg = replace(get_config("zamba2-1.2b").reduced(), use_flash_kernel=True)
    model = T.init_params(cfg, generator=torch.Generator(device=card).manual_seed(0),
                          device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    SK.reset_launch_count()
    FA.reset_launch_count()
    make_prefill_step(cfg)(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert SK.SSD_LAUNCHES == cfg.pattern.count("mamba") == 2
    assert FA.FLASH_LAUNCHES == cfg.pattern.count("attn") == 2
    cache = T.init_cache(cfg, 2, 8, device=card)
    T.serve_step(cfg, model, {"tokens": tokens[:, :1], "cur_index": 0}, cache)
    torch.cuda.synchronize()
    assert SK.SSD_LAUNCHES == 2 and FA.FLASH_LAUNCHES == 2


def hybrid_steps(cfg, model, dev, P=24, n_decode=3):
    """The uncached forward over a 2 x ``P`` prompt, the prompt streamed
    token by token through ``serve_step`` from a fresh cache, then
    ``n_decode`` greedy steps: each step's logits, on the CPU."""
    from repro_torch.models import transformer as T

    tokens = torch.randint(0, cfg.vocab, (2, P), generator=torch.Generator().manual_seed(1))
    out = [T.forward(cfg, model, {"tokens": tokens.to(dev)})[0].cpu()]
    cache = T.init_cache(cfg, 2, P + n_decode, device=dev)
    for t in range(P + n_decode):
        tok = tokens[:, t:t + 1] if t < P else out[-1][:, -1, :cfg.vocab].argmax(-1)[:, None]
        logits, cache = T.serve_step(cfg, model, {"tokens": tok.to(dev), "cur_index": t}, cache)
        out.append(logits.cpu())
    return out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_float32_hybrids_on_card_ignore_the_callers_tf32(card, arch):
    """zamba2 and xlstm reduced, float32, widened to d 256: the uncached
    forward (zamba2: the SSD and flash kernels), the prompt streamed
    through ``serve_step`` and 3 greedy steps on the card, with the
    caller's TF32 flags on, within 1e-4 x rms of the CPU on the same
    weights (``test_float32_lm_on_card_ignores_the_callers_tf32``'s
    pattern)."""
    cfg, models = lm_pair(card, arch, d_model=256)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        callers = float32_settings()
        got = hybrid_steps(cfg, models[card], card)
        assert float32_settings() == callers
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = hybrid_steps(cfg, models["cpu"], "cpu")
    assert len(got) == len(want) == 28
    for step, (g, w) in enumerate(zip(got, want)):
        g, w = g[..., :cfg.vocab].double(), w[..., :cfg.vocab].double()
        used = float((g - w).abs().max() / (1e-4 * w.square().mean().sqrt()))
        assert used <= 1.0, f"step {step}: {used:.4g} x the limit (1e-4 x rms)"


def mamba_grads(cfg, dev, seed=3, S=40):
    """A reduced float32 Mamba2 mixer seeded on the CPU and moved to
    ``dev``: ``mamba_chunked`` on a (2, S, d) input of unit rms, the sum
    of its output times fixed weights backpropagated; the input's and
    every leaf's gradient, on the CPU."""
    from repro_torch.models import ssm as S_

    g = torch.Generator().manual_seed(seed)
    mixer = S_.Mamba2(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        mixer.init_weights(g)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    w = torch.randn((2, S, cfg.d_model), generator=g)
    mixer = mixer.to(dev).requires_grad_(True)
    x = x.to(dev).requires_grad_(True)
    out = S_.mamba_chunked(cfg, mixer, x, chunk=cfg.scan_chunk)
    names, leaves = zip(*mixer.named_parameters())
    grads = torch.autograd.grad((out * w.to(dev)).sum(), (x, *leaves))
    return {name: t.cpu() for name, t in zip(("x",) + names, grads)}


def test_mamba_mixer_gradients_on_card_equal_cpu(card):
    """zamba2's reduced Mamba2 mixer, float32: every gradient on the card
    within 1e-4 x its rms of the CPU's, and no SSD launch. Where autograd
    records, the scan runs the chunk body on the card; the kernel has no
    backward, and an untracked kernel output would leave only the
    ``x * D`` skip's gradient."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import kernel as SK

    cfg = replace(get_config("zamba2-1.2b").reduced(), dtype="float32")
    SK.reset_launch_count()
    got = mamba_grads(cfg, card)
    torch.cuda.synchronize()
    assert SK.SSD_LAUNCHES == 0
    want = mamba_grads(cfg, "cpu")
    for name, w in want.items():
        w64, g64 = w.double(), got[name].double()
        used = float((g64 - w64).abs().max() / (1e-4 * w64.square().mean().sqrt()))
        assert used <= 1.0, f"{name}: {used:.4g} x the limit (1e-4 x rms)"


@pytest.mark.parametrize("op", ["flash_attention", "ssm_scan"])
def test_kernel_ops_refuse_autograd_on_card(card, op):
    """Both kernel ops raise on a grad-requiring CUDA input under grad
    mode, and launch under ``no_grad``."""
    from torch_parity import grad_op_inputs

    q, args = grad_op_inputs(op, card)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{op} has no backward"):
        args()
    with torch.no_grad():
        assert torch.isfinite(args()).all()



# ---------------------------------------------------------------------------
# Training: the train step, checkpoints and launch counts on the card
# ---------------------------------------------------------------------------

def train_step_run(cfg, model, dev, lr=1e-3):
    """One ``make_train_step`` over 2 microbatches of a seeded batch, and
    microbatch 0's gradients: (loss, {name: grad}, {name: updated param},
    {name: first moment}), on the CPU."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    batch = SyntheticLMData(cfg, 4, 24, seed=1).batch_at(0)
    _, grads = loss_and_grads(cfg, model, {k: v[0] for k, v in batch.items()})
    grads = {k: g.cpu() for k, g in grads.items()}
    _, opt, metrics = make_train_step(cfg, AdamWConfig(lr=lr))(model, adamw_init(model), batch)
    return (float(metrics["loss"]), grads, {k: v.cpu() for k, v in model.state_dict().items()},
            {k: v.cpu() for k, v in opt["mu"].items()})


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b"])
def test_train_step_on_card_equals_cpu(card, arch):
    """Reduced float32 (attention on the chunked core, as the reference
    trains), the same weights on both devices, 2 microbatches, the
    caller's TF32 flags on: the loss within 1e-5
    relative, every gradient leaf of microbatch 0 within 1e-4 x its rms,
    the step's first moment within 1e-4 x its rms, the updated parameters
    within their bound wherever the update's sign is determined
    (``torch_parity.card_step_used``), and the
    caller's settings restored. No kernel launches: the Mamba2 scan takes
    the chunk body under autograd."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import kernel as SK
    from torch_parity import card_step_used

    cfg, models = lm_pair(card, arch, train_microbatches=2, use_flash_kernel=False)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    FA.reset_launch_count()
    SK.reset_launch_count()
    try:
        callers = float32_settings()
        got = train_step_run(cfg, models[card], card)
        torch.cuda.synchronize()
        assert float32_settings() == callers
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert FA.FLASH_LAUNCHES == SK.SSD_LAUNCHES == 0
    want = train_step_run(cfg, models["cpu"], "cpu")
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for what, i in (("gradient", 1), ("first moment", 3)):
        for k, w in want[i].items():
            w64 = w.double()
            used = float((got[i][k].double() - w64).abs().max()
                         / (1e-4 * max(float(w64.square().mean().sqrt()), 1e-30)))
            assert used <= 1.0, f"{what} {k}: {used:.4g} x the limit"
    clipped = {k: mu.double() / 0.1 for k, mu in want[3].items()}  # mu / (1 - b1)
    used, loose = card_step_used(got[2], want[2], clipped, 1e-3)
    assert used <= 1.0 and loose <= 1e-3 * sum(w.numel() for w in want[2].values())


def test_bf16_checkpoint_roundtrip_on_card(card, tmp_path):
    """A bf16 model and float32 moments on the card: saved (async), the
    live tensors then updated in place, restored into a fresh card
    template bit for bit as they were saved."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    cfg = get_config("deepseek-7b").reduced(dtype="bfloat16")
    model = T.init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    opt = adamw_init(model)
    with torch.no_grad():
        for v in opt["nu"].values():
            v.uniform_()
    want = ({k: v.cpu().clone() for k, v in model.state_dict().items()},
            {k: v.cpu().clone() for k, v in opt["nu"].items()})
    store = CheckpointStore(tmp_path)
    store.save_async(1, (model, opt), extra={"next_step": 1})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    fresh = T.init_params(cfg, torch.Generator(device=card).manual_seed(1), device=card)
    (got, got_opt), extra = store.restore((fresh, adamw_init(fresh)))
    assert extra == {"next_step": 1} and got.device.type == card.type
    for k, v in got.state_dict().items():
        assert v.dtype == want[0][k].dtype and torch.equal(v.cpu(), want[0][k]), k
    for k, v in got_opt["nu"].items():
        assert torch.equal(v.cpu(), want[1][k]), k


# --------------------------------------------------------------------------
# The sharded backend and the pipeline runtime on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [None, 1])
def test_sharded_on_card_equals_cuda(card, n_shards):
    """``backend="sharded"`` on every card (or one) == ``backend="cuda"``
    node for node, one dense launch per shard; padding where S is no
    multiple of the card count."""
    from repro_torch.core import shard as SH
    from repro_torch.core.sweep import batched_optimal_dp

    C, ns = tie_rich(257, 5, 54, seed=21)
    want = batched_optimal_dp(C, backend="cuda", n_devices=ns)
    before = CD.DENSE_LAUNCHES
    got = SH.sharded_optimal_dp(C, n_devices=ns, n_shards=n_shards)
    shards = n_shards or torch.cuda.device_count()
    assert CD.DENSE_LAUNCHES - before == shards
    for k in ("splits", "cost_s", "feasible", "n_devices_s"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_pipeline_on_card_equals_cpu(card):
    """The pipeline over 4 stages on the card (reduced deepseek-7b, 8
    layers, float32) == its own sequential blocks bit for bit, and == the
    CPU pipeline within 1e-4 x rms."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel import pipeline as PPL

    class Plan:
        splits = (3, 5, 7)

    cfg = get_config("deepseek-7b").reduced(n_layers=8)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        model = model.to(dev)
        pos = torch.arange(16, dtype=torch.int32, device=dev).expand(2, 16)
        x = torch.randn(5, 2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
        x = x.to(dev)
        apply = PPL.transformer_block_apply(model, cfg, pos)
        outs[dev] = PPL.run_pipeline(Plan(), apply, PPL.stack_blocks(model), 8, x,
                                     devices=[dev] * 4)
        want = []
        with torch.no_grad(), model.float32_scope():
            for h in x:
                for block in model.blocks:
                    h = block(cfg, h, pos, None, 0, False)
                want.append(h)
        assert torch.equal(outs[dev], torch.stack(want)), dev
    err = float((outs["cuda"].cpu() - outs["cpu"]).abs().max())
    assert err <= 1e-4 * float(outs["cpu"].pow(2).mean().sqrt()), err
