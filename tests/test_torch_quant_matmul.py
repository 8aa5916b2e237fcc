"""The port's int8 GEMMs against the reference's, on the CPU.

* W8A8: the kernel's plain version (what ``quant_matmul`` runs for CPU
  tensors) equals the Pallas kernel in interpret mode bit for bit, over
  the reference kernel test's shapes and in a case with a_zp != 0 and
  |acc| > 2^24, where both compute the epilogue as one FMA. It agrees with
  the integer reference ``quant_matmul_ref`` within the reference test's
  ``rtol = atol = 1e-6`` (one float32 rounding apart), and there it
  differs from it, as the reference kernel does.
* W8A16: the plain version against the interpreted kernel at the
  reference test's tolerances (1e-4 in float32, 2e-2 with bfloat16 x).
* the W8A8 pre-pass (w transposed and its column sums) mirrored on the
  CPU (``w8a8_prep_mirror``: the kernel's byte permutes and per-block
  signed-byte sums) against the plain version and the reference;
* ``quant_linear`` and ``w8a16_linear`` end to end against the
  reference's, and the refusals of the wrappers.

Inputs are made from a seed with numpy and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as ref_quantize
from repro.kernels.quant_matmul import ops as RO
from repro.kernels.quant_matmul import ref as RR
from repro.kernels.quant_matmul.kernel import quant_matmul_kernel as ref_qmm_kernel
from repro.kernels.quant_matmul.kernel import w8a16_matmul_kernel as ref_w8a16_kernel
from repro_torch import convert
from repro_torch.core.quantization import quantize
from repro_torch.kernels.quant_matmul import kernel as QK
from repro_torch.kernels.quant_matmul import ops as QO
from repro_torch.kernels.quant_matmul import ref as QR

T = torch.from_numpy


def w8a8_inputs(M, K, N, seed, lo=-128):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, 128, (M, K), dtype=np.int8)
    w = rng.integers(lo, 128, (K, N), dtype=np.int8)
    w_scale = rng.uniform(0.001, 0.1, N).astype(np.float32)
    return a, w, w_scale


def ref_w8a8(a, w, a_scale, a_zp, w_scale, out_dtype=jnp.float32):
    out = ref_qmm_kernel(jnp.asarray(a), jnp.asarray(w), jnp.float32(a_scale),
                         jnp.int32(a_zp), jnp.asarray(w_scale), out_dtype=out_dtype,
                         interpret=True)
    return np.asarray(out.astype(jnp.float32))


def port_w8a8(a, w, a_scale, a_zp, w_scale, out_dtype=torch.float32):
    return QO.quant_matmul(T(a), T(w), a_scale, a_zp, T(w_scale), out_dtype=out_dtype)


# the reference kernel test's shapes (tests/test_kernels.py)
W8A8_SHAPES = [(64, 64, 64), (128, 256, 512), (100, 200, 300), (1, 64, 17),
               (256, 128, 128), (33, 65, 129)]


@pytest.mark.parametrize("shape", W8A8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_plain_equals_interpreted_kernel(shape):
    M, K, N = shape
    a, w, ws = w8a8_inputs(M, K, N, seed=M * K + N)
    got = port_w8a8(a, w, 0.03, -5, ws)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref_w8a8(a, w, 0.03, -5, ws))
    ref = RR.quant_matmul_ref(jnp.asarray(a), jnp.asarray(w), jnp.float32(0.03),
                              jnp.int32(-5), jnp.asarray(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("a_zp", [-37, 91])
def test_w8a8_fma_epilogue_beyond_2_24(a_zp):
    """int8 values near 100 push |acc| past 2^24, where f32(acc) rounds.
    The interpreted kernel subtracts ``a_zp * colsum`` in one FMA; the
    plain version must equal it bit for bit, and both differ from the
    int32-subtracting reference by about one float32 rounding."""
    a, w, ws = w8a8_inputs(64, 4096, 512, seed=a_zp + 200, lo=90)
    acc = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    got = port_w8a8(a, w, 0.03, a_zp, ws).numpy()
    assert np.array_equal(got, ref_w8a8(a, w, 0.03, a_zp, ws))
    ref = np.asarray(RR.quant_matmul_ref(jnp.asarray(a), jnp.asarray(w), jnp.float32(0.03),
                                         jnp.int32(a_zp), jnp.asarray(ws)))
    assert not np.array_equal(got, ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    port_ref = QR.quant_matmul_ref(T(a), T(w), 0.03, a_zp, T(ws)).numpy()
    assert np.array_equal(port_ref, ref)


@pytest.mark.parametrize("a_zp", [0, -5])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_out_dtypes_equal_interpreted_kernel(out_dtype, a_zp):
    a, w, _ = w8a8_inputs(64, 64, 64, seed=7)
    ws = np.full((64,), 0.02, np.float32)
    got = port_w8a8(a, w, 0.1, a_zp, ws, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    want = ref_w8a8(a, w, 0.1, a_zp, ws, out_dtype=getattr(jnp, out_dtype))
    assert np.array_equal(got.float().numpy(), want)


# the reference kernel test's shapes, then K over several pre-pass blocks
# with N no multiple of 4, and MobileNet-V2's Logits head (K 1280, N 1000)
PREP_SHAPES = [s[1:] for s in W8A8_SHAPES] + [(1100, 17), (1280, 1000)]


@pytest.mark.parametrize("shape", PREP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_prep_mirror_equals_plain_and_reference(shape):
    """The W8A8 pre-pass's byte permutes and per-block signed-byte sums,
    mirrored on the CPU: w transposed exactly, and column sums equal to
    the plain version's and to the reference kernel's zero-point sums."""
    K, N = shape
    _, w, _ = w8a8_inputs(1, K, N, seed=K + N)
    wT, colsum = QK.w8a8_prep_mirror(T(w))
    assert wT.dtype == torch.int8 and torch.equal(wT, T(w).T.contiguous())
    assert colsum.dtype == torch.int32
    assert torch.equal(colsum, T(w).sum(0, dtype=torch.int32))
    assert np.array_equal(colsum.numpy(), np.asarray(jnp.sum(jnp.asarray(w, jnp.int32), 0)))


def test_w8a8_prep_mirror_launches_nothing():
    QK.reset_launch_counts()
    _, w, _ = w8a8_inputs(1, 64, 64, seed=5)
    QK.w8a8_prep_mirror(T(w))
    assert (QK.W8A8_LAUNCHES, QK.W8A8_WGMMA_LAUNCHES) == (0, 0)


def test_integer_and_float_references_match_the_reference():
    a, w, ws = w8a8_inputs(32, 48, 16, seed=3)
    args_j = (jnp.asarray(a), jnp.asarray(w), jnp.float32(0.05), jnp.int32(4), jnp.asarray(ws))
    args_t = (T(a), T(w), 0.05, 4, T(ws))
    assert np.array_equal(QR.quant_matmul_ref(*args_t).numpy(),
                          np.asarray(RR.quant_matmul_ref(*args_j)))
    f_port = QR.float_matmul_ref(*args_t).numpy()
    np.testing.assert_allclose(f_port, np.asarray(RR.float_matmul_ref(*args_j)),
                               rtol=1e-5, atol=1e-5)
    # the zero-point-folded integer math equals dequantize-then-matmul
    np.testing.assert_allclose(QR.quant_matmul_ref(*args_t).numpy(), f_port,
                               rtol=1e-4, atol=1e-4)
    assert QR.int_matmul(T(a), T(w)).dtype == torch.int32


# the reference test's W8A16 shapes
W8A16_SHAPES = [(64, 64, 64), (100, 200, 300), (1, 128, 32), (256, 128, 512)]


@pytest.mark.parametrize("shape", W8A16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a16_plain_matches_interpreted_kernel(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(0.001, 0.05, N).astype(np.float32)
    got = QO.w8a16_matmul(T(x), T(w), T(ws))
    want = np.asarray(ref_w8a16_kernel(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        QR.w8a16_matmul_ref(T(x), T(w), T(ws)).numpy(),
        np.asarray(RR.w8a16_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a16_bf16_activations(out_dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w = rng.integers(-128, 128, (64, 48)).astype(np.int8)
    ws = np.full((48,), 0.02, np.float32)
    got = QO.w8a16_matmul(xb, T(w), T(ws), out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    want = ref_w8a16_kernel(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(w), jnp.asarray(ws), out_dtype=getattr(jnp, out_dtype),
                            interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


# float32 values the three-piece split must carry exactly: zero, tiny and
# huge normals, both signs, and neighbours of powers of two
SPLIT_EDGES = np.array(
    [0.0, -0.0, 1e-30, -1e-30, 3e38, -3e38, 2.0 ** -110, -(2.0 ** -110), 1.0, -1.0,
     np.nextafter(np.float32(1), np.float32(2)), np.nextafter(np.float32(1), np.float32(0)),
     np.nextafter(np.float32(2), np.float32(0)), np.nextafter(np.float32(0.5), np.float32(1)),
     np.float32(1 + 2 ** -8 + 2 ** -16 + 2 ** -23), np.float32(-(2 - 2 ** -23)) * 2.0 ** 100,
     np.float32(1 + 2 ** -9) * 2.0 ** -60, 127.5, -128.0, 65504.0], np.float32)


def split_draws(seed):
    """Seeded float32 draws over many binades, with the edge values."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1, 2, 4000) * rng.choice([-1, 1], 4000)
    x = (mant * 2.0 ** rng.integers(-110, 127, 4000)).astype(np.float32)
    return np.concatenate([x, rng.standard_normal(4000).astype(np.float32), SPLIT_EDGES])


def test_split_bf16_reconstructs_float32_exactly():
    """x1 + x2 + x3 == x for every draw (in float64, where the sum is
    exact), each piece a bf16 and each rounding that of the kernel."""
    x = T(split_draws(0))
    pieces = QK.split_bf16(x)
    assert [p.dtype for p in pieces] == [torch.bfloat16] * 3
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, x.double())
    # each piece carries the next 8 significant bits: |x - x1| <= 2^-8 |x|
    rest = (x.double() - pieces[0].double()).abs()
    assert bool((rest <= 2.0 ** -8 * x.double().abs()).all())
    # bfloat16 x is its own single piece
    xb = x.to(torch.bfloat16)
    assert torch.equal(QK.split_bf16(xb, pieces=1)[0], xb)


def test_split_bf16_products_are_exact():
    """sum over pieces of bf16(piece) * bf16(w), formed in float64, equals
    float64(x) * float64(w) for every int8 w: each product the tensor cores
    form is exact, so only the order of the float32 sum can differ."""
    x = T(split_draws(1))
    w = torch.arange(-128, 128, dtype=torch.int8)
    wb = w.to(torch.bfloat16)
    assert torch.equal(wb.double(), w.double())  # int8 is exact in bf16
    got = sum(p.double()[:, None] * wb.double()[None, :] for p in QK.split_bf16(x))
    assert torch.equal(got, x.double()[:, None] * w.double()[None, :])


@pytest.mark.parametrize("shape", W8A16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a16_split_arithmetic_matches_interpreted_kernel(shape):
    """The kernel's arithmetic, mirrored on the CPU: the exact sum of the
    three pieces' products (float64), rounded to float32, times w_scale,
    against the reference kernel in interpret mode at its tolerance."""
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(0.001, 0.05, N).astype(np.float32)
    acc = sum(p.double() @ T(w).double() for p in QK.split_bf16(T(x)))
    got = (acc.float() * T(ws)[None, :]).numpy()
    want = np.asarray(ref_w8a16_kernel(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def linear_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], 64)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("axis", [1, None], ids=["per-channel", "per-tensor"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 4, 128)], ids=["2d", "3d"])
def test_quant_linear_equals_reference(shape, axis):
    """Bit-equal quantization and a bit-equal W8A8 plain version make the
    layer bit-equal to the reference's on the interpreted kernel; the
    integer path (``use_kernel=False``) equals the reference's too."""
    x, w = linear_inputs(shape, seed=len(shape))
    wq_ref = ref_quantize(jnp.asarray(w), axis=axis, symmetric=True)
    wq = quantize(T(w), axis=axis, symmetric=True)
    got = QO.quant_linear(T(x), wq)
    assert got.shape == (*shape[:-1], 64) and got.dtype == torch.float32
    want = RO.quant_linear(jnp.asarray(x), wq_ref, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(QO.quant_linear(T(x), wq, use_kernel=False).numpy(),
                          np.asarray(RO.quant_linear(jnp.asarray(x), wq_ref, use_kernel=False)))
    # a converted reference QTensor gives the same layer
    assert torch.equal(QO.quant_linear(T(x), convert.qtensor_from_reference(wq_ref)), got)
    ref = x @ w
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel


def test_quant_linear_keeps_bfloat16():
    x, w = linear_inputs((8, 128), seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = QO.quant_linear(xb, quantize(T(w), axis=1, symmetric=True))
    want = RO.quant_linear(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                           ref_quantize(jnp.asarray(w), axis=1, symmetric=True),
                           interpret=True)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("axis", [1, None], ids=["per-channel", "per-tensor"])
def test_w8a16_linear_matches_reference(axis):
    x, w = linear_inputs((2, 4, 128), seed=5)
    wq_ref = ref_quantize(jnp.asarray(w), axis=axis, symmetric=True)
    got = QO.w8a16_linear(T(x), quantize(T(w), axis=axis, symmetric=True))
    want = RO.w8a16_linear(jnp.asarray(x), wq_ref, interpret=True)
    assert got.shape == (2, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    ref = x @ w
    rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
    assert rel < 0.01, rel


def _bad_calls():
    a = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 6), dtype=torch.int8)
    ws = torch.ones(6)
    x = torch.zeros((4, 8))
    return {
        "w8a8-a-float": lambda: QO.quant_matmul(x, w, 1.0, 0, ws),
        "w8a8-w-int16": lambda: QO.quant_matmul(a, w.short(), 1.0, 0, ws),
        "w8a8-k-mismatch": lambda: QO.quant_matmul(a, w[:7], 1.0, 0, ws),
        "w8a8-w-scale-shape": lambda: QO.quant_matmul(a, w, 1.0, 0, ws[:5]),
        "w8a8-out-f16": lambda: QO.quant_matmul(a, w, 1.0, 0, ws, out_dtype=torch.float16),
        "w8a8-empty": lambda: QO.quant_matmul(a[:0], w, 1.0, 0, ws),
        "w8a16-x-f16": lambda: QO.w8a16_matmul(x.half(), w, ws),
        "w8a16-x-int8": lambda: QO.w8a16_matmul(a, w, ws),
        "w8a16-w-float": lambda: QO.w8a16_matmul(x, w.float(), ws),
        "w8a16-out-f64": lambda: QO.w8a16_matmul(x, w, ws, out_dtype=torch.float64),
        "linear-axis-0": lambda: QO.quant_linear(x, quantize(torch.ones((8, 6)), axis=0)),
        "w8a16-linear-axis-0": lambda: QO.w8a16_linear(x, quantize(torch.ones((8, 6)), axis=0)),
        "kernel-scale-shape": lambda: QK.quant_matmul_kernel(
            a, w, torch.ones(2), torch.zeros(1, dtype=torch.int32), ws),
        "kernel-zp-float": lambda: QK.quant_matmul_kernel(a, w, torch.ones(1), torch.zeros(1), ws),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """A ``*_kernel`` function launches its CUDA kernel or raises; it
    never computes the result another way."""
    a = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 6), dtype=torch.int8)
    QK.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        QK.quant_matmul_kernel(a, w, torch.ones(1), torch.zeros(1, dtype=torch.int32),
                               torch.ones(6))
    with pytest.raises(ValueError, match="CUDA"):
        QK.w8a16_matmul_kernel(torch.zeros((4, 8)), w, torch.ones(6))
    QO.quant_linear(torch.ones((4, 8)), quantize(torch.ones((8, 6)), axis=1, symmetric=True))
    QO.w8a16_linear(torch.ones((4, 8)), quantize(torch.ones((8, 6)), axis=1, symmetric=True))
    assert (QK.W8A8_LAUNCHES, QK.W8A16_LAUNCHES) == (0, 0)


def test_ops_never_fall_back_off_the_cpu(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel path."""
    taken = []
    monkeypatch.setattr(QO, "quant_matmul_kernel",
                        lambda a, *r, **kw: taken.append(("w8a8", a.device)) or a)
    monkeypatch.setattr(QO, "w8a16_matmul_kernel",
                        lambda x, *r, **kw: taken.append(("w8a16", x.device)) or x)
    for name in ("quant_matmul_plain", "w8a16_matmul_plain"):
        monkeypatch.setattr(QO, name, lambda *a, **kw: pytest.fail("plain version ran"))
    meta = torch.device("meta")
    QO.quant_matmul(torch.zeros((4, 8), dtype=torch.int8, device=meta),
                    torch.zeros((8, 6), dtype=torch.int8, device=meta), 1.0, 0,
                    torch.ones(6, device=meta))
    QO.w8a16_matmul(torch.zeros((4, 8), device=meta),
                    torch.zeros((8, 6), dtype=torch.int8, device=meta), torch.ones(6, device=meta))
    assert taken == [("w8a8", meta), ("w8a16", meta)]


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delitem(build._LOADED, "quant_matmul.cu", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("quant_matmul.cu")
