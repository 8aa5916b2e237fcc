"""The port's attention against the reference's, on the CPU.

* the flash kernel's plain version (``kernels/flash_attention``, what the
  wrapper runs for CPU tensors) against ``attention_ref`` and against the
  Pallas kernel in interpret mode, over the shapes of
  ``tests/test_kernels.py::TestFlashAttention`` with its tolerances
  (float32 ``rtol 1e-3, atol 2e-5``; bfloat16 ``rtol 2e-2, atol 2e-2``);
* ``plain_attention`` and ``chunked_attention`` against the reference
  functions in float32 (``rtol 1e-5``: the same arithmetic, summed in
  another order), including idle rows at position -1;
* the wrapper's refusals: bad inputs raise, and the kernel path raises
  when the kernel cannot be built instead of computing anything;
* the wgmma kernel's arithmetic, mirrored on the CPU (64-row tiles, the
  skip rule, float32 scores of bf16 inputs, the online softmax, P split
  into two bf16 pieces times bf16 V), against both references, and the
  rule that routes a call to one kernel or the other.

Inputs are made from a seed with numpy and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.models import layers as RL
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.ref import attention_ref, split_hi_lo
from repro_torch.models import layers as PL

# (B, Sq, Skv, H, Hkv, D, bq, bkv): the reference kernel test's shapes
SHAPES = [
    (2, 128, 128, 4, 2, 32, 32, 64),
    (1, 64, 64, 4, 4, 64, 16, 16),
    (2, 100, 100, 4, 1, 32, 32, 32),   # MQA + ragged
    (1, 1, 256, 8, 2, 64, 8, 64),      # decode-shaped
    (1, 96, 200, 2, 2, 16, 32, 64),    # q suffix of longer kv
    (1, 256, 256, 2, 2, 128, 128, 128),
]


def qkv(B, Sq, Skv, H, Hkv, D, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(dtype)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(dtype)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(dtype)
    return q, k, v


def fold(x):
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_flash_plain_version_matches_reference(shape):
    B, Sq, Skv, H, Hkv, D, bq, bkv = shape
    q, k, v = qkv(B, Sq, Skv, H, Hkv, D, seed=Sq + Skv)
    qpos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    scale = D ** -0.5
    got = FA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(np.tile(qpos[None], (B, 1))),
        kv_positions=torch.from_numpy(kpos), scale=scale).numpy()
    want = ref_attention(jnp.asarray(fold(q)), jnp.asarray(fold(k)),
                         jnp.asarray(fold(v)), jnp.asarray(qpos),
                         jnp.asarray(kpos), scale)
    want = np.asarray(want).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-5)
    kernel = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_positions=jnp.tile(jnp.asarray(qpos)[None], (B, 1)),
                       kv_positions=jnp.asarray(kpos), scale=scale,
                       block_q=bq, block_kv=bkv, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-3, atol=2e-5)


def test_flash_plain_version_bf16():
    B, S, H, D = 1, 128, 2, 64
    q, k, v = qkv(B, S, S, H, H, D, seed=0)
    pos = np.arange(S, dtype=np.int32)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = FA.flash_attention(*bf, q_positions=torch.from_numpy(pos)[None],
                             kv_positions=torch.from_numpy(pos), scale=D ** -0.5)
    assert got.dtype == torch.bfloat16
    # both sides see the same bfloat16-rounded inputs
    q32, k32, v32 = (jnp.asarray(x.float().numpy()) for x in bf)
    kernel = ref_flash(q32.astype(jnp.bfloat16), k32.astype(jnp.bfloat16),
                       v32.astype(jnp.bfloat16), q_positions=jnp.asarray(pos)[None],
                       kv_positions=jnp.asarray(pos), scale=D ** -0.5,
                       block_q=32, block_kv=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kernel.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_plain_version_is_the_folded_reference_arithmetic():
    """The wrapper folds (B, S, H, D) to (B*H, S, D) and back; GQA maps q
    head h to kv head h // group within each batch row."""
    B, Sq, Skv, H, Hkv, D = 2, 12, 20, 4, 2, 8
    q, k, v = (torch.from_numpy(x) for x in qkv(B, Sq, Skv, H, Hkv, D, seed=3))
    qpos = torch.arange(Skv - Sq, Skv, dtype=torch.int32)
    kpos = torch.arange(Skv, dtype=torch.int32)
    got = FA.flash_attention(q, k, v, q_positions=qpos, kv_positions=kpos, scale=0.3)
    for b in range(B):
        for h in range(H):
            one = attention_ref(q[b, :, h][None], k[b, :, h // 2][None],
                                v[b, :, h // 2][None], qpos, kpos, 0.3)[0]
            torch.testing.assert_close(got[b, :, h], one, rtol=0, atol=0)


def _ref_plain(q, k, v, qpos, kpos, scale):
    return np.asarray(RL.plain_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        scale=scale))


def test_plain_attention_with_idle_rows_matches_reference():
    """Decode as the server runs it: per-row positions, idle rows at -1
    (every kv position masked) average v and carry no NaN."""
    B, Skv, H, Hkv, D = 4, 24, 4, 2, 16
    q, k, v = qkv(B, 1, Skv, H, Hkv, D, seed=7)
    qpos = np.array([[5], [-1], [23], [-1]], np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    got = PL.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), q_positions=torch.from_numpy(qpos),
                             kv_positions=torch.from_numpy(kpos), scale=0.25).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref_plain(q, k, v, qpos, kpos, 0.25), rtol=1e-5,
                               atol=1e-6)
    idle = v[1].mean(axis=0)  # (Hkv, D): uniform weights over all kv rows
    np.testing.assert_allclose(got[1, 0], np.repeat(idle, H // Hkv, axis=0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("Sq,Skv,H,Hkv", [(6, 6, 4, 4), (3, 40, 4, 1), (8, 8, 4, 2)])
def test_plain_attention_matches_reference(Sq, Skv, H, Hkv):
    B, D = 2, 16
    q, k, v = qkv(B, Sq, Skv, H, Hkv, D, seed=Sq * Skv)
    qpos = np.tile(np.arange(Skv - Sq, Skv, dtype=np.int32)[None], (B, 1))
    kpos = np.arange(Skv, dtype=np.int32)
    got = PL.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), q_positions=torch.from_numpy(qpos),
                             kv_positions=torch.from_numpy(kpos), scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), _ref_plain(q, k, v, qpos, kpos, D ** -0.5),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("Sq,Skv,q_chunk,kv_chunk", [
    (40, 40, 16, 32),   # ragged q and kv chunks
    (24, 70, 512, 32),  # q suffix of a longer kv (prefill into a cache)
    (33, 33, 8, 8),
])
def test_chunked_attention_matches_reference(Sq, Skv, q_chunk, kv_chunk, causal_skip):
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v = qkv(B, Sq, Skv, H, Hkv, D, seed=Sq + kv_chunk)
    qpos = np.tile(np.arange(Skv - Sq, Skv, dtype=np.int32)[None], (B, 1))
    kpos = np.arange(Skv, dtype=np.int32)
    kw = dict(scale=D ** -0.5, kv_chunk=kv_chunk, q_chunk=q_chunk,
              causal_skip=causal_skip)
    got = PL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_positions=torch.from_numpy(qpos),
                               kv_positions=torch.from_numpy(kpos), **kw)
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_positions=jnp.asarray(qpos),
                                kv_positions=jnp.asarray(kpos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_rope_rotates_interleaved_pairs_as_the_reference():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.randint(0, 100, size=(2, 5)).astype(np.int32)
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy()
    want = np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def _bad_calls():
    q = torch.zeros((1, 16, 2, 8))
    pos = torch.arange(16, dtype=torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos, scale=1.0)
    return {
        "f16": lambda: FA.flash_attention(q.half(), q.half(), q.half(), **kw),
        "mixed-dtype": lambda: FA.flash_attention(q, q.double(), q, **kw),
        "head-dim": lambda: FA.flash_attention(q, q[..., :4], q[..., :4], **kw),
        "heads-not-grouped": lambda: FA.flash_attention(
            torch.zeros((1, 16, 3, 8)), q, q, **kw),
        "kv-positions-2d": lambda: FA.flash_attention(
            q, q, q, q_positions=pos, kv_positions=pos[None], scale=1.0),
        "positions-length": lambda: FA.flash_attention(
            q, q, q, q_positions=pos[:4], kv_positions=pos, scale=1.0),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


@pytest.mark.parametrize("B,H,Hkv", [(1, 4, 2), (2, 1, 1), (1, 1, 1)])
def test_wrapper_hands_the_kernel_contiguous_rows(monkeypatch, B, H, Hkv):
    """Folding (B, S, H, D) to (B*H, S, D) with B or H of 1 is a strided
    view under reshape; the kernel path gets contiguous tensors."""
    seen = []
    monkeypatch.setattr(FA, "flash_attention_kernel",
                        lambda *a, **kw: seen.extend(a[:3]) or a[0])
    q = torch.zeros((B, 16, H, 8), device="meta")
    kv = torch.zeros((B, 16, Hkv, 8), device="meta")
    pos = torch.arange(16, dtype=torch.int32, device="meta")
    FA.flash_attention(q, kv, kv, q_positions=pos, kv_positions=pos, scale=1.0)
    assert [t.shape for t in seen] == [(B * H, 16, 8), (B * Hkv, 16, 8), (B * Hkv, 16, 8)]
    assert all(t.is_contiguous() for t in seen)


def test_kernel_path_raises_without_a_built_kernel(tmp_path, monkeypatch):
    """The kernel path (taken for every tensor not on the CPU) builds the
    CUDA kernel or raises; it never computes the result another way."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delitem(build._LOADED, "flash_attention.cu", raising=False)
    q = torch.zeros((2, 16, 8))
    pos = torch.arange(16, dtype=torch.int32)
    before = FA.FLASH_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        FA.flash_attention_kernel(q, q, q, pos, pos, scale=1.0)
    assert FA.FLASH_LAUNCHES == before


def test_wrapper_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel path."""
    taken = []
    monkeypatch.setattr(FA, "flash_attention_kernel",
                        lambda *a, **kw: taken.append(a[0].device) or a[0])
    monkeypatch.setattr(FA, "attention_ref", lambda *a: pytest.fail("plain version ran"))
    q = torch.zeros((1, 16, 2, 8), device="meta")
    pos = torch.arange(16, dtype=torch.int32, device="meta")
    FA.flash_attention(q, q, q, q_positions=pos, kv_positions=pos, scale=1.0)
    assert taken == [torch.device("meta")]


def test_split_hi_lo_keeps_16_bits_of_p():
    """p_hi + p_lo carries p to 2^-16 of itself wherever the rounding of
    p_lo stays normal (p >= 2^-118); below that the error is under half
    bf16's smallest subnormal (2^-134); p = 0 splits into zeros."""
    rng = np.random.default_rng(0)
    p = np.concatenate([
        rng.uniform(0, 1, 20000), np.exp(-rng.uniform(0, 87, 20000)),
        [0.0, 1.0, 0.5, 2.0 ** -118, 2.0 ** -126, 2.0 ** -100, 1e-30,
         np.nextafter(np.float32(1), np.float32(0)), np.nextafter(np.float32(0.5), np.float32(1)),
         np.float32(1 - 2 ** -9), np.float32(2 ** -8 + 2 ** -17)]]).astype(np.float32)
    hi, lo = split_hi_lo(torch.from_numpy(p))
    assert hi.dtype == lo.dtype == torch.bfloat16
    pd = torch.from_numpy(p).double()
    err = (pd - hi.double() - lo.double()).abs()
    normal = pd >= 2.0 ** -118
    assert bool((err[normal] <= 2.0 ** -16 * pd[normal]).all())
    assert bool((err <= torch.maximum(2.0 ** -16 * pd, torch.tensor(2.0 ** -134))).all())
    assert float(hi[p == 0].abs().max()) == 0.0 and float(lo[p == 0].abs().max()) == 0.0


def wgmma_arithmetic(q, k, v, qpos, kpos, scale, tile=64):
    """The wgmma kernel's function on the CPU, tile by tile: q rows in
    tiles of 64 (a consumer warpgroup), kv rows in tiles of 64, a tile
    skipped when its first position is past the q tile's last; float32
    scores of bf16 inputs scaled, the -1e30 mask, the online softmax with
    corr = exp(m_old - m_new), P V as split_hi_lo's two pieces times V
    (exact products, summed in float64), out = acc / max(l, 1e-30)."""
    group = q.shape[0] // k.shape[0]
    Sq, Skv = q.shape[1], k.shape[1]
    out = torch.zeros(q.shape, dtype=torch.float32)
    for h in range(q.shape[0]):
        kh, vh = k[h // group].float(), v[h // group].float()
        for q0 in range(0, Sq, tile):
            qt, pos = q[h, q0:q0 + tile].float(), qpos[q0:q0 + tile]
            m = torch.full((len(pos), 1), -1e30)
            l = torch.zeros((len(pos), 1))
            acc = torch.zeros((len(pos), q.shape[2]), dtype=torch.float64)
            for k0 in range(0, Skv, tile):
                if int(kpos[k0]) > int(pos[-1]):
                    continue
                s = (qt @ kh[k0:k0 + tile].T) * scale
                s = torch.where(kpos[None, k0:k0 + tile] <= pos[:, None], s, -1e30)
                m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(1, keepdim=True)
                m = m_new
                hi, lo = split_hi_lo(p)
                acc = acc * corr.double() + (hi.double() + lo.double()) @ vh[k0:k0 + tile].double()
            out[h, q0:q0 + tile] = (acc.float() / torch.clamp(l, min=1e-30))
    return out


@pytest.mark.parametrize("shape", [(1, 100, 100, 4, 2, 32), (1, 70, 200, 2, 1, 48),
                                   (2, 130, 130, 2, 2, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_arithmetic_matches_references(shape):
    """bf16 inputs through the kernel's tiled arithmetic stay within the
    float32 tolerance of both references on the same bf16 values: the
    split P costs ~2^-16 relative, not a bf16 rounding."""
    B, Sq, Skv, H, Hkv, D = shape
    q, k, v = (fold(x) for x in qkv(B, Sq, Skv, H, Hkv, D, seed=Sq + D))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    qpos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    scale = D ** -0.5
    got = wgmma_arithmetic(q, k, v, torch.from_numpy(qpos), torch.from_numpy(kpos), scale)
    want = attention_ref(q.float(), k.float(), v.float(), torch.from_numpy(qpos),
                         torch.from_numpy(kpos), scale)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-5)
    ref = ref_attention(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                        jnp.asarray(qpos), jnp.asarray(kpos), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("D", [1, 8, 16, 40, 64, 128, 160, 240, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_variant_routes_bf16_multiples_of_16_to_wgmma(dtype, D):
    want = "wgmma" if dtype == torch.bfloat16 and D % 16 == 0 else "simt"
    assert FA._variant(dtype, D) == want


@pytest.mark.parametrize("dtype,D", [(torch.float32, 128), (torch.bfloat16, 40)],
                         ids=["f32", "bf16-D40"])
def test_wgmma_variant_is_refused_where_it_does_not_apply(dtype, D):
    """Asking for the wgmma kernel where the rule would not pick it raises
    before anything is built or counted; so does an unknown variant."""
    q = torch.zeros((2, 16, D), dtype=dtype)
    pos = torch.arange(16, dtype=torch.int32)
    before = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    with pytest.raises(ValueError, match="wgmma"):
        FA.flash_attention_kernel(q, q, q, pos, pos, scale=1.0, variant="wgmma")
    with pytest.raises(ValueError, match="tensor"):
        FA.flash_attention_kernel(q, q, q, pos, pos, scale=1.0, variant="tensor")
    assert (FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES) == before


def test_kernel_wrapper_routes_by_the_variant_rule(monkeypatch):
    """The wrapper asks ``_variant`` for the kernel before it builds; on CPU
    tensors it then refuses to launch and counts nothing."""
    asked = []
    monkeypatch.setattr(FA, "_variant", lambda dtype, D: asked.append((dtype, D)) or "wgmma")
    monkeypatch.setattr(build, "load", lambda source: None)
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    pos = torch.arange(16, dtype=torch.int32)
    before = FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_kernel(q, q, q, pos, pos, scale=1.0)
    assert asked == [(torch.bfloat16, 64)]
    assert (FA.FLASH_LAUNCHES, FA.FLASH_WGMMA_LAUNCHES) == before
