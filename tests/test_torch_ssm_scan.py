"""The port's chunked SSD scan against the reference's, on the CPU.

* the kernel's chunked plain version (what ``ssm_scan`` runs for CPU
  tensors) against the Pallas kernel in interpret mode and against the
  sequential oracle, over the reference kernel test's shapes with its
  tolerances (``rtol 2e-4, atol 1e-4``: the chunked and the step-by-step
  recurrence sum in another order), ragged S and chunks longer than S;
* the port's sequential oracle against the reference's;
* the model-layout op (B and C shared across heads through a group
  index, no broadcast copy) against the reference op;
* the long-sequence stability case, bfloat16 inputs, the op on mixed
  input types (computed in float32, as the reference does), and the
  wrappers' refusals;
* the CUDA kernels' arithmetic mirrored in PyTorch (``ssm_scan_pieces``:
  three passes, products of exact bf16 pieces summed in float32) against
  the interpreted kernel and the sequential oracle, in float32 and
  bfloat16.

Inputs are made from a seed with numpy and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan_kernel as ref_kernel
from repro.kernels.ssm_scan.ops import ssm_scan as ref_op
from repro.kernels.ssm_scan.ref import ssm_scan_ref as ref_oracle
from repro_torch.kernels.ssm_scan import kernel as SK
from repro_torch.kernels.ssm_scan import ops as SO
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

TOL = dict(rtol=2e-4, atol=1e-4)  # the reference kernel test's


def softplus(z):
    return np.log1p(np.exp(z))


def scan_inputs(lead, S, ph, ds, seed, bc_lead=None, dA_shift=0.0):
    """x (*lead, S, ph), b/c (*bc_lead, S, ds), dA/dt (*lead, S), drawn as
    the reference test draws them."""
    rng = np.random.default_rng(seed)
    bc_lead = lead if bc_lead is None else bc_lead
    x = rng.standard_normal((*lead, S, ph)).astype(np.float32)
    b = (rng.standard_normal((*bc_lead, S, ds)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((*bc_lead, S, ds)) * 0.5).astype(np.float32)
    dA = (-softplus(rng.standard_normal((*lead, S)) + dA_shift)).astype(np.float32)
    dt = softplus(rng.standard_normal((*lead, S))).astype(np.float32)
    return x, b, c, dA, dt


# (BH, S, ph, ds, chunk): the reference kernel test's, a ragged 1000-step
# case, and chunks longer than S
SHAPES = [(4, 64, 16, 8, 16), (2, 128, 32, 16, 32), (3, 100, 16, 8, 32),
          (1, 256, 64, 64, 128), (2, 37, 8, 8, 16), (2, 1000, 16, 16, 128),
          (2, 50, 8, 4, 128)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_interpreted_kernel_and_oracle(shape):
    BH, S, ph, ds, ck = shape
    args = scan_inputs((BH,), S, ph, ds, seed=S * ph)
    got = SK.ssm_scan_plain(*map(torch.from_numpy, args), chunk=ck)
    assert got.shape == (BH, S, ph) and got.dtype == torch.float32
    kern = np.asarray(ref_kernel(*map(jnp.asarray, args), chunk=ck, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_oracle(*map(jnp.asarray, args))),
                               **TOL)


@pytest.mark.parametrize("shape", SHAPES[:5], ids=lambda s: "x".join(map(str, s)))
def test_sequential_oracle_matches_reference(shape):
    BH, S, ph, ds, _ = shape
    args = scan_inputs((BH,), S, ph, ds, seed=S + ph)
    np.testing.assert_allclose(ssm_scan_ref(*map(torch.from_numpy, args)).numpy(),
                               np.asarray(ref_oracle(*map(jnp.asarray, args))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(64, 16), (100, 32)])
def test_model_layout_op_matches_reference(S, chunk):
    B, H, ph, ds = 2, 3, 16, 8
    _, b, c, _, _ = scan_inputs((B,), S, ph, ds, seed=S + 1)  # b, c per batch row
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, H, ph)).astype(np.float32)
    dA = (-softplus(rng.standard_normal((B, S, H)))).astype(np.float32)
    dt = softplus(rng.standard_normal((B, S, H))).astype(np.float32)
    args = (x, b, c, dA, dt)
    got = SO.ssm_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert got.shape == (B, S, H, ph)
    want = ref_op(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the folded oracle with b, c broadcast over the heads
    fold = lambda t: np.ascontiguousarray(np.moveaxis(t, 2, 1)).reshape(B * H, S, *t.shape[3:])
    bf = np.repeat(b, H, axis=0)
    cf = np.repeat(c, H, axis=0)
    ref = ssm_scan_ref(*map(torch.from_numpy, (fold(x), bf, cf, fold(dA), fold(dt))))
    np.testing.assert_allclose(got.numpy(), ref.reshape(B, H, S, ph).transpose(1, 2).numpy(),
                               **TOL)


def test_grouped_b_c_equal_broadcast_copies():
    """b, c of (BG, S, ds) serve sequence bh from row bh // (BH // BG):
    the same function as the reference's broadcast copies, exactly."""
    x, b, c, dA, dt = scan_inputs((6,), 48, 8, 8, seed=9, bc_lead=(2,))
    grouped = SK.ssm_scan_plain(*map(torch.from_numpy, (x, b, c, dA, dt)), chunk=16)
    copied = SK.ssm_scan_plain(*map(torch.from_numpy, (x, np.repeat(b, 3, 0),
                                                       np.repeat(c, 3, 0), dA, dt)), chunk=16)
    assert torch.equal(grouped, copied)
    oracle = ssm_scan_ref(*map(torch.from_numpy, (x, b, c, dA, dt)))
    torch.testing.assert_close(grouped, oracle, **TOL)


def test_long_sequence_stability():
    """Decay keeps the state bounded over long scans (no overflow)."""
    args = scan_inputs((1,), 1024, 8, 8, seed=2, dA_shift=1.0)
    got = SK.ssm_scan_plain(*map(torch.from_numpy, args), chunk=128)
    assert bool(torch.isfinite(got).all())
    kern = np.asarray(ref_kernel(*map(jnp.asarray, args), chunk=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, **TOL)


def test_bfloat16_inputs_match_interpreted_kernel():
    """x, b, c in bfloat16 (dA, dt float32): both compute in float32 and
    round y to bfloat16 once, so they differ by at most one bf16 ulp."""
    x, b, c, dA, dt = scan_inputs((2,), 100, 16, 8, seed=11)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = SK.ssm_scan_plain(bf(x), bf(b), bf(c), torch.from_numpy(dA), torch.from_numpy(dt),
                            chunk=32)
    assert got.dtype == torch.bfloat16
    jb = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = ref_kernel(jb(bf(x)), jb(bf(b)), jb(bf(c)), jnp.asarray(dA), jnp.asarray(dt),
                      chunk=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7 + 2e-4, atol=1e-3)


# (x type, b/c type): mixes the reference op takes, since its kernel casts
# x, b and c to float32 itself
MIXED = [("bfloat16", "float32"), ("float32", "bfloat16"), ("float16", "float16")]


@pytest.mark.parametrize("x_type,bc_type", MIXED, ids=lambda t: t)
def test_model_layout_op_takes_mixed_types(x_type, bc_type):
    """``ssm_scan`` with x, b and c of other types than one float32 or
    bfloat16 pair computes in float32, as the reference does, and returns
    x's type: within one ulp of x's type of the reference op."""
    B, H, S, ph, ds = 2, 3, 40, 8, 8
    _, b, c, _, _ = scan_inputs((B,), S, ph, ds, seed=21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((B, S, H, ph)).astype(np.float32)
    dA = (-softplus(rng.standard_normal((B, S, H)))).astype(np.float32)
    dt = softplus(rng.standard_normal((B, S, H))).astype(np.float32)
    tt = lambda a, t: torch.from_numpy(a).to(getattr(torch, t))
    got = SO.ssm_scan(tt(x, x_type), tt(b, bc_type), tt(c, bc_type), torch.from_numpy(dA),
                      torch.from_numpy(dt), chunk=16)
    assert got.dtype == getattr(torch, x_type)
    jt = lambda t: jnp.asarray(t.float().numpy()).astype(getattr(jnp, str(t.dtype)[6:]))
    want = ref_op(jt(tt(x, x_type)), jt(tt(b, bc_type)), jt(tt(c, bc_type)),
                  jnp.asarray(dA), jnp.asarray(dt), chunk=16, interpret=True)
    assert want.dtype == getattr(jnp, x_type)
    ulp = float(torch.finfo(got.dtype).eps)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=ulp + 2e-4, atol=1e-4 + ulp)


def _bad_calls():
    x, b, c, dA, dt = map(torch.from_numpy, scan_inputs((4,), 32, 8, 8, seed=0))
    return {
        "x-f16": lambda: SK.ssm_scan_plain(x.half(), b.half(), c.half(), dA, dt),
        "b-dtype": lambda: SK.ssm_scan_plain(x, b.double(), c, dA, dt),
        "dA-bf16": lambda: SK.ssm_scan_plain(x, b, c, dA.bfloat16(), dt),
        "dt-shape": lambda: SK.ssm_scan_plain(x, b, c, dA, dt[:, :16]),
        "groups": lambda: SK.ssm_scan_plain(x, b[:3], c[:3], dA, dt),
        "b-c-shape": lambda: SK.ssm_scan_plain(x, b, c[..., :4], dA, dt),
        "chunk-0": lambda: SK.ssm_scan_plain(x, b, c, dA, dt, chunk=0),
        "kernel-chunk": lambda: SK.ssm_scan_kernel(
            *map(torch.from_numpy, scan_inputs((1,), 300, 8, 8, seed=0)), chunk=256),
        "kernel-ph": lambda: SK.ssm_scan_kernel(
            *map(torch.from_numpy, scan_inputs((1,), 32, 128, 8, seed=0))),
        "kernel-cpu": lambda: SK.ssm_scan_kernel(x, b, c, dA, dt),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_plain_version_takes_any_chunk_and_launches_nothing():
    args = tuple(map(torch.from_numpy, scan_inputs((2,), 300, 8, 8, seed=3)))
    SK.reset_launch_count()
    long = SK.ssm_scan_plain(*args, chunk=256)
    torch.testing.assert_close(long, SK.ssm_scan_plain(*args, chunk=100), **TOL)
    assert SK.SSD_LAUNCHES == 0


def test_op_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel path."""
    taken = []
    monkeypatch.setattr(SO, "ssm_scan_kernel",
                        lambda x, *a, **kw: taken.append(x.device) or x)
    monkeypatch.setattr(SO, "ssm_scan_plain", lambda *a, **kw: pytest.fail("plain version ran"))
    meta = torch.device("meta")
    SO.ssm_scan(torch.zeros((2, 16, 3, 8), device=meta), torch.zeros((2, 16, 4), device=meta),
                torch.zeros((2, 16, 4), device=meta), torch.zeros((2, 16, 3), device=meta),
                torch.zeros((2, 16, 3), device=meta))
    assert taken == [meta]


# (BH, BG, S, ph, ds, chunk): the reference test's shapes, ragged S with a
# shared B/C group, and a chunk longer than S
MIRROR_SHAPES = [(4, 4, 64, 16, 8, 16), (2, 2, 128, 32, 16, 32), (3, 3, 100, 16, 8, 32),
                 (1, 1, 256, 64, 64, 128), (2, 2, 37, 8, 8, 16),
                 (6, 2, 300, 16, 16, 128), (2, 1, 50, 8, 4, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MIRROR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_arithmetic_mirror_matches_references(shape, dtype):
    """The kernels' rescaled, piece-split arithmetic, mirrored on the CPU,
    against the reference kernel in interpret mode and the sequential
    oracle, at the reference test's tolerance (in bfloat16 one bf16 ulp on
    top: both round one float32 result)."""
    BH, BG, S, ph, ds, ck = shape
    x, b, c, dA, dt = scan_inputs((BH,), S, ph, ds, seed=BH * S + ds, bc_lead=(BG,))
    tt = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    got = SK.ssm_scan_pieces(tt(x), tt(b), tt(c), torch.from_numpy(dA), torch.from_numpy(dt),
                             chunk=ck)
    assert got.shape == (BH, S, ph) and got.dtype == getattr(torch, dtype)
    # the reference kernel takes b, c per sequence: broadcast copies
    group = BH // BG
    jt = lambda t: jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
    args = (jt(tt(x)), jt(tt(np.repeat(b, group, 0))), jt(tt(np.repeat(c, group, 0))),
            jnp.asarray(dA), jnp.asarray(dt))
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7 + 2e-4, atol=1e-3)
    kern = ref_kernel(*args, chunk=ck, interpret=True).astype(jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kern), **tol)
    oracle = ref_oracle(*args).astype(jnp.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle), **tol)


def test_kernel_arithmetic_mirror_long_sequence_stays_finite():
    """|cum| passes 90 within a chunk here, where exp(-cum) would overflow
    float32: the kernels form L as exp(cum_i - cum_j), never as a product."""
    args = scan_inputs((1,), 1024, 8, 8, seed=2, dA_shift=1.0)
    cum = np.cumsum(args[3].reshape(8, 128), axis=1)
    assert np.abs(cum).max() > 90
    got = SK.ssm_scan_pieces(*map(torch.from_numpy, args), chunk=128)
    assert bool(torch.isfinite(got).all())
    kern = np.asarray(ref_kernel(*map(jnp.asarray, args), chunk=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, **TOL)


def test_kernel_arithmetic_mirror_launches_nothing():
    args = tuple(map(torch.from_numpy, scan_inputs((2,), 40, 8, 8, seed=4)))
    SK.reset_launch_count()
    got = SK.ssm_scan_pieces(*args, chunk=16)
    torch.testing.assert_close(got, SK.ssm_scan_plain(*args, chunk=16), **TOL)
    assert SK.SSD_LAUNCHES == 0
