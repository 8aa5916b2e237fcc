"""The port's int8 gradient compression against the reference's
(``repro.runtime.compression``): the same arithmetic (an exact division
for the scale, half-to-even rounding), so equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.compression import compress_decompress as ref_cd
from repro.runtime.compression import compress_grads as ref_grads
from repro.runtime.compression import wire_bytes as ref_wire
from repro_torch.runtime.compression import (
    compress_decompress,
    compress_grads,
    init_error_feedback,
    wire_bytes,
)


def case(seed, shape, scale):
    rng = np.random.RandomState(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 0.004).astype(np.float32)
    return g, err


def as_port(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("shape,scale", [((64,), 0.1), ((33, 17), 3e-5), ((4, 8, 16), 250.0),
                                         ((5,), 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_equals_reference(shape, scale, dtype):
    """Values, scale and residual bit for bit, for float32 and bfloat16
    gradients with a nonzero error buffer (the all-zero case: scale 1)."""
    g, err = case(7, shape, scale)
    if scale == 0.0:
        err[:] = 0.0
    jdt = jnp.dtype(dtype)
    want_g, want_e = ref_cd(jnp.asarray(g, jdt), jnp.asarray(err))
    got_g, got_e = compress_decompress(as_port(jnp.asarray(g, jdt).astype(jnp.float32),
                                               getattr(torch, dtype)), as_port(err))
    assert got_g.dtype == getattr(torch, dtype) and got_e.dtype == torch.float32
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


def test_compress_grads_and_wire_bytes_equal_reference():
    shapes = {"w": (128, 128), "b": (128,), "s": (3, 5, 7)}
    flat = {k: case(i, s, 0.1) for i, (k, s) in enumerate(shapes.items())}
    ref_tree = {k: jnp.asarray(g) for k, (g, _) in flat.items()}
    ref_err = {k: jnp.asarray(e) for k, (_, e) in flat.items()}
    want_g, want_e = ref_grads(ref_tree, ref_err)
    got_g, got_e = compress_grads({k: as_port(g) for k, (g, _) in flat.items()},
                                  {k: as_port(e) for k, (_, e) in flat.items()})
    for k in shapes:
        np.testing.assert_array_equal(got_g[k].numpy(), np.asarray(want_g[k]))
        np.testing.assert_array_equal(got_e[k].numpy(), np.asarray(want_e[k]))
    assert wire_bytes(got_g) == ref_wire(ref_tree)
    comp, raw = wire_bytes({"w": torch.zeros((128, 128)), "b": torch.zeros(128)})
    assert raw / comp > 3.9


def test_error_feedback_tracks_the_true_sum():
    """The reference test's property: over 20 steps the compressed sum plus
    the last residual equals the true sum within 1e-4."""
    rng = np.random.RandomState(0)
    g_true = [torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
              for _ in range(20)]
    ef = init_error_feedback({"g": torch.zeros(64, dtype=torch.bfloat16)})
    assert ef["g"].dtype == torch.float32
    total = torch.zeros(64)
    for g in g_true:
        out, ef = compress_grads({"g": g}, ef)
        total += out["g"]
    assert float((total + ef["g"] - sum(g_true)).abs().max()) < 1e-4


def test_rounding_is_half_to_even():
    """A gradient whose scaled values land on .5 exactly (amax 127 gives
    scale 1): 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, as numpy rounds."""
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5])
    deq, err = compress_decompress(g, torch.zeros(6))
    assert deq.tolist() == [127.0, 0.0, 2.0, 2.0, 0.0, -4.0]
