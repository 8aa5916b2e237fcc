"""The port's int8 quantization against the reference's, on the CPU.

Every function of ``repro_torch.core.quantization`` must be bit-equal to
its counterpart in ``repro.core.quantization`` on the same numpy inputs:
values, scales, zero points and dequantized floats, including an all-zero
range (scale 1), constant tensors and ties at .5 (both round half to
even)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro_torch import convert
from repro_torch.core import quantization as PQ


def same(ref, port) -> bool:
    ref, port = np.asarray(ref), port.detach().cpu().numpy()
    return ref.dtype == port.dtype and ref.shape == port.shape and np.array_equal(ref, port)


def assert_qtensor_equal(ref, port):
    assert port.axis == ref.axis
    for name in ("values", "scale", "zero_point"):
        assert same(getattr(ref, name), getattr(port, name)), name
    assert same(ref.dequantize(), port.dequantize())
    assert port.nbytes == ref.nbytes


def inputs():
    rng = np.random.RandomState(0)
    return {
        "normal": rng.standard_normal((32, 16)).astype(np.float32) * 3,
        "skewed-channels": (rng.standard_normal((64, 4)) *
                            np.array([0.01, 0.1, 1.0, 10.0])).astype(np.float32),
        "positive": rng.uniform(0.5, 4.0, (8, 8)).astype(np.float32),
        "negative": -rng.uniform(0.5, 4.0, (8, 8)).astype(np.float32),
        "zeros": np.zeros((5, 5), np.float32),
        "constant": np.full((4, 4), 3.7, np.float32),
        "zero-column": np.concatenate([rng.standard_normal((6, 3)),
                                       np.zeros((6, 1))], 1).astype(np.float32),
        "conv-kernel": rng.standard_normal((3, 3, 8, 16)).astype(np.float32),
        # halves: per-tensor scales that land x / scale on .5
        "ties": (np.arange(-8, 8, dtype=np.float32) + 0.5).reshape(4, 4),
    }


CASES = [(axis, symmetric) for axis in (None, 0, 1, -1) for symmetric in (False, True)]


@pytest.mark.parametrize("axis,symmetric", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", sorted(inputs()))
def test_quantize_bit_equal(name, axis, symmetric):
    x = inputs()[name]
    assert_qtensor_equal(RQ.quantize(jnp.asarray(x), axis=axis, symmetric=symmetric),
                         PQ.quantize(torch.from_numpy(x), axis=axis, symmetric=symmetric))


def test_ties_round_half_to_even():
    """Scale 1 (range exactly 255) makes x / scale land on .5: both sides
    must round to the even neighbour, not away from zero."""
    x = np.array([-128.0, 127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    ref = RQ.quantize(jnp.asarray(x))
    port = PQ.quantize(torch.from_numpy(x))
    assert float(port.scale) == 1.0
    assert_qtensor_equal(ref, port)
    assert port.values[2:].tolist() == [0, 2, 2, 0, -2, -2]


def test_all_zero_range_uses_scale_one():
    """Scale 1; the asymmetric zero point is then INT8_MIN - 0 = -128."""
    for symmetric, zp in ((False, -128), (True, 0)):
        port = PQ.quantize(torch.zeros((3, 3)), symmetric=symmetric)
        assert float(port.scale) == 1.0 and int(port.zero_point) == zp
        assert torch.equal(port.dequantize(), torch.zeros((3, 3)))
        assert_qtensor_equal(RQ.quantize(jnp.zeros((3, 3)), symmetric=symmetric), port)


@pytest.mark.parametrize("axis", [None, 1])
def test_fake_quant_bit_equal(axis):
    x = inputs()["skewed-channels"]
    assert same(RQ.fake_quant(jnp.asarray(x), axis=axis),
                PQ.fake_quant(torch.from_numpy(x), axis=axis))


def test_fake_quant_keeps_bfloat16():
    x = torch.from_numpy(inputs()["normal"]).to(torch.bfloat16)
    ref = RQ.fake_quant(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    port = PQ.fake_quant(x)
    assert port.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(ref.astype(jnp.float32)), port.float().numpy())


def params_tree():
    rng = np.random.RandomState(1)
    return {
        "w": rng.standard_normal((16, 8)).astype(np.float32),
        "b": np.zeros((8,), np.float32),
        "nested": {"k": rng.standard_normal((4, 4, 4)).astype(np.float32),
                   "stack": [rng.standard_normal((8, 8)).astype(np.float32) * 0.1,
                             rng.standard_normal((3,)).astype(np.float32)]},
        "steps": np.arange(4, dtype=np.int32),
    }


def tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, fn) for v in tree]
    return fn(tree)


def test_quantize_params_bit_equal():
    ref = RQ.quantize_params(tree_to(params_tree(), jnp.asarray))
    port = PQ.quantize_params(tree_to(params_tree(), torch.from_numpy))
    assert isinstance(port["w"], PQ.QTensor) and isinstance(port["nested"]["k"], PQ.QTensor)
    assert not isinstance(port["b"], PQ.QTensor)  # vectors stay float
    assert port["steps"].dtype == torch.int32  # integer leaves pass through
    for path in (("w",), ("nested", "k"), ("nested", "stack", 0)):
        r, p = ref, port
        for key in path:
            r, p = r[key], p[key]
        assert_qtensor_equal(r, p)
    assert same(ref["nested"]["stack"][1], port["nested"]["stack"][1])


def test_quantize_params_converter_matches_port():
    """``convert.quantized_params_from_reference`` carries a reference
    tree across unchanged: the same leaves the port itself quantizes."""
    ref = RQ.quantize_params(tree_to(params_tree(), jnp.asarray))
    carried = convert.quantized_params_from_reference(ref)
    port = PQ.quantize_params(tree_to(params_tree(), torch.from_numpy))
    for key in ("w",):
        assert_qtensor_equal(ref[key], carried[key])
        assert torch.equal(carried[key].values, port[key].values)
    assert torch.equal(carried["b"], port["b"])
    assert PQ.param_bytes(carried) == PQ.param_bytes(port) == RQ.param_bytes(ref)


def test_dequantize_params_and_param_bytes():
    ref_p = tree_to(params_tree(), jnp.asarray)
    port_p = tree_to(params_tree(), torch.from_numpy)
    assert PQ.param_bytes(port_p) == RQ.param_bytes(ref_p)
    ref_q, port_q = RQ.quantize_params(ref_p), PQ.quantize_params(port_p)
    assert PQ.param_bytes(port_q) == RQ.param_bytes(ref_q)
    ref_d, port_d = RQ.dequantize_params(ref_q), PQ.dequantize_params(port_q)
    assert same(ref_d["w"], port_d["w"])
    assert same(ref_d["nested"]["k"], port_d["nested"]["k"])


@pytest.mark.parametrize("shape", [(7, 7, 112), (56, 56, 48)])
def test_wire_format_bit_equal(shape):
    x = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    ref, port = RQ.encode_activation(jnp.asarray(x)), PQ.encode_activation(torch.from_numpy(x))
    assert_qtensor_equal(ref, port)
    assert port.nbytes == int(np.prod(shape))
    assert same(RQ.decode_activation(ref), PQ.decode_activation(port))
    assert PQ.decode_activation(port, torch.bfloat16).dtype == torch.bfloat16


def test_qtensor_converter_is_exact():
    x = inputs()["skewed-channels"]
    ref = RQ.quantize(jnp.asarray(x), axis=1, symmetric=True)
    assert_qtensor_equal(ref, convert.qtensor_from_reference(ref))
