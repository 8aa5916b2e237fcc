"""The port's split executor, on the CPU.

Within the port: split execution equals the unsplit model bit for bit
for any split configuration with ``quantize_wire=False``, and the wire's
accounting (bytes of main + skip tensors, packets, modeled latency) is
consistent with the link, as the reference's ``tests/test_executor.py``
holds the reference. Against the reference, on its own parameters
(``convert.cnn_params_from_reference``): ``segment_bounds`` and its
errors, and ``run_split`` with the int8 wire hop for hop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import executor as RE
from repro.core import profiles as RP
from repro.models.mobilenetv2 import MobileNetV2 as RefMobileNetV2
from repro.models.resnet50 import ResNet50 as RefResNet50
from repro_torch.convert import cnn_params_from_reference, link_from_reference
from repro_torch.core import executor as PE
from repro_torch.core.executor import run_split, run_unsplit, segment_bounds
from repro_torch.core.profiles import ESP_NOW, PROTOCOLS, UDP
from repro_torch.models.mobilenetv2 import MobileNetV2
from repro_torch.models.resnet50 import ResNet50

PAPER_CUTS = ("block_2_expand", "block_15_project_BN", "block_16_project_BN")


def normal(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape)
                            .astype(np.float32))


@pytest.fixture(scope="module")
def mbv2():
    model = MobileNetV2(width=0.35, image_size=64)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    x = normal(model.input_shape(2), seed=1)
    return model, params, x, run_unsplit(model, params, x)


@pytest.fixture(scope="module")
def r50():
    model = ResNet50(image_size=64)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    x = normal(model.input_shape(1), seed=3)
    return model, params, x, run_unsplit(model, params, x)


def paper_cuts(model):
    return tuple(sorted(model.layer_names.index(n) + 1 for n in PAPER_CUTS))


class TestSplitEqualsUnsplit:
    @given(st.data())
    @settings(max_examples=15, deadline=None)
    def test_any_split_configuration_mbv2(self, mbv2, data):
        model, params, x, ref = mbv2
        L = len(model.layer_names)
        n = data.draw(st.integers(2, 5))
        splits = tuple(sorted(data.draw(
            st.sets(st.integers(1, L - 1), min_size=n - 1, max_size=n - 1))))
        out, trace = run_split(model, params, x, splits)
        assert torch.equal(out["h"], ref["h"])
        assert len(trace.hops) == n - 1

    def test_paper_split_points(self, mbv2):
        model, params, x, ref = mbv2
        assert paper_cuts(model) == (7, 48, 51)
        out, _ = run_split(model, params, x, paper_cuts(model))
        assert torch.equal(out["h"], ref["h"])

    def test_resnet50_block_splits(self, r50):
        model, params, x, ref = r50
        out, _ = run_split(model, params, x, (5, 20, 35, 50))
        assert torch.equal(out["h"], ref["h"])

    def test_a_float_hop_hands_on_the_same_tensors(self, mbv2):
        """Without the wire a hop copies nothing (and so keeps the memory
        format): the next layer gets the very tensors the last one made."""
        model, params, x, _ = mbv2
        calls = []

        class Recording:
            layer_names = model.layer_names

            def apply_layer(self, name, p, carry):
                out = model.apply_layer(name, p, carry)
                calls.append((carry, out))
                return out

        cut = model.layer_names.index("block_2_expand") + 1
        run_split(Recording(), params, x, (cut,))
        made, handed = calls[cut - 1][1], calls[cut][0]
        assert sorted(handed) == ["h", "res"]
        assert all(handed[k] is made[k] for k in made)


class TestWireAccounting:
    def test_bytes_include_live_residuals(self, mbv2):
        """A cut inside a residual block ships main + skip tensors."""
        model, params, x, _ = mbv2
        idx = model.layer_names.index("block_2_expand") + 1
        _, trace = run_split(model, params, x, (idx,), quantize_wire=True)
        h, w = 16, 16  # 64px input -> 16x16 at this depth
        assert trace.hops[0].nbytes == 2 * h * w * 48 + 2 * h * w * 8

    def test_block_boundary_ships_the_main_tensor(self, mbv2):
        model, params, x, _ = mbv2
        idx = model.layer_names.index("block_16_project_BN") + 1
        _, trace = run_split(model, params, x, (idx,), quantize_wire=True)
        assert trace.hops[0].nbytes == 2 * 2 * 2 * 112  # 64px -> 2x2 spatial

    def test_float_hops_count_float32_bytes(self, mbv2):
        model, params, x, _ = mbv2
        idx = model.layer_names.index("block_2_expand") + 1
        _, trace = run_split(model, params, x, (idx,))
        assert trace.hops[0].nbytes == 4 * (2 * 16 * 16 * 48 + 2 * 16 * 16 * 8)

    @pytest.mark.parametrize("link", [ESP_NOW, UDP], ids=lambda lk: lk.name)
    def test_packets_and_latency_consistent_with_link(self, mbv2, link):
        model, params, x, _ = mbv2
        _, trace = run_split(model, params, x, (30,), link=link, quantize_wire=True)
        hop = trace.hops[0]
        assert hop.n_packets == link.packets(hop.nbytes)
        assert hop.sim_latency_s == link.transmission_latency_s(hop.nbytes)
        assert trace.total_tx_bytes == hop.nbytes
        assert trace.total_tx_latency_s == hop.sim_latency_s

    def test_without_a_link_hops_cost_nothing(self, mbv2):
        model, params, x, _ = mbv2
        _, trace = run_split(model, params, x, paper_cuts(model), quantize_wire=True)
        assert [(h.boundary_layer, h.n_packets, h.sim_latency_s) for h in trace.hops] == \
            [(n, 0, 0.0) for n in PAPER_CUTS]

    def test_wire_decodes_each_leaf_to_its_own_dtype(self):
        carry = {"res": normal((2, 3, 3, 4), 0).double(), "h": normal((2, 3, 3, 8), 1)}
        out, nbytes = PE._wire_encode(carry)
        assert list(out) == ["h", "res"]
        assert (out["h"].dtype, out["res"].dtype) == (torch.float32, torch.float64)
        assert nbytes == 2 * 3 * 3 * (4 + 8)


@pytest.mark.parametrize("splits,L", [((3,), 5), ((1, 2, 3), 4), ((), 6), ((5, 3), 10),
                                      ((3, 3), 10), ((0, 4), 10), ((4, 10), 10),
                                      ((2, 11), 10)])
def test_segment_bounds_match_reference(splits, L):
    try:
        want = RE.segment_bounds(splits, L)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            segment_bounds(splits, L)
    else:
        assert segment_bounds(splits, L) == want


def test_wire_encode_matches_reference_bit_for_bit():
    """Both leaves of a residual carry through the int8 wire: the same
    decoded values and byte count as the reference's."""
    rng = np.random.RandomState(4)
    carry = {"h": (rng.standard_normal((2, 8, 8, 12)) * 3 + 1).astype(np.float32),
             "res": rng.standard_normal((2, 8, 8, 4)).astype(np.float32)}
    want, want_bytes = RE._wire_encode({k: jnp.asarray(v) for k, v in carry.items()})
    got, got_bytes = PE._wire_encode({k: torch.from_numpy(v) for k, v in carry.items()})
    assert got_bytes == want_bytes
    for k in carry:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def hops(trace):
    return [(h.boundary_layer, h.nbytes, h.n_packets, h.sim_latency_s) for h in trace.hops]


# int8 wire against the reference on its parameters: the hop records are
# shapes and the link's arithmetic, so they must be equal. The outputs
# differ by float32 summation order, which can move an activation across
# a rounding edge of the int8 grid (steps of 1/255 of the hop's range):
# one code then differs by a step and the difference travels downstream.
# Probes on these inputs: 2.2e-6 x rms where no code moved, 9.9e-3 and
# 1.7e-2 x rms where one did; the tolerance is three times the largest
WIRE_TOL = 5e-2


@pytest.mark.parametrize("Ref,Port,kw,batch,splits,proto", [
    (RefMobileNetV2, MobileNetV2, dict(width=0.35, image_size=64), 2,
     (7, 48, 51), "esp_now"),
    (RefMobileNetV2, MobileNetV2, dict(width=0.35, image_size=64), 2,
     (3, 20, 44, 53), "ble"),
    (RefResNet50, ResNet50, dict(image_size=64), 1, (5, 20, 35, 50), "udp"),
], ids=["mobilenet_v2-paper", "mobilenet_v2-other", "resnet50-blocks"])
def test_int8_wire_matches_reference(Ref, Port, kw, batch, splits, proto):
    ref, port = Ref(**kw), Port(**kw)
    rparams = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(1).standard_normal(ref.input_shape(batch)).astype(np.float32)
    want, want_trace = RE.run_split(ref, rparams, jnp.asarray(x), splits,
                                    link=RP.PROTOCOLS[proto], quantize_wire=True)
    got, got_trace = run_split(port, cnn_params_from_reference(rparams), torch.from_numpy(x),
                               splits, link=PROTOCOLS[proto], quantize_wire=True)
    assert link_from_reference(RP.PROTOCOLS[proto]) == PROTOCOLS[proto]
    assert hops(got_trace) == hops(want_trace)
    assert got_trace.total_tx_latency_s == want_trace.total_tx_latency_s
    g, w = got["h"].numpy().astype(np.float64), np.asarray(want["h"], np.float64)
    assert np.abs(g - w).max() <= WIRE_TOL * np.sqrt((w ** 2).mean())
    assert (g.argmax(-1) == w.argmax(-1)).all()
