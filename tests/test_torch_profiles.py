"""The port's copy of the cost model against the reference, bit for bit.

The DP's inputs are built on the host in float64 numpy, in the
reference's operation order; the port keeps its own copy of that code
(``repro_torch.core.{latency,profiles}``, ``repro_torch.models.graph``).
Every array it exports must be bit-equal to the reference's, and
``repro_torch.convert`` must carry the reference's objects across
unchanged."""

import numpy as np
import pytest

from repro.core import latency as RL
from repro.core import profiles as RP
from repro_torch import convert
from repro_torch.core import latency as PL
from repro_torch.core import profiles as PP

MODELS = ("mobilenet", "resnet50")
PROTOCOLS = ("udp", "tcp", "esp_now", "ble")


def profiles(model):
    if model == "mobilenet":
        return RP.mobilenet_cost_profile(), PP.mobilenet_cost_profile()
    return RP.resnet50_cost_profile(), PP.resnet50_cost_profile()


def cost_models(model, protocol, **kw):
    ref, port = profiles(model)
    return (RL.SplitCostModel(ref, (RP.ESP32,), RP.PROTOCOLS[protocol], **kw),
            PL.SplitCostModel(port, (PP.ESP32,), PP.PROTOCOLS[protocol], **kw))


@pytest.mark.parametrize("model", MODELS)
def test_segment_arrays_bit_equal(model):
    ref, port = profiles(model)
    assert port.num_layers == ref.num_layers == {"mobilenet": 54, "resnet50": 52}[model]
    a, b = ref.segment_arrays, port.segment_arrays
    for name in ("infer_s", "param_bytes", "work_bytes", "flops",
                 "boundary_act_bytes"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("is_first", [True, False], ids=["first", "later"])
def test_local_cost_matrix_bit_equal(model, is_first):
    ref, port = cost_models(model, "esp_now")
    assert np.array_equal(ref._local_cost_matrix(RP.ESP32, is_first),
                          port._local_cost_matrix(PP.ESP32, is_first))


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("model", MODELS)
def test_transmission_cost_vector_bit_equal(model, protocol):
    ref, port = cost_models(model, protocol)
    assert np.array_equal(ref.transmission_cost_vector(),
                          port.transmission_cost_vector())


@pytest.mark.parametrize("model", MODELS)
def test_segment_cost_tensor_bit_equal(model):
    ref, port = cost_models(model, "udp")
    assert np.array_equal(ref.segment_cost_tensor(5), port.segment_cost_tensor(5))


def test_scalar_queries_and_energy_bit_equal():
    power = dict(active_power_w=0.4)
    link = dict(tx_power_w=0.2, rx_power_w=0.1)
    ref = RL.SplitCostModel(RP.mobilenet_cost_profile(),
                            (RL.DeviceProfile("d", **power),),
                            RL.LinkProfile("l", 250, 1e5, **link),
                            variant=RL.bottleneck_variant(2.0, encoder_t_s=1e-3))
    port = PL.SplitCostModel(PP.mobilenet_cost_profile(),
                             (PL.DeviceProfile("d", **power),),
                             PL.LinkProfile("l", 250, 1e5, **link),
                             variant=PL.bottleneck_variant(2.0, encoder_t_s=1e-3))
    assert np.array_equal(ref.energy_cost_tensor(3), port.energy_cost_tensor(3))
    for splits in [(10,), (12, 40), (3, 30, 50)]:
        assert ref.end_to_end_s(splits) == port.end_to_end_s(splits)
    for a, b, k in [(1, 54, 1), (5, 20, 2), (21, 53, 3)]:
        assert ref.segment_cost_s(a, b, k) == port.segment_cost_s(a, b, k)
        assert ref.segment_energy_j(a, b, k) == port.segment_energy_j(a, b, k)


@pytest.mark.parametrize("model", MODELS)
def test_convert_round_trip(model):
    ref, port = profiles(model)
    assert convert.profile_from_reference(ref) == port
    assert {k: convert.link_from_reference(v) for k, v in RP.PROTOCOLS.items()} \
        == PP.PROTOCOLS
    assert convert.device_from_reference(RP.ESP32) == PP.ESP32
    assert tuple(convert.variant_from_reference(v)
                 for v in RP.esp32_variant_bank()) == PP.esp32_variant_bank()
