"""The port's serving runtime against the reference's, on the CPU.

deepseek-7b reduced (float32, ``use_flash_kernel=True``) with the
reference's ``init_params(PRNGKey(0))`` weights carried across. The same
requests served by the reference ``Server`` and the port's must give the
same greedy tokens; within the port, a request's tokens under staggered
admission must equal serving it alone (exact), and the meter's hop
accounting on a plan converted from the reference planner must equal the
reference meter's. With an adaptive manager behind it (``backend="numpy"``
on the port), the meter must follow the reference meter's replans hop for
hop: ``hop_seconds``, ``hops``, ``replans``, the protocol and link it
follows after a protocol switch, and per-token bytes priced at the
adopted variant.

The reference ``Server`` is driven through :class:`SyncedRefServer`: its
``_token_inputs`` hands ``jnp.asarray`` the server's own numpy buffers,
which JAX may wrap without a copy on the CPU, and ``_prefill`` rewrites
those buffers for the next token while the asynchronously dispatched
step may not have read them yet. The reference's tokens then vary from
run to run (its own staggered-admission test fails in some test orders).
The subclass passes copies; it changes nothing else."""

import dataclasses
import types
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import adaptive as RA
from repro.core import profiles as RP
from repro.core.planner import plan_pipeline
from repro.core.profiles import ESP_NOW, ICI
from repro.models import transformer as RT
from repro.models.graph import arch_layer_graph
from repro.runtime import server as RS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import adaptive as PA
from repro_torch.core import planner as PPL
from repro_torch.models import graph as PG
from repro_torch.models import transformer as PT
from repro_torch.runtime import server as PS
from repro_torch.runtime.server import (
    DrainTruncated,
    Request,
    Server,
    SplitLatencyMeter,
)
from torch_parity import plan_fields, synced_ref_server, tpu_stage_hardware

REF_CFG = dataclasses.replace(ref_get_config("deepseek-7b").reduced(), use_flash_kernel=True)
CFG = dataclasses.replace(get_config("deepseek-7b").reduced(), use_flash_kernel=True)
PROMPTS = {0: [3, 9, 4], 1: [11, 5, 7, 2, 60, 1, 8, 8, 30, 12], 2: [21, 9]}


# the reference ``Server`` with each step's host buffers copied
SyncedRefServer = synced_ref_server()

REF = types.SimpleNamespace(Server=SyncedRefServer, Request=RS.Request)


@pytest.fixture(scope="module")
def ref_params():
    return RT.init_params(jax.random.PRNGKey(0), REF_CFG)


@pytest.fixture(scope="module")
def params(ref_params):
    model = PT.Transformer(CFG, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(
        CFG, jax.tree.map(np.asarray, ref_params)))
    return model


def serve(mod, cfg, params, requests, slots=2, **kw):
    """Serve ``(rid, prompt, max_new_tokens)`` requests on ``mod.Server``
    (``mod``: :data:`REF` or the port's server module)."""
    srv = mod.Server(cfg, params, slots=slots, max_seq=64, **kw)
    for rid, prompt, max_new in requests:
        srv.submit(mod.Request(rid, np.array(prompt, np.int32), max_new_tokens=max_new))
    return srv.run_until_drained()


def test_tokens_equal_the_reference_server(ref_params, params):
    requests = [(rid, p, 6) for rid, p in PROMPTS.items()]
    want = serve(REF, REF_CFG, ref_params, requests)
    got = serve(PS, CFG, params, requests)
    assert got.drained and sorted(got) == sorted(PROMPTS)
    assert dict(got) == dict(want)
    assert all(0 <= t < CFG.vocab for toks in got.values() for t in toks)


def test_staggered_admission_equals_serving_alone(params):
    """Three slots, admissions at different offsets: each request's
    tokens equal serving it alone on a server with the same slot count."""
    max_new = 8
    solo = {rid: serve(PS, CFG, params, [(rid, p, max_new)], slots=3)[rid]
            for rid, p in PROMPTS.items()}
    srv = Server(CFG, params, slots=3, max_seq=64)
    emitted = {rid: [] for rid in PROMPTS}
    for rid, ticks in ((0, 2), (1, 3), (2, None)):
        srv.submit(Request(rid, np.array(PROMPTS[rid], np.int32), max_new_tokens=max_new))
        while (srv.queue or srv.active) and (ticks is None or ticks > 0):
            for r, tok in srv.step():
                emitted[r].append(tok)
            ticks = None if ticks is None else ticks - 1
    assert emitted == solo


def test_run_until_drained_reports_truncation(params):
    srv = Server(CFG, params, slots=1, max_seq=64)
    srv.submit(Request(0, np.array([1], np.int32), max_new_tokens=50))
    out = srv.run_until_drained(max_ticks=3)
    assert not out.drained and out.ticks == 3 and len(out[0]) == 3
    assert srv.active


def test_run_until_drained_raise_mode(params):
    srv = Server(CFG, params, slots=1, max_seq=64)
    srv.submit(Request(0, np.array([1], np.int32), max_new_tokens=50))
    with pytest.raises(DrainTruncated) as ei:
        srv.run_until_drained(max_ticks=2, on_truncate="raise")
    assert not ei.value.result.drained and len(ei.value.result[0]) == 2
    with pytest.raises(ValueError):
        srv.run_until_drained(on_truncate="sometimes")


@pytest.mark.parametrize("n_devices", [2, 3])
@pytest.mark.parametrize("bytes_per_token", [0, CFG.d_model * 2])
def test_meter_hops_equal_the_reference_meter(ref_params, params, n_devices,
                                              bytes_per_token):
    plan = plan_pipeline(arch_layer_graph(REF_CFG, batch=2, seq=32), n_devices, link=ICI)
    port_plan = port_tpu_plan(n_devices)
    assert plan_fields(port_plan) == plan_fields(plan)
    want = RS.SplitLatencyMeter(plan=plan, link=ESP_NOW, bytes_per_token=bytes_per_token)
    got = SplitLatencyMeter(plan=port_plan, link=convert.link_from_reference(ESP_NOW),
                            bytes_per_token=bytes_per_token)
    requests = [(0, [1, 2], 3), (1, [4], 2)]
    serve(REF, REF_CFG, ref_params, requests, meter=want)
    serve(PS, CFG, params, requests, meter=got)
    assert got.hops == want.hops == 5 * (n_devices - 1)
    assert got.hop_seconds == want.hop_seconds > 0


def port_tpu_plan(n_stages):
    """The port's own ``plan_pipeline`` on the reference's TPU stages and
    ICI link (the port's defaults are H100 stages and NVLink)."""
    return PPL.plan_pipeline(PG.arch_layer_graph(CFG, batch=2, seq=32), n_stages,
                             link=convert.link_from_reference(ICI),
                             hardware=tpu_stage_hardware())


def managed_meter(port, n_devices, variants):
    """A meter on a 400x-collapsed ESP-NOW link behind an adaptive manager
    (the reference's meter tests' setup), in either package."""
    ref_model = RP.paper_cost_model("mobilenet_v2", "esp_now")
    links = dict(RP.PROTOCOLS)
    bank = RP.esp32_variant_bank() if variants else None
    dead = replace(ESP_NOW, rate_bytes_per_s=ESP_NOW.rate_bytes_per_s / 400)
    kw = dict(n_devices=n_devices, variants=bank,
              surface_grid={"pt_scale": (1.0, 16.0, 256.0), "loss_p": (0.0, 0.1)})
    if port:
        mgr = PA.AdaptiveSplitManager(
            cost_model=convert.cost_model_from_reference(ref_model),
            protocols={k: convert.link_from_reference(v) for k, v in links.items()},
            backend="numpy", **{**kw, "variants": None if bank is None else tuple(
                convert.variant_from_reference(v) for v in bank)})
        return SplitLatencyMeter(plan=mgr.current_plan(), link=convert.link_from_reference(dead),
                                 bytes_per_token=5488, manager=mgr, protocol="esp_now")
    mgr = RA.AdaptiveSplitManager(cost_model=ref_model, protocols=links, **kw)
    return RS.SplitLatencyMeter(plan=mgr.current_plan(), link=dead, bytes_per_token=5488,
                                manager=mgr, protocol="esp_now")


def meter_state(meter):
    segs = meter.plan.segments
    return dict(hop_seconds=meter.hop_seconds, hops=meter.hops, replans=meter.replans,
                protocol=meter.protocol, link=convert.link_from_reference(meter.link),
                plan=convert.plan_from_reference(meter.plan).to_dict() | {"planner_time_s": 0},
                hop_bytes=[meter._hop_bytes(s) for s in segs[:-1]],
                history=[dataclasses.asdict(d) for d in meter.manager.history])


@pytest.mark.parametrize("variants", [False, True], ids=["plain", "variant bank"])
@pytest.mark.parametrize("n_devices", [2, 3])
def test_meter_with_a_manager_follows_the_reference(n_devices, variants):
    """Tokens on a collapsed link until the manager switches protocol (at
    most 300; with the bank at N 2 the compressed cut keeps ESP-NOW), then
    more tokens and a few device-reported hops: at every stage the port's
    meter equals the reference's."""
    want, got = managed_meter(False, n_devices, variants), managed_meter(True, n_devices, variants)
    stages = []
    for _ in range(300):
        want.on_token()
        got.on_token()
        stages.append(meter_state(got) == meter_state(want))
        if want.manager.current.protocol != "esp_now":
            break
    assert all(stages)
    if got.protocol != "esp_now":  # the switch (every case but the bank at N 2)
        assert got.replans >= 1 and got.link.name == got.protocol
        assert got.link.mtu_bytes == got.manager.current.chunk_bytes
    else:
        assert variants and n_devices == 2 and len(stages) == 300
    for nbytes, factor in ((5488, 1.0), (200, 30.0), (5488, 0.5)):
        lat = factor * got.link.transmission_latency_s(nbytes)
        assert got.observe_hop(nbytes, lat) == want.observe_hop(nbytes, lat)
        got.on_token()
        want.on_token()
        assert meter_state(got) == meter_state(want)
    assert got.hops == (n_devices - 1) * len(stages) + 3 * (n_devices - 1)
    if variants:
        assert got._plan_variant() is not None
        assert meter_state(got)["hop_bytes"][0] == got._plan_variant().compressed_bytes(5488)


def test_meter_prices_remaining_hops_across_a_replan():
    """An adoption on the first hop of a token reprices the token's
    remaining hop on the new plan; every token prices two hops."""
    plan3 = types.SimpleNamespace(segments=[types.SimpleNamespace(tx_bytes=512)] * 3)

    class AdoptOnThirdObserve:
        def __init__(self):
            self.history, self.n, self.current = [], 0, None

        def observe(self, protocol, nbytes, latency_s, retries=0):
            self.n += 1
            if self.n == 3:
                self.history.append("adopted")

        def current_plan(self):
            return plan3

    link = convert.link_from_reference(ESP_NOW)
    meter = SplitLatencyMeter(plan=plan3, link=link, bytes_per_token=5488,
                              manager=AdoptOnThirdObserve(), protocol="esp_now")
    for _ in range(5):
        meter.on_token()
    assert meter.replans == 1 and meter.hops == 10
    assert meter.hop_seconds == pytest.approx(link.transmission_latency_s(5488) * 10)
    assert meter._plan_variant() is None  # a stub without a bank
    assert not SplitLatencyMeter(plan=plan3, link=link).observe_hop(100, 1.0)


def test_plan_conversion_keeps_every_field():
    plan = plan_pipeline(arch_layer_graph(REF_CFG, batch=2, seq=32), 2, link=ICI)
    assert convert.plan_from_reference(plan).to_dict() == plan.to_dict()
    port_plan = port_tpu_plan(2)
    assert {**port_plan.to_dict(), "planner_time_s": plan.planner_time_s} == plan.to_dict()
