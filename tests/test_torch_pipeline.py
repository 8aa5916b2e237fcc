"""The port's pipeline planner against the reference's, and under its own
H100 defaults.

``stage_cost_profile`` and ``plan_pipeline`` take the stage hardware and
the link as parameters. Given a :class:`StageHardware` built here from
the reference's TPU constants and the reference's links (through
``convert.link_from_reference``), they must equal the reference's
``tpu_cost_profile`` and ``plan_pipeline`` with ``==``: every layer
cost, every plan field but the planner's wall time, at 2, 4 and 8
stages, 1 and 4 chips a stage, ICI and DCN, beam and ``optimal_dp``,
both objectives. The TPU numbers are parity data only: the port holds
none of them.

Under the port's defaults (H100 SXM stages joined by NVLink, or
InfiniBand), both solvers agree on feasibility, the beam never beats
the exact DP, and the beam's bottleneck is within 2% of the exact DP's
(the bound of ``tests/test_planner.py``), except on the instances
listed in :data:`BEAM_MISSES`: qwen2-vl-72b's memory cliff at 4 and 8
stages, where a beam of 16 keeps only prefixes with short first stages
and its last stage must take what is left. A beam of 64 reaches the
bound there."""

import dataclasses
import math
import re
from pathlib import Path

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.core import planner as RPL
from repro.core import profiles as RP
from repro.models.graph import arch_layer_graph as ref_arch_layer_graph
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import planner as PPL
from repro_torch.core import profiles as PP
from repro_torch.models.graph import arch_layer_graph
from torch_parity import plan_fields, tpu_stage_hardware

ROOT = Path(__file__).resolve().parent.parent
TPU = tpu_stage_hardware()
REF_LINKS = {"ici": RP.ICI, "dcn": RP.DCN}


def graphs(arch, batch=8, seq=1024):
    return (ref_arch_layer_graph(ref_get_config(arch), batch, seq),
            arch_layer_graph(get_config(arch), batch, seq))


def profile_fields(prof) -> tuple:
    return prof.name, prof.input_bytes, [dataclasses.asdict(lc) for lc in prof.layers]


def test_stage_hardware_equals_the_reference_constants():
    for n in (1, 4, 8):
        got = TPU.stage_device(n)
        want = RP.tpu_stage_device(n)
        assert convert.device_from_reference(want) == got and got.name == f"tpu_v5e_x{n}"
        assert TPU.stage_device(n, mem_fraction=0.5) == \
            convert.device_from_reference(RP.tpu_stage_device(n, mem_fraction=0.5))
    for flops, nbytes in ((0.0, 0.0), (3.7e12, 1.2e9), (1e9, 5e10), (2.5e15, 7.0)):
        for n in (1, 3, 4):
            assert TPU.layer_time_s(flops, nbytes, n) == RP.tpu_layer_time_s(flops, nbytes, n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stage_cost_profile_equals_tpu_cost_profile(arch):
    ref_g, g = graphs(arch)
    for kw in (dict(), dict(chips_per_stage=4), dict(act_dtype_bytes=4, param_dtype_bytes=1)):
        assert profile_fields(PPL.stage_cost_profile(g, hardware=TPU, **kw)) == \
            profile_fields(RPL.tpu_cost_profile(ref_g, **kw))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_pipeline_equals_the_reference(arch):
    ref_g, g = graphs(arch)
    for n_stages in (2, 4, 8):
        for chips in (1, 4):
            for name, link in REF_LINKS.items():
                for solver in ("beam", "optimal_dp"):
                    # the objective does not meet the chip count: "sum" at 1 chip
                    for objective in ("bottleneck", "sum") if chips == 1 else ("bottleneck",):
                        kw = dict(chips_per_stage=chips, solver=solver, objective=objective)
                        want = RPL.plan_pipeline(ref_g, n_stages, link=link, **kw)
                        got = PPL.plan_pipeline(g, n_stages, hardware=TPU,
                                                link=convert.link_from_reference(link), **kw)
                        assert plan_fields(got) == plan_fields(want), \
                            (n_stages, chips, name, solver, objective)


def test_plan_pipeline_keeps_the_beam_width_and_solver_kwargs():
    ref_g, g = graphs("deepseek-7b", batch=4, seq=512)
    for kw in (dict(beam_width=2), dict(solver="greedy"), dict(act_dtype_bytes=4)):
        want = RPL.plan_pipeline(ref_g, 4, link=RP.ICI, **kw)
        got = PPL.plan_pipeline(g, 4, hardware=TPU, link=convert.link_from_reference(RP.ICI),
                                **kw)
        assert plan_fields(got) == plan_fields(want)


# (config, stages) where a beam of 16 is more than 2% above the exact DP
# under the H100 defaults, on both links (batch 8 x 1,024 tokens)
BEAM_MISSES = {("qwen2-vl-72b", 4), ("qwen2-vl-72b", 8)}
# where the weights do not fit the stages' memory (80 GB, 90% usable)
INFEASIBLE = {("qwen3-moe-235b-a22b", 2), ("qwen3-moe-235b-a22b", 4), ("qwen2-vl-72b", 2)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_h100_plans_beam_within_two_percent_of_the_dp(arch):
    g = arch_layer_graph(get_config(arch), batch=8, seq=1024)
    for n_stages in (2, 4, 8):
        for link in (PP.NVLINK, PP.INFINIBAND):
            beam = PPL.plan_pipeline(g, n_stages, link=link)
            opt = PPL.plan_pipeline(g, n_stages, link=link, solver="optimal_dp")
            where = (arch, n_stages, link.name)
            if (arch, n_stages) in INFEASIBLE:
                assert beam.objective_cost_s == opt.objective_cost_s == math.inf, where
                assert beam.total_latency_s == opt.total_latency_s == math.inf, where
                # the reference calls the same instances infeasible on its stages
                ref = RPL.plan_pipeline(ref_arch_layer_graph(ref_get_config(arch), 8, 1024),
                                        n_stages, link=RP.ICI)
                assert ref.objective_cost_s == math.inf
                continue
            assert math.isfinite(opt.objective_cost_s), where
            assert opt.objective_cost_s <= beam.objective_cost_s, where
            assert sum(s.param_bytes for s in beam.segments) == sum(
                n.param_count * 2 for n in g.nodes)
            if (arch, n_stages) in BEAM_MISSES:
                assert beam.objective_cost_s > opt.objective_cost_s * 1.02, where
                wide = PPL.plan_pipeline(g, n_stages, link=link, beam_width=64)
                assert wide.objective_cost_s <= opt.objective_cost_s * 1.02, where
            else:
                assert beam.objective_cost_s <= opt.objective_cost_s * 1.02, where


def test_h100_defaults():
    g = arch_layer_graph(get_config("granite-34b"), batch=8, seq=1024)
    plan = PPL.plan_pipeline(g, 2)
    assert plan_fields(plan) == plan_fields(PPL.plan_pipeline(
        g, 2, chips_per_stage=1, link=PP.NVLINK, hardware=PP.H100_SXM, beam_width=16))
    assert plan.splits == (45,) and plan.segments[0].layer_names[0] == "embed"
    assert PP.H100_SXM.stage_device(2).name == "h100_sxm_x2"
    assert PP.H100_LINKS == {"nvlink": PP.NVLINK, "infiniband": PP.INFINIBAND}
    # NVLink moves a stage's activations ~9x faster than one NDR port
    prof = PPL.stage_cost_profile(g)
    nbytes = prof.layers[1].act_bytes
    assert PP.NVLINK.transmission_latency_s(nbytes) < \
        PP.INFINIBAND.transmission_latency_s(nbytes) / 8


def test_port_holds_no_tpu_number():
    """The TPU constants live in the reference only: no file of the port,
    its example twins or ``chip_smoke.py`` spells one of them."""
    tpu = {RP.TPU_PEAK_FLOPS, RP.TPU_HBM_BW, RP.TPU_DCN_BW, RP.TPU_ICI_BW}
    number = re.compile(r"(?<![\w.])\d[\d_]*(?:\.\d+)?(?:e\d+)?(?![\w.])")
    paths = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    for path in paths:
        text = path.read_text()
        found = {float(m.group().replace("_", "")) for m in number.finditer(text)}
        assert not found & tpu, (path, found & tpu)
        assert "tpu_v5e" not in text.lower(), path
