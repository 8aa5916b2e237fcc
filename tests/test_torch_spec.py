"""The planner tier (``repro_torch.core.spec``) against the reference's.

* The contract of ``tests/test_spec.py``, on the port: the JSON round
  trip is field-exact (NaN, ±inf and subnormal floats survive; bare JSON
  constants and unknown tags are refused), a spec pickles, and each of
  the five kwargs entries is the spec path, bit for bit.
* Across the packages: the same builder call writes the same JSON in
  both (with ``backend`` passed, as the port's default is ``None`` and
  the reference's ``"numpy"``); a JSON the reference wrote solves in the
  port equal to the reference's own solve; the reference's backends the
  port lacks are refused by name, and a mesh on a backend other than
  ``"sharded"`` with the reference's message.
* Two faults the shims fixed: ``np.float32`` surface axes price the
  nodes as the reference does, and ``plan_split_batch(models, None)``
  raises the reference's ``ValueError``.
* ``repro_torch.core`` re-exports what ``repro.core`` does, less the
  names of modules still to port, and keeps its submodules."""

import math
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core import planner as RPL
from repro.core import profiles as RP
from repro.core import spec as RSP
from repro.core import surface as RSF
from repro_torch import convert
from repro_torch.core import cuda_dp as CD
from repro_torch.core import planner as PPL
from repro_torch.core import profiles as PP
from repro_torch.core import spec as PSP
from repro_torch.core import surface as PSF
from repro_torch.core import sweep as PS
from repro_torch.core.latency import COST_CHANNELS
from torch_parity import batched_fields, family_fields, plan_fields

INF = float("inf")
GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}
CPU = dict(device="cpu")


def rand_tensor(rng, S=5, N=3, L=6, inf_frac=0.1):
    """A stacked cost tensor with +inf outside 1 <= a <= b <= L and some
    infeasible entries inside."""
    C = rng.uniform(0.1, 9.0, size=(S, N, L, L))
    C[rng.uniform(size=C.shape) < inf_frac] = INF
    a = np.arange(1, L + 1)
    C[:, :, a[:, None] > a[None, :]] = INF
    return C


def rich_spec(S):
    """A spec exercising every field family: nested cost model, protocol
    pairs, variant bank, a non-finite budget, awkward floats, a mesh.
    ``S`` is either spec module."""
    prof = RP if S is RSP else PP
    return S.surfaces_spec(
        prof.paper_cost_model("mobilenet_v2", "esp_now"), prof.PROTOCOLS, (2, 3, 5),
        pt_scale=(1.0, 0.1 + 0.2, 16.0), loss_p=(None, 0.0, 0.1), beam_width=6,
        chunk_candidates=(256, 1024), energy_budget=INF,
        variants=prof.esp32_variant_bank(), accuracy_floor=0.9, backend="numpy",
        mesh=S.MeshSpec(kind="local", n_shards=2))


# --------------------------------------------------------------------------
# The JSON round trip
# --------------------------------------------------------------------------


def test_rich_spec_round_trips_field_exact():
    spec = rich_spec(PSP)
    again = PSP.PlanSpec.from_json(spec.to_json())
    assert again == spec
    assert "Infinity" not in spec.to_json() and "NaN" not in spec.to_json()
    assert again.surface.loss_p == (None, 0.0, 0.1)
    assert isinstance(again.protocols, tuple) and isinstance(again.protocols[0], tuple)
    assert again.variants == PP.esp32_variant_bank()
    assert pickle.loads(pickle.dumps(spec)) == spec


@pytest.mark.parametrize("value", [0.1 + 0.2, 1e-308, 5e-324, INF, -INF, 1.0 / 3.0])
def test_awkward_floats_survive_bitwise(value):
    spec = PSP.PlanSpec(energy_budget=(value, -value), accuracy_floor=value)
    again = PSP.PlanSpec.from_json(spec.to_json())
    assert again.energy_budget == spec.energy_budget
    assert all(type(v) is float for v in again.energy_budget)
    assert again.accuracy_floor == value


def test_nan_round_trips_as_nan():
    again = PSP.PlanSpec.from_json(PSP.PlanSpec(accuracy_floor=float("nan")).to_json())
    assert math.isnan(again.accuracy_floor)


@pytest.mark.parametrize("payload,match", [
    ('{"__type__": "PlanSpec", "accuracy_floor": Infinity}', "non-strict JSON constant"),
    ('{"__type__": "PlanSpec", "accuracy_floor": NaN}', "non-strict JSON constant"),
    ('{"__type__": "os_system"}', "unknown PlanSpec type tag"),
    ('{"__type__": "MeshSpec"}', "not PlanSpec"),
])
def test_bad_payloads_are_refused(payload, match):
    with pytest.raises(ValueError, match=match):
        PSP.PlanSpec.from_json(payload)


def test_scenario_mesh_and_option_rules():
    with pytest.raises(ValueError, match="unknown scenario kind"):
        PSP.ScenarioRef(kind="wat")
    with pytest.raises(ValueError, match="unknown mesh kind"):
        PSP.MeshSpec(kind="wat")
    a = PSP.tensor_spec(np.zeros((1, 2, 3, 3)), beam_width=4, return_all_k=False)
    b = PSP.tensor_spec(np.zeros((1, 2, 3, 3)), return_all_k=False, beam_width=4)
    assert a == b and a.options() == {"beam_width": 4, "return_all_k": False}
    assert a.backend is None  # the port's default: resolved per solver


# --------------------------------------------------------------------------
# Spec path == kwargs path, within the port
# --------------------------------------------------------------------------

DP_KW = [dict(backend="numpy"), dict(backend="torch", dtype=torch.float64, **CPU),
         dict(backend="torch", **CPU), dict(backend="cuda", **CPU)]
DP_IDS = ["numpy", "torch-f64", "torch-f32", "cuda-f32"]


def service(kw):
    return PSP.PlannerService(kw.get("device"), kw.get("dtype", torch.float32))


def spec_kw(kw):
    return {k: v for k, v in kw.items() if k == "backend"}


@pytest.mark.parametrize("kw", DP_KW, ids=DP_IDS)
@pytest.mark.parametrize("combine", ["sum", "max"])
def test_solve_batched_is_the_spec_path(kw, combine):
    C = rand_tensor(np.random.default_rng(7))
    n = (2, 3, 2, 3, 2)
    via_kwargs = PS.solve_batched(C, combine=combine, n_devices=n, **kw)
    spec = PSP.tensor_spec(C, combine=combine, n_devices=n, **spec_kw(kw))
    via_spec = service(kw).solve(spec, C)
    again = service(kw).solve(PSP.PlanSpec.from_json(spec.to_json()), C)
    impl = PS._solve_batched_impl(C, combine=combine, n_devices=spec.n_devices, **kw)
    assert batched_fields(via_kwargs) == batched_fields(via_spec) \
        == batched_fields(again) == batched_fields(impl)


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
def test_heuristics_are_the_spec_path(solver):
    C = rand_tensor(np.random.default_rng(11))
    kw = {"beam_width": 3} if solver == "batched_beam" else {}
    via_kwargs = PS.solve_batched(C, solver=solver, **kw)
    via_spec = PSP.PlannerService().solve(PSP.tensor_spec(C, solver=solver, **kw), C)
    assert batched_fields(via_kwargs) == batched_fields(via_spec)
    assert via_spec.backend == "numpy"  # None resolves to the host for them


@pytest.mark.parametrize("kw", [DP_KW[0], DP_KW[3]], ids=[DP_IDS[0], DP_IDS[3]])
def test_multi_channel_and_variant_bank_are_the_spec_path(kw):
    rng = np.random.default_rng(17)
    C = np.stack([rand_tensor(rng, S=4, N=3, L=5) for _ in COST_CHANNELS])
    mc = dict(energy_budget=20.0, channel_weights=(1.0, 0.25))
    via_kwargs = PS.solve_multi_channel(C, **mc, **kw)
    via_spec = service(kw).solve_multi_channel(PSP.channels_spec(C, **mc, **spec_kw(kw)), C)
    assert batched_fields(via_kwargs) == batched_fields(via_spec)
    V = np.stack([rand_tensor(rng) for _ in range(3)])
    vb = dict(accuracy_proxy=(1.0, 0.95, 0.85), accuracy_floor=0.9)
    via_kwargs = PS.solve_variant_bank(V, **vb, **kw)
    via_spec = service(kw).solve_variant_bank(PSP.variant_bank_spec(V, **vb, **spec_kw(kw)), V)
    assert batched_fields(via_kwargs) == batched_fields(via_spec)
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0


@pytest.mark.parametrize("kw", [DP_KW[0], DP_KW[3]], ids=[DP_IDS[0], DP_IDS[3]])
def test_plan_split_batch_and_surfaces_are_the_spec_path(kw):
    models = [PP.paper_cost_model("mobilenet_v2", p) for p in ("esp_now", "ble")]
    via_kwargs = PPL.plan_split_batch(models, (2, 3), **kw)
    via_spec = service(kw).plan(PSP.models_spec(models, n_devices=(2, 3), **spec_kw(kw)),
                                models)
    assert [plan_fields(p) for p in via_kwargs] == [plan_fields(p) for p in via_spec]
    model = models[0]
    fam = PSF.build_surfaces(model, PP.PROTOCOLS, (2, 3), solver="batched_dp", **GRID, **kw)
    spec = PSP.surfaces_spec(model, PP.PROTOCOLS, (2, 3), solver="batched_dp", **GRID,
                             **spec_kw(kw))
    assert family_fields(service(kw).build_surfaces(spec)) == family_fields(fam)
    dtype = str(kw.get("dtype", torch.float32)).removeprefix("torch.")
    worker = PSP.build_surfaces_from_spec(spec.to_json(), kw.get("device"), dtype)
    assert family_fields(worker) == family_fields(fam)


def test_operand_validation():
    C = np.zeros((2, 2, 4, 4))
    spec = PSP.tensor_spec(C, backend="numpy")
    with pytest.raises(ValueError, match="shape"):
        PSP.PlannerService().solve(spec, np.zeros((2, 2, 5, 5)))
    with pytest.raises(ValueError, match="kind"):
        PSP.PlannerService().solve_multi_channel(spec, C)
    with pytest.raises(ValueError, match="needs n_devices"):
        PSP.PlannerService().plan(PSP.models_spec([], n_devices=None), [])
    with pytest.raises(ValueError, match="records 2 cost models"):
        models = [PP.paper_cost_model("mobilenet_v2", "ble")]
        PSP.PlannerService().plan(PSP.models_spec(models * 2, n_devices=2), models)
    with pytest.raises(ValueError, match="needs cost_model"):
        PSP.PlannerService().build_surfaces(PSP.PlanSpec(scenario=PSP.ScenarioRef("surface")))


# --------------------------------------------------------------------------
# Across the two packages
# --------------------------------------------------------------------------


def builder_calls(S):
    """The same call of each builder, for ``S`` either spec module."""
    prof = RP if S is RSP else PP
    C = rand_tensor(np.random.default_rng(3))
    models = [prof.paper_cost_model("resnet50", p) for p in ("udp", "ble")]
    return {
        "tensor": S.tensor_spec(C, combine="max", backend="numpy", n_devices=(2, 3, 2, 3, 3),
                                beam_width=5),
        "channels": S.channels_spec(np.stack([C, C]), backend="numpy", energy_budget=(1.5,) * 5,
                                    channel_weights=np.array([1.0, 0.5], np.float32)),
        "variant_bank": S.variant_bank_spec(np.stack([C] * 3), backend="numpy", n_devices=3,
                                            accuracy_proxy=(1.0, 0.9, 0.8),
                                            accuracy_floor=np.float32(0.85)),
        "models": S.models_spec(models, n_devices=np.array([2, 4]), backend="numpy",
                                variants=prof.esp32_variant_bank(), accuracy_floor=0.96),
        "surfaces": rich_spec(S),
    }


@pytest.mark.parametrize("builder", sorted(builder_calls(RSP)))
def test_builders_write_the_references_json(builder):
    assert builder_calls(PSP)[builder].to_json() == builder_calls(RSP)[builder].to_json()


@pytest.mark.parametrize("combine", ["sum", "max"])
def test_a_reference_json_solves_as_in_the_reference(combine):
    C = rand_tensor(np.random.default_rng(31))
    payload = RSP.tensor_spec(C, combine=combine, n_devices=(2, 3, 2, 3, 2)).to_json()
    assert '"backend": "numpy"' in payload  # the reference's default
    want = RSP.solve_from_json(payload, C)
    assert batched_fields(PSP.solve_from_json(payload, C)) == batched_fields(want)
    ref_model = RP.paper_cost_model("mobilenet_v2", "esp_now")
    surf = RSP.surfaces_spec(ref_model, RP.PROTOCOLS, (2, 3), solver="batched_dp", **GRID)
    want = RSP.build_surfaces_from_spec(surf.to_json())
    assert family_fields(PSP.build_surfaces_from_spec(surf.to_json())) == family_fields(want)


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_reference_backends_in_a_spec_are_refused(backend):
    C = rand_tensor(np.random.default_rng(5))
    payload = RSP.tensor_spec(C, backend=backend).to_json()
    with pytest.raises(ValueError, match=f"backend {backend!r} is not ported"):
        PSP.solve_from_json(payload, C, "cpu")
    surf = RSP.surfaces_spec(RP.paper_cost_model("mobilenet_v2", "ble"), RP.PROTOCOLS, (2,),
                             solver="batched_dp", backend=backend, **GRID)
    with pytest.raises(ValueError, match=f"backend {backend!r} is not ported"):
        PSP.build_surfaces_from_spec(surf.to_json(), "cpu")


def test_a_mesh_is_refused():
    """A mesh is a ``backend="sharded"`` knob: a spec or a call that pairs
    one with another backend is refused with the reference's message."""
    C = rand_tensor(np.random.default_rng(5))
    payload = RSP.tensor_spec(C, mesh=RSP.MeshSpec(kind="local")).to_json()
    with pytest.raises(ValueError, match="mesh_spec is a backend='sharded' knob; "
                                         "got backend='numpy'"):
        PSP.solve_from_json(payload, C)
    with pytest.raises(ValueError, match="mesh_spec is a backend='sharded' knob; "
                                         "batched_beam runs on numpy only"):
        PSF.build_surfaces(PP.paper_cost_model("mobilenet_v2", "ble"), PP.PROTOCOLS, (2,),
                           backend="numpy", mesh_spec=PSP.MeshSpec(), **GRID)


# --------------------------------------------------------------------------
# The two faults the shims fixed
# --------------------------------------------------------------------------

F32_PT = np.array([0.5, 1.0, 1.7, 3.3], np.float32)
F32_LOSS = np.array([0.0, 0.013, 0.1], np.float32)


@pytest.mark.parametrize("form", ["array", "list of scalars"])
def test_float32_surface_axes_price_as_the_reference(form):
    """``pt_scale`` and ``loss_p`` given as ``np.float32`` (an array, or a
    list of its scalars): the surfaces equal the reference's with ``==``,
    as the spec builder turns the axes into Python floats."""
    pt, loss = (F32_PT, F32_LOSS) if form == "array" else (list(F32_PT), list(F32_LOSS))
    ref_model = RP.paper_cost_model("mobilenet_v2", "esp_now")
    links = {p: RP.PROTOCOLS[p] for p in ("esp_now", "ble")}
    kw = dict(pt_scale=pt, loss_p=loss, solver="batched_greedy", backend="numpy")
    want = RSF.build_surfaces(ref_model, links, (2, 3), **kw)
    port_model = convert.cost_model_from_reference(ref_model)
    port_links = {p: convert.link_from_reference(lk) for p, lk in links.items()}
    got = PSF.build_surfaces(port_model, port_links, (2, 3), **kw)
    assert family_fields(got) == family_fields(want)
    one = PSF.build_surface(port_model, port_links, 3, **kw)
    assert family_fields({3: one}) == family_fields({3: want[3]})


def test_plan_split_batch_without_fleet_sizes_raises_the_references_error():
    models = [PP.paper_cost_model("mobilenet_v2", "esp_now")] * 2
    with pytest.raises(ValueError, match="a 'models' spec needs n_devices"):
        PPL.plan_split_batch(models, None, backend="numpy")
    with pytest.raises(ValueError, match="a 'models' spec needs n_devices"):
        RPL.plan_split_batch([RP.paper_cost_model("mobilenet_v2", "esp_now")] * 2, None)


# --------------------------------------------------------------------------
# The package's re-exports
# --------------------------------------------------------------------------

# names ``repro.core`` exports that the port lacks, by what they wait on
NOT_YET = {
    # the TPU pipeline planner's cost profile; counterpart: stage_cost_profile
    "tpu_cost_profile": "planner",
    # the Pallas backend: the port's kernels are core.cuda_dp, exported
    # under their own names (cuda_optimal_dp, cuda_fused_optimal_dp, ...)
    "pallas_dp_tables": "pallas_dp", "pallas_fused_dp_tables": "pallas_dp",
    "pallas_fused_optimal_dp": "pallas_dp", "pallas_interpret_default": "pallas_dp",
    "pallas_optimal_dp": "pallas_dp",
}


def public_names(pkg):
    return {n for n in dir(pkg) if not n.startswith("_")
            and not isinstance(getattr(pkg, n), type(pkg))}


def test_core_re_exports_the_references_names():
    import repro_torch.core as PC

    missing = public_names(RC) - public_names(PC)
    assert missing == set(NOT_YET)
    text = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    assert all(name in text for name in missing), "a missing name is not queued"
    for name in public_names(RC) & public_names(PC):
        assert type(getattr(PC, name)).__name__ == type(getattr(RC, name)).__name__, name


# names ``repro.parallel.hlo_analysis`` exports, by what answers them in
# ``repro_torch.parallel.op_analysis`` (ROADMAP's paragraph names each)
HLO_ANSWERS = {
    "COLLECTIVES": "COLLECTIVES",
    "shape_bytes": "tensor_bytes",
    "weighted_collective_bytes": "weighted_collective_bytes",
    # an eager step issues every trip of its loops: no computations to split
    # and weight, every op counted where it runs
    "split_computations": "count_step",
    "trip_count": "count_step",
    "computation_multipliers": "count_step",
}


def test_op_analysis_answers_the_hlo_analysis_names():
    import repro.parallel.hlo_analysis as RH
    import repro_torch.parallel.op_analysis as OA

    exported = {n for n, v in vars(RH).items() if not n.startswith("_")
                and (getattr(v, "__module__", None) == RH.__name__ or n.isupper())}
    assert exported == set(HLO_ANSWERS)
    assert all(hasattr(OA, answer) for answer in HLO_ANSWERS.values())
    text = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    paragraph = text[text.index("**Names `repro.core` exports"):]
    paragraph = paragraph[:paragraph.index("\n\n")]
    assert all(f"`{name}`" in paragraph for name in HLO_ANSWERS), "a name is not answered"
    assert all(f"`{answer}`" in paragraph for answer in HLO_ANSWERS.values())


def test_core_keeps_its_submodules():
    import repro_torch.core as PC

    for name in ("sweep", "surface", "async_replan", "adaptive", "spec", "planner"):
        assert type(getattr(PC, name)).__name__ == "module", name
    from repro_torch.core.sweep import sweep

    assert callable(sweep) and PC.sweep is not sweep
