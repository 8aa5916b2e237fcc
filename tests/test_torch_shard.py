"""The sharded backend (``repro_torch.core.shard``) on simulated CPU shards.

* Within the port: ``backend="sharded"`` over 1-5 shards is node-identical
  to ``backend="torch"`` (both the plain dense DP on the CPU) for scenario
  counts that do and do not divide the shard count, both combines,
  frozen rows and all-k, through ``batched_optimal_dp``, ``sweep``,
  ``plan_split_batch``, ``build_surfaces``, the variant-bank fold and the
  spec tier (a JSON the reference wrote, mesh included).
* Against the reference: in float32 equal to ``repro.core.shard.
  sharded_optimal_dp`` and ``batched_optimal_dp(backend="jax")`` on one
  XLA:CPU device; in float64 equal to the numpy oracle.
* The plumbing: ``_pad_to_multiple``, ``scenario_shards``, the mesh rules
  and their messages are the reference's; the entry points default to the
  card and raise without one.

The ranks of a ``torch.distributed`` group are in
``tests/test_torch_distributed.py``."""

import numpy as np
import pytest
import torch

from repro.core import profiles as RP
from repro.core import shard as RSH
from repro.core import spec as RSP
from repro.core import sweep as RS
from repro_torch import convert
from repro_torch.core import planner as PPL
from repro_torch.core import profiles as PP
from repro_torch.core import shard as SH
from repro_torch.core import spec as PSP
from repro_torch.core import surface as PSF
from repro_torch.core import sweep as PS
from repro_torch.core.latency import bottleneck_variants
from repro_torch.core.spec import MeshSpec
from torch_parity import batched_fields, family_fields, one_torch_thread, plan_fields, row_fields  # noqa: F401

INF = float("inf")
CPU = dict(device="cpu")
GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}


def make_C(S, N, L, seed, inf_frac=0.15):
    """Tie-rich quarter-integer costs (exact in float32 and float64), some
    +inf, and +inf wherever a > b."""
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 41, size=(S, N, L, L)) / 4.0
    C[rng.random_sample(C.shape) < inf_frac] = INF
    il = np.tril_indices(L, -1)
    C[:, :, il[0], il[1]] = INF
    return C


def make_ns(S, N, seed):
    return np.random.RandomState(seed + 1).randint(1, N + 1, size=S)


def fields(res) -> dict:
    """A result's nodes, backend aside: equal dicts are node-identical."""
    out = batched_fields(res)
    out.pop("backend")
    return out


def all_k_fields(res: dict) -> dict:
    return {n: fields(r) for n, r in res.items()}


# --------------------------------------------------------------------------
# Node identity within the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("S", [1, 7, 64, 65])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_sharded_is_node_identical_to_torch(n_shards, S, combine):
    N, L = 4, 9
    C = make_C(S, N, L, seed=S * 10 + n_shards)
    ns = make_ns(S, N, seed=S)
    for kernel in SH.KERNELS:  # on CPU tensors both are the plain dense DP
        got = SH.sharded_optimal_dp(C, combine, n_shards=n_shards, kernel=kernel, **CPU)
        assert got.backend == "sharded"
        assert fields(got) == fields(PS.batched_optimal_dp(C, combine, "torch", **CPU))
        got = SH.sharded_optimal_dp(C, combine, n_devices=ns, n_shards=n_shards,
                                    kernel=kernel, **CPU)
        assert fields(got) == fields(PS.batched_optimal_dp(
            C, combine, "torch", n_devices=ns, **CPU))
    got = SH.sharded_optimal_dp(C, combine, return_all_k=True, n_shards=n_shards, **CPU)
    assert all_k_fields(got) == all_k_fields(
        PS.batched_optimal_dp(C, combine, "torch", return_all_k=True, **CPU))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_the_backend_string_and_a_local_mesh_route_to_the_shards(n_shards):
    C = make_C(13, 3, 7, seed=2)
    ns = make_ns(13, 3, seed=2)
    want = fields(PS.batched_optimal_dp(C, "sum", "torch", n_devices=ns, **CPU))
    mesh = MeshSpec(kind="local", n_shards=n_shards)
    got = PS.batched_optimal_dp(C, "sum", "sharded", n_devices=ns, mesh_spec=mesh, **CPU)
    assert got.backend == "sharded" and fields(got) == want
    assert fields(PS.batched_optimal_dp(C, "sum", "sharded", n_devices=ns, **CPU)) == want
    assert fields(PS.solve_batched(C, backend="sharded", n_devices=ns, mesh_spec=mesh,
                                   **CPU)) == want


def test_shard_tables_equal_torch_tables_in_float64():
    C = make_C(11, 4, 8, seed=4)
    ns = make_ns(11, 4, seed=4)
    for n in (1, 2, 4):
        got = SH.sharded_dp_tables(C, "max", ns, n_shards=n, device="cpu",
                                   dtype=torch.float64)
        want = PS._dp_numpy(C, "max", ns)
        assert all(np.array_equal(x, y) for x, y in zip(got[0], want[0]))
        assert np.array_equal(got[1], want[1])


def test_kernel_free_cases():
    """N == 1 and S == 0 need no shard solve, as on one device."""
    for C in (make_C(5, 1, 6, seed=1), np.zeros((0, 3, 6, 6))):
        got = SH.sharded_optimal_dp(C, n_shards=3, **CPU)
        assert fields(got) == fields(PS.batched_optimal_dp(C, backend="torch", **CPU))


# --------------------------------------------------------------------------
# Against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("S", [7, 65])
def test_float32_equals_the_references_sharded_and_jax(S, combine):
    N, L = 5, 12
    C = make_C(S, N, L, seed=S + 3)
    ns = make_ns(S, N, seed=S + 3)
    ref_sharded = RSH.sharded_optimal_dp(C, combine, n_devices=ns)
    ref_jax = RS.batched_optimal_dp(C, combine, backend="jax", n_devices=ns)
    want = fields(ref_sharded)
    assert fields(ref_jax) == want
    for n in (1, 3, 4):
        got = SH.sharded_optimal_dp(C, combine, n_devices=ns, n_shards=n, **CPU)
        assert fields(got) == want
    ref_all = RSH.sharded_optimal_dp(C, combine, return_all_k=True)
    got_all = SH.sharded_optimal_dp(C, combine, return_all_k=True, n_shards=2, **CPU)
    assert all_k_fields(got_all) == all_k_fields(ref_all)


@pytest.mark.parametrize("combine", ["sum", "max"])
def test_float64_equals_the_numpy_oracle(combine):
    C = make_C(37, 4, 10, seed=9)
    ns = make_ns(37, 4, seed=9)
    want = fields(RS.batched_optimal_dp(C, combine, backend="numpy", n_devices=ns))
    for n in (1, 2, 5):
        got = SH.sharded_optimal_dp(C, combine, n_devices=ns, n_shards=n, device="cpu",
                                    dtype=torch.float64)
        assert fields(got) == want


# --------------------------------------------------------------------------
# Plumbing: padding, shard counts, meshes, messages
# --------------------------------------------------------------------------


def test_pad_to_multiple_is_the_references():
    for S in range(0, 40):
        for n in range(1, 9):
            assert SH._pad_to_multiple(S, n) == RSH._pad_to_multiple(S, n)


def test_scenario_shards_rules():
    assert SH.scenario_shards(device="cpu") == 1 == RSH.scenario_shards()
    assert SH.scenario_shards(5, device="cpu") == 5
    prefix = "n_shards=0 out of range [1, "
    with pytest.raises(ValueError) as port:
        SH.scenario_shards(0, device="cpu")
    with pytest.raises(ValueError) as ref:
        RSH.scenario_shards(0)
    assert str(port.value).startswith(prefix) and str(ref.value).startswith(prefix)


def test_the_mesh_of_a_spec():
    mesh = SH.mesh_from_spec(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.group is None
    spec = MeshSpec(kind="local", n_shards=3, axis="scen")
    assert SH.mesh_from_spec(spec, device="cpu").devices == (torch.device("cpu"),) * 3
    assert len(SH.mesh_from_spec(spec, n_shards=2, device="cpu").devices) == 2
    with pytest.raises(ValueError, match="unknown shard kernel 'pallas'"):
        SH.sharded_dp_tables(make_C(2, 2, 4, seed=0), kernel="pallas", device="cpu")


def test_a_distributed_mesh_without_a_group_names_it():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        SH.mesh_from_spec(MeshSpec(kind="distributed"), device="cpu")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        SH.mesh_from_spec(MeshSpec(kind="distributed", coordinator="127.0.0.1:1"),
                          device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_a_mesh_on_another_backend_raises_the_references_message(backend):
    C = make_C(3, 2, 4, seed=0)
    ref_backend = {"numpy": "numpy", "torch": "jax", "cuda": "pallas"}[backend]
    with pytest.raises(ValueError) as ref:
        RS.batched_optimal_dp(C, backend=ref_backend, mesh_spec=RSP.MeshSpec())
    with pytest.raises(ValueError) as port:
        PS.batched_optimal_dp(C, backend=backend, mesh_spec=MeshSpec(), **CPU)
    assert str(port.value) == str(ref.value).replace(repr(ref_backend), repr(backend))
    for solver in ("batched_beam", "batched_greedy"):
        with pytest.raises(ValueError) as ref:
            RS.solve_batched(C, solver=solver, mesh_spec=RSP.MeshSpec())
        with pytest.raises(ValueError) as port:
            PS.solve_batched(C, solver=solver, mesh_spec=MeshSpec())
        assert str(port.value) == str(ref.value)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    C = make_C(3, 2, 4, seed=0)
    for call in (lambda: SH.scenario_shards(), lambda: SH.mesh_from_spec(),
                 lambda: SH.sharded_optimal_dp(C),
                 lambda: PS.batched_optimal_dp(C, backend="sharded"),
                 lambda: PS.sweep(small_grid(), backend="sharded")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# --------------------------------------------------------------------------
# The entry points that route to the shards
# --------------------------------------------------------------------------


def small_grid():
    return convert.grid_from_reference(RS.ScenarioGrid(
        models={"mobilenet_v2": RP.mobilenet_cost_profile()},
        links={"udp": RP.UDP, "ble": RP.BLE}, n_devices=(2, 3, 4),
        loss_p=(0.0, 0.05, 0.2), rate_scale=(0.25, 1.0), devices=(RP.ESP32,)))


def test_sweep_on_the_shards_equals_torch():
    grid = small_grid()
    want = [row_fields(r) for r in PS.sweep(grid, backend="torch", **CPU).rows]
    got = PS.sweep(grid, backend="sharded", **CPU)
    assert got.backend == "sharded"
    assert [row_fields(r) for r in got.rows] == want


def test_plan_split_batch_on_the_shards_equals_torch():
    models = [PP.paper_cost_model("mobilenet_v2", p) for p in ("udp", "ble", "esp_now")] * 3
    fleets = [2, 3, 4, 5, 3, 2, 4, 5, 3]
    bank = bottleneck_variants((1.0, 2.0, 4.0))
    for kw in (dict(), dict(energy_budget=1.5), dict(variants=bank),
               dict(variants=bank, accuracy_floor=bank[1].accuracy_proxy)):
        want = [plan_fields(p) for p in PPL.plan_split_batch(models, fleets, backend="torch",
                                                            **kw, **CPU)]
        for mesh in (None, MeshSpec(n_shards=4)):
            got = PPL.plan_split_batch(models, fleets, backend="sharded", mesh_spec=mesh,
                                       **kw, **CPU)
            assert [plan_fields(p) for p in got] == want


def test_variant_bank_and_channels_on_the_shards_equal_torch():
    rng = np.random.RandomState(3)
    C = np.stack([make_C(9, 3, 6, seed=s) for s in (1, 2, 3)])
    ns = rng.randint(1, 4, size=9)
    for solve in (
            lambda b: PS.solve_variant_bank(C, backend=b, n_devices=ns,
                                            accuracy_proxy=[0.9, 0.8, 0.95],
                                            accuracy_floor=0.85, **CPU),
            lambda b: PS.solve_multi_channel(C[:2], channels=("latency", "energy"),
                                             backend=b, energy_budget=6.0, **CPU)):
        got = solve("sharded")
        assert got.backend == "sharded" and fields(got) == fields(solve("torch"))


def test_build_surfaces_on_the_shards_equals_torch():
    model = PP.paper_cost_model("mobilenet_v2", "esp_now")
    links = {p: PP.PROTOCOLS[p] for p in ("esp_now", "ble")}
    kw = dict(solver="batched_dp", **GRID, **CPU)
    want = family_fields(PSF.build_surfaces(model, links, (2, 3, 4), backend="torch", **kw))
    for mesh in (None, MeshSpec(n_shards=3)):
        got = PSF.build_surfaces(model, links, (2, 3, 4), backend="sharded", mesh_spec=mesh,
                                 **kw)
        assert family_fields(got) == want
    budget = dict(energy_budget=1.0, **kw)
    assert family_fields(PSF.build_surfaces(model, links, (2, 3), backend="sharded", **budget)) \
        == family_fields(PSF.build_surfaces(model, links, (2, 3), backend="torch", **budget))


@pytest.mark.parametrize("n_shards", [None, 1, 4])
def test_a_reference_spec_with_a_mesh_solves_on_the_shards(n_shards):
    """A ``backend="sharded"`` JSON the reference wrote, its mesh included,
    solves in the port equal to the port's ``"torch"`` route."""
    C = make_C(10, 3, 7, seed=8)
    ns = make_ns(10, 3, seed=8)
    mesh = None if n_shards is None else RSP.MeshSpec(kind="local", n_shards=n_shards)
    payload = RSP.tensor_spec(C, backend="sharded", n_devices=ns, mesh=mesh).to_json()
    want = fields(PS.batched_optimal_dp(C, backend="torch", n_devices=ns, **CPU))
    assert fields(PSP.solve_from_json(payload, C, "cpu")) == want
    model = RP.paper_cost_model("mobilenet_v2", "ble")
    surf = RSP.surfaces_spec(model, RP.PROTOCOLS, (2, 3), solver="batched_dp",
                             backend="sharded", mesh=mesh, **GRID)
    port_model = convert.cost_model_from_reference(model)
    want = PSF.build_surfaces(port_model, PP.PROTOCOLS, (2, 3), solver="batched_dp",
                              backend="torch", **GRID, **CPU)
    assert family_fields(PSP.build_surfaces_from_spec(surf.to_json(), "cpu")) \
        == family_fields(want)
