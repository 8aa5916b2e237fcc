"""What the port may import, where it runs, and what it refuses.

* ``repro_torch``, ``chip_smoke.py`` and the example twins
  (``examples/torch_*.py``) import neither ``jax`` nor any module of the
  reference package ``repro``.
* Entry points default to the card and raise without one; the CPU runs
  only when named, and then no kernel launches.
* Wrappers check their tensors; unported solvers and backends raise."""

import ast
import importlib.util
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import profiles as RP
from repro.core import sweep as RS
from repro_torch import convert
from repro_torch.core import adaptive as PA
from repro_torch.core import async_replan as PAR
from repro_torch.core import cuda_dp as CD
from repro_torch.core import planner as PPL
from repro_torch.core import surface as PSF
from repro_torch.core import spec as PSP
from repro_torch.core import sweep as PS
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.mobilenetv2 import MobileNetV2
from repro_torch.models.resnet50 import ResNet50
from repro_torch.runtime import gateway as PG

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "            or m.startswith(('jax.', 'repro.'))], sorted(sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert len(port_modules()) >= 10
    assert "repro_torch.models.audio" in port_modules()
    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.runtime.compression", "repro_torch.runtime.train_loop",
            "repro_torch.checkpoint.store", "repro_torch.data.pipeline",
            "repro_torch.launch.steps", "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.parallel.sharding", "repro_torch.parallel.op_analysis",
            "repro_torch.parallel.tensor_parallel", "repro_torch.configs.shapes"
            } <= set(port_modules())


def test_audio_helpers_follow_their_tensors_device(monkeypatch):
    """``models/audio.py`` takes its tensors' device (the CPU here) and
    needs no card: with CUDA reported missing it still runs on the CPU."""
    from repro_torch.models import audio

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = torch.arange(6, dtype=torch.int32).reshape(1, 3, 2)
    delayed = audio.delay_pattern(codes, -1)
    assert delayed.device.type == "cpu" and delayed[0, :, 1].tolist() == [-1, 1, 3, 5]
    assert torch.equal(audio.undelay_pattern(delayed, 3), codes)
    assert audio.delay_mask(3, 2).device.type == "cpu"


def imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def small_grid():
    return convert.grid_from_reference(RS.ScenarioGrid(
        models={"mobilenet_v2": RP.mobilenet_cost_profile()},
        links={"udp": RP.UDP}, n_devices=(2, 3), devices=(RP.ESP32,)))


def small_model():
    return convert.cost_model_from_reference(RP.paper_cost_model("mobilenet_v2", "udp"))


def default_entry_calls():
    """Every entry point whose exact DP runs on the card by default, called
    with ``backend=None`` (or no backend at all)."""
    C = np.ones((2, 2, 4, 4))
    links = {"udp": small_model().link}
    return {
        "sweep": lambda: PS.sweep(small_grid()),
        "batched_optimal_dp": lambda: PS.batched_optimal_dp(C),
        "cuda_optimal_dp": lambda: CD.cuda_optimal_dp(C),
        "cuda_fused_optimal_dp": lambda: CD.cuda_fused_optimal_dp(C[0], None, C[:, 0, 0]),
        "solve_batched": lambda: PS.solve_batched(C, backend=None),
        "solve_multi_channel": lambda: PS.solve_multi_channel(
            np.stack([C, C]), energy_budget=2.0),
        "solve_variant_bank": lambda: PS.solve_variant_bank(np.stack([C, C])),
        "plan_split_batch": lambda: PPL.plan_split_batch([small_model()] * 2, 3),
        "plan_split": lambda: PPL.plan_split(small_model(), 3, solver="batched_dp"),
        "build_surfaces": lambda: PSF.build_surfaces(small_model(), links, (2, 3),
                                                     solver="batched_dp"),
        "budgeted build_surfaces": lambda: PSF.build_surfaces(
            small_model(), links, (2,), solver="batched_dp", energy_budget=1.0),
        "degradation_surfaces": lambda: small_grid().degradation_surfaces(
            solver="batched_dp"),
        "PlannerService.solve": lambda: PSP.PlannerService().solve(PSP.tensor_spec(C), C),
        "solve_from_json": lambda: PSP.solve_from_json(PSP.tensor_spec(C).to_json(), C),
        "build_surfaces_from_spec": lambda: PSP.build_surfaces_from_spec(
            PSP.surfaces_spec(small_model(), links, (2,), solver="batched_dp",
                              **GRID).to_json()),
        "AdaptiveSplitManager": lambda: PA.AdaptiveSplitManager(
            cost_model=small_model(), protocols=links, n_devices=2, solver="optimal_dp",
            surface_grid=GRID),
        "fleet_managers": lambda: PA.fleet_managers(small_model(), links, (2, 3),
                                                    solver="optimal_dp", surface_grid=GRID),
        "SurfaceRebuilder.build_sync": lambda: rebuild_sync(small_model(), links),
        "FleetGateway": lambda: PG.FleetGateway(small_model(), links, (2,),
                                                solver="optimal_dp", surface_grid=GRID),
    }


GRID = {"pt_scale": (1.0, 4.0), "loss_p": (0.0,)}


def rebuild_sync(model, links):
    ex = PAR.ManualExecutor()
    rb = PAR.SurfaceRebuilder(model, links, solver="batched_dp", executor=ex, **GRID)
    rb.request(2, {"udp": (links["udp"].packet_time_s() * 30, 0.0)})
    rb.poll(2)
    return rb.build_sync(rb.inflight())


def example_main(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


CNN_ENTRIES = {
    "MobileNetV2.init": lambda: MobileNetV2(width=0.35, image_size=32).init(),
    "ResNet50.init": lambda: ResNet50(image_size=32).init(),
    "torch_quickstart.main": lambda: example_main("torch_quickstart")(),
    "torch_split_mobilenet_inference.main":
        lambda: example_main("torch_split_mobilenet_inference")(),
    **{f"{name}.main": (lambda name=name: example_main(name)())
       for name in ("torch_fleet_sweep", "torch_adaptive_replanning",
                    "torch_pareto_frontier", "torch_serve_split_llm",
                    "torch_train_pipeline_lm")},
    "Trainer": lambda: train_entry("trainer"),
    "make_train_step": lambda: train_entry("step"),
}


def train_entry(which):
    """The training entries as a user calls them, naming no device: a
    ``Trainer``, or ``make_train_step`` on ``init_params``' model."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import Trainer

    cfg = get_config("deepseek-7b").reduced()
    data = SyntheticLMData(cfg, 2, 8)
    if which == "trainer":
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            return Trainer(cfg, data, CheckpointStore(tmp)).run()
    params = T.init_params(cfg)
    return make_train_step(cfg)(params, adamw_init(params), data.batch_at(0))


@pytest.mark.parametrize("entry", sorted(CNN_ENTRIES))
def test_cnn_entries_default_to_the_card(monkeypatch, capsys, entry):
    """The CNNs' ``init``, the example twins' ``main`` and the training
    entries name no device by default: that is the card, and without one
    they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CNN_ENTRIES[entry]()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("entry", sorted(default_entry_calls()))
def test_default_device_is_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        default_entry_calls()[entry]()


def test_device_and_dtype_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_dtype(torch.float64) is torch.float64
    with pytest.raises(ValueError):
        resolve_dtype(torch.float16)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_runs_launch_no_kernel():
    CD.reset_launch_counts()
    grid = small_grid()
    PS.sweep(grid, device="cpu")
    PS.batched_optimal_dp(np.ones((3, 2, 5, 5)), device="cpu")
    assert (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES) == (0, 0)


def _bad_dense_calls():
    C = torch.ones((3, 2, 6, 6))
    ns = torch.full((3,), 2, dtype=torch.int32)
    return {
        "f16": lambda: CD.dense_dp(C.half(), ns),
        "ns-int64": lambda: CD.dense_dp(C, ns.long()),
        "not-square": lambda: CD.dense_dp(C[..., :5], ns),
        "strided": lambda: CD.dense_dp(C.transpose(2, 3), ns),
        "L-too-long": lambda: CD.dense_dp(
            torch.empty((1, 2, CD.MAX_L + 1, CD.MAX_L + 1)), ns[:1]),
        "combine": lambda: CD.dense_dp(C, ns, "mean"),
        "N1": lambda: CD.dense_dp(C[:, :1], ns),
        "fused-tx-dtype": lambda: CD.fused_dp(C[0], C[:, 0, 0].double(), ns),
        "fused-idx-shape": lambda: CD.fused_dp(C[0], C[:, 0, 0], ns,
                                               bank_idx=torch.zeros((2, 2), dtype=torch.int32)),
    }


@pytest.mark.parametrize("case", sorted(_bad_dense_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_dense_calls()[case]()


@pytest.mark.parametrize("kwargs", [dict(solver="batched_beam", backend="cuda"),
                                    dict(solver="batched_greedy", backend="cuda"),
                                    dict(backend="pallas")],
                         ids=lambda kw: next(iter(kw.values())))
def test_unported_solvers_and_backends_raise_by_name(kwargs):
    """The reference's backends the port lacks, and the host heuristics
    on a card backend, are refused by name."""
    name = next(iter(kwargs.values()))
    with pytest.raises(ValueError, match=name):
        PS.sweep(small_grid(), device="cpu", **kwargs)


def test_unported_surfaces_raise():
    """Surfaces are ported; the reference's backends the port lacks are
    refused by name."""
    for backend in ("pallas", "jax"):
        with pytest.raises(ValueError, match=backend):
            small_grid().degradation_surface(solver="batched_dp", backend=backend)


def refusing_calls(solver, backend):
    C = np.ones((3, 2, 4, 4))
    links = {"udp": small_model().link}
    kw = dict(solver=solver, backend=backend, device="cpu")
    return {
        "sweep": lambda: PS.sweep(small_grid(), **kw),
        "solve_batched": lambda: PS.solve_batched(C, **kw),
        "solve_multi_channel": lambda: PS.solve_multi_channel(
            np.stack([C, C]), energy_budget=2.0, **kw),
        "solve_variant_bank": lambda: PS.solve_variant_bank(np.stack([C, C]), **kw),
        "plan_split_batch": lambda: PPL.plan_split_batch([small_model()] * 3, 3, **kw),
        "build_surfaces": lambda: PSF.build_surfaces(small_model(), links, (2,), **kw),
    }


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
@pytest.mark.parametrize("entry", sorted(refusing_calls("batched_beam", "cuda")))
def test_host_heuristics_refuse_card_backends(entry, solver):
    """Beam and greedy are numpy algorithms on the host: a card backend is
    refused, never silently replaced."""
    for backend in ("cuda", "torch"):
        with pytest.raises(ValueError, match=f"{solver} supports backend='numpy' only"):
            refusing_calls(solver, backend)[entry]()


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("entry", sorted(refusing_calls("batched_dp", "jax")))
def test_reference_backends_refused_by_name(entry, backend):
    with pytest.raises(ValueError, match=f"backend {backend!r} is not ported"):
        refusing_calls("batched_dp", backend)[entry]()


def test_mesh_spec_is_refused():
    with pytest.raises(ValueError, match="sharded"):
        PS.solve_batched(np.ones((2, 2, 4, 4)), backend="numpy", mesh_spec=object())


@pytest.mark.parametrize("layout", ["checkout", "installed", "override"])
def test_kernel_build_directory(tmp_path, monkeypatch, layout):
    """Kernels build under the checkout's ``build/``; an installed package
    builds into the per-user cache; the environment variable wins."""
    from repro_torch.kernels import build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if layout == "checkout":
        assert build.build_dir() == ROOT / "build" / "repro_torch"
    elif layout == "installed":
        csrc = tmp_path / "lib" / "python3.12" / "site-packages" / "repro_torch" / "csrc"
        assert build.build_dir(csrc) == tmp_path / "cache" / "repro_torch"
    else:
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
        assert build.build_dir() == tmp_path / "kernels"


def test_kernel_build_key_covers_the_headers(tmp_path):
    """A library is rebuilt when a header beside its source changes, not
    only when the source does: the build key hashes both."""
    from repro_torch.kernels import build

    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    first = build.source_digest(src)
    assert build.source_digest(src) == first
    header.write_text("// two\n")
    second = build.source_digest(src)
    assert second != first
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert build.source_digest(src) not in (first, second)
