"""The microbatch pipeline runtime (``repro_torch.parallel.pipeline``)
against the reference's, in one process on the CPU.

* ``stage_assignment`` and ``pad_stage_params`` equal the reference's
  (one XLA:CPU device).
* ``pipelined_forward`` over ``["cpu"] * 4`` at the reference test's
  sizes (``tests/test_pipeline_parallel.py``: L 8, D 16, M 6, mb 2,
  ``block_apply = x + x @ w``), uniform and ``(3, 5, 7)`` splits: within
  the reference test's 1e-5 of the reference's sequential oracle (its
  ``run_pipeline`` does not run under the installed jax), and bit-equal
  to the port's own sequential run.
* The same at ``reduced()`` deepseek-7b (8 layers) through
  ``transformer_block_apply``: bit-equal to the port's blocks in order,
  and within ``LM_F32_TOL`` of the reference's ``apply_block`` in order
  on the same weights.

Over the ranks of a process group: ``tests/test_torch_distributed.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.planner import uniform_split as ref_uniform_split
from repro.models import transformer as RT
from repro.parallel import pipeline as RPP
from repro_torch.configs import get_config
from repro_torch.core.planner import uniform_split
from repro_torch.models import transformer as PT
from repro_torch.parallel import pipeline as PP
from torch_parity import LM_F32_TOL, lm_port_model, one_torch_thread  # noqa: F401

L, D, M, MB = 8, 16, 6, 2
SPLITS = {"uniform": uniform_split(L, 4), "uneven": (3, 5, 7)}


class Plan:
    def __init__(self, splits):
        self.splits = tuple(splits)


def toy_weights(seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.standard_normal((L, D, D)) * 0.1).astype(np.float32),
            rng.standard_normal((M, MB, D)).astype(np.float32))


def toy_block(lp, x):
    return x + x @ lp["w"]


def sequential(block_apply, stacked: dict, n_layers: int, microbatches):
    """Each microbatch through the layers in order, one call per layer."""
    h = microbatches
    for i in range(n_layers):
        h = block_apply({k: v[i] for k, v in stacked.items()}, h)
    return h


def test_the_references_splits_agree():
    assert SPLITS["uniform"] == ref_uniform_split(L, 4)


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_stage_assignment_and_padding_are_the_references(name):
    plan = Plan(SPLITS[name])
    ranges = PP.stage_assignment(plan, L)
    assert ranges == RPP.stage_assignment(plan, L)
    if name == "uneven":
        assert ranges == [(0, 2), (3, 4), (5, 6), (7, 7)]
    depth = max(b - a + 1 for a, b in ranges)
    w, _ = toy_weights()
    params = {"w": w, "b": w[:, 0] * 2}
    got, mask = PP.pad_stage_params({k: torch.from_numpy(v) for k, v in params.items()},
                                    ranges, depth)
    want, want_mask = RPP.pad_stage_params({k: jnp.asarray(v) for k, v in params.items()},
                                           ranges, depth)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    for k in params:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_the_pipeline_matches_the_sequential_oracles(name):
    w, x = toy_weights()
    plan = Plan(SPLITS[name])
    got = PP.run_pipeline(plan, toy_block, {"w": torch.from_numpy(w)}, L,
                          torch.from_numpy(x), devices=["cpu"] * 4)
    mine = sequential(toy_block, {"w": torch.from_numpy(w)}, L, torch.from_numpy(x))
    assert torch.equal(got, mine)
    ref = sequential(toy_block, {"w": jnp.asarray(w)}, L, jnp.asarray(x))
    assert float(np.max(np.abs(got.numpy() - np.asarray(ref)))) < 1e-5


def test_stages_on_different_devices_and_bad_arguments():
    w, x = toy_weights(1)
    stacked = {"w": torch.from_numpy(w)}
    ranges = PP.stage_assignment(Plan(SPLITS["uneven"]), L)
    stages, mask = PP.pad_stage_params(stacked, ranges, 3)
    got = PP.pipelined_forward(toy_block, stages, mask, torch.from_numpy(x),
                               devices=[torch.device("cpu"), "cpu", "cpu", "cpu"])
    assert torch.equal(got, sequential(toy_block, stacked, L, torch.from_numpy(x)))
    with pytest.raises(ValueError, match="3 devices for 4 stages"):
        PP.pipelined_forward(toy_block, stages, mask, torch.from_numpy(x), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            PP.pipelined_forward(toy_block, stages, mask, torch.from_numpy(x))


# --------------------------------------------------------------------------
# reduced() deepseek-7b through the Transformer's own blocks
# --------------------------------------------------------------------------

N_LAYERS = 8


@pytest.fixture(scope="module")
def deepseek():
    rcfg = ref_get_config("deepseek-7b").reduced(n_layers=N_LAYERS)
    cfg = get_config("deepseek-7b").reduced(n_layers=N_LAYERS)
    assert not cfg.use_flash_kernel and cfg.dtype == "float32"
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    model = lm_port_model(cfg, params)
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 2, 12, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))

    @jax.jit
    def ref_blocks(h):  # the reference's blocks in order on one microbatch
        for i in range(N_LAYERS):
            p = jax.tree.map(lambda t, i=i: t[i], params["blocks"])
            h = RT.apply_block(rcfg, "attn", p, h, jnp.asarray(positions), None,
                               decode=False)[0]
        return h

    want = np.stack([np.asarray(ref_blocks(jnp.asarray(xm))) for xm in x])
    return cfg, model, x, positions, want


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_deepseek_blocks_through_the_pipeline(deepseek, name):
    cfg, model, x, positions, want = deepseek
    pos = torch.from_numpy(positions.copy())
    apply = PP.transformer_block_apply(model, cfg, pos)
    stacked = PP.stack_blocks(model)
    assert set(stacked) == {n for n, _ in model.blocks[0].named_parameters()}
    got = PP.run_pipeline(Plan(SPLITS[name]), apply, stacked, N_LAYERS,
                          torch.from_numpy(x), devices=["cpu"] * 4)
    mine = []
    with torch.no_grad():
        for xm in torch.from_numpy(x):  # microbatch by microbatch, as the pipeline
            for block in model.blocks:
                xm = block(cfg, xm, pos, None, 0, False)
            mine.append(xm)
    assert torch.equal(got, torch.stack(mine))
    np.testing.assert_allclose(got.numpy(), want, **LM_F32_TOL)


def test_stack_blocks_takes_a_homogeneous_stack():
    cfg = get_config("zamba2-1.2b").reduced()
    model = PT.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        PP.stack_blocks(model)
