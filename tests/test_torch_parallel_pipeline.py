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

    @jax.jit
    def ref_grads(h, head):
        """d/d blocks and d/dx of sum(outputs * head), the blocks in order
        microbatch by microbatch (the port's stacked names are the
        reference's dotted block paths)."""
        def loss(blocks, h):
            total = 0.0
            for m in range(h.shape[0]):
                hm = h[m]
                for i in range(N_LAYERS):
                    p = jax.tree.map(lambda t, i=i: t[i], blocks)
                    hm = RT.apply_block(rcfg, "attn", p, hm, jnp.asarray(positions), None,
                                        decode=False)[0]
                total = total + jnp.sum(hm * head[m])
            return total
        return jax.grad(loss, argnums=(0, 1))(params["blocks"], h)

    return cfg, model, x, positions, want, ref_grads


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_deepseek_blocks_through_the_pipeline(deepseek, name):
    cfg, model, x, positions, want, _ = deepseek
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


# --------------------------------------------------------------------------
# gradients through the one-process form (the reference's pipelined_forward
# is a plain JAX function that jax.grad goes through)
# --------------------------------------------------------------------------

GRAD_SPLITS = {2: (3,), 3: (3, 5)}  # uneven: padded layers on the later stages


def per_microbatch_grads(block_apply, stacked: dict, n_layers: int, x, head):
    """Each microbatch's gradients alone (blocks in order): the terms that
    every accumulation order sums."""
    out = []
    for m in range(x.shape[0]):
        xm = x[m:m + 1].detach().requires_grad_(True)
        loss = torch.sum(sequential_per_microbatch(block_apply, stacked, n_layers, xm) * head[m])
        out.append(torch.autograd.grad(loss, [*stacked.values(), xm]))
    return out


def sequential_per_microbatch(block_apply, stacked: dict, n_layers: int, x):
    """The blocks in order, microbatch by microbatch (the pipeline's shapes)."""
    outs = []
    for xm in x:
        for i in range(n_layers):
            xm = block_apply({k: v[i] for k, v in stacked.items()}, xm)
        outs.append(xm)
    return torch.stack(outs)


def grad_head(x: torch.Tensor) -> np.ndarray:
    """The seeded weights of the loss sum(outputs * head), shaped as ``x``."""
    return np.random.RandomState(7).standard_normal(tuple(x.shape)).astype(np.float32)


def assert_grads_match_in_order(block_apply, stacked: dict, n_layers: int, x, plan, devices):
    """Gradients of sum(outputs * head) with respect to every stacked
    parameter and the input, through ``run_pipeline`` and through the
    blocks in order. A layer's weight gradient sums M per-microbatch terms
    g_m in autograd's order, which the two graphs need not share: any two
    orders of an M-term sum differ by at most 2 (M - 1) u sum_m |g_m| (u
    the unit roundoff), the bound held here. The input's gradient has one
    term per microbatch and must be equal. Returns the pipeline's
    gradients, the stacked parameters' then the input's."""
    head = torch.from_numpy(grad_head(x)).to(x.dtype)
    leaves = [*stacked.values(), x]
    got = torch.autograd.grad(
        torch.sum(PP.run_pipeline(plan, block_apply, stacked, n_layers, x, devices=devices)
                  * head), leaves)
    want = torch.autograd.grad(
        torch.sum(sequential_per_microbatch(block_apply, stacked, n_layers, x) * head), leaves)
    terms = per_microbatch_grads(block_apply, stacked, n_layers, x, head)
    M, u = x.shape[0], torch.finfo(x.dtype).eps / 2
    for i, name in enumerate(stacked):
        size = sum(t[i].abs() for t in terms)
        gap = (got[i] - want[i]).abs()
        assert bool((gap <= 2 * (M - 1) * u * size).all()), (name, float(gap.max()))
        assert float(got[i].abs().max()) > 0, name
    assert torch.equal(got[-1], want[-1])
    return got


def gamma(k: int, dtype) -> float:
    """Higham's gamma_k = k u / (1 - k u) for ``dtype``'s unit roundoff u."""
    ku = k * np.finfo(dtype).eps / 2
    return ku / (1 - ku)


@pytest.mark.parametrize("stages", sorted(GRAD_SPLITS))
def test_gradients_through_the_pipeline_equal_the_blocks_in_order(stages):
    """The toy blocks in float64: every stacked weight's gradient within
    the M-term sum bound of the blocks in order's, the input's equal.

    Then against the reference: ``jax.grad`` of sum(sequential(x) * head)
    through the reference's own sequential oracle, in float32. The
    gradient is a circuit of sums and products alone, so a computed value
    lies within gamma_k x the same circuit on |w|, |x| and |head| of the
    exact one, k the roundings on its longest path: L layers of D + 1
    forward and as many backward, the head's product and the M x mb-row
    sum of a weight gradient. The bound held is that of the float32 and
    the float64 computation added."""
    w_np, x_np = toy_weights(stages)
    w = torch.from_numpy(w_np).double().requires_grad_(True)
    x = torch.from_numpy(x_np).double().requires_grad_(True)
    got = assert_grads_match_in_order(toy_block, {"w": w}, L, x, Plan(GRAD_SPLITS[stages]),
                                      ["cpu"] * stages)
    head = grad_head(x)
    want = jax.grad(lambda w, x: jnp.sum(sequential(toy_block, {"w": w}, L, x) * head),
                    argnums=(0, 1))(jnp.asarray(w_np), jnp.asarray(x_np))
    w_abs = w.detach().abs().requires_grad_(True)
    x_abs = x.detach().abs().requires_grad_(True)
    size = torch.autograd.grad(torch.sum(sequential(toy_block, {"w": w_abs}, L, x_abs)
                                         * torch.from_numpy(head).double().abs()),
                               [w_abs, x_abs])
    k = 2 * L * (D + 1) + 1 + M * MB
    bound_of = gamma(k, np.float32) + gamma(k, np.float64)
    for name, g, r, a in zip(("w", "x"), got, want, size):
        gap = np.abs(g.numpy() - np.asarray(r, dtype=np.float64))
        assert np.all(gap <= bound_of * a.numpy()), (name, float(gap.max()))


@pytest.mark.parametrize("stages", sorted(GRAD_SPLITS))
def test_deepseek_gradients_through_the_pipeline(deepseek, stages):
    """reduced() deepseek-7b's blocks (float32, 8 layers): the stacked
    parameters come from ``stack_blocks`` of a model whose parameters
    require grad, so the gradient also reaches the model's own leaves.
    Every stacked parameter's gradient and the input's are within
    ``LM_F32_TOL`` of ``jax.grad`` through the reference's ``apply_block``
    in order, on the same weights, inputs and head; the atol is taken on
    the leaf's rms where that exceeds one, as ``torch_parity`` does for a
    scaled cache entry (these gradients reach |g| ~ 20, not the logits'
    std ~ 0.1 that ``LM_F32_TOL`` was set on)."""
    cfg, model, x, positions, _, ref_grads = deepseek
    pos = torch.from_numpy(positions.copy())
    apply = PP.transformer_block_apply(model, cfg, pos)
    for p in model.parameters():
        p.requires_grad_(True)
    try:
        stacked = PP.stack_blocks(model)
        assert all(t.requires_grad for t in stacked.values())
        xt = torch.from_numpy(x).requires_grad_(True)
        got = assert_grads_match_in_order(apply, stacked, N_LAYERS, xt,
                                          Plan(GRAD_SPLITS[stages]), ["cpu"] * stages)
        want_blocks, want_x = ref_grads(jnp.asarray(x), jnp.asarray(grad_head(xt)))
        want = {".".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(want_blocks)}
        assert set(want) == set(stacked)
        for name, g, r in [*zip(stacked, got, (want[n] for n in stacked)),
                           ("x", got[-1], np.asarray(want_x))]:
            rms = float(np.sqrt(np.mean(np.square(r.astype(np.float64)))))
            np.testing.assert_allclose(g.numpy(), r, rtol=LM_F32_TOL["rtol"],
                                       atol=LM_F32_TOL["atol"] * max(1.0, rms), err_msg=name)
        leaf = model.blocks[0].attn.wq
        (g,) = torch.autograd.grad(torch.sum(PP.run_pipeline(
            Plan(GRAD_SPLITS[stages]), apply, stacked, N_LAYERS, xt,
            devices=["cpu"] * stages)), [leaf])
        assert g.shape == leaf.shape and float(g.abs().max()) > 0
    finally:
        for p in model.parameters():
            p.requires_grad_(False)


def test_the_bubble_ticks_keep_nothing_past_the_backward():
    """Every tensor the pipeline's graph saved for its backward is freed
    once the backward has run and the outputs are dropped, but for the
    caller's own leaves: the fill ticks (stage s at t < s on zeros) and
    the drain ticks (microbatch M - 1 again) never reach the outputs."""
    import weakref

    w, x = toy_weights(5)
    w = torch.from_numpy(w).requires_grad_(True)
    x = torch.from_numpy(x).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = PP.run_pipeline(Plan((3, 5)), toy_block, {"w": w}, L, x, devices=["cpu"] * 3)
    torch.sum(out).backward()
    del out
    alive = [r() for r in saved if r() is not None]
    assert saved and all(t is w or t is x for t in alive), len(alive)
