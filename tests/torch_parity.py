"""Shared helpers of the port's parity tests (imported, not collected).

Each helper reads a result of either package by attribute, so the same
call takes a reference object and its port twin; the tests compare the
two outputs with ``==``. Timing fields (``wall_time_s``,
``planner_time_s``, ``build_time_s``, ``solve_time_s``,
``solver_wall_s``) are left out everywhere."""

from __future__ import annotations

import importlib.util
import re
from dataclasses import asdict, fields
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.surface import ProtocolSurface

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse where imported: the module's torch ops on one thread, the
    process's count restored after it. Tiny CPU ops gain nothing from a
    thread pool, and a pool per xdist worker oversubscribes the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SURFACE_ARRAYS = ("splits", "chunk_bytes", "latency_s", "runner_splits",
                  "runner_latency_s", "variant")


def _plain(x):
    """Numpy arrays as (dtype, shape, bytes) so ``==`` compares every bit
    (NaN-free here: +inf compares equal to itself)."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    return x


def solver_fields(res) -> dict:
    """A scalar ``SolverResult`` without its wall time."""
    return {k: getattr(res, k) for k in
            ("solver", "splits", "cost_s", "nodes_expanded", "variant", "feasible")}


def batched_fields(res) -> dict:
    """A ``BatchedSolverResult`` without its wall time."""
    names = ("solver", "backend", "n_devices", "splits", "cost_s", "feasible",
             "n_devices_s", "channels", "channel_cost_s", "variant")
    return {k: _plain(getattr(res, k)) for k in names}


def plan_fields(plan) -> dict:
    """Every ``SplitPlan`` field but ``planner_time_s``, read through
    ``convert.plan_from_reference`` (which also takes a port plan)."""
    p = convert.plan_from_reference(plan).to_dict()
    p.pop("planner_time_s")
    return p


def surface_fields(surface) -> dict:
    """A ``DegradationSurface`` as plain values: per protocol its axes,
    base link (as a field dict) and every array of ``ProtocolSurface``;
    plus the fleet size and the solver."""
    out = {"n_devices": surface.n_devices, "solver": surface.solver}
    for name, p in surface.protocols.items():
        base = convert.link_from_reference(p.base)
        out[name] = {
            "protocol": p.protocol,
            "base": {f.name: getattr(base, f.name) for f in fields(base)},
            "packet_time_s": tuple(p.packet_time_s),
            "loss_p": tuple(p.loss_p),
            **{k: _plain(getattr(p, k)) for k in SURFACE_ARRAYS},
        }
    return out


def surface_field_names() -> set[str]:
    """The ``ProtocolSurface`` fields :func:`surface_fields` must cover."""
    return {f.name for f in fields(ProtocolSurface)}


def family_fields(family: dict) -> dict:
    return {n: surface_fields(s) for n, s in family.items()}


def row_fields(row) -> dict:
    """A ``SweepRow`` without its wall share."""
    d = row.to_dict()
    d.pop("solver_wall_s")
    return d


def decisions(history) -> list[dict]:
    """An adaptive manager's ``PlanDecision`` history as plain dicts."""
    return [asdict(d) for d in history]


def protocols(ref_protocols: dict, port: bool) -> dict:
    """A ``{name: LinkProfile}`` map, converted for the port."""
    if not port:
        return dict(ref_protocols)
    return {k: convert.link_from_reference(v) for k, v in ref_protocols.items()}


# ---------------------------------------------------------------------------
# LM serving: one reduced config through both packages
# ---------------------------------------------------------------------------

# float32 logits of the reduced configs (std ~0.1): the same arithmetic
# summed in another order differs by ~5e-7
LM_F32_TOL = dict(rtol=1e-4, atol=1e-5)
LM_B, LM_P, LM_MAX_SEQ, LM_N_DECODE = 2, 12, 24, 6


def lm_inputs(cfg, S: int, seed: int) -> dict:
    """Seeded numpy inputs for the config's frontend: ``tokens`` (B, S),
    ``codes`` (B, S, n_codebooks) or ``embeds`` (B, S, d_model)."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "vision_embeds":
        return {"embeds": rng.standard_normal((LM_B, S, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "audio_codes":
        return {"codes": rng.randint(0, cfg.vocab, (LM_B, S, cfg.n_codebooks)).astype(np.int32)}
    return {"tokens": rng.randint(0, cfg.vocab, (LM_B, S)).astype(np.int32)}


def lm_next_inputs(cfg, last_logits, step: int) -> dict:
    """Greedy decode feed from the last position's logits (B, [K,] Vp):
    the argmax token (or code per codebook); the vision frontend has no
    token path, so it takes seeded embeds. ``cur_index`` is the write
    offset."""
    if cfg.frontend == "vision_embeds":
        feed = lm_inputs(cfg, 1, 100 + step)
    else:
        nxt = np.asarray(last_logits).argmax(-1).astype(np.int32)[:, None]
        feed = {"codes" if cfg.frontend == "audio_codes" else "tokens": nxt}
    return {**feed, "cur_index": np.int32(LM_P + step)}


def streams_prompt(cfg) -> bool:
    """Whether the cached runs feed the prompt token by token: any block
    pattern (a homogeneous attention stack prefills at once). The
    reference's ``prefill`` keeps no Mamba2 or mLSTM state (it returns
    ``None`` there), so such a prompt goes through ``serve_step``, as the
    ``Server`` feeds it."""
    return not (all(k == "attn" for k in cfg.pattern) and not cfg.shared_attn)


def prompt_steps(cfg, inp: dict):
    """The per-token feeds of a streamed prompt: token t at ``cur_index`` t."""
    for t in range(LM_P):
        yield {**{k: v[:, t:t + 1] for k, v in inp.items()}, "cur_index": t}


def lm_reference_run(rcfg, params, n_decode: int = LM_N_DECODE) -> dict:
    """The reference's uncached forward, prefill step, cached prefill and
    ``n_decode`` greedy ``serve_step``s (all jitted) on ``lm_inputs``:
    the logits of each, the decode feeds and the final cache, as numpy.
    Where :func:`streams_prompt`, the cached prefill is the prompt fed
    token by token through ``serve_step`` from a fresh cache, and its
    logits are those steps' (B, P, ...) together."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_prefill_step
    from repro.models import transformer as RT

    fwd = jax.jit(functools.partial(RT.forward, rcfg), static_argnames="decode")
    inp = {k: jnp.asarray(v) for k, v in lm_inputs(rcfg, LM_P, 0).items()}
    out = {"uncached": np.asarray(fwd(params, inp)[0]),
           "step": np.asarray(jax.jit(make_prefill_step(rcfg))(params, inp))}
    cache = RT.init_cache(rcfg, LM_B, LM_MAX_SEQ)
    if streams_prompt(rcfg):
        prompt = []
        for feed in prompt_steps(rcfg, inp):
            logits, cache = fwd(params, feed, cache, decode=True)
            prompt.append(np.asarray(logits))
        logits = jnp.asarray(np.concatenate(prompt, axis=1))
    else:
        logits, cache = fwd(params, inp, cache)
    out["steps"], out["feeds"] = [np.asarray(logits)], []
    for i in range(n_decode):
        feed = lm_next_inputs(rcfg, logits[:, -1], i)
        logits, cache = fwd(params, {k: jnp.asarray(v) for k, v in feed.items()}, cache,
                            decode=True)
        out["feeds"].append(feed)
        out["steps"].append(np.asarray(logits))
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def lm_port_model(cfg, params):
    """The port's ``Transformer`` on the CPU with the reference's weights."""
    import jax

    from repro_torch.models import transformer as PT

    model = PT.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    return model


def as_torch(inputs: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.asarray(v)) if np.ndim(v) else int(v)
            for k, v in inputs.items()}


def lm_port_run(cfg, model, ref: dict) -> dict:
    """The port's twin of :func:`lm_reference_run`, fed the reference's
    inputs and decode feeds; asserts at each step that the port's greedy
    pick equals the feed the reference's gave."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as PT

    import torch

    inp = as_torch(lm_inputs(cfg, LM_P, 0))
    out = {"uncached": to_numpy(PT.forward(cfg, model, inp)[0]),
           "step": to_numpy(make_prefill_step(cfg)(model, inp))}
    cache = PT.init_cache(cfg, LM_B, LM_MAX_SEQ, device="cpu")
    if streams_prompt(cfg):
        prompt = []
        for feed in prompt_steps(cfg, inp):
            logits, cache = PT.serve_step(cfg, model, feed, cache)
            prompt.append(logits)
        logits = torch.cat(prompt, dim=1)
    else:
        logits, cache = PT.prefill(cfg, model, inp, cache)
    out["steps"] = [to_numpy(logits)]
    for i, feed in enumerate(ref["feeds"]):
        mine = lm_next_inputs(cfg, to_numpy(logits[:, -1]), i)
        for k in mine:
            np.testing.assert_array_equal(mine[k], feed[k], err_msg=f"decode step {i}: {k}")
        logits, cache = PT.serve_step(cfg, model, as_torch(feed), cache)
        out["steps"].append(to_numpy(logits))
    out["cache"] = (tuple({k: to_numpy(v) for k, v in c.items()} for c in cache)
                    if isinstance(cache, tuple) else {k: to_numpy(v) for k, v in cache.items()})
    return out


def to_numpy(t) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 as numpy's bfloat16 (``ml_dtypes``,
    the type the reference's arrays come back in), exact via float32."""
    import ml_dtypes
    import torch

    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def assert_logits_close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    np.testing.assert_allclose(got, want, **LM_F32_TOL, err_msg=what)


def assert_caches_close(got, want, scaled: bool = False):
    """Float caches within ``LM_F32_TOL``; int8 codes at most one apart,
    on under 0.1% of entries (the two frameworks' float32 k can fall on
    either side of a rounding boundary); scales within rtol 1e-5. A
    block pattern's per-layer tuple is compared layer by layer, ``None``
    where the reference has ``None``; a recurrent state (no ``k``) with
    its atol times the entry's rms where that exceeds one (``scaled``):
    the mLSTM's matrix memory reaches |C| ~ 16 at ``reduced()`` size."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert_caches_close(g, w, scaled="k" not in w)
        return
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (name, diff.max())
        elif name.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=name)
        else:
            rms = float(np.sqrt(np.mean(np.square(w.astype(np.float64))))) if scaled else 1.0
            np.testing.assert_allclose(g, w, rtol=LM_F32_TOL["rtol"],
                                       atol=LM_F32_TOL["atol"] * max(1.0, rms), err_msg=name)


def assert_lm_runs_match(port: dict, ref: dict):
    """Every logits array of two :func:`lm_reference_run` /
    :func:`lm_port_run` results, and their final caches."""
    assert_logits_close(port["uncached"], ref["uncached"], "uncached forward")
    assert_logits_close(port["step"], ref["step"], "prefill step")
    assert len(port["steps"]) == len(ref["steps"])
    for i, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        assert_logits_close(got, want, f"cached step {i}")
    assert_caches_close(port["cache"], ref["cache"])


# --------------------------------------------------------------------------
# The example twins
# --------------------------------------------------------------------------

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load_example(name):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(capsys, fn, *args, masks=(), **kwargs) -> tuple[list[str], object]:
    """(the lines ``fn`` prints, with each ``(pattern, replacement)`` of
    ``masks`` applied: host wall times differ from run to run, its result)."""
    capsys.readouterr()
    result = fn(*args, **kwargs)
    lines = capsys.readouterr().out.splitlines()
    for pattern, repl in masks:
        lines = [re.sub(pattern, repl, line) for line in lines]
    return lines, result


def synced_ref_server():
    """The reference ``Server`` with each step's host buffers copied
    (``tests/test_torch_server.py`` says why)."""
    from repro.runtime import server as RS

    class SyncedRefServer(RS.Server):
        def _token_inputs(self, tokens_per_slot, positions_per_slot):
            return super()._token_inputs(tokens_per_slot.copy(), positions_per_slot.copy())

    return SyncedRefServer


def tpu_stage_hardware():
    """The reference's TPU stage constants as the port's ``StageHardware``
    (parity data for ``plan_pipeline``; the port holds no TPU number)."""
    from repro.core import profiles as RP
    from repro_torch.core.profiles import StageHardware

    return StageHardware("tpu_v5e", RP.TPU_PEAK_FLOPS, RP.TPU_HBM_BW, RP.TPU_HBM_BYTES)


def grad_op_inputs(op, dev):
    """(the first float input, a call of ``op`` on small seeded inputs on
    ``dev``): the kernel ops' autograd tests on both devices."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssm_scan.ops import ssm_scan

    g = torch.Generator().manual_seed(0)
    if op == "flash_attention":
        q, k, v = (torch.randn((1, 16, 2, 16), generator=g).to(dev) for _ in range(3))
        pos = torch.arange(16, dtype=torch.int32, device=dev)
        return q, lambda: flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                          scale=0.25)
    x = torch.randn((1, 24, 2, 8), generator=g).to(dev)
    b, c = (torch.randn((1, 24, 4), generator=g).to(dev) for _ in range(2))
    dt = torch.rand((1, 24, 2), generator=g).to(dev)
    return x, lambda: ssm_scan(x, b, c, -dt, dt, chunk=8)


# ---------------------------------------------------------------------------
# Training parity (tests/test_torch_train_step.py, test_torch_train_families.py)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_N = 2, 16, 2
TRAIN_LR = 1e-3

# A gradient leaf's tolerance, relative to its largest |value|: both
# frameworks sum in float32 (u = 2^-24) in other orders; an element's
# rounding error is ~sqrt(n) u of the leaf's scale for a length-n sum,
# and 1e-4 ~ 1,700 u covers sums of up to ~3e6 terms, chained through the
# reduced models' 2-4 layers and 16 recurrent steps.
GRAD_RTOL = 1e-4


def train_batch(cfg, n: int, seed: int) -> dict:
    """Seeded numpy training inputs for the frontend with next-token
    labels: (n, B, S, ...) when ``n`` > 1, else (B, S, ...); vision
    positions (3, B, S), or (n, 3, B, S)."""
    rng = np.random.RandomState(seed)
    lead = (n, TRAIN_B) if n > 1 else (TRAIN_B,)
    S = TRAIN_S
    if cfg.frontend == "audio_codes":
        c = rng.randint(0, cfg.vocab, (*lead, S + 1, cfg.n_codebooks)).astype(np.int32)
        return {"codes": c[..., :-1, :].copy(), "labels": c[..., 1:, :].copy()}
    if cfg.frontend == "vision_embeds":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (*lead[:-1], 3, TRAIN_B, S))
        return {"embeds": rng.standard_normal((*lead, S, cfg.d_model)).astype(np.float32),
                "positions": pos.copy(),
                "labels": rng.randint(0, cfg.vocab, (*lead, S)).astype(np.int32)}
    t = rng.randint(0, cfg.vocab, (*lead, S + 1)).astype(np.int32)
    return {"tokens": t[..., :-1].copy(), "labels": t[..., 1:].copy()}


def train_pair(arch: str, n: int = TRAIN_N):
    """(reference config, port config, reference params, port model with
    those weights) at ``reduced()`` size, float32, ``n`` microbatches."""
    import dataclasses

    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import transformer as RT
    from repro_torch.configs import get_config

    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), train_microbatches=n)
    cfg = dataclasses.replace(get_config(arch).reduced(), train_microbatches=n)
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, params, lm_port_model(cfg, params)


def ref_state(cfg, tree) -> dict:
    """A reference tree with the params' structure as the port's
    ``{name: CPU tensor}`` (gradients, moments, updated params)."""
    import jax

    return convert.lm_params_from_reference(cfg, jax.tree.map(np.asarray, tree))


def torch_batch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def assert_grads_close(got: dict, want: dict, what: str) -> dict:
    """Every leaf within ``GRAD_RTOL`` x its largest |reference value|;
    returns each leaf's tolerance."""
    assert sorted(got) == sorted(want), what
    tols = {}
    for k, w in want.items():
        w64, g64 = w.double(), got[k].double()
        tols[k] = GRAD_RTOL * float(w64.abs().max())
        err = float((g64 - w64).abs().max())
        assert err <= tols[k], f"{what} {k}: |diff| {err:.3g} > {tols[k]:.3g}"
    return tols


def assert_first_step_close(got: dict, want: dict, grads: dict, tols: dict, start: dict,
                            opt_cfg) -> tuple[int, int]:
    """Parameters after one AdamW step from zero moments, held where the
    update is determined. At step 1, delta = g/(|g| + eps) + wd p (g the
    clipped gradient, ``grads``), so a gradient error of at most T (1.1 x
    ``tols``: headroom for the clip factor's own rounding) moves delta by
    at most T eps / (|g| - T + eps)^2; where |g| > 2T that bound, times
    lr, plus 4 ulp32 of |p| + lr |delta|, holds each parameter. Where
    |g| <= 2T the sign of the update may flip (|diff| <= 2 lr + 4 ulp32):
    returns (those beyond 4 ulp32, all parameters)."""
    import torch

    lr, eps, wd = TRAIN_LR, opt_cfg.eps, opt_cfg.weight_decay
    flipped = total = 0
    for k, w in want.items():
        total += w.numel()
        g = grads[k].abs()
        T = 1.1 * tols[k]
        p0 = start[k].double().abs()
        step = lr * (g / (g + eps) + wd * p0)
        ulp = torch.from_numpy(np.spacing((p0 + step).float().numpy()).astype(np.float64))
        diff = (got[k].double() - w.double()).abs()
        firm = g > 2 * T
        bound = lr * T * eps / (g - T + eps).clamp_min(eps) ** 2 + 4 * ulp
        bad = firm & (diff > bound)
        assert not bad.any(), f"{k}: {int(bad.sum())} updates beyond their bound, " \
                              f"max excess {float((diff - bound)[firm].max()):.3g}"
        loose = ~firm
        assert (diff[loose] <= 2 * lr + 4 * ulp[loose]).all(), k
        flipped += int((loose & (diff > 4 * ulp)).sum())
    return flipped, total


def ref_train_run(arch: str):
    """The reference's value-and-grad on microbatch 0 and one jitted
    ``make_train_step`` over both microbatches (lr ``TRAIN_LR``), as the
    port's ``{name: tensor}`` dicts; and the port's model, config and
    batch for the same run. The step's clipped mean gradient is its first
    moment over (1 - b1)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_train_step
    from repro.models import transformer as RT
    from repro.optim import AdamWConfig, adamw_init

    rcfg, cfg, params, model = train_pair(arch)
    batch = train_batch(cfg, TRAIN_N, seed=1)
    mb = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: RT.loss_fn(rcfg, p, mb)))(params)
    step = jax.jit(make_train_step(rcfg, AdamWConfig(lr=TRAIN_LR)))
    new, opt, metrics = step(params, adamw_init(params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    return {"cfg": cfg, "model": model, "batch": batch, "loss": float(loss),
            "grads": ref_state(cfg, grads),
            "params": ref_state(cfg, new), "mu": ref_state(cfg, opt["mu"]),
            "step_loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "start": ref_state(cfg, params)}


def check_train_parity(arch: str, ref: dict) -> None:
    """The port against ``ref_train_run``'s results: microbatch 0's loss
    within 1e-6 relative (~17 u) and every gradient leaf within
    ``GRAD_RTOL``; then one ``make_train_step`` over both microbatches: its
    loss, the gradient norm, the first moment (0.1 x the clipped mean
    gradient, within 0.1 x its tolerance) and the parameters
    (``assert_first_step_close``). The updates left undetermined (|g|
    within 2T of zero, T = ``GRAD_RTOL`` x the leaf's largest |g|) are a
    share ~2T / max|g| x (the density of |g| / max|g| near zero): with
    max|g| ~10-30 x rms, a few per thousand; held under 1%."""
    import torch

    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, model, batch = ref["cfg"], ref["model"], ref["batch"]
    loss, grads = loss_and_grads(cfg, model, torch_batch({k: v[0] for k, v in batch.items()}))
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * abs(ref["loss"]), (float(loss), ref["loss"])
    assert_grads_close(grads, ref["grads"], f"{arch} microbatch 0 gradient")
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    model, opt, metrics = make_train_step(cfg, opt_cfg)(model, adamw_init(model),
                                                        torch_batch(batch))
    assert abs(float(metrics["loss"]) - ref["step_loss"]) <= 1e-6 * ref["step_loss"]
    assert abs(float(metrics["grad_norm"]) - ref["grad_norm"]) <= 1e-5 * ref["grad_norm"]
    clipped = {k: mu.double() / (1 - opt_cfg.b1) for k, mu in ref["mu"].items()}
    tols = {k: GRAD_RTOL * float(g.abs().max()) for k, g in clipped.items()}
    for k, w in ref["mu"].items():
        err = float((opt["mu"][k].double() - w.double()).abs().max())
        assert err <= 0.1 * 1.1 * tols[k] + 1e-12, f"{arch} mu {k}: {err:.3g}"
    assert not any(p.requires_grad for p in model.parameters())
    loose, total = assert_first_step_close(dict(model.state_dict()), ref["params"], clipped,
                                           tols, ref["start"], opt_cfg)
    assert loose <= 0.01 * total, f"{arch}: {loose} of {total} updates undetermined"


def card_step_used(got: dict, want: dict, clipped: dict, lr: float, eps: float = 1e-8
                   ) -> tuple[float, int]:
    """Card against CPU after one AdamW step from the same weights and
    zero moments (``chip_smoke.step_used``'s rule). ``clipped`` is the CPU
    step's clipped mean gradient, its bound T = 1e-4 x its rms; where
    |g| > 2T each parameter is held within the larger of 1e-4 x rms(p)
    and lr T eps / (|g| - T + eps)^2 (what T can move delta = g / (|g| +
    eps)); returns the largest share used, and the count of the rest,
    whose update sign is open (each asserted within 2 lr + 4 ulp32)."""
    import torch

    used, loose = 0.0, 0
    for k, w in want.items():
        g, w64 = clipped[k].double().abs(), w.double()
        T = 1e-4 * float(g.square().mean().sqrt())
        diff = (got[k].double() - w64).abs()
        firm = g > 2 * T
        bound = torch.clamp_min(lr * T * eps / (g - T + eps).clamp_min(eps) ** 2,
                                1e-4 * float(w64.square().mean().sqrt()))
        if firm.any():
            used = max(used, float((diff[firm] / bound[firm]).max()))
        ulp = torch.from_numpy(np.spacing(w.float().abs().numpy()).astype(np.float64))
        assert (diff[~firm] <= 2 * lr + 4 * ulp[~firm]).all(), k
        loose += int((~firm & (diff > 4 * ulp)).sum())
    return used, loose
