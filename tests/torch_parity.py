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

from repro_torch import convert
from repro_torch.core.surface import ProtocolSurface

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
