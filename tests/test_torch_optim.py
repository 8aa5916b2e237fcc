"""The port's AdamW and schedules against the reference's
(``repro.optim``), on the same numpy leaves.

Both run the same float32 chain; the frameworks' ``pow``, ``sqrt`` and
division round the same way, but their sums of squares (the global norm)
run in other orders. So:

* the gradient norm is held within n u relative (n values summed,
  u = 2^-24: a float32 sum's worst-case error);
* every other float32 value within 4 ulp32, except the moments: the
  clip scale multiplies every gradient, so a moment carries the norms'
  relative gap (once for mu, squared for nu) on its new term, plus 4
  ulp32 of its two terms' magnitudes (they may cancel) and the bound it
  carried, decayed by b1 or b2; a float32 parameter p - lr delta within
  4 ulp32 of |p| + |lr delta| plus lr times what those moment bounds can
  move delta (first order in each);
* bfloat16 parameters and moments round that float32 result once: they
  may differ by one bf16 ulp where the float32 values straddle a rounding
  boundary, which so small a gap does for a few values in a thousand;
  the count is held under 1%.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefConfig
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import global_norm as ref_norm
from repro.optim import linear_warmup_cosine as ref_warmup
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
)

SHAPES = {"w": (16, 24), "b": (24,), "n.s": (3, 5, 7)}
N_VALUES = sum(int(np.prod(s)) for s in SHAPES.values())


def leaves(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def ref_tree(flat, dtype=jnp.float32):
    """The reference's nested tree of the flat ``{name: array}``."""
    return {"w": jnp.asarray(flat["w"], dtype), "b": jnp.asarray(flat["b"], dtype),
            "n": {"s": jnp.asarray(flat["n.s"], dtype)}}


def ref_flat(tree) -> dict:
    return {"w": np.asarray(tree["w"].astype(jnp.float32)),
            "b": np.asarray(tree["b"].astype(jnp.float32)),
            "n.s": np.asarray(tree["n"]["s"].astype(jnp.float32))}


def ulp32(a):
    return np.spacing(np.abs(a).astype(np.float32)).astype(np.float64)


def assert_close32(got, want, what, tol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 4 * ulp32(want) if tol is None else tol
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} values beyond 4 ulp, max {np.abs(got - want).max()}"


def assert_close_bf16(got, want, what):
    """Equal, or one bf16 ulp apart on under 1% of the values."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)).astype(np.float64)
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), f"{what}: a value more than one bf16 ulp off"
    assert (diff > 0).mean() < 0.01, f"{what}: {(diff > 0).mean():.3%} differ"


SCHEDULES = {
    "const": (1e-3, 1e-3),
    "cosine": (ref_cosine(1e-3, 10), cosine_schedule(1e-3, 10)),
    "warmup": (ref_warmup(1e-3, 2, 10), linear_warmup_cosine(1e-3, 2, 10)),
}


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("lr", sorted(SCHEDULES))
@pytest.mark.parametrize("param_dtype,moments", [("float32", "float32"), ("bfloat16", "float32"),
                                                 ("bfloat16", "bfloat16")])
def test_adamw_three_steps_match_reference(clip, lr, param_dtype, moments):
    """Three AdamW steps on seeded params and gradients (clipping active:
    the gradients' norm is ~21): params, both moments, the step, the
    gradient norm and the learning rate."""
    ref_lr, port_lr = SCHEDULES[lr]
    pdt, mdt = jnp.dtype(param_dtype), jnp.dtype(moments)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    start = leaves(0, 0.5)
    rp = ref_tree(start, pdt)
    rstate = ref_init(rp, moments_dtype=mdt)
    # copies: jnp.asarray may alias a numpy buffer on the CPU, and the port
    # updates in place while the reference's dispatched step may still read it
    pp = {k: torch.tensor(v).to(tdt[param_dtype]) for k, v in start.items()}
    pstate = adamw_init(pp, moments_dtype=tdt[moments])
    rcfg = RefConfig(lr=ref_lr, grad_clip_norm=clip)
    pcfg = AdamWConfig(lr=port_lr, grad_clip_norm=clip)
    bound = {m: {k: 0.0 for k in SHAPES} for m in ("mu", "nu")}
    for step in range(3):
        g = leaves(10 + step)
        before = {m: ref_flat(rstate[m]) for m in ("mu", "nu")}
        rp_before = rp
        rp, rstate, rm = ref_update(ref_tree(g, pdt), rstate, rp, rcfg)
        grads = {k: torch.tensor(v).to(tdt[param_dtype]) for k, v in g.items()}
        pp, pstate, pm = adamw_update(grads, pstate, pp, pcfg)
        assert int(pstate["step"]) == int(rstate["step"]) == step + 1
        gn, rgn = float(pm["grad_norm"]), float(rm["grad_norm"])
        gap = abs(gn - rgn) / rgn
        assert gap <= N_VALUES * 2.0 ** -24, f"grad_norm {gn} vs {rgn}"
        assert_close32(float(pm["lr"]), float(rm["lr"]), "lr")
        p_before = ref_flat(rp_before)
        scale = 1.0 if clip is None else min(1.0, clip / rgn)
        for m, coef, power in (("mu", rcfg.b1, 1), ("nu", rcfg.b2, 2)):
            for name, want in ref_flat(rstate[m]).items():
                got = pstate[m][name].float().numpy()
                if moments == "bfloat16":
                    assert_close_bf16(got, want, f"step {step} {m} {name}")
                    continue
                g_ref = ref_flat(ref_tree(g, pdt))[name].astype(np.float64)
                new_term = (1 - coef) * np.abs(g_ref * scale) ** power
                carried = coef * np.abs(before[m][name].astype(np.float64))
                bound[m][name] = (coef * bound[m][name] + 2 * power * gap * new_term
                                  + 4 * ulp32(carried + new_term))
                assert_close32(got, want, f"step {step} {m} {name}", bound[m][name])
        t = step + 1
        b1c, b2c = 1 - rcfg.b1 ** t, 1 - rcfg.b2 ** t
        lr_now = float(rm["lr"])
        for name, want in ref_flat(rp).items():
            got = pp[name].float().numpy()
            if param_dtype == "bfloat16":
                assert_close_bf16(got, want, f"step {step} {name}")
                continue
            mu = np.abs(ref_flat(rstate["mu"])[name].astype(np.float64)) / b1c
            root = np.sqrt(ref_flat(rstate["nu"])[name].astype(np.float64) / b2c)
            den = root + rcfg.eps
            d_delta = (bound["mu"][name] / b1c / den
                       + mu / den ** 2 * bound["nu"][name] / b2c / (2 * root + 1e-30))
            step_size = lr_now * (mu / den + rcfg.weight_decay * np.abs(p_before[name]))
            tol = lr_now * d_delta + 4 * ulp32(np.abs(p_before[name]) + step_size)
            assert_close32(got, want, f"step {step} {name}", tol)


def test_update_is_in_place_and_decays_every_leaf():
    """With zero gradients the update is the weight decay alone, applied
    to every leaf in place: p <- p - lr * wd * p."""
    p = {k: torch.tensor(v) for k, v in leaves(1).items()}
    before = {k: v.clone() for k, v in p.items()}
    state = adamw_init(p)
    out, state, _ = adamw_update({k: torch.zeros_like(v) for k, v in p.items()}, state, p,
                                 AdamWConfig(lr=1e-2, weight_decay=0.1))
    assert out is p
    for k in p:
        torch.testing.assert_close(p[k], before[k] - 1e-2 * (0.1 * before[k]), rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_matches_reference():
    g = leaves(3, 7.0)
    got = float(global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    want = float(ref_norm(ref_tree(g)))
    assert abs(got - want) <= N_VALUES * 2.0 ** -24 * want


@pytest.mark.parametrize("name", ["cosine", "warmup"])
def test_schedules_match_reference(name):
    ref_fn, port_fn = SCHEDULES[name]
    for step in range(0, 14):
        want = float(ref_fn(jnp.int32(step)))
        got = float(port_fn(torch.tensor(step, dtype=torch.int32)))
        assert_close32(got, want, f"{name} at step {step}")
