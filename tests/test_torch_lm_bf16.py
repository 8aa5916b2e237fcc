"""The port's LM against the reference's in bfloat16, on the CPU.

The non-MoE configs at ``reduced()`` size in bf16 (the reference cannot
run bf16 MoE on XLA:CPU: ``DotThunk`` has no bf16 x bf16 = f32), the
block patterns of zamba2-1.2b and xlstm-1.3b among them, with the
reference's bf16 ``init_params(PRNGKey(0))`` weights carried across bit
for bit by ``convert.lm_params_from_reference``. Compared: the uncached
forward's float32 logits over the real vocab.

The two are not bit-equal: XLA may keep an intermediate in float32 where
the port rounds it to bf16, or the other way round. The tolerance is
derived, not tuned. Let u = 2^-8, bf16's unit roundoff: an activation
rounded to bf16 on one side only differs by at most u relative. Count
the bf16 roundings on the path to the logits: per block at most 18 (the
attention norm; q, k, v or MLA's four latent projections; RoPE on q and
k; the probabilities; the attention output and its projection; the
residual; the MLP norm; up and gate; their product; down; the residual;
the audio codebook sum or the vision embeds' cast), plus the final norm
and the head's input: R = 18 * n_layers + 2 = 38. A Mamba2 block has at
most 16 (the norm; the in-projection; the causal conv's 4 products and 3
sums in bf16; its bias and SiLU; y's cast; SiLU of z; their product; the
out-projection; the residual), an mLSTM block 5 (the norm, the
in-projection, y's cast, the out-projection, the residual), an sLSTM
block 4 (its in-projection stays float32 from bf16 values: exact
products); R sums the blocks of the pattern, plus 2 (zamba2 reduced,
Mamba2 / shared attention / Mamba2 / shared attention: 70; xlstm: 20).
Carried to the logits
with a gain of at most 1 in units of their std (the stack is
norm-preserving at init):
* worst case, all R errors of the full u in one direction:
  max |port - reference| <= R * u * std = 0.148 std;
* independent errors, each uniform with rms u / sqrt(3), adding in
  quadrature: rms |port - reference| <= sqrt(R) * u / sqrt(3) * std =
  0.0139 std.
Measured before this test was written (same weights, CPU): max 0.024 to
0.049 std, rms 0.0062 to 0.0090 std; zamba2 max 0.077, rms 0.0134 std;
xlstm 3.8e-7 and 5.8e-8 std (its scans run in float32 on both sides)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import transformer as PT
from torch_parity import (
    LM_P,
    as_torch,
    lm_inputs,
    lm_port_model,
    lm_port_run,
    lm_reference_run,
    to_numpy,
)

ARCHS = ["deepseek-7b", "granite-34b", "stablelm-12b", "minicpm3-4b", "musicgen-medium",
         "qwen2-vl-72b", "zamba2-1.2b", "xlstm-1.3b"]
U = 2.0 ** -8  # bf16 unit roundoff
ROUNDINGS_PER_BLOCK = {"attn": 18, "mamba": 16, "mlstm": 5, "slstm": 4}


def bf16_configs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(), dtype="bfloat16"),
            dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16"))


def limits(cfg) -> tuple[float, float]:
    """(max, rms) limits over the logits' std, as the docstring derives."""
    r = sum(ROUNDINGS_PER_BLOCK[kind] for kind in cfg.pattern) + 2
    return r * U, math.sqrt(r) * U / math.sqrt(3)


def within_limits(got, want, cfg):
    g = got[..., :cfg.vocab].astype(np.float64)
    w = want[..., :cfg.vocab].astype(np.float64)
    std = w.std()
    err_max, err_rms = np.abs(g - w).max() / std, np.sqrt(np.mean((g - w) ** 2)) / std
    lim_max, lim_rms = limits(cfg)
    assert err_max <= lim_max and err_rms <= lim_rms, (err_max, lim_max, err_rms, lim_rms)
    assert err_max > 0  # not bit-equal: the limits, not luck, decide


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_the_derived_limits(arch):
    rcfg, cfg = bf16_configs(arch)
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    assert params["embed"]["table"].dtype == jnp.bfloat16
    inp = lm_inputs(rcfg, LM_P, 0)
    fwd = jax.jit(functools.partial(RT.forward, rcfg))
    want = np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in inp.items()})[0])
    model = lm_port_model(cfg, params)
    assert model.embed.table.dtype == torch.bfloat16
    got = to_numpy(PT.forward(cfg, model, as_torch(inp))[0])
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    within_limits(got, want, cfg)


def test_bf16_cached_run_takes_the_parity_helpers():
    """The shared helpers run a bf16 prefill into a bf16 cache and greedy
    decode: the cache comes back in the reference's types and shapes,
    and every step's logits within the same limits."""
    rcfg, cfg = bf16_configs("deepseek-7b")
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    ref = lm_reference_run(rcfg, params, n_decode=2)
    port = lm_port_run(cfg, lm_port_model(cfg, params), ref)
    assert {k: (v.dtype, v.shape) for k, v in port["cache"].items()} == \
        {k: (v.dtype, v.shape) for k, v in ref["cache"].items()}
    assert port["cache"]["k"].dtype.name == "bfloat16"
    for got, want in zip(port["steps"], ref["steps"]):
        within_limits(got, want, cfg)
