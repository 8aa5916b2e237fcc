"""The port's LM families against the reference's, on the CPU.

Each of the six configs this slice serves, at its ``reduced()`` size (2
layers, d 64, 4 heads of 16, float32, vocab 128 padded to 256; MoE 4
experts top-2 in groups of 32; MLA ranks 32 / 16, heads 16 + 8 and v 16;
M-RoPE sections (2, 3, 3)), with the reference's
``init_params(PRNGKey(0))`` weights carried across by
``convert.lm_params_from_reference``:

* stablelm-12b (parallel residual), granite-moe-1b-a400m and
  qwen3-moe-235b-a22b (MoE), minicpm3-4b (MLA, absorbed decode),
  musicgen-medium (audio codes in, (B, S, 4, Vp) logits out; also with
  a tied head), qwen2-vl-72b (vision embeds, M-RoPE, the int8 KV cache).

Compared: the uncached forward, ``make_prefill_step`` (the flash branch
on: on the CPU its plain version runs), ``prefill`` into a cache and 6
greedy ``serve_step``s (``decode=True``), and the final cache. Logits:
``rtol 1e-4, atol 1e-5`` (std ~0.1; the same float32 arithmetic in
another order gives ~5e-7). Float caches: the same. The int8 cache's
codes may sit one apart where the two frameworks' float32 k lands within
an ulp of a rounding boundary; its scales within rtol 1e-5. On the
reference's own k and v the port's quantizer gives equal codes and
scales (``==``). Full-width shapes come from ``jax.eval_shape`` and a
``FakeTensorMode`` build: no full-width weight is allocated."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime import server as RS
from repro_torch.configs import get_config
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.runtime import server as PS
from torch_parity import (
    LM_F32_TOL,
    as_torch,
    assert_caches_close,
    assert_lm_runs_match,
    assert_logits_close,
    lm_inputs,
    lm_port_model,
    lm_port_run,
    lm_reference_run,
)

ARCHS = ["stablelm-12b", "granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "minicpm3-4b",
         "musicgen-medium", "qwen2-vl-72b"]
# MoE groups of 16 (the 24 prompt tokens make a full group and a padded
# one) at capacity factor 0.5 (C = 4 of 32 pairs per expert): experts
# overflow in both groups
OVERFLOW = dict(moe_group_size=16, moe_capacity_factor=0.5)

ref_init_params = jax.jit(RT.init_params, static_argnums=1)


def cfg_pair(arch, **kw):
    """(reference config, port config): ``reduced()`` with the flash branch
    on, plus ``kw``."""
    kw = {"use_flash_kernel": True, **kw}
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def runs(arch, **kw):
    rcfg, cfg = cfg_pair(arch, **kw)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ref = lm_reference_run(rcfg, params)
    return cfg, params, ref, lm_port_run(cfg, lm_port_model(cfg, params), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_uncached_forward_matches_reference(arch):
    cfg, _, ref, port = runs(arch)
    assert_logits_close(port["uncached"], ref["uncached"], "uncached forward")
    assert port["step"].shape == ref["step"].shape
    assert_logits_close(port["step"], ref["step"], "prefill step")


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_decode_match_reference(arch):
    """``prefill`` into a 24-row cache, then 6 greedy ``serve_step``s on
    the reference's feeds (the port's greedy picks must equal them)."""
    cfg, _, ref, port = runs(arch)
    for i, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        assert_logits_close(got, want, f"step {i}")
    assert_caches_close(port["cache"], ref["cache"])


def test_cache_layouts_follow_the_reference():
    """MLA caches only the latent and the rope key; qwen2-vl's cache is
    int8 with float32 scales unless a dtype is asked for."""
    for arch in ARCHS:
        rcfg, cfg = cfg_pair(arch)
        for dtype in (None, torch.float32):
            want = RT.init_cache(rcfg, 2, 8, dtype=None if dtype is None else jnp.float32)
            got = PT.init_cache(cfg, 2, 8, dtype=dtype, device="cpu")
            assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in want.items()}, (arch, dtype)


# ---------------------------------------------------------------------------
# MoE: top-k tie rule, slot-major capacity drops
# ---------------------------------------------------------------------------


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        _, want = jax.lax.top_k(jnp.asarray(probs), k)
        got = PL.top_k_lower_index(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def reference_keep(top_i, E, C):
    """The reference's slot-major queue (``apply_moe``'s three lines)."""
    masks = jax.nn.one_hot(jnp.swapaxes(top_i, 1, 2), E, dtype=jnp.int32)
    flat = masks.reshape(top_i.shape[0], -1, E)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(masks.shape)
    keep = (pos >= 0) & (pos < C)  # (n, K, g, E)
    return np.asarray(jnp.swapaxes(keep.any(-1), 1, 2))  # (n, g, K)


def test_moe_layer_drops_the_reference_pairs():
    """One MoE layer on a 24-token batch at OVERFLOW: the port keeps and
    drops exactly the reference's (token, slot) pairs (later slots first),
    and its output matches ``apply_moe``'s, pad rows routed as tokens."""
    rcfg, cfg = cfg_pair("granite-moe-1b-a400m", **OVERFLOW)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    p = jax.tree.map(lambda t: np.asarray(t[0]), params["blocks"]["ff"])
    x = np.random.RandomState(3).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want = np.asarray(RL.apply_moe(rcfg, p, jnp.asarray(x)))

    moe = PL.MoE(cfg, device="cpu", dtype=torch.float32)
    moe.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    chosen = []
    moe.select = lambda probs, k: chosen.append(PL.top_k_lower_index(probs, k)) or chosen[-1]
    got = moe(cfg, torch.from_numpy(x)).numpy()
    # |out| reaches ~60 here: float32 sums in another order, 2e-7 of it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    top_i = chosen[0]
    n, g, K = top_i.shape
    C = int(np.ceil(g * K / cfg.n_experts * cfg.moe_capacity_factor))
    keep = (PL.queue_positions(top_i, cfg.n_experts) < C).numpy()
    np.testing.assert_array_equal(keep, reference_keep(jnp.asarray(top_i.numpy()),
                                                       cfg.n_experts, C))
    assert (n, g, C) == (2, 16, 4) and not keep.all()
    assert keep[:, :, 0].sum() > keep[:, :, 1].sum()  # the second slot drops first


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"])
def test_moe_overflow_through_the_model_matches_reference(arch):
    """The whole serving loop with overflowing experts: prefill groups of
    16 (one padded), and decode groups of 2 tokens with C = 1."""
    _, _, ref, port = runs(arch, **OVERFLOW)
    assert_lm_runs_match(port, ref)


# ---------------------------------------------------------------------------
# MLA: absorbed and unabsorbed decode
# ---------------------------------------------------------------------------


def test_mla_unabsorbed_decode_matches_reference():
    _, _, ref, port = runs("minicpm3-4b", mla_absorbed_decode=False)
    assert_lm_runs_match(port, ref)


def test_mla_absorbed_decode_equals_unabsorbed():
    """The latent-space decode is the expanded one's function: within
    rtol 1e-4 / atol 1e-5 of it on the same feeds."""
    _, _, _, absorbed = runs("minicpm3-4b")
    _, _, _, expanded = runs("minicpm3-4b", mla_absorbed_decode=False)
    assert not np.array_equal(absorbed["steps"][1], expanded["steps"][1])
    for got, want in zip(absorbed["steps"], expanded["steps"]):
        np.testing.assert_allclose(got, want, **LM_F32_TOL)


# ---------------------------------------------------------------------------
# The tied head
# ---------------------------------------------------------------------------


def test_tied_head_per_codebook_matches_reference():
    """musicgen reduced with ``tie_embeddings`` (vocab 256, so no padded
    slot): the head is the stacked codebook tables transposed, holds no
    weight, and the serving loop matches the reference's."""
    cfg, params, ref, port = runs("musicgen-medium", tie_embeddings=True, vocab=256)
    assert not params["lm_head"] and cfg.vocab_padded == cfg.vocab
    assert "lm_head.w" not in lm_port_model(cfg, params).state_dict()
    assert port["uncached"].shape == (2, 12, cfg.n_codebooks, 256)
    assert_lm_runs_match(port, ref)


# ---------------------------------------------------------------------------
# M-RoPE and the int8 KV cache
# ---------------------------------------------------------------------------


def mrope_positions(S, seed):
    """(3, B, S) streams that differ: t the arange, h and w seeded."""
    rng = np.random.RandomState(seed)
    t = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    return np.stack([t, rng.randint(0, 9, (2, S)), rng.randint(0, 9, (2, S))]).astype(np.int32)


def test_mrope_rotation_matches_reference():
    x = np.random.RandomState(4).standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = mrope_positions(7, 5)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="M-RoPE"):
        PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6, (2, 3, 3))


def test_mrope_positions_through_the_model_match_reference():
    """qwen2-vl reduced on explicit (3, B, S) streams, uncached and into
    its int8 cache (masks take the t stream)."""
    rcfg, cfg = cfg_pair("qwen2-vl-72b")
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    inp = {**lm_inputs(cfg, 12, 0), "positions": mrope_positions(12, 6)}
    model = lm_port_model(cfg, params)
    for cached in (False, True):
        rc = RT.init_cache(rcfg, 2, 16) if cached else None
        want, _ = jax.jit(functools.partial(RT.forward, rcfg))(
            params, {k: jnp.asarray(v) for k, v in inp.items()}, rc)
        pc = PT.init_cache(cfg, 2, 16, device="cpu") if cached else None
        got, _ = PT.forward(cfg, model, as_torch(inp), pc)
        assert_logits_close(got.numpy(), np.asarray(want), f"cached={cached}")


def test_int8_cache_codes_and_scales_equal_reference():
    """One attention layer writing the int8 cache in the reference; the
    port's quantizer on the reference's own k and v gives the same codes
    and scales, ``==``, including a zero row (scale 1) and rounding ties."""
    rcfg, cfg = cfg_pair("qwen2-vl-72b")
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    p = jax.tree.map(lambda t: t[0], params["blocks"]["attn"])
    x = np.random.RandomState(7).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    x[1, 2] = 0.0  # a zero row: k and v rows of zeros
    x = jnp.asarray(x)
    pos = jnp.asarray(mrope_positions(5, 8))
    cache = {k: v[0] for k, v in RT.init_cache(rcfg, 2, 8).items()}
    _, new = RL.apply_attention(rcfg, p, x, pos, cache)
    for name, w in (("k", p["wk"]), ("v", p["wv"])):
        t = jnp.einsum("bsd,dhe->bshe", x, w, preferred_element_type=jnp.float32)
        if name == "k":
            t = RL.apply_rope(t, pos, rcfg.rope_theta, rcfg.mrope_sections)
        vals, scale = PL.quantize_kv(torch.from_numpy(np.array(t)))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(new[name])[:, :5])
        np.testing.assert_array_equal(scale.numpy(), np.asarray(new[name + "_scale"])[:, :5])
        assert scale[1, 2].eq(1.0).all()
    ties = torch.tensor([[[[127.0, 0.5, 1.5, -2.5, 63.5]]]])  # scale 1: round half to even
    vals, scale = PL.quantize_kv(ties)
    assert scale.item() == 1.0 and vals.flatten().tolist() == [127, 0, 2, -2, 64]


# ---------------------------------------------------------------------------
# The Server on the token-frontend configs (and M-RoPE on the text path)
# ---------------------------------------------------------------------------


class SyncedRefServer(RS.Server):
    """The reference ``Server`` with each step's host buffers copied (its
    ``jnp.asarray`` may wrap the buffers it rewrites before the
    asynchronously dispatched step reads them)."""

    def _token_inputs(self, tokens_per_slot, positions_per_slot):
        return super()._token_inputs(tokens_per_slot.copy(), positions_per_slot.copy())


PROMPTS = {0: [3, 9, 4], 1: [11, 5, 7, 2, 60, 1, 8], 2: [21, 9, 14, 2]}


@pytest.mark.parametrize("arch,kw", [("stablelm-12b", {}), ("granite-moe-1b-a400m", {}),
                                     ("qwen3-moe-235b-a22b", {}), ("minicpm3-4b", {}),
                                     ("qwen2-vl-72b", {"frontend": "none"})],
                         ids=["stablelm", "granite-moe", "qwen3-moe", "minicpm3",
                              "qwen2-vl-text"])
def test_server_tokens_equal_the_reference_servers(arch, kw):
    """Three requests on 2 slots (the third admitted mid-decode): the
    port's ``Server`` emits the reference ``Server``'s tokens. Its steps
    are ``serve_step``s (MLA absorbed); qwen2-vl on its text path takes
    M-RoPE positions as the reference's ``_token_inputs`` builds them."""
    rcfg, cfg = cfg_pair(arch, **kw)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ref = SyncedRefServer(rcfg, params, slots=2, max_seq=32)
    port = PS.Server(cfg, lm_port_model(cfg, params), slots=2, max_seq=32)
    for srv, mod in ((ref, RS), (port, PS)):
        for rid, prompt in PROMPTS.items():
            srv.submit(mod.Request(rid, np.array(prompt, np.int32), max_new_tokens=5))
    assert dict(port.run_until_drained()) == dict(ref.run_until_drained())


# ---------------------------------------------------------------------------
# Full width: shapes only
# ---------------------------------------------------------------------------


def reference_state_shapes(cfg, tree) -> dict:
    """The port's state-dict names for the reference's parameter pytree
    (``blocks.<i>.<group>.<leaf>`` per layer of each stack), with shapes
    and type names."""
    def entry(s, layer=False):
        return (tuple(s.shape[1:] if layer else s.shape), str(s.dtype))

    out = {"embed.table": entry(tree["embed"]["table"]),
           "final_norm.scale": entry(tree["final_norm"]["scale"])}
    if "w" in tree["lm_head"]:
        out["lm_head.w"] = entry(tree["lm_head"]["w"])
    for group, leaves in tree["blocks"].items():
        for leaf, s in leaves.items():
            assert s.shape[0] == cfg.n_layers
            for i in range(cfg.n_layers):
                out[f"blocks.{i}.{group}.{leaf}"] = entry(s, layer=True)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_config_builds_with_the_reference_shapes(arch):
    """Every weight and cache entry of the full-width config has the
    reference's shape and type (``jax.eval_shape`` against a build under
    ``FakeTensorMode``)."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    tree = jax.eval_shape(lambda k: RT.init_params(k, rcfg), jax.random.PRNGKey(0))
    rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, 2, 1040))
    with FakeTensorMode():
        model = PT.Transformer(cfg, device="cpu")
        got = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in model.state_dict().items()}
        cache = {k: (tuple(v.shape), str(v.dtype)[6:])
                 for k, v in PT.init_cache(cfg, 2, 1040, device="cpu").items()}
    assert got == reference_state_shapes(rcfg, tree)
    assert cache == {k: (v.shape, str(v.dtype)) for k, v in rcache.items()}
