"""The port's dense decoder against the reference's, on the CPU.

deepseek-7b reduced (2 layers, d 64, 4 heads of 16, float32), as MHA and
as GQA (``n_kv_heads=2``), with the flash kernel's branch on (prompts of
12 tokens > 8, so prefill takes it; on the CPU its plain version runs)
and off (chunked attention). The weights come from the reference's
``init_params(PRNGKey(0))`` (jitted) and are carried across by
``convert.lm_params_from_reference``. Compared: ``make_prefill_step``,
``prefill`` into a cache, then 8 greedy ``serve_step``s.

Tolerances. float32: ``rtol 1e-4, atol 1e-5`` on the logits (std ~0.15):
the same arithmetic summed in another order gives ~3e-7. bfloat16: max
abs error <= 0.1 x the reference logits' std (about four bfloat16 ulps at
the logits' largest magnitude): the two frameworks round intermediate
bfloat16 results at different places. Greedy tokens must be equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

P, B, MAX_SEQ, N_DECODE = 12, 2, 32, 8
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def configs(flash: bool, **kw):
    ref = dataclasses.replace(ref_get_config("deepseek-7b").reduced(**kw),
                              use_flash_kernel=flash)
    port = dataclasses.replace(get_config("deepseek-7b").reduced(**kw),
                               use_flash_kernel=flash)
    return ref, port


# the reference's init, jitted (its eager run takes seconds per config)
ref_init_params = jax.jit(RT.init_params, static_argnums=1)


def port_model(cfg, ref_params):
    sd = convert.lm_params_from_reference(cfg, jax.tree.map(np.asarray, ref_params))
    model = PT.Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


def prompt(cfg, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(B, P)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference_run(n_kv_heads: int, flash: bool):
    """The reference's prefill step, cached prefill and greedy decode."""
    rcfg, _ = configs(flash, n_kv_heads=n_kv_heads)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    toks = jnp.asarray(prompt(rcfg))
    step_logits = np.asarray(jax.jit(ref_prefill_step(rcfg))(params, {"tokens": toks}))
    fwd = jax.jit(functools.partial(RT.forward, rcfg))
    logits, cache = fwd(params, {"tokens": toks}, RT.init_cache(rcfg, B, MAX_SEQ))
    steps = [np.asarray(logits)]
    tokens = []
    for i in range(N_DECODE):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        tokens.append(np.asarray(tok))
        logits, cache = fwd(params, {"tokens": tok[:, None],
                                     "cur_index": jnp.int32(P + i)}, cache)
        steps.append(np.asarray(logits))
    return params, step_logits, steps, tokens


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_prefill_step_matches_reference(n_kv_heads, flash):
    params, want, _, _ = reference_run(n_kv_heads, flash)
    _, cfg = configs(flash, n_kv_heads=n_kv_heads)
    got = make_prefill_step(cfg)(port_model(cfg, params),
                                 {"tokens": torch.from_numpy(prompt(cfg))})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_cached_prefill_and_decode_match_reference(n_kv_heads, flash):
    params, _, want_steps, want_tokens = reference_run(n_kv_heads, flash)
    _, cfg = configs(flash, n_kv_heads=n_kv_heads)
    model = port_model(cfg, params)
    cache = PT.init_cache(cfg, B, MAX_SEQ, device="cpu")
    logits, cache = PT.prefill(cfg, model, {"tokens": torch.from_numpy(prompt(cfg))},
                               cache)
    np.testing.assert_allclose(logits.numpy(), want_steps[0], **F32_TOL)
    decode = make_decode_step(cfg)
    for i in range(N_DECODE):
        tok = logits[:, -1].argmax(dim=-1)
        np.testing.assert_array_equal(tok.numpy(), want_tokens[i])
        logits, cache = decode(model, {"tokens": tok[:, None], "cur_index": P + i}, cache)
        np.testing.assert_allclose(logits.numpy(), want_steps[i + 1], **F32_TOL)


def test_bf16_prefill_step_matches_reference():
    rcfg, cfg = configs(True, dtype="bfloat16")
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    toks = prompt(cfg, seed=1)
    want = np.asarray(jax.jit(ref_prefill_step(rcfg))(params, {"tokens": jnp.asarray(toks)}))
    model = port_model(cfg, params)
    assert model.embed.table.dtype == torch.bfloat16
    got = make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)}).numpy()
    real = slice(0, cfg.vocab)  # padded slots are -1e30 on both sides
    np.testing.assert_array_equal(got[:, cfg.vocab:], want[:, cfg.vocab:])
    err = np.abs(got[:, real] - want[:, real]).max()
    assert err <= 0.1 * want[:, real].std(), err


def test_granite_mqa_gelu_prefill_step_matches_reference():
    """granite-34b reduced: MQA (one kv head) and the GELU MLP."""
    rcfg = dataclasses.replace(ref_get_config("granite-34b").reduced(), use_flash_kernel=True)
    cfg = dataclasses.replace(get_config("granite-34b").reduced(), use_flash_kernel=True)
    assert (cfg.n_kv_heads, cfg.gated_mlp) == (1, False)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    toks = prompt(cfg, seed=2)
    want = np.asarray(jax.jit(ref_prefill_step(rcfg))(params, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(cfg)(port_model(cfg, params), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("S,pos", [
    (1, [[3], [-1], [0], [9]]),   # per-row decode writes; -1 writes nothing
    (1, [[12], [-1], [-1], [2]]),  # 12 is past the cache: nothing either
    (4, [[2, 3, 4, 5]] * 4),       # prefill: one slice from pos_ids[0, 0]
    (4, [[9, 10, 11, 12]] * 4),    # clamped to the end, as the reference does
])
def test_cache_write_matches_the_reference_writer(S, pos):
    from repro.models.layers import _cache_writer

    rng = np.random.RandomState(S)
    cache = rng.standard_normal((4, 10, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, S, 2, 3)).astype(np.float32)
    pos = np.array(pos, np.int32)
    want = _cache_writer(jnp.asarray(pos), S, 10)(jnp.asarray(cache), jnp.asarray(new))
    got = torch.from_numpy(cache.copy())
    PL.cache_write(got, torch.from_numpy(new), torch.from_numpy(pos), int(pos[0, 0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_runs_launch_no_kernel():
    _, cfg = configs(True)
    FA.reset_launch_count()
    model = PT.init_params(cfg, device="cpu")
    make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(prompt(cfg))})
    assert FA.FLASH_LAUNCHES == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_equal_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))


def test_full_width_deepseek_shape():
    cfg = get_config("deepseek-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.dtype) == (30, 4096, 32, 32, 128, 11008, 102400,
                                                "bfloat16")
    PT.check_supported(cfg)


def test_state_dict_conversion_is_complete():
    rcfg, cfg = configs(True, n_kv_heads=2)
    sd = convert.lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg)))
    model = PT.Transformer(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, name


def test_init_params_follows_the_reference_distribution():
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(), d_model=256,
                              d_ff=512, vocab=512)
    gen = torch.Generator().manual_seed(3)
    model = PT.init_params(cfg, generator=gen, device="cpu")
    attn, ff = model.blocks[0].attn, model.blocks[0].ff
    d, hdh = cfg.d_model, cfg.n_heads * cfg.head_dim
    for w, want in ((attn.wq, d ** -0.5), (attn.wo, hdh ** -0.5),
                    (ff.w_in, d ** -0.5), (ff.w_out, cfg.d_ff ** -0.5),
                    (model.embed.table, 0.02), (model.lm_head.w, 0.02)):
        assert abs(float(w.std()) / want - 1) < 0.05
        assert abs(float(w.mean())) < 0.05 * want
    assert torch.equal(model.final_norm.scale, torch.ones(d))
    again = PT.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again.blocks[1].ff.w_gate, model.blocks[1].ff.w_gate)


# The features and configs the port once refused, on deepseek-7b reduced
# with the feature on (sized as ``reduced()`` sizes it) or on a config's
# own ``reduced()`` with its overrides; a tied head needs vocab == its
# padded size. The block patterns (zamba2: Mamba2 with the shared
# attention block, or with an attention stack; xlstm: mLSTM and sLSTM; a
# Mamba2-only stack) feed their prompt token by token through
# ``serve_step`` (``torch_parity.streams_prompt``).
PORTED = {
    "use_mla": ("deepseek-7b", dict(use_mla=True, q_lora_rank=32, kv_lora_rank=16,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)),
    "is_moe": ("deepseek-7b", dict(n_experts=4, top_k=2)),
    "mrope_sections": ("deepseek-7b", dict(mrope_sections=(2, 3, 3))),
    "kv_cache_dtype": ("deepseek-7b", dict(kv_cache_dtype="int8")),
    "parallel_residual": ("deepseek-7b", dict(parallel_residual=True)),
    "frontend": ("deepseek-7b", dict(frontend="audio_codes", n_codebooks=4)),
    "tie_embeddings": ("deepseek-7b", dict(tie_embeddings=True, vocab=256)),
    "minicpm3-4b": ("minicpm3-4b", {}), "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", {}),
    "qwen2-vl-72b": ("qwen2-vl-72b", {}), "stablelm-12b": ("stablelm-12b", {}),
    "musicgen-medium": ("musicgen-medium", {}),
    "zamba2-1.2b": ("zamba2-1.2b", {}), "xlstm-1.3b": ("xlstm-1.3b", {}),
    "zamba2-unshared-attn": ("zamba2-1.2b", dict(shared_attn=False)),
    "mamba-only": ("zamba2-1.2b", dict(n_layers=3, block_pattern=("mamba",) * 3)),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_feature_builds_and_matches_the_reference(name):
    """The model builds with the feature (or config) and, on the
    reference's weights, matches its uncached forward, prefill step,
    cached prefill (or the prompt streamed through ``serve_step``) and 2
    greedy ``serve_step``s and final cache
    (``torch_parity.assert_lm_runs_match``: rtol 1e-4, atol 1e-5)."""
    from torch_parity import assert_lm_runs_match, lm_port_model, lm_port_run, lm_reference_run

    arch, kw = PORTED[name]
    rcfg, cfg = (dataclasses.replace(c.reduced(**kw), use_flash_kernel=True)
                 for c in (ref_get_config(arch), get_config(arch)))
    PT.check_supported(cfg)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ref = lm_reference_run(rcfg, params, n_decode=2)
    model = lm_port_model(cfg, params)
    if name == "tie_embeddings":
        assert "lm_head.w" not in model.state_dict() and not params["lm_head"]
    if name == "zamba2-unshared-attn":
        assert set(params["blocks"]) == {"mamba", "attn"}
    assert_lm_runs_match(lm_port_run(cfg, model, ref), ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_is_supported(arch):
    """``check_supported`` refuses none of the repo's configs; the port's
    model of each is homogeneous exactly where the reference's is."""
    cfg = get_config(arch)
    PT.check_supported(cfg)
    assert PT.is_homogeneous(cfg) == RT._is_homogeneous(ref_get_config(arch))


def test_unknown_block_kind_raises_as_the_reference():
    rcfg, cfg = (dataclasses.replace(c.reduced(), n_layers=2, block_pattern=("mamba", "conv"))
                 for c in (ref_get_config("zamba2-1.2b"), get_config("zamba2-1.2b")))
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        RT.init_params(jax.random.PRNGKey(0), rcfg)
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        PT.Transformer(cfg, device="cpu")


def test_tied_head_refuses_a_padded_vocab():
    """The reference's tied head cannot mask padded slots (its logits
    have ``vocab`` columns); the port refuses such a config when built."""
    rcfg, cfg = (dataclasses.replace(c.reduced(), tie_embeddings=True)
                 for c in (ref_get_config("deepseek-7b"), get_config("deepseek-7b")))
    assert cfg.vocab_padded != cfg.vocab
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    with pytest.raises((TypeError, ValueError)):
        RT.forward(rcfg, params, {"tokens": jnp.zeros((1, 4), jnp.int32)})
    with pytest.raises(ValueError, match="tie_embeddings"):
        PT.Transformer(cfg, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("deepseek-7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PT.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PT.init_cache(cfg, 1, 8)
