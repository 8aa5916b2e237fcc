"""The audio-codes path of the port against the reference's, on the CPU.

``repro_torch.models.audio`` (MusicGen's delay pattern) must equal
``repro.models.audio`` with ``==`` on every shape and pad id tried. The
musicgen frontend: codes (B, S, 4) embed as the sum of one table per
codebook (rows ``k * vocab`` on), within rtol 1e-6 of the reference (a
float32 sum of four rows in another order); the head gives (B, S, 4, Vp)
float32 logits, padded slots -1e30 on both sides. A delayed prompt through
the reduced musicgen model (2 layers, d 64, vocab 128 padded to 256, the
reference's weights) matches the reference within rtol 1e-4, atol 1e-5."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import audio as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import audio as PA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from torch_parity import LM_F32_TOL, lm_port_model

SHAPES = [(1, 3, 2), (2, 5, 4), (3, 1, 4), (1, 7, 1), (2, 16, 4)]  # (B, T, K)

ref_init_params = jax.jit(RT.init_params, static_argnums=1)


def codes(B, T, K, seed=0, vocab=2048):
    return np.random.RandomState(seed).randint(0, vocab, (B, T, K)).astype(np.int32)


@pytest.mark.parametrize("pad", [-1, 2048])
@pytest.mark.parametrize("B,T,K", SHAPES)
def test_delay_pattern_equals_reference(B, T, K, pad):
    c = codes(B, T, K)
    want = np.asarray(RA.delay_pattern(jnp.asarray(c), pad))
    got = PA.delay_pattern(torch.from_numpy(c), pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,T,K", SHAPES)
def test_undelay_pattern_equals_reference_and_inverts(B, T, K):
    c = codes(B, T, K, seed=1)
    delayed = np.array(RA.delay_pattern(jnp.asarray(c), -1))
    want = np.asarray(RA.undelay_pattern(jnp.asarray(delayed), T))
    got = PA.undelay_pattern(torch.from_numpy(delayed), T).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, c)


@pytest.mark.parametrize("T,K", [(1, 1), (3, 2), (5, 4), (16, 4), (2, 6)])
def test_delay_mask_equals_reference(T, K):
    want = np.asarray(RA.delay_mask(T, K))
    got = PA.delay_mask(T, K).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    # the mask marks exactly the slots the delay pattern fills
    delayed = PA.delay_pattern(torch.zeros((1, T, K), dtype=torch.int32), -1)[0]
    np.testing.assert_array_equal((delayed != -1).numpy(), got)


def test_codes_embed_and_head_match_reference():
    cfg = get_config("musicgen-medium").reduced()
    rcfg = ref_get_config("musicgen-medium").reduced()
    rng = np.random.RandomState(2)
    table = rng.standard_normal((cfg.n_codebooks * cfg.vocab, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.n_codebooks * cfg.vocab_padded)).astype(np.float32)
    c = codes(2, 9, cfg.n_codebooks, seed=3, vocab=cfg.vocab)

    embed = PL.Embed(cfg, device="cpu", dtype=torch.float32)
    embed.load_state_dict({"table": torch.from_numpy(table)})
    want = np.asarray(RL.apply_embed(rcfg, {"table": jnp.asarray(table)}, jnp.asarray(c)))
    got = embed(torch.from_numpy(c).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    head = PL.LMHead(cfg, device="cpu", dtype=torch.float32)
    head.load_state_dict({"w": torch.from_numpy(w)})
    want = np.asarray(RL.apply_lm_head(rcfg, {"w": jnp.asarray(w)}, jnp.asarray(want)))
    got = head(got).numpy()
    assert got.shape == (2, 9, cfg.n_codebooks, cfg.vocab_padded) == want.shape
    assert (got[..., cfg.vocab:] == -1e30).all() and (want[..., cfg.vocab:] == -1e30).all()
    np.testing.assert_allclose(got, want, **LM_F32_TOL)


def test_delayed_prompt_through_musicgen_matches_reference():
    """A (1, 10, 4) frame grid delayed to (1, 13, 4) (pad id 0, a real
    code), prefilled into a cache and decoded two frames greedily per
    codebook: logits (1, S, 4, Vp) match the reference's."""
    rcfg = dataclasses.replace(ref_get_config("musicgen-medium").reduced(),
                               use_flash_kernel=True)
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(), use_flash_kernel=True)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    model = lm_port_model(cfg, params)
    delayed = np.array(RA.delay_pattern(jnp.asarray(codes(1, 10, 4, 4, cfg.vocab)), 0))
    fwd = jax.jit(functools.partial(RT.forward, rcfg), static_argnames="decode")
    rcache = RT.init_cache(rcfg, 1, 16)
    pcache = PT.init_cache(cfg, 1, 16, device="cpu")
    feed = delayed
    for i in range(3):
        at = 0 if i == 0 else 12 + i  # the prompt's 13 rows, then one frame a step
        want, rcache = fwd(params, {"codes": jnp.asarray(feed), "cur_index": at}, rcache,
                           decode=i > 0)
        run = PT.serve_step if i else PT.prefill
        got, pcache = run(cfg, model, {"codes": torch.from_numpy(feed), "cur_index": at},
                          pcache)
        assert got.shape == (1, feed.shape[1], 4, cfg.vocab_padded)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_F32_TOL)
        feed = got[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)  # (1, 1, 4)
        np.testing.assert_array_equal(feed, np.asarray(want)[:, -1].argmax(-1)[:, None])
