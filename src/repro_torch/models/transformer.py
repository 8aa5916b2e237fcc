"""Decoder-only LM: the dense, homogeneous stack of the reference's
``repro.models.transformer`` (deepseek-7b and the other dense-attention
configs), in PyTorch.

:class:`Transformer` holds the weights: an embedding, a ``ModuleList`` of
pre-norm blocks (RMSNorm, GQA attention, RMSNorm, MLP, two residuals) and
a final norm with the LM head. There is no ``lax.scan``: the blocks run in
a Python loop. The reference's functional entry points keep their names
and take the module as ``params``:

* :func:`forward` ``(cfg, params, inputs, cache)`` -> ``(logits, cache)``;
* :func:`prefill` and :func:`serve_step` run it with a cache;
* :func:`init_params` makes a module of random weights from a seeded
  ``torch.Generator``; :func:`init_cache` a dense ``{"k", "v"}`` cache of
  shape (L, B, Smax, Hkv, Dh).

The cache is updated IN PLACE and returned (the reference returns a new
one): a full-width cache is too large to copy per step.

Features outside this slice raise ``NotImplementedError`` by name
(:func:`check_supported`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Attention,
    Embed,
    LMHead,
    RMSNorm,
    torch_dtype,
)

__all__ = ["Transformer", "check_supported", "forward", "init_cache",
           "init_params", "prefill", "serve_step"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first feature of ``cfg``
    that the port's model does not run."""
    unported = [
        ("use_mla", cfg.use_mla),
        ("is_moe", cfg.is_moe),
        ("block_pattern", any(k != "attn" for k in cfg.pattern)),
        ("shared_attn", cfg.shared_attn),
        ("mrope_sections", cfg.mrope_sections is not None),
        ('kv_cache_dtype="int8"', cfg.kv_cache_dtype == "int8"),
        ("parallel_residual", cfg.parallel_residual),
        ("tie_embeddings", cfg.tie_embeddings),
        (f"frontend={cfg.frontend!r}", cfg.frontend != "none"),
    ]
    for name, used in unported:
        if used:
            raise NotImplementedError(
                f"{cfg.name}: {name} is not ported to repro_torch yet; the "
                f"port runs the dense attention stack only")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.d_model, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, **kw)
        self.ff = MLP(cfg, **kw)

    def forward(self, cfg: ModelConfig, x, positions, cache=None, offset: int = 0):
        x = x + self.attn(cfg, self.norm1(x, cfg.norm_eps), positions, cache, offset)
        return x + self.ff(self.norm2(x, cfg.norm_eps))


class Transformer(nn.Module):
    """The weights of one dense decoder. ``forward(cfg, inputs, cache)``
    takes the config per call, so a step may run with its own settings
    (``make_prefill_step`` turns on ``causal_skip``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=resolve_device(device), dtype=dtype or torch_dtype(cfg.dtype))
        self.embed = Embed(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.lm_head = LMHead(cfg, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    @torch.no_grad()
    def forward(self, cfg: ModelConfig, inputs: dict, cache: dict | None = None):
        dev = self.device
        tokens = torch.as_tensor(inputs["tokens"], device=dev).long()
        x = self.embed(tokens)
        B, S = tokens.shape
        positions = inputs.get("positions")
        if positions is None:
            offset = int(inputs.get("cur_index", 0))
            positions = (offset + torch.arange(S, dtype=torch.int32, device=dev)
                         ).expand(B, S)
        else:
            positions = torch.as_tensor(positions, device=dev).to(torch.int32)
            # the prefill cache write's offset (one host read per call)
            offset = int(positions[0, 0]) if cache is not None and S > 1 else 0
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else {"k": cache["k"][i],
                                                      "v": cache["v"][i]}
            x = block(cfg, x, positions, layer_cache, offset)
        x = self.final_norm(x, cfg.norm_eps)
        return self.lm_head(x), cache


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (default: the card) with the
    reference's init distribution: projections normal / sqrt(fan_in), the
    attention output normal / sqrt(H*Dh), embedding and head normal *
    0.02, norm scales one. ``generator`` must live on ``device``
    (default: a fresh one seeded 0)."""
    model = Transformer(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    model.init_weights(generator)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, device=None) -> dict:
    """Dense decode cache ``{"k", "v"}``, each (L, B, Smax, Hkv, Dh) zeros
    of ``dtype`` (default: the config's activation type)."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=dtype or torch_dtype(cfg.dtype), device=resolve_device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def forward(cfg: ModelConfig, params: Transformer, inputs: dict,
            cache: dict | None = None):
    """``(logits, cache)``. ``inputs``: ``tokens`` (B, S) int, optional
    ``positions`` (B, S) (default ``cur_index + arange(S)``) and
    ``cur_index``. Logits are float32 over the padded vocab."""
    return params(cfg, inputs, cache)


def serve_step(cfg: ModelConfig, params: Transformer, inputs: dict, cache: dict):
    """One decode step: new token(s) + cache -> next-token logits + cache."""
    return forward(cfg, params, inputs, cache)


def prefill(cfg: ModelConfig, params: Transformer, inputs: dict, cache: dict):
    """Prefill a prompt into the cache; attention reads the whole cache."""
    return forward(cfg, params, inputs, cache)
