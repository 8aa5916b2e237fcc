"""Serving step builders: prefill and decode.

The counterparts of ``make_prefill_step`` and ``make_decode_step`` in the
reference's ``repro.launch.steps``. PyTorch runs eagerly, so a step is a
plain closure; the reference's mesh and sharding builders (``build_cell``,
``abstract_state``) and the train step are not ported."""

from __future__ import annotations

import dataclasses

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)`` -> the last position's logits (B, V),
    or (B, n_codebooks, V) for audio codes. ``batch`` holds ``tokens``,
    ``codes`` or ``embeds`` as the config's frontend takes, and optional
    ``positions`` ((3, B, S) for M-RoPE).

    It runs the uncached forward, so a block pattern's Mamba2 and mLSTM
    blocks take their chunked forms (the SSD kernel on the card).
    Serving prefill has no backward pass, so causal block skipping is on
    (``causal_skip=True``), as in the reference."""
    cfg = dataclasses.replace(cfg, causal_skip=True)

    def prefill_step(params, batch):
        logits, _ = T.forward(cfg, params, batch)
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, inputs, cache)`` -> ``(logits, cache)``."""

    def decode_step(params, inputs, cache):
        return T.serve_step(cfg, params, inputs, cache)

    return decode_step
