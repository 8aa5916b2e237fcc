"""Architecture registry + per-(arch x shape) input specs.

``get_config(arch_id)`` returns the exact published configuration (the
data files are copies of the reference's ``repro/configs/*``);
``input_specs(cfg, shape)`` and ``cache_specs(cfg, shape)`` return
stand-ins for every input and the decode cache of that cell: tensors on
the ``meta`` device with the reference's shapes and types, which allocate
nothing (the counterpart of the reference's ``jax.ShapeDtypeStruct``s,
the dry-run pattern)."""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes  # noqa: F401
from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-7b": "deepseek_7b",
    "stablelm-12b": "stablelm_12b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-34b": "granite_34b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-1.3b": "xlstm_1p3b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config


def effective_microbatches(cfg: ModelConfig, shape: ShapeSpec, dp_size: int = 16) -> int:
    """Microbatch count adapted to the mesh: each microbatch's global batch
    must stay divisible by the DP width (a 2-pod mesh doubles DP, so the
    per-pod microbatch count halves while per-device activations stay
    constant)."""
    if shape.kind != "train":
        return 1
    n = min(cfg.train_microbatches, max(1, shape.global_batch // dp_size))
    while shape.global_batch % n:
        n -= 1
    return max(1, n)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec | str, dp_size: int = 16) -> dict:
    """``meta`` tensors for the step inputs of one (arch x shape) cell.

    train:   {"tokens"/"codes"/"embeds"(+positions), "labels"}, split into
             microbatches as (N, B/N, ...) when N > 1 (vision positions
             (N, 3, B/N, S));
    prefill: model inputs for the full prompt (no cache);
    decode:  one new token + a 0-d int32 "cur_index"; the cache comes
             from :func:`cache_specs`."""
    from repro_torch.models.layers import torch_dtype

    if isinstance(shape, str):
        shape = SHAPES[shape]
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    dt = torch_dtype(cfg.dtype)
    i32 = torch.int32

    # training batches arrive pre-split into microbatches: (N, B/N, ...)
    N = effective_microbatches(cfg, shape, dp_size)
    if N > 1:
        assert B % N == 0, (B, N)
        lead: tuple = (N, B // N)
    else:
        lead = (B,)

    specs: dict = {}
    if cfg.frontend == "audio_codes":
        specs["codes"] = _meta((*lead, S, cfg.n_codebooks), i32)
        if shape.kind == "train":
            specs["labels"] = _meta((*lead, S, cfg.n_codebooks), i32)
    elif cfg.frontend == "vision_embeds":
        specs["embeds"] = _meta((*lead, S, cfg.d_model), dt)
        if shape.kind == "train":
            specs["positions"] = _meta((N, 3, B // N, S), i32) if N > 1 \
                else _meta((3, B, S), i32)
            specs["labels"] = _meta((*lead, S), i32)
        else:
            specs["positions"] = _meta((3, B, S), i32)
    else:
        specs["tokens"] = _meta((*lead, S), i32)
        if shape.kind == "train":
            specs["labels"] = _meta((*lead, S), i32)
    if shape.kind == "decode":
        specs["cur_index"] = _meta((), i32)
        if cfg.frontend == "vision_embeds":
            specs["positions"] = _meta((3, B, 1), i32)
    return specs


def to_meta(tree):
    """A tree of dicts, tuples and lists with every tensor replaced by a
    ``meta`` tensor of its shape and type."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(v) for v in tree)
    return _meta(tuple(tree.shape), tree.dtype)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec | str):
    """``meta`` tensors for the decode cache of one cell: the port's own
    ``init_cache`` built under ``FakeTensorMode`` (nothing allocated), in
    its structure (one stacked dict for a homogeneous stack, a tuple of
    per-layer caches for a block pattern)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_cache

    if isinstance(shape, str):
        shape = SHAPES[shape]
    assert shape.kind == "decode"
    with FakeTensorMode():
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
    return to_meta(cache)
