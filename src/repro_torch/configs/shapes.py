"""Assigned input shapes (per-arch shape set for the LM family): a copy of
the reference's ``repro.configs.shapes``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

StepKind = Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: StepKind
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic context handling: runs only for the
# SSM/hybrid archs; the 8 pure full-attention archs skip it.
LONG_CONTEXT_ARCHS = {"zamba2-1.2b", "xlstm-1.3b"}


def applicable_shapes(arch_id: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
