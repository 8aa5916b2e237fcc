"""Model configuration for all assigned architectures.

One frozen dataclass covers the whole zoo; family-specific fields default
off. Every config in ``repro_torch/configs/`` instantiates this with the
exact published dimensions. A copy of the reference's
``repro.models.config`` (the port imports nothing of ``repro``)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024  # tokens per dispatch group (GShard-style)

    # --- MLA (MiniCPM3 / DeepSeek-V2-style latent attention) ---------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- position encoding --------------------------------------------------
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl (t, h, w)

    # --- residual / block style ---------------------------------------------
    parallel_residual: bool = False  # stablelm-2: attn and mlp share the residual
    gated_mlp: bool = True  # SwiGLU (False -> GELU MLP, e.g. granite-34b)
    tie_embeddings: bool = False

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    # per-layer block kinds; None -> all "attn". e.g. zamba2 mixes "mamba"
    # with a shared "attn" block, xlstm mixes "mlstm"/"slstm".
    block_pattern: tuple[str, ...] | None = None
    shared_attn: bool = False  # zamba2: one shared param set for all attn blocks

    # --- modality frontends (STUBS per assignment) ---------------------------
    frontend: Literal["none", "audio_codes", "vision_embeds"] = "none"
    n_codebooks: int = 0  # musicgen: EnCodec streams

    # --- numerics -------------------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation/param dtype for the big runs
    remat: bool = True  # activation checkpointing per block (training)

    # --- distributed-training knobs (production memory levers) ---------------
    train_microbatches: int = 1  # gradient-accumulation microbatches per step
    remat_group: int = 1  # layers per remat group (boundaries saved = L/group)
    fsdp: bool = False  # shard params over the data axes too (FSDP/ZeRO-3)
    scan_chunk: int = 128  # mamba/mlstm chunk length (state-save granularity)
    pad_vocab_to: int = 256  # pad the LM-head vocab to a multiple (Megatron
    # convention) so logits shard over any TP width; padded slots are
    # masked to -inf and never predicted. 0 disables.
    opt_moments_dtype: str = "float32"  # bf16 halves optimizer HBM (235B arch)
    grad_accum_dtype: str = "float32"  # microbatch grad-accumulation dtype
    kv_cache_dtype: str = "bfloat16"  # "int8" = KIVI-style quantized KV cache
    # (per-token,per-head scales): halves decode-cache HBM vs bf16 — used by
    # the 72B arch whose bf16 cache + params exceed per-chip HBM
    fsdp_inference: bool = False  # FSDP params at serve time (qwen3-moe: the
    # 29 GB model-sharded params force it; dense archs keep TP-only params)

    # --- attention execution -------------------------------------------------
    q_chunk: int = 512  # chunked-attention block sizes (memory-efficient attn)
    kv_chunk: int = 1024
    use_flash_kernel: bool = False  # route attention through the CUDA flash kernel
    mla_absorbed_decode: bool = True  # latent-space MLA decode (perf iteration)
    causal_skip: bool = False  # dynamic-bound kv loop in prefill attention
    # (skips fully-masked causal blocks; forward-only -> serving paths)
    ssm_tp: bool = True  # tensor-parallel SSM/LSTM channels; False = pure-DP
    # mixers (xlstm: 4 heads x 1024-wide matrix memory makes channel-TP emit
    # per-chunk psums that dominate everything — see §Perf H3)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.n_layers, (
                f"block_pattern len {len(self.block_pattern)} != n_layers {self.n_layers}"
            )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        return ("attn",) * self.n_layers

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern:
            if kind in ("attn",):
                if self.use_mla:
                    q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.qk_rope_head_dim
                    )
                    kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    kv += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim
                    )
                    o = self.n_heads * self.v_head_dim * d
                    attn = q + kv + o
                else:
                    attn = (self.n_heads + 2 * self.n_kv_heads) * hd * d
                    attn += self.n_heads * hd * d
                if self.is_moe:
                    ff = self.n_experts * (3 if self.gated_mlp else 2) * d * self.d_ff
                    ff += d * self.n_experts
                else:
                    ff = (3 if self.gated_mlp else 2) * d * self.d_ff
                total += attn + ff + 2 * d
            elif kind == "mamba":
                di = self.d_inner
                total += d * 2 * di + di * self.d_conv + 2 * di * self.ssm_state + di * d + 2 * d
            elif kind in ("mlstm", "slstm"):
                di = self.d_inner
                total += d * 4 * di + di * d + 2 * d
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.block_pattern is None else len(self._reduced_pattern())),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab=128,
            head_dim=16,
            moe_group_size=32,
            q_chunk=16,
            kv_chunk=32,
            remat=False,
            dtype="float32",
            train_microbatches=1,
            remat_group=1,
            fsdp=False,
            scan_chunk=16,
        )
        if self.is_moe:
            small.update(n_experts=4, top_k=2)
        if self.use_mla:
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16)
        if self.block_pattern is not None:
            small.update(block_pattern=self._reduced_pattern())
        if self.mrope_sections is not None:
            small.update(mrope_sections=(2, 3, 3))
        small.update(overrides)
        return replace(self, **small)

    def _reduced_pattern(self) -> tuple[str, ...]:
        """First occurrences of each distinct kind, preserving order-of-mix."""
        kinds = list(dict.fromkeys(self.block_pattern))
        return tuple(kinds * 2)[:4] if len(kinds) > 1 else tuple(kinds * 2)
