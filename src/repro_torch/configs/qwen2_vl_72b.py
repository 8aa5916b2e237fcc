"""qwen2-vl-72b — 80L d8192 64H (GQA kv=8) d_ff=29568, vocab 152064,
M-RoPE (t/h/w sections 16/24/24 over head_dim 128), dynamic resolution.
[arXiv:2409.12191]

The vision frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch/text embeddings (B, S, d_model) plus the (3, B, S)
M-RoPE position streams."""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    frontend="vision_embeds",
    mrope_sections=(16, 24, 24),
    gated_mlp=True,
    rope_theta=1_000_000.0,
    train_microbatches=16,
    remat_group=2,
    fsdp=True,
    fsdp_inference=True,
    kv_cache_dtype="int8",
)
