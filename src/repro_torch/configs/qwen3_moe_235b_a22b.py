"""qwen3-moe-235b-a22b — 94L d4096 64H (GQA kv=4) head_dim=128,
d_ff=1536/expert, MoE 128 experts top-8, vocab 151936. [hf:Qwen/Qwen3-30B-A3B]

Largest assigned model; the qwen3 family uses an independent head_dim=128
(64 heads x 128 > d_model)."""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    gated_mlp=True,
    moe_group_size=512,
    train_microbatches=16,
    remat_group=2,
    fsdp=True,
    fsdp_inference=True,
    opt_moments_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
)
