"""granite-moe-1b-a400m — 24L d1024 16H (GQA kv=8) d_ff=512/expert,
MoE 32 experts top-8, vocab 49155. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=32,
    top_k=8,
    rope_theta=10_000.0,
    gated_mlp=True,
    moe_group_size=512,
    train_microbatches=2,
)
