"""granite-34b — 88L d6144 48H MQA (kv=1) d_ff=24576, vocab 49152,
GPT-BigCode-style code model (GELU FFN). [arXiv:2405.04324]

Deepest dense stack of the pool — the pipeline-partitioning showcase."""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    gated_mlp=False,
    rope_theta=10_000.0,
    train_microbatches=16,
    remat_group=2,
    fsdp=True,
    fsdp_inference=False,
)
