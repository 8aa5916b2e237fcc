"""stablelm-12b — 40L d5120 32H (GQA kv=8) d_ff=13824, vocab 100352,
parallel attention+FFN residual (stablelm-2 style). [hf:stabilityai]"""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    head_dim=160,
    parallel_residual=True,
    gated_mlp=True,
    rope_theta=10_000.0,
    train_microbatches=8,
)
