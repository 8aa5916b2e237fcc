"""deepseek-7b — 30L d4096 32H (MHA kv=32) d_ff=11008, vocab 102400,
llama architecture (SwiGLU, RoPE). [arXiv:2401.02954]"""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    head_dim=128,
    gated_mlp=True,
    rope_theta=10_000.0,
    train_microbatches=8,
)
