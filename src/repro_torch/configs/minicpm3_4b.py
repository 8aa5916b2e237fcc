"""minicpm3-4b — 62L d2560 40H d_ff=6400, vocab 73448, Multi-head Latent
Attention (MLA): q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v=64.
[hf:openbmb/MiniCPM3-4B]

The MLA decode cache stores only the 256-d latent + 32-d rope key per
token — the arch-level interaction with the paper's transmission-cost
model (smaller inter-stage/decode bytes)."""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    head_dim=96,  # qk_nope + qk_rope (bookkeeping only; MLA paths use the split dims)
    gated_mlp=True,
    rope_theta=10_000.0,
    train_microbatches=8,
)
