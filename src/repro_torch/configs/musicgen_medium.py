"""musicgen-medium — 48L d1536 24H (kv=24) d_ff=6144, decoder-only over
EnCodec tokens: 4 codebooks x vocab 2048, delay interleaving.
[arXiv:2306.05284]

The EnCodec frontend is a STUB per the assignment: inputs are the (B, S, 4)
codebook-token grid; the frame embedding is the sum of per-codebook
embeddings and the head predicts all 4 streams."""

from repro_torch.models.config import ModelConfig

config = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    head_dim=64,
    frontend="audio_codes",
    n_codebooks=4,
    gated_mlp=False,  # standard GELU FFN (d_ff = 4 d_model)
    rope_theta=10_000.0,
    train_microbatches=8,
)
