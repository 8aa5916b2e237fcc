"""zamba2-1.2b — 38L d2048, Mamba2 backbone (ssm_state=64) with a SHARED
attention+MLP block (32H kv=32, d_ff=8192) applied at 5 interleave points.
[arXiv:2411.15242]

Assumption (documented per DESIGN.md): the shared transformer block is
invoked every ~7 backbone layers (positions 6, 13, 20, 27, 34 of the
38-layer stack), one parameter set reused at every application — the
Zamba2 shared-block pattern."""

from repro_torch.models.config import ModelConfig

_ATTN_AT = {6, 13, 20, 27, 34}
_PATTERN = tuple("attn" if i in _ATTN_AT else "mamba" for i in range(38))

config = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    expand=2,
    d_conv=4,
    block_pattern=_PATTERN,
    shared_attn=True,
    rope_theta=10_000.0,
    train_microbatches=8,
)
