"""xlstm-1.3b — 48L d2048 4H, sLSTM + mLSTM blocks, vocab 50304.
[arXiv:2405.04517]

Block mix follows the paper's 7:1 mLSTM:sLSTM ratio — sLSTM at every 8th
position (7, 15, 23, 31, 39, 47). d_ff=0 per the assignment: xLSTM blocks
carry their own up/down projections (expand=2), no separate FFN."""

from repro_torch.models.config import ModelConfig

_SLSTM_AT = {7, 15, 23, 31, 39, 47}
_PATTERN = tuple("slstm" if i in _SLSTM_AT else "mlstm" for i in range(48))

config = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    expand=2,
    block_pattern=_PATTERN,
    train_microbatches=8,
    scan_chunk=512,
    ssm_tp=False,
)
