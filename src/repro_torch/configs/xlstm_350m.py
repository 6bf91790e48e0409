"""xLSTM-350M [arXiv:2405.04517; unverified]: 7:1 mLSTM:sLSTM blocks,
no separate FFN (blocks carry their own projections; d_ff=0)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    mlp_kind="none", use_rope=False, mlstm_proj_factor=2,
    microbatch=4,
)
