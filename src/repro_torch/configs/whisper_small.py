"""Whisper-small [arXiv:2212.04356; unverified]: 12L enc + 12L dec,
conv/mel frontend STUBBED (precomputed frame embeddings), MHA, GELU."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    enc_layers=12, enc_seq=1500,
    mlp_kind="gelu", use_rope=False, input_kind="encdec",
    microbatch=4,
)
