"""Minitron-8B [arXiv:2407.14679; hf]: pruned Nemotron-4 — GQA(kv=8),
squared-ReLU MLP, huge vocab."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000,
    mlp_kind="relu2",
    microbatch=4,
)
