"""Architecture configuration schema + the assigned input-shape grid."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # block pattern, cycled; optional non-repeating tail (pattern+tail
    # must cover n_layers).  types: global|local|rec|m|s
    pattern: Tuple[str, ...] = ("global",)
    tail: Tuple[str, ...] = ()

    # attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # chatglm 2d-rope = 0.5
    use_rope: bool = True
    window: int = 4096              # local-attention window
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0

    # mlp
    mlp_kind: str = "swiglu"        # swiglu|geglu|gelu|relu2|none

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25

    # recurrent (rglru / xlstm)
    rnn_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: int = 2

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500             # encoder frames for decode shapes

    # input
    input_kind: str = "tokens"      # tokens|embeds|encdec
    scale_embed: bool = False       # gemma-style sqrt(d) embedding scale
    post_norm: bool = False         # gemma2 sandwich norms

    # systems
    dtype: str = "bfloat16"
    fsdp: bool = False              # shard params over data axis too
    remat: bool = True
    microbatch: int = 2             # grad-accumulation microbatches
    scan_layers: bool = True        # False: unroll (roofline probes)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return (self.vocab + 255) // 256 * 256

    @property
    def layer_types(self) -> Tuple[str, ...]:
        reps = (self.n_layers - len(self.tail)) // len(self.pattern)
        return self.pattern * reps + self.tail

    def n_groups(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    def validate(self) -> None:
        body = self.n_layers - len(self.tail)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: pattern does not tile layers")
        if self.q_dim % self.n_kv_heads * 0:  # placeholder sanity
            pass
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    def reduced(self, n_layers=2, d_model=64, n_heads=4, n_kv_heads=None,
                d_ff=128, vocab=512, **kw) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kv = n_kv_heads or max(1, min(self.n_kv_heads, n_heads))
        upd = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=kv, head_dim=d_model // n_heads,
            d_ff=0 if self.d_ff == 0 else d_ff, vocab=vocab,
            window=min(self.window, 32),
            rnn_width=0 if self.rnn_width == 0 else d_model,
            n_experts=0 if self.n_experts == 0 else 4,
            top_k=0 if self.top_k == 0 else min(self.top_k, 2),
            capacity_factor=8.0,   # no drops in smoke tests (drop
                                   # behaviour is unit-tested separately)
            n_shared_experts=min(self.n_shared_experts, 1),
            shared_ff=0 if self.shared_ff == 0 else d_ff,
            enc_layers=0 if self.enc_layers == 0 else 2,
            enc_seq=32,
            dtype="float32", fsdp=False, remat=False, microbatch=1,
        )
        # keep pattern structure but shrink the repetition count
        pat, tail = self.pattern, self.tail
        body = n_layers - len(tail)
        if body <= 0 or body % len(pat):
            n_layers = len(pat) + len(tail)
            upd["n_layers"] = n_layers
        upd.update(kw)
        return dataclasses.replace(self, **upd)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k applicability (DESIGN.md §5): sub-quadratic archs only.
LONG_CONTEXT_ARCHS = ("xlstm-350m", "recurrentgemma-2b")
