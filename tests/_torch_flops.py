"""The analytic FLOPs of one step of a dense decoder — the count the
dry-run's per-device share (``loop_aware.flops`` less
``replicated.flops``) is held against, with no JAX import, so the card
tests use it too.

Dots only, as the cost counter counts: each layer's q, k, v and o
projections and its MLP (three matrices for a gated one, two
otherwise), 2 FLOPs a multiply-add; the LM head on the positions whose
logits the step returns (the last of a prefill, the one of a decode);
attention 4 FLOPs a head dim a (query, key) pair — Q K^T and P V —
over the pairs the flash kernel's mask lets through in a prefill
(the card's route) and over the whole cache buffer in a decode (a local
layer's ring of ``window`` slots, a global layer's ``seq_len``).
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import visible_pairs


def dense_step_flops(cfg, shape) -> int:
    """Global FLOPs of one prefill or decode step of ``cfg`` (a dense
    decoder: attention layers only) at ``shape``."""
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"no analytic count for a {shape.kind} step")
    if any(lt not in ("global", "local") for lt in cfg.layer_types):
        raise ValueError(f"{cfg.name}: not a dense decoder")
    d, b, s = cfg.d_model, shape.global_batch, shape.seq_len
    nmat = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    layer = 2 * d * (2 * cfg.q_dim + 2 * cfg.kv_dim) \
        + 2 * nmat * d * cfg.d_ff
    tokens = b * s if shape.kind == "prefill" else b
    total = tokens * cfg.n_layers * layer + b * 2 * d * cfg.padded_vocab
    for lt in cfg.layer_types:
        window = cfg.window if lt == "local" else 0
        if shape.kind == "prefill":
            pairs = visible_pairs(s, s, True, window)
        else:
            pairs = min(window, s) if window else s
        total += 4 * b * cfg.n_heads * cfg.head_dim * pairs
    return total
