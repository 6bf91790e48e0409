"""Decoder-LM assembly for the dense family: pattern-grouped blocks,
embedding, head, loss; train / prefill / decode paths with dict caches —
the port's counterpart of the JAX package's ``models/transformer.py``
for layer types ``global`` and ``local`` with the dense MLP slot.

The params and cache trees keep the JAX package's layout: every block
leaf has a leading *pattern group* axis (``params["blocks"]["b0"]["wq"]``
is ``(G, d, q_dim)``), so weights map 1:1
(:func:`repro_torch.convert.model_params_from_jax`).  Where the JAX
package scans the groups with ``lax.scan``, the port loops over them in
Python, each group reading views of the stacked leaves.

Differences of form, not of function:

- the cache's ``pos`` is a Python int (the JAX package keeps an int32
  scalar), so a decode step computes its cache slot without reading the
  card;
- :func:`prefill` writes the prompt's keys and values into a zeroed
  cache and :func:`decode_step` writes one slot of it in place (the JAX
  package returns updated copies); the returned cache holds the same
  values, and the cache passed in is marked consumed (``pos`` None), so
  reusing it raises.

Recurrent (``rec``), xLSTM (``m``, ``s``) and MoE layers raise
``NotImplementedError``: they are later slices of the port (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..tree import tree_map
from . import layers as L

__all__ = ["init_params", "init_cache", "forward_train", "loss_fn",
           "prefill", "decode_step", "check_supported", "param_dtype"]

_LATER = ("is not in this slice of the PyTorch port (ROADMAP Queue 1 "
          "item 6: models and co-serving)")


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense decoder:
    layer types ``global``/``local`` only, no experts, token or embedding
    input."""
    other = sorted(set(cfg.layer_types) - {"global", "local"})
    if other:
        raise NotImplementedError(f"{cfg.name}: layer types {other} {_LATER}")
    if cfg.n_experts > 0:
        raise NotImplementedError(f"{cfg.name}: MoE layers {_LATER}")
    if cfg.input_kind == "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder "
                                  f"(Whisper) {_LATER}")


# --------------------------------------------------------------------------
# Per-block init
# --------------------------------------------------------------------------

def init_block(gen: torch.Generator, ltype: str,
               cfg: ArchConfig) -> Dict[str, Any]:
    if ltype not in ("global", "local"):
        raise NotImplementedError(f"layer type {ltype!r} {_LATER}")
    if cfg.n_experts > 0:
        raise NotImplementedError(f"MoE layers {_LATER}")
    dt, d, dev = param_dtype(cfg), cfg.d_model, gen.device
    p: Dict[str, Any] = {
        "norm_in": torch.zeros((d,), dtype=torch.float32, device=dev),
        "wq": L.dense_init(gen, d, cfg.q_dim, dt),
        "wk": L.dense_init(gen, d, cfg.kv_dim, dt),
        "wv": L.dense_init(gen, d, cfg.kv_dim, dt),
        "wo": L.dense_init(gen, cfg.q_dim, d, dt),
    }
    if cfg.post_norm:
        p["norm_post"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    if cfg.mlp_kind != "none":
        p["norm_mlp"] = torch.zeros((d,), dtype=torch.float32, device=dev)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dt)
        if cfg.post_norm:
            p["norm_mlp_post"] = torch.zeros((d,), dtype=torch.float32,
                                             device=dev)
    return p


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def init_block_cache(ltype: str, cfg: ArchConfig, batch: int, max_len: int,
                     device, groups: int = 0) -> Dict[str, Any]:
    """A block's zeroed KV cache; ``groups`` > 0 adds the leading group
    axis."""
    lead = (groups,) if groups else ()
    if ltype == "global":
        length = max_len
    elif ltype == "local":
        length = min(cfg.window, max_len)
    else:
        raise NotImplementedError(f"layer type {ltype!r} {_LATER}")
    shape = lead + (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=param_dtype(cfg), device=device)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    g = cfg.n_groups()
    cache: Dict[str, Any] = {
        "blocks": {f"b{i}": init_block_cache(lt, cfg, batch, max_len, device,
                                             groups=g)
                   for i, lt in enumerate(cfg.pattern)},
        "pos": 0}
    for i, lt in enumerate(cfg.tail):
        cache[f"tail{i}"] = init_block_cache(lt, cfg, batch, max_len, device)
    return cache


# --------------------------------------------------------------------------
# Per-block forward
# --------------------------------------------------------------------------

def _attn_block(p, x, ltype, cfg: ArchConfig, mode, positions, pos, cache):
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm_in"])
    q = L.matmul(h, p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.matmul(h, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.matmul(h, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    window = cfg.window if ltype == "local" else 0

    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        wlen = ck.shape[1]
        if ltype == "local":
            slot, kv_len = pos % wlen, min(pos + 1, wlen)
        else:
            # dynamic_update_slice clamps a start past the end
            slot, kv_len = min(pos, wlen - 1), pos + 1
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
        out = L.direct_attention(q, ck, cv, causal=False, window=0,
                                 softcap=cfg.attn_softcap, kv_len=kv_len)
    else:
        out = L.attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
        if mode == "prefill":
            w = cache["k"].shape[1]
            if ltype == "local" and s >= w:
                # keep the last `w` keys in ring order: key at position p
                # lives in slot p % w  ->  roll the tail by s % w.
                cache["k"].copy_(torch.roll(k[:, -w:], s % w, dims=1))
                cache["v"].copy_(torch.roll(v[:, -w:], s % w, dims=1))
            else:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v

    out = L.matmul(out.reshape(b, s, cfg.q_dim), p["wo"])
    if cfg.post_norm:
        out = L.rms_norm(out, p["norm_post"])
    return x + out


def _mlp_slot(p, x, cfg: ArchConfig):
    if "norm_mlp" not in p:
        return x
    h = L.rms_norm(x, p["norm_mlp"])
    out = L.mlp_forward(p["mlp"], h, cfg.mlp_kind)
    if cfg.post_norm:
        out = L.rms_norm(out, p["norm_mlp_post"])
    return x + out


def block_apply(ltype: str, p, x, cfg: ArchConfig, mode: str, positions,
                pos, cache):
    if ltype not in ("global", "local"):
        raise NotImplementedError(f"layer type {ltype!r} {_LATER}")
    x = _attn_block(p, x, ltype, cfg, mode, positions, pos, cache)
    return _mlp_slot(p, x, cfg)


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """Random params drawn from ``gen`` on its device: per pattern group
    (stacked on a leading group axis), then the embedding, the head and
    the tail blocks."""
    check_supported(cfg)
    dt, dev = param_dtype(cfg), gen.device
    groups = [{f"b{i}": init_block(gen, lt, cfg)
               for i, lt in enumerate(cfg.pattern)}
              for _ in range(cfg.n_groups())]
    stacked = tree_map(lambda *ls: torch.stack(ls), *groups)
    del groups
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
        "norm_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                              device=dev),
        "blocks": stacked,
    }
    for i, lt in enumerate(cfg.tail):
        params[f"tail{i}"] = init_block(gen, lt, cfg)
    return params


def _embed_in(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    dt = param_dtype(cfg)
    if cfg.input_kind == "embeds":
        x = batch["embeds"].to(dt)
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.scale_embed:
        # a float32 scalar: a bf16 activation is promoted, then cast back
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return x.to(dt)


def _head_out(params, x, cfg: ArchConfig):
    x = L.rms_norm(x, params["norm_f"])
    logits = L.matmul(x, params["head"]).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _stack_apply(params, x, cfg: ArchConfig, mode: str, positions, pos,
                 cache):
    """The pattern groups in order, each reading its slice of the stacked
    params (and cache), then the tail.  In train mode no cache is
    threaded (``cache`` may be None)."""
    train = mode == "train"
    for gi in range(cfg.n_groups()):
        for i, lt in enumerate(cfg.pattern):
            name = f"b{i}"
            gp = tree_map(lambda t: t[gi], params["blocks"][name])
            gc = None if train else tree_map(lambda t: t[gi],
                                             cache["blocks"][name])
            x = block_apply(lt, gp, x, cfg, mode, positions, pos, gc)
    for i, lt in enumerate(cfg.tail):
        x = block_apply(lt, params[f"tail{i}"], x, cfg, mode, positions, pos,
                        None if train else cache[f"tail{i}"])
    return x


def forward_train(params, batch, cfg: ArchConfig):
    """Full causal forward -> (logits, aux_loss); the dense family has no
    auxiliary loss (0.0)."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _stack_apply(params, x, cfg, "train", positions, 0, None)
    return _head_out(params, x, cfg), 0.0


def loss_fn(params, batch, cfg: ArchConfig):
    """Next-token NLL (or per-position labels for embedding input).  A
    forward here: full-length attention on the card has no backward
    pass yet (the flash kernel is forward only)."""
    logits, aux = forward_train(params, batch, cfg)
    if cfg.input_kind == "embeds":
        lg, lb = logits, batch["labels"]
    else:
        lg, lb = logits[:, :-1], batch["tokens"][:, 1:]
    logp = F.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, lb.long()[..., None])[..., 0]
    loss = nll.mean()
    return loss + 0.01 * aux, (loss, aux)


def prefill(params, batch, cfg: ArchConfig, max_len: Optional[int] = None):
    """Run the prompt, return (last-token logits, cache)."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max_len or s, x.device)
    positions = torch.arange(s, device=x.device)
    x = _stack_apply(params, x, cfg, "prefill", positions, 0, cache)
    cache["pos"] = s
    return _head_out(params, x[:, -1:], cfg), cache


def decode_step(params, cache, batch_t, cfg: ArchConfig):
    """One token: batch_t {'tokens': (B, 1)} or {'embeds': (B, 1, D)}.
    Writes the token's keys and values into ``cache``'s tensors in place
    and returns ``(logits, new_cache)`` with ``pos`` advanced.  The input
    cache is consumed: its ``pos`` is set to None, so a second step from
    it (whose tensors already hold this step's keys) raises instead of
    attending over them."""
    if cache["pos"] is None:
        raise ValueError(
            "decode_step: this cache was consumed by an earlier "
            "decode_step, which wrote its tensors in place; pass the cache "
            "that step returned")
    x = _embed_in(params, batch_t, cfg)
    pos = int(cache["pos"])
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x = _stack_apply(params, x, cfg, "decode", positions, pos, cache)
    new_cache = dict(cache, pos=pos + 1)
    cache["pos"] = None
    return _head_out(params, x, cfg), new_cache
