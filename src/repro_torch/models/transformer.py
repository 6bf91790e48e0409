"""Decoder-LM assembly: pattern-grouped blocks, embedding, head, loss;
train / prefill / decode paths with dict caches — the port's counterpart
of the JAX package's ``models/transformer.py`` for every layer type
(``global``, ``local``, ``rec``, ``m``, ``s``) and MLP slot (dense or
MoE).

The params and cache trees keep the JAX package's layout: every block
leaf has a leading *pattern group* axis (``params["blocks"]["b0"]["wq"]``
is ``(G, d, q_dim)``), and the unscanned tail blocks (recurrentgemma's
two ``rec`` layers) sit under ``tail0``, ``tail1``, so weights map 1:1
(:func:`repro_torch.convert.model_params_from_jax`).  Where the JAX
package scans the groups with ``lax.scan``, the port loops over them in
Python (:func:`repro_torch.loops.scan`; ``cfg.scan_layers`` False
unrolls them, as the JAX package does), each group reading views of the
stacked leaves (one ``unbind`` a leaf, so a backward pass stacks each
leaf's gradient once).  With
``cfg.remat``, a training forward under autograd runs each pattern group
under ``torch.utils.checkpoint`` — the counterpart of the JAX package's
``jax.checkpoint(body)`` — so the backward recomputes a group's
activations from its input instead of keeping them.

Differences of form, not of function:

- the cache's ``pos`` is a Python int (the JAX package keeps an int32
  scalar), so a decode step computes its cache slot without reading the
  card;
- :func:`prefill` writes the prompt's keys and values, and the
  recurrent states, into a zeroed cache and :func:`decode_step` writes
  it in place (the JAX package returns updated copies); the returned
  cache holds the same values, and the cache passed in is marked
  consumed (``pos`` None), so reusing it raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..loops import scan
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import sharding as SH
from . import xlstm as XL

__all__ = ["init_params", "init_cache", "forward_train", "loss_fn",
           "prefill", "decode_step", "param_dtype", "stack_groups",
           "unstack_groups", "remat_call"]


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# Per-block init
# --------------------------------------------------------------------------

def init_block(gen: torch.Generator, ltype: str,
               cfg: ArchConfig) -> Dict[str, Any]:
    dt, d, dev = param_dtype(cfg), cfg.d_model, gen.device

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=dev)
    p: Dict[str, Any] = {"norm_in": zeros()}
    if ltype in ("global", "local"):
        p.update({
            "wq": L.dense_init(gen, d, cfg.q_dim, dt),
            "wk": L.dense_init(gen, d, cfg.kv_dim, dt),
            "wv": L.dense_init(gen, d, cfg.kv_dim, dt),
            "wo": L.dense_init(gen, cfg.q_dim, d, dt),
        })
    elif ltype == "rec":
        p.update(RG.init_rglru_block(gen, d, cfg.rnn_width or d,
                                     cfg.conv_width, dt))
    elif ltype == "m":
        p.update(XL.init_mlstm_block(gen, d, cfg.n_heads, dt,
                                     cfg.mlstm_proj_factor, cfg.conv_width))
    elif ltype == "s":
        p.update(XL.init_slstm_block(gen, d, cfg.n_heads, dt))
    else:
        raise ValueError(f"unknown layer type {ltype}")
    if cfg.post_norm and ltype in ("global", "local", "rec"):
        p["norm_post"] = zeros()
    # MLP slot (xlstm blocks carry their own projections -> none)
    if ltype in ("global", "local", "rec") and cfg.mlp_kind != "none":
        p["norm_mlp"] = zeros()
        if cfg.n_experts > 0:
            p["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.n_experts,
                                    cfg.n_shared_experts, cfg.shared_ff, dt)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dt)
        if cfg.post_norm:
            p["norm_mlp_post"] = zeros()
    return p


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def init_block_cache(ltype: str, cfg: ArchConfig, batch: int, max_len: int,
                     device, groups: int = 0, mesh=None) -> Dict[str, Any]:
    """A block's zeroed cache (KV for attention, the recurrent states
    otherwise); ``groups`` > 0 adds the leading group axis.  With a
    ``mesh`` each leaf is a DTensor placed by the cache specs
    (:func:`repro_torch.models.sharding.cache_full`)."""
    lead = (groups,) if groups else ()
    dt, d, f32 = param_dtype(cfg), cfg.d_model, torch.float32

    def full(shape, dtype=f32, value=0.0):
        if mesh is not None:
            return SH.cache_full(lead + shape, value, dtype, mesh, batch)
        return torch.full(lead + shape, value, dtype=dtype, device=device)
    if ltype in ("global", "local"):
        length = max_len if ltype == "global" else min(cfg.window, max_len)
        shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
        return {"k": full(shape, dt), "v": full(shape, dt)}
    if ltype == "rec":
        r = cfg.rnn_width or d
        return {"h": full((batch, r)),
                "conv": full((batch, cfg.conv_width - 1, r), dt)}
    if ltype == "m":
        di = cfg.mlstm_proj_factor * d
        hd = di // cfg.n_heads
        return {"C": full((batch, cfg.n_heads, hd, hd)),
                "n": full((batch, cfg.n_heads, hd)),
                "m": full((batch, cfg.n_heads), value=XL.M_INIT),
                "conv": full((batch, cfg.conv_width - 1, di), dt)}
    if ltype == "s":
        shape = (batch, cfg.n_heads, d // cfg.n_heads)
        return {"c": full(shape), "n": full(shape),
                "m": full(shape, value=XL.M_INIT), "h": full(shape, dt)}
    raise ValueError(ltype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device,
               mesh=None) -> Dict[str, Any]:
    """The model's zeroed cache, ``pos`` 0; with a ``mesh``, DTensor
    leaves placed by the cache specs (:func:`init_block_cache`)."""
    g = cfg.n_groups()
    cache: Dict[str, Any] = {
        "blocks": {f"b{i}": init_block_cache(lt, cfg, batch, max_len, device,
                                             groups=g, mesh=mesh)
                   for i, lt in enumerate(cfg.pattern)},
        "pos": 0}
    for i, lt in enumerate(cfg.tail):
        cache[f"tail{i}"] = init_block_cache(lt, cfg, batch, max_len, device,
                                             mesh=mesh)
    return cache


def _store(cache: Dict[str, Any], **new) -> None:
    """Write a block's new states into its cache tensors in place."""
    for name, t in new.items():
        cache[name].copy_(t)


# --------------------------------------------------------------------------
# Per-block forward
# --------------------------------------------------------------------------

def _attn_block(p, x, ltype, cfg: ArchConfig, mode, positions, pos, cache):
    b, s, _ = x.shape
    h = L.rms_norm(x, p["norm_in"])
    q = SH.split_dim(L.matmul(h, p["wq"]), -1,
                     (cfg.n_heads, cfg.head_dim))
    k = SH.split_dim(L.matmul(h, p["wk"]), -1,
                     (cfg.n_kv_heads, cfg.head_dim))
    v = SH.split_dim(L.matmul(h, p["wv"]), -1,
                     (cfg.n_kv_heads, cfg.head_dim))
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
        # attention's dispatch: direct_attention over the cache, on each
        # rank's own heads for DTensors (sharding.on_local_heads)
        out = L.attention(q, ck, cv, causal=False, window=0,
                          softcap=cfg.attn_softcap, kv_len=kv_len)
    else:
        out = L.attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
        if mode == "prefill":
            w = cache["k"].shape[1]
            if ltype == "local" and s >= w:
                # keep the last `w` keys in ring order: key at position p
                # lives in slot p % w  ->  roll the tail by s % w.
                _store(cache, k=torch.roll(k[:, -w:], s % w, dims=1),
                       v=torch.roll(v[:, -w:], s % w, dims=1))
            else:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v

    out = SH.placed_like(L.matmul(out.reshape(b, s, cfg.q_dim), p["wo"]), x)
    if cfg.post_norm:
        out = L.rms_norm(out, p["norm_post"])
    return x + out


def _rec_block(p, x, cfg: ArchConfig, mode, cache):
    h = L.rms_norm(x, p["norm_in"])
    if mode == "train":
        out = RG.rglru_block(p, h)
    elif mode == "prefill":
        out, (hl, cs) = RG.rglru_block_prefill(p, h)
        _store(cache, h=hl, conv=cs)
    else:
        out, (hl, cs) = RG.rglru_block_step(p, h[:, 0],
                                            (cache["h"], cache["conv"]))
        out = out[:, None]
        _store(cache, h=hl, conv=cs)
    if cfg.post_norm:
        out = L.rms_norm(out, p["norm_post"])
    return x + out


def _mlstm_blk(p, x, cfg: ArchConfig, mode, cache):
    h = L.rms_norm(x, p["norm_in"])
    state = None
    if mode == "decode":
        state = ((cache["C"], cache["n"], cache["m"]), cache["conv"])
    out, new = XL.mlstm_block(p, h, cfg.n_heads, mode, state)
    if mode != "train":
        (c, n, m), conv = new
        _store(cache, C=c, n=n, m=m, conv=conv)
    return x + SH.placed_like(out, x)


def _slstm_blk(p, x, cfg: ArchConfig, mode, cache):
    h = L.rms_norm(x, p["norm_in"])
    state = None
    if mode == "decode":
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    out, (c, n, m, hh) = XL.slstm_block(p, h, cfg.n_heads, state)
    if mode != "train":
        _store(cache, c=c, n=n, m=m, h=hh)
    return x + SH.placed_like(out, x)


def _mlp_slot(p, x, cfg: ArchConfig):
    """The block's MLP (dense or MoE) -> (x, aux)."""
    if "norm_mlp" not in p:
        return x, 0.0
    h = L.rms_norm(x, p["norm_mlp"])
    if "moe" in p:
        out, aux = MOE.moe_forward(p["moe"], h, n_experts=cfg.n_experts,
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
    else:
        out, aux = L.mlp_forward(p["mlp"], h, cfg.mlp_kind), 0.0
    out = SH.placed_like(out, x)
    if cfg.post_norm:
        out = L.rms_norm(out, p["norm_mlp_post"])
    return x + out, aux


def block_apply(ltype: str, p, x, cfg: ArchConfig, mode: str, positions,
                pos, cache):
    """One block -> (x, aux); a prefill or decode step writes ``cache``
    in place."""
    if ltype in ("global", "local"):
        x = _attn_block(p, x, ltype, cfg, mode, positions, pos, cache)
    elif ltype == "rec":
        x = _rec_block(p, x, cfg, mode, cache)
    elif ltype == "m":
        x = _mlstm_blk(p, x, cfg, mode, cache)
    elif ltype == "s":
        x = _slstm_blk(p, x, cfg, mode, cache)
    else:
        raise ValueError(ltype)
    return _mlp_slot(p, x, cfg)


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def stack_groups(trees: list):
    """Stack a list of same-structure dict trees leaf by leaf on a new
    leading axis, emptying the input dicts as it goes, so at most one
    stacked leaf exists beside the unstacked ones."""
    if isinstance(trees[0], dict):
        return {k: stack_groups([t.pop(k) for t in trees])
                for k in sorted(trees[0])}
    return torch.stack(trees)


def unstack_groups(tree, n: int, gathered=None) -> list:
    """The ``n`` per-group trees of views of a stacked tree (the inverse
    of :func:`stack_groups`), one ``unbind`` a leaf.  A DTensor leaf
    sharded on the group axis (the cache specs shard the first dim equal
    to the batch, which may be that axis) is gathered on it first; the
    views are then of that copy, and ``(leaf, copy)`` is appended to the
    list ``gathered``, so a caller that writes the views can write the
    copy back."""
    if isinstance(tree, dict):
        parts = {k: unstack_groups(v, n, gathered) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    whole = SH.replicate_dims(tree, [0])
    if whole is not tree and gathered is not None:
        gathered.append((tree, whole))
    return list(whole.unbind(0))


def remat_call(cfg: ArchConfig, train: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``cfg.remat`` asks for it in a training forward that autograd
    records, as the JAX package wraps its scanned body in
    ``jax.checkpoint``.  The blocks draw no random numbers, so no RNG
    state is saved for the recompute."""
    if cfg.remat and train and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """Random params drawn from ``gen`` on its device: per pattern group
    (stacked on a leading group axis), then the embedding, the head and
    the tail blocks."""
    dt, dev = param_dtype(cfg), gen.device
    stacked = stack_groups([{f"b{i}": init_block(gen, lt, cfg)
                             for i, lt in enumerate(cfg.pattern)}
                            for _ in range(cfg.n_groups())])
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
    elif isinstance(params["embed"], DTensor):
        x = SH.embedding_lookup(params["embed"], batch["tokens"].long())
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.scale_embed:
        # a float32 scalar: a bf16 activation is promoted, then cast back
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return x.to(dt)


def _head_out(params, x, cfg: ArchConfig):
    x = L.rms_norm(x, params["norm_f"])
    # under autograd the head's d is read whole (fsdp splits it over data)
    logits = L.matmul(x, SH.gathered_for_grad(params["head"], [0])).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _stack_apply(params, x, cfg: ArchConfig, mode: str, positions, pos,
                 cache):
    """The pattern groups in order, each reading its views of the stacked
    params (and cache), then the tail -> (x, aux summed over the blocks).
    In train mode no cache is threaded (``cache`` may be None), and with
    ``cfg.remat`` each group runs under :func:`remat_call`."""
    train, aux, g = mode == "train", 0.0, cfg.n_groups()
    names = [f"b{i}" for i in range(len(cfg.pattern))]
    gps = {n: unstack_groups(params["blocks"][n], g) for n in names}
    # cache leaves sharded on the group axis are written through copies
    # gathered on it, and written back below
    gathered = []
    gcs = None if train else {n: unstack_groups(cache["blocks"][n], g,
                                                gathered)
                              for n in names}

    def group(xx, aux_, gp, gc):       # the JAX package's scanned body
        if cfg.fsdp:
            # pin the residual stream's batch sharding: with fsdp params
            # the propagation may otherwise replicate activations over
            # the data axis (a no-op on plain tensors)
            xx = SH.shard_activations(xx)
        for i, lt in enumerate(cfg.pattern):
            xx, a = block_apply(lt, gp[names[i]], xx, cfg, mode, positions,
                                pos, None if gc is None else gc[names[i]])
            aux_ = aux_ + a
        return xx, aux_

    def step(carry, xg):
        return remat_call(cfg, train, group, *carry, *xg), None

    (x, aux), _ = scan(
        "transformer.groups", step, (x, aux),
        [({n: gps[n][gi] for n in names},
          None if train else {n: gcs[n][gi] for n in names})
         for gi in range(g)], unroll=not cfg.scan_layers)
    for leaf, whole in gathered:
        leaf.copy_(whole)
    for i, lt in enumerate(cfg.tail):
        x, a = block_apply(lt, params[f"tail{i}"], x, cfg, mode, positions,
                           pos, None if train else cache[f"tail{i}"])
        aux = aux + a
    return x, aux


def forward_train(params, batch, cfg: ArchConfig):
    """Full causal forward -> (logits, aux_loss): the MoE layers' summed
    load-balance loss, 0.0 for a model without experts."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_apply(params, x, cfg, "train", positions, 0, None)
    return _head_out(params, x, cfg), aux


def loss_fn(params, batch, cfg: ArchConfig):
    """Next-token NLL (or per-position labels for embedding input) ->
    ``(loss + 0.01 aux, (nll, aux))``.  Differentiable on the CPU and
    the card: under autograd, attention takes the JAX package's chunked
    or direct route (:func:`layers.attention`), never the forward-only
    flash kernel; under ``torch.no_grad()`` full-length attention runs
    the flash kernel."""
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
    """Run the prompt, return (last-token logits, cache).  On sharded
    params (DTensors) the cache is made sharded on their mesh, by the
    cache specs."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max_len or s, x.device,
                       x.device_mesh if isinstance(x, DTensor) else None)
    positions = torch.arange(s, device=x.device)
    x, _ = _stack_apply(params, x, cfg, "prefill", positions, 0, cache)
    cache["pos"] = s
    return _head_out(params, x[:, -1:], cfg), cache


def decode_step(params, cache, batch_t, cfg: ArchConfig):
    """One token: batch_t {'tokens': (B, 1)} or {'embeds': (B, 1, D)}.
    Writes the token's keys and values and the recurrent layers' states
    into ``cache``'s tensors in place
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
    x, _ = _stack_apply(params, x, cfg, "decode", positions, pos, cache)
    new_cache = dict(cache, pos=pos + 1)
    cache["pos"] = None
    return _head_out(params, x, cfg), new_cache
