"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] — the port's
counterpart of the JAX package's ``models/whisper.py``.

As in the JAX package the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings (B, T, d).  Sinusoidal positions on both
sides, RMSNorm throughout.  Encoder: bidirectional MHA + GELU MLP.
Decoder: causal self-attention + cross-attention + GELU MLP, with a
self-KV cache and the cross K/V computed once at prefill.  Both stacks'
layers are stacked on a leading layer axis, as the JAX package scans
them; the port loops over them in Python (:func:`repro_torch.loops.scan`;
``cfg.scan_layers`` False unrolls them), and with ``cfg.remat`` a
training forward runs each encoder and decoder layer under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of
both scanned bodies).

Which attention runs where: the encoder's self-attention (``Sq == Skv``,
non-causal) and the decoder prefill's causal self-attention go to
:func:`repro_torch.models.layers.attention`, the flash kernel on the
card; cross-attention (``Sq != Skv``) and decode steps run
:func:`~repro_torch.models.layers.direct_attention`.

Differences of form, not of function: the cache's ``pos`` is a Python
int; :func:`prefill` writes a zeroed cache and :func:`decode_step` writes
its self-KV slot in place and marks the cache it was given consumed, as
:mod:`repro_torch.models.transformer` does; the prefill computes the
cross K/V once (the JAX package computes them twice).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..loops import scan
from . import layers as L
from . import sharding as SH
from .transformer import param_dtype, remat_call, stack_groups, \
    unstack_groups

__all__ = ["sinusoid", "init_params", "encode", "decode_train",
           "forward_train", "loss_fn", "init_cache", "prefill",
           "decode_step"]


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_attn(gen, cfg, prefix=""):
    dt, d = param_dtype(cfg), cfg.d_model
    return {prefix + "wq": L.dense_init(gen, d, cfg.q_dim, dt),
            prefix + "wk": L.dense_init(gen, d, cfg.kv_dim, dt),
            prefix + "wv": L.dense_init(gen, d, cfg.kv_dim, dt),
            prefix + "wo": L.dense_init(gen, cfg.q_dim, d, dt)}


def _norms(gen, cfg, *names):
    return {n: torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=gen.device) for n in names}


def _init_enc_layer(gen, cfg):
    p = _norms(gen, cfg, "norm_in", "norm_mlp")
    p.update(_init_attn(gen, cfg))
    p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu",
                          param_dtype(cfg))
    return p


def _init_dec_layer(gen, cfg):
    p = _norms(gen, cfg, "norm_in", "norm_x", "norm_mlp")
    p.update(_init_attn(gen, cfg))
    p.update(_init_attn(gen, cfg, prefix="x"))
    p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu",
                          param_dtype(cfg))
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """Random params drawn from ``gen`` on its device, each stack's
    layers on a leading layer axis."""
    dt = param_dtype(cfg)
    enc = stack_groups([_init_enc_layer(gen, cfg)
                        for _ in range(cfg.enc_layers)])
    dec = stack_groups([_init_dec_layer(gen, cfg)
                        for _ in range(cfg.n_layers)])
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
        **_norms(gen, cfg, "norm_enc", "norm_f"),
        "enc": enc, "dec": dec,
    }


def _heads(cfg, t, b):
    return SH.split_dim(t, -1, (cfg.n_kv_heads, cfg.head_dim))


def _mha(p, x, kv_x, cfg, *, causal, prefix="", cache=None, pos=None,
         kv_len=None):
    """-> (out, (k, v)).  Without ``cache`` q/k/v come from ``x`` and
    ``kv_x`` and run :func:`layers.attention`; with ``cache = (k, v)``
    (precomputed cross K/V, or the self-KV cache whose slot ``pos`` this
    step's key and value are written into when ``kv_x`` is given) the
    queries attend over it with :func:`layers.direct_attention`."""
    b, s, _ = x.shape
    q = SH.split_dim(L.matmul(x, p[prefix + "wq"]), -1,
                     (cfg.n_heads, cfg.head_dim))
    if cache is None:
        k = _heads(cfg, L.matmul(kv_x, p[prefix + "wk"]), b)
        v = _heads(cfg, L.matmul(kv_x, p[prefix + "wv"]), b)
        out = L.attention(q, k, v, causal=causal)
    else:
        k, v = cache
        if kv_x is not None:                       # decode self-attn append
            slot = min(pos, k.shape[1] - 1)   # dynamic_update_slice clamps
            k[:, slot:slot + 1] = _heads(cfg, L.matmul(kv_x, p[prefix
                                                               + "wk"]), b)
            v[:, slot:slot + 1] = _heads(cfg, L.matmul(kv_x, p[prefix
                                                               + "wv"]), b)
        attend = functools.partial(L.direct_attention, causal=False,
                                   kv_len=kv_len)
        # on DTensors each rank attends over its own heads
        out = SH.on_local_heads(attend, q, k, v) \
            if isinstance(q, DTensor) else attend(q, k, v)
    # the merged heads' gradient comes back split over the model axis on
    # q_dim, which 12 heads do not divide 16 ways: grad_like returns it
    # in the merge's own layout first
    return L.matmul(SH.grad_like(out.reshape(b, s, cfg.q_dim)),
                    p[prefix + "wo"]), (k, v)


def _mlp(lp, xx):
    return xx + L.mlp_forward(lp["mlp"], L.rms_norm(xx, lp["norm_mlp"]),
                              "gelu")


def _enc_layer(x, lp, cfg):
    h = L.rms_norm(x, lp["norm_in"])
    x = x + _mha(lp, h, h, cfg, causal=False)[0]
    return _mlp(lp, x)


def encode(params, embeds, cfg: ArchConfig) -> torch.Tensor:
    x = embeds.to(param_dtype(cfg))
    x = x + sinusoid(torch.arange(x.shape[1], device=x.device),
                     cfg.d_model).to(x.dtype)
    x, _ = scan("whisper.encoder_layers",
                lambda xx, lp: (remat_call(cfg, True, _enc_layer, xx, lp,
                                           cfg), None),
                x, unstack_groups(params["enc"], cfg.enc_layers),
                unroll=not cfg.scan_layers)
    return L.rms_norm(x, params["norm_enc"])


def _embed_tokens(params, tokens, positions, cfg):
    x = params["embed"][tokens.long()]
    return x + sinusoid(positions, cfg.d_model).to(x.dtype)


def _head(params, x):
    return L.matmul(L.rms_norm(x, params["norm_f"]), params["head"]).float()


def _dec_layer(x, lp, enc_out, cfg):
    h = L.rms_norm(x, lp["norm_in"])
    x = x + _mha(lp, h, h, cfg, causal=True)[0]
    h = L.rms_norm(x, lp["norm_x"])
    x = x + _mha(lp, h, enc_out, cfg, causal=False, prefix="x")[0]
    return _mlp(lp, x)


def decode_train(params, tokens, enc_out, cfg: ArchConfig) -> torch.Tensor:
    x = _embed_tokens(params, tokens, torch.arange(tokens.shape[1],
                                                   device=tokens.device), cfg)
    x, _ = scan("whisper.decoder_layers",
                lambda xx, lp: (remat_call(cfg, True, _dec_layer, xx, lp,
                                           enc_out, cfg), None),
                x, unstack_groups(params["dec"], cfg.n_layers),
                unroll=not cfg.scan_layers)
    return _head(params, x)


def forward_train(params, batch, cfg: ArchConfig):
    enc_out = encode(params, batch["embeds"], cfg)
    return decode_train(params, batch["tokens"], enc_out, cfg), 0.0


def loss_fn(params, batch, cfg: ArchConfig):
    logits, aux = forward_train(params, batch, cfg)
    lg, lb = logits[:, :-1], batch["tokens"][:, 1:]
    logp = F.log_softmax(lg, dim=-1)
    loss = -torch.gather(logp, -1, lb.long()[..., None])[..., 0].mean()
    return loss, (loss, aux)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device,
               enc_len: Optional[int] = None, mesh=None) -> Dict[str, Any]:
    """Zeroed self- and cross-attention caches, ``pos`` 0; with a
    ``mesh``, DTensor leaves placed by the cache specs."""
    dt, n = param_dtype(cfg), cfg.n_layers
    kv = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = (n, batch, enc_len or cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        if mesh is not None:
            return SH.cache_full(shape, 0.0, dt, mesh, batch)
        return torch.zeros(shape, dtype=dt, device=device)
    return {"self_k": zeros(kv), "self_v": zeros(kv),
            "cross_k": zeros(xkv), "cross_v": zeros(xkv), "pos": 0}


def prefill(params, batch, cfg: ArchConfig, max_len: Optional[int] = None):
    """Encode the frame embeddings and run the decoder prompt, building
    both caches -> (last-token logits, cache)."""
    enc_out = encode(params, batch["embeds"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, enc_out.device,
                       enc_len=enc_out.shape[1],
                       mesh=enc_out.device_mesh
                       if isinstance(enc_out, DTensor) else None)
    x = _embed_tokens(params, tokens, torch.arange(s, device=tokens.device),
                      cfg)
    def layer(x, il):
        i, lp = il
        h = L.rms_norm(x, lp["norm_in"])
        a, (k, v) = _mha(lp, h, h, cfg, causal=True)
        cache["self_k"][i, :, :s] = k
        cache["self_v"][i, :, :s] = v
        x = x + a
        h = L.rms_norm(x, lp["norm_x"])
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        xk.copy_(_heads(cfg, L.matmul(enc_out, lp["xwk"]), b))
        xv.copy_(_heads(cfg, L.matmul(enc_out, lp["xwv"]), b))
        x = x + _mha(lp, h, None, cfg, causal=False, prefix="x",
                     cache=(xk, xv))[0]
        return _mlp(lp, x), None

    x, _ = scan("whisper.prefill_layers", layer, x,
                enumerate(unstack_groups(params["dec"], cfg.n_layers)),
                unroll=not cfg.scan_layers)
    cache["pos"] = s
    return _head(params, x[:, -1:]), cache


def decode_step(params, cache, batch_t, cfg: ArchConfig):
    """One token ``{'tokens': (B, 1)}`` -> (logits, new cache); writes the
    self-KV slot in place and marks ``cache`` consumed (``pos`` None)."""
    if cache["pos"] is None:
        raise ValueError(
            "decode_step: this cache was consumed by an earlier "
            "decode_step, which wrote its tensors in place; pass the cache "
            "that step returned")
    tokens = batch_t["tokens"]
    b, pos = tokens.shape[0], int(cache["pos"])
    x = _embed_tokens(params, tokens, torch.full(
        (b, 1), pos, dtype=torch.int32, device=tokens.device), cfg)
    def layer(x, il):
        i, lp = il
        h = L.rms_norm(x, lp["norm_in"])
        x = x + _mha(lp, h, h, cfg, causal=False,
                     cache=(cache["self_k"][i], cache["self_v"][i]),
                     pos=pos, kv_len=pos + 1)[0]
        h = L.rms_norm(x, lp["norm_x"])
        x = x + _mha(lp, h, None, cfg, causal=False, prefix="x",
                     cache=(cache["cross_k"][i], cache["cross_v"][i]))[0]
        return _mlp(lp, x), None

    x, _ = scan("whisper.decode_layers", layer, x,
                enumerate(unstack_groups(params["dec"], cfg.n_layers)),
                unroll=not cfg.scan_layers)
    new_cache = dict(cache, pos=pos + 1)
    cache["pos"] = None
    return _head(params, x), new_cache
