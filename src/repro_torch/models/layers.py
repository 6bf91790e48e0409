"""Shared model layers: norms, RoPE, attention, MLP variants and the
causal depthwise conv of the recurrent blocks — the port's counterpart
of the JAX package's ``models/layers.py``.

Conventions, as in the JAX package:

- linear weights are (d_in, d_out), no biases; params are plain dicts
  with the JAX package's key names, so weights map 1:1
  (:func:`repro_torch.convert.model_params_from_jax`).
- attention tensors: q (B, Sq, H, hd); k/v (B, Skv, KV, hd); GQA via
  head-group reshape (query head h reads kv head h // (H / KV)).
- computations run in the param dtype (bf16 for the big configs) with
  float32 softmax/normalizer internals.

:func:`attention` picks the route by whether autograd must see through
the call:

- without a gradient (serving, a held-out loss under
  ``torch.no_grad()``), every full-length call (a prefill or a forward)
  goes to :func:`repro_torch.kernels.flash_attention`: on the card the
  hand-written kernel, on the CPU its plain version;
- with one (a training step), it takes the JAX package's route exactly:
  :func:`chunked_attention` for a full-length call of
  ``chunked_threshold`` (4096) positions or more, :func:`direct_attention`
  below that.  Both are plain PyTorch that autograd differentiates; the
  flash kernel has no backward pass (nor has the JAX package's Pallas
  kernel, which its training step never runs).

Decode calls (a cache longer than the query, ``kv_len``) stay
:func:`direct_attention`, as the JAX package computes them outside any
kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..kernels import flash_attention
from ..loops import scan
from .sharding import LocalBlocks, on_local_heads

__all__ = ["dense_init", "embed_init", "rms_norm", "layer_norm",
           "group_norm", "apply_rope", "direct_attention",
           "chunked_attention", "attention",
           "init_mlp", "mlp_forward", "init_causal_conv", "causal_conv",
           "causal_conv_step", "matmul", "einsum", "NEG_INF"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Init helpers (drawn from an explicit generator on its device)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / np.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion of mixed float types (a float32
    activation times a bfloat16 weight computes in float32), which
    ``torch.matmul`` refuses; a storage-dequantized bf16 weight meets a
    float32 activation that way."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's promotion of mixed float types, as
    :func:`matmul`."""
    t = ops[0].dtype
    for o in ops[1:]:
        t = torch.promote_types(t, o.dtype)
    return torch.einsum(eq, *(o.to(t) for o in ops))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def group_norm(x: torch.Tensor, w: torch.Tensor, n_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """Per-head norm used by xLSTM cells: x (..., H, hd) normalized per
    head (``n_groups`` is H, implied by the shape, as in the JAX
    package).  A Python-number ``w`` scales as a number: no tensor is
    made for it (the dry-run's fake-tensor trace allocates nothing on the
    card)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if not isinstance(w, (int, float)):
        w = torch.as_tensor(w, device=x.device).float()
    return (y * w).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (with partial-dim fraction, chatglm-style 2d = fraction 0.5)
# --------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               fraction: float = 1.0, theta: float = 10000.0
               ) -> torch.Tensor:
    """Rotary embedding on interleaved pairs (dims 0::2 with 1::2).
    x: (B, S, H, hd); positions: (S,) or (B, S).

    ``fraction`` < 1 rotates only the first fraction*hd dims (chatglm's
    2d-RoPE is fraction=0.5)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    freqs = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                    device=x.device) / rot)
    ang = positions[..., None].float() * freqs           # (..., S, rot/2)
    if ang.ndim == 2:                                    # (S, r2)
        ang = ang[None]                                  # (1, S, r2)
    cos = torch.cos(ang)[:, :, None, :]                  # (B|1, S, 1, r2)
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot].float(), x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def direct_attention(q, k, v, *, causal: bool, window: int = 0,
                     softcap: float = 0.0, q_offset: int = 0,
                     kv_len: Optional[int] = None, score_reduce=None,
                     head_dim: Optional[int] = None) -> torch.Tensor:
    """Materializes (Sq, Skv) scores in float32 — decode steps and
    partially-filled caches.

    q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd).  ``q_offset`` is the
    absolute position of q[0] (decode: current position).  ``kv_len``
    masks a partially-filled cache (keys at ``kv_len`` and past).  On a
    block of the head dim (a rank's, ``sharding.on_local_heads``),
    ``score_reduce`` sums the partial q.k products over the blocks and
    ``head_dim`` is the whole head dim, which scales them."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if score_reduce is not None:
        scores = score_reduce(scores)
    scores = scores / np.sqrt(head_dim or hd)
    scores = _softcap(scores, softcap)
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window and window > 0:
        mask &= ki > qi - window
    if kv_len is not None:
        mask &= ki < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      softcap: float = 0.0, q_chunk: int = 2048,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over q chunks, each
    over the kv chunks with a running max, denominator and float32
    accumulator, so no more than (q_chunk x kv_chunk) scores a head
    exist at once — the JAX package's ``chunked_attention`` (its
    ``lax.map`` / ``lax.scan`` become Python loops,
    :func:`repro_torch.loops.scan`), which autograd differentiates.
    Both sequences are padded to whole chunks; padded keys are masked,
    padded queries dropped.  The PV product runs in float32, as the JAX
    package keeps it.

    A kv chunk that the causal or window mask hides from every query of
    the q chunk is skipped (the kv loop runs over the visible chunks
    only, so each of its trips does the same work): in the JAX
    package's scan it scales the running values by exactly 1 (or,
    before the first visible chunk, leaves values that the first visible
    one multiplies by exactly 0), so skipping it changes no bit of the
    output."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / np.sqrt(hd)
    qpad, kpad = (-sq) % q_chunk, (-skv) % kv_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, qpad))
    kp = F.pad(k, (0, 0, 0, 0, 0, kpad))
    vp = F.pad(v, (0, 0, 0, 0, 0, kpad))
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    dev = q.device

    def visible(q0, k0):
        if causal and k0 > q0 + q_chunk - 1:
            return False
        return not (window and window > 0
                    and k0 + kv_chunk - 1 <= q0 - window)

    def q_step(_, q0):
        qb32 = qp[:, q0:q0 + q_chunk].reshape(
            b, q_chunk, kv, g, hd).float() * scale
        q_pos = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        den = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((b, kv, g, q_chunk, hd), dtype=torch.float32,
                          device=dev)

        def kv_step(carry, k0):
            m, den, acc = carry
            kb = kp[:, k0:k0 + kv_chunk].float()
            vb = vp[:, k0:k0 + kv_chunk]
            s = _softcap(torch.einsum("bqkgd,bskd->bkgqs", qb32, kb),
                         softcap)
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            msk = (k_pos < skv)[None, :].expand(q_chunk, kv_chunk)
            if causal:
                msk = msk & (k_pos[None, :] <= q_pos[:, None])
            if window and window > 0:
                msk = msk & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            den = den * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vb.float())
            return (m_new, den, acc * alpha[..., None] + pv), None

        (m, den, acc), _ = scan(
            "layers.attention_kv_chunks", kv_step, (m, den, acc),
            [k0 for k0 in range(0, nk * kv_chunk, kv_chunk)
             if visible(q0, k0)])
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        return None, out.permute(0, 3, 1, 2, 4)       # (B, cq, KV, G, hd)

    _, outs = scan("layers.attention_q_chunks", q_step, None,
                   range(0, nq * q_chunk, q_chunk))
    out = torch.cat(outs, dim=1).reshape(b, nq * q_chunk, h, hd)
    return out[:, :sq].to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_offset: int = 0,
              kv_len: Optional[int] = None, chunked_threshold: int = 4096,
              remat: bool = False, score_reduce=None,
              head_dim: Optional[int] = None) -> torch.Tensor:
    """Dispatch (module docstring).  A full-length call is ``Sq == Skv``,
    ``q_offset`` 0 and no ``kv_len``.

    - Autograd must see through the call (grad enabled and q, k or v
      requires grad): the JAX package's ``attention`` route —
      :func:`chunked_attention` for a full-length call of at least
      ``chunked_threshold`` positions (under
      ``torch.utils.checkpoint`` when ``remat``, so the backward
      recomputes the chunk probabilities), :func:`direct_attention`
      otherwise.
    - No gradient: a full-length call runs
      :func:`repro_torch.kernels.flash_attention` (the CUDA kernel on the
      card, its plain version on the CPU), anything else
      :func:`direct_attention`.

    On DTensors (params placed on a ``DeviceMesh``) each rank runs that
    dispatch on its local heads and batch rows
    (:func:`repro_torch.models.sharding.on_local_heads`): the flash
    kernel, which reads plain tensors, gets each rank's own heads.  A
    cache sharded on the head dim reaches :func:`direct_attention` with
    ``score_reduce`` and ``head_dim`` (only a decode step's call, never a
    full-length one, reads such a cache)."""
    if isinstance(q, DTensor):
        # a DTensor's attention is each rank's, over its own heads (q, k
        # and v gathered first where the heads do not split evenly), by
        # the routes below on its local tensors; autograd sees through
        return on_local_heads(functools.partial(
            attention, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, kv_len=kv_len,
            chunked_threshold=chunked_threshold, remat=remat), q, k, v)
    sq, skv = q.shape[1], k.shape[1]
    full = sq == skv and kv_len is None and q_offset == 0
    if full and score_reduce is not None:
        raise ValueError("attention: a full-length call on a block of the "
                         "head dim; only direct_attention sums partial "
                         "scores")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if full and sq >= chunked_threshold:
            fn = functools.partial(chunked_attention, causal=causal,
                                   window=window, softcap=softcap)
            if remat:
                return checkpoint(fn, q, k, v, use_reentrant=False)
            return fn(q, k, v)
    elif full:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    return direct_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset,
                            kv_len=kv_len, score_reduce=score_reduce,
                            head_dim=head_dim)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, kind: str,
             dtype) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, f, dtype),
                "w_up": dense_init(gen, d, f, dtype),
                "w_down": dense_init(gen, f, d, dtype)}
    return {"w_up": dense_init(gen, d, f, dtype),
            "w_down": dense_init(gen, f, d, dtype)}


def mlp_forward(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    elif kind == "geglu":
        h = F.gelu(matmul(x, params["w_gate"]), approximate="tanh") \
            * matmul(x, params["w_up"])
    elif kind == "gelu":
        h = F.gelu(matmul(x, params["w_up"]), approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(matmul(x, params["w_up"])))
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return matmul(h, params["w_down"])


# --------------------------------------------------------------------------
# Causal depthwise conv (recurrentgemma / xlstm front conv)
# --------------------------------------------------------------------------

def init_causal_conv(gen: torch.Generator, width: int, channels: int,
                     dtype) -> dict:
    return {"conv_w": (torch.randn((width, channels), generator=gen,
                                   device=gen.device, dtype=torch.float32)
                       * (1.0 / np.sqrt(width))).to(dtype)}


def causal_conv(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time: x (B, S, C), a sum over the taps
    of shifted slices.  On DTensors each rank convolves its own rows and
    channels (``sharding.LocalBlocks``: DTensor's pad fails to plan on
    torch 2.11)."""
    blocks = LocalBlocks(x, heads=x.shape[-1])
    w = blocks.param(params["conv_w"], 1)
    x = blocks.local(x, 2)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return blocks.rows(out, 2)


def causal_conv_step(params: dict, x_t: torch.Tensor,
                     conv_state: torch.Tensor):
    """Single decode step.  conv_state: (B, width-1, C) trailing inputs
    -> (out (B, C), the next state); on DTensors on each rank's own rows
    and channels, as :func:`causal_conv`."""
    blocks = LocalBlocks(x_t, heads=x_t.shape[-1])
    window = torch.cat([blocks.local(conv_state, 2),
                        blocks.local(x_t, 1)[:, None]], dim=1)
    out = einsum("bwc,wc->bc", window, blocks.param(params["conv_w"], 1))
    return blocks.rows(out, 1), blocks.rows(window[:, 1:], 2)
