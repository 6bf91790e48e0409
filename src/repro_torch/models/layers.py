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

:func:`attention` sends every full-length call (a prefill or a training
forward) to :func:`repro_torch.kernels.flash_attention`: on the card
the hand-written kernel, on the CPU its plain version.  Decode calls
(a cache longer than the query, ``kv_len``) stay :func:`direct_attention`
in plain torch, as the JAX package computes them outside any kernel.
The kernel has no backward pass, so a full-length call on the card runs
under ``torch.no_grad()`` or ``torch.inference_mode()`` (the engine's
prefill and decode do).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import flash_attention

__all__ = ["dense_init", "embed_init", "rms_norm", "layer_norm",
           "group_norm", "apply_rope", "direct_attention", "attention",
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
    package)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * torch.as_tensor(w, device=x.device).float()).to(x.dtype)


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
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """Materializes (Sq, Skv) scores in float32 — decode steps and
    partially-filled caches.

    q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd).  ``q_offset`` is the
    absolute position of q[0] (decode: current position).  ``kv_len``
    masks a partially-filled cache (keys at ``kv_len`` and past)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / np.sqrt(hd)
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


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_offset: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """Dispatch: a full-length call (``Sq == Skv``, ``q_offset`` 0, no
    ``kv_len``) runs :func:`repro_torch.kernels.flash_attention` — the
    CUDA kernel on the card, its plain version on the CPU — and
    everything else :func:`direct_attention`.  Both compute the function
    of the JAX package's ``attention`` (which takes XLA's chunked form
    for full-length calls of 4096 or more, the direct one otherwise)."""
    sq, skv = q.shape[1], k.shape[1]
    if sq == skv and kv_len is None and q_offset == 0:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    return direct_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset,
                            kv_len=kv_len)


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
    of shifted slices."""
    w = params["conv_w"]
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return out


def causal_conv_step(params: dict, x_t: torch.Tensor,
                     conv_state: torch.Tensor):
    """Single decode step.  conv_state: (B, width-1, C) trailing inputs
    -> (out (B, C), the next state)."""
    w = params["conv_w"]
    window = torch.cat([conv_state, x_t[:, None]], dim=1)
    out = einsum("bwc,wc->bc", window, w)
    return out, window[:, 1:]
