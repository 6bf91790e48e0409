"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]) —
the port's counterpart of the JAX package's ``models/rglru.py``.

Block: x -> {linear -> causal-conv4 -> RG-LRU} gated by {linear -> GeLU},
projected back to d_model.  The RG-LRU diagonal linear recurrence

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(c * softplus(Lambda) * (-r_t))          (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs over a whole sequence as a log-depth scan (:func:`rglru_scan`,
Hillis-Steele doubling over the ``(a, b)`` pairs in float32: about
ceil(log2 S) steps of a few whole-tensor ops each, where the JAX package
calls ``lax.associative_scan``), and one fused step a decode token.

As in the JAX package, :func:`rglru_scan` returns ``h`` in the input's
dtype and the prefill's carried state is that rounded ``h``'s last row,
so in bfloat16 the decode state starts bf16-rounded; the conv state is
the last ``width - 1`` *pre-conv* inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import (causal_conv, causal_conv_step, dense_init,
                     init_causal_conv, matmul)

__all__ = ["init_rglru_block", "rglru_scan", "rglru_step", "rglru_block",
           "rglru_block_prefill", "rglru_block_step"]

_C = 8.0  # Griffin's fixed scalar


def init_rglru_block(gen: torch.Generator, d: int, rnn_width: int,
                     conv_width: int, dtype) -> dict:
    p = {
        "rg_in": dense_init(gen, d, rnn_width, dtype),
        "rg_gate_in": dense_init(gen, d, rnn_width, dtype),
        "rg_wa": dense_init(gen, rnn_width, rnn_width, dtype),
        "rg_wx": dense_init(gen, rnn_width, rnn_width, dtype),
        # Lambda init so a^c in [0.9, 0.999] (Griffin appendix)
        "rg_lambda": torch.rand((rnn_width,), generator=gen,
                                device=gen.device,
                                dtype=torch.float32) * 4.0 + 2.0,
        "rg_out": dense_init(gen, rnn_width, d, dtype),
    }
    p.update(init_causal_conv(gen, conv_width, rnn_width, dtype))
    return p


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(params, u):
    r = torch.sigmoid(matmul(u, params["rg_wa"]).float())
    i = torch.sigmoid(matmul(u, params["rg_wx"]).float())
    log_a = -_C * _softplus(params["rg_lambda"].float()) * r   # (B,S,R) f32
    a = torch.exp(log_a)
    gated_x = i * u.float()
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * gated_x


def rglru_scan(params: dict, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU.  u: (B, S, R) -> h (B, S, R) in u's dtype.

    Hillis-Steele doubling: after the step of offset ``d`` every
    position holds the composition of itself with the ``2d - 1``
    positions before it under ``(l, r) -> (l.a r.a, r.a l.b + r.b)``
    (``l`` the earlier), so after ceil(log2 S) steps ``b`` is ``h``."""
    a, b = _gates(params, u)
    s, d = u.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b.to(u.dtype)


def rglru_step(params: dict, u_t: torch.Tensor,
               h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode: u_t (B, R), h_prev (B, R) f32 -> (out, h_new)."""
    a, b = _gates(params, u_t[:, None])
    h = a[:, 0] * h_prev + b[:, 0]
    return h.to(u_t.dtype), h


def _branches(params: dict, x: torch.Tensor):
    u = matmul(x, params["rg_in"])
    gate = F.gelu(matmul(x, params["rg_gate_in"]), approximate="tanh")
    return u, gate


def rglru_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Full recurrent block, train path.  x: (B, S, D)."""
    return rglru_block_prefill(params, x)[0]


def rglru_block_prefill(params: dict, x: torch.Tensor):
    """The block over a prompt -> ``(out, (h_last (B, R) f32, conv_state
    (B, w-1, R)))`` for decode."""
    u, gate = _branches(params, x)
    h = rglru_scan(params, causal_conv({"conv_w": params["conv_w"]}, u))
    out = matmul(h * gate, params["rg_out"])
    width = params["conv_w"].shape[0]
    return out, (h[:, -1].float(), u[:, -(width - 1):])


def rglru_block_step(params: dict, x_t: torch.Tensor, state
                     ) -> Tuple[torch.Tensor, tuple]:
    """Decode step.  x_t: (B, D); state = (h (B,R) f32, conv (B,w-1,R))."""
    h_prev, conv_state = state
    u_t, gate = _branches(params, x_t)
    uc_t, conv_state = causal_conv_step({"conv_w": params["conv_w"]},
                                        u_t, conv_state)
    h_t, h_new = rglru_step(params, uc_t, h_prev)
    return matmul(h_t * gate, params["rg_out"]), (h_new, conv_state)
