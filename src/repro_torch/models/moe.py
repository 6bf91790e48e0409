"""Mixture-of-Experts layer: top-k routing with per-sequence capacity,
scatter dispatch into an expert buffer, SwiGLU experts and an optional
sigmoid-gated shared expert — the port's counterpart of the JAX
package's ``models/moe.py``.

Shapes: x (B, S, D) -> buffer (E, B, C, D) with per-sequence capacity
``C = max(8, min(ceil(top_k * S / E * capacity_factor), S * top_k))``;
overflow slots drop (GShard).  The JAX package's buffer is batch-major,
(B, E, C, D): the same slots and the same products, in another order.
A call of at most 4 positions (a decode step) takes the dense path
instead: every expert computed, combined with the top-k gates.  The expert GEMMs are batched ``torch.matmul`` /
``einsum`` (cuBLAS on the card), as the JAX package computes them in
XLA outside any Pallas kernel.

Quirks kept from the JAX package: a slot's position within its expert is
a cumsum over the flattened ``(S * k)`` routing order (token-major, slot
within token); left-pad tokens route and take capacity like any other;
the router runs in float32, the shared expert's gate in the weight
dtype; the aux loss is Switch's ``E * sum(me * ce)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from . import sharding as SH
from .layers import dense_init, einsum, matmul

__all__ = ["init_moe", "capacity", "route", "moe_forward_dense",
           "moe_forward"]

DENSE_MAX_SEQ = 4          # calls of at most this many positions go dense


def init_moe(gen: torch.Generator, d: int, f: int, n_experts: int,
             n_shared: int, shared_ff: int, dtype) -> dict:
    scale = 1.0 / math.sqrt(d)

    def experts(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * s).to(dtype)
    p = {
        "router": dense_init(gen, d, n_experts, torch.float32),
        "experts_gate": experts((n_experts, d, f), scale),
        "experts_up": experts((n_experts, d, f), scale),
        "experts_down": experts((n_experts, f, d), 1.0 / math.sqrt(f)),
    }
    if n_shared > 0:
        p["shared_gate"] = dense_init(gen, d, shared_ff, dtype)
        p["shared_up"] = dense_init(gen, d, shared_ff, dtype)
        p["shared_down"] = dense_init(gen, shared_ff, d, dtype)
        p["shared_route"] = dense_init(gen, d, 1, dtype)
    return p


def capacity(seq: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(math.ceil(top_k * seq / n_experts * capacity_factor))
    return max(8, min(c, seq * top_k))


def route(params: dict, x: torch.Tensor, top_k: int):
    """Float32 router: ``(probs (B, S, E), gate_vals (B, S, k) normalized
    to sum 1, expert_idx (B, S, k))``, top-k in descending order."""
    probs = torch.softmax(matmul(x.float(), params["router"]), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _shared(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared expert's SwiGLU output, times its sigmoid gate (in the
    weight dtype)."""
    sh = F.silu(matmul(x, params["shared_gate"])) \
        * matmul(x, params["shared_up"])
    sh = matmul(sh, params["shared_down"])
    return sh, torch.sigmoid(matmul(x, params["shared_route"]))


def moe_forward_dense(params: dict, x: torch.Tensor, *, n_experts: int,
                      top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-path MoE: every expert computed for every position, then
    combined with the top-k gates (zero elsewhere).  A decode step reads
    every expert's weights.  The JAX package's three-operand combine
    ``bsef,efd,bse->bsd`` runs as two contractions: the gates scale the
    expert activations, then one GEMM over (expert, ff) — no (B, S, E, F,
    D) intermediate; on DTensors one GEMM an expert, summed over them."""
    b, s, d = x.shape
    # the routing on each rank's rows (sharding.LocalBlocks: the plain
    # ops on plain tensors), the gates written into a block of its own
    blocks = SH.LocalBlocks(x)
    _, gate_vals, expert_idx = route(
        {"router": blocks.param(params["router"])}, blocks.local(x), top_k)
    gates = blocks.rows(gate_vals.new_zeros(
        (*gate_vals.shape[:2], n_experts)).scatter_(-1, expert_idx,
                                                    gate_vals))
    x2 = x.reshape(1, b * s, d)
    # (E, N, F): one batched GEMM a weight, batch over the experts
    hg = matmul(x2, params["experts_gate"])
    hu = matmul(x2, params["experts_up"])
    hf = F.silu(hg) * hu
    e, f = hf.shape[0], hf.shape[-1]
    hf = hf * gates.reshape(b * s, e).t()[..., None].to(hf.dtype)
    if isinstance(hf, DTensor):
        # one GEMM an expert, summed over the experts: DTensor (torch
        # 2.11) has no sharding for flattening (expert, ff) with ff split
        # over the model axis
        out = matmul(hf, params["experts_down"]).sum(0).reshape(b, s, d)
    else:
        out = matmul(hf.permute(1, 0, 2).reshape(b * s, e * f),
                     params["experts_down"].reshape(e * f, d)).reshape(
                         b, s, d)
    if "shared_gate" in params:
        sh, sgate = _shared(params, x)
        out = out + sh * sgate.to(out.dtype)
    return out.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                        device=x.device)


def dispatch_plan(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """Each (token, slot)'s position within its expert, per sequence — a
    cumsum over the flattened ``(S * k)`` routing order — and whether it
    fits the capacity: ``(pos (B, S, k), keep (B, S, k))``."""
    b, s, k = expert_idx.shape
    flat = expert_idx.reshape(b, s * k)
    oh = F.one_hot(flat, n_experts)                        # (B, S*k, E)
    pos_all = torch.cumsum(oh, dim=1) - 1
    pos = torch.gather(pos_all, -1, flat[..., None]).reshape(b, s, k)
    return pos, pos < cap


def moe_forward(params: dict, x: torch.Tensor, *, n_experts: int,
                top_k: int, capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    if s <= DENSE_MAX_SEQ:
        return moe_forward_dense(params, x, n_experts=n_experts,
                                 top_k=top_k)
    e, k = n_experts, top_k
    c = capacity(s, e, k, capacity_factor)
    # dispatch is per sequence, so routing, dispatch and combine run on
    # each rank's own rows (sharding.LocalBlocks), the expert GEMMs on the
    # experts' shards; on plain tensors every LocalBlocks call is the
    # identity
    blocks = SH.LocalBlocks(x)
    xl = blocks.local(x)
    bl = xl.shape[0]
    probs, gate_vals, expert_idx = route(
        {"router": blocks.param(params["router"])}, xl, k)

    # Load-balance aux loss (Switch): E * sum_e f_e * P_e, over the
    # global batch
    me = blocks.mean(probs, (0, 1))
    ce = blocks.mean(F.one_hot(expert_idx, e).float().sum(dim=2),
                     (0, 1)) / k
    aux = e * torch.sum(me * ce)

    pos, keep = dispatch_plan(expert_idx, e, c)
    # The slot buffer is expert-major, (E, B, C, D): slot p of row r's
    # expert x is flat row (x * B + r) * C + p.  The expert GEMMs then
    # merge (B, C) as a view of a contiguous block, which DTensor's plan
    # of the down projection needs on torch 2.11 (a batch-major block's
    # merge is not a view there).  Overflow slots land on slot C - 1 as
    # zeros (and weigh 0 below).
    row = torch.arange(bl, device=x.device)[:, None, None]
    idx = (expert_idx * bl + row) * c \
        + torch.clamp_max(pos, c - 1)                     # (B, S, k)

    buf = torch.zeros((e * bl * c, d), dtype=x.dtype, device=x.device)
    for slot in range(k):
        xk = torch.where(keep[:, :, slot, None], xl, 0).to(x.dtype)
        buf.scatter_add_(0, idx[:, :, slot].reshape(bl * s, 1).expand(
            bl * s, d), xk.reshape(bl * s, d))

    # Expert FFN (SwiGLU) over slots: (E, B, C, D) x (E, D, F); under
    # autograd the experts' d is read whole (sharding.gathered_for_grad:
    # fsdp splits it over data)
    h = blocks.rows(buf.reshape(e, bl, c, d), row_dim=1)
    hg = einsum("ebcd,edf->ebcf", h,
                SH.gathered_for_grad(params["experts_gate"], [-2]))
    hu = einsum("ebcd,edf->ebcf", h,
                SH.gathered_for_grad(params["experts_up"], [-2]))
    hf = F.silu(hg) * hu
    # each rank's rows of every expert's slots (DTensor may have split
    # the experts over the model axis, unevenly: 60 over 16)
    out_buf = blocks.local(einsum(
        "ebcf,efd->ebcd", hf, SH.gathered_for_grad(params["experts_down"],
                                                   [-1])),
        row_dim=1).reshape(e * bl * c, d)

    # Combine: gather each token's slot back, weighted by its gate.
    out = torch.zeros_like(xl)
    for slot in range(k):
        got = torch.gather(out_buf, 0, idx[:, :, slot].reshape(
            bl * s, 1).expand(bl * s, d)).reshape(bl, s, d)
        w = (gate_vals[:, :, slot] * keep[:, :, slot])[..., None]
        out = out + got * w.to(out.dtype)
    out = blocks.rows(out)

    if "shared_gate" in params:
        sh, sgate = _shared(params, x)
        out = out + sh * sgate.to(out.dtype)
    return out, aux
