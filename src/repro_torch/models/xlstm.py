"""xLSTM blocks (sLSTM + mLSTM) [arXiv:2405.04517] — the port's
counterpart of the JAX package's ``models/xlstm.py``.

The mLSTM (matrix memory, exponential gates) in three equivalent forms,
each with the JAX package's stabilizers (``m`` starts at -1e30, the
normalizer is ``max(|q . n|, exp(-m))``):

- :func:`mlstm_quadratic`: the full (S, S) decay-masked form, the
  tests' oracle;
- :func:`mlstm_chunkwise`: quadratic within chunks of 256 and the
  ``(C, n, m)`` state carried between them — a Python loop over the
  S / 256 chunks (:func:`repro_torch.loops.scan`), where the JAX package
  runs ``lax.scan``;
- :func:`mlstm_step`: the recurrent decode update.

The sLSTM (scalar memory, per-head recurrent weights) is sequential: a
Python loop over time (:func:`~repro_torch.loops.scan`), as the JAX
package's ``lax.scan``.  A prefill
therefore launches one step's ops per prompt token per sLSTM layer;
:func:`slstm_scan` fuses the four recurrent products into one einsum a
step to keep that count down.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..loops import scan
from . import sharding as SH
from .layers import (causal_conv, causal_conv_step, dense_init, einsum,
                     group_norm, init_causal_conv, matmul)

__all__ = ["mlstm_quadratic", "mlstm_chunkwise", "mlstm_step",
           "slstm_scan", "init_mlstm_block", "mlstm_block",
           "init_slstm_block", "slstm_block"]

M_INIT = -1e30


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------

def mlstm_quadratic(q, k, v, i_gate, f_gate) -> torch.Tensor:
    """Oracle form.  q/k/v: (B, S, H, hd); i/f gates: (B, S, H) pre-act.
    O(S^2) memory — tests and short sequences only."""
    s, hd = q.shape[1], q.shape[-1]
    q = q.float() / math.sqrt(hd)
    k, v = k.float(), v.float()
    bcum = torch.cumsum(F.logsigmoid(f_gate.float()), dim=1)   # inclusive
    # log_D[t, s] = bcum_t - bcum_s + i_s  (s <= t)
    log_d = bcum[:, :, None] - bcum[:, None, :] + i_gate.float()[:, None]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    log_d = torch.where(tri[None, :, :, None], log_d, -torch.inf)
    m = torch.amax(log_d, dim=2)                                # (B,T,H)
    dmat = torch.exp(log_d - m[:, :, None])
    scores = torch.einsum("bthd,bshd->btsh", q, k) * dmat
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))
    return torch.einsum("btsh,bshd->bthd", scores, v) / norm[..., None]


def mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: int = 256,
                    return_state: bool = False):
    """Chunk-parallel mLSTM, equal to the quadratic form.

    Padding uses f=+20 (logsigmoid ~ 0: no decay) and i=-1e30 (no write),
    so padded steps are no-ops and the final state is the state after
    the real tokens (the prefill -> decode handoff)."""
    b, s, h, hd = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = torch.cat([i_gate, i_gate.new_full((b, pad, h), -1e30)],
                           dim=1)
        f_gate = torch.cat([f_gate, f_gate.new_full((b, pad, h), 20.0)],
                           dim=1)
    n_chunks, L = q.shape[1] // chunk, chunk
    qc = q.reshape(b, n_chunks, L, h, hd).float() / math.sqrt(hd)
    kc = k.reshape(b, n_chunks, L, h, hd).float()
    vc = v.reshape(b, n_chunks, L, h, hd).float()
    ic = i_gate.reshape(b, n_chunks, L, h).float()
    fc = F.logsigmoid(f_gate.reshape(b, n_chunks, L, h).float())
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    C = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h), M_INIT, dtype=torch.float32, device=q.device)

    def chunk_step(carry, j):
        C, n, m_run = carry
        qb, kb, vb, ib = qc[:, j], kc[:, j], vc[:, j], ic[:, j]
        bcum = torch.cumsum(fc[:, j], dim=1)           # (B,L,H) in-chunk
        log_d = bcum[:, :, None] - bcum[:, None, :] + ib[:, None]
        log_d = torch.where(tri[None, :, :, None], log_d, -torch.inf)
        m_intra = torch.amax(log_d, dim=2)                     # (B,L,H)
        m_inter = bcum + m_run[:, None, :]                     # (B,L,H)
        m_t = torch.maximum(m_intra, m_inter)
        dmat = torch.exp(log_d - m_t[:, :, None])
        scores = torch.einsum("blhd,bshd->blsh", qb, kb) * dmat
        w_state = torch.exp(m_inter - m_t)                     # (B,L,H)
        num = (torch.einsum("blsh,bshd->blhd", scores, vb)
               + w_state[..., None] * torch.einsum("blhd,bhde->blhe", qb, C))
        # normalizer vector: n_t = sum_s D[t,s] k_s (+ carried state), so
        # that denom = |q . n_t| matches the quadratic sum_s scores[t,s].
        nvec = (torch.einsum("blsh,bshd->blhd", dmat, kb)
                + w_state[..., None] * n[:, None])
        denom = torch.maximum(
            torch.einsum("blhd,blhd->blh", nvec, qb).abs(), torch.exp(-m_t))
        out = num / denom[..., None]

        # state update to end of chunk
        b_last = bcum[:, -1]                                   # (B,H)
        m_next = torch.maximum(
            b_last + m_run,
            torch.amax(b_last[:, None] - bcum + ib, dim=1))
        w_old = torch.exp(b_last + m_run - m_next)             # (B,H)
        w_new = torch.exp(b_last[:, None] - bcum + ib
                          - m_next[:, None])                   # (B,L,H)
        C = (w_old[..., None, None] * C
             + torch.einsum("blhd,blhe->bhde", w_new[..., None] * kb, vb))
        n = w_old[..., None] * n + torch.einsum("blh,blhd->bhd", w_new, kb)
        return (C, n, m_next), out

    (C, n, m_run), outs = scan("xlstm.mlstm_chunks", chunk_step,
                               (C, n, m_run), range(n_chunks))
    out = torch.cat(outs, dim=1)[:, :s]
    if return_state:
        return out, (C, n, m_run)
    return out


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """Decode.  q/k/v_t: (B, H, hd); i/f_t: (B, H); state=(C, n, m)."""
    C, n, m = state
    hd = q_t.shape[-1]
    q32 = q_t.float() / math.sqrt(hd)
    k32, v32 = k_t.float(), v_t.float()
    logf = F.logsigmoid(f_t.float())
    i32 = i_t.float()
    m_new = torch.maximum(logf + m, i32)
    fp = torch.exp(logf + m - m_new)[..., None]
    ip = torch.exp(i32 - m_new)[..., None]
    C = fp[..., None] * C + ip[..., None] * k32[..., None] * v32[..., None, :]
    n = fp * n + ip * k32
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q32).abs(),
                          torch.exp(-m_new))
    out = torch.einsum("bhd,bhde->bhe", q32, C) / denom[..., None]
    return out, (C, n, m_new)


# --------------------------------------------------------------------------
# sLSTM cell
# --------------------------------------------------------------------------

def slstm_scan(params: dict, x: torch.Tensor, h0=None):
    """x: (B, S, D) pre-projected inputs -> (h (B, S, D) in x's dtype,
    carry ``(c, n, m, h)``).  Memory mixing: per-head recurrent weights
    R_* (H, hd, hd), applied as one einsum over their concatenation a
    step."""
    b, s, d = x.shape
    heads, hd = params["s_rz"].shape[0], params["s_rz"].shape[1]
    # on DTensors the recurrence runs on each rank's rows and heads as
    # plain tensors (sharding.LocalBlocks), one region for all the steps
    blocks = SH.LocalBlocks(x, heads=heads)
    w_in = [blocks.local(SH.split_dim(matmul(x, params[n]), -1,
                                      (heads, hd)), 2)
            for n in ("s_wz", "s_wi", "s_wf", "s_wo")]
    w_in = torch.stack(w_in, dim=2)                       # (B,S,4,H,hd)
    r_all = torch.cat([blocks.param(params[n], 0)
                       for n in ("s_rz", "s_ri", "s_rf", "s_ro")],
                      dim=-1)                             # (H, hd, 4 hd)
    bl, hl = w_in.shape[0], w_in.shape[3]
    if h0 is None:
        # made from w_in, so a rank's cost counter reads them as its
        # blocks (sharding.local_copies)
        z0 = w_in.new_zeros((bl, hl, hd), dtype=torch.float32)
        c, n, m = z0, z0, z0 + M_INIT
        h = w_in.new_zeros((bl, hl, hd), dtype=x.dtype)
    else:
        c, n, m, h = (blocks.local(t, 1) for t in h0)

    def time_step(carry, t):
        c, n, m, h = carry
        r = einsum("bhd,hde->bhe", h, r_all).reshape(bl, hl, 4, hd)
        pre = (w_in[:, t].transpose(1, 2) + r).float()       # (B,H,4,hd)
        zt = torch.tanh(pre[:, :, 0])
        it = pre[:, :, 1]
        ft = F.logsigmoid(pre[:, :, 2])
        ot = torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h32 = ot * (c / torch.clamp_min(n, 1e-6))
        return (c, n, m_new, h32.to(x.dtype)), h32

    (c, n, m, h), hs = scan("xlstm.slstm_steps", time_step, (c, n, m, h),
                            range(s))
    out = blocks.rows(torch.stack(hs, dim=1).to(x.dtype).reshape(bl, s, -1),
                      2)
    return out, tuple(blocks.rows(t, 1) for t in (c, n, m, h))


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def init_mlstm_block(gen: torch.Generator, d: int, n_heads: int, dtype,
                     proj_factor: int = 2, conv_width: int = 4) -> dict:
    di = proj_factor * d
    p = {
        "m_up_x": dense_init(gen, d, di, dtype),
        "m_up_z": dense_init(gen, d, di, dtype),
        "m_wq": dense_init(gen, di, di, dtype),
        "m_wk": dense_init(gen, di, di, dtype),
        "m_wv": dense_init(gen, di, di, dtype),
        "m_wi": dense_init(gen, di, n_heads, torch.float32),
        "m_wf": dense_init(gen, di, n_heads, torch.float32),
        "m_down": dense_init(gen, di, d, dtype),
        "m_gn": torch.ones((di,), dtype=torch.float32, device=gen.device),
    }
    p.update(init_causal_conv(gen, conv_width, di, dtype))
    return p


def mlstm_block(params: dict, x: torch.Tensor, n_heads: int,
                mode: str = "train", state=None, chunk: int = 256):
    """x: (B, S, D) (S=1 for decode with mode='decode') -> (out, state):
    state ``((C, n, m), conv)`` after a prefill or decode step, None in
    train mode."""
    b, s, _ = x.shape
    xm = matmul(x, params["m_up_x"])
    z = matmul(x, params["m_up_z"])
    di = xm.shape[-1]
    hd = di // n_heads
    conv = {"conv_w": params["conv_w"]}
    # on DTensors the cell, its gates and its norm run on each rank's
    # rows and heads as plain tensors (sharding.LocalBlocks; the heads
    # gathered where they do not split over the other mesh axes)
    blocks = SH.LocalBlocks(x, heads=n_heads)

    def heads(t):
        return SH.split_dim(t, -1, (n_heads, hd))

    if mode == "decode":
        xc, conv_state = causal_conv_step(conv, xm[:, 0], state[1])
        xc = F.silu(xc)
        q = heads(matmul(xc, params["m_wq"]))
        k = heads(matmul(xc, params["m_wk"]))
        v = heads(matmul(xm[:, 0], params["m_wv"]))
        h, cell = mlstm_step(
            *(blocks.local(t, 1) for t in (q, k, v, matmul(
                xc, params["m_wi"]), matmul(xc, params["m_wf"]))),
            tuple(blocks.local(t, 1) for t in state[0]))
        h = h[:, None]                                    # (B,1,H,hd)
        new_state = (tuple(blocks.rows(t, 1) for t in cell), conv_state)
    else:
        xc = F.silu(causal_conv(conv, xm))
        q = heads(matmul(xc, params["m_wq"]))
        k = heads(matmul(xc, params["m_wk"]))
        v = heads(matmul(xm, params["m_wv"]))
        ig, fg = matmul(xc, params["m_wi"]), matmul(xc, params["m_wf"])
        args = [blocks.local(t, 2) for t in (q, k, v, ig, fg)]
        if mode == "prefill":
            h, cell = mlstm_chunkwise(*args, chunk=chunk, return_state=True)
            width = params["conv_w"].shape[0]
            new_state = (tuple(blocks.rows(t, 1) for t in cell),
                         xm[:, -(width - 1):])
        else:
            h = mlstm_chunkwise(*args, chunk=chunk)
            new_state = None
    # the heads merged on the blocks: a DTensor view of di split 16 ways
    # as 4 heads has no sharding (its gradient would need one)
    m_gn = blocks.param(SH.split_dim(params["m_gn"], 0, (n_heads, hd)), 0)
    h = (group_norm(h.to(x.dtype), 1.0, n_heads) * m_gn).to(x.dtype)
    h = blocks.rows(h.reshape(h.shape[0], h.shape[1], -1), 2)
    out = matmul(h * F.silu(z[:, :h.shape[1]]), params["m_down"])
    return out, new_state


def init_slstm_block(gen: torch.Generator, d: int, n_heads: int,
                     dtype) -> dict:
    hd = d // n_heads
    f = (4 * d // 3 + 63) // 64 * 64

    def rinit():
        return torch.randn((n_heads, hd, hd), generator=gen,
                           device=gen.device,
                           dtype=torch.float32) / math.sqrt(hd)
    p = {n: dense_init(gen, d, d, dtype)
         for n in ("s_wz", "s_wi", "s_wf", "s_wo")}
    p.update({n: rinit() for n in ("s_rz", "s_ri", "s_rf", "s_ro")})
    p.update({
        "s_gn": torch.ones((d,), dtype=torch.float32, device=gen.device),
        "s_up_gate": dense_init(gen, d, f, dtype),
        "s_up": dense_init(gen, d, f, dtype),
        "s_down": dense_init(gen, f, d, dtype),
    })
    return p


def slstm_block(params: dict, x: torch.Tensor, n_heads: int, state=None):
    """x: (B, S, D) -> (out, carry ``(c, n, m, h)``); ``state`` is the
    carry to start from (a decode step), None for zeros: train, prefill
    and decode compute alike."""
    b, s, d = x.shape
    h, carry = slstm_scan(params, x, h0=state)
    # the per-head norm on each rank's rows and heads
    blocks = SH.LocalBlocks(x, heads=n_heads)
    h = blocks.local(SH.split_dim(h, -1, (n_heads, d // n_heads)), 2)
    h = blocks.rows(group_norm(h, 1.0, n_heads).reshape(
        h.shape[0], s, -1), 2)
    h = h * params["s_gn"]
    ff = matmul(F.gelu(matmul(h, params["s_up_gate"]), approximate="tanh")
                * matmul(h, params["s_up"]), params["s_down"])
    return ff.to(x.dtype), carry
