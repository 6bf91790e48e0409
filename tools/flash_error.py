#!/usr/bin/env python3
"""Where the float32 flash kernel's error sits, on one NVIDIA GPU.

On the starcoder2-3b layer of ``chip_smoke.py`` phase 8 (S 4096, 24 heads
over 2, hd 128, causal, seeds 1 and 2) it compares, against a float64
reference of the same attention:

  kernel    ``flash_attention`` in float32 (the split-TF32 body)
  emulated  the same split arithmetic in PyTorch float32 with
            round-to-nearest accumulation (cuBLAS, TF32 off): S = Qb Kb^T
            + (Qb Ks^T + Qs Kb^T) with Q pre-scaled, softmax, P split, O =
            Pb Vb + Pb Vs + Ps Vb, normalized
  plain     the plain version (``ref_attention``, float32)

and prints the largest and the mean absolute error over query rows that
see 1-16, 17-128, 129-1024 and 1025-4096 keys, so the part of the error
that grows with the keys a row sees stands out.  Then, without the causal
mask, 256 query rows (8 heads over 2, hd 128, seed 3) over 4096, 16384
and 65536 keys: every row sees them all, so each line is the error at
that many keys, for the same three outputs.

    python3 tools/flash_error.py      # needs a card
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import flash_attention, ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import split_tf32  # noqa: E402

S, H, KV, HD = 4096, 24, 2, 128
RANGES = [(0, 16), (16, 128), (128, 1024), (1024, 4096)]
LONG_SQ, LONG_H, LONG_SKV = 256, 8, (4096, 16384, 65536)


def _mask(q, k, causal):
    sq, skv = q.shape[1], k.shape[1]
    return torch.ones(sq, skv, dtype=torch.bool,
                      device=q.device).tril() if causal else None


def exact(q, k, v, causal=True):
    """The same attention in float64 (the plain version computes in
    float32): (B, Sq, H, hd), (B, Skv, KV, hd) -> (B, Sq, H, hd)
    float64."""
    g = q.shape[2] // k.shape[2]
    qh = q[0].double().transpose(0, 1) / math.sqrt(q.shape[-1])
    kh = k[0].double().transpose(0, 1).repeat_interleave(g, 0)
    vh = v[0].double().transpose(0, 1).repeat_interleave(g, 0)
    s = qh @ kh.mT
    mask = _mask(q, k, causal)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return (p @ vh).transpose(0, 1)[None]


def emulated(q, k, v, causal=True):
    """Split-TF32 attention, every product and sum in float32 rounded to
    nearest: (B, Sq, H, hd), (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    g = q.shape[2] // k.shape[2]
    qh = q[0].transpose(0, 1) * (1.0 / math.sqrt(q.shape[-1]))
    kh = k[0].transpose(0, 1).repeat_interleave(g, 0)
    vh = v[0].transpose(0, 1).repeat_interleave(g, 0)
    (qb, qs), (kb, ks), (vb, vs) = (split_tf32(a.contiguous())
                                    for a in (qh, kh, vh))
    s = qb @ kb.mT + (qb @ ks.mT + qs @ kb.mT)
    mask = _mask(q, k, causal)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pb, ps = split_tf32(p)
    o = (pb @ vb + pb @ vs + ps @ vb) / l
    return o.transpose(0, 1)[None]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_error: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.as_tensor(rng.standard_normal((1, S, n, HD)),
                                   dtype=torch.float32, device="cuda")
                   for n in (H, KV, KV))
        with torch.no_grad():
            want = exact(q, k, v)
            got = {"kernel": flash_attention(q, k, v),
                   "emulated": emulated(q, k, v),
                   "plain": ref_attention(q, k, v)}
        for name, out in got.items():
            err = (out.double() - want).abs()[0].amax(dim=(1, 2))
            print(f"seed {seed} {name:8s} max {float(err.max()):.3e} | "
                  + " | ".join(f"keys {lo + 1}-{hi}: max "
                               f"{float(err[lo:hi].max()):.3e} mean "
                               f"{float(err[lo:hi].mean()):.3e}"
                               for lo, hi in RANGES), flush=True)
        del q, k, v, want, got
        torch.cuda.empty_cache()
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.standard_normal((1, LONG_SQ, LONG_H, HD)),
                        dtype=torch.float32, device="cuda")
    for skv in LONG_SKV:
        k, v = (torch.as_tensor(rng.standard_normal((1, skv, KV, HD)),
                                dtype=torch.float32, device="cuda")
                for _ in range(2))
        with torch.no_grad():
            want = exact(q, k, v, causal=False)
            got = {"kernel": flash_attention(q, k, v, causal=False),
                   "emulated": emulated(q, k, v, causal=False),
                   "plain": ref_attention(q, k, v, causal=False)}
            plain = got["plain"]
        print(f"non-causal {LONG_SQ} rows x {skv} keys: " + " | ".join(
            f"{name} max {float((out.double() - want).abs().max()):.3e}"
            for name, out in got.items())
              + f" | kernel vs plain max "
              f"{float((got['kernel'] - plain).abs().max()):.3e}; output "
              f"max |o| {float(want.abs().max()):.3e}", flush=True)
        del k, v, want, got, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
