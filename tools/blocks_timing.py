#!/usr/bin/env python3
"""Device times of the two shuffle-GEMM block kernels at Fig 9's calls and
the paper suite's, for one checkout, on one NVIDIA GPU.

Builds the kernels of the checkout at ``--root`` (default: this one),
holds each call of ``shuffle_gemm_blocks`` / ``shuffle_gemm_grouped_blocks``
against its plain version (rtol 1e-5, atol 1e-5 x max|want|) and times it
with CUDA-graph replays (``chip_smoke.device_ms``, the median of three).
The calls, on seeded float32 operands:

  fig9_fir        Fig 9's FIR: batch 4, rows 4096, t 9, n_out 1, PAD at
                  the causal edge (sequential body)
  fig9_mel        Fig 9's mel: batch 4, rows 31, t 129, n_out 24 (wide)
  fig9_per_row    the per-row FIR of an 8-row cross-graph wave: w (8, 9, 1)
  fig9_stft_step  one grouped butterfly step of Fig 9's STFT: batch 4,
                  3968 rows of t 4, n_out 4, 2 groups
  fir256_80       batch 4096, rows 256, t 80, n_out 1 (wide)
  fir256_80_phased  batch 4096, rows 32, t 87, n_out 8 (wide)
  dwt_haar        batch 4096, rows 512, t 2, n_out 2 (sequential)
  front1024_mel   batch 64, rows 31, t 513, n_out 64 (wide, 2 passes)
  dct32_65535     batch 65535 (the grid's y extent), rows 1, t 32, n_out 32
  dct32_131072    batch 131072 (the 2-D DCT of 4096 blocks): a kernel that
                  takes at most 65535 batch rows refuses it

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run both on the same card, in turns:

    python3 tools/blocks_timing.py --root build/parent
    python3 tools/blocks_timing.py
    python3 tools/blocks_timing.py
    python3 tools/blocks_timing.py --root build/parent

Prints the card's name and power limit, then one JSON line per run:
``{"root": ..., "calls": {name: {"ms", "max_abs_err"} or {"refused"}}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
from chip_smoke import device_ms  # noqa: E402


def _causal_idx(rows: int, t: int) -> np.ndarray:
    """Row r gathers x[r - k], k < t; PAD (-1) before the start."""
    idx = np.arange(rows)[:, None] - np.arange(t)[None, :]
    return np.where(idx < 0, -1, idx).astype(np.int32)


def _phased_idx(rows: int, t: int, phases: int) -> np.ndarray:
    """Window r ends at sample phases * r + phases - 1 and reaches t back;
    PAD before the start."""
    idx = (phases * np.arange(rows)[:, None] + phases - 1
           - np.arange(t)[None, :])
    return np.where(idx < 0, -1, idx).astype(np.int32)


def _in_order(rows: int, t: int) -> np.ndarray:
    return np.arange(rows * t, dtype=np.int32).reshape(rows, t)


# name: (batch, n_in, idx, n_out, per-row w, grouped (groups, nb) or None)
CALLS = {
    "fig9_fir": (4, 4096, _causal_idx(4096, 9), 1, False, None),
    "fig9_mel": (4, 3999, _in_order(31, 129), 24, False, None),
    "fig9_per_row": (8, 4096, _causal_idx(4096, 9), 1, True, None),
    "fig9_stft_step": (4, 3968 * 4, _in_order(3968, 4), 4, False,
                       (2, 1984)),
    "fir256_80": (4096, 256, _causal_idx(256, 80), 1, False, None),
    "fir256_80_phased": (4096, 256, _phased_idx(32, 87, 8), 8, False,
                         None),
    "dwt_haar": (4096, 1024, _in_order(512, 2), 2, False, None),
    "front1024_mel": (64, 15903, _in_order(31, 513), 64, False, None),
    "dct32_65535": (65535, 32, _in_order(1, 32), 32, False, None),
    "dct32_131072": (131072, 32, _in_order(1, 32), 32, False, None),
}


def operands(name: str, device: str) -> dict:
    """The seeded float32 operands of call ``name`` on ``device``."""
    batch, n_in, idx, n_out, per_row, grouped = CALLS[name]
    rows, t = idx.shape
    w_shape = ((grouped[0], t, n_out) if grouped else
               (batch, t, n_out) if per_row else (t, n_out))
    rng = np.random.default_rng(len(name))
    a = {k: torch.as_tensor(v, device=device) for k, v in dict(
        x=rng.standard_normal((batch, n_in), np.float32), idx=idx,
        pad_vals=rng.standard_normal((rows, t), np.float32),
        w=rng.standard_normal(w_shape, np.float32)).items()}
    if grouped:
        a.update(reps=1, groups=grouped[0], nb=grouped[1])
    return a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose kernels are built and timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blocks_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch import kernels
    from repro_torch.kernels.shuffle_gemm import (
        ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks,
        shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    out = {}
    for name in CALLS:
        a = operands(name, "cuda")
        fn, ref = ((shuffle_gemm_grouped_blocks,
                    ref_shuffle_gemm_grouped_blocks) if "groups" in a
                   else (shuffle_gemm_blocks, ref_shuffle_gemm_blocks))
        try:
            got = fn(**a)
        except ValueError as e:
            out[name] = {"refused": str(e)}
            continue
        want = ref(**a)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        ms = statistics.median(device_ms(torch, lambda: fn(**a))
                               for _ in range(3))
        out[name] = {"ms": ms,
                     "max_abs_err": float((got - want).abs().max())}
        print(f"  {name:18s} {ms * 1e3:9.3f} us", flush=True)
    print(json.dumps({"root": str(root), "calls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
