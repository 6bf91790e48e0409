#!/usr/bin/env python3
"""Device times, output digests and staged bytes of the shuffle-GEMM
kernels at Fig 9's calls and the paper suite's, for one checkout, on one
NVIDIA GPU.

Builds the kernels of the checkout at ``--root`` (default: this one),
records the kernel calls that checkout's own ops make — as
``chip_smoke.record_calls`` records them — and, for each, holds the
kernel against its plain version (rtol 1e-4, atol 1e-4 x max|want|),
times it with CUDA-graph replays (``chip_smoke.device_ms``, the median of
three) and through its wrapper from the host (``chip_smoke.wall_ms``:
launch overhead included), and prints the first 16 hex digits of the SHA-1 of its output
bytes, the body its launch reports (a checkout whose launches report
none: blank) and the bytes its blocks copy into shared memory from
device memory.  Those bytes are computed, not measured: from the call's
layout and the grid its launch reports (:func:`staged_bytes`; for a
checkout whose launches report none, :func:`parent_staged_bytes`).
Float32 operands; the calls, on seeded inputs:

  fig9      a batch-4 Fig-9 value_and_grad step (length 4096, mask CNN
            (2, 12, 12, 1)): the FIR taps and the mel (shuffle_gemm_blocks),
            the STFT and iSTFT chains and their backward chains, the STFT
            framing's adjoint; the per-row FIR call of an 8-row
            cross-graph wave (w (8, 9, 1)); one grouped butterfly step
  suite     every kernel call of a fuse-2 forward of each
            chip_smoke.paper_suite workload at its chip_smoke batch (4096
            rows, 4096 DCT blocks: 131072 rows of 32, front1024 64): the
            FIRs, DCT, DWT and front1024's FIR and mel on
            shuffle_gemm_blocks, the FFT chains at 128-1024 points,
            FFT -> iFFT and front1024's STFT on shuffle_gemm_chain

Two checkouts on one card, in turns, also compare bit for bit (the
digests):

    python3 tools/blocks_timing.py --root build/parent
    python3 tools/blocks_timing.py
    python3 tools/blocks_timing.py
    python3 tools/blocks_timing.py --root build/parent

``tools/chain_ablation.py`` times the chain kernel's parts.  Prints the
card's name and power limit, a line a call, then one JSON line:
``{"root": ..., "calls": {name: {"ms", "wall_ms", "max_abs_err",
"digest", "staged_bytes_computed", "body"}}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

LENGTH, CH = 4096, (2, 12, 12, 1)


def fig9_calls():
    """``[(name, kernel, args)]`` of Fig 9's calls (see the docstring)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.pipelines import speech_enhancement as tse
    rng = np.random.default_rng(0)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device="cuda")
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device="cuda")
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device="cuda")
    params = dict(c.init_params())
    params["mask"] = cnn
    vag = c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
    calls = cs.record_calls(torch, lambda: vag(params, x, x), grad=True)
    out = [(f"fig9 {_shape(k, a)}", k, a) for k, a in calls]
    fir = next(a for k, a in calls if k == "shuffle_gemm_blocks"
               and tuple(a["idx"].shape) == (4096, 9))
    w = torch.as_tensor(rng.standard_normal((8, 9, 1)).astype(np.float32),
                        device="cuda")
    per_row = {k: v for k, v in fir.items() if k != "spans"}
    per_row.update(x=torch.as_tensor(rng.standard_normal((8, 4096)).astype(
        np.float32), device="cuda"), w=w)
    out.append(("fig9 per-row FIR w (8, 9, 1)", "shuffle_gemm_blocks",
                per_row))
    chain = next(a for k, a in calls if k == "shuffle_gemm_chain")
    (idx, pads, w0, reps, groups, nb, scale), *_ = _chain_steps(chain)
    out.append(("fig9 one grouped butterfly step",
                "shuffle_gemm_grouped_blocks",
                dict(x=chain["x"], idx=idx, pad_vals=pads, w=w0, reps=reps,
                     groups=groups, nb=nb, scale=scale)))
    return out


def _chain_steps(a):
    from repro_torch.kernels.shuffle_gemm.kernel import chain_steps
    return chain_steps(a["segment"], a["ws"], a["x"].device, a["x"].dtype)


def suite_calls():
    """``[(name, kernel, args)]`` of the paper suite's forward calls."""
    from repro_torch.signal import SignalGraph
    suite = cs.paper_suite(SignalGraph, 0)
    rng = np.random.default_rng(19)
    out = []
    for name, (g, length, batch) in suite.items():
        h = g.compile(length, fuse=2, backend="hopper", device="cuda")
        x = torch.as_tensor(cs.suite_input(np, rng, name, length, batch),
                            device="cuda")
        out += [(f"{name} {_shape(k, a)}", k, a) for k, a in
                cs.record_calls(torch, lambda: cs.suite_forward(name, h, x))]
    return out


def _shape(kernel: str, a: dict) -> str:
    if kernel == "shuffle_gemm_chain":
        seg = a["segment"]
        return (f"chain of {len(seg.steps)}, {a['x'].shape[0]} x "
                f"{seg.tiles} tiles")
    (r, t), n_out = a["idx"].shape, a["w"].shape[-1]
    return f"{a['x'].shape[0]} x ({r}, {t}, {n_out})"


def launched(sgk, kernel: str, a: dict):
    """What one launch of the call reports, through the checkout's
    launch-args entries: ``(body, ints)`` — the body's name and the ints
    its C entry wrote after the dims (blocks: grid x, grid y, rows or
    batch rows a block, body; chain: blocks, slots, shared bytes a block)
    — or ``(None, None)`` where the checkout's launches report nothing
    (no ``blocks_launch_args``) or the kernel is the grouped one."""
    from repro_torch import kernels
    if not hasattr(sgk, "blocks_launch_args") \
            or kernel == "shuffle_gemm_grouped_blocks":
        return None, None
    if kernel == "shuffle_gemm_blocks":
        _, args = sgk.blocks_launch_args(**a)
        kernels.launch("repro_shuffle_gemm_blocks", a["x"].device, *args)
        ints = list(args[13][-4:])
        return sgk.BODIES[ints[3]], ints
    _, args = sgk.chain_launch_args(**a)
    kernels.launch("repro_shuffle_gemm_chain", a["x"].device, *args)
    return "chain", list(args[6][-3:])


def span_chunk_bytes(a: dict, tiling) -> int:
    """Bytes the staged body copies of ``x``: per batch row and tile, the
    16-byte chunks from the one holding the tile's first staged element
    to the one holding its last (the kernel's spans: the table's, or the
    affine ``[max(0, hi - len), min(n_in, hi))``), at most a staged row's
    chunks — as ``stage_rows`` copies them, at ``x``'s own address."""
    x = a["x"]
    (b, n_in), es = x.shape, x.element_size()
    tiles = -(-a["idx"].shape[0] // tiling.rt)
    if tiling.affine is None:
        lo, hi = a["spans"].tiles(tiling.rt).astype(np.int64).T
    else:
        step, hi0, length = tiling.affine
        top = hi0 + step * np.arange(tiles, dtype=np.int64)
        lo, hi = np.maximum(0, top - length), np.minimum(n_in, top)
    keep = hi > lo
    row = x.data_ptr() + np.arange(b, dtype=np.int64)[:, None] * n_in * es
    first, end = row + lo[keep] * es, row + hi[keep] * es
    chunks = np.minimum((end + 15) // 16 - first // 16, tiling.row_bytes // 16)
    return int(chunks.sum()) * 16


def staged_bytes(sgk, kernel: str, a: dict, body, ints) -> int:
    """Bytes a call's blocks copy into shared memory from device memory,
    computed from its layout and the grid its launch reported: the
    staged body's blocks each the operand and their tile's tables (a
    run's first indices alone), each batch row's span of every tile
    (:func:`span_chunk_bytes`); the wide body's blocks each its batch
    row's operand, every batch row its rows' gathered values (and
    scales); the chain's blocks each the shared tables and every later
    operand, every (batch row, tile) pair its own tables; the sequential
    and grouped bodies nothing.  A checkout whose launches report no
    body: :func:`parent_staged_bytes`."""
    if body is None:
        return parent_staged_bytes(kernel, a)
    x = a["x"]
    b, es = x.shape[0], x.element_size()
    if kernel == "shuffle_gemm_chain":
        seg = a["segment"]
        lay = seg.device_tables(x.device, x.dtype)[0]["layout"]
        operands = sum(w.numel() for w in a["ws"][1:]) * es
        return (ints[0] * (lay.shared[1] + operands)
                + b * seg.tiles * lay.own_bytes)
    (rows, t), n_out = a["idx"].shape, a["w"].shape[-1]
    scaled = a.get("scale") is not None
    if body == "sequential":
        return 0
    if body == "wide":
        return (ints[0] * b * t * n_out * es
                + b * rows * t * es * (2 if scaled else 1))
    from repro_torch.kernels.shuffle_gemm.tiling import RUN
    tl = sgk.blocks_tiling(x, a["idx"], a["w"], a.get("scale"),
                           a.get("spans"))
    per_row = (4 if tl.mode == RUN else 4 * t) + es * t * (
        (tl.off_pad >= 0) + (tl.off_scale >= 0))
    return (ints[0] * ints[1] * t * n_out * es + ints[1] * rows * per_row
            + span_chunk_bytes(a, tl))


def parent_staged_bytes(kernel: str, a: dict) -> int:
    """Bytes a call of a checkout whose launches report nothing stages
    (computed): the wide body (t >= 32 where its staging fits) copies, a
    block of ``rpc`` rows of one batch row, the operand and the rows'
    gathered values (and scales); the chain, a block of
    ``tiles_per_cta`` tiles of one batch row, its layout's tables and
    every later operand; the sequential body stages nothing."""
    es = a["x"].element_size()
    if kernel == "shuffle_gemm_chain":
        seg, b = a["segment"], a["x"].shape[0]
        kern, _ = seg.device_tables(a["x"].device, a["x"].dtype)
        lay = kern["layout"]
        blocks = b * seg.tiles // seg.tiles_per_cta
        operands = sum(w.numel() for w in a["ws"][1:]) * es
        return blocks * (lay.shared[1] + lay.own[1] + operands)
    if kernel != "shuffle_gemm_blocks":
        return 0
    (b, _), (r, t), n_out = a["x"].shape, a["idx"].shape, a["w"].shape[-1]
    rpc = max(1, min(r, 32 // n_out))
    scaled = a.get("scale") is not None
    smem = (-(-es * t * n_out // 16) * 16
            + -(-rpc * t * es // 16) * 16 * (2 if scaled else 1))
    if t < 32 or smem > 227 * 1024:
        return 0
    return b * -(-r // rpc) * t * n_out * es + b * r * t * es * (
        2 if scaled else 1)


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
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    from repro_torch.kernels.shuffle_gemm.ref import (
        ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks)
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    fns = {"shuffle_gemm_blocks": (sgk.shuffle_gemm_blocks,
                                   ref_shuffle_gemm_blocks),
           "shuffle_gemm_grouped_blocks": (sgk.shuffle_gemm_grouped_blocks,
                                           ref_shuffle_gemm_grouped_blocks),
           "shuffle_gemm_chain": (sgk.shuffle_gemm_chain, sgk.ref_chain)}
    out = {}
    for name, kernel, a in fig9_calls() + suite_calls():
        while name in out:
            name += "'"
        fn, ref = fns[kernel]
        with torch.no_grad():
            got = fn(**a)
            want = ref(**{k: v for k, v in a.items() if k != "spans"})
            err = cs.suite_close(torch, name, got, want, 1e-4)
            ms = statistics.median(cs.device_ms(torch, lambda: fn(**a))
                                   for _ in range(3))
            wall = cs.wall_ms(torch, lambda: fn(**a))
            body, ints = launched(sgk, kernel, a)
        staged = staged_bytes(sgk, kernel, a, body, ints)
        digest = hashlib.sha1(got.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()[:16]
        out[name] = {"ms": ms, "wall_ms": wall, "max_abs_err": err,
                     "digest": digest, "staged_bytes_computed": staged,
                     "body": body}
        print(f"  {name:48s} {ms * 1e3:9.3f} us  wrapper {wall * 1e3:8.2f} "
              f"us  {digest}  into shared memory (computed) {staged:>12d} B"
              f"  {body or ''}", flush=True)
    print(json.dumps({"root": str(root), "calls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
