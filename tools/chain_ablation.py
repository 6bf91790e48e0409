#!/usr/bin/env python3
"""Where the shuffle-GEMM chain kernel's time goes, on one NVIDIA GPU.

Builds ablated copies of ``src/repro_torch/kernels/csrc/shuffle_gemm.cu``
(each with one part of the chain kernel's work taken out, so its output is
no longer the chain's) and times the C entry ``repro_shuffle_gemm_chain``
on the chains of a batch-4 Fig-9 ``value_and_grad`` step at length 4096 —
the STFT's 8 butterflies (forward) and the iSTFT's backward list (8
transposed GEMMs with the width-1 adjoint reductions folded in, and the
last reduction), each a launch over 124 tiles of 512 floats — and on the
paper suite's 512- and 1024-point FFT chains at its 4096 batch rows (one
tile of 1024 and 2048 floats a batch row).  Device times from CUDA-graph
replays, as ``chip_smoke.py`` times its kernels; each call's blocks, tiles
a block (slots) and the bytes its blocks stage into shared memory.

  full     the kernel as it ships
  staged   every group of tiles stops once its first sub-step is computed
           and the later sub-steps' tables and operands have landed
  step0    as staged, with nothing staged (the first sub-step alone)
  tables   as staged, without the first sub-step (the staging alone)
  indices  as tables, without the operands
  empty    returns at once: the launch of its grid and its parameters

Then, on the kernel as it ships, the same launch over the first s
sub-steps of each chain, s = 2 .. S, and each chain's sub-steps launched
one at a time on ``shuffle_gemm_grouped_blocks``: the time each sub-step
adds.

    python3 tools/chain_ablation.py      # needs nvcc and a card
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/shuffle_gemm.cu"
BUILD = ROOT / "build/chain_ablation"
LENGTH, BATCH, CH = 4096, 4, (2, 12, 12, 1)
KERNEL = ("chain_kernel(const T* __restrict__ x, T* __restrict__ out, "
          "const Chain c,\n             const ChainSteps cs) {\n")
TABLES = [("  if (c.shared_bytes)\n", "  if (false)\n"),
          ("    if (c.own_bytes)\n", "    if (false)\n")]
OPERANDS = "  for (int s = 1 + warp; s < c.count; s += warps) {"
NO_OPERANDS = (OPERANDS, OPERANDS.replace("int s = 1 + warp;",
                                          "int s = c.count;"))
STEP0 = "    // step 0 from device memory while the copies land\n    {"
NO_STEP0 = (STEP0, STEP0.replace("    {", "    if (c.count < 0) {"))
RETURN = ("    copies_landed();\n\n    for (int s = 1; s < c.count; ++s) {",
          "    copies_landed();\n    if (c.count > 0) continue;\n\n"
          "    for (int s = 1; s < c.count; ++s) {")
ABLATIONS = {
    "full": [],
    "staged": [RETURN],
    "step0": [*TABLES, NO_OPERANDS, RETURN],
    "tables": [NO_STEP0, RETURN],
    "indices": [NO_STEP0, NO_OPERANDS, RETURN],
    "empty": [(KERNEL, KERNEL + "  if (c.count > 0) return;\n")],
}


def ablated(name: str, edits) -> str:
    """The source with ``edits`` applied; raises if one does not apply."""
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in {SOURCE.name}")
        src = src.replace(old, new)
    return src


def build(name: str, src: str) -> tuple:
    """Write an ablated source and start its nvcc: (library, process)."""
    cu, lib = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    cu.write_text(src)
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def device_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """``reps`` calls captured into a CUDA graph, replayed ``iters``
    times between two CUDA events: the device time of one call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def fig9_chains():
    """The chain calls of one Fig-9 value_and_grad step on ``hopper``:
    ``{label: (x, steps, ws)}`` for the STFT's forward chain and the
    iSTFT's backward chain."""
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels.shuffle_gemm import ops
    from repro_torch.pipelines import speech_enhancement as tse
    rng = np.random.default_rng(0)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device="cuda")
    x = torch.as_tensor(rng.standard_normal((BATCH, LENGTH))
                        .astype(np.float32), device="cuda")
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device="cuda")
    params = dict(c.init_params())
    params["mask"] = cnn
    orig, calls = ops.shuffle_gemm_chain, []

    def rec(xb, seg, ws):
        calls.append((xb.detach().clone(), seg.steps,
                      [w.detach().clone() for w in ws]))
        return orig(xb, seg, ws)
    ops.shuffle_gemm_chain = rec
    try:
        c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)(params, x, x)
        torch.cuda.synchronize()
    finally:
        ops.shuffle_gemm_chain = orig
    fwd = next(call for call in calls if call[1][0].name.startswith("spec"))
    bwd = next(call for call in calls if len(call[1]) == 9)
    return {"STFT forward (8)": fwd, "iSTFT backward (9)": bwd}


def suite_chains():
    """The paper suite's 512- and 1024-point FFT chains at its 4096 batch
    rows (``chip_smoke.paper_suite``, fuse 2): ``{label: (x, steps,
    ws)}``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.signal import SignalGraph
    suite = cs.paper_suite(SignalGraph, 0)
    rng = np.random.default_rng(19)
    out = {}
    for name in ("fft512", "fft1024"):
        g, length, batch = suite[name]
        h = g.compile(length, fuse=2, backend="hopper", device="cuda")
        x = torch.as_tensor(cs.suite_input(np, rng, name, length, batch),
                            device="cuda")
        ((_, a),) = cs.record_calls(torch, lambda: h(x))
        out[f"{name} ({len(a['segment'].steps)}), 4096 rows"] = (
            a["x"], a["segment"].steps, a["ws"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels.shuffle_gemm.chain import segment_chain
    from repro_torch.kernels.shuffle_gemm.kernel import (
        chain_launch_args, shuffle_gemm_steps)
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {name: ablated(name, edits) for name, edits in ABLATIONS.items()}
    jobs = {name: build(name, src) for name, src in sources.items()}
    for name, (_, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
    chains = {**fig9_chains(), **suite_chains()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {}
    for name, (lib_path, _) in jobs.items():
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.repro_shuffle_gemm_chain
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn

    def timed(fn, x, steps, ws):
        (seg,) = segment_chain(steps)
        out, args = chain_launch_args(x, seg, ws)

        def call():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return device_ms(call), seg, args

    for label, call in chains.items():
        _, seg, args = timed(libs["full"], *call)
        blocks, slots, smem = args[6][-3:]
        kern, _ = seg.device_tables(call[0].device, call[0].dtype)
        lay = kern["layout"]
        operands = sum(w.numel() * w.element_size() for w in call[2][1:])
        staged = (blocks * (lay.shared[1] + operands)
                  + call[0].shape[0] * seg.tiles * lay.own_bytes)
        print(f"{label}: {blocks} blocks of {slots} tiles at once, "
              f"{smem} B shared a block; {staged} B staged into shared "
              f"memory (computed from the layout and the blocks)",
              flush=True)
    print(f"{'variant':12s} " + "  ".join(f"{k:>26s}" for k in chains))
    for name, fn in libs.items():
        row = [timed(fn, *call)[0] for call in chains.values()]
        print(f"{name:12s} " + "  ".join(f"{t * 1e3:23.2f} us" for t in row),
              flush=True)
    for label, (x, steps, ws) in list(chains.items())[:2]:    # Fig 9's
        prefix = []
        for s in range(2, len(steps) + 1):
            prefix.append(timed(libs["full"], x, steps[:s], ws[:s])[0])
        (seg,) = segment_chain(steps)
        one = device_ms(lambda: shuffle_gemm_steps(x, seg, ws))
        print(f"{label}, first s sub-steps in one launch, us: "
              + ", ".join(f"s={i + 1} {t * 1e3:.2f}"
                          for i, t in enumerate(prefix, start=1))
              + f"; one launch a sub-step: {one * 1e3:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
