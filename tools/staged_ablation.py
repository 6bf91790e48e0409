#!/usr/bin/env python3
"""Where the staged ``shuffle_gemm_blocks`` body's time goes, on one
NVIDIA GPU.

Builds ablated copies of ``src/repro_torch/kernels/csrc/shuffle_gemm.cu``
(each with one part of the staged body's work taken out, so its output is
no longer the call's) and times the C entry ``repro_shuffle_gemm_blocks``
on the mel call of a batch-4 Fig-9 ``value_and_grad`` step (4 x (31, 129,
24)) and on front1024's mel at the paper suite's 64 batch rows (64 x (31,
513, 64)).  Device times from CUDA-graph replays, as ``chip_smoke.py``
times its kernels:

  full      the body as it ships
  rows      every pass stops once its batch rows' spans of x have landed
            (no sums, no stores)
  operand   returns once the operand and the tile's tables have landed
  launch    returns at once: the launch of its grid and its parameters

Then, on the library as it ships, the same calls on the two bodies a
rule could send them to instead: the wide body (the operand repeated for
each batch row, w (B, t, n_out)) and the sequential body (the call
without its plan's spans), each bit for bit the staged body's output.

    python3 tools/staged_ablation.py      # needs nvcc and a card
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chain_ablation as ca  # noqa: E402
import chip_smoke as cs  # noqa: E402

START = ("  extern __shared__ int4 smem[];\n  char* const base = "
         "reinterpret_cast<char*>(smem);\n  const T* const wsm")
ROWS = "  if (passes > 0)\n    stage_rows("
LANDED = "      cp_async_wait<0>();\n    }\n    __syncthreads();\n"
ABLATIONS = {
    "full": [],
    "rows": [(LANDED, LANDED + "    if (a.t > 0) {\n      __syncthreads();\n"
                               "      continue;\n    }\n")],
    "operand": [(ROWS, "  cp_async_wait<0>();\n  __syncthreads();\n"
                       "  if (a.t > 0) return;\n" + ROWS)],
    "launch": [(START, "  if (a.t > 0) return;\n" + START)],
}


def mel_calls() -> dict:
    """``{label: bound arguments}`` of the two mel calls."""
    import blocks_timing as bt
    from repro_torch.signal import SignalGraph
    fig9 = next(a for name, k, a in bt.fig9_calls()
                if k == "shuffle_gemm_blocks"
                and tuple(a["idx"].shape) == (31, 129))
    g, length, batch = cs.paper_suite(SignalGraph, 0)["front1024"]
    h = g.compile(length, fuse=2, backend="hopper", device="cuda")
    x = torch.as_tensor(cs.suite_input(np, np.random.default_rng(19),
                                       "front1024", length, batch),
                        device="cuda")
    suite = next(a for k, a in cs.record_calls(
        torch, lambda: cs.suite_forward("front1024", h, x))
        if k == "shuffle_gemm_blocks" and tuple(a["idx"].shape) == (31, 513))
    return {"Fig 9 mel 4 x (31, 129, 24)": fig9,
            "front1024 mel 64 x (31, 513, 64)": suite}


def main() -> int:
    if not torch.cuda.is_available():
        print("staged_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    ca.BUILD.mkdir(parents=True, exist_ok=True)
    orig = ca.SOURCE.read_text()
    jobs = {}
    for name, edits in ABLATIONS.items():
        src = orig
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in the source")
            src = src.replace(old, new)
        jobs[name] = ca.build(f"staged_{name}", src)
    for name, (_, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
    calls = mel_calls()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    entries = {}
    for name, (lib_path, _) in jobs.items():
        fn = ctypes.CDLL(str(lib_path)).repro_shuffle_gemm_blocks
        fn.argtypes = list(kernels._SIGNATURES["repro_shuffle_gemm_blocks"])
        fn.restype = ctypes.c_int
        entries[name] = fn

    def timed(fn, a):
        _, args = sgk.blocks_launch_args(**a)

        def call():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        call()
        return statistics.median(ca.device_ms(call) for _ in range(3)), args

    print(f"{'variant':22s} " + "  ".join(f"{k:>34s}" for k in calls))
    for name, fn in entries.items():
        row = [timed(fn, a) for a in calls.values()]
        body = ", ".join(sgk.BODIES[args[13][-1]] for _, args in row)
        print(f"{name:22s} " + "  ".join(f"{t * 1e3:31.3f} us"
                                         for t, _ in row) + f"  ({body})",
              flush=True)

    # the same calls on the other bodies, their operands made beforehand
    bodies = {"wide (w per row)": [
                  dict(a, w=a["w"].expand(a["x"].shape[0], *a["w"].shape)
                       .contiguous(), spans=None) for a in calls.values()],
              "sequential (no spans)": [dict(a, spans=None)
                                        for a in calls.values()]}
    for name, args in bodies.items():
        row = []
        for a, b in zip(calls.values(), args):
            with torch.no_grad():
                if not torch.equal(sgk.shuffle_gemm_blocks(**b),
                                   sgk.shuffle_gemm_blocks(**a)):
                    raise AssertionError(f"{name} is not the staged body's "
                                         f"output")
                row.append(statistics.median(ca.device_ms(
                    lambda: sgk.shuffle_gemm_blocks(**b)) for _ in range(3)))
        print(f"{name:22s} " + "  ".join(f"{t * 1e3:31.3f} us" for t in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
