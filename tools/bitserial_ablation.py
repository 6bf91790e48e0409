#!/usr/bin/env python3
"""Where the bitserial kernels' time goes, on one NVIDIA GPU.

Builds ablated copies of ``src/repro_torch/kernels/csrc/bitserial_mm.cu``
(each with one part of the work taken out, so its output is no longer the
product) and times both entries — ``repro_bitserial_quant_matmul`` (the
int route in one launch) and ``repro_bitserial_matmul_planes`` — on the
three int-routed calls of a batch-4 Fig-9q forward at widths (16, 8):
front.taps (M 16384, K 9, N 1), mask.gemm (496, 256, 64) and mel_tap.mel
(124, 129, 24).  Device times from CUDA-graph replays, as ``chip_smoke.py``
times its kernels.

  full       the kernels as they ship
  no_mma     each MMA an integer add of its fragments: everything but
             the tensor cores
  no_quant   the one-launch kernel's quantize without its IEEE division
  staged     each kernel returns once its first K chunk is staged in
             shared memory (the one-launch kernel's float tiles, the planes
             kernel's digit planes)
  scales     the one-launch kernel returns once its row and column scales
             are known (the planes kernel as in full)
  digits     the one-launch kernel returns once the digits of its first
             chunk are in shared memory (the planes kernel as in full)
  empty      each kernel returns at once: the launch of its grid

    python3 tools/bitserial_ablation.py      # needs nvcc and a card
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
from repro_torch.core import bitwidth as bw  # noqa: E402
from repro_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/bitserial_mm.cu"
BUILD = ROOT / "build/bitserial_ablation"
CALLS = [("front.taps", 16384, 9, 1), ("mask.gemm", 496, 256, 64),
         ("mel_tap.mel", 124, 129, 24)]
WIDTHS = (16, 8)
ENTRY = ("      int32_t* __restrict__ out, int m, int k, int n, int aligned,"
         "\n              int pa_any, int pw_any) {\n",
         "             float* __restrict__ y, int rows, int k, int n) {\n")
ABLATIONS = {
    "full": [],
    "no_mma": [("  asm volatile(\n      \"mma.sync",
                "  c[0] += a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1];\n"
                "  if (false) asm volatile(\n      \"mma.sync")],
    "no_quant": [("rintf(__fdiv_rn(x == 0.0f ? scale : x, scale));",
                  "rintf(x * scale);")],
    "staged": [("    stage(c0, l);\n    h_mx",
                "    stage(c0, l);\n    if (k > 0) return;\n    h_mx"),
               ("    if (aligned) cp_async_wait_all();\n"
                "    __syncthreads();\n",
                "    if (aligned) cp_async_wait_all();\n"
                "    __syncthreads();\n    if (k > 0) return;\n")],
    "scales": [("  if (warp < BN && lane == 0) w_scale[warp] = wsc;\n",
                "  if (warp < BN && lane == 0) w_scale[warp] = wsc;\n"
                "  if (k > 0) return;\n")],
    "digits": [("ws + warp * stride, BN * stride);\n    __syncthreads();\n",
                "ws + warp * stride, BN * stride);\n    __syncthreads();\n"
                "    if (k > 0) return;\n")],
    "empty": [(e, e + "  if (k > 0) return;\n") for e in ENTRY],
}


def build(name: str, edits) -> tuple:
    """Write the ablated source and start its nvcc: (library, process)."""
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in {SOURCE.name}")
        src = src.replace(old, new)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bitserial_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {name: build(name, edits) for name, edits in ABLATIONS.items()}
    for name, (_, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
    rng = np.random.default_rng(2)
    aw, ww = WIDTHS
    inputs = []
    for _, m, k, n in CALLS:
        h = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                            device="cuda")
        w = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                            device="cuda")
        ap = torch.stack(bw.split_planes(bw.quantize(h, aw)[0], aw))
        wp = torch.stack(bw.split_planes(bw.quantize(w, ww, 0)[0], ww))
        inputs.append((h, w, ap.contiguous(), wp.contiguous()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"{'variant':10s} {'entry':10s} "
          + "  ".join(f"{lab:>12s}" for lab, *_ in CALLS))
    for name, (lib_path, _) in jobs.items():
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("repro_bitserial_quant_matmul",
                      "repro_bitserial_matmul_planes"):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            row = []
            for (_, m, k, n), (h, w, ap, wp) in zip(CALLS, inputs):
                quant = entry.endswith("quant_matmul")
                out = torch.empty((m, n), device="cuda", dtype=torch.float32
                                  if quant else torch.int32)
                args = ((h.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                         aw, ww) if quant else
                        (ap.data_ptr(), wp.data_ptr(), out.data_ptr(),
                         ap.shape[0], wp.shape[0], m, k, n))

                def call():
                    err = fn(*args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {entry}: CUDA error {err}")
                row.append(device_ms(call))
            label = "one-launch" if "quant" in entry else "planes"
            print(f"{name:10s} {label:10s} "
                  + "  ".join(f"{t * 1e3:9.2f} us" for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
