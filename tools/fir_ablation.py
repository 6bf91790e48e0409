#!/usr/bin/env python3
"""Where the phased-FIR kernel's time goes, on one NVIDIA GPU.

Builds variants of ``src/repro_torch/kernels/csrc/fir_conv.cu`` and times
each with CUDA-graph replays on Fig 9's call (batch 4, n 4096, 9 taps, 8
phases: 512 windows of 16 indices), in turns with the 8 x 128 copy probe
of ``shuffle_gemm.cu`` (the launch floor: one load and one store a
thread), after checking each against the plain version:

  unrolled   the kernel as it ships: each thread loads its window's
             indices (16-byte loads) and taps, then all its samples
  staged     a block first stages its windows' indices and the tap bank
             in shared memory (one barrier), then as above
  generic    the generic body (runtime L and P: the kernel this file
             held before the unrolled one)
  one_load   unrolled, but every index read as 0 (no dependent load: one
             round trip to memory, what the index table costs)

    python3 tools/fir_ablation.py      # needs nvcc and a card
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
from repro_torch.core import signal_mapping as sm  # noqa: E402
from repro_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.fir_conv import ops as fir_ops  # noqa: E402
from repro_torch.kernels.fir_conv.ref import ref_fir_conv_hopper  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/fir_conv.cu"
PROBE = ROOT / "src/repro_torch/kernels/csrc/shuffle_gemm.cu"
BUILD = ROOT / "build/fir_ablation"
UNROLLED_LOADS = '''  const int r = threadIdx.x / P, p = threadIdx.x - r * P;
  const int row = blockIdx.x * R + r;
  if (row >= m) return;
  const int4* ri = reinterpret_cast<const int4*>(idx) +
                   static_cast<int64_t>(row) * (L / 4);
  int32_t iv[L];
  float wv[L], xv[L];
#pragma unroll
  for (int l = 0; l < L; l += 4) {
    const int4 w = __ldg(ri + l / 4);
    iv[l] = w.x;
    iv[l + 1] = w.y;
    iv[l + 2] = w.z;
    iv[l + 3] = w.w;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) wv[l] = __ldg(wbank + l * P + p);
'''
STAGED_LOADS = '''  __shared__ int32_t si[L][R];
  __shared__ float sw[L * P];
  const int tid = threadIdx.x, m0 = blockIdx.x * R, rows = min(R, m - m0);
  const int4* src = reinterpret_cast<const int4*>(idx + m0 * L);
  for (int i = tid; i < rows * L / 4; i += kThreads) {
    const int4 w = src[i];
    const int rr = 4 * i / L, l = 4 * i - rr * L;
    si[l][rr] = w.x;
    si[l + 1][rr] = w.y;
    si[l + 2][rr] = w.z;
    si[l + 3][rr] = w.w;
  }
  for (int i = tid; i < L * P / 4; i += kThreads)
    reinterpret_cast<float4*>(sw)[i] =
        reinterpret_cast<const float4*>(wbank)[i];
  __syncthreads();
  const int r = tid / P, p = tid - r * P;
  const int row = m0 + r;
  if (row >= m) return;
  int32_t iv[L];
  float wv[L], xv[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    iv[l] = si[l][r];
    wv[l] = sw[l * P + p];
  }
'''
DISPATCH = "  if (win == 16 && phases == 8 && "
VARIANTS = {
    "unrolled": [],
    "staged": [(UNROLLED_LOADS, STAGED_LOADS)],
    "generic": [(DISPATCH, "  if (false && ")],
    "one_load": [("xv[l] = iv[l] < 0 ? 0.f : __ldg(xb + iv[l]);",
                  "xv[l] = __ldg(xb + l);")],
}


def build(name: str, src: str) -> tuple:
    cu, lib = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    cu.write_text(src)
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def device_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """``reps`` calls in a CUDA graph, replayed ``iters`` times."""
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
        print("fir_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    BUILD.mkdir(parents=True, exist_ok=True)
    base = SOURCE.read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {SOURCE.name}")
            src = src.replace(old, new)
        jobs[name] = build(name, src)
    jobs["probe"] = build("probe", PROBE.read_text())
    libs = {}
    for name, (path, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
        libs[name] = ctypes.CDLL(str(path))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((4, 4096)), dtype=torch.float32,
                        device="cuda")
    h = torch.as_tensor(np.hanning(9) / np.hanning(9).sum(),
                        dtype=torch.float32, device="cuda")
    idx = fir_ops._window_index(fir_ops._plan(4096, 9, 8), "cuda")
    wbank = sm.fir_phase_weights_torch(h, 8).contiguous()
    out = torch.empty((4, 4096), device="cuda")
    want = ref_fir_conv_hopper(x, idx, wbank)
    px = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    py = torch.empty_like(px)
    P = ctypes.c_void_p

    def stream():               # the stream a graph capture runs on
        return torch.cuda.current_stream().cuda_stream

    def call(name):
        fn = libs[name].repro_fir_conv
        fn.argtypes = [P] * 4 + [ctypes.c_int] * 5 + [P]
        return lambda: fn(x.data_ptr(), idx.data_ptr(), wbank.data_ptr(),
                          out.data_ptr(), 4, 4096, 512, 16, 8, stream())

    copy = libs["probe"].repro_copy_f32
    copy.argtypes = [P, P, ctypes.c_int, P]

    def probe():
        copy(px.data_ptr(), py.data_ptr(), px.numel(), stream())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name in VARIANTS:
        if call(name)():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if name != "one_load" and not err <= 1e-5:
            raise AssertionError(f"{name}: max abs error {err:.3e}")
        turns = [device_ms(f) for f in (probe, call(name), call(name),
                                        probe)]
        print(f"{name:9s} kernel {(turns[1] + turns[2]) / 2 * 1e3:.3f} us, "
              f"probe {(turns[0] + turns[3]) / 2 * 1e3:.3f} us (in turns "
              + ", ".join(f"{t * 1e3:.3f}" for t in turns) + f"); max abs "
              f"err {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
