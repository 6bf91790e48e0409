#!/usr/bin/env python3
"""Where the bfloat16 flash-attention kernel's time goes, on one NVIDIA GPU.

Builds ablated copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(each with one part of the per-tile work taken out, so its output is no
longer attention) and times each with CUDA events on the two bfloat16
layers of ``chip_smoke.py`` phase 8: starcoder2-3b (S 4096, 24 heads over
2, hd 128, causal) and gemma2-2b local (S 8192, 8 heads over 4, hd 256,
window 4096, softcap 50).

  full         the kernel as it ships
  no_wgmma     no tensor-core products: loads, barriers, softmax
  no_softmax   no scale, softcap, masks or exponentials: loads, barriers,
               the products
  loads_only   neither: the TMA ring and the barriers
  tanhf        the softcap through the C library's tanhf

    python3 tools/flash_ablation.py      # needs nvcc and a card
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

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
BUILD = ROOT / "build/flash_ablation"
LAYERS = [  # label, S, H, KV, hd, window, softcap (all causal, batch 1)
    ("starcoder2-3b", 4096, 24, 2, 128, 0, 0.0),
    ("gemma2-2b local", 8192, 8, 4, 256, 4096, 50.0),
]
NO_WGMMA = [("      wgmma_ss<BK>(s,", "      if (false) wgmma_ss<BK>(s,"),
            ("      wgmma_rs<D>(o,", "      if (false) wgmma_rs<D>(o,")]
NO_SOFTMAX = [("  auto softmax = [&](int t) {\n",
               "  auto softmax = [&](int t) {\n    if (true) {\n"
               "#pragma unroll\n"
               "      for (int i = 0; i < NS; ++i) l_a += s[i];\n"
               "      return;\n    }\n")]
ABLATIONS = {
    "full": [],
    "no_wgmma": NO_WGMMA,
    "no_softmax": NO_SOFTMAX,
    "loads_only": NO_WGMMA + NO_SOFTMAX,
    "tanhf": [("softcap * tanh_f32(", "softcap * tanhf(")],
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


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {name: build(name, edits) for name, edits in ABLATIONS.items()}
    for name, (_, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
    rng = np.random.default_rng(1)
    inputs = [[torch.as_tensor(rng.standard_normal((1, s, n, hd)),
                               dtype=torch.float32, device="cuda")
               .to(torch.bfloat16) for n in (h, kv, kv)]
              for _, s, h, kv, hd, _, _ in LAYERS]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"{'variant':12s} "
          + "  ".join(f"{lab:>16s}" for lab, *_ in LAYERS))
    for name, (lib_path, _) in jobs.items():
        fn = ctypes.CDLL(str(lib_path)).repro_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        row = []
        for (_, s, h, kv, hd, win, cap), (q, k, v) in zip(LAYERS, inputs):
            out = torch.empty_like(q)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), 1, s, s, h, kv, hd, 1, win, cap, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            row.append(time_ms(call))
        print(f"{name:12s} " + "  ".join(f"{t * 1e3:13.1f} us" for t in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
