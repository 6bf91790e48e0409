#!/usr/bin/env python3
"""Where the flash-attention kernels' time goes, on one NVIDIA GPU.

Builds ablated copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(each with one part of the per-tile work taken out, so its output is no
longer attention) and times each with CUDA events on the layers of
``chip_smoke.py`` phase 8: starcoder2-3b (S 4096, 24 heads over 2, hd 128,
causal) and gemma2-2b local (S 8192, 8 heads over 4, hd 256, window 4096,
softcap 50), in bfloat16 and in float32.

bfloat16 (one launch a call):

  full         the kernel as it ships
  no_wgmma     no tensor-core products: loads, barriers, softmax
  no_softmax   no scale, softcap, masks or exponentials: loads, barriers,
               the products
  loads_only   neither: the TMA ring and the barriers
  tanhf        the softcap through the C library's tanhf

float32 (the pre-pass, then the split-TF32 body; each variant times the
body alone on the pre-pass's scratch, except ``prepass``):

  full         the body as it ships: three TF32 products a float32 one
  one_product  big.big alone, in both products (what the split costs)
  no_wgmma     no tensor-core products: Q staging, bulk copies, barriers,
               softmax, the split of P
  loads_only   no products and no softmax: Q staging, copies, barriers
  prepass      the pre-pass alone (K and V split, V transposed)

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
from repro_torch.kernels.flash_attention.ref import f32_tiling  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
BUILD = ROOT / "build/flash_ablation"
LAYERS = [  # label, S, H, KV, hd, window, softcap (all causal, batch 1)
    ("starcoder2-3b", 4096, 24, 2, 128, 0, 0.0),
    ("gemma2-2b local", 8192, 8, 4, 256, 4096, 50.0),
]


def off(*lines):
    """Edits that put ``if (false)`` before each of ``lines``."""
    return [(line, line.replace("wgmma_", "if (false) wgmma_", 1))
            for line in lines]


NO_WGMMA = off("      wgmma_ss<BK>(s, smem_desc(",
               "      wgmma_rs<D>(o, pa[kk],")
NO_SOFTMAX = [("  auto softmax = [&](int t) {\n",
               "  auto softmax = [&](int t) {\n    if (true) {\n"
               "#pragma unroll\n"
               "      for (int i = 0; i < NS; ++i) l_a += s[i];\n"
               "      return;\n    }\n")]
QF = "qf[kk < KR ? kk : 0]"
F32_EXTRA = off(f"        wgmma_rs<BK>(sc, {QF}, dks,",
                "        wgmma_ss<BK>(sc, dqb, dks,",
                "      wgmma_ss<BK>(sc, tc::smem_desc(s_qs",
                "      wgmma_rs<D>(o, pb[kk], dvs, 1);",
                "      wgmma_rs<D>(o, ps[kk], dvb, 1);")
F32_NO_WGMMA = F32_EXTRA + off(f"        wgmma_rs<BK>(s, {QF}, dkb,",
                               "        wgmma_ss<BK>(s, dqb, dkb,",
                               "      wgmma_rs<D>(o, pb[kk], dvb, 1);")
# (name, type, edits); the float32 "prepass" row times full's pre-pass
ABLATIONS = [
    ("full", "bfloat16", []),
    ("no_wgmma", "bfloat16", NO_WGMMA),
    ("no_softmax", "bfloat16", NO_SOFTMAX),
    ("loads_only", "bfloat16", NO_WGMMA + NO_SOFTMAX),
    ("tanhf", "bfloat16", [("softcap * tanh_f32(", "softcap * tanhf(")]),
    ("full", "float32", []),
    ("one_product", "float32", F32_EXTRA),
    ("no_wgmma", "float32", F32_NO_WGMMA),
    ("loads_only", "float32", F32_NO_WGMMA + NO_SOFTMAX),
    ("prepass", "float32", None),
]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "repro_flash_attention": [_P] * 4 + [_I] * 8 + [_F, _P],
    "repro_flash_split_kv": [_P] * 3 + [_I] * 7 + [_P],
    "repro_flash_attention_f32": [_P] * 3 + [_I] * 11 + [_F, _P],
}


def tag(name: str, dt: str, edits) -> str:
    """Build name: both types' ``full`` share one library."""
    return "full" if not edits else f"{dt}_{name}"


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


def load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


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


def checked(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def calls(lib, dt, variant, layer, qkv):
    """The timed call of ``variant`` on one layer's inputs."""
    _, s, h, kv, hd, win, cap = layer
    q, k, v = qkv
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    if dt == "bfloat16":
        return lambda: checked(variant, lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, s,
            s, h, kv, hd, 1, win, cap, stream))
    d, bk = f32_tiling(hd)
    tiles = -(-s // bk)
    blob = torch.empty((1, kv, tiles, 4, bk * d), dtype=torch.float32,
                       device="cuda")

    def split():
        checked(variant, lib.repro_flash_split_kv(
            k.data_ptr(), v.data_ptr(), blob.data_ptr(), 1, s, kv, hd, d,
            bk, tiles, stream))
    split()
    if variant == "prepass":
        return split
    return lambda: checked(variant, lib.repro_flash_attention_f32(
        q.data_ptr(), blob.data_ptr(), out.data_ptr(), 1, s, s, h, kv, hd, d,
        bk, tiles, 1, win, cap, stream))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, dt, edits in ABLATIONS:
        if edits is not None and tag(name, dt, edits) not in jobs:
            jobs[tag(name, dt, edits)] = build(tag(name, dt, edits), edits)
    for built, (_, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {built} failed:\n{out}")
    rng = np.random.default_rng(1)
    inputs = {dt: [[torch.as_tensor(rng.standard_normal((1, s, n, hd)),
                                    dtype=torch.float32, device="cuda")
                    .to(getattr(torch, dt)) for n in (h, kv, kv)]
                   for _, s, h, kv, hd, _, _ in LAYERS]
              for dt in ("bfloat16", "float32")}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"{'variant':22s} "
          + "  ".join(f"{lab:>16s}" for lab, *_ in LAYERS))
    for name, dt, edits in ABLATIONS:
        lib = load(jobs[tag("full" if edits is None else name, dt,
                            edits or [])][0])
        row = [time_ms(calls(lib, dt, name, layer, qkv))
               for layer, qkv in zip(LAYERS, inputs[dt])]
        print(f"{dt + ' ' + name:22s} "
              + "  ".join(f"{t * 1e3:13.1f} us" for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
