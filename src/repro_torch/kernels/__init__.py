"""Hand-written CUDA kernels for SigDLA's compute hot spots (Hopper, sm_90a).

Each kernel is the fused "fabric + computing array" step of the paper,
written for the H100 in place of the JAX package's Pallas TPU kernels:

- shuffle_gemm : the programmable gather/pad fused with the GEMM (paper
                 §V: the shuffling fabric feeding the array) — both the
                 shared-operand and the grouped (FFT butterfly) forms.

The source lives in ``csrc/`` and is built from the checkout at first use,
with ``nvcc`` into a plain-C shared library (loaded with ``ctypes``) under
``build/repro_torch_kernels/<digest>/`` at the repo root; the digest covers
the source and flags, so an edit rebuilds.  Every wrapper takes the plain
PyTorch version for a tensor on the CPU and launches its kernel — or
raises — for a tensor on the card; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = ["shuffle_gemm", "shuffle_gemm_grouped", "compiled_supported",
           "library", "build", "NVCC_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "shuffle_gemm.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures of the exported C functions.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_shuffle_gemm_blocks": (_P,) * 6 + (_I,) * 6 + (_P,),
    "repro_shuffle_gemm_grouped_blocks": (_P,) * 6 + (_I,) * 8 + (_P,),
    "repro_copy_f32": (_P, _P, _I, _P),
}

_LIB: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout
    (listed in ``.gitignore``)."""
    return SOURCE.parents[4] / "build" / "repro_torch_kernels"


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or under {cuda_home}; the CUDA "
            f"toolkit is needed to build the repro_torch kernels")
    return str(path)


def build() -> Path:
    """Build ``csrc/shuffle_gemm.cu`` unless its library exists, and return
    the library's path; raises ``RuntimeError`` with the compiler's output
    if the build fails.  ``nvcc -Xptxas -v`` output (registers, spills) is
    kept in ``libshuffle_gemm.log`` beside the library."""
    lib = build_dir() / _digest() / "libshuffle_gemm.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    lib.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)          # atomic: concurrent builders agree
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, with ``argtypes``/``restype`` declared
    for every exported function."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def compiled_supported() -> bool:
    """True once the kernel library builds and a copy kernel launches on
    the card and returns its input — the counterpart of the JAX
    package's compiled-Pallas probe.  False on a host with no card; a
    build failure raises."""
    if not torch.cuda.is_available():
        return False
    lib = library()
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    err = lib.repro_copy_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_copy_f32 launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    return bool(torch.equal(x, y))


from .shuffle_gemm.ops import shuffle_gemm, shuffle_gemm_grouped  # noqa: E402
