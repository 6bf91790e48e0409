"""Hand-written CUDA kernels for SigDLA's compute hot spots (Hopper, sm_90a).

Each kernel is the fused "fabric + computing array" step of the paper,
written for the H100 in place of the JAX package's Pallas TPU kernels:

- shuffle_gemm : the programmable gather/pad fused with the GEMM (paper
                 §V: the shuffling fabric feeding the array) — both the
                 shared-operand and the grouped (FFT butterfly) forms,
                 and chains of such steps (a stage's butterflies) in one
                 launch.
- bitserial_mm : variable-bitwidth integer GEMM over 4-bit digit planes
                 with shift-add recombination (paper §IV / Fig 2) on the
                 int8 tensor cores; and the int route's quantize -> GEMM
                 -> dequantize step in one launch.
- fft_stage    : radix-2 butterfly stages = composed shuffle plan +
                 per-twiddle-class 4x4 products (paper Fig 3a), a whole
                 FFT's stages in one launch.
- fir_conv     : multi-phase FIR (window gather + tap-bank product,
                 structural zeros = DPU pads; paper Fig 3b).
- flash_attention : online-softmax attention forward (GQA, causal,
                 sliding window, logit softcap) for the DL side, on the
                 tensor cores (wgmma): bfloat16 fed by TMA, float32 as
                 three TF32 products on split operands.

The sources live in ``csrc/`` and are built from the checkout at first
use: one ``nvcc`` per source, all started together, then one link into a
plain-C shared library (loaded with ``ctypes``) under
``build/repro_torch_kernels/<digest>/`` at the repo root; the digest
covers every source and the flags, so an edit rebuilds.  Every wrapper
takes the plain PyTorch version for a tensor on the CPU and launches its
kernel — or raises — for a tensor on the card; nothing falls back.
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

__all__ = ["shuffle_gemm", "shuffle_gemm_grouped", "bitserial_matmul",
           "bitserial_quant_matmul",
           "fft_stage", "fft_hopper", "fir_conv", "flash_attention",
           "ref_attention", "compiled_supported", "library", "build",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
LIB_NAME = "librepro_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

# ctypes signatures of the exported C functions.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_shuffle_gemm_blocks": (_P,) * 6 + (_I,) * 6 + (_P, _P, _I, _P),
    "repro_shuffle_gemm_grouped_blocks": (_P,) * 6 + (_I,) * 9 + (_P,),
    "repro_shuffle_gemm_chain": (_P, _P) + (_I,) * 3 + (_P, _P, _I, _I, _P),
    "repro_copy_f32": (_P, _P, _I, _P),
    "repro_bitserial_matmul_planes": (_P,) * 3 + (_I,) * 5 + (_P,),
    "repro_bitserial_quant_matmul": (_P,) * 3 + (_I,) * 5 + (_P,),
    "repro_bitserial_quant_matmul_rows": (_P,) * 3 + (_I,) * 6 + (_P, _P),
    "repro_fft_stages": (_P,) * 5 + (_I,) * 3 + (_P, _P),
    "repro_fir_conv": (_P,) * 4 + (_I,) * 5 + (_P,),
    "repro_flash_attention": (_P,) * 4 + (_I,) * 8 + (ctypes.c_float, _P),
    "repro_flash_split_kv": (_P,) * 3 + (_I,) * 7 + (_P,),
    "repro_flash_attention_f32": (_P,) * 3 + (_I,) * 11
    + (ctypes.c_float, _P),
    "repro_flash_f32_tiling": (_I, _P, _P),
}

_LIB: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout
    (listed in ``.gitignore``)."""
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def _digest() -> str:
    """Digest of every source (name and bytes) and every flag."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
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
    """Build every ``csrc/*.cu`` into one library unless it exists, and
    return the library's path: one ``nvcc -c`` per source, all running
    at once, then one ``nvcc -shared`` link.  Raises ``RuntimeError``
    with the compiler's output if a step fails.  The ``nvcc -Xptxas -v``
    output of every source (registers, spills per kernel) is kept in
    ``librepro_kernels.log`` beside the library."""
    lib = build_dir() / _digest() / LIB_NAME
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    work = lib.parent / f".build.{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        nvcc = _nvcc()
        jobs = []
        for src in SOURCES:
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            with open(log, "w") as out:
                jobs.append((src, obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=out, stderr=subprocess.STDOUT)))
        report, failed = [], []
        for src, _, log, proc in jobs:
            rc = proc.wait()
            report.append(f"== {src.name} (nvcc exit {rc})\n"
                          f"{log.read_text()}")
            if rc:
                failed.append(src.name)
        if not failed:
            tmp = work / LIB_NAME
            link = subprocess.run(
                [nvcc, *LINK_FLAGS, "-o", str(tmp),
                 *(str(obj) for _, obj, _, _ in jobs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            report.append(f"== link (nvcc exit {link.returncode})\n"
                          f"{link.stdout}")
            if link.returncode:
                failed.append("link")
        text = "\n".join(report)
        lib.with_suffix(".log").write_text(text)
        if failed:
            raise RuntimeError(f"building the repro_torch kernels failed "
                               f"({', '.join(failed)}):\n{text}")
        os.replace(tmp, lib)      # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the library's C entry point ``entry`` with ``args`` (tensor
    pointers and sizes as ints) and the current stream of ``device``.
    Raises ``RuntimeError`` if the launch reports a CUDA error: a refused
    launch never runs, and no later synchronisation would report it."""
    with torch.cuda.device(device):
        err = getattr(library(), entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def check_operands(kernel: str, operands) -> None:
    """Check a kernel's operands before their pointers go to C.
    ``operands`` maps each name to ``(tensor, dtype)``; the first tensor
    must lie on a CUDA device and every other on the same one, each of
    its dtype and contiguous.  Raises ``ValueError`` or ``TypeError``."""
    (lead, (first, _)), *_ = operands.items()
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors or (plain "
                         f"version) CPU tensors; got {dev}")
    for name, (t, dtype) in operands.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {lead} on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def forward_only(kernel: str, x: torch.Tensor, *others) -> None:
    """Refuse a call on the card that autograd would have to see through,
    for the standalone entry points with no backward pass (``fft_stage``,
    ``fir_conv`` and ``flash_attention``: the JAX package defines none
    either) and the per-row form of ``shuffle_gemm`` (one operand a batch
    row: the serving path, a forward only there too), so their result
    never silently drops a gradient.  CPU tensors take the plain
    versions, which differentiate.  The shuffle-GEMM ops have their
    backward in ``shuffle_gemm/vjp.py``."""
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, *others)):
        raise NotImplementedError(
            f"the {kernel} CUDA kernel has no backward pass (nor has its "
            f"JAX counterpart); run under torch.no_grad() or on the CPU")


def compiled_supported() -> bool:
    """True once the kernel library builds and a copy kernel launches on
    the card and returns its input — the counterpart of the JAX
    package's compiled-Pallas probe.  False on a host with no card; a
    build failure raises.  Its launches are counted in its
    ``launches`` attribute."""
    if not torch.cuda.is_available():
        return False
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    launch("repro_copy_f32", x.device, x.data_ptr(), y.data_ptr(), x.numel())
    compiled_supported.launches += 1
    torch.cuda.synchronize()
    return bool(torch.equal(x, y))


compiled_supported.launches = 0


from .bitserial_mm.ops import (bitserial_matmul,  # noqa: E402
                               bitserial_quant_matmul)
from .fft_stage.ops import fft_hopper, fft_stage  # noqa: E402
from .fir_conv.ops import fir_conv  # noqa: E402
from .flash_attention.ops import flash_attention  # noqa: E402
from .flash_attention.ref import ref_attention  # noqa: E402
from .shuffle_gemm.ops import shuffle_gemm, shuffle_gemm_grouped  # noqa: E402
