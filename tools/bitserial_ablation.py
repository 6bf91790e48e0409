#!/usr/bin/env python3
"""Where the bitserial kernels' time goes, on one NVIDIA GPU.

Builds copies of ``src/repro_torch/kernels/csrc/bitserial_mm.cu``, each
with one part of the work taken out (so its output is no longer the
product) or one design constant changed, and times them with CUDA-graph
replays, as ``chip_smoke.py`` times its kernels:

- the shared entries, ``repro_bitserial_quant_matmul`` (the int route in
  one launch) and ``repro_bitserial_matmul_planes``, on the three
  int-routed calls of a batch-4 Fig-9q forward at widths (16, 8):
  front.taps (M 16384, K 9, N 1), mask.gemm (496, 256, 64) and
  mel_tap.mel (124, 129, 24);
- the per-row entry, ``repro_bitserial_quant_matmul_rows``, on the same
  calls of a two-tenant batch-8 wave, (B, R, K, N) = (8, 4096, 9, 1),
  (8, 124, 256, 64), (8, 31, 129, 24), with the body each launch reports.

Variants of the shared entries:

  full         the kernels as they ship
  no_mma       each MMA an integer add of its fragments: everything but
               the tensor cores (the per-row tiles and chunked bodies too)
  no_quant     the one-launch kernel's quantize without its IEEE division
               (every body that quantizes)
  staged       each kernel returns once its first K chunk is staged in
               shared memory (the one-launch kernel's float tiles, the
               planes kernel's digit planes)
  scales       the one-launch kernel returns once its row and column
               scales are known (the planes kernel as in full)
  digits       the one-launch kernel returns once the digits of its first
               chunk are in shared memory (the planes kernel as in full)
  empty        each shared kernel returns at once: the launch of its grid

Variants of the per-row bodies (the shared entries as in full):

  rows_loads   the row body returns once its values of h have landed; the
               tiles body once w's column tile (shared memory) and the
               first block of h (registers) have
  rows_scales  the row body once w's integers and its row's scale are
               known; the tiles body once w's scales and the first block's
               row scales are (w's digits skipped)
  rows_digits  the row body once its integers are in registers, past its
               barrier; the tiles body runs everything but its MMAs
  rows_empty   every per-row body returns at once

Design points, exact like full and held to its outputs:

  row_ieee     the row body quantizing by the IEEE division (quant) in
               place of the reciprocal's fast path (quant_fast)
  row_v4       the row body's lanes holding 4 values of a row (four lanes
               a row at K 9), row_v16 16 (one lane a row)
  row_off      the front call on the tiles body (the row body's limits
               taken away)
  row256       the row body at 256 threads a CTA
  tiles_ieee   the tiles body quantizing by the IEEE division
  tiles_mt1    the tiles body always on 16-row blocks (one M tile a CTA at
               the mask call: 256 CTAs, two waves)
  tiles_mt2    the tiles body always on 32-row blocks (16 CTAs at mel)
  ctas2        the tiles body aims at two CTAs an SM
  tiles_all    the tiles body walks every M block of a (batch row, column
               tile) in one CTA

With ``--parent DIR`` (a checkout of another commit, for example the
parent unpacked with ``git archive`` into ``build/parent``) its
``bitserial_mm.cu`` is built as it is and timed in turns with full
(parent / full / full / parent) on every call of both entries; full's
per-row outputs are held bit for bit to the parent's, and the two builds'
shared-entry kernels (``quant_kernel<..., false>`` and ``planes_kernel``)
are compared by their ptxas registers and spills and, where
``cuobjdump`` is found, by their SASS.  With ``--racecheck`` the per-row
bodies at the three calls and the shared entry at the shapes of
``test_bitserial_quant_kernel_repeats_over_k_chunks`` run under
``compute-sanitizer --tool racecheck``, where the toolkit has it.

    python3 tools/bitserial_ablation.py [--parent DIR] [--racecheck]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core import bitwidth as bw  # noqa: E402
from repro_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.bitserial_mm import (  # noqa: E402
    QUANT_ROWS_BODIES, ref_bitserial_quant_matmul)

SOURCE = ROOT / "src/repro_torch/kernels/csrc/bitserial_mm.cu"
BUILD = ROOT / "build/bitserial_ablation"
CALLS = [("front.taps", 16384, 9, 1), ("mask.gemm", 496, 256, 64),
         ("mel_tap.mel", 124, 129, 24)]
ROW_CALLS = [("front.taps", 8, 4096, 9, 1), ("mask.gemm", 8, 124, 256, 64),
             ("mel_tap.mel", 8, 31, 129, 24)]
WIDTHS = (16, 8)
ENTRY = ("      int32_t* __restrict__ out, int m, int k, int n, int aligned,"
         "\n              int pa_any, int pw_any) {\n",
         "             float* __restrict__ y, int rows, int k, int n) {\n")
ROWS_ENTRY = ("                 int lanes_log2, float qa, float qw) {\n",
              "                   int tpc) {\n")
ROW_LOADS = ("    x[i] = live && j + (i << lanes_log2) < k ? "
             "hr[i << lanes_log2] : 0.0f;\n")
ROW_SCALE = "  const float hs = quant_scale(fold_max(mx, lanes), qa);\n"
ROW_DIGITS = "  __syncwarp();\n"
ROW_W_FAST = ("      wq[c * k + lane] = d.fast ? quant_fast(v[c], d, qw)\n"
              "                                : quant(v[c], ws[c], qw);\n")
ROW_H_FAST = ("  if (d.fast) {\n#pragma unroll\n"
              "    for (int i = 0; i < kRowValues; ++i) q[i] = "
              "quant_fast(x[i], d, qa);\n")
TILES_LANDED = "  load_h(t0);\n  cp_async_wait_all();\n  __syncthreads();\n"
TILES_W_DIGITS = ("    quads_digits<PW>(wx, lane, 32, nq, s, kQw, "
                  "ws + warp * stride,\n                     BN * stride);\n")
TILES_SCALE = "    if (j == 0) h_scale[par][hr] = hs;\n"
TILES_MMA = ("    mma_chunk<PA, PW>(as, ws, stride, kd, wt, acc);\n"
             "    // its barrier")
TILES_MT = "  return ctas16 > sms ? launch_tiles_mt"
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
    "rows_loads": [
        (ROW_LOADS, ROW_LOADS + "  {\n    float s = 0.0f;\n"
         "    for (int i = 0; i < kRowValues; ++i) s += x[i];\n"
         "    for (int c = 0; c < kRowMaxN; ++c) s += v[c];\n"
         "    if (s == 1.0e-30f) y[0] = s;\n    if (k > 0) return;\n  }\n"),
        (TILES_LANDED, TILES_LANDED + "  {\n    float s = 0.0f;\n"
         "    for (int i = 0; i < QH; ++i) s += hx[i].x + hx[i].y + hx[i].z"
         " + hx[i].w;\n    if (s == 1.0e-30f) y[0] = s;\n"
         "    if (k > 0) return;\n  }\n")],
    "rows_scales": [
        (ROW_SCALE, ROW_SCALE + "  if (hs == 1.0e-30f) y[0] = hs;\n"
         "  if (k > 0) return;\n"),
        (TILES_W_DIGITS, ""),
        (TILES_SCALE, TILES_SCALE + "    if (k > 0) return;\n")],
    "rows_digits": [
        (ROW_DIGITS, ROW_DIGITS + "  {\n    int s = 0;\n"
         "    for (int i = 0; i < kRowValues; ++i) s += q[i];\n"
         "    if (s == 12345) y[0] = hs;\n    if (k > 0) return;\n  }\n"),
        (TILES_MMA, "    // its barrier")],
    "rows_empty": [(e, e + "  if (k > 0) return;\n") for e in ROWS_ENTRY]
    + [("             float* __restrict__ y, int rows, int k, int n) {\n"
        "  constexpr int BM = 16 * WM, BN = 8 * WN;\n",
        "             float* __restrict__ y, int rows, int k, int n) {\n"
        "  constexpr int BM = 16 * WM, BN = 8 * WN;\n"
        "  if (kRows && k > 0) return;\n")],
    "row_ieee": [(ROW_W_FAST, "      wq[c * k + lane] = "
                  "quant(v[c], ws[c], qw);\n"),
                 (ROW_H_FAST, ROW_H_FAST.replace("if (d.fast)",
                                                 "if (false)"))],
    "row_v4": [("constexpr int kRowValues = 8;",
                "constexpr int kRowValues = 4;")],
    "row_v16": [("constexpr int kRowValues = 8;",
                 "constexpr int kRowValues = 16;")],
    "row_off": [("  if (k <= kRowMaxK && n <= kRowMaxN) return kRowBody;\n",
                 "")],
    "row256": [("constexpr int kRowThreads = 128;",
                "constexpr int kRowThreads = 256;")],
    "tiles_ieee": [("    if (d.fast) {\n      qi[0] = quant_fast",
                    "    if (false) {\n      qi[0] = quant_fast")],
    "tiles_mt1": [(TILES_MT, "  return false ? launch_tiles_mt")],
    "tiles_mt2": [(TILES_MT, "  return true ? launch_tiles_mt")],
    "ctas2": [("constexpr int kTilesCtasPerSm = 1;",
               "constexpr int kTilesCtasPerSm = 2;")],
    "tiles_all": [("  const int ctas = spread < mblocks ? "
                   "static_cast<int>(spread) : mblocks;",
                   "  const int ctas = 1;")],
}
EXACT = ("full", "row_ieee", "row_v4", "row_v16", "row_off", "row256",
         "tiles_ieee", "tiles_mt1", "tiles_mt2", "ctas2", "tiles_all")


def build(name: str, src: str) -> tuple:
    """Write ``src`` as ``name``'s source and start its nvcc: (library,
    process).  Each source sits in its own directory under one file name,
    so the builds' kernel names match."""
    cu = BUILD / name / "bitserial_mm.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    return lib, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def ablated(name: str, edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is in {SOURCE.name} "
                               f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


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


def bind(lib_path: Path) -> tuple:
    """(library, whether its per-row entry takes a dims array)."""
    lib = ctypes.CDLL(str(lib_path))
    src = (lib_path.parent / "bitserial_mm.cu").read_text()
    dims = "int aw, int ww, int* dims," in src
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry, ints in (("repro_bitserial_quant_matmul", 5),
                        ("repro_bitserial_matmul_planes", 5),
                        ("repro_bitserial_quant_matmul_rows", 6)):
        fn = getattr(lib, entry)
        fn.argtypes = [p] * 3 + [i] * ints + [p] * (
            2 if dims and entry.endswith("_rows") else 1)
        fn.restype = ctypes.c_int
    return lib, dims


def shared_calls(name, lib, inputs):
    """Both shared entries' times on the batch-4 calls: {entry: [ms]}."""
    aw, ww = WIDTHS
    out = {}
    for entry in ("repro_bitserial_quant_matmul",
                  "repro_bitserial_matmul_planes"):
        fn = getattr(lib, entry)
        row = []
        for (_, m, k, n), (h, w, ap, wp) in zip(CALLS, inputs):
            quant = entry.endswith("quant_matmul")
            y = torch.empty((m, n), device="cuda", dtype=torch.float32
                            if quant else torch.int32)
            args = ((h.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, aw,
                     ww) if quant else
                    (ap.data_ptr(), wp.data_ptr(), y.data_ptr(),
                     ap.shape[0], wp.shape[0], m, k, n))

            def call(fn=fn, args=args, entry=entry):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} {entry}: CUDA error {err}")
            row.append(device_ms(call))
        out[entry] = row
    return out


def per_row(name, lib, has_dims, row_inputs, time=True):
    """The per-row entry on the batch-8 calls: [(ms, body, y)]."""
    aw, ww = WIDTHS
    fn = lib.repro_bitserial_quant_matmul_rows
    out = []
    for (_, b, r, k, n), (h, w) in zip(ROW_CALLS, row_inputs):
        y = torch.empty((b, r, n), device="cuda", dtype=torch.float32)
        dims = (ctypes.c_int * 4)()
        args = (h.data_ptr(), w.data_ptr(), y.data_ptr(), b, r, k, n, aw,
                ww) + ((dims,) if has_dims else ())

        def call(args=args):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} per-row: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        body = (f"{QUANT_ROWS_BODIES[dims[0]]} grid ({dims[1]}, {dims[2]}) "
                f"{dims[3]} a CTA" if has_dims else "-")
        out.append((device_ms(call) if time else 0.0, body, y.clone()))
    return out


def ptxas_lines(log: str) -> dict:
    """{kernel: 'registers / spills'} from an ``-Xptxas -v`` log."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", m[1])
        elif name and "spill stores" in line:
            found[name] = line.split(":")[-1].strip()
        elif name and "Used" in line and "registers" in line:
            found[name] = (re.search(r"Used \d+ registers", line)[0] + "; "
                           + found.get(name, ""))
    return found


def sass(lib: Path) -> dict:
    """{kernel: SASS text} from ``cuobjdump -sass``, or {} without it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", name.strip())
        # its instructions and their encodings alone (the last function
        # runs on into the file's trailer), with their spacing collapsed:
        # cuobjdump pads its columns to the widest line of the whole file
        out[name] = "\n".join(" ".join(line.split())
                              for line in body.splitlines()
                              if re.search(r"/\*(?:[0-9a-f]{4}| 0x)", line))
    return out


def compare_shared(logs: dict, libs: dict) -> None:
    """The shared entries' kernels of the parent and full: ptxas lines
    and SASS equal?"""
    shared = re.compile(r"quant_kernel\w*Lb0E|planes_kernel")
    pa, fu = ptxas_lines(logs["parent"]), ptxas_lines(logs["full"])
    keys = sorted(k for k in pa if shared.search(k))
    same = [k for k in keys if pa[k] == fu.get(k)]
    print(f"ptxas, shared-entry kernels: {len(same)} of {len(keys)} equal "
          f"in registers and spills between parent and full")
    for k in keys:
        if pa[k] != fu.get(k):
            print(f"  differs: {k}: parent {pa[k]} | full {fu.get(k)}")
    new = sorted(k for k in fu if k not in pa)
    for k in new:
        print(f"  new kernel {k}: {fu[k]}")
    sp, sf = sass(libs["parent"]), sass(libs["full"])
    if not sp:
        print("cuobjdump not found: SASS not compared")
        return
    keys = sorted(k for k in sp if shared.search(k))
    same = [k for k in keys if sp[k] == sf.get(k)]
    print(f"SASS, shared-entry kernels: {len(same)} of {len(keys)} identical "
          f"between parent and full")
    shown = False
    for k in keys:
        if sp[k] != sf.get(k):
            print(f"  differs: {k}")
            if not shown:                # the first few lines that differ
                a, b = sp[k].splitlines(), sf.get(k, "").splitlines()
                rows = [(x, y) for x, y in zip(a, b) if x != y][:6]
                print(f"    {len(a)} / {len(b)} lines; " + " | ".join(
                    f"{x[:90]} -> {y[:90]}" for x, y in rows))
                shown = True


def racecheck() -> None:
    """Run the per-row bodies and the shared entry's K-chunk shapes under
    compute-sanitizer's racecheck, where the toolkit has it."""
    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(tool).exists():
        print("racecheck: compute-sanitizer not available")
        return
    try:
        run = subprocess.run(
            [tool, "--tool", "racecheck", "--racecheck-report", "all",
             sys.executable, str(Path(__file__).resolve()), "--race-body"],
            capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        print("racecheck: compute-sanitizer did not finish in 600 s")
        return
    tail = "\n".join((run.stdout + run.stderr).strip().splitlines()[-12:])
    print(f"racecheck: compute-sanitizer exit {run.returncode}\n{tail}")


def race_body() -> int:
    """What --racecheck runs under the sanitizer: the repo's own build."""
    from repro_torch.kernels import bitserial_mm as bsm
    rng = np.random.default_rng(3)
    aw, ww = WIDTHS
    with torch.no_grad():
        for _, b, r, k, n in ROW_CALLS:
            h = torch.as_tensor(rng.standard_normal((b, r, k)),
                                dtype=torch.float32, device="cuda")
            w = torch.as_tensor(rng.standard_normal((b, k, n)),
                                dtype=torch.float32, device="cuda")
            got = bsm.bitserial_quant_matmul_hopper(h, w, aw, ww)
            assert torch.equal(got, ref_bitserial_quant_matmul(h, w, aw, ww))
        for r, k, n in ((37, 300, 200), (300, 300, 3), (1000, 700, 64),
                        (4096, 520, 8)):
            h = torch.as_tensor(rng.standard_normal((r, k)),
                                dtype=torch.float32, device="cuda")
            w = torch.as_tensor(rng.standard_normal((k, n)),
                                dtype=torch.float32, device="cuda")
            h[:, -4:] *= 1000.0
            w[-4:] *= 1000.0
            for widths in ((8, 8), (16, 16)):
                got = bsm.bitserial_quant_matmul_hopper(h, w, *widths)
                assert torch.equal(
                    got, ref_bitserial_quant_matmul(h, w, *widths))
    torch.cuda.synchronize()
    print("race body: every call bit for bit its plain version")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another commit to time in turns")
    ap.add_argument("--racecheck", action="store_true")
    ap.add_argument("--race-body", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bitserial_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.race_body:
        return race_body()
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {name: ablated(name, edits)
               for name, edits in ABLATIONS.items()}
    if args.parent is not None:
        sources["parent"] = (args.parent / SOURCE.relative_to(ROOT)) \
            .read_text()
    jobs = {name: build(name, src) for name, src in sources.items()}
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{out}")
        libs[name], logs[name] = lib, out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print("full build, ptxas:")
    for k, v in ptxas_lines(logs["full"]).items():
        print(f"  {k}: {v}")
    if "parent" in libs:
        compare_shared(logs, libs)

    rng = np.random.default_rng(2)
    aw, ww = WIDTHS
    inputs = []
    for _, m, k, n in CALLS:
        h = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                            device="cuda")
        w = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                            device="cuda")
        ap_ = torch.stack(bw.split_planes(bw.quantize(h, aw)[0], aw))
        wp = torch.stack(bw.split_planes(bw.quantize(w, ww, 0)[0], ww))
        inputs.append((h, w, ap_.contiguous(), wp.contiguous()))
    row_inputs = []
    for _, b, r, k, n in ROW_CALLS:
        h = (rng.standard_normal((b, r, k))
             * np.exp(rng.uniform(-3, 3, (b, r, 1)))).astype(np.float32)
        w = (rng.standard_normal((b, k, n))
             * np.exp(rng.uniform(-2, 2, (b, 1, 1)))).astype(np.float32)
        row_inputs.append((torch.as_tensor(h, device="cuda"),
                           torch.as_tensor(w, device="cuda")))
    wants = [ref_bitserial_quant_matmul(h, w, aw, ww)
             for h, w in row_inputs]

    bound = {name: bind(path) for name, path in libs.items()}
    order = [n for n in ABLATIONS]
    if "parent" in libs:             # in turns: parent / full / full / parent
        order = ["parent", "full", "full", "parent"] + [
            n for n in ABLATIONS if n != "full"]
    labels = [lab for lab, *_ in CALLS]
    print(f"{'variant':12s} {'entry':10s} "
          + "  ".join(f"{lab:>12s}" for lab in labels))
    for name in order:
        lib, has_dims = bound[name]
        times = shared_calls(name, lib, inputs)
        for entry, row in times.items():
            label = "planes" if "planes" in entry else "one-launch"
            print(f"{name:12s} {label:10s} "
                  + "  ".join(f"{t * 1e3:9.2f} us" for t in row), flush=True)
        rows = per_row(name, lib, has_dims, row_inputs)
        print(f"{name:12s} {'per-row':10s} "
              + "  ".join(f"{t * 1e3:9.2f} us" for t, _, _ in rows)
              + "   bodies: " + "; ".join(b for _, b, _ in rows), flush=True)
        if name in EXACT or name == "parent":
            for (lab, *_), (_, _, y), want in zip(ROW_CALLS, rows, wants):
                if not torch.equal(y, want):
                    raise AssertionError(f"{name} per-row {lab} is not its "
                                         f"plain version")
    print("every exact variant's per-row outputs bit for bit the plain "
          "version" + (" and the parent's" if "parent" in libs else ""))
    if args.racecheck:
        racecheck()
    return 0


if __name__ == "__main__":
    sys.exit(main())
