#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path — the paper's Fig-9 speech-enhancement
SigProgram (learned FIR -> STFT -> mask CNN -> iSTFT, plus a mel tap) at
its own width (length 4096, frame 256, hop 128, 9 FIR taps, 24 mels, mask
CNN channels (2, 12, 12, 1)), with random weights drawn by numpy from
``--seed`` — phase by phase:

  0. environment: torch, the card, ``nvidia-smi`` name and power limit;
  1. build: compiles ``src/repro_torch/kernels/csrc/shuffle_gemm.cu``
     with ``nvcc`` and probes the library;
  2. kernels: records the 18 shuffle-GEMM calls one Fig-9 forward makes
     (2 ``shuffle_gemm_blocks``, 16 ``shuffle_gemm_grouped_blocks``) and
     holds each kernel against its plain PyTorch version on the same card
     tensors (rtol = atol = 1e-5 in float32, 2e-2 in bfloat16), with
     device times from CUDA-graph replays;
  3. offline: one batch-4 forward on the ``hopper`` backend against the
     port's ``reference`` backend (rtol 1e-4, atol 1e-5), launching the
     two kernels exactly 2 and 16 times; ``torch.profiler`` over 5
     forwards gives the device time by kernel and the busy share;
  4. serve: ``SignalService`` answers 8 mixed-length requests in one
     length bucket (the masked path), then the same 8 sent 4 times over
     (32 requests, 8 waves) in the window that is timed and counted;
     every result equals an offline compile at the request's true length
     (``out`` atol 1e-5, ``mel_tap`` rtol = atol = 1e-4).  The launch
     counts of this window are the ``launches`` of the kernel line.

Any failed phase raises and the script exits non-zero.  The last two
lines are the kernel JSON and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

LENGTH, BATCH, CH = 4096, 4, (2, 12, 12, 1)
SERVE_LENGTHS = [LENGTH - 500 - 200 * i for i in range(8)]
SERVE_ROUNDS = 4                   # the 8 lengths, sent 4 times
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12            # H100 SXM float32 outside tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TPU_KERNELS = {
    "shuffle_gemm_blocks": "src/repro/kernels/shuffle_gemm/kernel.py:64",
    "shuffle_gemm_grouped_blocks":
        "src/repro/kernels/shuffle_gemm/kernel.py:125",
}
SOURCE = "src/repro_torch/kernels/csrc/shuffle_gemm.cu"


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def device_ms(torch, fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured into a CUDA
    graph, replayed ``iters`` times between two CUDA events, so host
    launch overhead is not in the figure."""
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


def wall_ms(torch, fn, iters: int = 20) -> float:
    """Time of one ``fn()`` from the host's side: CUDA events around a
    loop of calls, launch overhead included."""
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


def call_cost(args: dict) -> tuple:
    """(bytes, flops) one kernel call must move and do, from this call's
    data: each element of ``x`` that some row gathers, read once per batch
    row; ``pad`` only at the PAD entries (idx < 0), the only ones read;
    ``idx``, ``scale`` and ``w`` in full; the output written once.  2 flops
    per multiply-add."""
    x, idx, w, scale = args["x"], args["idx"], args["w"], args.get("scale")
    es = x.element_size()
    b, rows, t, n_out = x.shape[0], idx.shape[0], idx.shape[1], w.shape[-1]
    gathered = int(idx[idx >= 0].unique().numel())
    nbytes = (b * gathered * es + idx.numel() * 4 + int((idx < 0).sum()) * es
              + (0 if scale is None else scale.numel() * es)
              + w.numel() * es + b * rows * n_out * es)
    return nbytes, 2 * b * rows * t * n_out


def describe(name: str, args: dict) -> dict:
    idx, w = args["idx"], args["w"]
    return {"kernel": name, "rows": idx.shape[0], "t": idx.shape[1],
            "n_out": w.shape[-1], "groups": args.get("groups", 1),
            "nb": args.get("nb", idx.shape[0]),
            "pad": int((idx < 0).sum()), "scale": args.get("scale")
            is not None}


def record_calls(torch, compiled, x, params):
    """Run one forward with the two kernel wrappers wrapped by a recorder:
    returns ``[(kernel name, bound arguments)]`` in call order, with every
    tensor argument cloned."""
    from repro_torch.kernels.shuffle_gemm import ops
    names = ("shuffle_gemm_blocks", "shuffle_gemm_grouped_blocks")
    originals = {n: getattr(ops, n) for n in names}
    calls = []

    def recorder(name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            calls.append((name, {k: v.clone() if isinstance(v, torch.Tensor)
                                 else v for k, v in bound.arguments.items()}))
            return fn(*a, **kw)
        return rec

    for n in names:
        setattr(ops, n, recorder(n, originals[n]))
    try:
        with torch.no_grad():
            compiled(x, params)
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(ops, n, originals[n])
    return calls


def check_fig9_calls(calls) -> None:
    """The 18 calls match the Fig-9 lowering: two row-uniform GEMMs (FIR
    taps, mel) and 16 butterflies (t 4, n_out 4, groups 1..128 twice)."""
    d = [describe(n, a) for n, a in calls]
    blocks = sorted((c["rows"], c["t"], c["n_out"]) for c in d
                    if c["kernel"] == "shuffle_gemm_blocks")
    grouped = [c for c in d if c["kernel"] == "shuffle_gemm_grouped_blocks"]
    want_groups = sorted([1 << k for k in range(8)] * 2)
    if blocks != [(31, 129, 24), (4096, 9, 1)]:
        raise AssertionError(f"shuffle_gemm_blocks shapes {blocks}")
    if len(grouped) != 16 or sorted(c["groups"] for c in grouped) \
            != want_groups or any((c["rows"], c["t"], c["n_out"])
                                  != (3968, 4, 4) for c in grouped):
        raise AssertionError(f"shuffle_gemm_grouped_blocks calls {grouped}")


def profile_forward(torch, forward, wall_ms_per_call: float,
                    calls: int = 5) -> None:
    """Where one forward's device time goes: ``torch.profiler`` over
    ``calls`` forwards, device time summed by kernel name, and the busy
    share against the unprofiled wall time of one forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                forward()
            torch.cuda.synchronize()
    # device-side events only: an operator's entry repeats the time of
    # the kernels it launched
    by_name = [(e.self_device_time_total / calls, e.count / calls, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not by_name:
        print("profile: the profiler recorded no device time; device busy "
              "share not measured")
        return
    by_name.sort(reverse=True)
    busy_us = sum(t for t, _, _ in by_name)
    print(f"profile of one hopper forward: device busy {busy_us:.1f} us of "
          f"{wall_ms_per_call * 1e3:.1f} us wall "
          f"({100 * busy_us / (wall_ms_per_call * 1e3):.1f}% busy), "
          f"{sum(c for _, c, _ in by_name):.0f} kernels and copies")
    for t, c, key in by_name[:10]:
        print(f"  {t:8.2f} us  {c:5.1f} calls  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))

    # -- 0. environment -----------------------------------------------------
    phase("0 environment")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device {kind}; count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # -- 1. build -----------------------------------------------------------
    phase("1 build")
    from repro_torch import kernels as K
    from repro_torch.kernels.shuffle_gemm import (
        launch_counts, ref_shuffle_gemm_blocks,
        ref_shuffle_gemm_grouped_blocks, reset_launch_counts,
        shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
    t0 = time.perf_counter()
    lib = K.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s under "
          f"{lib.parent}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    if not K.compiled_supported():
        raise AssertionError("compiled_supported() is False on the card")
    print("compiled_supported() True", flush=True)

    # -- model and inputs (numpy, from the seed) ----------------------------
    from repro_torch.convert import params_from_jax
    from repro_torch.pipelines.speech_enhancement import build_graph
    from repro_torch.serving import SignalRequest, SignalService
    rng = np.random.default_rng(args.seed)
    cnn_hwio = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
                .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]
    cnn = params_from_jax(cnn_hwio, device="cuda")
    x_np = rng.standard_normal((BATCH, LENGTH)).astype(np.float32)
    xs_serve = [rng.standard_normal(t).astype(np.float32)
                for t in SERVE_LENGTHS]
    graph = build_graph(LENGTH, ch=CH)
    hopper = graph.compile(LENGTH, fuse=2, backend="hopper", device="cuda")
    params = dict(hopper.init_params())
    params["mask"] = cnn
    x = torch.as_tensor(x_np, device="cuda")
    print(f"Fig-9 graph: length {LENGTH}, batch {BATCH}, cnn {CH}; "
          f"lowering {hopper.lowering_report()}", flush=True)

    # -- 2. kernels against their plain versions ----------------------------
    phase("2 kernels")
    wrappers = {"shuffle_gemm_blocks": (shuffle_gemm_blocks,
                                        ref_shuffle_gemm_blocks),
                "shuffle_gemm_grouped_blocks": (
                    shuffle_gemm_grouped_blocks,
                    ref_shuffle_gemm_grouped_blocks)}
    calls = record_calls(torch, hopper, x, params)
    check_fig9_calls(calls)
    per_kernel = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_bytes_ms": 0.0, "bound_ops_ms": 0.0,
                      "bound_ms": 0.0, "calls": 0} for n in wrappers}
    cases = [(n, a, "float32") for n, a in calls]
    # one bfloat16 case: the butterfly with PAD fill and diag scale
    bf_name, bf_args = next(c for c in calls
                            if c[0] == "shuffle_gemm_grouped_blocks"
                            and c[1]["scale"] is not None)
    cases.append((bf_name, {k: v.to(torch.bfloat16)
                            if isinstance(v, torch.Tensor)
                            and v.is_floating_point() else v
                            for k, v in bf_args.items()}, "bfloat16"))
    with torch.no_grad():
        for name, a, dt in cases:
            kern, plain = wrappers[name]
            got = kern(**a)
            want = plain(**a)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dt]
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise AssertionError(f"{name} {describe(name, a)} {dt}: "
                                     f"max abs err {err} beyond {tol}")
            k_ms = device_ms(torch, lambda: kern(**a))
            p_ms = device_ms(torch, lambda: plain(**a))
            w_ms = wall_ms(torch, lambda: kern(**a))
            nbytes, flops = call_cost(a)
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / FP32_FLOP_PER_S * 1e3
            d = describe(name, a)
            print(f"{name:28s} {dt:8s} rows {d['rows']:5d} t {d['t']:3d} "
                  f"n_out {d['n_out']:2d} G {d['groups']:3d} "
                  f"pad {d['pad']:5d} scale {int(d['scale'])} | "
                  f"max_abs_err {err:.3e} (tol {tol}) | kernel "
                  f"{k_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  "
                  f"wrapper {w_ms * 1e3:8.2f} us  bound "
                  f"{max(b_bytes, b_ops) * 1e3:6.3f} us "
                  f"({nbytes} B, {flops} flop)", flush=True)
            if dt != "float32":
                continue
            pk = per_kernel[name]
            pk["max_abs_err"] = max(pk["max_abs_err"], err)
            pk["ms"] += k_ms
            pk["plain_ms"] += p_ms
            pk["bound_bytes_ms"] += b_bytes
            pk["bound_ops_ms"] += b_ops
            pk["bound_ms"] += max(b_bytes, b_ops)
            pk["calls"] += 1

    # -- 3. offline forward: hopper vs reference on the card ----------------
    phase("3 offline")
    reference = graph.compile(LENGTH, fuse=2, backend="reference",
                              device="cuda")
    with torch.no_grad():
        reset_launch_counts()
        out_h = hopper(x, params)
        torch.cuda.synchronize()
        offline_counts = launch_counts()
        out_r = reference(x, params)
        torch.cuda.synchronize()
    print(f"launches in one forward: {offline_counts}")
    if offline_counts != {"shuffle_gemm_blocks": 2,
                          "shuffle_gemm_grouped_blocks": 16}:
        raise AssertionError(f"one Fig-9 forward launched {offline_counts}")
    shapes = {"out": (BATCH, LENGTH),
              "mel_tap": (BATCH, 1 + (LENGTH - 256) // 128, 24)}
    for k, shape in shapes.items():
        h, r = out_h[k], out_r[k]
        if tuple(h.shape) != shape or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"{k}: shape {tuple(h.shape)} (want "
                                 f"{shape}) or non-finite values")
        torch.testing.assert_close(h, r, rtol=1e-4, atol=1e-5)
        print(f"{k}: {tuple(h.shape)} hopper vs reference max abs err "
              f"{float((h - r).abs().max()):.3e} (rtol 1e-4, atol 1e-5)")
    with torch.no_grad():
        fwd_h = wall_ms(torch, lambda: hopper(x, params), iters=10)
        fwd_r = wall_ms(torch, lambda: reference(x, params), iters=10)
    print(f"forward wall time, batch {BATCH}: hopper {fwd_h:.3f} ms, "
          f"reference {fwd_r:.3f} ms", flush=True)
    profile_forward(torch, lambda: hopper(x, params), fwd_h)

    # -- 4. serve: 8 mixed-length requests, one bucket ----------------------
    phase("4 serve")
    svc = SignalService(batch_size=4, backend="hopper", device="cuda")
    svc.register("speech_enhancement", graph, params={"mask": cnn})

    def requests(base):
        return [SignalRequest(rid=base + i, graph="speech_enhancement",
                              samples=s) for i, s in enumerate(xs_serve)]

    svc.serve(requests(0))                 # compiles the 4096 bucket
    torch.cuda.synchronize()
    rids = [100 * (k + 1) + i for k in range(SERVE_ROUNDS) for i in range(8)]
    for k in range(SERVE_ROUNDS):
        for r in requests(100 * (k + 1)):
            svc.submit(r)
    results, step_ms = {}, []
    reset_launch_counts()
    t_serve = time.perf_counter()
    while svc.pending():
        t1 = time.perf_counter()
        results.update(svc.step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    serve_s = time.perf_counter() - t_serve
    serve_counts = launch_counts()
    waves = len(rids) // 4
    print(f"served {len(results)} requests in {len(step_ms)} steps "
          f"(smoke reading, not a benchmark): "
          f"{len(results) / serve_s:.1f} requests/s, p50 step "
          f"{float(np.median(step_ms)):.3f} ms (steps "
          f"{', '.join(f'{s:.3f}' for s in step_ms)} ms); "
          f"stats {svc.stats}; launches {serve_counts}")
    if sorted(results) != rids or serve_counts != {
            "shuffle_gemm_blocks": 2 * waves,
            "shuffle_gemm_grouped_blocks": 16 * waves}:
        raise AssertionError(f"serving did not run {waves} bucketed waves "
                             f"of 2 + 16 launches")
    worst = {"out": 0.0, "mel_tap": 0.0}
    with torch.no_grad():
        for i, t in enumerate(SERVE_LENGTHS):
            off = graph.compile(t, fuse=2, backend="hopper", device="cuda")(
                torch.as_tensor(xs_serve[i][None], device="cuda"),
                {"mask": cnn})
            for (k, (rtol, atol)), rnd in itertools.product(
                    (("out", (0.0, 1e-5)), ("mel_tap", (1e-4, 1e-4))),
                    range(SERVE_ROUNDS)):
                got = results[100 * (rnd + 1) + i][k]
                want = off[k][0].cpu().numpy()
                if got.shape != want.shape or not np.all(np.isfinite(got)):
                    raise AssertionError(f"request {i} ({t}) {k}: shape "
                                         f"{got.shape} vs {want.shape}")
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
                worst[k] = max(worst[k], float(np.abs(got - want).max()))
    print(f"served == offline compile at true length: max abs err "
          f"out {worst['out']:.3e} (atol 1e-5), mel_tap "
          f"{worst['mel_tap']:.3e} (rtol 1e-4, atol 1e-4)", flush=True)

    # -- 5. kernel list -----------------------------------------------------
    phase("5 kernels")
    kernels = []
    for name, pk in per_kernel.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name],
            "launches": serve_counts[name],
            "max_abs_err": pk["max_abs_err"],
            "ms": pk["ms"], "plain_ms": pk["plain_ms"],
            "bound_ms": pk["bound_ms"],
            "bound_by": "bytes" if pk["bound_bytes_ms"]
            >= pk["bound_ops_ms"] else "operations",
            "library_ms": None,
            "per": f"sum over the {pk['calls']} calls of one batch-"
                   f"{BATCH} Fig-9 forward",
            "library": "no single PyTorch call computes gather∘GEMM",
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
