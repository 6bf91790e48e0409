#!/usr/bin/env python3
"""Trace the dry-run's grid on the CPU and tabulate the records.

Runs ``python -m repro_torch.launch.dryrun --device cpu --unsharded``
once a cell — every cell of ``configs.cell_applicable`` on the (16, 16)
world, and the ``train_4k`` cells of ``MULTI_POD`` on (2, 16, 16) —
``--jobs`` processes at a time, each cut at ``--timeout`` seconds (the
dry-run's 600 s by default), then prints one markdown row a cell from
the records in ``--out``:

  * the trace seconds (``lower_s``: the step alone, under the other
    jobs' load) and the unsharded trace's;
  * ``argument_bytes``, and whether it equals the count from the
    sharding specs alone (``chip_smoke._expected_arguments``);
  * FLOPs a device (``loop_aware.flops``) and the part other ranks
    repeat (``replicated.flops``);
  * the share times the ranks over the unsharded step's FLOPs
    (``dryrun.unsharded_flops``): 1 where no work was lost or counted
    twice;
  * temp bytes and collective bytes by kind.

A cell cut by the timeout is listed as such, with its limit.

    PYTHONPATH=src python tools/dryrun_sweep.py [--jobs 4] [--timeout 600] \\
        [--out artifacts/dryrun_torch] [--cells ARCH:SHAPE[:mp] ...] \\
        [--table-only]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MULTI_POD = ("starcoder2-3b", "qwen2-moe-a2.7b", "grok-1-314b",
             "xlstm-350m")


def grid():
    """``(arch, shape, multi_pod)`` of every cell the sweep traces."""
    from repro_torch.configs import SHAPES, cell_applicable, list_configs
    cells = [(a, s, False) for a in list_configs() for s in sorted(SHAPES)
             if cell_applicable(a, s)]
    return cells + [(a, "train_4k", True) for a in MULTI_POD]


def _tag(arch, shape, multi_pod):
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"


def run(cells, jobs: int, timeout: float, out: str) -> dict:
    """Trace ``cells`` through the CLI; ``{tag: seconds or None}`` (None:
    cut at ``timeout``), each process's output in ``out/<tag>.log``."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    pending, running, done = list(cells), {}, {}
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape, mp = pending.pop(0)
            tag = _tag(arch, shape, mp)
            log = open(os.path.join(out, tag + ".log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--device", "cpu",
                   "--unsharded", "--out", out] + (["--multi-pod"]
                                                    if mp else [])
            running[tag] = (subprocess.Popen(cmd, stdout=log,
                                             stderr=subprocess.STDOUT,
                                             env=env, cwd=ROOT),
                            time.monotonic(), log)
        time.sleep(1)
        for tag, (proc, t0, log) in list(running.items()):
            late = time.monotonic() - t0 > timeout
            if proc.poll() is None and not late:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            done[tag] = None if late else round(time.monotonic() - t0, 1)
            del running[tag]
            how = (f"cut at {timeout:.0f} s" if late
                   else f"exit {proc.returncode} in {done[tag]} s")
            print(f"{tag}: {how}", flush=True)
    return done


def table(cells, out: str, timeout: float) -> str:
    """The markdown table of the records in ``out``."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    rows = ["| Cell | Mesh | Trace s (unsharded) | argument_bytes "
            "(= specs) | FLOPs a device | replicated.flops | share x ranks "
            "/ unsharded | temp bytes | collective bytes |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for arch, shape, mp in cells:
        tag = _tag(arch, shape, mp)
        path = os.path.join(out, tag + ".json")
        mesh = "2x16x16" if mp else "16x16"
        if not os.path.exists(path):
            rows.append(f"| {arch} {shape} | {mesh} | not traced in "
                        f"{timeout:.0f} s | | | | | | |")
            continue
        rec = json.load(open(path))
        la, mem = rec["loop_aware"], rec["memory"]
        want = chip_smoke._expected_arguments(torch, arch, shape, mp)
        un = rec.get("unsharded", {})
        share = la["flops"] - rec["replicated"]["flops"]
        ratio = (f"{share * rec['n_devices'] / un['flops']:.12g}"
                 if un.get("flops") else "n/a")
        coll = ", ".join(f"{k} {v:.4g}" for k, v in
                         la["collective_bytes"].items() if v) or "0"
        rows.append(
            f"| {arch} {shape} | {mesh} | {rec['lower_s']} "
            f"({un.get('trace_s', 'n/a')}) | {mem['argument_bytes']} "
            f"({'yes' if mem['argument_bytes'] == want else 'NO: %d' % want})"
            f" | {la['flops']:.5g} | {rec['replicated']['flops']:.5g} | "
            f"{ratio} | {mem['temp_bytes']:.4g} | {coll} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts",
                                                  "dryrun_torch"))
    ap.add_argument("--cells", nargs="*",
                    help="ARCH:SHAPE or ARCH:SHAPE:mp (default: the grid)")
    ap.add_argument("--table-only", action="store_true",
                    help="tabulate the records in --out, trace nothing")
    args = ap.parse_args(argv)
    cells = grid() if not args.cells else [
        (c.split(":")[0], c.split(":")[1], c.endswith(":mp"))
        for c in args.cells]
    if not args.table_only:
        run(cells, args.jobs, args.timeout, args.out)
    print(table(cells, args.out, args.timeout))


if __name__ == "__main__":
    main()
