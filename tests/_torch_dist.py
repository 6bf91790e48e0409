"""Multi-process harness for the port's multi-rank tests.

``run_ranks(fn, world, tmp_path, *args, timeout=240, device="cpu")``
starts ``world`` processes with ``torch.multiprocessing``'s ``spawn``
start method, joins them into one process group through a ``file://``
rendezvous in ``tmp_path`` (no TCP port, so the suite's xdist workers
never clash) — gloo on the CPU, the staged gloo group with every rank on
``cuda:0`` for ``device="cuda"`` (``launch.mesh.init_distributed``) —,
calls ``fn(rank, world, *args)`` in each, and returns rank 0's return
value (anything JSON can hold).  ``fn`` is a module-level function of an
importable module (the ranks import it by name), and ``args`` are
pickled, so pass numpy arrays rather than tensors.

Each call has its own deadline.  A rank that raises writes its traceback
to ``tmp_path`` and exits nonzero; the harness then stops the other
ranks (gloo would only tell them "Connection closed by peer") and fails
with that traceback.  A rank still running at the deadline — a hung
rendezvous or collective — is killed, and the test fails with whatever
tracebacks were written, never hanging the suite.
"""

from __future__ import annotations

import importlib
import json
import os
import time
import traceback

import torch.multiprocessing as mp

DEFAULT_TIMEOUT = 240.0
GRACE = 10.0          # seconds the other ranks get to fail on their own


def _rank_entry(module: str, name: str, rank: int, world: int, init: str,
                out_dir: str, device: str, args: tuple) -> None:
    import torch
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import init_distributed
        init_distributed(rank, world, init, device=device,
                         timeout_s=DEFAULT_TIMEOUT / 2)
        result = getattr(importlib.import_module(module), name)(
            rank, world, *args)
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(result, f)
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _tracebacks(out_dir: str, world: int) -> str:
    parts = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                parts.append(f"--- rank {r} ---\n{f.read()}")
    return "\n".join(parts)


def run_ranks(fn, world: int, tmp_path, *args,
              timeout: float = DEFAULT_TIMEOUT, device: str = "cpu"):
    """Rank 0's return value of ``fn(rank, world, *args)`` run in
    ``world`` gloo ranks (module docstring); raises ``AssertionError``
    with the failing ranks' tracebacks on a failure or at ``timeout``
    seconds."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(
        fn.__module__, fn.__name__, r, world, init, out_dir, device, args))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed_at = None
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None
                                  and now > failed_at + GRACE):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        why = ("timed out" if failed_at is None and
               time.monotonic() > deadline else "failed")
        raise AssertionError(
            f"{fn.__name__} on {world} ranks {why} (exit codes {codes}):\n"
            + (_tracebacks(out_dir, world) or "no rank wrote a traceback"))
    with open(os.path.join(out_dir, "result.json")) as f:
        return json.load(f)
