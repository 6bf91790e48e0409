"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell
on fake tensors over a fake process group, and record its per-device
memory, FLOPs, HBM bytes and collective bytes — the port's counterpart
of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch] \\
        [--device cpu] [--unsharded]

The JAX package lowers and compiles each cell for 256 (512) forced host
devices and reads XLA's analyses.  The port has no compiler between it
and the card, so it runs the step itself, as rank 0 of a fake default
process group of 256 ranks (512 with ``--multi-pod``;
``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing) on the port's ``make_production_mesh``, with
every tensor a fake one (``FakeTensorMode`` on ``--device``, the card by
default): params from the bundle's ``init``, the AdamW moments, the
batch of :func:`repro_torch.models.zoo.input_specs` and the cache of
:func:`~repro_torch.models.zoo.cache_specs_for`, placed as DTensors by
the sharding specs (moments by the zero-1 specs).  Nothing is allocated
on the card and no kernel launches: the flash kernel's op runs its fake
implementation.  The step — ``make_train_step`` (whose in-place update
is the counterpart of donation), ``bundle.prefill`` under ``no_grad`` or
``bundle.decode_step`` — runs once inside a ``MemTracker`` and a
:class:`repro_torch.launch.hlo_analysis.CostMode`.  The step's scanned
loops (pattern groups, microbatches, the sLSTM's steps, the mLSTM's
chunks, whisper's layers, chunked attention) are counted as the
reference's analysis counts a ``while``: a body times its trips, the
body traced only until two trips count alike (``hlo_analysis``'s module
docstring) — so xlstm-350m's 32768-step prefill traces two sLSTM steps
a layer, not all of them.

The record keeps the reference's keys.  ``memory.argument_bytes`` is
rank 0's local shard bytes of params, moments, batch and cache;
``output_bytes`` those of the step's results, the tensors it wrote in
place among them; ``temp_bytes`` the tracker's peak less the arguments,
the skipped trips' leftovers made for it.  ``loop_aware`` is the
loop-aware count, its ``while_loops`` each counted loop's ``(name,
trips)``; ``cost`` (``flops_per_device_naive``,
``bytes_per_device_naive``) and ``collectives_naive`` the trip-blind one
— each counted loop's body once, as XLA's own analysis reads a
``while``.  ``whole_loops`` (:func:`trace_cell`, :func:`lower_cell`)
runs every loop whole instead: the comparison trace, with no loops
listed and both counts alike; ``cfg.scan_layers`` False unrolls the
group loops alone, as the reference's flag does.  Two keys have no
counterpart there: ``replicated``, the FLOPs of ``loop_aware.flops``
that other ranks repeat (the port's DTensor plan, e.g. attention over
all heads on every model rank where the heads do not split;
``CostMode.replicated_flops``), by op — ``flops`` less them is the
rank's share of the step's work, the count a roofline share reads — and
``flash_attention``, the calls and FLOPs of the flash kernel's op.
Every cell of ``configs.cell_applicable`` traces: the MoE routing and
the xLSTM cells run on each rank's own blocks
(``models/sharding.LocalBlocks``).  :func:`unsharded_flops` traces the
same step on one fake device with no mesh, its loops counted alike:
``flops`` less ``replicated.flops``, times the ranks, is that count.
Two values have no counterpart and are ``null``: ``compile_s`` (nothing
is compiled) and ``memory.code_bytes`` (no executable); no HLO file is
written.  Records go to ``artifacts/dryrun_torch`` by default, beside,
never over, the JAX package's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import SHAPES, cell_applicable, get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import sharding as SH
from ..models.zoo import batch_pspec, cache_specs_for, get_model, input_specs
from ..optim.adamw import AdamWState
from ..tree import tree_leaves, tree_map
from . import hlo_analysis
from .mesh import make_production_mesh
from .train import make_train_step

__all__ = ["fake_world", "local_bytes", "trace_cell", "unsharded_flops",
           "lower_cell", "main"]


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake default process group of
    ``world_size`` ranks.  A fake group of another size is replaced; a
    group this context created is destroyed on exit.  A real default
    group (another backend) raises: the dry-run never replaces one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} default process "
                               f"group exists; the dry-run needs a fake one")
        if dist.get_world_size() == world_size:
            yield
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Rank 0's bytes of ``tree`` 's tensors: a DTensor's local shard,
    a plain tensor whole, each storage once."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if isinstance(t, DTensor) else t
        key = (t.untyped_storage()._cdata, t.storage_offset())
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def _placed(tree, specs, mesh):
    """``tree`` placed on ``mesh`` by ``specs`` with each rank's block in
    storage of its own (``distribute_tensor`` leaves a view of the whole
    tensor, whose storage a memory tracker would count)."""
    def own(d):
        if not isinstance(d, DTensor):
            return d
        return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())
    return tree_map(own, SH.distribute_tree(tree, specs, mesh))


def _zeros_like_meta(tree, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def _live_bytes(tracker) -> int:
    return sum(snap["Total"] for snap in
               tracker.get_tracker_snapshot("current").values())


def trace_cell(cfg: ArchConfig, shape_name: str, shape: ShapeConfig, mesh,
               donate: bool = True, device=DEFAULT_DEVICE,
               whole_loops: bool = False) -> Dict[str, Any]:
    """The record of one cell (module docstring) on ``mesh`` (a
    ``DeviceMesh`` over the current default process group, this process
    its rank 0); every tensor a fake one on ``device``.  With ``donate``
    False the step runs on copies of the params and moments (train) or
    the cache (decode), made inside the trace, so its arguments stay as
    they were — the counterpart of jitting without ``donate_argnums``.
    With ``whole_loops`` every counted loop runs every trip
    (``CostMode(whole_loops=True)``): the comparison trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    dev = resolve_device(device)
    axes = SH.mesh_axes_of(mesh)
    bundle = get_model(cfg)
    SH.set_activation_mesh(mesh)
    try:
        with FakeTensorMode():
            params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
            pspecs = SH.param_specs(params, axes, cfg.fsdp)
            params = _placed(params, pspecs, mesh)
            batch = _zeros_like_meta(input_specs(cfg, shape), dev)
            batch = _placed(batch, batch_pspec(batch, mesh), mesh)
            args: Dict[str, Any] = {"params": params, "batch": batch}
            if shape.kind == "train":
                mspecs = tree_map(
                    lambda p, sp: SH.zero1_spec(sp, tuple(p.shape), axes),
                    params, pspecs)
                moments = [_placed(tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=dev), params),
                    mspecs, mesh) for _ in range(2)]
                args["opt"] = AdamWState(0, *moments)
            elif shape.kind == "decode":
                cache = _zeros_like_meta(cache_specs_for(cfg, shape), dev)
                args["cache"] = _placed(
                    cache, SH.cache_specs(cache, axes, shape.global_batch),
                    mesh)
            arg_bytes = local_bytes(args)

            tracker = MemTracker()
            tracker.track_external(*(t for t in tree_leaves(args)
                                     if isinstance(t, torch.Tensor)))
            t0 = time.perf_counter()
            with tracker, hlo_analysis.CostMode(
                    whole_loops=whole_loops,
                    live_bytes=lambda: _live_bytes(tracker)) as cost:
                out = _step(bundle, shape, args, donate)
            t_lower = time.perf_counter() - t0
            out_bytes = local_bytes(out)
            peak = max((snap["Total"] for snap in tracker.get_tracker_snapshot(
                "peak").values()), default=0)
            op = "repro_torch.flash_attention"
            flash = {"calls": cost.op_counts.get(op, 0),
                     "flops": float(cost.op_flops.get(op, 0))}
            replicated = {"flops": float(cost.replicated_flops),
                          "by_op": {k: float(v) for k, v in
                                    cost.op_replicated.items() if v}}
    finally:
        SH.set_activation_mesh(None)

    summary, naive = cost.summary.to_dict(), cost.naive
    coll = dict(naive.collective_bytes, count=naive.collective_count)
    return {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "n_devices": int(mesh.size()),
        "kind": shape.kind,
        "microbatch": cfg.microbatch if shape.kind == "train" else 1,
        "lower_s": round(t_lower, 1), "compile_s": None,
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(peak - arg_bytes, 0)),
            "code_bytes": None,
        },
        "cost": {
            "flops_per_device_naive": float(naive.flops),
            "bytes_per_device_naive": float(naive.hbm_bytes),
        },
        "loop_aware": summary,
        "collectives_naive": coll,
        "replicated": replicated,
        "flash_attention": flash,
    }


def unsharded_flops(cfg: ArchConfig, shape: ShapeConfig,
                    device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The cell's step traced on one fake device with no mesh (plain
    fake tensors, no process group): its FLOPs, and the flash op's calls
    and FLOPs, under a :class:`~repro_torch.launch.hlo_analysis.CostMode`
    counting loops as :func:`trace_cell` does — the count a sharded
    record's share (``loop_aware.flops`` less ``replicated.flops``) times
    its ranks is held to."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = resolve_device(device)
    bundle = get_model(cfg)
    with FakeTensorMode():
        params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        args: Dict[str, Any] = {
            "params": params,
            "batch": _zeros_like_meta(input_specs(cfg, shape), dev)}
        if shape.kind == "train":
            args["opt"] = AdamWState(0, *(tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=dev), params)
                for _ in range(2)))
        elif shape.kind == "decode":
            args["cache"] = _zeros_like_meta(cache_specs_for(cfg, shape),
                                             dev)
        with hlo_analysis.CostMode() as cost:
            _step(bundle, shape, args, True)
    op = "repro_torch.flash_attention"
    return {"flops": float(cost.summary.flops),
            "flash_attention": {"calls": cost.op_counts.get(op, 0),
                                "flops": float(cost.op_flops.get(op, 0))}}


def _step(bundle, shape: ShapeConfig, args: Dict[str, Any], donate: bool):
    """One step of the cell's kind on ``args``; returns its results."""
    def copied(tree):
        return tree if donate else tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    params, batch = args["params"], args["batch"]
    if shape.kind == "train":
        return make_train_step(bundle)(copied(params), copied(args["opt"]),
                                       batch)
    # a plain tensor met by a DTensor op (positions, masks) is read as
    # replicated, as the train step reads it
    with torch.no_grad(), implicit_replication():
        if shape.kind == "prefill":
            return bundle.prefill(params, batch, max_len=shape.seq_len)
        return bundle.decode_step(params, copied(args["cache"]), batch)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               donate: bool = True, device=DEFAULT_DEVICE,
               whole_loops: bool = False) -> Dict[str, Any]:
    """The record of ``arch`` x ``shape_name`` on the production mesh:
    (16, 16) over 256 fake ranks, (2, 16, 16) over 512 with
    ``multi_pod``; ``whole_loops`` as :func:`trace_cell`."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        return trace_cell(cfg, shape_name, shape, mesh, donate=donate,
                          device=device, whole_loops=whole_loops)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--unsharded", action="store_true",
                    help="also trace the step on one fake device with no "
                         "mesh (unsharded_flops), as the record's "
                         "'unsharded' entry")
    args = ap.parse_args(argv)

    if not cell_applicable(args.arch, args.shape):
        print(f"SKIP {args.arch} x {args.shape} (documented inapplicable)")
        return

    rec = lower_cell(args.arch, args.shape, args.multi_pod,
                     device=args.device)
    if args.unsharded:
        t0 = time.perf_counter()
        rec["unsharded"] = unsharded_flops(get_config(args.arch),
                                           SHAPES[args.shape],
                                           device=args.device)
        rec["unsharded"]["trace_s"] = round(time.perf_counter() - t0, 1)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.arch}__{args.shape}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
