"""Rank bodies of the port's multi-rank tests, run by
``_torch_dist.run_ranks`` (``tests/test_torch_distributed.py``,
``tests/test_torch_compression.py``, ``tests/test_torch_moe.py``).  Each is ``fn(rank, world, ...)``
in a gloo rank on the CPU and imports PyTorch and the port only, so a
rank starts without JAX; the tests compute the JAX package's results in
their own process and compare.  Arrays cross as numpy; a large result is
written by rank 0 to an ``.npz`` the test reads."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def _flat(prefix, tree, out):
    """``{"/a/b": numpy}`` of a dict tree's tensor leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}/{k}", tree[k], out)
    else:
        full = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
        out[prefix] = full.cpu().numpy()
    return out


def _tensors(tree):
    from repro_torch.tree import tree_map
    return tree_map(torch.as_tensor, tree)


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def sharded_train_step(rank, world, arch, reduced_kw, replace_kw,
                       mesh_shape, params_np, batches, stream_kw, lr,
                       out_path, leaf="wq"):
    """``batches`` steps of ``make_train_step`` (a list of token arrays,
    or with ``stream_kw`` a count of ``make_batch_iterator(sharding=)``
    batches of a ``TokenStream``) with params placed by ``param_specs``
    on a ``("data", "model")`` mesh of ``mesh_shape``; rank 0 writes the
    params and moments to ``out_path`` and returns each step's loss and
    gradient norm, the first batch's loss under ``no_grad`` before the
    step (attention on the flash path) and the placements seen (of the
    batch and of the first group's ``leaf``, a path under
    ``params["blocks"]["b0"]``, and of its first moment)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch_iterator
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import adamw_init

    cfg = dataclasses.replace(get_config(arch).reduced(**reduced_kw),
                              **replace_kw)
    mesh = make_test_mesh(tuple(mesh_shape), device="cpu")
    axes = SH.mesh_axes_of(mesh)
    if cfg.fsdp:
        SH.set_activation_mesh(mesh)
    params = _tensors(params_np)
    params = SH.distribute_tree(params, SH.param_specs(params, axes,
                                                       cfg.fsdp), mesh)
    opt = adamw_init(params)
    bundle = get_model(cfg)
    step = make_train_step(bundle, lambda s: lr)
    if stream_kw:
        stream = TokenStream(**stream_kw)
        it = make_batch_iterator(stream, sharding=SH.row_sharding(
            mesh, (stream.global_batch, stream.seq_len)), device="cpu")
        feed = [next(it)[1] for _ in range(batches)]
    else:
        feed = []
        for b in batches:
            tok = torch.as_tensor(b)
            feed.append({"tokens": SH.distribute_tree(
                tok, SH.batch_spec(tuple(tok.shape), axes), mesh)})
    with torch.no_grad(), implicit_replication():
        nograd = bundle.loss_fn(params, feed[0])[0]
    losses, norms = [], []
    placements = {"batch": str(feed[0]["tokens"].placements),
                  "wq": str(_leaf(params["blocks"]["b0"], leaf)
                            .placements)}
    for batch in feed:
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    SH.set_activation_mesh(None)
    placements["m_wq"] = str(_leaf(opt.m["blocks"]["b0"], leaf).placements)
    flat = {}
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        _flat(name, tree, flat)
    if rank == 0:
        np.savez(out_path, **flat)
    return {"loss": losses, "grad_norm": norms, "step": opt.step,
            "nograd_loss": float(nograd.full_tensor()),
            "placements": placements}


def pipeline(rank, world, w_np, x_np, n_mb):
    """``spmd_pipeline`` of ``tanh(x @ w)`` over a ``("stage",)`` mesh of
    ``world`` ranks; returns the output every rank got (their max
    difference from rank 0's is 0) and the stage params' layout."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.pipeline import spmd_pipeline

    mesh = make_test_mesh((world,), ("stage",), device="cpu")
    w = torch.as_tensor(w_np)
    x = torch.as_tensor(x_np)

    calls = []

    def fn(p, xx):
        calls.append(1)
        return torch.tanh(xx @ p["w"])
    got = spmd_pipeline(fn, {"w": w}, x, mesh=mesh, axis_name="stage",
                        n_microbatches=n_mb)
    # stage params as a DTensor sharded on the stage dim: the same result
    got_dt = spmd_pipeline(fn, {"w": distribute_tensor(w, mesh, [Shard(0)])},
                           x, mesh=mesh, axis_name="stage",
                           n_microbatches=n_mb)
    ref0 = got.clone()
    dist.broadcast(ref0, 0)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(calls)]))
    return {"out": got.tolist(), "dtensor_equal": bool(torch.equal(got,
                                                                   got_dt)),
            "ranks_agree": bool(torch.equal(ref0, got)),
            "calls": [int(c) for c in counts]}


def compressed_allreduce(rank, world, x_np):
    """Every rank compresses its row of ``x_np`` and all-reduces it
    with ``allreduce_compressed`` over the world and over a ``"pod"``
    mesh dim's group; returns rank 0's results."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compression import (allreduce_compressed,
                                               compress_int8)

    q, s = compress_int8(torch.as_tensor(x_np[rank]))
    got = allreduce_compressed(q, s)
    mesh = make_test_mesh((world,), ("pod",), device="cpu")
    got_mesh = allreduce_compressed(q, s, mesh.get_group("pod"))
    return {"out": got.tolist(), "mesh_equal": bool(torch.equal(got,
                                                                got_mesh)),
            "dtype": str(got.dtype)}


def elastic_checkpoint(rank, world, tree_np, directory):
    """Save a tree placed on a (2, 2) mesh, restore it under (4, 1);
    returns whether each restored leaf equals the saved one, and its
    placements and local shapes."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as SH

    tree = _tensors(tree_np)
    m1 = make_test_mesh((2, 2), device="cpu")
    specs = {"w": SH.P("data", "model"), "b": SH.P(), "s": SH.P("model")}
    t1 = SH.distribute_tree(tree, specs, m1)
    ck = Checkpointer(directory)
    ck.save(3, t1, blocking=True)
    m2 = make_test_mesh((4, 1), device="cpu")
    shardings = {"w": SH.NamedSharding(m2, SH.P("data", None)),
                 "b": None, "s": SH.NamedSharding(m2, SH.P("data"))}
    step, back = ck.restore(like=tree, shardings=shardings)
    out = {"step": step}
    for k in sorted(tree):
        full = back[k].full_tensor() if hasattr(back[k], "full_tensor") \
            else torch.as_tensor(back[k])
        out[k] = {"equal": bool(torch.equal(full, tree[k])),
                  "placements": str(getattr(back[k], "placements", None)),
                  "local_shape": list(back[k].to_local().shape) if hasattr(
                      back[k], "to_local") else None}
    return out


def placement(rank, world, x_np):
    """DTensor placement by spec on 4 ranks: ``("pod", "data")`` on a
    (2, 2, 1) mesh splits dim 0 four ways major to minor, each rank's
    block is numpy's; ``distribute_tree`` replicates ``P()``;
    ``shard_activations`` pins the batch; ``make_production_mesh``
    raises on this world."""
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_test_mesh)
    from repro_torch.models import sharding as SH
    from repro_torch.models.zoo import batch_pspec

    x = torch.as_tensor(x_np)
    m3 = make_test_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    coord = m3.get_coordinate()
    d = SH.distribute_tree(x, SH.P(("pod", "data"), "model"), m3)
    block = np.split(x_np, 4, axis=0)[coord[0] * 2 + coord[1]]
    m2 = make_test_mesh((2, 2), device="cpu")
    r = SH.distribute_tree({"a": x}, {"a": SH.P()}, m2)["a"]
    act = SH.distribute_tree(x, SH.P(None, "model"), m2)
    SH.set_activation_mesh(m2)
    pinned = SH.shard_activations(act)
    odd = SH.shard_activations(SH.distribute_tree(
        torch.ones(3, 4), SH.P(None, "model"), m2))
    SH.set_activation_mesh(None)
    try:
        make_production_mesh(device="cpu")
        prod = "no error"
    except ValueError as e:
        prod = str(e)
    spec = batch_pspec({"tokens": x}, m3)["tokens"]
    return {"block_equal": bool(np.array_equal(d.to_local().numpy(),
                                                block)),
            "placements": str(d.placements),
            "replicated": str(r.placements),
            "replicated_equal": bool(torch.equal(r.to_local(), x)),
            "pinned": str(pinned.placements),
            "pinned_equal": bool(torch.equal(pinned.full_tensor(), x)),
            "odd_batch": str(odd.placements),
            "production": prod, "batch_pspec": list(spec),
            "mesh_axes": SH.mesh_axes_of(m3)}


def fails_on_rank_1(rank, world):
    """Rank 1 raises while the others wait in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return {"rank": rank}


def hangs_on_rank_1(rank, world):
    """Rank 1 never reaches the collective the others wait in."""
    if rank == 1:
        import time
        time.sleep(3600)
    dist.barrier()
    return {"rank": rank}


def card_collectives(rank, world):
    """On ``cuda:0`` through the staged group: each collective the slice
    uses gives the right result, DTensor's redistributions too, and the
    group counted the bytes it staged."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import staged_gloo
    from repro_torch.launch.mesh import make_test_mesh
    dev = torch.device("cuda", 0)
    ok = {}
    x = torch.full((1000,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    ok["all_reduce"] = bool((x == world * (world + 1) / 2).all())
    x = torch.full((10,), rank, device=dev, dtype=torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    ok["all_reduce_max_int32"] = bool((x == world - 1).all())
    x = torch.full((100,), float(rank), device=dev)
    dist.broadcast(x, src=world - 1)
    ok["broadcast"] = bool((x == world - 1).all())
    x = torch.full((4,), float(rank), device=dev)
    out = torch.empty(4 * world, device=dev)
    dist.all_gather_into_tensor(out, x)
    ok["all_gather_into_tensor"] = bool(torch.equal(
        out.view(world, 4)[:, 0].cpu(), torch.arange(world).float()))
    x = torch.arange(4 * world, device=dev, dtype=torch.float32)
    out = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(out, x)
    ok["reduce_scatter_tensor"] = bool(torch.equal(out, world * x[
        4 * rank:4 * rank + 4]))
    x = torch.full((8,), float(rank), device=dev)
    y = torch.empty(8, device=dev)
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, (rank + 1) % world),
             dist.P2POp(dist.irecv, y, (rank - 1) % world)]):
        w.wait()
    ok["send_recv_ring"] = bool((y == (rank - 1) % world).all())
    x = torch.arange(world, device=dev, dtype=torch.float32) + 10 * rank
    out = torch.empty(world, device=dev)
    dist.all_to_all_single(out, x)
    ok["all_to_all_single"] = bool(torch.equal(
        out.cpu(), torch.arange(world).float() * 10 + rank))
    mesh = make_test_mesh((1, world), device="cuda")
    a = torch.arange(32, dtype=torch.float32, device=dev).reshape(4, 8)
    d = distribute_tensor(a, mesh, [Replicate(), Shard(1)])
    ok["dtensor_full_tensor"] = bool(torch.equal(d.full_tensor(), a))
    e = d.redistribute(mesh, [Replicate(), Shard(0)])
    ok["dtensor_all_to_all"] = bool(torch.equal(e.full_tensor(), a))
    ok["on_card"] = d.to_local().device.type == "cuda"
    return {"ok": ok, "counts": staged_gloo.staged_totals()}


def card_sharded_step(rank, world, params_np, tokens, lr, out_path):
    """One float32 step of a reduced starcoder2-3b on ``cuda:0`` with
    params placed on a (1, world) mesh (the model axis), written by
    rank 0 to ``out_path`` for the test to hold against one process."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(
        vocab=256), microbatch=2)
    mesh = make_test_mesh((1, world), device="cuda")
    params = tree_map(lambda a: torch.as_tensor(a, device="cuda"), params_np)
    params = SH.distribute_tree(params, SH.param_specs(
        params, SH.mesh_axes_of(mesh), False), mesh)
    opt = adamw_init(params)
    tok = torch.as_tensor(tokens, device="cuda")
    batch = {"tokens": SH.distribute_tree(tok, SH.batch_spec(
        tuple(tok.shape), SH.mesh_axes_of(mesh)), mesh)}
    params, opt, m = make_train_step(get_model(cfg), lambda s: lr)(
        params, opt, batch)
    flat = {}
    for name, tree in (("params", params), ("m", opt.m)):
        _flat(name, tree, flat)
    if rank == 0:
        np.savez(out_path, **flat)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def staged_group_on_cpu(rank, world):
    """The staged group built as a second group over the same ranks, CPU
    tensors passed to its gloo backend as they are: every collective
    right, DTensor's redistributions on a mesh over it too, and the
    group's counts name the collectives it ran (nothing staged on the
    CPU)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import staged_gloo
    staged_gloo.register()
    group = dist.new_group(backend=staged_gloo.BACKEND)
    ok = {}
    x = torch.full((6,), float(rank + 1))
    dist.all_reduce(x, group=group)
    ok["all_reduce"] = bool((x == world * (world + 1) / 2).all())
    x = torch.full((3,), float(rank))
    out = torch.empty(3 * world)
    dist.all_gather_into_tensor(out, x, group=group)
    ok["all_gather_into_tensor"] = bool(torch.equal(
        out.view(world, 3)[:, 0], torch.arange(world).float()))
    x = torch.arange(2 * world, dtype=torch.float32)
    out = torch.empty(2)
    dist.reduce_scatter_tensor(out, x, group=group)
    ok["reduce_scatter_tensor"] = bool(torch.equal(
        out, world * x[2 * rank:2 * rank + 2]))
    mesh = DeviceMesh.from_group(group, "cpu", mesh_dim_names=("model",))
    a = torch.arange(4 * world * 2, dtype=torch.float32).reshape(
        2 * world, 4)
    d = distribute_tensor(a, mesh, [Shard(0)])
    ok["dtensor_full_tensor"] = bool(torch.equal(d.full_tensor(), a))
    ok["dtensor_to_shard1"] = bool(torch.equal(
        d.redistribute(mesh, [Shard(1)]).full_tensor(), a))
    r = distribute_tensor(a, mesh, [Replicate()])
    ok["dtensor_replicate"] = bool(torch.equal(r.to_local(), a))
    return {"ok": ok, "counts": dict(group.counts),
            "backend": group.getBackendName()}


def zero1_adamw(rank, world, params_np, grads_np, lr):
    """``adamw_update_`` on a (2, 2) ``("data", "model")`` mesh, params
    and grads placed by ``P(None, "model")``: once with the moments laid
    out as the params, once by ``zero1_spec`` (the data axis added).
    Returns rank 0's placements and whether both runs' params and
    moments are ``torch.equal`` (gathered whole)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import AdamWState, adamw_update_
    from repro_torch.tree import tree_map

    mesh = make_test_mesh((2, 2), device="cpu")
    axes = SH.mesh_axes_of(mesh)
    spec = SH.P(None, "model")
    runs = {}
    for kind in ("plain", "zero1"):
        params = SH.distribute_tree(_tensors(params_np), spec, mesh)
        grads = SH.distribute_tree(_tensors(grads_np), spec, mesh)
        mspec = spec if kind == "plain" else SH.zero1_spec(
            spec, tuple(params["w"].shape), axes)
        moments = [SH.distribute_tree(tree_map(
            lambda p: torch.full(p.shape, 0.01 * (i + 1)), _tensors(
                params_np)), mspec, mesh) for i in range(2)]
        state = AdamWState(3, *moments)
        for _ in range(2):
            params, state, _ = adamw_update_(grads, state, params, lr)
        runs[kind] = (params, state, str(state.m["w"].placements))
    same = all(torch.equal(a.full_tensor(), b.full_tensor())
               for a, b in zip(
                   [runs["plain"][0]["w"], runs["plain"][1].m["w"],
                    runs["plain"][1].v["w"], runs["plain"][0]["b"]],
                   [runs["zero1"][0]["w"], runs["zero1"][1].m["w"],
                    runs["zero1"][1].v["w"], runs["zero1"][0]["b"]]))
    return {"equal": bool(same), "plain_m": runs["plain"][2],
            "zero1_m": runs["zero1"][2]}


def sharded_decode(rank, world, arch, reduced_kw, params_np, tokens, steps):
    """Prefill ``tokens`` and take ``steps`` greedy decode steps with
    params placed by ``param_specs`` on a (2, 2) mesh (the cache made
    sharded by the cache specs), and the same unsharded on this rank;
    returns the largest logit difference, the tokens of both, and the
    placements of the first attention cache."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH

    cfg = get_config(arch).reduced(**reduced_kw)
    bundle = get_model(cfg)
    mesh = make_test_mesh((2, 2), device="cpu")
    axes = SH.mesh_axes_of(mesh)
    plain = _tensors(params_np)
    sharded = SH.distribute_tree(plain, SH.param_specs(plain, axes, False),
                                 mesh)
    tok = torch.as_tensor(tokens)
    batch = {"tokens": SH.distribute_tree(
        tok, SH.batch_spec(tuple(tok.shape), axes), mesh)}
    out = {"diff": 0.0, "tokens": [], "plain_tokens": []}
    with torch.no_grad(), implicit_replication():
        lg_s, c_s = bundle.prefill(sharded, batch, max_len=tok.shape[1]
                                   + steps)
        lg_p, c_p = bundle.prefill(plain, {"tokens": tok},
                                   max_len=tok.shape[1] + steps)
        out["cache"] = str(c_s["blocks"]["b0"]["k"].placements)
        for _ in range(steps):
            full = lg_s.full_tensor()
            out["diff"] = max(out["diff"],
                              float((full - lg_p).abs().max()))
            nxt_s = full[:, -1].argmax(-1).to(torch.int32)[:, None]
            nxt_p = lg_p[:, -1].argmax(-1).to(torch.int32)[:, None]
            out["tokens"].append(nxt_s[:, 0].tolist())
            out["plain_tokens"].append(nxt_p[:, 0].tolist())
            lg_s, c_s = bundle.decode_step(sharded, c_s, {
                "tokens": SH.distribute_tree(nxt_s, SH.batch_spec(
                    tuple(nxt_s.shape), axes), mesh)})
            lg_p, c_p = bundle.decode_step(plain, c_p, {"tokens": nxt_p})
        out["diff"] = max(out["diff"], float(
            (lg_s.full_tensor() - lg_p).abs().max()))
    return out


def sharded_prefill_decode(rank, world, arch, reduced_kw, params_np, tokens,
                           mesh_shape=(2, 2), device="cpu"):
    """A prefill of ``tokens`` and one greedy decode step with params
    placed by ``param_specs`` on a ``("data", "model")`` mesh on
    ``device`` (the cache made sharded by the cache specs); returns both
    steps' logits gathered whole, the two greedy tokens, the placements
    of the first group's cache leaves and the flash kernel's launches in
    the prefill (none on the CPU, whose flash path is plain)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.models import sharding as SH
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced(**reduced_kw)
    bundle = get_model(cfg)
    mesh = make_test_mesh(tuple(mesh_shape), device=device)
    axes = SH.mesh_axes_of(mesh)
    params = tree_map(lambda t: t.to(device), _tensors(params_np))
    params = SH.distribute_tree(params, SH.param_specs(params, axes,
                                                       cfg.fsdp), mesh)

    def placed(tok):
        return {"tokens": SH.distribute_tree(
            tok, SH.batch_spec(tuple(tok.shape), axes), mesh)}
    tok = torch.as_tensor(tokens, device=device)
    with torch.no_grad(), implicit_replication():
        FK.reset_launch_counts()
        lg, cache = bundle.prefill(params, placed(tok),
                                   max_len=tok.shape[1] + 1)
        launches = FK.launch_counts()
        first = lg.full_tensor()
        nxt = first[:, -1].argmax(-1).to(torch.int32)[:, None]
        placements = {k: str(v.placements)
                      for k, v in sorted(cache["blocks"]["b0"].items())}
        lg, cache = bundle.decode_step(params, cache, placed(nxt))
        second = lg.full_tensor()
    return {"prefill": first.tolist(), "decode": second.tolist(),
            "tokens": [nxt[:, 0].tolist(),
                       second[:, -1].argmax(-1).tolist()],
            "cache": placements, "launches": launches}


def moe_expert_layout(rank, world, arch, mesh_shapes, x_np):
    """The MoE capacity path of ``arch``'s ``reduced()`` layer with the
    config's own ``fsdp`` (float32, params from a seeded
    ``torch.Generator``) on a ``("data", "model")`` mesh of each of
    ``mesh_shapes``, the batch split over the data axis: for each mesh,
    the down projection's equation, its first operand's global and local
    shapes, whether the local block is contiguous and its ``(b, c)``
    merge a view of the same storage, the placements of the expert
    weights and of the LM head as their products read them, and the
    output's and the aux loss's largest difference from the same layer
    on plain tensors."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe, transformer
    from repro_torch.models import sharding as SH

    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(), fsdp=full.fsdp)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                          cfg.n_shared_experts, cfg.shared_ff, torch.float32)
    params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, torch.float32)
    params["norm_f"] = torch.zeros(cfg.d_model)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    x = torch.as_tensor(x_np)
    want, want_aux = moe.moe_forward(params, x, **kw)
    real, real_mm, calls = moe.einsum, L.matmul, []

    def spy(eq, *ops):
        calls.append((eq, ops[0], ops[1]))
        return real(eq, *ops)

    def spy_mm(a, b):
        calls.append(("head", a, b))
        return real_mm(a, b)

    def placements(t):
        """``"S<dim>"`` a shard, ``"R"`` a replica, ``"P"`` a pending
        sum, by mesh axis."""
        if not isinstance(t, DTensor):
            return None
        return [f"S{p.dim}" if isinstance(p, Shard) else
                "R" if isinstance(p, Replicate) else "P"
                for p in t.placements]
    out = []
    for shape in mesh_shapes:
        mesh = make_test_mesh(tuple(shape), device="cpu")
        axes = SH.mesh_axes_of(mesh)
        if cfg.fsdp:
            SH.set_activation_mesh(mesh)
        placed = SH.distribute_tree(
            params, SH.param_specs(params, axes, cfg.fsdp), mesh)
        xd = distribute_tensor(x, mesh, [
            Shard(0) if n == "data" else Replicate()
            for n in mesh.mesh_dim_names])
        calls.clear()
        moe.einsum, L.matmul = spy, spy_mm
        try:
            got, aux = moe.moe_forward(placed, xd, **kw)
            transformer._head_out(placed, xd, cfg)
        finally:
            moe.einsum, L.matmul = real, real_mm
            SH.set_activation_mesh(None)
        eq, op, _ = calls[2]
        local = op.to_local() if isinstance(op, DTensor) else op
        try:
            merged = local.view(local.shape[0], -1, local.shape[-1])
            shares = merged.untyped_storage().data_ptr() \
                == local.untyped_storage().data_ptr()
        except RuntimeError:           # the strides allow no such view
            shares = False
        out.append({
            "mesh": list(shape), "equation": eq,
            "global_shape": list(op.shape), "local_shape": list(local.shape),
            "contiguous": local.is_contiguous(),
            "merge_shares_storage": shares,
            "params_placed": {k: placements(placed[k]) for k in (
                "experts_gate", "experts_up", "experts_down", "head")},
            "weights_read": [placements(w) for _, _, w in calls],
            "out_err": float((got.full_tensor() - want).abs().max()),
            "aux_err": float(abs(float(aux.full_tensor()
                                       if isinstance(aux, DTensor) else aux)
                                 - float(want_aux)))})
    return {"n_experts": cfg.n_experts, "meshes": out}
