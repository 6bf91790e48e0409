"""The port's launchers against the JAX package's: the serve CLI
(``launch/serve.py``), the dry-run (``launch/dryrun.py``), its cost
counter (``launch/hlo_analysis.py``) and abstract inputs
(``models/zoo.py``'s ``input_specs`` / ``cache_specs_for``), and the
flash kernel's custom op — on the CPU.

  * ``input_specs`` gives the reference's keys, shapes and dtypes for
    every config x shape; ``cache_specs_for`` the reference's
    ``jax.eval_shape`` cache, leaf for leaf, for every applicable decode
    cell (its ``pos`` a Python int);
  * the cost counter on the reference's own cases
    (``tests/test_hlo_analysis.py``): a 7-layer matmul + tanh loop, its
    gradient and its remat read exactly 1, 3 and 4 x 7 x 2 * 64 * 256 *
    256 FLOPs; a float32 (256 x 512) @ (512 x 128) reads exactly its
    operands and result in HBM bytes; ``Shard(1)`` x ``Shard(0)`` on a
    fake 8-rank group reduced to ``Replicate`` reads exactly 256 * 128 *
    4 all-reduce bytes, and the 4096 x 8192 x 2048 product on a fake
    (16, 16) world reads the FLOPs of one device's shards
    (2 * 4096 * 512 * 2048), neither DTensor's global call nor its
    sharding propagation's global-shaped op, 15/16 of them repeated by
    the data ranks; attention on heads gathered by
    ``sharding.on_local_heads`` is counted half repeated on two model
    ranks, forward and backward;
  * the dry-run against the reference's tiny cell
    (``tests/test_distributed.py:132``: gemma2-2b at 2 layers, d 64, 4
    heads, d_ff 128, vocab 512, bfloat16, microbatch 2, remat) on (2, 2)
    and (2, 2, 2) fake meshes: the reference's record keys,
    ``argument_bytes`` equal but for the one scalar the port holds as a
    Python int (``AdamWState.step`` in a train cell, the cache's ``pos``
    in a decode cell: 4 bytes of int32 in the reference), decode FLOPs
    equal, train FLOPs within ``TRAIN_FLOPS_RATIO`` of the reference's
    and the rank's share (less ``replicated.flops``) equal to them (the
    reference runs in a subprocess with 8 forced host devices, as its
    own test does);
  * gemma2-2b ``decode_32k`` on the fake (16, 16) world: its
    ``argument_bytes`` equal a count of local shard bytes from the
    reference's own shapes and partition specs, its FLOPs the step's
    analytic count over 256 (``_torch_flops``), none repeated;
  * ``lower_cell`` refuses the MoE and xLSTM families, naming the op
    DTensor has no rule for;
  * the flash op passes ``torch.library.opcheck`` on CPU tensors, and
    under ``FakeTensorMode`` gives fake CUDA tensors their output shape,
    dtype and device and the flop formula's exact count;
  * the serve path on the reference's weights (``bundle.init(
    PRNGKey(0))`` through ``model_params_from_jax``; reduced starcoder2-3b
    and gemma2-2b, float32, greedy, batch 4, ``--quant-bits`` 0 and 8)
    gives the reference CLI's tokens exactly, and ``python -m
    repro_torch.launch.serve --device cpu`` prints what
    ``tests/test_cli.py`` asks of the reference's;
  * the two sharded paths the dry-run added, on gloo ranks: zero-1
    moments in ``adamw_update_`` bit for bit the moments laid out as
    their params, and a decode step over a cache sharded on the head dim
    (gemma2-2b reduced to one kv head) against the unsharded step.
"""

import ast
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.checkpoint import checkpoint

import _torch_dist_ranks as R
from _torch_dist import run_ranks
from _torch_flops import dense_step_flops
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import sharding as JSH
from repro.models.zoo import get_model as jget_model
from repro.models.zoo import input_specs as jinput_specs
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     visible_pairs)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import serve as S
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import get_model
from repro_torch.models import sharding as SH
from repro_torch.models.zoo import cache_specs_for, input_specs
from repro_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512)
TINY_SHAPES = {"tiny_train": ShapeConfig("tiny_train", 64, 8, "train"),
               "tiny_decode": ShapeConfig("tiny_decode", 64, 8, "decode")}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the port's train-cell FLOPs per device over the reference's on the tiny
# cell: 1.100 on both meshes (measured by this test) — in the backward of the
# MLP's down projection DTensor's strategy gathers w_down over the model
# axis and computes the gradients of the hidden activations and of w_down
# over the whole d_ff on each model rank, where XLA keeps d_ff split; the
# record's replicated.flops is that surplus
TRAIN_FLOPS_RATIO = (1.0, 1.1 + 1e-9)
INT32_SCALAR = 4        # bytes of the reference's int32 step / pos


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


# -- abstract inputs ----------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_match_reference(arch, shape):
    want = jinput_specs(jget_config(arch), SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dt(got[k].dtype) == str(want[k].dtype), k


def _decode_cells():
    return [(a, s) for a in list_configs() for s in sorted(SHAPES)
            if SHAPES[s].kind == "decode" and jcell_applicable(a, s)]


@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_cache_specs_match_reference(arch, shape):
    sh = SHAPES[shape]
    jb = jget_model(jget_config(arch))
    want = jax.eval_shape(lambda: jb.init_cache(sh.global_batch,
                                                sh.seq_len))
    got = cache_specs_for(get_config(arch), sh)

    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif path.endswith("/pos"):
            # the port's pos is a Python int; the reference's an int32
            assert g == 0 and w.shape == () and str(w.dtype) == "int32"
        else:
            assert g.device.type == "meta", path
            assert tuple(g.shape) == tuple(w.shape), path
            assert _dt(g.dtype) == str(w.dtype), path
    walk(got, want, "")


# -- the cost counter on the reference's cases --------------------------------

def _layers(a, ws, remat=False):
    x = a
    for w in ws.unbind(0):
        if remat:
            x = checkpoint(lambda x_, w_: torch.tanh(x_ @ w_), x, w,
                           use_reentrant=False)
        else:
            x = torch.tanh(x @ w)
    return x


def _grads(a, ws, remat=False):
    # the gradient of both operands: autograd would skip the first
    # layer's input gradient, which the reference's scanned body computes
    a, ws = (t.detach().requires_grad_() for t in (a, ws))
    return torch.autograd.grad(_layers(a, ws, remat).sum(), (a, ws))


def test_matmul_loop_grad_remat_flops_exact():
    ws = torch.randn(7, 256, 256)
    a = torch.randn(64, 256)
    unit = 2 * 64 * 256 * 256
    assert H.analyze(_layers, a, ws).flops == 7 * unit
    assert H.analyze(_grads, a, ws).flops == 3 * 7 * unit
    assert H.analyze(_grads, a, ws, True).flops == 4 * 7 * unit


def test_hbm_bytes_of_a_matmul_exact():
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    s = H.analyze(torch.matmul, a, b)
    assert s.hbm_bytes == (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert s.while_loops == [] and s.total_collective_bytes == 0


def test_collective_bytes_of_a_sharded_matmul():
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    with DR.fake_world(8):
        mesh = make_test_mesh((8,), ("model",), device="cpu")
        da = distribute_tensor(a, mesh, [Shard(1)], src_data_rank=None)
        db = distribute_tensor(b, mesh, [Shard(0)], src_data_rank=None)
        s = H.analyze(lambda: (da @ db).redistribute(mesh, [Replicate()]))
    assert s.collective_bytes["all-reduce"] == 256 * 128 * 4
    assert s.collective_count == 1
    assert s.total_collective_bytes == 256 * 128 * 4
    # the local product of one rank's shards, not the global one
    assert s.flops == 2 * 256 * 64 * 128


def test_flops_per_device_on_a_16x16_world():
    with DR.fake_world(256):
        mesh = make_test_mesh((16, 16), device="cpu")
        with FakeTensorMode():
            a, b = torch.empty(4096, 8192), torch.empty(8192, 2048)
            da = distribute_tensor(a, mesh, [Replicate(), Shard(1)],
                                   src_data_rank=None)
            db = distribute_tensor(b, mesh, [Replicate(), Shard(0)],
                                   src_data_rank=None)
            # twice: the first call runs DTensor's propagation, the
            # second finds it cached; both count one device's product
            for _ in range(2):
                assert H.analyze(lambda: da @ db).flops \
                    == 2 * 4096 * 512 * 2048
            # the 16 data ranks compute that product alike: its share
            # is the global product over the 256 ranks
            with H.CostMode() as mode:
                da @ db
    assert mode.summary.flops == 2 * 4096 * 512 * 2048
    assert mode.replicated_flops == 2 * 4096 * 512 * 2048 * 15 // 16
    assert mode.summary.flops - mode.replicated_flops \
        == 2 * 4096 * 8192 * 2048 // 256


def test_replicated_flops_of_attention_on_gathered_heads():
    """Attention through ``sharding.on_local_heads`` on 3 heads, which
    do not split over a model axis of 2: q, k and v are gathered and both
    model ranks attend over all heads, forward and backward — half of
    every plain product's FLOPs is replicated; with 4 heads each rank
    attends over its own 2, and nothing is."""
    from repro_torch.models import sharding as SH

    def attend(q, k, v):
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    rng = np.random.default_rng(0)
    for heads, replicated in ((3, 0.5), (4, 0.0)):
        with DR.fake_world(4):
            mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
            qkv = [distribute_tensor(
                torch.as_tensor(rng.standard_normal((2, 8, heads, 4))
                                .astype(np.float32)).requires_grad_(),
                mesh, [Shard(0), Shard(2)], src_data_rank=None)
                for _ in range(3)]
            with H.CostMode() as mode:
                SH.on_local_heads(attend, *qkv).sum().backward()
        # two products forward, four backward, each on a rank's batch row
        unit = 2 * 1 * (heads if replicated else heads // 2) * 8 * 8 * 4
        assert mode.op_counts["aten.bmm"] == 6
        assert mode.summary.flops == 6 * unit
        assert mode.replicated_flops == replicated * 6 * unit


# -- the dry-run against the reference's tiny cell ----------------------------

_REFERENCE = """
import json, dataclasses
import jax
import repro.configs as C
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as DR
DR.make_production_mesh = lambda multi_pod=False: (
    jax.make_mesh((2, 2, 2), ("pod", "data", "model")) if multi_pod
    else jax.make_mesh((2, 2), ("data", "model")))
cfg = dataclasses.replace(
    get_config("gemma2-2b").reduced(**{tiny}), dtype="bfloat16",
    microbatch=2, remat=True)
C._REGISTRY["gemma2-2b"] = cfg
DR.get_config = lambda arch: cfg
DR.SHAPES["tiny_train"] = ShapeConfig("tiny_train", 64, 8, "train")
DR.SHAPES["tiny_decode"] = ShapeConfig("tiny_decode", 64, 8, "decode")
recs = {{}}
for shape in ("tiny_train", "tiny_decode"):
    for mp in (False, True):
        r = DR.lower_cell("gemma2-2b", shape, mp)
        r.pop("_hlo_text", None)
        recs[shape + "/" + r["mesh"]] = r
print(json.dumps(recs))
"""


@pytest.fixture(scope="module")
def reference_records():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(tiny=TINY)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tiny_cfg():
    return dataclasses.replace(get_config("gemma2-2b").reduced(**TINY),
                               dtype="bfloat16", microbatch=2, remat=True)


def _keys(rec) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in rec.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(TINY_SHAPES))
def test_dryrun_tiny_cell_matches_reference(reference_records, shape_name,
                                            mesh_name):
    shape_, axes = MESHES[mesh_name]
    want = reference_records[f"{shape_name}/{mesh_name}"]
    with DR.fake_world(math.prod(shape_)):
        mesh = make_test_mesh(shape_, axes, device="cpu")
        got = DR.trace_cell(_tiny_cfg(), shape_name,
                            TINY_SHAPES[shape_name], mesh, device="cpu")
    for k, v in _keys(want).items():
        assert k in got, k
        if v is not None:
            assert sorted(got[k]) == v, k
    assert got["mesh"] == want["mesh"] and got["kind"] == want["kind"]
    assert got["n_devices"] == want["n_devices"]
    assert got["microbatch"] == want["microbatch"]
    assert got["loop_aware"]["flops"] > 0
    assert got["compile_s"] is None and got["memory"]["code_bytes"] is None
    # the one scalar the port keeps as a Python int: AdamWState.step
    # (train) or the cache's pos (decode), an int32 in the reference
    assert got["memory"]["argument_bytes"] + INT32_SCALAR \
        == want["memory"]["argument_bytes"]
    ratio = got["loop_aware"]["flops"] / want["loop_aware"]["flops"]
    if shape_name == "tiny_train":
        lo, hi = TRAIN_FLOPS_RATIO
        assert lo <= ratio <= hi, ratio
    else:
        assert ratio == 1.0, ratio
    # the gap is the work DTensor's plan repeats on the model ranks: the
    # rank's share is the reference's count exactly
    assert got["loop_aware"]["flops"] - got["replicated"]["flops"] \
        == want["loop_aware"]["flops"]
    # the loops, by trips: the train step's 2 microbatches, and no loop
    # over the one pattern group (XLA inlines a while of one trip, and
    # the port's counted loop of one trip is a plain one)
    assert sorted(t for _, t in got["loop_aware"]["while_loops"]) \
        == sorted(t for _, t in want["loop_aware"]["while_loops"])


def test_dryrun_without_donation_copies_the_cache():
    """``donate=False`` runs the decode step on a copy of the cache made
    inside the trace: the same arguments and FLOPs, the copy in the
    temporaries."""
    shape_, axes = MESHES["2x2"]
    recs = []
    for donate in (True, False):
        with DR.fake_world(4):
            mesh = make_test_mesh(shape_, axes, device="cpu")
            recs.append(DR.trace_cell(_tiny_cfg(), "tiny_decode",
                                      TINY_SHAPES["tiny_decode"], mesh,
                                      donate=donate, device="cpu"))
    kept, copied = recs
    assert copied["memory"]["argument_bytes"] \
        == kept["memory"]["argument_bytes"]
    assert copied["loop_aware"]["flops"] == kept["loop_aware"]["flops"]
    assert copied["memory"]["temp_bytes"] > kept["memory"]["temp_bytes"]


def _spec_bytes(tree, specs, mesh_axes) -> int:
    """Local bytes of ``tree`` 's leaves (anything with ``shape`` and
    ``dtype``) under ``specs``: numel over the product of the mesh axes
    each spec names."""
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        ways = 1
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str)
                       else tuple(entry or ())):
                ways *= mesh_axes[ax]
        total += math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize \
            // ways
    return total


def _reference_arguments(jcfg, sh, axes) -> int:
    """Rank 0's argument bytes of a cell counted from the JAX package's
    shapes and partition specs: params, the batch, a decode cell's
    cache (less its int32 ``pos``, a Python int in the port) and a train
    cell's two float32 moments by ``zero1_spec``."""
    jb = jget_model(jcfg)
    params = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    pspecs = JSH.param_specs(params, axes, jcfg.fsdp)
    batch = jinput_specs(jcfg, sh)
    total = (_spec_bytes(params, pspecs, axes)
             + _spec_bytes(batch, {k: JSH.batch_spec(tuple(v.shape), axes)
                                   for k, v in batch.items()}, axes))
    if sh.kind == "decode":
        cache = jax.eval_shape(lambda: jb.init_cache(sh.global_batch,
                                                     sh.seq_len))
        cache = {k: v for k, v in cache.items() if k != "pos"}
        total += _spec_bytes(cache, JSH.cache_specs(cache, axes,
                                                    sh.global_batch), axes)
    elif sh.kind == "train":
        moments = jax.tree_util.tree_map(
            lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
        mspecs = jax.tree_util.tree_map(
            lambda p, sp: JSH.zero1_spec(sp, tuple(p.shape), axes), params,
            pspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
        total += 2 * _spec_bytes(moments, mspecs, axes)
    return total


def _share_identity(rec, cfg, sh):
    """``(loop_aware.flops - replicated.flops) x n_devices`` equals the
    FLOPs of the same step traced on one fake device with no mesh, at
    relative 1e-9: no work lost, none counted twice."""
    one = DR.unsharded_flops(cfg, sh, device="cpu")
    share = rec["loop_aware"]["flops"] - rec["replicated"]["flops"]
    assert one["flops"] > 0
    assert share * rec["n_devices"] == pytest.approx(one["flops"], rel=1e-9)
    return one


def test_dryrun_production_decode_argument_bytes():
    got = DR.lower_cell("gemma2-2b", "decode_32k", False, device="cpu")
    axes = {"data": 16, "model": 16}
    sh = SHAPES["decode_32k"]
    want = _reference_arguments(jget_config("gemma2-2b"), sh, axes)
    assert got["memory"]["argument_bytes"] == want
    assert got["mesh"] == "16x16" and got["n_devices"] == 256
    assert got["cost"]["flops_per_device_naive"] > 0
    # the decode step's loop over the 13 pattern groups, counted from two
    assert got["loop_aware"]["while_loops"] == [("transformer.groups", 13)]
    assert got["cost"]["flops_per_device_naive"] \
        < got["loop_aware"]["flops"]
    # every product split over the 256 ranks: the count a device is the
    # step's analytic count over 256, and nothing is repeated
    assert got["replicated"]["flops"] == 0
    assert got["loop_aware"]["flops"] * 256 \
        == dense_step_flops(get_config("gemma2-2b"), sh)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-moe-a2.7b", "decode_32k"), ("grok-1-314b", "decode_32k"),
    ("xlstm-350m", "decode_32k"), ("xlstm-350m", "long_500k")])
def test_dryrun_moe_and_xlstm_production_cells(arch, shape):
    """The MoE and xLSTM families on the fake (16, 16) world (each
    rank's routing, gates and cells on its own blocks,
    ``sharding.LocalBlocks``): ``argument_bytes`` the JAX package's
    specs' count, the share identity, no flash call in a decode step."""
    got = DR.lower_cell(arch, shape, False, device="cpu")
    sh = SHAPES[shape]
    assert got["memory"]["argument_bytes"] == _reference_arguments(
        jget_config(arch), sh, {"data": 16, "model": 16})
    assert got["n_devices"] == 256 and got["kind"] == "decode"
    _share_identity(got, get_config(arch), sh)
    assert got["flash_attention"]["calls"] == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,kind,mesh_name", [
    (arch, kind, mesh) for arch in ("qwen2-moe-a2.7b", "xlstm-350m")
    for kind, mesh in (("train", "2x2"), ("prefill", "2x2"),
                       ("prefill", "2x2x2"))] + [
    ("grok-1-314b", "train", "2x2")])
def test_dryrun_moe_and_xlstm_small_world(arch, kind, mesh_name):
    """The reduced MoE and xLSTM configs' train step on a fake (2, 2)
    mesh and prefill on (2, 2) and (2, 2, 2), in seconds: the capacity
    path's dispatch, combine and aux loss, the chunkwise mLSTM and the
    sLSTM's per-token loop, each on a rank's own blocks.  ``argument_bytes`` is
    the JAX package's specs' count, and the share identity holds, the
    train step's backward included.  grok-1-314b's train step keeps its
    ``fsdp`` specs (the experts' d split over data, d_ff over model): the
    cell torch 2.11's DTensor could not plan while the expert FFN ran
    batch-major."""
    shape_, axes = MESHES[mesh_name]
    # bf16, microbatch 2 and remat, as the tiny dense cell; xlstm-350m
    # cut to 2 layers, one mLSTM and one sLSTM block
    kw = dict(dtype="bfloat16", microbatch=2, remat=True)
    if arch == "xlstm-350m":
        kw.update(n_layers=2, pattern=("m", "s"))
    if arch == "grok-1-314b":
        kw.update(fsdp=True)
    cfg = dataclasses.replace(get_config(arch).reduced(**TINY), **kw)
    jcfg = dataclasses.replace(jget_config(arch).reduced(**TINY), **kw)
    sh = ShapeConfig(f"tiny_{kind}", 32, 8, kind)
    with DR.fake_world(math.prod(shape_)):
        mesh = make_test_mesh(shape_, axes, device="cpu")
        got = DR.trace_cell(cfg, sh.name, sh, mesh, device="cpu")
    # the reference's int32 AdamW step is not counted on either side
    assert got["memory"]["argument_bytes"] == _reference_arguments(
        jcfg, sh, SH.mesh_axes_of(mesh))
    _share_identity(got, cfg, sh)
    # the flash op takes CUDA tensors only: a CPU trace runs its plain
    # version (chip_smoke.py phase 16b counts the op on fake CUDA ones)
    assert got["flash_attention"]["calls"] == 0


# -- loop-aware counting ------------------------------------------------------

def test_scanned_equals_unrolled_analysis():
    """The port of ``tests/test_roofline.py``'s "core guarantee of the
    loop-aware analyzer": on the same reduced starcoder2-3b, the gradient
    of the loss counted with its 6 pattern groups as a counted loop
    (``scan_layers=True``: 3 trips traced, the rest added, the backward
    pass's too) and unrolled (``scan_layers=False``) reads the same FLOPs
    and HBM bytes — exactly, where the reference's analyses agree within
    0.9–1.15."""
    base = get_config("starcoder2-3b").reduced(
        n_layers=6, d_model=64, n_heads=4, d_ff=128, vocab=256)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (4, 32)).astype(np.int32))
    got = {}
    for scan in (True, False):
        cfg = dataclasses.replace(base, scan_layers=scan)
        bundle = get_model(cfg)
        params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        with H.CostMode() as mode:
            loss, _ = bundle.loss_fn(params, {"tokens": tokens})
            torch.autograd.grad(loss, leaves)
        got[scan] = mode
    scanned, unrolled = got[True].summary, got[False].summary
    assert scanned.flops == unrolled.flops > 0
    assert scanned.hbm_bytes == unrolled.hbm_bytes
    assert scanned.while_loops == [("transformer.groups", 6)]
    assert unrolled.while_loops == []
    # trip-blind, as XLA's own analysis: the scanned body counted once
    assert got[True].naive.flops < scanned.flops
    assert got[False].naive.flops == unrolled.flops


# the five families at a few layers on the fake (2, 2) world: enough
# pattern groups (and microbatches) that the counted loops skip trips
FAMILIES = {
    "dense": ("starcoder2-3b", dict(n_layers=6)),
    "moe": ("qwen2-moe-a2.7b", dict(n_layers=6)),
    "rglru": ("recurrentgemma-2b", dict(n_layers=14)),
    "xlstm": ("xlstm-350m", dict(n_layers=6, pattern=("m", "s"))),
    "whisper": ("whisper-small", dict(n_layers=4, enc_layers=4)),
}
LOOP_REL = 1e-9         # loop-aware against whole: FLOPs, bytes
LOOP_TEMP_REL = 0.05    # and temp bytes (a peak, module docstring)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loop_aware_trace_equals_whole_trace(family, kind):
    """A cell traced with its loops counted (a body times its trips)
    against the same cell with every loop run whole
    (``trace_cell(whole_loops=True)``): FLOPs, replicated FLOPs, HBM
    bytes and collective bytes by kind at ``LOOP_REL``, temp bytes at
    ``LOOP_TEMP_REL``, argument and output bytes equal — the train
    step's backward pass, remat's recompute and the microbatch loop's
    in-body gradients included."""
    arch, kw = FAMILIES[family]
    cfg = dataclasses.replace(
        get_config(arch).reduced(**dict(TINY, **kw)), dtype="bfloat16",
        microbatch=4, remat=True)
    sh = ShapeConfig(f"tiny_{kind}", 16, 8, kind)
    recs = {}
    for whole in (False, True):
        with DR.fake_world(4):
            mesh = make_test_mesh(*MESHES["2x2"], device="cpu")
            recs[whole] = DR.trace_cell(cfg, sh.name, sh, mesh,
                                        device="cpu", whole_loops=whole)
    got, want = recs[False], recs[True]
    la, lw = got["loop_aware"], want["loop_aware"]
    assert la["flops"] == pytest.approx(lw["flops"], rel=LOOP_REL)
    assert got["replicated"]["flops"] == pytest.approx(
        want["replicated"]["flops"], rel=LOOP_REL, abs=0)
    assert la["hbm_bytes"] == pytest.approx(lw["hbm_bytes"], rel=LOOP_REL)
    for op in H.COLLECTIVES:
        assert la["collective_bytes"][op] == pytest.approx(
            lw["collective_bytes"][op], rel=LOOP_REL, abs=0), op
    assert got["memory"]["temp_bytes"] == pytest.approx(
        want["memory"]["temp_bytes"], rel=LOOP_TEMP_REL)
    for k in ("argument_bytes", "output_bytes"):
        assert got["memory"][k] == want["memory"][k], k
    # the group loop skipped trips; the whole trace lists no loop
    trips = dict(la["while_loops"])
    groups = trips.get("transformer.groups") or trips.get(
        "whisper.decode_layers" if kind == "decode"
        else "whisper.encoder_layers")
    assert groups >= 4 and lw["while_loops"] == []
    if kind == "train":
        assert trips["train.microbatches"] == 4
    assert got["cost"]["flops_per_device_naive"] < la["flops"]


def test_dryrun_cli_writes_a_record(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma2-2b__decode_32k__16x16.json")
                     .read_text())
    assert rec["cost"]["flops_per_device_naive"] > 0
    skip = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "long_500k", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert skip.returncode == 0 and skip.stdout.startswith("SKIP")


def test_dryrun_refuses_the_card_on_a_host_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        DR.lower_cell("gemma2-2b", "decode_32k", False)


# -- the flash op -------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 5, 30.0),
                                                   (False, 0, 0.0)])
def test_flash_op_opcheck(causal, window, softcap):
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    got = torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                                (q, k, v, causal, window, softcap))
    assert all(r == "SUCCESS" for r in got.values()), got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_op_fake_cuda_shape_and_flops(dtype):
    with FakeTensorMode():
        q = torch.empty(2, 33, 8, 64, dtype=dtype, device="cuda")
        k = torch.empty(2, 33, 2, 64, dtype=dtype, device="cuda")
        with H.CostMode() as mode:
            out = flash_attention(q, k, k, causal=True, window=7)
    assert out.shape == q.shape and out.dtype == dtype
    assert out.device.type == "cuda"
    pairs = sum(min(i + 1, 7) for i in range(33))
    assert visible_pairs(33, 33, True, 7) == pairs
    assert mode.summary.flops == 4 * 2 * 8 * 64 * pairs
    assert mode.op_counts == {"repro_torch.flash_attention": 1}


def test_flash_wrapper_keeps_cpu_tensors_differentiable():
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    k = torch.randn(1, 8, 1, 4, requires_grad=True)
    out = flash_attention(q, k, k)
    out.sum().backward()
    assert q.grad is not None and k.grad is not None


# -- the serve launcher -------------------------------------------------------

def _reference_cli(argv) -> dict:
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = old
    out = {}
    for line in buf.getvalue().splitlines():
        if line.startswith("req "):
            rid, toks = line[4:].split(": ", 1)
            out[int(rid)] = ast.literal_eval(toks)
    return out


@pytest.mark.parametrize("quant", [0, 8])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-2b"])
def test_serve_tokens_match_reference(arch, quant):
    argv = ["--arch", arch, "--requests", "6", "--batch-size", "4",
            "--max-new", "6", "--quant-bits", str(quant)]
    want = _reference_cli(argv)
    jcfg = jget_config(arch).reduced()
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    got, _ = S.serve(get_config(arch).reduced(),
                     model_params_from_jax(jparams, "cpu"), requests=6,
                     batch_size=4, max_new=6, quant_bits=quant,
                     device="cpu")
    assert len(want) == 6 and got == want


def test_serve_requests_are_the_references():
    reqs = S.requests_for(6, 100, 5)
    assert [r.prompt for r in reqs] == [[(7 * i + j) % 100
                                         for j in range(3 + i % 4)]
                                        for i in range(6)]
    assert all(r.max_new == 5 for r in reqs)


def _run_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_serve_cli_on_the_cpu():
    out = _run_cli(["--arch", "starcoder2-3b", "--requests", "3",
                    "--max-new", "4", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tok/s" in out.stdout and "req 0:" in out.stdout
    q = _run_cli(["--arch", "gemma2-2b", "--requests", "2", "--max-new",
                  "3", "--quant-bits", "8", "--device", "cpu"])
    assert q.returncode == 0, q.stderr[-2000:]
    assert "quant=8" in q.stdout


def test_serve_cli_refuses_the_card_on_a_host_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run_cli(["--arch", "starcoder2-3b", "--requests", "1"])
    assert out.returncode != 0 and "is_available" in out.stderr


def test_serve_reduced_flag_can_be_turned_off(monkeypatch):
    seen = {}

    def fake_serve(cfg, params, **kw):
        seen["cfg"] = cfg
        return {0: [1]}, 1.0
    monkeypatch.setattr(S, "serve", fake_serve)
    with FakeTensorMode():
        S.main(["--arch", "xlstm-350m", "--no-reduced", "--device", "cpu"])
    assert seen["cfg"] == get_config("xlstm-350m")
    S.main(["--arch", "xlstm-350m", "--device", "cpu"])
    assert seen["cfg"] == get_config("xlstm-350m").reduced()


# -- the sharded paths the dry-run added, on gloo ranks -----------------------

def test_zero1_moments_match_moments_laid_out_as_params(tmp_path):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "b": rng.standard_normal((4, 6)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    got = run_ranks(R.zero1_adamw, 4, tmp_path, params, grads, 1e-2)
    assert got["equal"]
    assert got["plain_m"] == str((Replicate(), Shard(1)))
    assert got["zero1_m"] == str((Shard(0), Shard(1)))


def test_decode_over_a_cache_sharded_on_the_head_dim(tmp_path):
    kw = dict(TINY, n_kv_heads=1)
    cfg = get_config("gemma2-2b").reduced(**kw)
    jparams = jget_model(jget_config("gemma2-2b").reduced(**kw)).init(
        jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 6)).astype(np.int32)
    got = run_ranks(R.sharded_decode, 4, tmp_path, "gemma2-2b", kw, params,
                    tokens, 3)
    # one kv head does not split over the model axis: the cache shards
    # its head dim (and its batch over the data axis)
    assert got["cache"] == str((Shard(1), Shard(4)))
    assert got["tokens"] == got["plain_tokens"]
    assert got["diff"] < 1e-4
