"""Multi-device models on the PyTorch port, against the JAX package's
single-device results, on gloo ranks on the CPU.

The JAX package's own multi-device tests (``tests/test_distributed.py``)
run its sharded code under ``shard_map`` / ``jit(in_shardings=)``; the
oracle here is what those tests compare against: the same function on
one device.  Each multi-rank case starts its ranks once through
``_torch_dist.run_ranks`` (its own deadline, 240 s by default; rank
bodies in ``_torch_dist_ranks.py``, which import no JAX):

  * the sharded train step: starcoder2-3b reduced to 2 layers, d 64, 4
    heads, d_ff 128, vocab 256, microbatch 2, batch 8 x 32 — the
    reference test's cell — with params placed by ``param_specs`` on a
    (2, 4) ``("data", "model")`` mesh of 8 ranks, against
    ``jax.jit(make_train_step)`` on one device: loss and gradient norm
    at rtol 1e-5, every param and moment at rtol 1e-4, atol 1e-6, in
    float32, at a constant learning rate of 1e-3 — save the few param
    elements whose AdamW update divides a gradient within 100x of eps,
    held to twice the steps' size (see ``_check_step``); the loss under
    ``no_grad`` (attention on the flash path) before the step at rtol
    1e-5.  An ``fsdp=True`` case on (2, 2) (``shard_activations``
    acts), and two steps on (2, 2) fed by
    ``make_batch_iterator(sharding=)`` against the JAX package's
    iterator;
  * ``spmd_pipeline`` on 4 ranks (4 stages, 8 microbatches of 2 x 16,
    ``tanh(x @ w)``) against the sequential loop at 1e-6, every rank's
    output equal, with stage params as plain tensors and as a DTensor;
    ``pipeline_bubble_fraction`` equal to the JAX package's;
  * the elastic checkpoint: saved from a (2, 2) mesh, restored under
    (4, 1), every leaf ``torch.equal`` and placed by its spec;
  * placement by spec: ``to_placements`` against the specs' meaning, a
    ``("pod", "data")`` entry splitting as numpy's major-to-minor split
    on 4 ranks, ``P()`` replicated, ``shard_activations``,
    ``batch_pspec`` equal to the JAX package's, the meshes' shapes and
    axes equal to the JAX package's ``make_test_mesh`` /
    ``make_production_mesh``, and ``make_production_mesh`` refusing a
    4-rank world.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import _torch_dist_ranks as R
from _torch_dist import run_ranks
from repro import configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.data import make_batch_iterator as jmake_batch_iterator
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import sharding as JSH
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.runtime.pipeline import \
    pipeline_bubble_fraction as jbubble_fraction
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as SH
from repro_torch.models import zoo as tzoo
from repro_torch.runtime.pipeline import pipeline_bubble_fraction
from repro_torch.tree import tree_map

ARCH = "starcoder2-3b"
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
LR = 1e-3
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
XLSTM_REL_L2 = 1e-3       # test_torch_lm_train.py's, for its gradients


def _reduced(arch):
    """The reduced config's arguments: ``REDUCED``, and for xlstm-350m
    the pattern ``("m", "s")``: its 8 layers in 4 groups of one mLSTM
    and one sLSTM block (the shipped pattern of 7 + 1 compiles twice as
    long in the JAX package; 4 groups also equal the 4 rows of
    :func:`test_sharded_prefill_decode_matches_reference`, where the
    cache specs then shard the group axis)."""
    if arch == "xlstm-350m":
        return dict(REDUCED, pattern=("m", "s"))
    return REDUCED


def _flat_jax(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat_jax(f"{prefix}/{k}", tree[k], out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _reference(replace_kw, batches, arch=ARCH):
    """The JAX package's jitted one-device step of ``arch`` run over
    ``batches``: (the initial params as a numpy tree for the port, each
    step's loss and gradient norm, the first batch's loss, the flat
    params and moments after the steps, and per param the elements whose
    gradient was nonzero and under 1e-6 at some step)."""
    jcfg = dataclasses.replace(
        jconfigs.get_config(arch).reduced(**_reduced(arch)), **replace_kw)
    jb = jzoo.get_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    params_np = tree_map(lambda t: t.numpy(), model_params_from_jax(jp,
                                                                    "cpu"))
    nograd = float(jb.loss_fn(jp, batches[0])[0])
    step = jax.jit(jtrain.make_train_step(jb, lambda s: LR))
    p, o, metrics = jp, jadamw.adamw_init(jp), []
    m_prev, near_eps = _flat_jax("m", o.m, {}), {}
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        # this step's clipped gradient, from the first moment's update
        m_now = _flat_jax("m", o.m, {})
        for k, v in m_now.items():
            g = np.abs(v - 0.9 * m_prev[k]) / 0.1
            near_eps["params" + k[1:]] = near_eps.get(
                "params" + k[1:], False) | ((g > 0) & (g < 1e-6))
        m_prev = m_now
    flat = {}
    for name, tree in (("params", p), ("m", o.m), ("v", o.v)):
        _flat_jax(name, tree, flat)
    return params_np, metrics, nograd, flat, near_eps


def _check_step(got, out_path, metrics, nograd, flat, near_eps, n_steps,
                rel_l2=None):
    """The port's steps against the JAX package's (module docstring's
    tolerances).  With ``rel_l2`` (xlstm-350m) the gradient norm and
    every whole leaf are held by relative L2 error instead: the unsharded
    port's xlstm gradients miss the JAX package's by up to that much
    (``test_torch_lm_train.py``'s ``XLSTM_REL_L2``), and a norm's error
    is at most its leaves'."""
    assert got["step"] == n_steps
    np.testing.assert_allclose(got["nograd_loss"], nograd, rtol=LOSS_RTOL)
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(got["loss"][i], m["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(got["grad_norm"][i], m["grad_norm"],
                                   rtol=rel_l2 or LOSS_RTOL,
                                   err_msg=f"norm {i}")
    port = np.load(out_path)
    assert sorted(port.files) == sorted(flat)
    for name, want in flat.items():
        got_leaf = port[name]
        if rel_l2 is not None:
            # every element, the near-eps ones too
            err = np.linalg.norm(got_leaf - want) / max(
                np.linalg.norm(want), 1e-30)
            assert err <= rel_l2, (name, err)
            continue
        if name.startswith("params/"):
            # AdamW normalises each gradient element, (m / bc1) /
            # (sqrt(v / bc2) + 1e-8), a ratio in [-1, 1] at the first step:
            # where a step's gradient element is nonzero and within 100x
            # of eps, float32 rounding of it (the unsharded port's and the
            # JAX package's differ there too) moves that step's update by
            # up to 2 lr (a flipped sign).  Those elements, a few in a
            # thousand, are held to 2 * n_steps * lr, the rest to RTOL /
            # ATOL.
            sens = near_eps[name]
            assert sens.mean() < 1e-2, (name, sens.sum())
            np.testing.assert_allclose(got_leaf[sens], want[sens], rtol=0,
                                       atol=2 * n_steps * LR, err_msg=name)
            got_leaf, want = got_leaf[~sens], want[~sens]
        np.testing.assert_allclose(got_leaf, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _tokens(seed, b=8, s=32):
    return np.random.default_rng(seed).integers(0, REDUCED["vocab"],
                                                (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,mesh_shape,replace_kw,leaf,placed", [
    (ARCH, (2, 4), {"microbatch": 2}, "wq", (Replicate(), Shard(2))),
    (ARCH, (2, 2), {"microbatch": 2, "fsdp": True}, "wq",
     (Shard(1), Shard(2))),
    # 8 microbatches of one row: a microbatch does not split over the 2
    # data ranks, so the step gathers the batch over that axis first
    (ARCH, (2, 2), {"microbatch": 8}, "wq", (Replicate(), Shard(2))),
    # the experts (groups, E, d, d_ff) split on d_ff: the capacity path's
    # dispatch and combine on each rank's rows, the aux loss over all
    ("qwen2-moe-a2.7b", (2, 2), {"microbatch": 2}, "moe/experts_gate",
     (Replicate(), Shard(3))),
    # the 4 heads split over the model axis of 2: each rank's mLSTM and
    # sLSTM cells on its own heads and rows
    ("xlstm-350m", (2, 2), {"microbatch": 2}, "m_wq",
     (Replicate(), Shard(2))),
], ids=["tp4_dp2", "fsdp_2x2", "microbatch8_2x2", "qwen2_moe_2x2",
        "xlstm_2x2"])
def test_sharded_train_step_matches_reference(tmp_path, arch, mesh_shape,
                                              replace_kw, leaf, placed):
    """One step with params placed by ``param_specs`` equals the JAX
    package's one-device jitted step (module docstring's tolerances)."""
    tokens = _tokens(7)
    params_np, metrics, nograd, flat, near_eps = _reference(
        replace_kw, [{"tokens": jnp.asarray(tokens)}], arch)
    out = str(tmp_path / "port.npz")
    got = run_ranks(R.sharded_train_step, int(np.prod(mesh_shape)),
                    tmp_path, arch, _reduced(arch), replace_kw, mesh_shape,
                    params_np, [tokens], None, LR, out, leaf)
    _check_step(got, out, metrics, nograd, flat, near_eps, 1,
                XLSTM_REL_L2 if arch == "xlstm-350m" else None)
    # the batch is split over the data axis; the leaf over the model
    # axis (and the data axis under fsdp); the moments take its layout
    assert got["placements"]["batch"] == str((Shard(0), Replicate()))
    assert got["placements"]["wq"] == got["placements"]["m_wq"] \
        == str(placed)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m"])
def test_sharded_prefill_decode_matches_reference(tmp_path, arch):
    """A prefill and one greedy decode step with params placed on a (2,
    2) mesh equal the JAX package's one-device prefill and decode step:
    logits at rtol 1e-4 (atol 1e-5; xlstm-350m 3e-4, the whole-model
    tolerance of ``test_torch_recurrent.py``), both greedy tokens
    exactly.  qwen2-moe's decode step takes the MoE's dense path, its
    prefill the capacity path.  xlstm-350m's 4 pattern groups equal the
    batch, so the cache specs shard its group axis: the steps write its
    states through copies gathered on that axis, written back
    (``transformer.unstack_groups``)."""
    jcfg = jconfigs.get_config(arch).reduced(**_reduced(arch))
    jb = jzoo.get_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    params_np = tree_map(lambda t: t.numpy(), model_params_from_jax(jp,
                                                                    "cpu"))
    tokens = _tokens(11, b=4, s=16)
    jlp, jc = jax.jit(lambda p, b: jb.prefill(p, b, max_len=17))(
        jp, {"tokens": jnp.asarray(tokens)})
    jt0 = np.asarray(jlp[:, -1]).argmax(-1).astype(np.int32)
    jld, _ = jax.jit(jb.decode_step)(jp, jc,
                                     {"tokens": jnp.asarray(jt0[:, None])})
    got = run_ranks(R.sharded_prefill_decode, 4, tmp_path, arch,
                    _reduced(arch), params_np, tokens)
    atol = 3e-4 if arch == "xlstm-350m" else 1e-5
    for key, want in (("prefill", jlp), ("decode", jld)):
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   np.asarray(want), rtol=1e-4, atol=atol,
                                   err_msg=key)
    assert got["tokens"] == [jt0.tolist(),
                             np.asarray(jld[:, -1]).argmax(-1).tolist()]
    # the cache split over the data axis on its batch (dim 1), or for
    # xlstm-350m on its group axis (dim 0)
    split = "(Shard(dim=0)" if arch == "xlstm-350m" else "(Shard(dim=1)"
    assert all(pl.startswith(split) for pl in got["cache"].values()), \
        got["cache"]


def test_sharded_steps_from_batch_iterator(tmp_path):
    """Two steps on (2, 2) fed by ``make_batch_iterator(sharding=)``
    equal two steps of the JAX package's step on its iterator's
    batches."""
    stream_kw = dict(vocab=REDUCED["vocab"], seq_len=32, global_batch=8,
                     seed=3)
    it = jmake_batch_iterator(JTokenStream(**stream_kw))
    batches = [next(it)[1] for _ in range(2)]
    replace_kw = {"microbatch": 2}
    params_np, metrics, nograd, flat, near_eps = _reference(replace_kw,
                                                            batches)
    out = str(tmp_path / "port.npz")
    got = run_ranks(R.sharded_train_step, 4, tmp_path, ARCH, REDUCED,
                    replace_kw, (2, 2), params_np, 2, stream_kw, LR, out)
    _check_step(got, out, metrics, nograd, flat, near_eps, 2)
    assert got["placements"]["batch"] == str((Shard(0), Replicate()))


# -- pipeline -----------------------------------------------------------------

def test_spmd_pipeline_matches_sequential(tmp_path):
    """4 stages over 4 ranks, 8 microbatches of 2 x 16: the sequential
    loop's output (the JAX package's, float32) within 1e-6, on every
    rank, with stage params plain and as a DTensor."""
    n_stages, n_mb, mb, d = 4, 8, 2, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((n_stages, d, d)) / np.sqrt(d)).astype(
        np.float32)
    x = rng.standard_normal((n_mb, mb, d)).astype(np.float32)
    ref = jnp.asarray(x)
    for s in range(n_stages):
        ref = jnp.tanh(ref @ jnp.asarray(w[s]))
    got = run_ranks(R.pipeline, n_stages, tmp_path, w, x, n_mb)
    assert got["ranks_agree"] and got["dtensor_equal"]
    # each stage computes its 8 microbatches, in each of the two runs
    assert got["calls"] == [2 * n_mb] * n_stages
    np.testing.assert_allclose(np.asarray(got["out"], np.float32),
                               np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_stages,n_mb", [(1, 1), (2, 8), (4, 8), (4, 1),
                                           (8, 32)])
def test_pipeline_bubble_fraction(n_stages, n_mb):
    assert pipeline_bubble_fraction(n_stages, n_mb) == \
        jbubble_fraction(n_stages, n_mb)


# -- checkpoint ---------------------------------------------------------------

def test_elastic_checkpoint_restore_across_meshes(tmp_path):
    """Saved from a (2, 2) mesh, restored under (4, 1): every leaf equal
    and placed by its spec (``None``: a host leaf)."""
    rng = np.random.default_rng(2)
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "b": rng.standard_normal(5).astype(np.float32),
            "s": rng.standard_normal(4).astype(np.float32)}
    got = run_ranks(R.elastic_checkpoint, 4, tmp_path, tree,
                    str(tmp_path / "ckpt"))
    assert got["step"] == 3
    assert all(got[k]["equal"] for k in tree), got
    assert got["w"]["placements"] == str((Shard(0), Replicate()))
    assert got["w"]["local_shape"] == [2, 8]
    assert got["s"]["placements"] == str((Shard(0), Replicate()))
    assert got["b"]["placements"] == "None"


# -- placement by spec --------------------------------------------------------

class _Mesh:
    """A mesh's names and shape, as both packages' ``mesh_axes_of`` read
    them."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.devices = np.zeros(shape)


def test_to_placements_follows_the_spec():
    m = _Mesh(("pod", "data", "model"), (2, 2, 4))
    assert SH.to_placements(SH.P(), m) == [Replicate()] * 3
    assert SH.to_placements(SH.P(None, "model"), m) == [
        Replicate(), Replicate(), Shard(1)]
    assert SH.to_placements(SH.P(("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    for bad in (SH.P(("data", "pod")), SH.P("data", "data")):
        with pytest.raises(ValueError):
            SH.to_placements(bad, m)


@pytest.mark.parametrize("names,shape", [
    (("data", "model"), (2, 2)), (("data", "model"), (4, 1)),
    (("pod", "data", "model"), (2, 2, 1)),
    (("pod", "data", "model"), (2, 16, 16))])
def test_batch_pspec_matches_reference(names, shape):
    m = _Mesh(names, shape)
    specs = {"tokens": np.zeros((8, 32)), "embeds": np.zeros((2, 3, 4)),
             "one": np.zeros((1, 5)), "odd": np.zeros((6, 2))}
    want = jzoo.batch_pspec(specs, m)
    got = tzoo.batch_pspec(specs, m)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert SH.mesh_axes_of(m) == JSH.mesh_axes_of(m)


def test_meshes_match_reference(monkeypatch):
    """``make_test_mesh`` 's defaults and ``make_production_mesh`` 's
    shapes and axes are the JAX package's (read from its signature and
    by catching its ``jax.make_mesh`` call)."""
    sig = inspect.signature(jmesh.make_test_mesh).parameters
    tsig = inspect.signature(tmesh.make_test_mesh).parameters
    for name in ("shape", "axes"):
        assert tsig[name].default == sig[name].default
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (shape, axes))
    monkeypatch.setattr(tmesh, "_device_mesh",
                        lambda shape, axes, device: (shape, axes))
    for multi_pod in (False, True):
        assert tmesh.make_production_mesh(multi_pod=multi_pod) == \
            jmesh.make_production_mesh(multi_pod=multi_pod)


def test_placement_on_ranks(tmp_path):
    """On 4 ranks: a ``("pod", "data")`` entry gives each rank numpy's
    major-to-minor block, ``P()`` replicates, ``shard_activations``
    pins a batch over the data axis (and leaves a batch of 3 alone),
    ``batch_pspec`` on a live mesh, and ``make_production_mesh`` raises
    on this world."""
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    got = run_ranks(R.placement, 4, tmp_path, x)
    assert got["block_equal"], got
    assert got["placements"] == str((Shard(0), Shard(0), Shard(1)))
    assert got["replicated"] == str((Replicate(), Replicate()))
    assert got["replicated_equal"]
    assert got["pinned"] == str((Shard(0), Replicate()))
    assert got["pinned_equal"]
    assert got["odd_batch"] == str((Replicate(), Shard(1)))
    assert "256 ranks" in got["production"]
    assert got["batch_pspec"] == [["pod", "data"], None]
    assert got["mesh_axes"] == {"pod": 2, "data": 2, "model": 1}


# -- the local-block helpers -------------------------------------------------

def test_local_blocks_are_the_identity_on_plain_tensors():
    """On plain tensors every ``LocalBlocks`` method hands back its input
    (``mean`` is ``Tensor.mean``, bit for bit), as do ``split_dim``,
    ``placed_like`` and ``replicate_dims``: the unsharded MoE and xLSTM
    paths run the ops they ran before."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((4, 6, 8)).astype(np.float32))
    p = torch.as_tensor(rng.standard_normal((4, 2, 2)).astype(np.float32))
    blocks = SH.LocalBlocks(x, heads=4)
    assert blocks.mesh is None
    assert blocks.local(x) is x and blocks.local(x, 2) is x
    assert blocks.param(p) is p and blocks.param(p, 0) is p
    assert blocks.rows(x) is x and blocks.rows(x, 2) is x
    assert torch.equal(blocks.mean(x, (0, 1)), x.mean(dim=(0, 1)))
    assert SH.placed_like(x, p) is x and SH.replicate_dims(x, [0]) is x
    assert torch.equal(SH.split_dim(x, -1, (4, 2)), x.reshape(4, 6, 4, 2))


@pytest.mark.parametrize("heads,copies", [(4, 1), (3, 2)])
def test_local_blocks_layout_and_copies(heads, copies):
    """On a fake (2, 2) world: the rows split as the reference
    activation's batch; heads that divide the model axis split over it
    (each rank's block held by no other rank), heads that do not are
    gathered (held alike by the 2 model ranks, which
    ``sharding.local_copies`` reports to the cost counter); ``rows``
    wraps a block back at the global shape; a param's block is whole
    but for its split heads."""
    with DR.fake_world(4):
        mesh = tmesh.make_test_mesh((2, 2), device="cpu")
        x = distribute_tensor(torch.zeros(4, 6, 8), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        q = distribute_tensor(torch.zeros(4, 6, heads, 2), mesh,
                              [Shard(0), Shard(2) if copies == 1
                               else Replicate()], src_data_rank=None)
        r = distribute_tensor(torch.zeros(heads, 2, 2), mesh,
                              [Replicate(), Replicate()],
                              src_data_rank=None)
        blocks = SH.LocalBlocks(x, heads=heads)
        ql = blocks.local(q, 2)
        assert tuple(ql.shape) == (2, 6, heads // (2 if copies == 1
                                                  else 1), 2)
        assert SH.local_copies(ql) == copies
        assert SH.local_copies(blocks.local(x)) == 2
        back = blocks.rows(ql, 2)
        assert tuple(back.shape) == (4, 6, heads, 2)
        assert back.placements == q.placements
        rl = blocks.param(r, 0)
        assert tuple(rl.shape) == (heads // (2 if copies == 1 else 1), 2, 2)
        assert SH.local_copies(rl) == 1


# -- the harness --------------------------------------------------------------

def test_harness_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the call with its own traceback, well
    before the deadline, while the others wait in a collective."""
    with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
        run_ranks(R.fails_on_rank_1, 2, tmp_path, timeout=60)


def test_harness_kills_a_hung_rank(tmp_path):
    """A rank that never reaches the collective is killed at the
    deadline and the call fails instead of hanging."""
    with pytest.raises(AssertionError, match="timed out"):
        run_ranks(R.hangs_on_rank_1, 2, tmp_path, timeout=8)


def test_staged_group_runs_collectives_and_dtensor(tmp_path):
    """The CUDA device type's process group (``launch/staged_gloo.py``)
    on 4 CPU ranks, CPU tensors going to its gloo backend unstaged:
    all-reduce, all-gather, reduce-scatter and DTensor's placements on
    a mesh over it give the right results, and its counts name each
    collective it ran (0 bytes staged on the CPU)."""
    got = run_ranks(R.staged_group_on_cpu, 4, tmp_path)
    assert all(got["ok"].values()), got["ok"]
    assert got["backend"] == "repro_staged_gloo"
    for name in ("allreduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor"):
        assert got["counts"].get(name, 0) >= 1, got["counts"]
    assert "bytes_to_host" not in got["counts"]
