"""SigMesh's host-side pieces in the PyTorch port against the JAX package.

  * Spec rules: ``param_specs`` of every config the JAX package ships, at
    ``reduced()`` size (weights from the JAX package's own init through
    ``convert.model_params_from_jax``), equal the JAX package's leaf for
    leaf on a ``{"data": 2, "model": 2}`` and a ``{"pod": 2, "data": 16,
    "model": 16}`` mesh, with and without fsdp; so do ``zero1_spec`` of
    every leaf, ``batch_spec`` and ``cache_specs`` of each config's
    decode cache, and the cases of ``tests/test_serving_sharding.py``.
  * Router parity: one seeded script of ``assign`` / ``release`` /
    ``charge`` / ``drop`` fed to both packages' ``DeviceRouter`` s gives
    the same answers and the same ``occupancy()`` after every call.
  * The sharding properties of ``tests/test_signal_sharding_props.py``,
    swept through ``tests/_hypothesis_compat.py``: shard -> trim round
    trips on uneven rows (on a virtual mesh over one CPU slot and on an
    explicit ``DataMesh`` of CPU slots, where the rows really split),
    ``padded_rows``, ``device_step_costs``, balanced least-loaded
    assignment, dropped shards never chosen, the per-device ledger of one
    served mix equal to the JAX package's, and session affinity.

Everything runs in one process on the CPU: the mesh is placement slots
of one device, as the JAX package's tests run on a virtual mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.core import perf_model as jperf
from repro.models import sharding as JSH
from repro.models.zoo import get_model as jget_model
from repro.serving import DeviceRouter as JRouter
from repro.serving import SignalMesh as JMesh
from repro.serving import SignalRequest as JRequest
from repro.serving import SignalService as JService
from repro.signal import SignalGraph as JGraph
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.core.perf_model import (device_step_costs, sharded_step_cost,
                                         step_cost_estimate,
                                         step_cost_estimate_per_device)
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models import get_model
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import P
from repro_torch.serving import (DeviceRouter, SignalMesh, SignalRequest,
                                 SignalService, trim_rows)
from repro_torch.signal import SignalGraph

FRAME, HOP = 64, 32
AXES = [{"data": 2, "model": 2}, {"pod": 2, "data": 16, "model": 16}]
ARCHS = jconfigs.list_configs()


def _fig9(graph_cls=SignalGraph, sig=torch.sigmoid, absf=torch.abs):
    g = graph_cls("g")
    g.stft("spec", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec", fn=lambda p, z: sig(absf(z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP)
    g.outputs("out")
    return g


def _jfig9():
    return _fig9(JGraph, jax.nn.sigmoid, jnp.abs)


def _pairs(ttree, jtree):
    """(port leaf, JAX leaf) pairs of two spec trees of one structure,
    walked along the port's (a :class:`P` is a leaf, not a tuple)."""
    if isinstance(ttree, dict):
        assert sorted(ttree) == sorted(jtree)
        for k in ttree:
            yield from _pairs(ttree[k], jtree[k])
    elif isinstance(ttree, (list, tuple)) and not isinstance(ttree, P):
        assert len(ttree) == len(jtree)
        for t, j in zip(ttree, jtree):
            yield from _pairs(t, j)
    else:
        yield ttree, jtree


def _leaves_with_shapes(ttree, jtree):
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _leaves_with_shapes(ttree[k], jtree[k])
    elif isinstance(ttree, (list, tuple)):
        for t, j in zip(ttree, jtree):
            yield from _leaves_with_shapes(t, j)
    else:
        yield ttree, jtree


# -- spec rules ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Each config at reduced() size: the JAX package's params and cache,
    and the port's, converted leaf for leaf."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).reduced()
        jb = jget_model(jcfg)
        jp = jb.init(jax.random.PRNGKey(0))
        tb = get_model(get_config(arch).reduced())
        out[arch] = (jp, model_params_from_jax(jp, "cpu"),
                     jb.init_cache(2, 16), tb.init_cache(2, 16,
                                                         device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_jax_package(models, arch):
    """param_specs of every leaf (the innermost dict key names it), on
    both meshes, with and without fsdp; zero1_spec of each leaf."""
    jp, tp, _, _ = models[arch]
    n = 0
    for axes in AXES:
        for fsdp in (False, True):
            tspecs = SH.param_specs(tp, axes, fsdp)
            jspecs = JSH.param_specs(jp, axes, fsdp)
            for t, j in _pairs(tspecs, jspecs):
                assert isinstance(t, P) and t == j
                n += 1
            for (leaf, jleaf), (t, j) in zip(
                    _leaves_with_shapes(tp, jp), _pairs(tspecs, jspecs)):
                shape = tuple(leaf.shape)
                assert shape == tuple(jleaf.shape)
                assert SH.zero1_spec(t, shape, axes) == \
                    JSH.zero1_spec(j, shape, axes)
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_jax_package(models, arch):
    """cache_specs of the decode cache at batch 2 and batch_spec of the
    batch shapes a step takes, on both meshes."""
    _, _, jcache, tcache = models[arch]
    for axes in AXES:
        for t, j in _pairs(SH.cache_specs(tcache, axes, 2),
                           JSH.cache_specs(jcache, axes, 2)):
            assert t == j
        for shape in [(2, 16), (32, 16), (1, 7, 64), (64, 8, 4), (6,)]:
            for dim in range(len(shape)):
                assert SH.batch_spec(shape, axes, dim) == \
                    JSH.batch_spec(shape, axes, dim)
        assert SH.batch_axes(axes) == JSH.batch_axes(axes)


def test_param_spec_rules():
    """tests/test_serving_sharding.py's rule cases, on the port's P."""
    axes = {"data": 16, "model": 16}
    assert SH.param_spec("wq", (4096, 4096), axes, False) == P(None, "model")
    assert SH.param_spec("wq", (4096, 4096), axes, True) == P("data", "model")
    assert SH.param_spec("wo", (4096, 4096), axes, False) == P("model", None)
    assert SH.param_spec("embed", (92672, 6144), axes, False) == \
        P("model", None)
    assert SH.param_spec("wq", (4096, 100), axes, False) == P(None, None)
    assert SH.param_spec("w_up", (30, 4096, 16384), axes, False) == \
        P(None, None, "model")
    assert SH.param_spec("experts_gate", (8, 6144, 32768), axes, True) == \
        P(None, "data", "model")
    assert SH.param_spec("norm_in", (4096,), axes, False) == P(None)
    assert P("data", "model") == JP("data", "model")


def test_zero1_spec_adds_data_axis():
    axes = {"data": 16, "model": 16}
    spec = SH.param_spec("wq", (4096, 4096), axes, False)
    assert SH.zero1_spec(spec, (4096, 4096), axes) == P("data", "model")
    spec2 = SH.param_spec("wq", (4096, 4096), axes, True)
    assert SH.zero1_spec(spec2, (4096, 4096), axes) == P("data", "model")


def test_cache_specs_shard_batch():
    axes = {"data": 16, "model": 16}
    cache = {"k": torch.empty((128, 32768, 8, 128), dtype=torch.bfloat16,
                              device="meta"),
             "kv16": torch.empty((128, 32768, 16, 128),
                                 dtype=torch.bfloat16, device="meta"),
             "pos": torch.empty((), dtype=torch.int32, device="meta")}
    specs = SH.cache_specs(cache, axes, batch=128)
    assert specs["k"] == P("data", None, None, "model")
    assert specs["kv16"] == P("data", None, "model", None)
    assert specs["pos"] == P()


def test_row_sharding_and_mesh_axes():
    """row_sharding binds batch_spec to a DataMesh; split_rows splits the
    rows evenly over the slots or runs them once on the first."""
    mesh = DataMesh(["cpu"] * 4)
    assert SH.mesh_axes_of(mesh) == {"data": 4}
    assert mesh.shape == (4,) and mesh.axis_names == ("data",)
    assert SH.row_sharding(mesh, (8, 3)).spec == P("data", None)
    assert SH.row_sharding(mesh, (6, 3)).spec == P(None, None)
    x = torch.arange(8.0)
    assert [b.tolist() for b in SH.split_rows(mesh, x)] == \
        [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert [b.tolist() for b in SH.split_rows(mesh, x[:6])] == \
        [[0.0, 1.0, 2.0, 3.0, 4.0, 5.0]]
    one = make_data_mesh(device="cpu")
    assert one.devices == (torch.device("cpu"),)
    (blk,) = SH.split_rows(one, x[:5])
    assert blk.device == torch.device("cpu") and blk.tolist() == x[:5].tolist()
    with pytest.raises(ValueError):
        make_data_mesh(2, device="cpu")


def test_mesh_on_the_card_raises_without_one():
    """A shard count over the card raises on a host without one, as
    resolve_device does: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        SignalService(mesh=2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        SignalMesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_data_mesh()
    with pytest.raises(ValueError, match="device type"):
        SignalService(mesh=DataMesh(["cpu"]), device="meta")


# -- router parity ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_router_matches_the_jax_package_on_a_seeded_script(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    jr, tr = JRouter(n), DeviceRouter(n)
    for _ in range(200):
        op = rng.choice(["assign", "assign", "release", "charge", "drop"])
        if op == "assign":
            hint = int(rng.choice([0, int(rng.integers(1, 1000))]))
            if jr.alive_count() == 0:
                with pytest.raises(RuntimeError):
                    jr.assign(hint)
                with pytest.raises(RuntimeError):
                    tr.assign(hint)
            else:
                assert tr.assign(hint) == jr.assign(hint)
        elif op == "release":
            idx = None if rng.random() < 0.2 else int(rng.integers(n))
            jr.release(idx)
            tr.release(idx)
        elif op == "charge":
            idx, c = int(rng.integers(n)), int(rng.integers(0, 5000))
            jr.charge(idx, c)
            tr.charge(idx, c)
        elif rng.random() < 0.3:
            idx = int(rng.integers(n))
            jr.drop(idx)
            tr.drop(idx)
        assert tr.occupancy() == jr.occupancy()
        assert tr.alive_count() == jr.alive_count()


# -- sharding properties (tests/test_signal_sharding_props.py) ----------------

@settings(max_examples=30)
@given(st.integers(1, 40), st.integers(1, 9))
def test_shard_trim_round_trip_on_uneven_rows(rows, n_shards):
    """pad -> shard -> trim is the identity on the real rows, on a virtual
    mesh over one CPU slot and on n_shards explicit CPU slots."""
    rng = np.random.default_rng(rows * 100 + n_shards)
    real = rng.standard_normal((rows, 16)).astype(np.float32)
    for mesh in (SignalMesh(n_shards, device="cpu"),
                 SignalMesh(mesh=DataMesh(["cpu"] * n_shards))):
        padded = mesh.padded_rows(rows)
        assert padded >= rows and padded % n_shards == 0
        assert padded - rows < n_shards
        stack = np.zeros((padded, 16), np.float32)
        stack[:rows] = real
        blocks = mesh.shard(stack)
        slots = len(mesh.devices)
        assert len(blocks) == (slots if padded % slots == 0 and slots > 1
                               else 1)
        assert all(b.shape[0] == padded // len(blocks) for b in blocks)
        back = trim_rows(torch.cat(blocks).numpy(), rows)
        np.testing.assert_array_equal(back, real)
        multi = trim_rows({"b": stack, "a": stack[:, :2]}, rows)
        assert list(multi) == ["b", "a"]


@settings(max_examples=20)
@given(st.integers(1, 32), st.integers(1, 8))
def test_padded_rows_is_stable(rows, n_shards):
    mesh = SignalMesh(n_shards, device="cpu")
    p = mesh.padded_rows(rows)
    assert mesh.padded_rows(p) == p
    assert p == JMesh(n_shards).padded_rows(rows)
    assert mesh.align_row_budget(rows) == JMesh(n_shards).align_row_budget(
        rows)
    assert mesh.align_row_budget(None) is None


@settings(max_examples=30)
@given(st.integers(0, 64), st.integers(1, 9), st.integers(1, 5000))
def test_device_step_costs_consistent_with_totals(batch, n, per_item):
    costs = device_step_costs(per_item, batch, n)
    assert costs == jperf.device_step_costs(per_item, batch, n)
    assert len(costs) == n
    assert len(set(costs)) == 1
    assert sharded_step_cost(per_item, batch, n) == max(costs, default=0)
    if batch:
        assert max(costs) * n >= per_item * batch
        assert max(costs) <= per_item * (batch // n + (batch % n > 0))


def test_step_cost_estimate_per_device_matches_step_cost_estimate():
    compiled = _fig9().compile(512, device="cpu")
    per_item = step_cost_estimate(compiled, batch=1)
    for n in (1, 2, 8):
        assert step_cost_estimate_per_device(compiled, batch=4,
                                             n_devices=n) == \
            device_step_costs(per_item, 4, n)
    assert step_cost_estimate_per_device(compiled, batch=4,
                                         n_devices=1) == \
        [step_cost_estimate(compiled, batch=4)]


@settings(max_examples=20)
@given(st.integers(2, 8), st.integers(5, 40))
def test_router_greedy_assignment_is_balanced(n, sessions):
    r = DeviceRouter(n)
    for _ in range(sessions):
        r.assign()
    occ = r.occupancy()["sessions"]
    assert sum(occ) == sessions
    assert max(occ) - min(occ) <= 1


@settings(max_examples=20)
@given(st.integers(2, 8), st.integers(1, 6))
def test_router_drop_redirects_all_future_assignments(n, drops):
    r = DeviceRouter(n)
    dead = list(range(min(drops, n - 1)))
    for d in dead:
        r.drop(d)
    for _ in range(3 * n):
        assert r.assign() not in dead
    assert r.alive_count() == n - len(dead)


def test_per_device_occupancy_equals_the_jax_package():
    """The router's ledger for one served mix of uneven lengths (waves of
    4 and 3 rows on 8 shards) equals the perf model's per-device estimate
    and the JAX package's ledger; wall_cycles advanced by the largest
    share, est_cycles by the whole batch."""
    rng = np.random.default_rng(3)
    sigs = [rng.standard_normal(t).astype(np.float32)
            for t in (512, 512, 400, 300, 512, 450, 333)]
    svc = SignalService(batch_size=4, mesh=SignalMesh(8, device="cpu"),
                        device="cpu")
    svc.register("g", _fig9())
    res = svc.serve([SignalRequest(rid=i, graph="g", samples=s)
                     for i, s in enumerate(sigs)])
    assert sorted(res) == list(range(len(sigs)))
    jsvc = JService(batch_size=4, mesh=JMesh(8))
    jsvc.register("g", _jfig9())
    jsvc.serve([JRequest(rid=i, graph="g", samples=s)
                for i, s in enumerate(sigs)])
    per_item = svc.group_cost(("g", 512))
    expected = [a + b for a, b in zip(device_step_costs(per_item, 4, 8),
                                      device_step_costs(per_item, 3, 8))]
    assert svc.router.device_cycles == expected
    assert svc.router.occupancy() == jsvc.router.occupancy()
    assert svc.wall_cycles == jsvc.wall_cycles == 2 * per_item
    assert svc.est_cycles == jsvc.est_cycles == per_item * len(sigs)


@pytest.mark.parametrize("mesh", ["virtual", "slots"])
def test_session_affinity_invariant_across_ticks(mesh):
    """A session's carried state stays on its shard (and its device) for
    the whole stream, and each tick's cost lands on exactly that shard's
    ledger; idle shards are never charged; closing releases the shard."""
    m = SignalMesh(8, device="cpu") if mesh == "virtual" \
        else SignalMesh(mesh=DataMesh(["cpu"] * 4))
    svc = SignalService(batch_size=4, mesh=m, device="cpu")
    svc.register("g", _fig9())
    rng = np.random.default_rng(4)
    sessions = [svc.open_stream("g") for _ in range(3)]
    homes = [s.device_index for s in sessions]
    assert homes == [0, 1, 2]
    charged = {d: 0 for d in homes}
    for _ in range(6):
        for s in sessions:
            s.feed(rng.standard_normal(128).astype(np.float32))
        before = list(svc.router.device_cycles)
        assert svc.stream_step() in (0, 3)
        for s, home in zip(sessions, homes):
            assert s.device_index == home
            assert s.state.buf.device == m.device_for(home)
        for d in set(homes):
            charged[d] += svc.router.device_cycles[d] - before[d]
    vals = {charged[d] for d in homes}
    assert len(vals) == 1 and vals != {0}
    for d in range(m.n_shards):
        if d not in homes:
            assert svc.router.device_cycles[d] == 0
    for s in sessions:
        s.close()
    assert sum(svc.router.occupancy()["sessions"]) == 0
