"""SigSched in the PyTorch port against the JAX package.

The cases of the JAX package's ``tests/test_scheduler.py`` run on the
port's service (CPU, plain versions of the kernels), and:

  * results are held against the JAX package's OFFLINE
    ``graph.compile(t).jit()`` at the request's true length, rtol 1e-5,
    atol 1e-6 — not against its scheduled outputs, which are not
    ground truth across JAX versions (they miss its own offline compile
    by float32 rounding);
  * where the wave composition is the same (default scheduler vs
    ``scheduler=False``, one graph) results equal the port's unscheduled
    service exactly;
  * dispatch decisions are pure host logic over integer perf-model
    cycles, so the port's ``SigSched`` and the JAX package's are fed the
    same seeded submission script and must dispatch the same rids in the
    same order, tick by tick, with the same ``stats``, ``backlog_rows()``
    and ``est_cycles``;
  * Fig 9 at test size with two registrations of different FIR taps and
    mask weights runs as one wave with per-row params (``out`` atol
    1e-5, ``mel_tap`` rtol = atol = 1e-4 of the JAX package's offline
    compile with each row's own params), and so does a wave of an
    int-routed FIR, a biquad, a learnable window or a grouped operand
    (alone or chained), with the JAX package's ``SignalService`` stats
    on the same wave.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro import signal as jsig
from repro_torch import signal as tsig
from repro_torch.convert import params_from_jax
from repro_torch.core.exec_ir import RowParams
from repro_torch.core.fabric import ShufflePlan
from repro_torch.kernels.shuffle_gemm import (
    ref_shuffle_gemm_blocks, shuffle_gemm, shuffle_gemm_blocks)
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SignalRequest, SignalService, SigSched
from repro_torch.signal import HopperBackend, PrecisionPolicy

FRAME, HOP = 64, 32
RTOL, ATOL = 1e-5, 1e-6


# -- the graphs: the JAX package's test graph, in both packages ------------

def _jmask(p, z):
    return jax.nn.sigmoid(jnp.abs(z) - 1.0)


def _jwmask(p, z):
    return jax.nn.sigmoid(jnp.abs(z) - p["w"])


def _tmask(p, z):
    return torch.sigmoid(torch.abs(z) - 1.0)


def _twmask(p, z):
    return torch.sigmoid(torch.abs(z) - p["w"])


def _graph(pkg, name, fn, init=None):
    g = pkg.SignalGraph(name)
    g.stft("spec", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec", fn=fn, **({"init": init} if init else {}))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP)
    g.outputs("out")
    return g


def _tgraph(name, weighted=False):
    if weighted:
        return _graph(tsig, name, _twmask, {"w": np.float32(1.0)})
    return _graph(tsig, name, _tmask)


def _jgraph(name, weighted=False):
    if weighted:
        return _graph(jsig, name, _jwmask, {"w": np.float32(1.0)})
    return _graph(jsig, name, _jmask)


def _svc(**kw):
    return SignalService(device="cpu", **kw)


_REF_CACHE = {}


def _val(res):
    """Unwrap the single-output SigProgram dict the service returns."""
    return res["out"] if isinstance(res, dict) else res


def _offline(samples, params=None, weighted=False):
    """The JAX package's graph compiled offline at the request's exact
    length: the ground truth every scheduled path must reproduce."""
    key = (weighted, int(samples.shape[-1]))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _jgraph("ref", weighted).compile(key[1]).jit()
    out = _REF_CACHE[key](jnp.asarray(samples), params)
    return np.asarray(out["out"] if isinstance(out, dict) else out)


def _hold(got, samples, params=None, weighted=False):
    np.testing.assert_allclose(_val(got),
                               _offline(samples, params, weighted),
                               rtol=RTOL, atol=ATOL)


def _signals(rng, n, lengths=(192, 256, 320)):
    return [rng.standard_normal(
        lengths[i % len(lengths)]).astype(np.float32) for i in range(n)]


# -- legacy equivalence ----------------------------------------------------

def test_default_scheduler_matches_legacy_fifo_stats():
    rng = np.random.default_rng(0)
    sigs = _signals(rng, 5)

    def reqs():
        return [SignalRequest(rid=i, graph="g", samples=s)
                for i, s in enumerate(sigs)]
    on = _svc(batch_size=3)
    on.register("g", _tgraph("g"))
    off = _svc(batch_size=3, scheduler=False)
    off.register("g", _tgraph("g"))
    assert isinstance(on.scheduler, SigSched) and off.scheduler is None
    res_on, res_off = on.serve(reqs()), off.serve(reqs())
    for k in ("batches", "bucketed", "exact", "compiles"):
        assert on.stats[k] == off.stats[k], k
    for i, s in enumerate(sigs):
        assert np.array_equal(_val(res_on[i]), _val(res_off[i]))
        _hold(res_on[i], s)


# -- preemptible waves -----------------------------------------------------

def test_split_waves_match_offline():
    rng = np.random.default_rng(1)
    sigs = _signals(rng, 6)
    svc = _svc(batch_size=8, scheduler={"row_budget": 2})
    svc.register("g", _tgraph("g"))
    res = svc.serve([SignalRequest(rid=i, graph="g", samples=s)
                     for i, s in enumerate(sigs)])
    assert svc.scheduler.stats["wave_splits"] >= 1
    assert svc.scheduler.backlog_rows() == 0
    for i, s in enumerate(sigs):
        _hold(res[i], s)


def test_split_wave_counts_pending_until_drained():
    rng = np.random.default_rng(2)
    sigs = [rng.standard_normal(256).astype(np.float32) for _ in range(5)]
    svc = _svc(batch_size=8, scheduler={"row_budget": 2})
    svc.register("g", _tgraph("g"))
    for i, s in enumerate(sigs):
        svc.submit(SignalRequest(rid=i, graph="g", samples=s))
    first = svc.step()
    # the whole wave is claimed; two rows ran, three are backlog
    assert len(first) == 2
    assert svc.scheduler.backlog_rows() == 3
    assert svc.pending() == 3


# -- cross-graph batching --------------------------------------------------

def test_cross_graph_batching_one_wave():
    rng = np.random.default_rng(3)
    sigs = _signals(rng, 6, lengths=(256,))

    def reqs():
        return [SignalRequest(rid=i, graph=("a" if i % 2 else "b"),
                              samples=s) for i, s in enumerate(sigs)]
    on = _svc(batch_size=8)
    on.register("a", _tgraph("a"))
    on.register("b", _tgraph("b"))
    res = on.serve(reqs())
    assert on.scheduler.stats["cross_graph_batches"] >= 1
    assert on.stats["batches"] == 1          # ONE call for both graphs
    off = _svc(batch_size=8, scheduler=False)
    off.register("a", _tgraph("a"))
    off.register("b", _tgraph("b"))
    ref = off.serve(reqs())
    assert off.stats["batches"] == 2         # legacy: one call per graph
    for i, s in enumerate(sigs):
        _hold(res[i], s)
        np.testing.assert_allclose(_val(res[i]), _val(ref[i]), rtol=RTOL,
                                   atol=ATOL)


def test_cross_graph_disabled_keeps_per_graph_waves():
    rng = np.random.default_rng(4)
    sigs = _signals(rng, 4, lengths=(256,))
    svc = _svc(batch_size=8, scheduler={"cross_graph": False})
    svc.register("a", _tgraph("a"))
    svc.register("b", _tgraph("b"))
    svc.serve([SignalRequest(rid=i, graph=("a" if i % 2 else "b"),
                             samples=s) for i, s in enumerate(sigs)])
    assert svc.scheduler.stats["cross_graph_batches"] == 0
    assert svc.stats["batches"] == 2


def test_cross_graph_different_params_per_row():
    """fp-equal graphs whose registered params DIFFER share one wave: the
    per-row call threads each row its own params (no split)."""
    rng = np.random.default_rng(5)
    pa = {"mask": {"w": np.float32(0.5)}}
    pb = {"mask": {"w": np.float32(2.0)}}
    sigs = _signals(rng, 4, lengths=(256,))
    svc = _svc(batch_size=8)
    svc.register("a", _tgraph("a", weighted=True), params=pa)
    svc.register("b", _tgraph("b", weighted=True), params=pb)
    res = svc.serve([SignalRequest(rid=i, graph=("a" if i % 2 else "b"),
                                   samples=s) for i, s in enumerate(sigs)])
    assert svc.scheduler.stats["cross_graph_batches"] == 1
    assert svc.stats["param_splits"] == 0 and svc.stats["batches"] == 1
    for i, s in enumerate(sigs):
        _hold(res[i], s, params=(pa if i % 2 else pb), weighted=True)


def test_structurally_different_graphs_never_mix():
    rng = np.random.default_rng(6)
    g2 = tsig.SignalGraph("other")
    g2.stft("spec", frame=FRAME, hop=HOP)
    g2.magnitude("out", "spec", onesided=True)
    g2.outputs("out")
    svc = _svc(batch_size=8)
    svc.register("a", _tgraph("a"))
    svc.register("other", g2)
    sigs = _signals(rng, 4, lengths=(256,))
    svc.serve([SignalRequest(rid=i, graph=("a" if i % 2 else "other"),
                             samples=s) for i, s in enumerate(sigs)])
    assert svc.scheduler.stats["cross_graph_batches"] == 0
    assert svc.stats["batches"] == 2


# -- deadline-aware picking ------------------------------------------------

def test_tight_deadline_preempts_older_bulk_group():
    rng = np.random.default_rng(7)
    svc = _svc(batch_size=8)
    svc.register("g", _tgraph("g"))
    for i in range(4):
        svc.submit(SignalRequest(
            rid=i, graph="g",
            samples=rng.standard_normal(512).astype(np.float32)))
    svc.submit(SignalRequest(
        rid=99, graph="g", deadline=1.0,
        samples=rng.standard_normal(256).astype(np.float32)))
    first = svc.step()
    assert list(first) == [99]
    assert svc.pending() == 4


def test_slack_rich_group_defers_one_tick_to_fill():
    rng = np.random.default_rng(8)
    svc = _svc(batch_size=8)
    svc.register("g", _tgraph("g"))
    svc.submit(SignalRequest(
        rid=0, graph="g", deadline=1e15,
        samples=rng.standard_normal(256).astype(np.float32)))
    assert svc.step() == {}                       # deferred
    assert svc.scheduler.stats["deferrals"] == 1
    svc.submit(SignalRequest(
        rid=1, graph="g", deadline=1e15,
        samples=rng.standard_normal(256).astype(np.float32)))
    res = svc.step()                              # max_defers=1: runs now
    assert sorted(res) == [0, 1]
    assert svc.stats["batches"] == 1              # one fuller wave


def test_inf_deadline_group_drains_under_sustained_finite_load():
    rng = np.random.default_rng(9)
    svc = _svc(batch_size=1)
    svc.register("g", _tgraph("g"))
    svc.submit(SignalRequest(
        rid=1000, graph="g",
        samples=rng.standard_normal(512).astype(np.float32)))
    served_inf_after = None
    results = {}
    for tick in range(60):
        svc.submit(SignalRequest(
            rid=tick, graph="g", deadline=float(svc.est_cycles),
            samples=rng.standard_normal(256).astype(np.float32)))
        results.update(svc.step())
        if 1000 in results:
            served_inf_after = tick
            break
    assert served_inf_after is not None, "deadline=inf group starved"
    sched = svc.scheduler
    assert served_inf_after <= 6 * sched.starvation_ticks
    assert sched.stats["starvation_picks"] >= 1


# -- random request mixes: every mix, scheduled == offline -----------------

@pytest.mark.parametrize("case", range(8))
def test_random_mix_matches_offline(case):
    rng0 = np.random.default_rng(1000 + case)
    n = int(rng0.integers(2, 8))
    budget = [None, 1, 2, 3][case % 4]
    rng = np.random.default_rng(int(rng0.integers(0, 2 ** 16)))
    svc = _svc(batch_size=4, scheduler={"row_budget": budget})
    svc.register("a", _tgraph("a"))
    svc.register("b", _tgraph("b"))
    reqs = []
    for i in range(n):
        length = int(rng.choice([192, 256, 320]))
        deadline = math.inf if rng.random() < 0.5 \
            else float(rng.integers(0, 10_000_000))
        reqs.append(SignalRequest(
            rid=i, graph=("a" if rng.random() < 0.5 else "b"),
            deadline=deadline,
            samples=rng.standard_normal(length).astype(np.float32)))
    res = svc.serve(reqs)
    assert sorted(res) == list(range(n))
    assert svc.scheduler.backlog_rows() == 0
    for r in reqs:
        _hold(res[r.rid], r.samples)


# -- streaming: cross-graph session stacking -------------------------------

def test_stream_cross_graph_sessions_stack_into_one_core_call():
    rng = np.random.default_rng(10)
    svc = _svc(batch_size=4, block_frames=4)
    svc.register("a", _tgraph("a"))
    svc.register("b", _tgraph("b"))
    sa, sb = svc.open_stream("a"), svc.open_stream("b")
    x = rng.standard_normal(512).astype(np.float32)
    y = rng.standard_normal(512).astype(np.float32)
    sa.feed(x)
    sb.feed(torch.as_tensor(y))
    calls = svc.stream_step()
    assert calls == 1                    # ONE core call for both graphs
    assert svc.scheduler.stats["cross_graph_batches"] == 1
    outa = np.concatenate([_val(sa.read()), _val(sa.close())])
    outb = np.concatenate([_val(sb.read()), _val(sb.close())])
    np.testing.assert_allclose(outa, _offline(x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outb, _offline(y), rtol=RTOL, atol=ATOL)


def test_stream_params_split_and_per_graph_without_scheduler():
    """fp-equal graphs with different params never share a core call, and
    ``scheduler=False`` stacks per graph: two calls either way."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal(512).astype(np.float32)
    pa = {"mask": {"w": np.float32(0.5)}}
    pb = {"mask": {"w": np.float32(2.0)}}
    for kw, params in (({}, (pa, pb)), ({"scheduler": False}, (pa, pa))):
        svc = _svc(block_frames=4, **kw)
        svc.register("a", _tgraph("a", weighted=True), params=params[0])
        svc.register("b", _tgraph("b", weighted=True), params=params[1])
        sa, sb = svc.open_stream("a"), svc.open_stream("b")
        sa.feed(x)
        sb.feed(x)
        assert svc.stream_step() == 2
        outb = np.concatenate([_val(sb.read()), _val(sb.close())])
        np.testing.assert_allclose(outb, _offline(x, params[1], True),
                                   rtol=RTOL, atol=ATOL)


def test_reregister_purges_claimed_wave_rows():
    rng = np.random.default_rng(11)
    svc = _svc(batch_size=8, scheduler={"row_budget": 1})
    svc.register("g", _tgraph("g"))
    reqs = [SignalRequest(rid=i, graph="g",
                          samples=rng.standard_normal(256).astype(
                              np.float32)) for i in range(3)]
    for r in reqs:
        svc.submit(r)
    svc.step()                              # claims the wave, runs 1 row
    assert svc.scheduler.backlog_rows() == 2
    svc.register("g", _tgraph("g"))         # replacement drops backlog
    assert svc.scheduler.backlog_rows() == 0
    assert svc.pending() == 0
    assert svc.stats["dropped"] == 2
    assert [r.error is not None for r in reqs] == [False, True, True]


def test_promotion_moves_each_row_at_most_once_per_tick():
    rng = np.random.default_rng(12)
    svc = _svc(batch_size=8, scheduler=True)
    svc.register("a", _tgraph("a"))
    sigs = []
    for i, (n, dl) in enumerate([(500, math.inf), (500, math.inf),
                                 (500, math.inf), (200, math.inf),
                                 (200, math.inf), (80, 1e12)]):
        x = rng.standard_normal(n).astype(np.float32)
        sigs.append(x)
        svc.submit(SignalRequest(rid=i, graph="a", samples=x, deadline=dl))
    done = {}
    for _ in range(20):
        done.update(svc.step())
        if len(done) == len(sigs):
            break
    assert sorted(done) == list(range(len(sigs)))
    for i, x in enumerate(sigs):
        _hold(done[i], x)
    assert svc.scheduler.stats["bucket_promotions"] >= 1


def test_scheduler_validation_errors():
    svc = _svc()
    for kw in ({"row_budget": 0}, {"max_defers": -1},
               {"starvation_ticks": 0}):
        with pytest.raises(ValueError):
            SigSched(svc, **kw)
    sched = SigSched(svc, row_budget=3)
    other = _svc(scheduler=sched)
    assert other.scheduler is sched and sched.service is other


# -- decision parity with the JAX package's SigSched -----------------------

@pytest.mark.parametrize("bucket", [128, 256, 512])
def test_costs_equal_reference(bucket):
    jsvc = jserving.SignalService(batch_size=4)
    tsvc = _svc(batch_size=4)
    jsvc.register("g", _jgraph("g"))
    tsvc.register("g", _tgraph("g"))
    assert tsvc.group_cost(("g", bucket)) == jsvc.group_cost(("g", bucket))
    n_frames = 1 + (bucket - FRAME) // HOP
    assert tsvc._stream_cost("g", n_frames) == \
        jsvc._stream_cost("g", n_frames)


def _script(seed, ticks=14):
    """A seeded submission script: per tick, the requests submitted
    before it — (rid, graph, samples, deadline slack or None for inf)."""
    rng = np.random.default_rng(seed)
    rid, out = 0, []
    for t in range(ticks):
        reqs = []
        for _ in range(int(rng.integers(0, 4)) if t < ticks - 4 else 0):
            n = int(rng.choice([80, 192, 256, 320, 500]))
            kind = rng.random()
            slack = None if kind < 0.4 else (
                float(rng.integers(0, 40_000)) if kind < 0.8
                else float(rng.integers(10 ** 9, 10 ** 10)))
            reqs.append((rid, "a" if rng.random() < 0.5 else "b",
                         rng.standard_normal(n).astype(np.float32), slack))
            rid += 1
        out.append(reqs)
    return out


@pytest.mark.parametrize("budget", [None, 1, 2, 3])
def test_dispatch_decisions_equal_reference(budget):
    cfg = {"row_budget": budget}
    jsvc = jserving.SignalService(batch_size=3, scheduler=dict(cfg))
    tsvc = _svc(batch_size=3, scheduler=dict(cfg))
    for svc, g in ((jsvc, _jgraph), (tsvc, _tgraph)):
        svc.register("a", g("a"))
        svc.register("b", g("b"))
    ticks, waves = 0, 0
    for reqs in _script(20 + (budget or 0)):
        assert tsvc.est_cycles == jsvc.est_cycles
        for svc, req in ((jsvc, jserving.SignalRequest),
                         (tsvc, SignalRequest)):
            for rid, g, x, slack in reqs:
                dl = math.inf if slack is None \
                    else float(svc.est_cycles) + slack
                svc.submit(req(rid=rid, graph=g, samples=x.copy(),
                               deadline=dl))
        got_j, got_t = jsvc.step(), tsvc.step()
        assert list(got_t) == list(got_j), ticks
        assert tsvc.scheduler.stats == jsvc.scheduler.stats, ticks
        assert tsvc.stats == jsvc.stats, ticks
        assert tsvc.scheduler.backlog_rows() == \
            jsvc.scheduler.backlog_rows()
        assert tsvc.pending() == jsvc.pending()
        assert tsvc.est_cycles == jsvc.est_cycles
        ticks += 1
        waves += bool(got_t)
    while jsvc.pending() or tsvc.pending():
        got_j, got_t = jsvc.step(), tsvc.step()
        assert list(got_t) == list(got_j)
        assert tsvc.scheduler.stats == jsvc.scheduler.stats
        assert tsvc.est_cycles == jsvc.est_cycles
        ticks += 1
        assert ticks < 200
    st = tsvc.scheduler.stats
    assert waves >= 4 and st["dispatches"] >= 4
    assert st["deferrals"] + st["bucket_promotions"] + st["wave_splits"] \
        + st["cross_graph_batches"] >= 1


def _traced_run(pkg_obs, svc, req, graph):
    """Drive ``_script(31)`` through ``svc`` with tracing on; return the
    SigSched lane's events and the ``scheduler`` counter track in order
    (name, phase, args without the program fingerprint), and the
    ``sched.*`` metrics."""
    pkg_obs.reset()
    pkg_obs.enable()
    try:
        svc.register("a", graph("a"))
        svc.register("b", graph("b"))
        for reqs in _script(31):
            for rid, g, x, slack in reqs:
                svc.submit(req(rid=rid, graph=g, samples=x.copy(),
                               deadline=math.inf if slack is None
                               else float(svc.est_cycles) + slack))
            svc.step()
        while svc.pending():
            svc.step()
        tracer = pkg_obs.tracer()
        lanes = {tid: label for label, tid in tracer._lanes.items()}
        events = [(e["name"], e["ph"],
                   {k: v for k, v in (e.get("args") or {}).items()
                    if k != "key"})
                  for e in tracer.events()
                  if lanes.get(e["tid"]) == "SigSched"
                  or (e["ph"] == "C" and e["name"] == "scheduler")]
        snap = pkg_obs.metrics().snapshot()
    finally:
        pkg_obs.reset()
    metrics = {k: v for kind in ("counters", "histograms")
               for k, v in snap[kind].items() if k.startswith("sched.")}
    return events, metrics


def test_trace_and_metric_names_equal_reference():
    """Traced, the port's SigSched emits the reference's lane events and
    counter track in the same order with the same arguments, and the same
    ``sched.*`` counters and slack histogram."""
    from repro import obs as jobs
    from repro_torch import obs as tobs
    cfg = {"row_budget": 2, "starvation_ticks": 2}
    want = _traced_run(jobs, jserving.SignalService(
        batch_size=3, scheduler=dict(cfg)), jserving.SignalRequest, _jgraph)
    got = _traced_run(tobs, _svc(batch_size=3, scheduler=dict(cfg)),
                      SignalRequest, _tgraph)
    assert got[0] == want[0]
    assert {e[0] for e in got[0]} >= {"dispatch", "defer", "scheduler"}
    assert set(got[1]) == set(want[1]) >= {
        "sched.dispatches", "sched.wave_chunks", "sched.slack_cycles"}
    for k, v in want[1].items():
        if isinstance(v, dict):
            assert got[1][k]["count"] == v["count"], k
        else:
            assert got[1][k] == v, k


# -- Fig 9 with per-row params ---------------------------------------------

FIG9_LENGTH, FIG9_CH = 1024, (2, 4, 4, 1)
# rows 0 and 1 (graphs a and b) share a length: the mask CNN runs them as
# one call under torch.func.vmap; every other row runs alone
FIG9_LENS = [924, 924, 844, 764, 684, 604]


def _fig9_params(seed):
    """FIR taps and mask CNN (HWIO, the JAX layout) from one seed."""
    rng = np.random.default_rng(seed)
    taps = (rng.standard_normal(9) * 0.3).astype(np.float32)
    taps[0] = 1.0
    cnn = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
           .astype(np.float32)
           for ci, co in zip(FIG9_CH[:-1], FIG9_CH[1:])]
    return taps, cnn


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "speech_enhancement.py"
    spec = importlib.util.spec_from_file_location("_fig9_example_sched",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JSE = _jax_example()


def _fig9_jax_offline(i, x, seed):
    taps, cnn = _fig9_params(seed)
    c = _JSE.build_graph(FIG9_LENGTH, ch=FIG9_CH).compile(FIG9_LENS[i])
    params = dict(c.init_params())
    params["front"] = {"taps": jnp.asarray(taps)}
    params["mask"] = [jnp.asarray(w) for w in cnn]
    out = c(jnp.asarray(x[None]), params)
    return {k: np.asarray(v)[0] for k, v in out.items()}


@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_fig9_different_params_one_wave(backend):
    svc = _svc(batch_size=8, backend=backend)
    seeds = {"a": 0, "b": 1}
    for name, seed in seeds.items():
        taps, cnn = _fig9_params(seed)
        svc.register(name, tse.build_graph(FIG9_LENGTH, ch=FIG9_CH),
                     params={"front": {"taps": taps},
                             "mask": params_from_jax(cnn, device="cpu")})
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(t).astype(np.float32) for t in FIG9_LENS]
    res = svc.serve([SignalRequest(rid=i, graph="ab"[i % 2], samples=x)
                     for i, x in enumerate(xs)])
    assert svc.stats["batches"] == 1 and svc.stats["param_splits"] == 0
    assert svc.scheduler.stats["cross_graph_batches"] == 1
    for i, x in enumerate(xs):
        want = _fig9_jax_offline(i, x, seeds["ab"[i % 2]])
        for k, (rtol, atol) in (("out", (0, 1e-5)),
                                ("mel_tap", (1e-4, 1e-4))):
            assert res[i][k].shape == want[k].shape
            np.testing.assert_allclose(res[i][k], want[k], rtol=rtol,
                                       atol=atol)


def test_fig9_per_row_launches_blocks_once_per_gemm(monkeypatch):
    """On the hopper backend the per-row wave calls ``shuffle_gemm_blocks``
    once for the FIR taps (one operand a row) and once for the mel
    (shared), as a one-graph wave does."""
    calls = []

    def rec(x, idx, pads, w, scale=None, spans=None):
        calls.append(tuple(w.shape))
        return shuffle_gemm_blocks(x, idx, pads, w, scale, spans)
    for mod in ("ops", "vjp"):
        monkeypatch.setattr(importlib.import_module(
            f"repro_torch.kernels.shuffle_gemm.{mod}"),
            "shuffle_gemm_blocks", rec)
    svc = _svc(batch_size=8, backend="hopper")
    for name, seed in (("a", 0), ("b", 1)):
        taps, cnn = _fig9_params(seed)
        svc.register(name, tse.build_graph(FIG9_LENGTH, ch=FIG9_CH),
                     params={"front": {"taps": taps},
                             "mask": params_from_jax(cnn, device="cpu")})
    rng = np.random.default_rng(8)
    svc.serve([SignalRequest(rid=i, graph="ab"[i % 2],
                             samples=rng.standard_normal(FIG9_LENGTH - 50)
                             .astype(np.float32)) for i in range(4)])
    assert sorted(calls) == [(4, 9, 1), (129, 24)]


# -- every stage kind stacks a per-row wave, as the JAX package's vmap -----

def _stack_case(kind):
    """(graph builder taking a package, params a, params b, the port's
    service kwargs, the JAX package's) of a stage kind whose params a
    cross-graph wave stacks one a row."""
    rng = np.random.default_rng(3)
    if kind == "int_routed":
        def build(pkg):
            g = pkg.SignalGraph("q")
            g.fir("out", "input", taps=np.hanning(9) / np.hanning(9).sum())
            g.outputs("out")
            return g
        widths = {"out": (16, 8)}
        return (build, {"out": {"taps": rng.standard_normal(9)}},
                {"out": {"taps": rng.standard_normal(9)}},
                {"backend": HopperBackend(
                    precision=PrecisionPolicy(widths=widths))},
                {"backend": "pallas",
                 "precision": jsig.PrecisionPolicy(widths=widths)})
    if kind == "biquad":
        def build(pkg):
            g = pkg.SignalGraph("iir")
            g.iir_biquad("out", "input", b=[0.2, 0.3, 0.2],
                         a=[1.0, -0.5, 0.25])
            g.outputs("out")
            return g
        return (build, {"out": {"b": np.float32([0.2, 0.3, 0.2]),
                                "a": np.float32([1.0, -0.5, 0.25])}},
                {"out": {"b": np.float32([0.1, 0.3, 0.1]),
                         "a": np.float32([1.0, -0.4, 0.2])}}, {}, {})
    assert kind == "learnable_window"

    def build(pkg):
        g = pkg.SignalGraph("w")
        g.stft("spec", frame=FRAME, hop=HOP, window="learnable")
        g.istft("out", "spec", hop=HOP)
        g.outputs("out")
        return g
    return (build, {"spec": {"window": rng.random(FRAME)}},
            {"spec": {"window": rng.random(FRAME)}}, {}, {})


def _two_tenant_wave(build, pa, pb, kw, jkw, xs, out="out"):
    """One wave of ``xs`` alternating between registrations a (params
    ``pa``) and b (``pb``) of ``build``'s graph, served by the port and by
    the JAX package's ``SignalService``: ``(port results, port service,
    JAX results, JAX service)``, each result the ``out`` array."""
    svc = _svc(batch_size=8, **kw)
    js = jserving.SignalService(batch_size=8, **jkw)
    for name, p in (("a", pa), ("b", pb)):
        svc.register(name, build(tsig), params=p)
        js.register(name, build(jsig), params=jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float32), p))
    res = svc.serve([SignalRequest(rid=i, graph="ab"[i % 2], samples=x)
                     for i, x in enumerate(xs)])
    jres = js.serve([jserving.SignalRequest(rid=i, graph="ab"[i % 2],
                                            samples=x)
                     for i, x in enumerate(xs)])

    def pick(r):
        return np.asarray(r[out] if isinstance(r, dict) else r)
    return ({i: pick(r) for i, r in res.items()}, svc,
            {i: pick(r) for i, r in jres.items()}, js)


def _same_wave_stats(svc, js):
    """One cross-graph wave, one batch and no params split, in both
    packages alike."""
    assert svc.scheduler.stats["cross_graph_batches"] \
        == js.scheduler.stats["cross_graph_batches"] == 1
    for k in ("param_splits", "batches"):
        assert svc.stats[k] == js.stats[k], k
    assert svc.stats["param_splits"] == 0 and svc.stats["batches"] == 1


@pytest.mark.parametrize("kind", ["int_routed", "biquad",
                                  "learnable_window"])
def test_stage_kinds_stack_per_row_like_reference(kind):
    """A two-registration wave whose graphs registered different params
    of an int-routed FIR, a biquad or a learnable window runs as one
    per-row call, as the JAX package's ``vmap`` over stacked params
    does: the same ``stats``, every row the JAX package's row at rtol
    1e-5, atol 1e-6 — the int route's beyond that only by single
    activation-quantum flips (the two packages' float32 activations may
    land one rounding boundary apart), in under 1% of the outputs."""
    build, pa, pb, kw, jkw = _stack_case(kind)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
    res, svc, jres, js = _two_tenant_wave(build, pa, pb, kw, jkw, xs)
    _same_wave_stats(svc, js)
    for i, x in enumerate(xs):
        got, want = res[i], jres[i]
        assert got.shape == want.shape
        if kind != "int_routed":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            continue
        # one 16-bit activation quantum of the row times the largest tap
        taps = (pa if i % 2 == 0 else pb)["out"]["taps"]
        quantum = np.abs(x).max() / (2 ** 15 - 1) * np.abs(taps).max()
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL + 1.01 * quantum)
        off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
        assert off.mean() < 0.01


def _grouped_lowering(monkeypatch, steps):
    """Both packages' ``_lower_stage`` taught a stage kind ``grouped_tw``
    of ``steps`` grouped einsums (the FFT butterfly's shape: rows (G=3,
    nb=2), t 4, operand (3, 4, 4)) over a flat length-24 input, each with
    a learnable operand ``w<i>``: one step lowers to the grouped unit on
    ``hopper``, two to a chain.  No graph the repo builds has a learnable
    grouped operand; the JAX package's ``vmap`` stacks one all the
    same."""
    import repro.core.exec_ir as jir
    import repro.signal.graph as jgraph
    import repro_torch.core.exec_ir as tir
    import repro_torch.signal.graph as tgraph
    for mod, ir in ((jgraph, jir), (tgraph, tir)):
        def lower(st, in_types, fuse, width, _orig=mod._lower_stage, _ir=ir):
            if st.kind != "grouped_tw":
                return _orig(st, in_types, fuse, width)
            return None, [_ir.EinsumStep(
                f"{st.name}.bf{i}", "...gnt,gto->...gno",
                np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
                reshape_in=(3, 2, 4), out_rank=3, rows=6, cin=4, cout=4,
                param_key=f"w{i}") for i in range(steps)], in_types[0]
        monkeypatch.setattr(mod, "_lower_stage", lower)

    def build(pkg):
        g = pkg.SignalGraph("tw")
        g.add("grouped_tw", "bf", ["input"])
        g.outputs("bf")
        return g
    return build


@pytest.mark.parametrize("steps", [1, 2], ids=["grouped", "chain"])
@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_grouped_operand_wave_stacks_like_reference(backend, steps,
                                                    monkeypatch):
    """A grouped (butterfly-shaped) learnable operand, alone (the grouped
    unit) or two in a row (a chain unit on ``hopper``), registered
    differently by two graphs: one per-row wave with the JAX package's
    ``stats``, every row its row at rtol 1e-5, atol 1e-6."""
    build = _grouped_lowering(monkeypatch, steps)
    rng = np.random.default_rng(9)
    pa, pb = ({"bf": {f"w{i}": rng.standard_normal((3, 4, 4))
                      .astype(np.float32) for i in range(steps)}}
              for _ in range(2))
    xs = [rng.standard_normal(24).astype(np.float32) for _ in range(4)]
    res, svc, jres, js = _two_tenant_wave(build, pa, pb,
                                          {"backend": backend}, {}, xs,
                                          out="bf")
    _same_wave_stats(svc, js)
    for i in range(len(xs)):
        np.testing.assert_allclose(res[i], jres[i], rtol=RTOL, atol=ATOL)
    if backend == "hopper":
        chains = svc.compiled_for("a", 24)._exec.chain_report()
        assert len(chains) == (steps > 1)


@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_row_stackable_kinds(backend):
    """Row-uniform GEMMs (FIR taps, mel, a block-circulant layer) and a
    dnn hook take row-stacked params: a per-row call equals each row run
    alone with its own params."""
    g = tsig.SignalGraph("rows")
    g.fir("f", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.stft("spec", "f", frame=FRAME, hop=HOP)
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=6)
    g.dnn_circulant("dc", "mel", 8, block=2)
    g.dnn("m", "dc", fn=_twmask, init={"w": np.float32(1.0)})
    g.outputs("m")
    c = g.compile(256, backend=backend, device="cpu")
    rng = np.random.default_rng(6)
    base = c.init_params()
    rows = []
    for _ in range(3):
        p = {k: dict(v) if isinstance(v, dict) else v
             for k, v in base.items()}
        p["f"] = {"taps": rng.standard_normal(9).astype(np.float32)}
        p["mel"] = {"weights": rng.random(base["mel"]["weights"].shape)
                    .astype(np.float32)}
        p["dc"] = {"weights": rng.standard_normal(
            base["dc"]["weights"].shape).astype(np.float32)}
        p["m"] = {"w": np.float32(rng.random())}
        rows.append(p)
    x = torch.as_tensor(rng.standard_normal((3, 256)).astype(np.float32))
    from repro_torch.tree import tree_map
    stacked = tree_map(lambda *v: torch.stack([torch.as_tensor(u)
                                               for u in v]), *rows)
    with torch.no_grad():
        got = c.per_row(x, stacked)
        for i in range(3):
            torch.testing.assert_close(got["m"][i],
                                       c(x[i:i + 1], rows[i])["m"][0],
                                       rtol=RTOL, atol=ATOL)


def test_row_params_take_cuts_every_leaf():
    rp = RowParams({"a": torch.arange(6).reshape(3, 2),
                    "b": [torch.arange(3)]})
    sub = rp.take(torch.tensor([2, 0]))
    assert sub.tree["a"].tolist() == [[4, 5], [0, 1]]
    assert sub.tree["b"][0].tolist() == [2, 0]


# -- the per-row shuffle_gemm_blocks plain version -------------------------

@pytest.mark.parametrize("t,n_out,b", [(1, 1, 1), (9, 1, 4), (33, 24, 5),
                                       (129, 24, 3)])
def test_per_row_blocks_plain_equals_shared_calls(t, n_out, b):
    """The plain version's rank-3 ``w``: batch row b equals the shared-``w``
    call on ``w[b]`` and a numpy gather∘GEMM on that row."""
    rng = np.random.default_rng(t * 100 + n_out)
    rows, n_in = 17, 50
    idx = rng.integers(-1, n_in, (rows, t)).astype(np.int32)
    pads = rng.standard_normal((rows, t)).astype(np.float32)
    scale = rng.standard_normal((rows, t)).astype(np.float32)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    w = rng.standard_normal((b, t, n_out)).astype(np.float32)
    T = torch.as_tensor
    got = shuffle_gemm_blocks(T(x), T(idx), T(pads), T(w), T(scale))
    assert tuple(got.shape) == (b, rows, n_out)
    for i in range(b):
        one = ref_shuffle_gemm_blocks(T(x[i:i + 1]), T(idx), T(pads),
                                      T(w[i]), T(scale))[0]
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)
        g = np.where(idx < 0, pads, x[i][np.maximum(idx, 0)]) * scale
        np.testing.assert_allclose(got[i].numpy(), g @ w[i], rtol=1e-5,
                                   atol=1e-5)


def test_per_row_shuffle_gemm_op():
    """``shuffle_gemm`` with a (B, t, n_out) operand: each row against its
    own operand, through the plan's gather; on the CPU the plain version
    differentiates."""
    rng = np.random.default_rng(0)
    n = 40
    plan = ShufflePlan(gather_idx=np.arange(n, dtype=np.int32)
                       .reshape(10, 4)[:, ::-1].reshape(-1).copy(),
                       pad_values=np.zeros(n, np.float32), width=32)
    x = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((3, 4, 2)).astype(np.float32),
                        ).requires_grad_(True)
    y = shuffle_gemm(x, plan, w, rows=10)
    assert tuple(y.shape) == (3, 10, 2)
    for i in range(3):
        want = shuffle_gemm(x[i:i + 1], plan, w[i].detach(), rows=10)[0]
        torch.testing.assert_close(y[i].detach(), want)
    y.sum().backward()
    assert w.grad is not None and tuple(w.grad.shape) == (3, 4, 2)
    with pytest.raises(ValueError, match="per-row"):
        shuffle_gemm(x[:2], plan, w, rows=10)


_T = np.arange(3, dtype=np.float32)


@pytest.mark.parametrize("a,b", [
    ({"m": [_T]}, {"m": [_T.copy()]}),
    ({"m": [_T]}, {"m": [_T + 1]}),
    ({"m": {"w": np.float32(1.0)}}, {"m": {"w": np.float32(1.0)}}),
    ({"m": _T}, {"m": _T[:2]}),
    ({"m": np.float32([np.nan])}, {"m": np.float32([np.nan])}),
    ({"m": _T}, {"n": _T}),
    ({"m": _T}, {"m": _T.astype(np.float64)}),
    ({"m": [_T, _T]}, {"m": (_T, _T)}),
])
def test_params_equal_matches_reference(a, b):
    """The port's params equality (device leaves compared on the device,
    host leaves on the host) decides as the JAX package's does, for
    tensors on one device, host arrays and a mix."""
    from repro.serving.signal_service import _params_equal as jeq
    from repro_torch.serving.signal_service import _params_equal as teq
    from repro_torch.tree import tree_map
    want = jeq(a, b)
    as_t = tree_map(torch.as_tensor, b)
    assert teq(a, b) == teq(tree_map(torch.as_tensor, a), as_t) \
        == teq(a, as_t) == want
