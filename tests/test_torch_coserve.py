"""The PyTorch port's LLM serving and LLM + DSP co-scheduling against the
JAX package's.

The JAX package's own cases (``tests/test_signal_service.py``'s engine,
policy and co-scheduler cases, ``tests/test_signal_mesh_faults.py``'s
``DecodeWave`` snapshots, ``tests/test_serving_sharding.py``'s quantized
weights) run on the port (CPU, plain versions of the kernels), with the
tiny starcoder2-3b engine's weights from the JAX package's own
``bundle.init(PRNGKey(0))`` through ``model_params_from_jax``, and:

  * greedy tokens of ``generate``, ``serve`` and ``DecodeWave`` (stepped,
    admitted into, snapshotted and resumed) equal the JAX package's
    exactly; sampled decoding is held to its own determinism (the port
    draws from a ``torch.Generator``: the same distribution, another
    stream);
  * ``decode_step_cost`` equals the JAX package's integer for every
    dense config at batch 1, 4 and 8;
  * ``quantize_tree``, ``dequantize_tree`` and ``quantized_bytes`` equal
    the JAX package's bit for bit;
  * DSP results are held to the JAX package's OFFLINE
    ``graph.compile(t).jit()`` at rtol 1e-5, atol 1e-6 (its served
    results are not ground truth across JAX versions);
  * both packages' ``CoScheduler``s, fed one seeded script of LLM and DSP
    arrivals under each policy, make the same ``TickPlan`` every tick
    with the same running ``llm_cycles``, ``dsp_cycles`` and ``ticks``,
    and give the same tokens.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as js
from repro import signal as jsig
from repro.configs import get_config as jget_config
from repro.models.zoo import get_model as jget_model
from repro_torch import obs
from repro_torch import serving as ts
from repro_torch import signal as tsig
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import get_model

T = 512
RTOL, ATOL = 1e-5, 1e-6
POLICIES = ["round_robin", "latency_aware", "cost_balanced"]
DENSE = ["starcoder2-3b", "gemma2-2b", "chatglm3-6b", "minitron-8b",
         "internvl2-26b"]
TINY = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128)


# -- engines: one set of weights, both packages ------------------------------

_PARAMS = {}


def _jparams():
    if "j" not in _PARAMS:
        cfg = jget_config("starcoder2-3b").reduced(**TINY)
        _PARAMS["j"] = jget_model(cfg).init(jax.random.PRNGKey(0))
    return _PARAMS["j"]


def _engines(batch_size=2, temperature=0.0, quant_bits=0):
    """(port engine, JAX engine) on the same weights."""
    jeng = js.ServingEngine(
        jget_model(jget_config("starcoder2-3b").reduced(**TINY)),
        batch_size=batch_size, temperature=temperature,
        quant_bits=quant_bits)
    jeng.load(_jparams())
    teng = ts.ServingEngine(
        get_model(get_config("starcoder2-3b").reduced(**TINY)),
        batch_size=batch_size, temperature=temperature,
        quant_bits=quant_bits)
    teng.load(model_params_from_jax(_jparams(), "cpu"), device="cpu")
    return teng, jeng


def _reqs(pkg, spec):
    return [pkg.Request(rid=rid, prompt=list(p), max_new=n, deadline=dl)
            for rid, p, n, dl in spec]


# -- DSP graphs: the JAX package's test graph in both packages ---------------

def _graph(pkg, fn, natural=False):
    g = pkg.SignalGraph("fig9n" if natural else "fig9")
    g.stft("spec", frame=256, hop=128)
    g.dnn("mask", "spec", fn=fn)
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=128, **({} if natural else {"length": T}))
    g.outputs("out")
    return g


def _tgraph(natural=False):
    return _graph(tsig, lambda p, z: torch.sigmoid(torch.abs(z) - 1.0),
                  natural)


def _jgraph(natural=False):
    return _graph(jsig, lambda p, z: jax.nn.sigmoid(jnp.abs(z) - 1.0),
                  natural)


_OFFLINE = {}


def _hold(got, samples):
    """``got`` against the JAX package's offline compile at the exact
    length of ``samples``."""
    n = int(samples.shape[-1])
    if n not in _OFFLINE:
        _OFFLINE[n] = _jgraph(natural=True).compile(n).jit()
    want = np.asarray(_OFFLINE[n](jnp.asarray(samples), None)["out"])
    got = got["out"] if isinstance(got, dict) else got
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _tsvc(**kw):
    return ts.SignalService(device="cpu", **kw)


# -- the engine --------------------------------------------------------------

def test_generate_serve_and_wave_tokens_equal_reference():
    teng, jeng = _engines()
    prompts = [[1, 2, 3], [4, 5]]
    assert teng.generate(prompts, max_new=6) == jeng.generate(prompts,
                                                              max_new=6)
    spec = [(i, [i + 1, i + 2, i + 3][: 1 + i % 3], 2 + i, math.inf)
            for i in range(5)]
    assert teng.serve(_reqs(ts, spec)) == jeng.serve(_reqs(js, spec))
    tw, jw = ts.DecodeWave(teng, _reqs(ts, spec[:2])), \
        js.DecodeWave(jeng, _reqs(js, spec[:2]))
    assert tw.prefill_tokens == jw.prefill_tokens
    while not jw.done:
        assert tw.pop_done() == jw.pop_done()
        assert tw.free_slots() == jw.free_slots()
        tw.step()
        jw.step()
    assert tw.done and tw.results() == jw.results()


def test_wave_equals_generate_and_sampling_is_deterministic():
    teng, _ = _engines()
    reqs = _reqs(ts, [(0, [3, 1, 4], 5, math.inf), (1, [1, 5], 5, math.inf)])
    wave = ts.DecodeWave(teng, reqs)
    while not wave.done:
        wave.step()
    gen = teng.generate([r.prompt for r in reqs], max_new=5)
    assert wave.results() == {0: gen[0], 1: gen[1]}
    hot, _ = _engines(temperature=0.7)
    a = hot.generate([[1, 2, 3], [4, 5]], max_new=6)
    assert a == hot.generate([[1, 2, 3], [4, 5]], max_new=6)
    w = ts.DecodeWave(hot, _reqs(ts, [(0, [1, 2, 3], 6, math.inf),
                                      (1, [4, 5], 6, math.inf)]))
    while not w.done:
        w.step()
    assert w.results() == {0: a[0], 1: a[1]}
    assert all(0 <= t < hot.cfg.padded_vocab for o in a for t in o)


def test_decode_wave_midflight_admission_greedy_identical():
    """A newcomer admitted into a free slot mid-flight continues exactly
    like a solo run when padded prefix lengths align, and the wave gives
    the JAX package's tokens."""
    teng, jeng = _engines()
    out = {}
    for pkg, eng in ((ts, teng), (js, jeng)):
        wave = pkg.DecodeWave(eng, _reqs(pkg, [(0, [1, 2, 3], 2, math.inf),
                                               (1, [4, 5, 6], 6, math.inf)]))
        wave.step()
        wave.step()
        assert wave.free_slots() == 1
        finished = wave.admit(_reqs(pkg, [(2, [7, 8, 9, 10, 11], 3,
                                           math.inf)]))
        assert list(finished) == [0]
        while not wave.done:
            wave.step()
        out[pkg] = wave.results()
    res = out[ts]
    assert res == out[js]
    assert len(res[1]) == 6 and len(res[2]) == 3
    assert res[1] == teng.serve(_reqs(ts, [(1, [4, 5, 6], 6, math.inf)]))[1]
    assert res[2] == teng.serve(_reqs(ts, [(2, [7, 8, 9, 10, 11], 3,
                                            math.inf)]))[2]


def test_admission_and_snapshot_require_greedy():
    hot, _ = _engines(temperature=0.7)
    wave = ts.DecodeWave(hot, _reqs(ts, [(0, [1, 2], 2, math.inf)]))
    with pytest.raises(ValueError, match="greedy"):
        wave.admit(_reqs(ts, [(1, [3, 4], 2, math.inf)]))
    with pytest.raises(ValueError, match="greedy"):
        wave.snapshot()


def test_decode_wave_snapshot_resumes_identical_tokens():
    teng, jeng = _engines()
    spec = [(0, [1, 2, 3], 6, math.inf), (1, [4, 5], 6, 7.0)]
    ref = ts.DecodeWave(teng, _reqs(ts, spec))
    wave = ts.DecodeWave(teng, _reqs(ts, spec))
    jwave = js.DecodeWave(jeng, _reqs(js, spec))
    for _ in range(3):
        ref.step()
        wave.step()
        jwave.step()
    snap = wave.snapshot()
    assert snap == jwave.snapshot()
    resumed = ts.DecodeWave.from_snapshot(teng, snap)
    jresumed = js.DecodeWave.from_snapshot(jeng, jwave.snapshot())
    for w in (ref, resumed, jresumed):
        while not w.done:
            w.step()
    assert resumed.results() == ref.results() == jresumed.results()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_cost_equals_reference(arch):
    teng = ts.ServingEngine(get_model(get_config(arch)), batch_size=8)
    jeng = js.ServingEngine(jget_model(jget_config(arch)), batch_size=8)
    for b in (1, 4, None):
        assert teng.decode_step_cost(b) == jeng.decode_step_cost(b)
        assert isinstance(teng.decode_step_cost(b), int)
    assert 0 < teng.decode_step_cost(1) <= teng.decode_step_cost(4)


def test_request_slack():
    assert ts.Request(rid=0, prompt=[1], deadline=10.0).slack(4.0) == 6.0
    assert ts.Request(rid=0, prompt=[1]).slack(4.0) == math.inf


# -- storage quantization ----------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_tree_bit_for_bit(bits):
    tp = model_params_from_jax(_jparams(), "cpu")
    tq, tsc = ts.quantize_tree(tp, bits=bits, min_size=256)
    jq, jsc = js.quantize_tree(_jparams(), bits=bits, min_size=256)
    leaves = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jq):
        got, scale = tq, tsc
        for k in path:
            got, scale = got[k.key], scale[k.key]
        jscale = jsc
        for k in path:
            jscale = jscale[k.key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        assert np.array_equal(got.numpy(), np.asarray(want)), path
        assert (scale is None) == (jscale is None), path
        if scale is not None:
            assert np.array_equal(scale.numpy(), np.asarray(jscale)), path
        leaves += 1
    assert leaves == len(jax.tree_util.tree_leaves(jq))
    assert ts.quantized_bytes(tq, tsc, bits) \
        == js.quantized.quantized_bytes(jq, jsc, bits)
    tdq = ts.dequantize_tree(tq, tsc, dtype=torch.float32)
    jdq = js.dequantize_tree(jq, jsc, dtype=jnp.float32)
    for path, want in jax.tree_util.tree_leaves_with_path(jdq):
        got = tdq
        for k in path:
            got = got[k.key]
        assert np.array_equal(got.numpy(), np.asarray(want)), path


def test_quantized_engine_tokens_equal_reference():
    teng, jeng = _engines(batch_size=1, quant_bits=8)
    assert teng.params["embed"].dtype == torch.bfloat16
    assert teng.generate([[1, 2, 3]], max_new=4) \
        == jeng.generate([[1, 2, 3]], max_new=4)


# -- the co-scheduler --------------------------------------------------------

def test_coscheduler_interleaves_and_matches_standalone():
    teng, jeng = _engines()
    svc = _tsvc(batch_size=2)
    svc.register("fig9", _tgraph())
    assert svc.router is None
    sched = ts.CoScheduler(teng, svc)
    rng = np.random.default_rng(2)
    sigs = [rng.standard_normal(T).astype(np.float32) for _ in range(3)]
    spec = [(i, [i + 1, i + 2, i + 3], 4, math.inf) for i in range(3)]
    for i, s in enumerate(sigs):
        sched.submit_signal(ts.SignalRequest(rid=100 + i, graph="fig9",
                                             samples=s))
    for r in _reqs(ts, spec):
        sched.submit_llm(r)
    llm, dsp = sched.run()
    assert sorted(llm) == [0, 1, 2] and sorted(dsp) == [100, 101, 102]
    assert sched.ticks >= 4
    assert llm == teng.serve(_reqs(ts, spec)) == jeng.serve(_reqs(js, spec))
    for i, s in enumerate(sigs):
        _hold(dsp[100 + i], s)
    occ = sched.occupancy()
    assert "per_device" not in occ and occ["llm_cycles"] > 0


def test_latency_aware_serves_earliest_deadline_first():
    svc = _tsvc(batch_size=1)
    svc.register("fig9", _tgraph(natural=True))
    rng = np.random.default_rng(16)
    for i, dl in enumerate([5.0, 1.0, 3.0]):   # rid 1 most urgent
        svc.submit(ts.SignalRequest(
            rid=i, graph="fig9", deadline=dl,
            samples=rng.standard_normal(T).astype(np.float32)))
    pol = ts.get_policy("latency_aware")

    class _Sched:
        signals = svc

        def llm_pending(self):
            return False

        def llm_earliest_deadline(self):
            return math.inf

    done_order = []
    while svc.pending():
        plan = pol.plan(_Sched())
        done_order.extend(svc.step(pick=svc.make_pick(plan.dsp_key,
                                                      plan.dsp_order)))
    assert done_order == [1, 2, 0]


def test_cost_balanced_policy_validates_target():
    with pytest.raises(ValueError):
        ts.CostBalancedPolicy(dsp_target=1.5)
    assert ts.get_policy(ts.CostBalancedPolicy(0.3)).dsp_target == 0.3
    with pytest.raises(ValueError, match="unknown policy"):
        ts.get_policy("nope")
    assert [ts.get_policy(p).name for p in POLICIES] == POLICIES


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_complete_all_work(policy):
    teng, jeng = _engines()
    rng = np.random.default_rng(17)
    svc = _tsvc(batch_size=2)
    svc.register("fig9", _tgraph())
    sched = ts.CoScheduler(teng, svc, policy=policy)
    sigs = [rng.standard_normal(T).astype(np.float32) for _ in range(3)]
    spec = [(i, [i + 1, i + 2], 3, float(10 + i)) for i in range(3)]
    for i, s in enumerate(sigs):
        sched.submit_signal(ts.SignalRequest(
            rid=100 + i, graph="fig9", deadline=float(i), samples=s))
    for r in _reqs(ts, spec):
        sched.submit_llm(r)
    llm, dsp = sched.run()
    assert sorted(llm) == [0, 1, 2] and sorted(dsp) == [100, 101, 102]
    occ = sched.occupancy()
    assert occ["llm_cycles"] > 0 and occ["dsp_cycles"] > 0
    assert 0.0 < occ["dsp_share"] < 1.0
    assert llm == jeng.serve(_reqs(js, spec))
    for i, s in enumerate(sigs):
        _hold(dsp[100 + i], s)


def test_latency_aware_streams_ride_along_llm_ticks():
    teng, _ = _engines()
    svc = _tsvc(block_frames=2)
    svc.register("fig9", _tgraph(natural=True))
    sched = ts.CoScheduler(teng, svc, policy="latency_aware")
    rng = np.random.default_rng(18)
    sess = svc.open_stream("fig9")
    sess.feed(rng.standard_normal(T).astype(np.float32))
    for i in range(4):                         # urgent LLM traffic only
        sched.submit_llm(ts.Request(rid=i, prompt=[1, 2, 3], max_new=6,
                                    deadline=1.0))
    for _ in range(3):
        sched.tick()
    assert svc.stats["core_calls"] > 0         # streams advanced
    got = [sess.read(), sess.close()]
    assert sum(p["out"].shape[-1] for p in got) > 0


def test_latency_aware_llm_progresses_alongside_streams():
    teng, _ = _engines()
    svc = _tsvc(block_frames=2)
    svc.register("fig9", _tgraph(natural=True))
    sched = ts.CoScheduler(teng, svc, policy="latency_aware")
    rng = np.random.default_rng(20)
    sess = svc.open_stream("fig9")
    for i in range(2):
        sched.submit_llm(ts.Request(rid=i, prompt=[1, 2, 3], max_new=4))
    for _ in range(12):                        # keep the stream fed
        sess.feed(rng.standard_normal(256).astype(np.float32))
        sched.tick()
    assert sorted(sched.llm_results) == [0, 1]
    assert svc.stats["core_calls"] > 0
    sess.close()


def test_latency_aware_deadline_less_degrades_to_round_robin():
    teng, _ = _engines()
    svc = _tsvc(batch_size=1)
    svc.register("fig9", _tgraph(natural=True))
    sched = ts.CoScheduler(teng, svc, policy="latency_aware")
    rng = np.random.default_rng(21)
    sched.submit_llm(ts.Request(rid=0, prompt=[1, 2, 3], max_new=3))
    sigs = []
    for i in range(4):                         # steady deadline-less DSP
        sigs.append(rng.standard_normal(T).astype(np.float32))
        sched.submit_signal(ts.SignalRequest(rid=100 + i, graph="fig9",
                                             samples=sigs[-1]))
        sched.tick()
    assert 0 in sched.llm_results
    assert len(sched.dsp_results) >= 3
    for rid, got in sched.dsp_results.items():
        _hold(got, sigs[rid - 100])


def test_coscheduler_trace_spans_and_counters():
    teng, _ = _engines()
    svc = _tsvc(batch_size=2)
    svc.register("fig9", _tgraph())
    sched = ts.CoScheduler(teng, svc)
    sched.submit_llm(ts.Request(rid=0, prompt=[1, 2], max_new=2))
    sched.submit_signal(ts.SignalRequest(
        rid=100, graph="fig9",
        samples=np.random.default_rng(22).standard_normal(T).astype(
            np.float32)))
    obs.reset()
    obs.enable()
    try:
        sched.run()
        m = obs.metrics()
        assert m.counter("sched.ticks").value == sched.ticks
        assert m.counter("engine.prefills").value == 1
        assert m.counter("engine.decode_steps").value == 1
        names = {e.get("name") for e in obs.tracer().to_dict()[
            "traceEvents"]}
    finally:
        obs.disable()
        obs.reset()
    assert {"tick", "prefill", "decode_step", "occupancy",
            "dsp_share"} <= names


# -- decision parity: both packages' CoSchedulers on one seeded script -------

def _recording(sched):
    plans = []
    plan = sched.policy.plan

    def rec(s):
        p = plan(s)
        plans.append(dataclasses.asdict(p))
        return p
    sched.policy.plan = rec
    return plans


@pytest.mark.parametrize("policy", POLICIES)
def test_decision_parity_with_reference(policy):
    """One seeded script of LLM requests (prompt 2-6 tokens, 2-5 new,
    some with deadlines) and DSP requests (lengths 384 / 512, some with
    deadlines) arriving over the first 10 ticks, fed to both packages'
    CoSchedulers: the same plan, running cycle counts and tick count at
    every tick, the same tokens, and DSP results held to the JAX
    package's offline compile."""
    teng, jeng = _engines(batch_size=3)
    tsvc, jsvc = _tsvc(batch_size=2), js.SignalService(batch_size=2)
    tsvc.register("fig9", _tgraph(natural=True))
    jsvc.register("fig9", _jgraph(natural=True))
    tsched = ts.CoScheduler(teng, tsvc, policy=policy)
    jsched = js.CoScheduler(jeng, jsvc, policy=policy)
    tplans, jplans = _recording(tsched), _recording(jsched)
    rng = np.random.default_rng(23)
    sigs, rid = {}, 0
    for tick in range(40):
        if tick < 10:
            if rng.random() < 0.6:
                p = rng.integers(1, 100, int(rng.integers(2, 7))).tolist()
                n = int(rng.integers(2, 6))
                dl = float(rng.integers(1, 40)) if rng.random() < 0.5 \
                    else math.inf
                for pkg, s in ((ts, tsched), (js, jsched)):
                    s.submit_llm(pkg.Request(rid=rid, prompt=p, max_new=n,
                                             deadline=dl))
                rid += 1
            if rng.random() < 0.6:
                x = rng.standard_normal(int(rng.choice([384, 512]))).astype(
                    np.float32)
                dl = float(rng.integers(1, 40)) if rng.random() < 0.5 \
                    else math.inf
                sigs[1000 + rid] = x
                for pkg, s in ((ts, tsched), (js, jsched)):
                    s.submit_signal(pkg.SignalRequest(
                        rid=1000 + rid, graph="fig9", samples=x,
                        deadline=dl))
                rid += 1
        elif tsched.idle and jsched.idle:
            break
        tsched.tick()
        jsched.tick()
        assert tplans == jplans, tick
        assert (tsched.ticks, tsched.llm_cycles, tsched.dsp_cycles) == (
            jsched.ticks, jsched.llm_cycles, jsched.dsp_cycles), tick
        assert sorted(tsched.llm_results) == sorted(jsched.llm_results)
        assert sorted(tsched.dsp_results) == sorted(jsched.dsp_results)
    assert tsched.idle and jsched.idle and len(tplans) > 10
    assert tsched.llm_results == jsched.llm_results
    assert sorted(tsched.dsp_results) == sorted(sigs)
    assert tsched.occupancy() == jsched.occupancy()
    for r, got in tsched.dsp_results.items():
        _hold(got, sigs[r])
