"""SigQuant in the PyTorch port against the JAX package: calibration, the
width solver, the int-routed ``hopper`` backend and calibrated serving.

The graph is the JAX package's Fig-9q test graph
(``tests/test_precision_calibration.py`` ``_fig9q(length, mel=True)``)
at its size: length 512, frame 64, hop 32, 12 mels, the mask a
block-circulant layer.  Both packages calibrate it on the same six
seeded batches (the last three held out) at a 1e-2 budget:

* the records agree step by step (names, ``k``, ``rows``, ``reaches``,
  flags, batch counts) with every range statistic at rtol 1e-5, and the
  local fake-quant errors at rtol 1e-5, atol 1e-6 (the single-quantum
  rounding flips described next move a 16-bit error by about 1e-7);
* the solvers return the same policy;
* the int-routed forwards agree: ``out`` at atol 1e-5; ``mel`` at rtol
  1e-4, atol 1e-5, because a rounding flip is expected there — the two
  packages' float32 activations differ in the last bits upstream of the
  quantizer, so an activation lying on a rounding boundary lands one
  quantum apart.  The integer operands handed to the bitserial GEMM are
  therefore also compared: equal except for single-quantum flips in
  well under 1% of the entries;
* the lowering reports are equal field by field;
* served results equal the port's own int-routed offline compile at each
  request's true length (atol 1e-5).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jkernels
from repro.core import bitwidth as jbw
from repro import precision as jpz
from repro import signal as jsig
from repro.signal import PallasBackend
from repro_torch import kernels as tkernels
from repro_torch import precision as tpz
from repro_torch import signal as tsig
from repro_torch.core import bitwidth as tbw
from repro_torch.serving import SignalRequest, SignalService
from repro_torch.signal import HopperBackend, PrecisionPolicy

FRAME, HOP, LEN, BUDGET = 64, 32, 512, 1e-2
ACT = {"jax": lambda v: jax.nn.sigmoid(v - 1.0),
       "torch": lambda v: torch.sigmoid(v - 1.0)}


def _fig9q(pkg, length):
    """The JAX package's Fig-9q test graph, built in ``pkg``."""
    g = pkg.SignalGraph("fig9q")
    g.fir("front", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.stft("spec", "front", frame=FRAME, hop=HOP)
    g.magnitude("mag", "spec", onesided=False)
    g.dnn_circulant("mask", "mag", FRAME, block=4,
                    activation=ACT["jax" if pkg is jsig else "torch"])
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=length)
    g.magnitude("m2", "enh", onesided=True)
    g.mel_filterbank("mel", "m2", sr=16_000, n_mels=12)
    g.outputs("out", "mel")
    return g


def _batches(n, length, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, length)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def cal():
    """One calibration per package on the same batches (module-scoped:
    the JAX solver evaluates its candidates through interpret-mode
    Pallas)."""
    batches = _batches(6, LEN)
    jc = _fig9q(jsig, LEN).compile(LEN, backend="pallas")
    jpol, jrec = jpz.auto_policy(jc, batches, budget=BUDGET)
    tc = _fig9q(tsig, LEN).compile(LEN, backend="hopper", device="cpu")
    tpol, trec = tpz.auto_policy(tc, batches, budget=BUDGET)
    return types.SimpleNamespace(jc=jc, jpol=jpol, jrec=jrec, tc=tc,
                                 tpol=tpol, trec=trec)


# -- calibration ---------------------------------------------------------------

def test_calibration_records_match_reference(cal):
    jrec, trec = cal.jrec, cal.trec
    assert list(trec.steps) == list(jrec.steps)
    assert trec.gemm_steps() == jrec.gemm_steps() == \
        ["front.taps", "mask.gemm", "mel.mel"]
    for name, js in jrec.steps.items():
        ts = trec.steps[name]
        for f in ("stage", "k", "rows", "grouped", "is_complex", "reaches",
                  "batches"):
            assert getattr(ts, f) == getattr(js, f), (name, f)
        for f in ("a_max", "w_max", "h_l1", "w_l1", "acc_norm"):
            np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                       rtol=1e-5, err_msg=f"{name}.{f}")
        assert set(ts.local_err) == set(js.local_err), name
        for pair, err in js.local_err.items():
            np.testing.assert_allclose(ts.local_err[pair], err, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {pair}")
    for tb, jb in zip(trec.baselines, jrec.baselines):
        for k in jb:
            np.testing.assert_allclose(tb[k], np.asarray(jb[k]), rtol=1e-4,
                                       atol=1e-5)


def test_observer_is_bit_transparent(cal):
    """The observer returns the reference backend's result bit for bit:
    calibration never perturbs the traffic it measures."""
    x = _batches(1, LEN, seed=5)[0]
    rec = tpz.calibrate(cal.tc, [x], holdout=[x])
    with torch.no_grad():
        ref = cal.tc.with_backend("reference")(x)
        seen = cal.tc.with_backend(
            tpz.calibration._ObserverBackend(rec, tpz.LADDER))(x)
    for k in ref:
        torch.testing.assert_close(seen[k], ref[k], rtol=0, atol=0)


def test_calibrate_validates_batches(cal):
    with pytest.raises(ValueError, match="at least one batch"):
        tpz.calibrate(cal.tc, [])


# -- the width solver ----------------------------------------------------------

def test_solver_matches_reference(cal):
    assert dict(cal.tpol.widths) == dict(cal.jpol.widths)
    assert cal.tpol.default is cal.jpol.default is None
    assert set(cal.tpol.widths) == set(cal.trec.gemm_steps())
    assert all(w in tpz.LADDER for w in cal.tpol.widths.values())
    cal.trec.assert_no_overflow(cal.tpol)
    assert tpz.solve_widths(cal.trec, budget=BUDGET) == cal.tpol
    errs = tpz.policy_errors(cal.trec, cal.tpol)
    assert set(errs) == {"out", "mel"} and max(errs.values()) <= BUDGET
    jerrs = jpz.policy_errors(cal.jrec, cal.jpol)
    for k, e in jerrs.items():
        np.testing.assert_allclose(errs[k], e, rtol=1e-4)


def test_solver_unmeetable_budget_raises(cal):
    with pytest.raises(ValueError, match="cannot meet"):
        tpz.solve_widths(cal.trec, budget=1e-9)


def test_overflow_guard_rejects_bad_policy(cal):
    st_ = cal.trec.steps["mask.gemm"]
    wide = tpz.StepStats(stage=st_.stage, step="fake.step", k=2 ** 26,
                         rows=st_.rows, grouped=False, reaches=st_.reaches)
    wide.h_l1 = wide.w_l1 = wide.acc_norm = float(2 ** 26)
    assert not wide.fits((4, 4)) and not wide.fits((16, 16))
    cal.trec.steps["fake.step"] = wide
    try:
        with pytest.raises(ValueError, match="overflow"):
            cal.trec.assert_no_overflow(
                PrecisionPolicy(widths={"fake.step": (16, 16)}))
    finally:
        del cal.trec.steps["fake.step"]


# -- the int route -------------------------------------------------------------

def _recorder(fn, sink, to_np):
    def rec(a, w, aw, ww, **kw):
        sink.append((to_np(a), to_np(w)))
        return fn(a, w, aw, ww, **kw)
    return rec


def _quant_recorder(fn, sink):
    """Records the integer operands the port's one-launch int route
    quantizes its float operands to (its plain version's quantize)."""
    def rec(h, w, aw, ww):
        sink.append((tbw.quantize(h, aw, axis=-1)[0].numpy(),
                     tbw.quantize(w, ww, axis=0)[0].numpy()))
        return fn(h, w, aw, ww)
    return rec


def test_int_routed_forward_matches_reference(cal, monkeypatch):
    x = _batches(1, LEN, seed=9)[0]
    ja, ta = [], []
    monkeypatch.setattr(jkernels, "bitserial_matmul", _recorder(
        jkernels.bitserial_matmul, ja, np.asarray))
    monkeypatch.setattr(tkernels, "bitserial_quant_matmul", _quant_recorder(
        tkernels.bitserial_quant_matmul, ta))
    try:
        # lowered units bind the kernel wrapper when built: rebuild them
        jsig.clear_plan_caches()
        tsig.clear_plan_caches()
        want = cal.jc.with_backend(PallasBackend(precision=cal.jpol))(
            jnp.asarray(x))
        with torch.no_grad():
            got = cal.tc.with_backend(HopperBackend(precision=cal.jpol))(x)
    finally:
        jsig.clear_plan_caches()
        tsig.clear_plan_caches()
    assert list(got) == list(want) == ["out", "mel"]
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               rtol=1e-4, atol=1e-5)
    assert len(ja) == len(ta) == 3
    for (jq, jw), (tq, tw) in zip(ja, ta):
        np.testing.assert_array_equal(tw, jw)
        flips = np.abs(tq.astype(np.int64) - jq)
        assert flips.max() <= 1 and (flips > 0).mean() < 0.01


def test_lowering_report_matches_reference(cal):
    jr = cal.jc.with_backend(PallasBackend(precision=cal.jpol)) \
        .lowering_report()
    tr = cal.tc.with_backend(HopperBackend(precision=cal.jpol)) \
        .lowering_report()
    assert (jr.pop("name"), tr.pop("name")) == ("pallas", "hopper")
    assert tr == jr
    assert tr["array_passes"]["int_routed"] == len(cal.jpol.widths) == 3


def test_int_route_refuses_gradients(cal):
    """The int route takes the straight-through estimator, so the
    input's gradient is finite and informative (rounding's own is zero
    almost everywhere).  The name dates from when the route refused
    gradients; it is kept so the test's record stays continuous."""
    c = cal.tc.with_backend(HopperBackend(precision=cal.tpol))
    x = torch.as_tensor(_batches(1, LEN)[0]).requires_grad_()
    out = c(x)
    sum(v.square().mean() for v in out.values()).backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0


def test_policy_keys_the_backend_cache(cal):
    assert HopperBackend(precision=cal.tpol).cache_key != \
        HopperBackend().cache_key
    svc = SignalService(backend="hopper", precision=cal.tpol, device="cpu")
    assert svc.backend.cache_key == HopperBackend(
        precision=cal.tpol).cache_key


# -- calibrated serving --------------------------------------------------------

def test_served_equals_int_routed_offline(cal):
    lens = [LEN - 40 * i for i in range(5)]          # one bucket: 512
    xs = [x[0] for x in _batches(len(lens), LEN, batch=1, seed=21)]
    xs = [x[:t] for x, t in zip(xs, lens)]
    g = _fig9q(tsig, None)
    svc = SignalService(batch_size=4, backend="hopper", precision=cal.tpol,
                        device="cpu")
    svc.register("fig9q", g)
    res = svc.serve([SignalRequest(rid=i, graph="fig9q", samples=x)
                     for i, x in enumerate(xs)])
    assert sorted(res) == list(range(len(lens)))
    assert svc.stats["compiles"] == 1 and svc.stats["bucketed"] == 2
    backend = HopperBackend(precision=cal.tpol)
    with torch.no_grad():
        for i, t in enumerate(lens):
            off = g.compile(t, backend=backend, device="cpu")(xs[i][None])
            assert set(res[i]) == {"out", "mel"}
            for k in ("out", "mel"):
                assert res[i][k].shape == tuple(off[k][0].shape)
                np.testing.assert_allclose(res[i][k], off[k][0].numpy(),
                                           rtol=0, atol=1e-5)


def test_precision_needs_the_hopper_backend(cal):
    with pytest.raises(ValueError, match="hopper"):
        SignalService(precision=cal.tpol, device="cpu")


def test_per_row_int_wave_matches_reference(cal, monkeypatch):
    """Two registrations of Fig-9q with different FIR taps and mask
    weights under the solved policy: one per-row wave in both packages
    (``stats`` equal: one batch, no params split), each int-routed step
    one call with one operand a row.  The int route is held as the
    int-routed forward above holds it: the integer operands the wave
    quantizes each row to equal the JAX package's for that row and its
    registration's params (its offline int-routed forward, recorded
    outside ``vmap``) — the weights exactly, the activations but for
    single-quantum flips in well under 1% of the entries — and each
    row's outputs equal the port's own offline int-routed compile with
    that row's params (atol 1e-5)."""
    from repro import serving as jserving
    rng = np.random.default_rng(31)
    base = cal.tc.init_params()
    regs = []
    for _ in range(2):
        p = {k: dict(v) if isinstance(v, dict) else v
             for k, v in base.items()}
        # weights about the layer's own init, the scale the policy was
        # calibrated at; each tenant's its own
        bw = np.asarray(base["mask"]["weights"], np.float32)
        p["front"] = {"taps": (0.3 * rng.standard_normal(9))
                      .astype(np.float32)}
        p["mask"] = {"weights": (bw + 0.5 * bw.std() * rng.standard_normal(
            bw.shape)).astype(np.float32)}
        regs.append({k: {kk: np.asarray(vv, np.float32)
                         for kk, vv in v.items()} for k, v in p.items()})
    xs = [x[0] for x in _batches(4, LEN, batch=1, seed=33)]
    svc = SignalService(batch_size=8, backend="hopper", precision=cal.tpol,
                        device="cpu")
    js = jserving.SignalService(batch_size=8, backend="pallas",
                                precision=cal.jpol)
    for name, p in zip("ab", regs):
        svc.register(name, _fig9q(tsig, None), params=p)
        js.register(name, _fig9q(jsig, None),
                    params=jax.tree_util.tree_map(jnp.asarray, p))
    ta = []

    def rec(h, w, aw, ww):
        # per row: the rows (B, ..., K) and w (B, K, N) quantized as the
        # plain version quantizes them
        hq = tbw.quantize(h.reshape(h.shape[0], -1, h.shape[-1]), aw,
                          axis=-1)[0]
        ta.append((hq.numpy(), tbw.quantize(w, ww, axis=-2)[0].numpy()))
        return orig(h, w, aw, ww)
    orig = tkernels.bitserial_quant_matmul
    monkeypatch.setattr(tkernels, "bitserial_quant_matmul", rec)
    tsig.clear_plan_caches()
    try:
        res = svc.serve([SignalRequest(rid=i, graph="ab"[i % 2], samples=x)
                         for i, x in enumerate(xs)])
    finally:
        monkeypatch.undo()
        tsig.clear_plan_caches()
    jres = js.serve([jserving.SignalRequest(rid=i, graph="ab"[i % 2],
                                            samples=x)
                     for i, x in enumerate(xs)])
    assert sorted(res) == sorted(jres) == list(range(len(xs)))
    for k in ("param_splits", "batches"):
        assert svc.stats[k] == js.stats[k]
    assert svc.stats["param_splits"] == 0 and svc.stats["batches"] == 1
    assert svc.scheduler.stats["cross_graph_batches"] \
        == js.scheduler.stats["cross_graph_batches"] == 1
    assert len(ta) == len(cal.tpol.widths)
    assert all(tw.shape[0] == len(xs) for _, tw in ta)
    tq = _fig9q(tsig, None).compile(
        LEN, backend=HopperBackend(precision=cal.tpol), device="cpu")
    for i, x in enumerate(xs):
        p = regs[i % 2]
        ja = []
        monkeypatch.setattr(jkernels, "bitserial_matmul", _recorder(
            jkernels.bitserial_matmul, ja, np.asarray))
        jsig.clear_plan_caches()
        try:
            # lowered units bind the kernel wrapper when built: bind here
            _fig9q(jsig, None).compile(LEN, backend=PallasBackend(
                precision=cal.jpol))(jnp.asarray(x[None]),
                                     jax.tree_util.tree_map(jnp.asarray, p))
        finally:
            monkeypatch.undo()
            jsig.clear_plan_caches()
        assert len(ja) == len(ta)
        for (jh, jw), (th, tw) in zip(ja, ta):
            np.testing.assert_array_equal(tw[i], jw)
            flips = np.abs(th[i].astype(np.int64)
                           - jh.reshape(th[i].shape))
            assert flips.max() <= 1 and (flips > 0).mean() < 0.01
        with torch.no_grad():
            off = tq(torch.as_tensor(x[None]), p)
        for k in ("out", "mel"):
            assert res[i][k].shape == np.asarray(jres[i][k]).shape
            np.testing.assert_allclose(res[i][k], off[k][0].numpy(),
                                       rtol=0, atol=1e-5)
