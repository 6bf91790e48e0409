"""Streaming in the PyTorch port against the JAX package.

Every graph is built in both packages from the same numpy taps and
weights; the same seeded numpy chunks stream through the port's
``StreamingRunner`` (on the CPU) and the whole signal through the JAX
package's offline ``graph.compile(t)`` on its ``reference`` backend, as
the JAX package's own streaming tests run it.  The port's streamed
outputs are held to that offline result and to the port's own offline
compile at atol 1e-5 (frame taps such as the mel filterbank at rtol
1e-5, atol 1e-4: ``tests/test_sigprogram.py``'s limits for the tap).
They are not compared bit for bit with the JAX package's *streamed*
outputs: a FIR stage streams as a plain gather and einsum but runs on
the backend offline, and the CPU's batched matmuls round by row count.

Gradients through the runner are held to the offline gradients at rtol
1e-4, atol 1e-5 (``tests/test_signal_autodiff.py``,
``tests/test_pallas_vjp.py``), on ``reference`` and on ``hopper``, whose
shuffle-GEMM kernels run their plain versions under the hand-written
backward Functions here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import signal as jsig
from repro_torch import signal as tsig
from repro_torch.signal import StreamingRunner, StreamStructure
from repro_torch.signal.streaming import (restore_state, snapshot_state,
                                          stack_states, unstack_states)

FRAME, HOP = 256, 128
ATOL = 1e-5
TAP_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BACKENDS = ["reference", "hopper"]


def _conv_mask_jax(W):
    def fn(p, z):
        m = jnp.abs(z)[..., None]
        squeeze = m.ndim == 3
        if squeeze:
            m = m[None]
        y = jax.lax.conv_general_dilated(
            m, jnp.asarray(W), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if squeeze:
            y = y[0]
        return jax.nn.sigmoid(y[..., 0])
    return fn


def _conv_mask_torch(W):
    w = torch.as_tensor(np.ascontiguousarray(W.transpose(3, 2, 0, 1)))

    def fn(p, z):
        m = torch.abs(z)[..., None, :, :]
        squeeze = m.ndim == 3
        if squeeze:
            m = m[None]
        y = F.conv2d(m, w.to(m.device), padding=1)
        if squeeze:
            y = y[0]
        return torch.sigmoid(y[..., 0, :, :])
    return fn


# the two packages' spellings of what a graph builder needs
JAX = dict(sig=jsig, sigmoid=jax.nn.sigmoid, abs=jnp.abs,
           conv_mask=_conv_mask_jax)
TORCH = dict(sig=tsig, sigmoid=torch.sigmoid, abs=torch.abs,
             conv_mask=_conv_mask_torch)


# -- graphs of tests/test_signal_streaming.py, in either package -------------

def _g_iir(o, T):
    g = o["sig"].SignalGraph("iir")
    g.iir_biquad("q", "input", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.25])
    g.iir_biquad("q2", "q", b=[0.5, 0.1, 0.0], a=[1.0, 0.2, 0.1])
    g.outputs("q2")
    return g


def _g_fir(o, T):
    g = o["sig"].SignalGraph("fir")
    g.fir("f", "input",
          taps=np.random.default_rng(1).standard_normal(9).astype(
              np.float32))
    g.outputs("f")
    return g


def _g_core(o, T):
    g = o["sig"].SignalGraph("rt")
    g.stft("spec", frame=FRAME, hop=HOP)
    g.istft("out", "spec", hop=HOP, length=T)
    g.outputs("out")
    return g


def _g_fig9_conv(o, T):
    W = (np.random.default_rng(3).standard_normal((3, 3, 1, 1))
         * 0.2).astype(np.float32)
    g = o["sig"].SignalGraph("fig9")
    g.stft("spec", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec", fn=o["conv_mask"](W), frame_context=1)
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=T)
    g.outputs("out")
    return g


def _g_pre_post(o, T):
    g = o["sig"].SignalGraph("chain")
    g.fir("pre", "input", taps=(np.hanning(8) / 4).astype(np.float32))
    g.stft("spec", "pre", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec", fn=lambda p, z: o["sigmoid"](o["abs"](z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("mid", "enh", hop=HOP, length=T)
    g.iir_biquad("post", "mid", b=[0.3, 0.2, 0.1], a=[1.0, -0.4, 0.2])
    g.outputs("post")
    return g


def _g_fig9_tapped(o, T):
    g = o["sig"].SignalGraph("fig9_tapped")
    g.stft("spec", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec", fn=lambda p, z: o["sigmoid"](o["abs"](z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=T)
    g.magnitude("mag", "enh", onesided=True)
    g.mel_filterbank("mel_tap", "mag", sr=16_000, n_mels=8)
    g.outputs("out", "mel_tap")
    return g


def _g_chain_taps(o, T):
    g = o["sig"].SignalGraph("chain")
    g.fir("f1", "input", taps=[1.0, 0.5, 0.25])
    g.iir_biquad("q", "f1", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.25])
    g.outputs("q", "f1")
    return g


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stream(graph, x, splits, **kw):
    """Stream ``x`` through a port runner in the chunks ``splits`` cuts;
    returns the concatenated output per name (numpy)."""
    r = StreamingRunner(graph, device="cpu", **kw)
    acc = {}
    outs = [r.process(c) for c in np.split(x, splits, axis=-1)]
    outs.append(r.flush())
    for o in outs:
        o = o if isinstance(o, dict) else {None: o}
        for k, v in o.items():
            acc.setdefault(k, []).append(v.detach().numpy())
    struct = r.struct
    return {k: np.concatenate(v, axis=(x.ndim - 1 if k in
                                       struct.frame_outputs else -1))
            for k, v in acc.items()}


def _offline(o, build, T, x, **kw):
    """The graph's offline result in either package, as a numpy dict."""
    g = build(o, T)
    if o is JAX:
        out = g.compile(T)(jnp.asarray(x))
    else:
        out = g.compile(T, device="cpu", **kw)(torch.as_tensor(x))
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _check(got, want, tap=()):
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k in tap:
            np.testing.assert_allclose(got[k], w, **TAP_TOL)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL)


# cases: (graph, length, input shape, splits, runner kwargs)
CASES = {
    "iir_chain": (_g_iir, 2048, (2048,), [177, 900, 901], {}),
    "fir_chain": (_g_fir, 2048, (2048,), [300, 1100], {}),
    "stft_istft_core": (_g_core, 4096, (4096,), [300, 512, 700, 2500],
                        dict(block_frames=4)),
    "fig9_conv_mask": (_g_fig9_conv, 4096, (2, 4096),
                       [300, 812, 1500, 3000], dict(block_frames=4)),
    "pre_post_stages": (_g_pre_post, 2048, (2048,), [333, 777, 1200], {}),
    "short_istft": (_g_core, 4096, (2, 4096), [700, 1500, 3000],
                    dict(block_frames=4)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_equals_offline(case, backend):
    build, T, shape, splits, kw = CASES[case]
    x = _x(shape, seed=len(case))
    if case == "short_istft":
        # istft(length < natural) caps the stream at every drain
        def build(o, _T, _b=build):
            return _b(o, 1000)
    got = _stream(build(TORCH, T), x, splits, backend=backend, **kw)
    for o in (JAX, TORCH):
        want = _offline(o, build, T, x)
        _check(got, want)
    if case == "short_istft":
        assert got["out"].shape == (2, 1000)


@pytest.mark.parametrize("fuse", [0, 1, 2])
def test_streamed_equals_offline_at_every_fuse_level(fuse):
    """The carried-state offsets live at stage boundaries, so every fusion
    level of the per-block core streams the offline result."""
    T = 4096
    x = _x(T, seed=7)
    got = _stream(_g_fig9_tapped(TORCH, T), x, [300, 812, 1500, 3000],
                  block_frames=4, fuse=fuse)
    want = _offline(JAX, _g_fig9_tapped, T, x)
    _check(got, want, tap=("mel_tap",))
    _check(got, _offline(TORCH, _g_fig9_tapped, T, x, fuse=fuse),
           tap=("mel_tap",))


@pytest.mark.parametrize("splits", [[100, 200, 400, 1000], [1024]])
def test_chunk_pattern_invariance(splits):
    """However the input is cut, the stream is the offline signal."""
    T = 2048
    x = _x(T, seed=5)
    got = _stream(_g_core(TORCH, T), x, splits)
    _check(got, _offline(JAX, _g_core, T, x))
    _check(got, _stream(_g_core(TORCH, T), x, [700]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_output_runner_matches_offline(backend):
    """Frame taps stream beside the deframed output (one core program);
    the latencies are the reference's."""
    T = 4096
    x = _x(T, seed=4)
    got = _stream(_g_fig9_tapped(TORCH, T), x, [300, 812, 1500, 3000],
                  block_frames=4, backend=backend)
    _check(got, _offline(JAX, _g_fig9_tapped, T, x), tap=("mel_tap",))
    lat = StreamStructure.analyze(_g_fig9_tapped(TORCH, T)).output_latencies()
    jlat = jsig.StreamStructure.analyze(
        _g_fig9_tapped(JAX, T)).output_latencies()
    assert lat == jlat
    assert lat["out"] == {"domain": "samples", "latency": FRAME - HOP}


def test_sample_chain_taps_stream_with_zero_latency():
    T = 1024
    x = _x(T, seed=7)
    r = StreamingRunner(_g_chain_taps(TORCH, T), device="cpu")
    acc = {}
    for c in np.split(x, [300, 700], axis=-1):
        outs = r.process(c)
        assert set(outs) == {"q", "f1"}      # both emit immediately
        for k, v in outs.items():
            acc.setdefault(k, []).append(v.numpy())
    want = _offline(JAX, _g_chain_taps, T, x)
    for k in ("q", "f1"):
        np.testing.assert_allclose(np.concatenate(acc[k], axis=-1), want[k],
                                   rtol=0, atol=ATOL)
    lat = r.struct.output_latencies()
    assert lat["q"]["latency"] == 0 and lat["f1"]["latency"] == 0


def test_sample_chain_flush_keeps_batch_rank():
    g = tsig.SignalGraph("fir")
    g.fir("f", "input", taps=[1.0, 0.5, 0.25])
    g.outputs("f")
    r = StreamingRunner(g, device="cpu")
    y = r.process(np.ones((2, 3, 64), np.float32))["f"]
    tail = r.flush()
    assert tail == {} and y.shape == (2, 3, 64)
    with pytest.warns(DeprecationWarning):
        g.output("f")
    r = StreamingRunner(g, device="cpu")
    y = r.process(torch.ones((2, 3, 64)))
    tail = r.flush()
    assert y.shape == (2, 3, 64) and tail.shape == (2, 3, 0)
    torch.cat([y, tail], dim=-1)             # no raise


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rejects_non_streamable(pkg):
    o, Runner = (JAX, jsig.StreamingRunner) if pkg == "jax" else \
        (TORCH, lambda g: StreamingRunner(g, device="cpu"))
    g = o["sig"].SignalGraph("bad")
    g.stft("s1", frame=64, hop=32)
    g.istft("o1", "s1", hop=32)
    g.stft("s2", "o1", frame=64, hop=32)     # two framers
    g.istft("o2", "s2", hop=32)
    g.outputs("o2")
    with pytest.raises(ValueError):
        Runner(g)
    g2 = o["sig"].SignalGraph("bad2")
    g2.dct("d", "input")                     # a global transform of samples
    g2.outputs("d")
    with pytest.raises(ValueError):
        Runner(g2)
    f = o["sig"].SignalGraph("mel")          # frames out, no istft
    f.stft("spec", frame=FRAME, hop=HOP)
    f.magnitude("mag", "spec", onesided=True)
    f.mel_filterbank("mel", "mag", sr=16_000, n_mels=8)
    f.outputs("mel")
    with pytest.raises(ValueError):
        Runner(f)


def _pre_core_graph():
    g = tsig.SignalGraph("rt")
    g.fir("pre", "input", taps=np.hanning(8) / 4)
    g.stft("spec", "pre", frame=FRAME, hop=HOP)
    g.istft("out", "spec", hop=HOP)
    g.outputs("out")
    return g


def test_states_stack_unstack_snapshot_restore():
    """Lock-stepped states stack across a new leading axis and come back
    apart; a snapshot is host numpy with the counters, detached, and
    restores to tensors equal to the live state; out-of-step states
    refuse to stack."""
    chunk = 256
    g = _pre_core_graph()
    runners = [StreamingRunner(g, block_frames=4, device="cpu")
               for _ in range(2)]
    waves = [_x(1024, seed=8 + i) for i in range(2)]
    for r, w in zip(runners, waves):
        r.process(w[:chunk])
        r.process(w[chunk:2 * chunk])
    states = [r.state for r in runners]
    stacked = stack_states(states)
    assert stacked.buf.shape[0] == 2 and stacked.tail.shape[0] == 2
    for s, live in zip(unstack_states(stacked, 2), states):
        assert (s.total, s.f_next, s.buf_start) == \
            (live.total, live.f_next, live.buf_start)
        assert torch.equal(s.buf, live.buf) and torch.equal(s.tail, live.tail)
        for a, b in zip(s.pre, live.pre):
            assert torch.equal(a, b)
    snap = snapshot_state(states[0])
    assert isinstance(snap.buf, np.ndarray) and snap.total == states[0].total
    back = restore_state(snap, device="cpu")
    assert torch.equal(back.buf, states[0].buf)
    assert all(torch.equal(a, b) for a, b in zip(back.pre, states[0].pre))
    snap.buf[...] = 0                        # an owned copy
    assert not torch.equal(back.buf, torch.zeros_like(back.buf))
    runners[0].process(waves[0][2 * chunk:3 * chunk])
    with pytest.raises(ValueError, match="lock-step"):
        stack_states([r.state for r in runners])


def test_snapshot_detaches_autograd_history():
    g = _pre_core_graph()
    taps = torch.tensor(np.hanning(8) / 4, dtype=torch.float32,
                        requires_grad=True)
    r = StreamingRunner(g, params={"pre": {"taps": taps}}, block_frames=2,
                        device="cpu")
    r.process(_x(700, seed=3))
    assert r.state.buf.requires_grad and r.state.tail.requires_grad
    back = restore_state(snapshot_state(r.state), device="cpu")
    assert not back.buf.requires_grad and not back.tail.requires_grad


@pytest.mark.parametrize("what", ["runner", "restore_state"])
def test_default_device_raises_without_a_card(what, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        if what == "runner":
            StreamingRunner(_pre_core_graph())
        else:
            restore_state(snapshot_state(
                StreamingRunner(_pre_core_graph(), device="cpu").state))


def test_shared_core_cache_keyed_by_device_and_backend():
    """Runners on one StreamStructure share compiled cores; the key holds
    n_frames, fuse, the backend's cache key and the device."""
    g = _g_core(TORCH, None)
    struct = StreamStructure.analyze(g)
    r1 = StreamingRunner(g, block_frames=4, struct=struct, device="cpu")
    r2 = StreamingRunner(g, block_frames=4, struct=struct, device="cpu")
    w = _x(1024, seed=9)
    r1.process(w)
    n = len(struct._core_cache)
    r2.process(w)
    assert r1.struct is r2.struct and len(struct._core_cache) == n >= 1
    assert all(k[3] == torch.device("cpu") and k[2] == ("reference",)
               for k in struct._core_cache)
    StreamingRunner(g, block_frames=4, struct=struct, backend="hopper",
                    device="cpu").process(w)
    assert len(struct._core_cache) == 2 * n
    a = struct.core_graph(4, 2, "reference", "cpu")
    assert struct.core_graph(4, 2, "reference", "cpu") is a
    assert struct.core_graph(4, 2, "hopper", "cpu") is not a
    assert a.device == torch.device("cpu")


def test_deadline_hint_streams_an_early_framer_tap():
    def build(o):
        g = o["sig"].SignalGraph("dl")
        g.stft("spec", frame=FRAME, hop=HOP)
        g.dnn("mask", "spec",
              fn=lambda p, z: o["sigmoid"](o["abs"](z) - 1.0))
        g.mul("enh", "spec", "mask")
        g.istft("out", "enh", hop=HOP)
        g.outputs("out", deadline=5e-3)
        return g
    s = StreamStructure.analyze(build(TORCH))
    assert s.early_taps == ["spec"] and "spec" in s.frame_outputs
    assert s.output_latencies() == \
        jsig.StreamStructure.analyze(build(JAX)).output_latencies()
    got = StreamingRunner(build(TORCH), device="cpu").process(
        _x(4 * FRAME, seed=11))
    assert tuple(got["spec"].shape) == (1 + 3 * FRAME // HOP, FRAME)
    assert got["out"].shape[-1] < 4 * FRAME


# --------------------------------------------------------------------------
# Gradients through the runner
# --------------------------------------------------------------------------

def _g_stream_grad(o, T):
    """tests/test_signal_autodiff.py's streamed-gradient graph."""
    g = o["sig"].SignalGraph("stream_grad")
    g.fir("front", "input", taps=(np.hanning(8) / 4).astype(np.float32))
    g.stft("spec", "front", frame=FRAME, hop=HOP)
    g.dnn("mask", "spec",
          fn=lambda p, z: o["sigmoid"](o["abs"](z) * p - 1.0),
          init=np.float32(1.1))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=T)
    g.outputs("out")
    return g


def _g_vjp_fir(o, T):
    g = o["sig"].SignalGraph("fir")
    g.fir("f", "input",
          taps=np.random.default_rng(1).standard_normal(9) * 0.3)
    g.outputs("f")
    return g


def _g_vjp_window(o, T):
    g = o["sig"].SignalGraph("win_stream")
    g.stft("spec", "input", frame=64, hop=32, window="learnable")
    g.istft("out", "spec", hop=32, length=T)
    g.outputs("out")
    return g


def _g_vjp_fig9(o, T):
    """tests/test_pallas_vjp.py's full Fig-9 shape: learnable front,
    window, mel (a frame tap) and a mask over the mel."""
    rng = np.random.default_rng(4)
    front = rng.standard_normal(7) * 0.2
    w = np.asarray(rng.standard_normal((12, 64)) * 0.1, np.float32)
    g = o["sig"].SignalGraph("fig9")
    g.fir("front", "input", taps=front)
    g.stft("spec", "front", frame=64, hop=32, window="learnable")
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=12)
    if o is JAX:
        g.dnn("mask", "mel", fn=lambda p, m: jax.nn.sigmoid(m @ p["w"]),
              init={"w": w})
    else:
        g.dnn("mask", "mel", fn=lambda p, m: torch.sigmoid(m @ p["w"]),
              init={"w": w})
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=32, length=T)
    g.outputs("out", "mel")
    return g


GRAD_CASES = {
    "fir_front_mask": (_g_stream_grad, 1024, [300, 700], 4),
    "fir_taps": (_g_vjp_fir, 768, [256, 512], 4),
    "stft_window": (_g_vjp_window, 768, [256, 512], 4),
    "fig9_full": (_g_vjp_fig9, 768, [256, 512], 4),
}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                       else tree, np.float32).ravel()]




@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_through_runner_matches_offline(case, backend):
    """d loss / d params of the concatenated streamed outputs (mean of
    squares over every output's values) equals the JAX package's offline
    gradient and the port's own."""
    build, T, splits, bf = GRAD_CASES[case]
    x = _x(T, seed=21)
    jc = build(JAX, T).compile(T)
    jparams = jc.init_params()

    def off_loss(p):
        outs = jc(jnp.asarray(x), p)
        n = sum(v.size for v in outs.values())
        return sum(jnp.sum(jnp.abs(v) ** 2) for v in outs.values()) / n

    jl, jg = jax.value_and_grad(off_loss)(jparams)
    g = build(TORCH, T)
    tc = g.compile(T, backend=backend, device="cpu")
    leaves0 = tc.init_params()

    def leaf(v):
        return torch.tensor(np.asarray(v, np.float32), requires_grad=True)
    params = {k: ({f: leaf(a) for f, a in v.items()}
                  if isinstance(v, dict) else leaf(v))
              for k, v in leaves0.items()}
    flat = [t for k in sorted(params) for t in
            ([params[k][f] for f in sorted(params[k])]
             if isinstance(params[k], dict) else [params[k]])]
    r = StreamingRunner(g, params=params, block_frames=bf, backend=backend,
                        device="cpu")
    outs = [r.process(c) for c in np.split(x, splits)] + [r.flush()]
    vals = [v for o in outs for v in o.values() if v.numel()]
    loss = sum(torch.sum(torch.abs(v) ** 2) for v in vals) / \
        sum(v.numel() for v in vals)
    grads = torch.autograd.grad(loss, flat)
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jl), **GRAD_TOL)
    for got, want in zip([gr.numpy().ravel() for gr in grads],
                         _leaves(jg)):
        np.testing.assert_allclose(got, want, **GRAD_TOL)
    # the port's offline gradient too
    tl, tg = tc.value_and_grad(
        lambda o: sum(torch.sum(torch.abs(v) ** 2) for v in o.values())
        / sum(v.numel() for v in o.values()))(leaves0, x)
    np.testing.assert_allclose(float(loss), float(tl), **GRAD_TOL)
    for got, want in zip([gr.numpy().ravel() for gr in grads],
                         _leaves(tg)):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


# --------------------------------------------------------------------------
# Random streamable graphs: hopper against reference, offline and streamed
# --------------------------------------------------------------------------

def _g_random(o, T, seed):
    rng = np.random.default_rng(seed)
    g = o["sig"].SignalGraph("rand")
    src = "input"
    if rng.integers(2):
        g.fir("front", "input", taps=rng.standard_normal(
            int(rng.integers(1, 10))))
        src = "front"
    g.stft("spec", src, frame=64, hop=32)
    g.dnn("mask", "spec", fn=lambda p, z: o["sigmoid"](o["abs"](z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=32, length=T)
    g.magnitude("mag", "enh", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=12)
    g.outputs("out", "mel")
    return g


@pytest.mark.parametrize("seed", range(4))
def test_random_streamable_graphs_hopper_vs_reference(seed):
    """tests/test_exec_backends.py's random streamable pipelines: the
    port's hopper runner against the JAX package's reference offline
    compile, and against the port's reference runner."""
    rng = np.random.default_rng(100 + seed)
    T = int(rng.choice([384, 512, 640]))
    x = _x(T, seed=seed + 1)
    cuts = sorted({int(c) for c in rng.integers(1, T - 1, size=2)})
    got = _stream(_g_random(TORCH, T, seed), x, cuts, block_frames=4,
                  backend="hopper")
    want = _offline(JAX, lambda o, t: _g_random(o, t, seed), T, x)
    _check(got, want, tap=("mel",))
    ref = _stream(_g_random(TORCH, T, seed), x, cuts, block_frames=4)
    _check(got, ref, tap=("mel",))
