"""Streaming sessions and their durability in the PyTorch port's
``SignalService``, against the JAX package.

Lock-stepped sessions over the Fig-9 SigProgram (learned FIR, STFT, mask
CNN, iSTFT, mel tap; narrow CNN) stack their ready blocks into at most
one core call a tick; every session's concatenated ``read()`` /
``close()`` stream equals the JAX package's offline ``graph.compile(t)``
(``out`` at atol 1e-5, ``mel_tap`` at rtol 1e-5, atol 1e-4) and a
private ``StreamingRunner`` (at those limits when stacked, where the
CPU's batched matmuls round by batch; bit for bit for one session,
``tests/test_signal_service.py``'s contract).  Checkpoints
restore in place or in a fresh service from disk and resume bit for bit
with exactly-once delivery; the port's checkpointer writes the JAX
package's directory layout.  Calibrated streams stay within the SigQuant
budget.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch import obs
from repro_torch import precision as tpz
from repro_torch import signal as tsig
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.convert import params_from_jax
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SignalService
from repro_torch.signal import HopperBackend, StreamingRunner

T, CH, CHUNK = 1024, (2, 4, 4, 1), 256
BACKENDS = ["reference", "hopper"]


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "speech_enhancement.py"
    spec = importlib.util.spec_from_file_location("_fig9_example_stream",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JSE = _jax_example()


def _cnn(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
            .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]


def _waves(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(length).astype(np.float32)
            for _ in range(n)]


def _service(backend="reference", block_frames=4, **kw):
    svc = SignalService(block_frames=block_frames, backend=backend,
                        device="cpu", **kw)
    svc.register("se", tse.build_graph(T, ch=CH),
                 params={"mask": params_from_jax(_cnn(), device="cpu")})
    return svc


def _jax_offline(w):
    c = _JSE.build_graph(T, ch=CH).compile(T)
    params = dict(c.init_params())
    params["mask"] = [jnp.asarray(a) for a in _cnn()]
    return {k: np.asarray(v) for k, v in c(jnp.asarray(w), params).items()}


def _runner(backend="reference", block_frames=4):
    return StreamingRunner(
        tse.build_graph(T, ch=CH),
        params={"mask": params_from_jax(_cnn(), device="cpu")},
        block_frames=block_frames, backend=backend, device="cpu")


def _collect(acc, outs):
    for k, v in outs.items():
        acc.setdefault(k, []).append(np.asarray(v.detach() if isinstance(
            v, torch.Tensor) else v))


def _joined(acc):
    return {k: np.concatenate(v, axis=0 if k == "mel_tap" else -1)
            for k, v in acc.items()}


def _check(got, want, out_atol=1e-5):
    assert set(got) == set(want) == {"out", "mel_tap"}
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=out_atol)
    np.testing.assert_allclose(got["mel_tap"], want["mel_tap"], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lock_stepped_sessions_one_core_call_a_tick(backend):
    svc = _service(backend)
    waves = _waves(3, T, seed=14)
    sessions = [svc.open_stream("se") for _ in waves]
    accs = [{} for _ in waves]
    for lo in range(0, T, CHUNK):
        for s, w in zip(sessions, waves):
            s.feed(w[lo:lo + CHUNK])
        assert svc.stream_step() <= 1          # batched, not per-session
        for acc, s in zip(accs, sessions):
            _collect(acc, s.read())
    for acc, s in zip(accs, sessions):
        _collect(acc, s.close())
    assert svc.stream_sessions() == 0
    assert svc.stats["core_calls"] >= 1 and svc.stats["stream_ticks"] == 4
    assert svc.stats["flush_core_calls"] >= len(waves)
    assert svc.est_cycles == svc.wall_cycles > 0
    for acc, w in zip(accs, waves):
        got = _joined(acc)
        _check(got, _jax_offline(w))
        r = _runner(backend)
        ref = {}
        for lo in range(0, T, CHUNK):
            _collect(ref, r.process(w[lo:lo + CHUNK]))
        _collect(ref, r.flush())
        _check(got, _joined(ref))


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_session_equals_private_runner_bit_for_bit(backend):
    svc = _service(backend)
    (w,) = _waves(1, T, seed=15)
    sess = svc.open_stream("se")
    run = _runner(backend)
    got, ref = {}, {}
    for lo, hi in ((0, 300), (300, 900), (900, T)):
        sess.feed(w[lo:hi])
        svc.stream_step()
        _collect(got, sess.read())
        _collect(ref, run.process(w[lo:hi]))
    _collect(got, sess.close())
    _collect(ref, run.flush())
    got, ref = _joined(got), _joined(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_open_stream_rejects_non_streamable():
    svc = SignalService(device="cpu")
    g = tsig.SignalGraph("dct")
    g.dct("d", "input")
    g.outputs("d")
    svc.register("dct", g)
    f = tsig.SignalGraph("mel")
    f.stft("spec", frame=64, hop=32)
    f.magnitude("mag", "spec", onesided=True)
    f.mel_filterbank("mel", "mag", sr=16_000, n_mels=8)
    f.outputs("mel")
    svc.register("mel", f)
    for name in ("dct", "mel"):
        with pytest.raises(ValueError, match="not streamable"):
            svc.open_stream(name)
    with pytest.raises(KeyError):
        svc.open_stream("nope")


def test_reregister_detaches_open_sessions():
    svc = _service(block_frames=2)
    sess = svc.open_stream("se")
    sess.feed(_waves(1, 700, seed=19)[0])
    g2 = tsig.SignalGraph("b")
    g2.stft("spec", frame=512, hop=256)      # another frame/hop
    g2.istft("out", "spec", hop=256)
    g2.outputs("out")
    svc.register("se", g2)
    assert sess.closed and sess.error is not None
    assert svc.stats["detached_sessions"] == 1
    with pytest.raises(ValueError, match="re-registered"):
        sess.feed(np.zeros(128, np.float32))
    assert svc.stream_step() == 0            # nothing to run, no crash
    sess2 = svc.open_stream("se")            # new sessions work
    sess2.feed(np.zeros(1024, np.float32))
    assert svc.stream_step() == 1
    assert set(sess2.close()) == {"out"}


def test_restore_detaches_sessions_opened_after_checkpoint():
    svc = _service()
    ck = svc.checkpoint()
    sess = svc.open_stream("se")
    svc.restore(ck)
    assert sess.closed and "checkpoint" in sess.error
    with pytest.raises(ValueError):
        sess.feed(np.zeros(256, np.float32))
    assert svc.stats["detached_sessions"] == 1
    assert svc.stream_sessions() == 0


def _uninterrupted(w, chunks):
    svc = _service()
    s = svc.open_stream("se")
    acc = {}
    for lo, hi in chunks:
        s.feed(w[lo:hi])
        svc.stream_step()
        _collect(acc, s.read())
    _collect(acc, s.close())
    return _joined(acc)


@pytest.mark.parametrize("read_past_checkpoint", [False, True])
def test_checkpoint_restore_exactly_once(read_past_checkpoint):
    """Restore rewinds the state; the client replays its feeds from the
    checkpoint on.  What it already read is never delivered again, and
    the whole delivered stream equals an uninterrupted one bit for
    bit."""
    (w,) = _waves(1, T, seed=7)
    chunks = [(lo, lo + 128) for lo in range(0, T, 128)]
    want = _uninterrupted(w, chunks)
    svc = _service()
    s = svc.open_stream("se")
    acc = {}
    for lo, hi in chunks[:4]:
        s.feed(w[lo:hi])
        svc.stream_step()
        _collect(acc, s.read())
    s.feed(w[512:640])
    svc.stream_step()                        # pending, unread output
    ck = svc.checkpoint()
    for lo, hi in chunks[5:7]:
        s.feed(w[lo:hi])
        svc.stream_step()
    if read_past_checkpoint:
        _collect(acc, s.read())
    svc.restore(ck)                          # the handle is restored in place
    assert svc.session_by_sid(s.sid) is s and not s.closed
    for lo, hi in chunks[5:]:
        s.feed(w[lo:hi])
        svc.stream_step()
        _collect(acc, s.read())
    _collect(acc, s.close())
    got = _joined(acc)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_save_checkpoint_survives_process_death(tmp_path):
    (w,) = _waves(1, 2 * T, seed=7)
    svc = _service()
    sess = svc.open_stream("se")
    sess.feed(w[:T])
    svc.stream_step()
    head = sess.read()
    step = svc.save_checkpoint(str(tmp_path / "ckpt"), blocking=True)
    assert (tmp_path / "ckpt" / f"step_{step:06d}" / "COMMIT").exists()
    svc2 = _service()                        # nothing survives but the disk
    assert svc2.restore_from_disk(str(tmp_path / "ckpt")) == step
    sess2 = svc2.session_by_sid(sess.sid)
    assert sess2 is not None and sess2 is not sess
    assert svc2.est_cycles == svc.est_cycles
    tails = []
    for s, sv in ((sess, svc), (sess2, svc2)):
        s.feed(w[T:])
        sv.stream_step()
        acc = {}
        _collect(acc, s.read())
        _collect(acc, s.close())
        tails.append(_joined(acc))
    for k in tails[0]:
        np.testing.assert_array_equal(tails[0][k], tails[1][k])
    assert sum(v.size for v in head.values()) + tails[0]["out"].size > 0


def test_save_checkpoint_keeps_last_n(tmp_path):
    svc = _service()
    for i in range(5):
        svc.save_checkpoint(str(tmp_path / "ckpt"), step=i, keep=2,
                            blocking=True)
    kept = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert kept == ["step_000003", "step_000004"]
    assert latest_step(str(tmp_path / "ckpt")) == 4
    assert svc.save_checkpoint(str(tmp_path / "ckpt"), keep=2) == 5


def test_restore_from_disk_requires_sidecar(tmp_path):
    Checkpointer(str(tmp_path / "c")).save(0, [np.zeros(3)], blocking=True)
    svc = _service()
    with pytest.raises(ValueError, match="sidecar"):
        svc.restore_from_disk(str(tmp_path / "c"))


def test_checkpointer_writes_the_reference_layout(tmp_path):
    """The same tree and sidecar through both packages' checkpointers:
    the same files, manifests and leaves; each restores the other's."""
    rng = np.random.default_rng(3)
    tree = {"b": [rng.standard_normal((2, 3)).astype(np.float32),
                  np.arange(4)], "a": rng.standard_normal(5)}
    meta = {"format": 1, "sessions": [1, "x", None]}
    JCheckpointer(str(tmp_path / "j")).save(7, tree, blocking=True,
                                            meta=meta)
    port = Checkpointer(str(tmp_path / "t"))
    port.save(7, {**tree, "b": [torch.as_tensor(tree["b"][0]),
                                tree["b"][1]]}, blocking=False, meta=meta)
    port.wait()
    dj, dt = tmp_path / "j" / "step_000007", tmp_path / "t" / "step_000007"
    assert sorted(p.name for p in dj.iterdir()) == \
        sorted(p.name for p in dt.iterdir()) == \
        ["COMMIT", "leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
         "manifest.json"]
    assert json.loads((dj / "manifest.json").read_text()) == \
        json.loads((dt / "manifest.json").read_text())
    for i in range(3):
        np.testing.assert_array_equal(np.load(dj / f"leaf_{i:05d}.npy"),
                                      np.load(dt / f"leaf_{i:05d}.npy"))
    step, back, got_meta = Checkpointer(str(tmp_path / "j")).restore(
        like=tree, with_meta=True)
    assert step == 7 and got_meta == meta
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    np.testing.assert_array_equal(back["a"], tree["a"])
    step, flat = JCheckpointer(str(tmp_path / "t")).restore()
    assert len(flat) == 3
    with pytest.raises(ValueError, match="leaves"):
        port.restore(like=[0])


# --------------------------------------------------------------------------
# Calibrated streaming (tests/test_precision_calibration.py's budget test)
# --------------------------------------------------------------------------

QLEN, QBUDGET = 512, 1e-2


def _fig9q(length):
    g = tsig.SignalGraph("fig9q")
    g.fir("front", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.stft("spec", "front", frame=64, hop=32)
    g.magnitude("mag", "spec", onesided=False)
    g.dnn_circulant("mask", "mag", 64, block=4,
                    activation=lambda v: torch.sigmoid(v - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=32, length=length)
    g.magnitude("m2", "enh", onesided=True)
    g.mel_filterbank("mel", "m2", sr=16_000, n_mels=12)
    g.outputs("out", "mel")
    return g


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_budget_holds_streamed_and_served():
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((2, QLEN)).astype(np.float32)
               for _ in range(6)]
    c = _fig9q(QLEN).compile(QLEN, backend="hopper", device="cpu")
    policy, _ = tpz.auto_policy(c, batches, budget=QBUDGET)
    assert policy.widths
    x = np.random.default_rng(9).standard_normal(QLEN).astype(np.float32)
    fref = _fig9q(QLEN).compile(QLEN, device="cpu")(x)["out"].numpy()
    cq = c.with_backend(HopperBackend(precision=policy))
    assert _rel_err(cq(x)["out"], fref) <= QBUDGET

    r = StreamingRunner(_fig9q(None), backend=cq.backend, device="cpu")
    acc = {}
    for lo in range(0, QLEN, 128):
        _collect(acc, r.process(x[lo:lo + 128]))
    _collect(acc, r.flush())
    streamed = np.concatenate(acc["out"], axis=-1)
    n = streamed.shape[-1]
    assert _rel_err(streamed, fref[..., :n]) <= QBUDGET

    svc = SignalService(backend="hopper", precision=policy, device="cpu")
    svc.register("g", _fig9q(None))
    sess = svc.open_stream("g")
    acc = {}
    for lo in range(0, QLEN, 192):
        sess.feed(x[lo:lo + 192])
        svc.stream_step()
        _collect(acc, sess.read())
    _collect(acc, sess.close())
    served = np.concatenate(acc["out"], axis=-1)
    m = served.shape[-1]
    assert _rel_err(served, fref[..., :m]) <= QBUDGET
    k = min(n, m)
    np.testing.assert_allclose(streamed[..., :k], served[..., :k], rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------
# Observability: the reference's span and counter names
# --------------------------------------------------------------------------

def test_traced_stream_has_the_reference_names(tmp_path):
    obs.reset()
    obs.enable()
    try:
        svc = _service(block_frames=2)
        sess = svc.open_stream("se")
        sess.feed(_waves(1, 768, seed=1)[0])
        svc.stream_step()
        sess.close()
        path = str(tmp_path / "trace.json")
        obs.get_tracer().export(path)
        obs.validate_trace(path)
        doc = json.loads(open(path).read())
        snap = obs.get_registry().snapshot()
    finally:
        obs.reset()
    names = {(ev["tid"], ev["name"]) for ev in doc["traceEvents"]
             if ev["ph"] == "X"}
    lanes = {ev["args"]["name"]: ev["tid"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert (lanes["Streaming"], "stream_tick") in names
    assert (lanes["graph/se"], "stream_core") in names
    for h in ("streaming.chunk_samples", "streaming.block_frames",
              "service.stream_stack_width"):
        assert snap["histograms"][h]["count"] >= 1, h


def test_stream_pending_and_frames_ready():
    svc = _service(block_frames=2)
    sess = svc.open_stream("se")
    assert not svc.stream_pending() and sess.frames_ready() == 0
    sess.feed(np.zeros(256 + 5 * 128, np.float32))   # 6 frames, 3 held back
    assert svc.stream_pending() and sess.frames_ready() == 3
    assert svc.stream_step() == 1 and sess.frames_ready() == 1
    assert svc.stream_sessions("se") == svc.stream_sessions() == 1


def test_sessions_carry_no_autograd_history():
    """Registered params that require grad do not make a session's
    carried state hold a graph from tick to tick."""
    cnn = [w.requires_grad_() for w in params_from_jax(_cnn(), device="cpu")]
    svc = SignalService(block_frames=2, device="cpu")
    svc.register("se", tse.build_graph(T, ch=CH), params={
        "mask": cnn, "front": {"taps": torch.zeros(9, requires_grad=True)}})
    sess = svc.open_stream("se")
    sess.feed(_waves(1, 768, seed=2)[0])
    assert svc.stream_step() == 1
    assert not sess.state.buf.requires_grad
    assert not sess.state.tail.requires_grad
    assert not any(c.requires_grad for c in sess.state.pre)
