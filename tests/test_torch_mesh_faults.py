"""SigMesh serving and its fault tolerance in the PyTorch port.

A meshed ``SignalService`` runs on a virtual 8-shard mesh over the CPU
(the shards wrap onto one placement slot, as the JAX package's tests run
on one CPU device) and on an explicit 4-slot ``DataMesh`` of CPU entries,
where waves really split into per-slot row blocks and gather back.

Oracles.  The CPU's plain GEMMs round by the number of rows a call
computes (ROADMAP Queue 3): a meshed call is held bit for bit against
the port's unmeshed service computing the same rows a call — the
unmeshed service at the meshed call's batch (virtual mesh, full waves),
at batch 1 against the 4-slot mesh's one-row blocks, and a session
alone against a meshed session, which never stacks across shards — and
every meshed result also against the JAX package's OFFLINE
``compile(t)`` at the served tolerances (waves rtol 1e-5, atol 1e-6;
streams ``out`` atol 1e-5, ``mel`` rtol 1e-5, atol 1e-4).  The JAX
package's own meshed, served or streamed outputs are not the oracle.
Where a meshed call computes more rows than any unmeshed one (a wave of
3 padded to 8 rows), it is held bit for bit against the port's compiled
graph on the same padded batch, trimmed.

Supervision: the main-process cases of
``tests/test_signal_mesh_faults.py`` (a transient failure rolled back
and retried, retry exhaustion restored from the durable checkpoint and
replayed, the straggler hook, a restore detaching later sessions) and a
device lost mid-stream on the 4-slot mesh — each stream bit for bit the
port's unsupervised one, with the JAX package's ``stats``.  The
co-scheduler's ``occupancy()["per_device"]`` equals the JAX package's on
one seeded script.
"""

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
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch.mesh import DataMesh
from repro_torch.models import get_model
from repro_torch.runtime import DeviceLoss, StepMonitor, StreamSupervisor
from repro_torch.serving import (CoScheduler, Request, ServingEngine,
                                 SignalMesh, SignalRequest, SignalService)
from repro_torch.signal import SignalGraph

T = 1024
RTOL, ATOL = 1e-5, 1e-6
STREAM_TOL = {"out": (0.0, 1e-5), "mel": (1e-5, 1e-4)}
TINY = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128)


def _fig9(pkg="torch", multi=True):
    graph_cls, sig, absf = (SignalGraph, torch.sigmoid, torch.abs) \
        if pkg == "torch" else (jsig.SignalGraph, jax.nn.sigmoid, jnp.abs)
    g = graph_cls("f")
    g.stft("spec", frame=256, hop=128)
    g.dnn("mask", "spec", fn=lambda p, z: sig(absf(z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=128)
    if multi:
        g.magnitude("mag", "enh", onesided=True)
        g.mel_filterbank("mel", "mag", sr=16_000, n_mels=8)
        g.outputs("out", "mel")
    else:
        g.outputs("out")
    return g


def _service(mesh=None, batch_size=4, multi=True, **kw):
    svc = SignalService(batch_size=batch_size, mesh=mesh, device="cpu", **kw)
    svc.register("f", _fig9(multi=multi))
    return svc


def _slots(n=4):
    return DataMesh(["cpu"] * n)


def _signals(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for n in lens]


def _serve(svc, sigs):
    return svc.serve([SignalRequest(rid=i, graph="f", samples=s)
                      for i, s in enumerate(sigs)])


def _assert_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for rid in ref:
        for k in ref[rid]:
            np.testing.assert_array_equal(got[rid][k], ref[rid][k])


def _jax_offline(sig):
    c = _fig9("jax").compile(len(sig))
    return {k: np.asarray(v) for k, v in c(jnp.asarray(sig[None])).items()}


def _hold_offline(got, sigs):
    for i, s in enumerate(sigs):
        want = _jax_offline(s)
        for k in want:
            np.testing.assert_allclose(got[i][k], want[k][0], rtol=RTOL,
                                       atol=ATOL)


# -- one-shot waves ------------------------------------------------------------

UNEVEN = [1024, 1024, 900, 700, 1024, 800, 640, 1000]   # one bucket: masked


def test_virtual_mesh_waves_equal_unmeshed():
    """8 uneven-length requests in waves of 4, padded to 8 rows on a
    virtual 8-shard mesh: equal bit for bit to the unmeshed service (the
    CPU rounds 4 and 8 rows alike on this graph) and to the JAX
    package's offline compile at the served tolerance; multi-output."""
    sigs = _signals(UNEVEN)
    svc = _service(8)
    got = _serve(svc, sigs)
    _assert_equal(_serve(_service(), sigs), got)
    _hold_offline(got, sigs)
    assert svc.stats["bucketed"] == 2 and svc.stats["batches"] == 2
    assert svc.mesh.n_shards == 8 and len(svc.mesh.devices) == 1


@pytest.mark.parametrize("n_req", [8, 7, 5])
def test_slot_mesh_waves_split_and_gather(n_req):
    """Even and uneven waves on 4 CPU slots: each slot computes one row
    (a pad row of 0 valid frames where the wave is short), the blocks
    gather back in row order, equal bit for bit to the unmeshed service
    at batch 1 (one row a call) and to the offline compile."""
    sigs = _signals(UNEVEN[:n_req], seed=n_req)
    got = _serve(_service(_slots()), sigs)
    _assert_equal(_serve(_service(batch_size=1), sigs), got)
    _hold_offline(got, sigs)


def test_exact_length_waves_on_both_meshes():
    """Requests at the bucket length (the unmasked call) on both meshes."""
    sigs = _signals([T] * 6, seed=9)
    ref1 = _serve(_service(batch_size=1), sigs)
    _assert_equal(ref1, _serve(_service(_slots()), sigs))
    got = _serve(_service(8), sigs)
    _hold_offline(got, sigs)


def test_padded_wave_equals_the_compiled_graph_on_its_padded_rows():
    """A wave of 3 padded to 8 rows on the virtual mesh computes 8 rows a
    call where the unmeshed service computes 3 — the CPU rounds those
    apart (ROADMAP Queue 3) — so it is held bit for bit against the
    port's compiled graph on the same padded batch (0 valid frames on
    the pad rows), trimmed, and against the offline compile."""
    sigs = _signals(UNEVEN[:7], seed=3)
    svc = _service(8)
    got = _serve(svc, sigs)
    _hold_offline(got, sigs)
    reg = svc._graphs["f"]
    c = svc.compiled_for("f", T)
    for lo, hi in ((0, 4), (4, 7)):
        stack = np.zeros((8, T), np.float32)
        for i in range(lo, hi):
            stack[i - lo, :len(sigs[i])] = sigs[i]
        vf = [reg.struct.valid_frames(len(sigs[i])) for i in range(lo, hi)]
        out = c.masked_jit()(stack, vf + [0] * (8 - len(vf)), None)
        for i in range(lo, hi):
            row = svc._request_result(
                c, reg, {k: v.numpy() for k, v in out.items()}, i - lo,
                len(sigs[i]))
            for k in row:
                np.testing.assert_array_equal(got[i][k], row[k])


@pytest.mark.parametrize("mesh", ["virtual", "slots"])
def test_row_budget_chunks_align_to_the_shard_width(mesh):
    """SigSched's row budget of 3 rounds up to one shard round (8 on the
    virtual mesh, 4 on the slots): the wave of 8 runs in 1 or 2 chunks,
    equal bit for bit to the unmeshed service computing the same rows a
    call."""
    m = 8 if mesh == "virtual" else _slots()
    sigs = _signals(UNEVEN, seed=11)
    svc = _service(m, batch_size=8, scheduler={"row_budget": 3})
    assert svc.scheduler._effective_budget() == (8 if mesh == "virtual"
                                                 else 4)
    got = _serve(svc, sigs)
    assert svc.stats["batches"] == (1 if mesh == "virtual" else 2)
    ref = _serve(_service(batch_size=8 if mesh == "virtual" else 1), sigs)
    _assert_equal(ref, got)


def test_sharded_jit_splits_rows_over_the_slots():
    """sharded_jit over 4 CPU slots: one block a slot, params passed to
    each, the outputs gathered in row order — equal bit for bit to the
    plain call on each block's rows; rows that do not divide run once on
    the first slot, equal to the plain call."""
    c = _fig9().compile(T, device="cpu")
    x = np.random.default_rng(5).standard_normal((8, T)).astype(np.float32)
    fn = c.sharded_jit(_slots())
    got = fn(x)
    for i in range(4):
        want = c(x[2 * i:2 * i + 2])
        for k in want:
            assert torch.equal(got[k][2 * i:2 * i + 2], want[k])
    odd = fn(x[:6], None, valid_frames=[7] * 6)
    want = c.masked_jit()(x[:6], [7] * 6, None)
    for k in want:
        assert torch.equal(odd[k], want[k])
    with pytest.raises(ValueError, match="1-D mesh"):
        c.sharded_jit(_slots(), batch_axis="model")


# -- stream sessions -----------------------------------------------------------

def _drain(services, waves, chunk=512):
    """One session a wave (``services[i]`` opens session i), fed in
    lock-step; returns the concatenated outputs and the sessions."""
    sessions = [s.open_stream("f") for s in services]
    got = [{} for _ in sessions]
    for lo in range(0, len(waves[0]), chunk):
        for s, w in zip(sessions, waves):
            s.feed(w[lo:lo + chunk])
        for svc in dict.fromkeys(services):
            svc.stream_step()
        for g, s in zip(got, sessions):
            for k, v in s.read().items():
                g.setdefault(k, []).append(v)
    for g, s in zip(got, sessions):
        for k, v in s.close().items():
            g.setdefault(k, []).append(v)
    axes = {"out": -1, "mel": 0}
    return [{k: np.concatenate(v, axis=axes[k]) for k, v in g.items()}
            for g in got], sessions


@pytest.mark.parametrize("mesh", ["virtual", "slots"])
def test_meshed_sessions_equal_unmeshed_sessions(mesh):
    """4 multi-output sessions land on 4 shards and never stack: 4 core
    calls a tick, each session bit for bit an unmeshed session computing
    its rows alone, and every stream within the served tolerance of the
    offline compile."""
    waves = _signals([3 * T] * 4, seed=7)
    svc = _service(8 if mesh == "virtual" else _slots())
    got, sessions = _drain([svc] * 4, waves)
    assert [s.device_index for s in sessions] == [0, 1, 2, 3]
    assert svc.stats["core_calls"] > 0 and svc.stats["core_calls"] % 4 == 0
    alone, _ = _drain([_service() for _ in waves], waves)
    for a, b in zip(alone, got):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    for g, w in zip(got, waves):
        want = _jax_offline(w)
        for k, (rtol, atol) in STREAM_TOL.items():
            np.testing.assert_allclose(g[k], want[k][0], rtol=rtol,
                                       atol=atol)


def test_meshed_tick_makes_one_core_call_a_shard():
    """Where the unmeshed service stacks 4 sessions into one core call
    a tick, the meshed one makes one a shard."""
    svc = _service(_slots())
    sessions = [svc.open_stream("f") for _ in range(4)]
    calls = []
    waves = _signals([4 * 256] * 4, seed=8)
    for lo in range(0, 4 * 256, 256):
        for s, w in zip(sessions, waves):
            s.feed(w[lo:lo + 256])
        calls.append(svc.stream_step())
    assert set(calls) <= {0, 4} and calls[-1] == 4
    ref = _service()
    ref_sessions = [ref.open_stream("f") for _ in range(4)]
    ref_calls = []
    for lo in range(0, 4 * 256, 256):
        for s, w in zip(ref_sessions, waves):
            s.feed(w[lo:lo + 256])
        ref_calls.append(ref.stream_step())
    assert [c * 4 for c in ref_calls] == calls


# -- supervision (tests/test_signal_mesh_faults.py) ----------------------------

def _run_stream(svc, w, chunk=512, injector=None, sup_kw=None):
    """``w`` through one supervised session in chunks; returns the
    concatenated read()/close() stream and the supervisor."""
    sup = StreamSupervisor(svc, **(sup_kw or {}))
    sess = svc.open_stream("f")
    pieces = []
    empty = np.zeros(0, np.float32)
    for lo in range(0, len(w), chunk):
        sup.feed(sess, w[lo:lo + chunk])
        sup.tick(injector)
        pieces.append(sess.read().get("out", empty))
    pieces.append(sess.close().get("out", empty))
    return np.concatenate(pieces, axis=-1), sup


def _unsupervised(w, chunk=512):
    svc = _service(multi=False)
    sess = svc.open_stream("f")
    pieces = []
    for lo in range(0, len(w), chunk):
        sess.feed(w[lo:lo + chunk])
        svc.stream_step()
        pieces.append(sess.read()["out"])
    pieces.append(sess.close()["out"])
    return np.concatenate(pieces, axis=-1)


def test_transient_failure_rolls_back_and_retries_bit_identical():
    w = _signals([4 * T], seed=0)[0]
    fired = []

    def injector(tick, attempt):
        if tick == 2 and attempt == 0:
            fired.append(tick)
            raise RuntimeError("transient device error")

    out, sup = _run_stream(_service(8, multi=False), w, injector=injector)
    assert fired == [2]
    np.testing.assert_array_equal(_unsupervised(w), out)
    assert sup.stats == {"retries": 1, "checkpoint_restores": 0,
                         "device_losses": 0}


def test_retry_exhaustion_restores_durable_checkpoint_and_replays():
    """Persistent failure at tick 3 exhausts 2 retries: the durable
    checkpoint (tick 2) is restored and the journal replayed tick by
    tick, so the stream is bit for bit the unfailed one."""
    w = _signals([4 * T], seed=1)[0]
    attempts = []

    def injector(tick, attempt):
        if tick == 3 and len(attempts) <= 2:
            attempts.append(attempt)
            raise RuntimeError("persistent device error")

    out, sup = _run_stream(_service(8, multi=False), w, injector=injector,
                           sup_kw={"ckpt_every": 2, "max_retries": 2})
    assert attempts == [0, 1, 2]
    np.testing.assert_array_equal(_unsupervised(w), out)
    assert sup.stats == {"retries": 3, "checkpoint_restores": 1,
                         "device_losses": 0}


def test_straggler_hook_fires_on_slow_tick():
    w = _signals([2 * T], seed=2)[0]
    slow = []
    _, sup = _run_stream(
        _service(8, multi=False), w,
        sup_kw={"monitor": StepMonitor(straggler_factor=0.0),
                "on_straggler": lambda tick, dt: slow.append(tick)})
    assert slow, "straggler hook never fired"
    assert sup.monitor.stragglers == slow


def test_restore_detaches_sessions_opened_after_checkpoint():
    svc = _service(8, multi=False)
    ck = svc.checkpoint()
    sess = svc.open_stream("f")
    svc.restore(ck)
    assert sess.closed and "checkpoint" in sess.error
    with pytest.raises(ValueError):
        sess.feed(np.zeros(256, np.float32))
    assert svc.stats["detached_sessions"] == 1


def test_device_loss_mid_stream_resumes_bit_identical_on_slots():
    """Losing the shard a session is homed on mid-stream (4 CPU slots):
    the shard dropped, the session re-homed, the durable checkpoint
    restored onto its new slot and replayed there — the stream bit for
    bit the unfailed one."""
    w = _signals([5 * T], seed=7)[0]
    svc = _service(_slots(), multi=False)
    sup = StreamSupervisor(svc, ckpt_every=2)
    sess = svc.open_stream("f")
    state, homes, pieces = {"fired": False}, [], []

    def injector(tick, attempt):
        if tick == 4 and not state["fired"]:
            state["fired"] = True
            raise DeviceLoss(sess.device_index)

    for lo in range(0, len(w), 512):
        sup.feed(sess, w[lo:lo + 512])
        sup.tick(injector)
        pieces.append(sess.read()["out"])
        homes.append(sess.device_index)
    assert sess.state.buf.device == svc.mesh.device_for(sess.device_index)
    pieces.append(sess.close()["out"])
    np.testing.assert_array_equal(_unsupervised(w),
                                  np.concatenate(pieces, axis=-1))
    assert state["fired"] and sup.stats["device_losses"] == 1
    assert svc.router.alive_count() == 3 and not svc.router.alive[0]
    assert len(set(homes)) > 1 and homes[-1] != 0
    assert sup.stats["checkpoint_restores"] >= 1
    assert svc.stats["device_losses"] == 1


class _LostState:
    """A session's state that lies on a lost device: any read raises."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name!r} of a lost shard's state")


def test_device_loss_never_touches_the_lost_slot():
    """After a DeviceLoss nothing places work on the lost slot or reads
    the state it held: the restore and the replay land on live slots.
    Two sessions on 4 CPU slots; at the loss the lost slot's
    ``device_for`` starts to raise and its session's state is replaced by
    one that raises on any read.  Both streams come back bit for bit."""
    ws = _signals([4 * T, 4 * T], seed=9)
    svc = _service(_slots(), multi=False)
    sessions = [svc.open_stream("f") for _ in ws]
    sup = StreamSupervisor(svc, ckpt_every=2)
    lost = {}
    device_for = svc.mesh.device_for

    def guarded(index):
        if index == lost.get("index"):
            raise AssertionError(f"shard {index} used after its loss")
        return device_for(index)
    svc.mesh.device_for = guarded

    def injector(tick, attempt):
        if tick == 3 and not lost:
            lost["index"] = sessions[0].device_index
            sessions[0].state = _LostState()
            raise DeviceLoss(lost["index"])

    pieces = [[] for _ in ws]
    for lo in range(0, 4 * T, 512):
        for sess, w in zip(sessions, ws):
            sup.feed(sess, w[lo:lo + 512])
        sup.tick(injector)
        for acc, sess in zip(pieces, sessions):
            acc.append(sess.read()["out"])
    assert lost["index"] == 0 and not svc.router.alive[0]
    assert [s.device_index for s in sessions] == [2, 1]
    assert svc.router.device_sessions == [0, 1, 1, 0]
    for acc, sess in zip(pieces, sessions):
        acc.append(sess.close()["out"])
    for w, acc in zip(ws, pieces):
        np.testing.assert_array_equal(_unsupervised(w),
                                      np.concatenate(acc, axis=-1))
    assert sup.stats == {"retries": 0, "checkpoint_restores": 1,
                         "device_losses": 1}


def test_snapshot_carries_the_shard_and_rehomes_a_dead_one(tmp_path):
    """checkpoint() carries each session's shard and the router's ledger;
    a snapshot restored after its shard died re-homes the session; a
    fresh meshed service restores from disk onto the same shards."""
    svc = _service(8, multi=False)
    a, b = svc.open_stream("f"), svc.open_stream("f")
    a.feed(_signals([T], seed=4)[0])
    svc.stream_step()
    ck = svc.checkpoint()
    assert [s["device_index"] for s in ck["sessions"]] == [0, 1]
    assert ck["device_cycles"] == svc.router.device_cycles
    svc.save_checkpoint(str(tmp_path))
    svc.drop_device(0)
    assert a.device_index not in (0, None)
    svc.restore(ck)
    assert a.device_index != 0 and b.device_index == 1
    fresh = _service(8, multi=False)
    fresh.restore_from_disk(str(tmp_path))
    assert sorted(s.device_index for s in
                  fresh._sessions["f"]) == [0, 1]
    assert fresh.router.device_cycles == ck["device_cycles"]
    with pytest.raises(ValueError, match="meshed"):
        _service(multi=False).drop_device(0)


# -- the co-scheduler's per-device view -----------------------------------------

def test_coscheduler_per_device_equals_the_jax_package():
    """One seeded script through both packages' CoScheduler over a
    4-shard meshed service: occupancy() — per_device included — equal
    after every tick, every shard charged; the trace carries the
    device_occupancy counter."""
    jp = jget_model(jget_config("starcoder2-3b").reduced(**TINY)).init(
        jax.random.PRNGKey(0))
    jeng = js.ServingEngine(jget_model(jget_config(
        "starcoder2-3b").reduced(**TINY)), batch_size=2)
    jeng.load(jp)
    teng = ServingEngine(get_model(get_config("starcoder2-3b").reduced(
        **TINY)), batch_size=2)
    teng.load(model_params_from_jax(jp, "cpu"), device="cpu")
    jsvc = js.SignalService(batch_size=4, mesh=js.SignalMesh(4))
    jsvc.register("f", _fig9("jax"))
    tsvc = _service(SignalMesh(4, device="cpu"))
    jsched = js.CoScheduler(jeng, jsvc, policy="round_robin")
    tsched = CoScheduler(teng, tsvc, policy="round_robin")
    sigs = _signals(UNEVEN[:6], seed=12)
    for pkg, sched in ((js, jsched), (None, tsched)):
        for rid, prompt in ((0, [1, 2, 3]), (1, [4, 5])):
            req = (pkg.Request if pkg else Request)(rid=rid, prompt=prompt,
                                                    max_new=3)
            sched.submit_llm(req)
        for i, s in enumerate(sigs):
            sched.submit_signal((pkg.SignalRequest if pkg else
                                 SignalRequest)(rid=i, graph="f",
                                                samples=s))
    obs.reset()
    obs.enable()
    try:
        while not (jsched.idle and tsched.idle):
            jsched.tick()
            tsched.tick()
            assert tsched.occupancy() == jsched.occupancy()
        names = {ev["name"] for ev in obs.tracer().events()
                 if ev["ph"] == "C"}
    finally:
        obs.reset()
    per = tsched.occupancy()["per_device"]
    assert len(per["device_cycles"]) == 4 and all(per["device_cycles"])
    assert "device_occupancy" in names
