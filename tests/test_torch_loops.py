"""The port's counted loop (``repro_torch.loops.scan``) and the cost
counter's reading of it (``launch/hlo_analysis.CostMode``), on the CPU.

  * outside a count, ``scan`` is the plain loop: the same ops in the same
    order and the same values;
  * a loop of matmul + tanh trips reads exactly trips x the body's FLOPs
    loop-aware, the body's once trip-blind (as XLA's own analysis reads
    a ``while``), its gradient 3 x and its remat 4 x — the reference's
    cases (``tests/test_hlo_analysis.py``), now with the loop counted
    from three trips — and the loop is listed with its trips;
  * a loop whose trips never count alike runs whole;
  * the mLSTM's chunk loop, the sLSTM's steps and chunked attention's
    q and kv loops, forward and backward (a checkpointed region around
    them included), count exactly what ``CostMode(whole_loops=True)``
    counts — FLOPs, HBM bytes and ops — and under a memory tracker on
    fake tensors reach the same peak.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import hlo_analysis as H
from repro_torch.loops import scan
from repro_torch.models import layers as L
from repro_torch.models import xlstm as XL

UNIT = 2 * 64 * 256 * 256


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _body(x, w):
    return torch.tanh(x @ w), x.sum()


def test_scan_outside_a_count_is_the_plain_loop():
    rng = np.random.default_rng(0)
    ws = torch.as_tensor(rng.standard_normal((5, 16, 16)).astype(np.float32))
    a = torch.as_tensor(rng.standard_normal((4, 16)).astype(np.float32))
    with _Ops() as plain:
        x, ys = a, []
        for w in ws.unbind(0):
            x, y = _body(x, w)
            ys.append(y)
    with _Ops() as scanned:
        x2, ys2 = scan("test.loop", _body, a, ws.unbind(0))
    assert scanned.names == plain.names
    assert torch.equal(x2, x) and len(ys2) == 5
    assert all(torch.equal(p, q) for p, q in zip(ys, ys2))


def _layers(a, ws, remat=False):
    def trip(x, w):
        if remat:
            return checkpoint(lambda x_, w_: torch.tanh(x_ @ w_), x, w,
                              use_reentrant=False), None
        return torch.tanh(x @ w), None
    return scan("test.layers", trip, a, ws.unbind(0))[0]


def _grads(a, ws, remat=False):
    a, ws = (t.detach().requires_grad_() for t in (a, ws))
    return torch.autograd.grad(_layers(a, ws, remat).sum(), (a, ws))


@pytest.mark.parametrize("trips", [2, 3, 7])
def test_counted_loop_reads_body_times_trips(trips):
    ws = torch.randn(trips, 256, 256)
    a = torch.randn(64, 256)
    for fn, per, args in ((_layers, 1, ()), (_grads, 3, ()),
                          (_grads, 4, (True,))):
        with H.CostMode() as mode:
            fn(a, ws, *args)
        with H.CostMode(whole_loops=True) as whole:
            fn(a, ws, *args)
        assert mode.summary.flops == per * trips * UNIT, fn
        assert mode.summary.hbm_bytes == whole.summary.hbm_bytes
        assert mode.op_counts == whole.op_counts
        assert mode.summary.while_loops == [("test.layers", trips)]
        assert whole.summary.while_loops == []
        assert whole.naive.flops == whole.summary.flops
        # trip-blind: the body once, forward and backward
        assert mode.naive.flops == per * UNIT


def test_loop_whose_trips_differ_runs_whole():
    ws = [torch.randn(8 * (i + 1), 8) for i in range(5)]
    ran = []

    def trip(carry, w):
        ran.append(w.shape[0])
        return carry + (w @ w.T).sum(), None
    with H.CostMode() as mode:
        scan("test.growing", trip, torch.zeros(()), ws)
    assert ran == [8, 16, 24, 32, 40]
    assert mode.summary.flops == sum(2 * n * 8 * n for n in ran)
    assert mode.summary.while_loops == [("test.growing", 5)]


def _counts(fn, *args, whole):
    with H.CostMode(whole_loops=whole) as mode:
        fn(*args)
    return mode


def _same(fn, *args):
    aware, whole = (_counts(fn, *args, whole=w) for w in (False, True))
    assert aware.summary.flops == whole.summary.flops
    assert aware.summary.hbm_bytes == whole.summary.hbm_bytes
    assert aware.op_counts == whole.op_counts
    assert aware.summary.flops > 0
    return aware


def _mlstm_args(rng, s=64, grad=False):
    b, h, hd = 2, 2, 8
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                            ).requires_grad_(grad)
            for shape in ((b, s, h, hd),) * 3 + ((b, s, h),) * 2]


@pytest.mark.parametrize("grad", [False, True])
def test_mlstm_chunk_loop_counts_as_whole(grad):
    rng = np.random.default_rng(1)
    args = _mlstm_args(rng, grad=grad)

    def run(*a):
        out = XL.mlstm_chunkwise(*a, chunk=8)
        if grad:
            torch.autograd.grad(out.sum(), a)
    mode = _same(run, *args)
    assert mode.summary.while_loops == [("xlstm.mlstm_chunks", 8)]


@pytest.mark.parametrize("grad", [False, True])
def test_slstm_steps_count_as_whole(grad):
    rng = np.random.default_rng(2)
    d, heads = 16, 2
    params = XL.init_slstm_block(torch.Generator().manual_seed(0), d,
                                 heads, torch.float32)
    x = torch.as_tensor(rng.standard_normal((2, 12, d)).astype(np.float32))
    leaves = list(params.values())

    def run():
        for p in leaves:
            p.requires_grad_(grad)
        out, _ = XL.slstm_block(params, x, heads)
        if grad:
            torch.autograd.grad(out.sum(), leaves)
    mode = _same(run)
    assert mode.summary.while_loops == [("xlstm.slstm_steps", 12)]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 10),
                                           (False, 0)])
def test_chunked_attention_loops_count_as_whole(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 40, 2, 4))
                               .astype(np.float32)).requires_grad_()
               for _ in range(3))

    def run():
        out = L.chunked_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=8, kv_chunk=4)
        torch.autograd.grad(out.sum(), (q, k, v))
    mode = _same(run)
    names = {n for n, _ in mode.summary.while_loops}
    assert names == {"layers.attention_q_chunks",
                     "layers.attention_kv_chunks"}
    # the kv loop runs over the chunks a q chunk sees: all 10 of the
    # last q chunk's, 5 of them within the window of 10 (keys 20 to 39)
    trips = sorted(t for n, t in mode.summary.while_loops
                   if n == "layers.attention_kv_chunks")
    assert trips[-1] == (5 if window else 10)


def _peak(fn, whole: bool):
    tracker = MemTracker()
    with tracker, H.CostMode(whole_loops=whole, live_bytes=lambda: sum(
            s["Total"] for s in tracker.get_tracker_snapshot(
                "current").values())) as mode:
        fn()
    peak = max(s["Total"] for s in
               tracker.get_tracker_snapshot("peak").values())
    return peak, mode


@pytest.mark.parametrize("remat", [False, True])
def test_counted_loop_peak_bytes_match_whole(remat):
    """What skipped trips keep alive for the backward pass — the sLSTM's
    per-step activations, recomputed under a checkpoint around the block
    when ``remat`` — held until the backward pass has gone through the
    last trip run: the tracker's peak within 5% of the whole loop's (in
    float32 the step's ``h`` is its output ``y`` and is saved, which the
    count, reading ``y`` as freed once stacked, leaves out: 2.5% here)."""
    with FakeTensorMode():
        d, heads = 32, 2
        params = XL.init_slstm_block(torch.Generator().manual_seed(0), d,
                                     heads, torch.float32)
        leaves = list(params.values())
        x = torch.empty(4, 24, d, requires_grad=True)

        def block(x_):
            return XL.slstm_block(params, x_, heads)[0]

        def run():
            for p in leaves:
                p.requires_grad_()
            out = (checkpoint(block, x, use_reentrant=False) if remat
                   else block(x))
            torch.autograd.grad(out.sum(), [x] + leaves)
        (aware, ma), (whole, mw) = (_peak(run, w) for w in (False, True))
    assert ma.summary.flops == mw.summary.flops
    assert ma.summary.hbm_bytes == mw.summary.hbm_bytes
    assert ma.summary.while_loops == [("xlstm.slstm_steps", 24)]
    assert aware == pytest.approx(whole, rel=0.05)
