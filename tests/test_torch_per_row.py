"""Per-row operands in the port's kernels, and bitserial planes of any
count, against the JAX package and against their own shared calls.

A served wave whose graphs registered different params runs one call
with one operand a batch row (the JAX package's ``vmap`` over stacked
params).  On the CPU the kernel wrappers run their plain versions, so
these tests hold those versions to the function the CUDA kernels
compute:

  * ``shuffle_gemm_grouped_blocks`` with ``w (B, G, t, n_out)``, the
    chain with any sub-step's operand one a batch row, and the int
    route's ``bitserial_quant_matmul`` with ``w (B, K, N)``: batch row b
    bit for bit the shared call on row b's operands; the chain also
    against a numpy emulation of the kernel's tile indexing with each
    row's operands (the CPU spec of the per-row chain instance), and the
    quantized GEMM against the JAX package's int route under ``vmap``;
  * ``bitserial_matmul_planes`` at plane counts the widths do not give
    (pa, pw in {3, 5, 8}, and counts past 8) against the JAX package's
    Pallas kernel in interpret mode, shifts of 32 and more included, and
    against a numpy emulation of the CUDA body of any count (pairs
    i + j < 8, uint32 shift-add);
  * the ops and the backends on per-row params (``RowParams``): the
    grouped unit, the chain unit and the int-routed unit of ``hopper``
    and the plain path of ``reference``, each row equal to the same
    program run on that row alone with its own params; a biquad with
    ``(B, 3)`` coefficients and a learnable window of ``(B, frame)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitwidth as jbw
from repro.kernels import bitserial_matmul as j_bitserial
from repro.kernels.bitserial_mm.kernel import \
    bitserial_matmul_planes as j_planes
from repro_torch import signal as tsig
from repro_torch.core.exec_ir import (EinsumStep, ExecProgram, RowParams,
                                      StageProgram, resolve_operand,
                                      row_operand)
from repro_torch.core.fabric import PAD, ShufflePlan
from repro_torch.kernels import bitserial_mm
from repro_torch.kernels.shuffle_gemm import (
    run_chain, shuffle_gemm_chain, shuffle_gemm_grouped,
    shuffle_gemm_grouped_blocks, shuffle_gemm_steps)
from repro_torch.kernels.shuffle_gemm.chain import SubStep, segment_chain
from repro_torch.kernels.shuffle_gemm.ops import ShuffleGemmChain
from repro_torch.signal import HopperBackend, PrecisionPolicy
from repro_torch.signal.graph import SigType, biquad_apply

RTOL, ATOL = 1e-5, 1e-6
T = torch.as_tensor


# -- shuffle_gemm_grouped_blocks with one operand a batch row --------------

@pytest.mark.parametrize("reps,groups,nb,t,n_out,b", [
    (1, 1, 5, 3, 2, 1), (2, 3, 2, 4, 4, 4), (3, 4, 1, 9, 1, 3),
    (1, 16, 8, 4, 4, 8)])
def test_per_row_grouped_plain_equals_shared_calls(reps, groups, nb, t,
                                                   n_out, b):
    """Batch row b of a per-row call is the shared call on w[b] bit for
    bit, and a numpy gather, PAD fill, scale and per-group product at
    1e-5."""
    rng = np.random.default_rng(reps * 100 + groups * 10 + t)
    rows, n_in = reps * groups * nb, 40
    idx = rng.integers(-1, n_in, (rows, t)).astype(np.int32)
    pads = rng.standard_normal((rows, t)).astype(np.float32)
    scale = rng.standard_normal((rows, t)).astype(np.float32)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    w = rng.standard_normal((b, groups, t, n_out)).astype(np.float32)
    got = shuffle_gemm_grouped_blocks(T(x), T(idx), T(pads), T(w), reps,
                                      groups, nb, T(scale))
    assert tuple(got.shape) == (b, rows * n_out)
    for i in range(b):
        one = shuffle_gemm_grouped_blocks(T(x[i:i + 1]), T(idx), T(pads),
                                          T(w[i]), reps, groups, nb,
                                          T(scale))[0]
        assert torch.equal(got[i], one)
        g = np.where(idx < 0, pads, x[i][np.maximum(idx, 0)]) * scale
        grp = (np.arange(rows) // nb) % groups
        want = np.einsum("rt,rto->ro", g, w[i][grp]).ravel()
        np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL,
                                   atol=1e-5)


def test_per_row_grouped_op_forward_and_refusals():
    """``shuffle_gemm_grouped`` with ``w (B, G, t, n_out)``: each row
    against its own operand through the plan's gather; the plain version
    differentiates on the CPU; a batch that does not match refuses."""
    rng = np.random.default_rng(1)
    plan = ShufflePlan(rng.permutation(24).astype(np.int32),
                       np.zeros(24, np.float32), 32)
    x = T(rng.standard_normal((3, 24)).astype(np.float32))
    w = T(rng.standard_normal((3, 3, 4, 2)).astype(np.float32)
          ).requires_grad_(True)
    y = shuffle_gemm_grouped(x, plan, w, reps=1, groups=3, nb=2)
    assert tuple(y.shape) == (3, 12)
    for i in range(3):
        want = shuffle_gemm_grouped(x[i:i + 1], plan, w[i].detach(), reps=1,
                                    groups=3, nb=2)[0]
        assert torch.equal(y[i].detach(), want)
    y.sum().backward()
    assert tuple(w.grad.shape) == (3, 3, 4, 2)
    with pytest.raises(ValueError, match="per-row"):
        shuffle_gemm_grouped(x[:2], plan, w, reps=1, groups=3, nb=2)


# -- the chain with per-row sub-step operands ------------------------------

def _chain(rng, tiles=3, rpt=8, groups=(1, 2, 4), n_in=50):
    """Grouped sub-steps (t 4, n_out 4) over ``tiles`` tiles: the first
    reads anywhere in the input, later ones within their tile; PAD
    entries and scales on some."""
    steps, prev = [], None
    for i, g in enumerate(groups):
        rows = tiles * rpt
        if prev is None:
            idx = rng.integers(0, n_in, (rows, 4))
        else:
            ept = prev.n_elems // tiles
            idx = (np.arange(rows) // rpt * ept)[:, None] \
                + rng.integers(0, ept, (rows, 4))
        idx = idx.astype(np.int32)
        idx[rng.random(idx.shape) < 0.15] = PAD
        plan = ShufflePlan(idx.ravel(), rng.standard_normal(idx.size)
                           .astype(np.float32))
        diag = None if i == 1 else rng.standard_normal(idx.size).astype(
            np.float32)
        prev = SubStep(f"s{i}", plan, diag, rows, 4, g, rpt // g)
        steps.append(prev)
    return steps


def _emulate_rows(x, seg, ws):
    """The chain kernel's tile indexing in numpy, each batch row with its
    own operands where ``ws[i]`` carries a batch axis (the per-row
    instance reads w + b * G * t * n_out), the sum over k in order."""
    x = x.numpy()
    last = seg.steps[-1]
    out = np.zeros((x.shape[0], last.n_elems), np.float32)
    for b in range(x.shape[0]):
        for k in range(seg.tiles):
            buf = x[b]
            for i, s in enumerate(seg.steps):
                w = ws[i].numpy()
                w = w[b] if w.ndim == 4 else w
                rpt = s.rows // seg.tiles
                idx, pads, scale = seg.tables[i]
                y = np.zeros(rpt * s.n_out, np.float32)
                for r in range(rpt):
                    grow = k * rpt + r
                    trow = r if seg.periodic[i] else grow
                    g = (grow // s.nb) % s.groups
                    for o in range(s.n_out):
                        acc = np.float32(0)
                        for kk in range(s.t):
                            j = idx[trow, kk]
                            v = pads[trow, kk] if j < 0 else buf[j]
                            if scale is not None:
                                v = v * scale[trow, kk]
                            acc = np.float32(acc + v * w[g, kk, o])
                        y[r * s.n_out + o] = acc
                buf = y
            ept = last.n_elems // seg.tiles
            out[b, k * ept:(k + 1) * ept] = buf
    return out


@pytest.mark.parametrize("rows_of", [(0, 1, 2), (1,), (0, 2)],
                         ids=["all", "middle", "ends"])
def test_per_row_chain_plain_equals_shared_chains(rows_of):
    """A chain whose sub-steps ``rows_of`` take one operand a batch row:
    bit for bit its sub-steps one at a time; row b the shared chain on
    row b's operands (bit for bit where every sub-step is per-row: the
    plain version then runs each row alone, as the shared call on one
    row does; at 1e-6 otherwise, since the CPU's batched products are
    not batch-invariant — on the card the kernel is, and the card tests
    hold it bit for bit); the numpy emulation of the kernel's per-row
    instance at 1e-6."""
    rng = np.random.default_rng(5)
    steps = _chain(rng)
    (seg,) = segment_chain(steps)
    assert seg.launch == "shuffle_gemm_chain"
    b = 3
    x = T(rng.standard_normal((b, 50)).astype(np.float32))
    ws = [T(rng.standard_normal(((b,) if i in rows_of else ())
                                + (s.groups, s.t, s.n_out))
            .astype(np.float32)) for i, s in enumerate(steps)]
    got = shuffle_gemm_chain(x, seg, ws)
    assert torch.equal(got, shuffle_gemm_steps(x, seg, ws))
    for i in range(b):
        own = [w[i] if w.ndim == 4 else w for w in ws]
        one = shuffle_gemm_chain(x[i:i + 1], seg, own)[0]
        if len(rows_of) == len(steps):
            assert torch.equal(got[i], one)
        torch.testing.assert_close(got[i], one, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_emulate_rows(x, seg, ws), got.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_run_chain_per_row_forward_and_refusals():
    """``run_chain`` with ``per_row``: every segment (a chain, and a
    one-step segment on the blocks or grouped kernel) takes its rows'
    operands; the same operands repeated give the shared chain's result
    (at 1e-6: the CPU's batched products are not batch-invariant)."""
    rng = np.random.default_rng(7)
    steps = _chain(rng, tiles=2, rpt=4, groups=(2, 1, 4))
    chain = ShuffleGemmChain(steps)
    b = 4
    x = T(rng.standard_normal((b, 50)).astype(np.float32))
    shared = [T(rng.standard_normal((s.groups, s.t, s.n_out))
                .astype(np.float32)) for s in steps]
    rows = [w.expand(b, *w.shape).contiguous() for w in shared]
    want = run_chain(x, chain, shared)
    close = functools.partial(torch.testing.assert_close, rtol=1e-6,
                              atol=1e-6)
    close(run_chain(x, chain, rows, (0, 1, 2)), want)
    h = T(rng.standard_normal((b, steps[0].n_elems)).astype(np.float32))
    for i in (1, 2):                    # blocks- and grouped-form segments
        one = ShuffleGemmChain(steps[i:i + 1])
        close(run_chain(h, one, [rows[i]], (0,)),
              run_chain(h, one, [shared[i]]))
    with pytest.raises(ValueError, match="per-row"):
        run_chain(x[:2], chain, rows, (0, 1, 2))


# -- the int route's one-launch GEMM with one w a batch row ----------------

@pytest.mark.parametrize("aw,ww", [(16, 8), (8, 8), (4, 16)])
@pytest.mark.parametrize("shape", [(37, 9, 1), (24, 256, 64), (31, 129, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_per_row_quant_matmul_equals_shared_calls(aw, ww, shape):
    """``bitserial_quant_matmul`` with w (B, K, N): batch row b bit for bit
    the shared call on w[b] (quantized with w[b]'s own column scales),
    and the JAX package's int route (quantize x2, interpret-mode
    ``bitserial_matmul``, dequantize) under ``jax.vmap`` over rows."""
    r, k, n = shape
    b = 3
    rng = np.random.default_rng(aw * 7 + k)
    h = (rng.standard_normal((b, r, k))
         * np.exp(rng.uniform(-3, 3, (b, r, 1)))).astype(np.float32)
    w = (rng.standard_normal((b, k, n))
         * np.exp(rng.uniform(-2, 2, (b, 1, 1)))).astype(np.float32)
    h[1, 2] = 0.0
    got = bitserial_mm.bitserial_quant_matmul(T(h), T(w), aw, ww)
    assert tuple(got.shape) == (b, r, n) and got.dtype == torch.float32
    for i in range(b):
        assert torch.equal(got[i], bitserial_mm.bitserial_quant_matmul(
            T(h[i]), T(w[i]), aw, ww))

    def lane(hh, wf):
        xq, xs = jbw.quantize(hh, aw, axis=-1)
        wq, ws = jbw.quantize(wf, ww, axis=0)
        acc = j_bitserial(xq.astype(jnp.int32), wq.astype(jnp.int32), aw,
                          ww, interpret=True)
        return acc.astype(jnp.float32) * xs * ws
    want = np.asarray(jax.vmap(lane)(jnp.asarray(h), jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    # (B, ..., R, K) rows flatten per batch row
    got4 = bitserial_mm.bitserial_quant_matmul(
        T(h).reshape(b, 1, r, k), T(w), aw, ww)
    assert torch.equal(got4.reshape(b, r, n), got)
    with pytest.raises(ValueError, match="per-row"):
        bitserial_mm.bitserial_quant_matmul(T(h[:2]), T(w), aw, ww)


# Fig-9q's three int-routed calls in a two-tenant wave of 8: (B, R, K, N)
FIG9Q_ROW_CALLS = {"front.taps": (8, 4096, 9, 1),
                   "mask.gemm": (8, 124, 256, 64),
                   "mel_tap.mel": (8, 31, 129, 24)}


def test_quant_rows_body_rule():
    """The per-row entry's body comes from (K, N) alone: the row body on
    the front taps, the tiles body on the mask and mel GEMMs, the chunked
    body past the tiles body's single chunk; the rule's limits are the
    edges where the body changes."""
    body = bitserial_mm.quant_rows_body
    assert {name: body(k, n) for name, (_, _, k, n)
            in FIG9Q_ROW_CALLS.items()} == {
        "front.taps": "row", "mask.gemm": "tiles", "mel_tap.mel": "tiles"}
    kern = bitserial_mm.kernel
    assert body(kern.ROW_MAX_K, kern.ROW_MAX_N) == "row"
    assert body(kern.ROW_MAX_K + 1, 1) == "tiles"
    assert body(1, kern.ROW_MAX_N + 1) == "tiles"
    assert body(kern.TILES_MAX_K, 64) == "tiles"
    assert body(kern.TILES_MAX_K + 1, 1) == "chunked"
    assert set(map(lambda kn: body(*kn), [(1, 1), (300, 200)])) <= set(
        bitserial_mm.QUANT_ROWS_BODIES)


@pytest.mark.parametrize("call", sorted(FIG9Q_ROW_CALLS))
def test_per_row_quant_matmul_at_fig9q_calls(call):
    """The plain per-row version at Fig-9q's three call shapes, batch 8,
    widths (16, 8): bit for bit the JAX package's int route (quantize x2,
    interpret-mode ``bitserial_matmul``, dequantize) under ``jax.vmap``,
    and each batch row the shared call on its own w — on whichever batch
    of rows it sits in (the first three, the whole wave)."""
    b, r, k, n = FIG9Q_ROW_CALLS[call]
    aw, ww = 16, 8
    rng = np.random.default_rng(k * 31 + n)
    h = (rng.standard_normal((b, r, k))
         * np.exp(rng.uniform(-3, 3, (b, r, 1)))).astype(np.float32)
    w = (rng.standard_normal((b, k, n))
         * np.exp(rng.uniform(-2, 2, (b, 1, n)))).astype(np.float32)
    got = bitserial_mm.bitserial_quant_matmul(T(h), T(w), aw, ww)

    def lane(hh, wf):
        xq, xs = jbw.quantize(hh, aw, axis=-1)
        wq, ws = jbw.quantize(wf, ww, axis=0)
        acc = j_bitserial(xq.astype(jnp.int32), wq.astype(jnp.int32), aw,
                          ww, interpret=True)
        return acc.astype(jnp.float32) * xs * ws
    want = np.asarray(jax.vmap(lane)(jnp.asarray(h), jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(bitserial_mm.bitserial_quant_matmul(
        T(h[:3]), T(w[:3]), aw, ww), got[:3])
    for i in (0, b - 1):
        assert torch.equal(got[i], bitserial_mm.bitserial_quant_matmul(
            T(h[i]), T(w[i]), aw, ww))


# -- bitserial planes of any count -----------------------------------------

PLANE_COUNTS = [(pa, pw) for pa in (3, 5, 8) for pw in (3, 5, 8)] \
    + [(9, 2), (1, 11), (2, 4)]


def _emulate_any_planes(a, w):
    """numpy emulation of the CUDA body of any plane count: planes past
    the eighth not read, pairs with i + j < 8 only, each shift's int32
    sum wrapping, then the uint32 shift-add."""
    pa, pw = min(a.shape[0], 8), min(w.shape[0], 8)
    acc = np.zeros((a.shape[1], w.shape[2]), np.uint64)
    for s in range(8):
        part = np.zeros_like(acc, dtype=np.int64)
        for i in range(pa):
            if 0 <= s - i < pw:
                part += a[i].astype(np.int64) @ w[s - i].astype(np.int64)
        part = (part.astype(np.uint64) & 0xFFFFFFFF)
        acc = (acc + (part << np.uint64(4 * s))) & 0xFFFFFFFF
    return acc.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("pa,pw", PLANE_COUNTS)
def test_planes_of_any_count_match_the_tpu_kernel(pa, pw):
    """``bitserial_matmul_planes`` on pa x pw int8 planes of any digits
    (the whole int8 range, so sums wrap the accumulator) against the JAX
    package's Pallas kernel run in interpret mode over a (2, 1, 3) grid:
    bit for bit, pairs whose shift 4 (i + j) reaches 32 and more adding
    nothing, as ``lax.shift_left`` gives; and the numpy emulation of the
    CUDA body of any count."""
    rng = np.random.default_rng(pa * 16 + pw)
    m, k, n = 16, 48, 8
    a = rng.integers(-128, 128, (pa, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (pw, k, n)).astype(np.int8)
    want = np.asarray(j_planes(jnp.asarray(a), jnp.asarray(w), bm=8, bn=8,
                               bk=16, interpret=True))
    got = bitserial_mm.bitserial_matmul_planes(T(a), T(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_emulate_any_planes(a, w), want)
    assert (pa + pw - 2 >= 8) == any(
        4 * (i + j) >= 32 for i in range(pa) for j in range(pw))


# -- per-row params through the backends -----------------------------------

def _grouped_program(steps):
    """One stage of ``steps`` grouped einsums (rows (G=3, nb=2), t 4,
    operand (3, 4, 4)), each a learnable operand ``w<i>``."""
    es = [EinsumStep(f"bf.m{i}", "...gnt,gto->...gno",
                     np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
                     reshape_in=(3, 2, 4), out_rank=3, rows=6, cin=4,
                     cout=4, param_key=f"w{i}") for i in range(steps)]
    t = SigType((24,), False, "samples")
    st = StageProgram("bf", ("input",), None, es, t)
    return ExecProgram("p", [st], ("bf",), t, {"bf": t}, True, 2)


@pytest.mark.parametrize("steps", [1, 2], ids=["grouped", "chain"])
@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_grouped_and_chain_units_take_row_params(backend, steps):
    """The grouped unit (one step) and the chain unit (two) of ``hopper``
    and the plain path of ``reference`` on row-stacked operands: each
    row equals the program run on that row alone with its own
    operands."""
    bound = tsig.backends.get_backend(backend).bind(_grouped_program(steps))
    if backend == "hopper":
        assert len(bound.chain_report()) == (steps > 1)
    rng = np.random.default_rng(steps)
    b = 3
    x = T(rng.standard_normal((b, 24)).astype(np.float32))
    ws = {f"w{i}": T(rng.standard_normal((b, 3, 4, 4)).astype(np.float32))
          for i in range(steps)}
    with torch.no_grad():
        got = bound(x, {"bf": ws}, row_params=True)
        for i in range(b):
            one = bound(x[i:i + 1], {"bf": {k: v[i] for k, v in ws.items()}})
            torch.testing.assert_close(got[i], one[0], rtol=RTOL, atol=ATOL)
            if backend == "hopper":
                assert torch.equal(got[i], one[0])


def test_int_unit_takes_row_params():
    """The int-routed unit on a row-stacked operand: one call of the
    quantized GEMM with w (B, t, c), each row bit for bit the row alone
    with its own taps; its straight-through gradient per row."""
    g = tsig.SignalGraph("q")
    g.fir("out", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.outputs("out")
    backend = HopperBackend(precision=PrecisionPolicy(widths={"out": (16,
                                                                      8)}))
    c = g.compile(64, backend=backend, device="cpu")
    assert c.lowering_report()["array_passes"]["int_routed"] == 1
    rng = np.random.default_rng(2)
    taps = T(rng.standard_normal((3, 9)).astype(np.float32))
    x = T(rng.standard_normal((3, 64)).astype(np.float32))
    with torch.no_grad():
        got = c.per_row(x, {"out": {"taps": taps}})["out"]
        for i in range(3):
            assert torch.equal(got[i], c(x[i:i + 1],
                                         {"out": {"taps": taps[i]}})["out"][0])
    tp = taps.clone().requires_grad_(True)
    c.per_row(x, {"out": {"taps": tp}})["out"].sum().backward()
    for i in range(3):
        ti = taps[i].clone().requires_grad_(True)
        c(x[i:i + 1], {"out": {"taps": ti}})["out"].sum().backward()
        torch.testing.assert_close(tp.grad[i], ti.grad, rtol=1e-5,
                                   atol=1e-5)


def test_biquad_takes_one_row_of_coefficients_a_batch_row():
    """``biquad_apply`` with (B, 3) coefficients: row i bit for bit the
    filter of row i with its own (3,) coefficients, over a (B, C, L)
    input too; a (3,) pair on one side and (B, 3) on the other
    broadcasts."""
    rng = np.random.default_rng(0)
    x = T(rng.standard_normal((3, 2, 40)).astype(np.float32))
    b = T(rng.uniform(0.1, 0.3, (3, 3)).astype(np.float32))
    a = T(np.stack([[1.0, -0.5 + 0.1 * i, 0.25] for i in range(3)])
          .astype(np.float32))
    y, zf = biquad_apply(x, b, a)
    y2, _ = biquad_apply(x, b, a[0])
    for i in range(3):
        yi, zi = biquad_apply(x[i], b[i], a[i])
        assert torch.equal(y[i], yi) and torch.equal(zf[i], zi)
        assert torch.equal(y2[i], biquad_apply(x[i], b[i], a[0])[0])


def test_learnable_window_takes_one_window_a_batch_row():
    """The STFT's learnable window, one ``(frame,)`` a batch row, on both
    backends: each row equals the row alone with its own window."""
    g = tsig.SignalGraph("w")
    g.stft("spec", frame=32, hop=16, window="learnable")
    g.istft("out", "spec", hop=16)
    g.outputs("out")
    rng = np.random.default_rng(4)
    win = T(rng.random((3, 32)).astype(np.float32))
    x = T(rng.standard_normal((3, 128)).astype(np.float32))
    for backend in ("reference", "hopper"):
        c = g.compile(128, backend=backend, device="cpu")
        with torch.no_grad():
            got = c.per_row(x, {"spec": {"window": win}})["out"]
            for i in range(3):
                torch.testing.assert_close(
                    got[i], c(x[i:i + 1], {"spec": {"window": win[i]}}
                              )["out"][0], rtol=RTOL, atol=ATOL)


def test_resolve_operand_of_row_params():
    """``resolve_operand`` of a row-stacked entry is the stacked operand
    (``row_operand`` tells it apart), and the static one where the entry
    does not hold the step's key."""
    e = _grouped_program(1).stages[0].steps[0]
    op = torch.ones((2, 3, 4, 4))
    assert resolve_operand(e, RowParams({"w0": op})) is op
    assert row_operand(e, RowParams({"w0": op})) is op
    assert resolve_operand(e, RowParams({"other": op})) is e.operand
    assert row_operand(e, {"w0": op}) is None
