"""The shuffle-GEMM kernels of the PyTorch port against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels in interpret mode, the way
its own tests run them, with the same numpy inputs: rtol = atol = 1e-5 in
float32 and 2e-2 in bfloat16 (the reference suite's tolerances,
``tests/test_kernels.py``).  The CUDA kernels themselves are held against
the plain versions on the card in ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import signal_mapping as jsm
from repro.kernels import shuffle_gemm as j_gemm
from repro.kernels import shuffle_gemm_grouped as j_grouped
from repro_torch import kernels as tk
from repro_torch.core import fabric as tfab
from repro_torch.kernels import shuffle_gemm as t_gemm
from repro_torch.kernels import shuffle_gemm_grouped as t_grouped
from repro_torch.kernels.shuffle_gemm import (
    launch_counts, ref_shuffle_gemm, ref_shuffle_gemm_blocks,
    ref_shuffle_gemm_grouped_blocks, shuffle_gemm_blocks,
    shuffle_gemm_grouped_blocks)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _plans(rng, n, rows, t, with_pad):
    """The FIR im2col plan (causal PAD entries) or a PAD-free random
    gather, as the same numpy arrays for both packages."""
    if with_pad:
        p = jsm.make_fir_plan(n, t).im2col
        gi, pv = p.gather_idx, p.pad_values
    else:
        gi = rng.integers(0, n, rows * t).astype(np.int32)
        pv = np.zeros(rows * t, np.int64)
    return jfab.ShufflePlan(gi, pv), tfab.ShufflePlan(gi, pv)


def _compare(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])


# -- the plain versions against the JAX package's kernels --------------------

@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("with_pad", [True, False])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,t,feat", [(64, 5, 1), (96, 7, 4), (256, 16, 8)])
def test_shuffle_gemm_matches_reference(n, t, feat, dt, with_pad, scaled):
    rng = np.random.default_rng(n + t + 10 * with_pad + 100 * scaled)
    jp, tp = _plans(rng, n, n, t, with_pad)
    x = rng.standard_normal((2, n)).astype(np.float32)
    w = rng.standard_normal((t, feat)).astype(np.float32)
    diag = rng.standard_normal(n * t).astype(np.float32) if scaled else None
    want = j_gemm(jnp.asarray(x, JDT[dt]), jp, jnp.asarray(w, JDT[dt]),
                  rows=n, interpret=True, diag=diag)
    got = t_gemm(torch.as_tensor(x).to(TDT[dt]), tp,
                 torch.as_tensor(w).to(TDT[dt]), rows=n, diag=diag)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (2, n, feat)
    _compare(got, want, dt)
    if not scaled:      # the unfused oracle: apply_plan, then a matmul
        _compare(ref_shuffle_gemm(torch.as_tensor(x).to(TDT[dt]), tp,
                                  torch.as_tensor(w).to(TDT[dt]), rows=n),
                 want, dt)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("with_pad", [True, False])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 8])
def test_grouped_fig9_layout_matches_reference(groups, dt, with_pad,
                                               scaled):
    """The Fig-9 butterfly layout: t 4, n_out 4, rows (reps, G, nb) with
    reps 3 and G * nb = 16."""
    reps, t, n_out, nb = 3, 4, 4, 16 // groups
    rows = reps * groups * nb
    n_in = rows * t // 2
    rng = np.random.default_rng(groups + 10 * with_pad + 100 * scaled)
    gi = rng.integers(0, n_in, rows * t).astype(np.int32)
    pv = np.zeros(rows * t, np.float32)
    if with_pad:
        gi[rng.random(rows * t) < 0.25] = jfab.PAD
        pv = rng.standard_normal(rows * t).astype(np.float32)
    jp, tp = jfab.ShufflePlan(gi, pv), tfab.ShufflePlan(gi, pv)
    x = rng.standard_normal((2, n_in)).astype(np.float32)
    w = rng.standard_normal((groups, t, n_out)).astype(np.float32)
    diag = rng.standard_normal(rows * t).astype(np.float32) if scaled \
        else None
    want = j_grouped(jnp.asarray(x, JDT[dt]), jp, jnp.asarray(w, JDT[dt]),
                     reps, groups, nb, interpret=True, diag=diag)
    got = t_grouped(torch.as_tensor(x).to(TDT[dt]), tp,
                    torch.as_tensor(w).to(TDT[dt]), reps, groups, nb,
                    diag=diag)
    assert tuple(got.shape) == (2, rows * n_out)
    _compare(got, want, dt)


def test_fft_stage_as_grouped_gemm_matches_reference():
    """A real FFT stage (gather plan + (half, 4, 4) twiddles) through the
    grouped op of both packages."""
    n = 64
    st = jsm.make_fft_plan(n, fuse_adjacent=False).stages[2]
    x = np.random.default_rng(1).standard_normal((3, 2 * n)).astype(
        np.float32)
    tw = np.asarray(st.twiddle)
    want = j_grouped(jnp.asarray(x), st.gather, jnp.asarray(tw), 1, st.half,
                     st.nb, interpret=True)
    tp = tfab.ShufflePlan(st.gather.gather_idx, st.gather.pad_values)
    got = t_grouped(torch.as_tensor(x), tp, torch.as_tensor(tw), 1,
                    st.half, st.nb)
    _compare(got, want, "float32")


# -- the wrappers' contract ----------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 40)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, 40, (10, 4)).astype(np.int32))
    pad = torch.as_tensor(rng.standard_normal((10, 4)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((4, 3)).astype(np.float32))
    before = launch_counts()
    got = shuffle_gemm_blocks(x, idx, pad, w)
    torch.testing.assert_close(got, ref_shuffle_gemm_blocks(x, idx, pad, w),
                               rtol=0, atol=0)
    wg = torch.as_tensor(rng.standard_normal((2, 4, 3)).astype(np.float32))
    got = shuffle_gemm_grouped_blocks(x, idx, pad, wg, 1, 2, 5)
    torch.testing.assert_close(
        got, ref_shuffle_gemm_grouped_blocks(x, idx, pad, wg, 1, 2, 5),
        rtol=0, atol=0)
    assert launch_counts() == before


@pytest.mark.parametrize("grouped", [False, True])
def test_non_cpu_tensor_never_falls_back(grouped):
    """A tensor off the CPU goes to the kernel or raises: a ``meta`` tensor
    (no card needed) is refused, not computed by the plain version."""
    x = torch.empty((2, 40), device="meta")
    idx = torch.empty((10, 4), dtype=torch.int32, device="meta")
    pad = torch.empty((10, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if grouped:
            shuffle_gemm_grouped_blocks(
                x, idx, pad, torch.empty((2, 4, 3), device="meta"), 1, 2, 5)
        else:
            shuffle_gemm_blocks(x, idx, pad,
                                torch.empty((4, 3), device="meta"))


def test_plan_reading_past_the_input_is_refused():
    gi = np.array([0, 1, 2, 9], np.int32)
    plan = tfab.ShufflePlan(gi, np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="index 9"):
        t_gemm(torch.zeros((1, 8)), plan, torch.ones((2, 1)), rows=2)


def test_compiled_supported_false_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tk.compiled_supported() is False


def test_build_digest_covers_sources_and_flags():
    d = tk._digest()
    assert len(d) == 16 and d == tk._digest()
    assert tk.build_dir().name == "repro_torch_kernels"
    assert "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS


# -- the staged body's row tiles, spans and layout ---------------------------

from repro_torch.kernels.shuffle_gemm.kernel import blocks_tiling  # noqa: E402
from repro_torch.kernels.shuffle_gemm.tiling import (  # noqa: E402
    GATHER, MIN_WORK, NB, PADDED, RUN, SHARED_BYTES, RowSpans,
    staged_tiling)


def _brute_spans(idx, rt):
    """Per tile of ``rt`` rows, (lo, hi) of its non-PAD indices by a loop
    over every entry; (0, 0) where it reads none."""
    out = []
    for r0 in range(0, idx.shape[0], rt):
        read = [int(i) for i in idx[r0:r0 + rt].ravel() if i >= 0]
        out.append((min(read), max(read) + 1) if read else (0, 0))
    return np.array(out, np.int32).reshape(-1, 2)


def _tables(kind, rng):
    """(idx, pads, scale) numpy tables: the FIR im2col plan (causal PAD
    entries of value 0), the 8-phase FIR's windows, in-order rows (DCT,
    mel frames), a circular window (db2), a random gather with PAD
    entries of random value and a scale, and rows of PAD only."""
    if kind == "fir":
        p = jsm.make_fir_plan(256, 20).im2col
        idx = p.gather_idx.reshape(256, 20)
        return idx, np.asarray(p.pad_values).reshape(idx.shape), None
    if kind == "phased":
        idx = 8 * np.arange(32)[:, None] + 7 - np.arange(87)[None, :]
        idx = np.where(idx < 0, -1, idx)
        return idx, np.zeros(idx.shape), None
    if kind == "in_order":
        idx = np.arange(31 * 129).reshape(31, 129)
        return idx, np.zeros(idx.shape), None
    if kind == "circular":
        idx = (2 * np.arange(512)[:, None] + np.arange(4)[None, :]) % 1024
        return idx, np.zeros(idx.shape), None
    if kind == "random":
        idx = rng.integers(0, 300, (37, 9))
        idx[rng.random(idx.shape) < 0.3] = -1
        return idx, rng.standard_normal(idx.shape), \
            rng.standard_normal(idx.shape)
    idx = np.full((40, 3), -1)
    idx[:10] = rng.integers(0, 50, (10, 3))
    return idx, np.zeros(idx.shape), None


@pytest.mark.parametrize("rt", [1, 3, 8, 32, 256, 1000])
@pytest.mark.parametrize("kind", ["fir", "phased", "in_order", "circular",
                                  "random", "pad_rows"])
def test_row_spans_match_a_brute_force_span(kind, rt):
    """RowSpans' (lo, hi) of every row tile, from the numpy plan, equal a
    loop over the table's entries, for tiles of 1 to more than every
    row; their affine form, where it has one, holds every tile's span
    within its width; the mode says how the kernel reads the table (a
    contiguous run, PAD entries, a plain gather) and whether its PAD
    values need a table."""
    rng = np.random.default_rng(len(kind) * rt)
    idx, pads, scale = _tables(kind, rng)
    spans = RowSpans(idx, pads, scale)
    want = _brute_spans(idx, rt)
    np.testing.assert_array_equal(spans.tiles(rt), want)
    assert spans.max_span(rt) == int((want[:, 1] - want[:, 0]).max())
    assert spans.staged(rt) == int((want[:, 1] - want[:, 0]).sum())
    assert (spans.mode, spans.zero_pads) == {
        "fir": (PADDED, True), "phased": (PADDED, True),
        "in_order": (RUN, True), "circular": (GATHER, True),
        "random": (PADDED, False), "pad_rows": (PADDED, True)}[kind]
    aff = spans.affine(rt)
    if kind in ("fir", "phased", "in_order"):
        assert aff is not None
    if aff is not None:
        step, hi0, length = aff
        assert length == spans.max_span(rt)
        for q, (lo, hi) in enumerate(want):
            if hi > lo:
                assert max(0, hi0 + q * step - length) <= lo
                assert hi0 + q * step >= hi
    assert torch.equal(spans.on(rt, "cpu"), torch.as_tensor(want))


def _staged_ok(tl, t, n_out, es, scaled):
    """The checks launch_staged makes of a layout (csrc/shuffle_gemm.cu)."""
    table = (tl.rt - 1) * tl.rs + t
    nxt = [o for o in (tl.off_pad, tl.off_scale, tl.off_buf) if o >= 0]
    return (tl.rt >= 1 and tl.bg >= 1 and 32 <= tl.threads <= 256
            and tl.threads % 32 == 0 and tl.no in (1, 4)
            and n_out % tl.no == 0 and tl.split == (t >= 32)
            and (tl.lanes == 1 or (tl.lanes == 8 and tl.split))
            and tl.ws >= n_out and tl.ws % tl.no == 0 and tl.rs >= t
            and tl.row_bytes % 16 == 0 and tl.row_bytes >= 16
            and t * tl.ws * es <= tl.off_idx and tl.off_idx % 16 == 0
            and tl.off_buf % 16 == 0 and tl.off_idx + 4 * table <= nxt[0]
            and (tl.off_pad < 0 or (tl.off_pad % 16 == 0
                                    and tl.off_pad + es * table <= (
                                        tl.off_scale if tl.off_scale >= 0
                                        else tl.off_buf)))
            and (tl.off_scale < 0 or (tl.off_scale % 16 == 0 and
                                      tl.off_scale + es * table
                                      <= tl.off_buf))
            and (tl.off_scale >= 0) == scaled
            and (tl.off_pad < 0 or tl.mode == PADDED)
            and tl.off_buf + 2 * tl.bg * tl.nb * tl.row_bytes <= tl.total
            <= SHARED_BYTES
            and tl.nb == NB[(tl.split, tl.lanes, tl.no)]
            and tl.ws == n_out and tl.wxor in (0, 7))


# Fig 9's and the paper suite's shared-operand calls, with their backward
# calls: (rows, t, n_out, n_in, table kind); those of fewer than MIN_WORK
# multiply-adds an output (Fig 9's FIR, the DWTs) take the sequential body
STAGED_CALLS = [(31, 129, 24, 3999, "order"),
                (256, 20, 1, 256, "causal"), (256, 40, 1, 256, "causal"),
                (256, 80, 1, 256, "causal"), (32, 87, 8, 256, "phased"),
                (1, 32, 32, 32, "order"), (16384, 80, 1, 16384, "causal"),
                (31, 513, 64, 15903, "order"), (31, 64, 513, 1984, "order"),
                (37, 300, 64, 500, "random")]
SEQUENTIAL_CALLS = [(4096, 9, 1, 4096, "causal"), (512, 2, 2, 1024, "order"),
                    (512, 4, 2, 1024, "circular"),
                    (16384, 2, 1, 63488, "order")]


def _call_table(kind, rows, t, n_in, rng):
    if kind == "causal":
        idx = np.arange(rows)[:, None] - np.arange(t)[None, :]
        return np.where(idx < 0, -1, idx)
    if kind == "phased":
        idx = 8 * np.arange(rows)[:, None] + 7 - np.arange(t)[None, :]
        return np.where(idx < 0, -1, idx)
    if kind == "circular":
        return (2 * np.arange(rows)[:, None] + np.arange(t)[None, :]) % n_in
    if kind == "order":
        return np.arange(rows * t).reshape(rows, t)
    idx = rng.integers(0, n_in, (rows, t))
    idx[rng.random(idx.shape) < 0.2] = -1
    return idx


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("call", STAGED_CALLS, ids=lambda c: "x".join(
    map(str, c[:3])))
def test_staged_tiling_takes_every_suite_call(call, es):
    """Every shared-operand call of Fig 9 and the paper suite (and their
    backward calls) takes the staged body with its plan's spans, in a
    layout the launch accepts: regions aligned and apart, within
    SHARED_BYTES, one of the kernel's instances; the tile's threads at
    most one a column of 256."""
    rows, t, n_out, n_in, kind = call
    idx = _call_table(kind, rows, t, n_in, np.random.default_rng(rows))
    spans = RowSpans(idx, np.zeros(idx.shape))
    for scaled in (False, True):
        tl = staged_tiling(rows, t, n_out, es, scaled, spans)
        assert tl is not None and _staged_ok(tl, t, n_out, es, scaled)
        assert tl.span == spans.max_span(tl.rt)
        assert tl.rt * n_out // tl.no * tl.lanes <= 256 or tl.rt == 1
        assert tl.affine is not None or kind == "random"


@pytest.mark.parametrize("call", SEQUENTIAL_CALLS, ids=lambda c: "x".join(
    map(str, c[:3])))
def test_rows_of_few_multiply_adds_take_the_sequential_body(call):
    """A call whose output is a sum of fewer than MIN_WORK products (t x
    n_out: Fig 9's 9-tap FIR, the DWTs, the framing adjoints) takes no
    staged tiling, with or without spans."""
    rows, t, n_out, n_in, kind = call
    assert t * n_out < MIN_WORK
    idx = _call_table(kind, rows, t, n_in, np.random.default_rng(rows))
    assert staged_tiling(rows, t, n_out, 4, False, RowSpans(idx)) is None


def _emulate_staged(x, idx, pads, w, scale, spans, tl, base):
    """The staged body's addressing and arithmetic in numpy, for x whose
    storage starts ``base`` bytes past a 16-byte boundary: per tile and
    batch row, the 16-byte chunks from the one holding x[b, lo] to the one
    holding x[b, hi - 1] must fit ``row_bytes``; each read lands inside
    them; the sum runs in the kernel's order (one chain below t 32, eight
    partials combined by the fixed tree from 32)."""
    b_, n_in = x.shape
    rows, t = idx.shape
    es = x.itemsize
    tiles = spans.tiles(tl.rt) if spans is not None else \
        np.array([[0, n_in]] * -(-rows // tl.rt))
    out = np.zeros((b_, rows, w.shape[1]), np.float32)
    for q, (lo, hi) in enumerate(tiles):
        for b in range(b_):
            first, end = base + (b * n_in + lo) * es, base + (b * n_in + hi) * es
            chunks = (-(-end // 16) - first // 16) if hi > lo else 0
            assert chunks * 16 <= tl.row_bytes
            shift = first % 16
            for r in range(q * tl.rt, min(rows, (q + 1) * tl.rt)):
                vals = []
                for k in range(t):
                    i = int(idx[r, k])
                    if i < 0:
                        v = np.float32(pads[r, k])
                    else:
                        at = shift + (i - lo) * es
                        assert 0 <= at and at + es <= chunks * 16
                        v = np.float32(x[b, i])
                    if scale is not None:
                        v = np.float32(v * np.float32(scale[r, k]))
                    vals.append(v)
                vals = np.array(vals, np.float32)
                for o in range(w.shape[1]):
                    prod = vals.astype(np.float64) * w[:, o]
                    if t < 32:
                        acc = np.float32(0)
                        for p_ in prod:
                            acc = np.float32(acc + p_)
                    else:
                        p8 = []
                        for l_ in range(8):
                            acc = np.float32(0)
                            for p_ in prod[l_::8]:
                                acc = np.float32(acc + p_)
                            p8.append(acc)
                        acc = np.float32(
                            np.float32(np.float32(p8[0] + p8[4])
                                       + np.float32(p8[2] + p8[6]))
                            + np.float32(np.float32(p8[1] + p8[5])
                                         + np.float32(p8[3] + p8[7])))
                    out[b, r, o] = acc
    return out


@pytest.mark.parametrize("base", [0, 4, 12])
@pytest.mark.parametrize("rows,t,n_out,n_in,kind", [
    (24, 17, 1, 30, "causal"), (6, 9, 4, 21, "random"),
    (4, 40, 4, 300, "random"), (3, 70, 1, 90, "phased")])
def test_staged_addressing_reads_inside_each_span(rows, t, n_out, n_in,
                                                  kind, base):
    """The staged body's addressing emulated over odd row lengths and
    misaligned rows: every read inside the chunks its span copies, and
    the values those of the JAX package's kernel (interpret mode) at the
    float32 tolerance."""
    rng = np.random.default_rng(rows * t + base)
    idx = _call_table(kind, rows, t, n_in, rng).astype(np.int32)
    pads = rng.standard_normal(idx.shape).astype(np.float32)
    scale = rng.standard_normal(idx.shape).astype(np.float32) \
        if kind == "random" else None
    x = rng.standard_normal((3, n_in)).astype(np.float32)
    w = rng.standard_normal((t, n_out)).astype(np.float32)
    spans = RowSpans(idx, pads, scale)
    tl = staged_tiling(rows, t, n_out, 4, scale is not None, spans)
    got = _emulate_staged(x, idx, pads, w, scale, spans, tl, base)
    plan = jfab.ShufflePlan(idx.ravel(), pads.ravel())
    want = j_gemm(jnp.asarray(x), plan, jnp.asarray(w), rows,
                  interpret=True,
                  diag=None if scale is None else scale.ravel())
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)


def test_blocks_tiling_reads_the_call_and_never_the_batch():
    """A blocks call gets a staged tiling for a shared operand with spans
    and rows of MIN_WORK multiply-adds or more; none (the launch's wide
    or sequential body) for a per-row operand, a call without spans or
    rows of fewer; the same at 1 and 70000 batch rows."""
    causal = _call_table("causal", 4096, 20, 4096, None)
    idx = torch.zeros((4096, 20), dtype=torch.int32)
    for b in (1, 70000):
        x = torch.empty((b, 4096))
        tl = blocks_tiling(x, idx, torch.empty((20, 1)),
                           spans=RowSpans(causal))
        assert tl is not None and tl == blocks_tiling(
            x[:1], idx, torch.empty((20, 1)), spans=RowSpans(causal))
        assert blocks_tiling(x, idx, torch.empty((20, 1))) is None
        assert blocks_tiling(x, idx[:, :9], torch.empty((9, 1)),
                             spans=RowSpans(causal[:, :9])) is None
        assert blocks_tiling(x, idx, torch.empty((b, 20, 1)),
                             spans=RowSpans(causal)) is None
