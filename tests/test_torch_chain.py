"""Chains of shuffle-GEMM steps in the PyTorch port: segmentation, tiles,
the plain version, the lowering and the backward.

``kernels/shuffle_gemm/chain.py`` cuts a list of grouped gather∘GEMM
sub-steps (sub-step s + 1 gathering from sub-step s's output) into
segments of one launch each, and each segment's vectors into equal tiles
no sub-step reads across.  Held here on the CPU:

  * Fig 9's two forward chains (STFT and iSTFT butterflies) are one
    segment of 8 each, 31 tiles of 512 floats a batch row (124 at batch
    4); their backward lists cut as the kernel design expects (the iSTFT's
    16 sub-steps in one launch, the STFT's first 15, then the framing
    adjoint alone on ``shuffle_gemm_blocks``);
  * a sub-step that reads across the tiles of every tiling that fits
    forces a cut; one that reads within halves gives two tiles;
  * the chain's plain version equals (``torch.equal``) its sub-steps'
    plain versions one after another, and a numpy emulation of the CUDA
    kernel's tile-by-tile indexing (rebased, periodic tables) gives the
    same values (rtol = atol = 1e-6: the emulation sums in numpy's
    order);
  * a chain through the port equals the JAX package's grouped op
    (Pallas, interpret mode) applied sub-step by sub-step, rtol = atol =
    1e-5 (the reference suite's float32 tolerance);
  * ``ShuffleGemmChainFn``'s gradients (the backward chain, and the
    per-step replay where a ``w`` needs a gradient) equal the per-step
    ``ShuffleGemmFn`` path's (``torch.equal``: the same plain versions in
    the same order).

The CUDA chain kernel against its sub-steps launched one by one is in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.kernels import shuffle_gemm_grouped as j_grouped
from repro_torch.core.fabric import PAD, ShufflePlan
from repro_torch.kernels.shuffle_gemm import (
    ShuffleGemmChain, ref_shuffle_gemm_chain, ref_shuffle_gemm_grouped_blocks,
    run_chain, shuffle_gemm_chain, shuffle_gemm_grouped)
from repro_torch.kernels.shuffle_gemm.chain import (
    SHARED_BYTES, SubStep, best_tiles, segment_chain, shared_bytes, swizzle)
from repro_torch.kernels.shuffle_gemm.kernel import chain_steps, ref_chain
from repro_torch.kernels.shuffle_gemm.vjp import backward_chain
from repro_torch.pipelines import speech_enhancement as tse

LENGTH, BATCH = 4096, 4


@pytest.fixture(scope="module")
def fig9():
    return tse.build_graph(LENGTH).compile(LENGTH, fuse=2, backend="hopper",
                                           device="cpu")


def _chains(compiled):
    return {c["stage"]: c for c in compiled.chain_report()}


def _fig9_chain(compiled, stage):
    """The bound chain of ``stage`` (the lowering's own object)."""
    fn = compiled._exec.stage_fns[stage]
    (chain,) = fn.chains
    return chain


# -- segmentation and tiles ---------------------------------------------------

def test_fig9_forward_chains_are_one_segment_of_8(fig9):
    chains = _chains(fig9)
    assert sorted(chains) == ["out", "spec"]
    for stage, c in chains.items():
        assert c["steps"] == [f"{stage}.s{i}.butterfly" for i in range(8)]
        (seg,) = c["segments"]
        assert seg["launch"] == "shuffle_gemm_chain"
        assert seg["steps"] == c["steps"]
        # 31 frames a batch row: 124 tiles of 512 floats at batch 4
        assert seg["tiles"] * BATCH == 124 and seg["tile_floats"] == 512
        # up to 16 tiles (2048 rows) a block at once; the launch takes
        # fewer where the batch is small
        assert seg["tiles_per_cta"] == 16
        assert seg["periodic"] == [False] + [True] * 7
        assert seg["shared_bytes"] <= SHARED_BYTES
    # the per-step routes stay the JAX package's
    rep = fig9.lowering_report()
    assert rep["routes"]["fused_grouped"] == 16
    assert rep["routes"]["fused_gemm"] == 2


def test_fig9_backward_lists_are_cut_at_the_framing_adjoint(fig9):
    """Each butterfly's adjoint reduction has width 1 (a permutation) and
    folds into the next transposed GEMM's gather; the STFT framing's
    (frames overlap by the hop: width 2) reads across tiles and runs
    alone on ``shuffle_gemm_blocks``."""
    spec, operands = backward_chain(_fig9_chain(fig9, "spec"), LENGTH)
    assert operands == tuple(("w", i) for i in reversed(range(8))) \
        + (("ones", 2),)
    first, framing = spec.segments
    assert first.launch == "shuffle_gemm_chain"
    assert len(first.steps) == 8 and first.tiles == 31
    assert [s.name for s in first.steps][:2] == [
        "spec.s7.butterfly.transpose",
        "spec.s7.butterfly.adjoint+spec.s6.butterfly.transpose"]
    assert framing.launch == "shuffle_gemm_blocks"
    (adj,) = framing.steps
    assert adj.name == "spec.s0.butterfly.adjoint"
    assert (adj.rows, adj.t, adj.n_out) == (LENGTH, 2, 1)
    assert int((adj.plan.gather_idx == PAD).sum()) == 256
    out_chain = _fig9_chain(fig9, "out")
    out, operands = backward_chain(
        out_chain, out_chain.steps[0].plan.gather_idx.max() + 1)
    assert operands[-1] == ("ones", 1)      # nothing after it to fold into
    (seg,) = out.segments
    assert seg.launch == "shuffle_gemm_chain" and len(seg.steps) == 9
    assert seg.tiles == 31


def _perm_step(name, rows, t, n_out, perm, groups=1):
    return SubStep(name, ShufflePlan(perm.astype(np.int32),
                                     np.zeros(perm.size, np.float32)),
                   None, rows, n_out, groups)


def test_reads_across_tiles_force_a_cut():
    """Sub-step 2 a random permutation of a 65,536-float vector: no tiling
    of more than one tile holds it, and one tile (two 256 KB buffers)
    does not fit shared memory."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    a = _perm_step("a", n // 4, 4, 4, np.arange(n))
    b = _perm_step("b", n // 4, 4, 4, rng.permutation(n))
    assert best_tiles([a, b]) == 1
    assert shared_bytes([a, b], 1, 1, (False, False)) > SHARED_BYTES
    segs = segment_chain([a, b])
    assert [s.launch for s in segs] == ["shuffle_gemm_blocks"] * 2


def test_reads_within_halves_give_two_tiles():
    rng = np.random.default_rng(1)
    n = 1 << 12
    half = np.concatenate([rng.permutation(n // 2),
                           n // 2 + rng.permutation(n // 2)])
    a = _perm_step("a", n // 4, 4, 4, rng.integers(0, 100, n))
    b = _perm_step("b", n // 4, 4, 4, half)
    (seg,) = segment_chain([a, b])
    assert seg.launch == "shuffle_gemm_chain" and seg.tiles == 2
    assert seg.periodic == (False, False)


def test_small_random_chain_is_one_tile_a_batch_row():
    """A random permutation over a vector that fits shared memory whole:
    no partition, one tile a batch row."""
    rng = np.random.default_rng(2)
    n = 1 << 10
    steps = [_perm_step(f"s{i}", n // 4, 4, 4, rng.permutation(n))
             for i in range(3)]
    (seg,) = segment_chain(steps)
    assert seg.launch == "shuffle_gemm_chain" and seg.tiles == 1
    assert seg.slot_rows == 256


def test_segment_refuses_a_step_reading_past_its_input():
    a = _perm_step("a", 8, 4, 1, np.arange(32))
    b = _perm_step("b", 8, 4, 4, np.arange(32))     # a writes only 8
    with pytest.raises(ValueError, match="reads past"):
        segment_chain([a, b])


# -- the plain version and the kernel's indexing ------------------------------

def _random_chain(rng, tiles=3, rpt=8, t=4, n_out=4, groups=(1, 2, 4),
                  n_in=50):
    """A chain of grouped sub-steps over ``tiles`` independent tiles:
    sub-step 1 reads anywhere in a length-``n_in`` input (PAD entries,
    a scale), later ones only within their tile (some PAD entries,
    scales on one), tables that differ by tile."""
    steps, prev = [], None
    for i, g in enumerate(groups):
        rows = tiles * rpt
        if prev is None:
            idx = rng.integers(0, n_in, (rows, t))
        else:
            ept = prev.n_elems // tiles
            idx = (np.arange(rows) // rpt * ept)[:, None] \
                + rng.integers(0, ept, (rows, t))
        idx = idx.astype(np.int32)
        if i != 1:
            idx[rng.random(idx.shape) < 0.2] = PAD
        plan = ShufflePlan(idx.ravel(), rng.standard_normal(idx.size)
                           .astype(np.float32))
        diag = None if i == 2 else rng.standard_normal(idx.size).astype(
            np.float32)
        prev = SubStep(f"s{i}", plan, diag, rows, n_out, g, rpt // g)
        steps.append(prev)
    ws = [torch.as_tensor(rng.standard_normal((s.groups, s.t, s.n_out))
                          .astype(np.float32)) for s in steps]
    return steps, ws


def _emulate(x, seg, ws):
    """The chain kernel's indexing in numpy: tile by tile, sub-step 1
    from the input with its plain tables, later sub-steps from the tile's
    buffer with the rebased (and, where periodic, shared) tables."""
    ws = [w.numpy() for w in ws]
    x = x.numpy()
    last = seg.steps[-1]
    out = np.zeros((x.shape[0], last.n_elems), np.float32)
    for b in range(x.shape[0]):
        for k in range(seg.tiles):
            buf = x[b]
            for i, s in enumerate(seg.steps):
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
                            acc = np.float32(acc + v * ws[i][g, kk, o])
                        y[r * s.n_out + o] = acc
                buf = y
            ept = last.n_elems // seg.tiles
            out[b, k * ept:(k + 1) * ept] = buf
    return out


def test_chain_plain_equals_per_step_plain_and_the_kernel_indexing():
    rng = np.random.default_rng(3)
    steps, ws = _random_chain(rng)
    (seg,) = segment_chain(steps)
    assert seg.launch == "shuffle_gemm_chain" and seg.tiles == 3
    x = torch.as_tensor(rng.standard_normal((2, 50)).astype(np.float32))
    want = x
    for idx, pads, w, reps, groups, nb, scale in chain_steps(
            seg, ws, "cpu", torch.float32):
        want = ref_shuffle_gemm_grouped_blocks(want, idx, pads, w, reps,
                                               groups, nb, scale)
    got = shuffle_gemm_chain(x, seg, ws)      # a CPU tensor: plain version
    assert torch.equal(got, want)
    assert torch.equal(ref_chain(x, seg, ws), want)
    assert torch.equal(ref_shuffle_gemm_chain(
        x, chain_steps(seg, ws, "cpu", torch.float32)), want)
    np.testing.assert_allclose(_emulate(x, seg, ws), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def _periodic_chain(rng, tiles=4, rpt=8, t=2):
    """Two sub-steps; the second reads its tile by the same rebased table
    in every tile (periodic)."""
    a = SubStep("a", ShufflePlan(rng.integers(0, 20, tiles * rpt * t)
                                 .astype(np.int32),
                                 np.zeros(tiles * rpt * t, np.float32)),
                None, tiles * rpt, 2)
    local = rng.integers(0, rpt * 2, (rpt, t))
    idx = (np.arange(tiles)[:, None, None] * rpt * 2 + local).reshape(-1)
    b = SubStep("b", ShufflePlan(idx.astype(np.int32),
                                 np.zeros(idx.size, np.float32)),
                None, tiles * rpt, 3)
    return [a, b]


def test_periodic_tables_are_stored_once():
    """Tiles whose rebased tables agree keep one tile's copy, and the
    kernel indexing still gives the plain version's values."""
    rng = np.random.default_rng(4)
    a, b = _periodic_chain(rng)
    (seg,) = segment_chain([a, b])
    assert seg.tiles == 4 and seg.periodic == (False, True)
    kern, _ = seg.device_tables("cpu", torch.float32)
    assert kern["shared"].numel() == 8 * 2 * 4       # one tile's indices
    assert kern["own"].numel() == 0
    ws = [torch.as_tensor(rng.standard_normal((1, s.t, s.n_out))
                          .astype(np.float32)) for s in (a, b)]
    x = torch.as_tensor(rng.standard_normal((3, 20)).astype(np.float32))
    np.testing.assert_allclose(_emulate(x, seg, ws),
                               ref_chain(x, seg, ws).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_packed_tables_hold_every_later_sub_steps_tables(dt):
    """The two packed buffers the kernel stages, read back at the layout's
    offsets: each later sub-step's rebased indices (swizzled where the
    sub-step before swizzles its output), PAD values and scales (one
    tile's rows where periodic, in the fixed region; else one packed row
    a tile, from the tile's own region), every region 16-byte aligned and
    inside its region of the layout."""
    rng = np.random.default_rng(7)
    steps, _ = _random_chain(rng, tiles=8, rpt=32)
    es = torch.empty((), dtype=dt).element_size()
    for steps_ in (steps, _periodic_chain(rng)):
        (seg,) = segment_chain(steps_)
        kern, _ = seg.device_tables("cpu", dt)
        lay = kern["layout"]
        assert lay.total <= SHARED_BYTES and lay.fixed % 16 == 0
        assert lay.own_bytes % 16 == 0
        for i, s in enumerate(seg.steps[1:], 1):
            per = seg.periodic[i]
            rows = s.rows // seg.tiles
            idx, pads, scale = seg.tables[i]
            # indices into a swizzled output are packed swizzled
            tables = (swizzle(idx) if seg.swz[i - 1] else idx, pads, scale)
            for off, arr, t_dt in zip(lay.steps[i][:3], tables,
                                      (torch.int32, dt, dt)):
                if off < 0:
                    continue
                n = rows * s.t * torch.empty((), dtype=t_dt).element_size()
                assert off % 16 == 0 and off + n <= (
                    lay.fixed if per else lay.own_bytes)
                for q in range(1 if per else seg.tiles):
                    buf = kern["shared"] if per else kern["own"][q]
                    o = off - lay.shared[0] if per else off
                    want = torch.as_tensor(np.ascontiguousarray(
                        arr[q * rows:(q + 1) * rows])).to(t_dt).ravel()
                    assert torch.equal(buf[o:o + n].view(t_dt), want)
    # the random chain's tables differ by tile: one own row each
    (seg,) = segment_chain(steps)
    kern, _ = seg.device_tables("cpu", dt)
    assert kern["own"].shape == (seg.tiles, kern["layout"].own_bytes)


def test_chain_layout_stages_tables_once_and_buffers_a_slot():
    """The fixed region (descriptors, periodic tables, operands) is the
    same for every slot count; each slot adds its own tables, its share
    of the two buffers (a tile of the largest buffered output each) and
    its 8-byte entry; the slots a segment takes hold at most
    MAX_BLOCK_ROWS rows and fit SHARED_BYTES, as many as both allow."""
    from repro_torch.kernels.shuffle_gemm.chain import (
        MAX_BLOCK_ROWS, MAX_SLOTS, chain_layout)
    rng = np.random.default_rng(9)
    for steps in (_random_chain(rng, tiles=8, rpt=32)[0],
                  _periodic_chain(rng),
                  _random_chain(rng, tiles=40, rpt=4)[0]):
        (seg,) = segment_chain(steps)
        lays = [chain_layout(seg.steps, seg.tiles, k, seg.periodic)
                for k in (1, 2, 5)]
        assert len({(lay.fixed, lay.shared, lay.steps, lay.own_bytes,
                     lay.buf_floats) for lay in lays}) == 1
        lay = lays[0]
        assert lay.buf_floats == max(s.n_elems // seg.tiles
                                     for s in seg.steps[:-1])
        for k, lk in zip((1, 2, 5), lays):
            assert lk.total == (lay.fixed + k * lay.own_bytes
                                + 2 * -(-4 * k * lay.buf_floats // 16) * 16)
        operands = sum(-(-4 * s.groups * s.t * s.n_out // 16) * 16
                       for s in seg.steps[1:])
        assert lay.fixed == -(-88 * len(seg.steps) // 16) * 16 \
            + lay.shared[1] + operands
        assert not lay.perms[0] and all(
            p == (s.t == s.n_out == 4 and s.groups > 1 and s.nb < 8)
            for s, p in zip(seg.steps[1:], lay.perms[1:]))
        rows = max(s.rows // seg.tiles for s in seg.steps)
        slots = seg.tiles_per_cta
        assert 1 <= slots <= MAX_SLOTS and slots * rows <= max(
            rows, MAX_BLOCK_ROWS)
        assert shared_bytes(seg.steps, seg.tiles, slots,
                            seg.periodic) <= SHARED_BYTES
        if slots < min(MAX_SLOTS, MAX_BLOCK_ROWS // rows):
            assert shared_bytes(seg.steps, seg.tiles, slots + 1,
                                seg.periodic) > SHARED_BYTES


def test_chain_matches_jax_grouped_op_step_by_step():
    """The port's run_chain against the JAX package's grouped op
    (Pallas, interpret mode) applied sub-step by sub-step."""
    rng = np.random.default_rng(5)
    steps, ws = _random_chain(rng)
    chain = ShuffleGemmChain(steps)
    x = rng.standard_normal((2, 50)).astype(np.float32)
    got = run_chain(torch.as_tensor(x), chain, ws)
    want = jnp.asarray(x)
    for s, w in zip(steps, ws):
        plan = jfab.ShufflePlan(s.plan.gather_idx, s.plan.pad_values)
        want = j_grouped(want, plan, jnp.asarray(w.numpy()), s.reps,
                         s.groups, s.nb, interpret=True, diag=s.diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- the backward -------------------------------------------------------------

def _per_step(x, steps, ws):
    for s, w in zip(steps, ws):
        x = shuffle_gemm_grouped(x, s.plan, w, s.reps, s.groups, s.nb,
                                 diag=s.diag)
    return x


def _permutation_chain(rng, tiles=3, rpt=8):
    """As :func:`_random_chain`, but every sub-step after the first reads
    its tile by a permutation (adjoint reductions of width 1, which the
    backward folds), the last with a scale."""
    steps, ws = _random_chain(rng, tiles, rpt)
    for i in (1, 2):
        prev, s = steps[i - 1], steps[i]
        ept = prev.n_elems // tiles
        idx = np.concatenate([k * ept + rng.permutation(ept)
                              for k in range(tiles)]).astype(np.int32)
        steps[i] = SubStep(s.name, ShufflePlan(idx, np.zeros(idx.size,
                                                             np.float32)),
                           s.diag, s.rows, s.n_out, s.groups, s.nb)
    return steps, ws


@pytest.mark.parametrize("make", [_random_chain, _permutation_chain])
@pytest.mark.parametrize("w_grad", [False, True])
def test_chain_gradients_equal_the_per_step_path(w_grad, make):
    """The backward chain (``x`` only) and the per-step replay (a ``w``
    too) against ``ShuffleGemmFn`` applied sub-step by sub-step."""
    rng = np.random.default_rng(6)
    steps, ws0 = make(rng)
    chain = ShuffleGemmChain(steps)
    x0 = torch.as_tensor(rng.standard_normal((2, 50)).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal((2, steps[-1].n_elems))
                         .astype(np.float32))
    grads = []
    for fn in (lambda x, ws: run_chain(x, chain, ws),
               lambda x, ws: _per_step(x, steps, ws)):
        x = x0.clone().requires_grad_()
        ws = [w.clone().requires_grad_(w_grad) for w in ws0]
        y = fn(x, ws)
        y.backward(dy)
        grads.append([y.detach(), x.grad] + [w.grad for w in ws])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    if not w_grad:
        back, operands = backward_chain(chain, 50)
        assert [s.launch for s in back.segments] == ["shuffle_gemm_chain"]
        folded = sum(kind == "w" for kind, _ in operands) \
            - sum(kind == "ones" for kind, _ in operands)
        assert folded == (2 if make is _permutation_chain else 0)


def test_swizzle_keeps_float4s_and_pairs_and_spreads_the_butterflies():
    """The buffer swizzle is its own inverse inside each aligned 32-float
    block, keeps every float4 whole and every (even, even + 1) pair a
    pair, and spreads a butterfly step's reads (row r: floats 8r, 8r + 1,
    8r + 4, 8r + 5) from 4 banks a gather to 8, its pair loads to 8 of
    the 16 8-byte bank pairs."""
    p = np.arange(4096)
    q = swizzle(p)
    assert np.array_equal(swizzle(q), p)
    assert np.array_equal(q // 32, p // 32)
    assert np.array_equal(q[::4] % 4, np.zeros(1024))
    assert np.array_equal(q.reshape(-1, 4), q[::4, None] + np.arange(4))
    assert np.array_equal(q[1::2], q[::2] + 1)
    assert np.array_equal(swizzle(np.array([-1, 5])), [-1, 5])
    r = np.arange(32)
    for c in (0, 1, 4, 5):
        assert len(np.unique(((8 * r + c) % 32))) == 4
        assert len(np.unique(swizzle(8 * r + c) % 32)) == 8
    assert len(np.unique(swizzle(8 * r[:16]) // 2 % 16)) == 8


def test_operand_permutation_spreads_a_quarter_warps_groups():
    """A butterfly operand staged with group g's chunk kk at kk ^ ((g >>
    1) & 3): for 8 consecutive groups (a quarter-warp's rows at one row a
    group) each chunk read kk falls in 8 distinct 16-byte bank groups,
    where the plain layout (chunk 4g + kk) gives 2; at 2 and 4 rows a
    group, the quarter's distinct groups still read distinct bank groups;
    the permutation stays inside each group's 64 bytes."""
    g = np.arange(64)
    for kk in range(4):
        perm = 4 * g + (kk ^ ((g >> 1) & 3))
        for q in range(0, 64, 8):
            assert len(np.unique(perm[q:q + 8] % 8)) == 8
            assert len(np.unique((4 * g + kk)[q:q + 8] % 8)) == 2
        for nb in (2, 4):
            rows = g[:8 // nb * nb]
            gr = rows // nb
            pos = 4 * gr + (kk ^ ((gr >> 1) & 3))
            assert len(np.unique(pos % 8)) == len(np.unique(gr))
        assert np.array_equal(np.sort(perm.reshape(-1)) // 4, g)
