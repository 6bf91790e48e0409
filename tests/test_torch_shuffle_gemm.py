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
