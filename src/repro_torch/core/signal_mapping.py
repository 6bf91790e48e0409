"""Mapping signal-processing algorithms onto the DLA compute array (paper §V-A).

Every algorithm becomes a sequence of  shuffle-plan -> dense GEMM/einsum
steps, exactly the decomposition the SigDLA fabric performs in hardware:

  FFT  (radix-2 DIT): bit-reversal plan, then per stage a *gather* plan that
        groups butterfly pairs by twiddle class, a batched (4x4) real matmul
        against the twiddle tensor (the paper's Fig 3a: butterfly factors as
        the stationary operand), and a *scatter* plan back to natural order.
        The constant 1/0 entries of the butterfly matrices are the values the
        DPU pads in hardware.
  FIR : an im2col gather-with-zero-padding plan (DPU pads x[n<0]=0) followed
        by a single GEMM with the tap vector (Fig 3b).
  DCT : dense transform matrix — already regular; plain GEMM (Fig 3c).
  DWT : polyphase window gather at stride 2 + GEMM with the (L,2)
        low/high-pass filter bank (Fig 3d).

All plans are static numpy, built once per shape, and bit-identical to the
JAX package's builders; the tensor ops batch along leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .fabric import PAD, ShufflePlan, device_constant

# --------------------------------------------------------------------------
# Complex <-> interleaved-real layout ([re0, im0, re1, im1, ...])
# --------------------------------------------------------------------------

def complex_to_interleaved(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x).reshape(*x.shape[:-1], -1)


def interleaved_to_complex(x: torch.Tensor) -> torch.Tensor:
    """Interleaved float32 ``[re0, im0, ...]`` -> complex64 (the
    complex64 of the JAX package's ``lax.complex``)."""
    r = x.reshape(*x.shape[:-1], -1, 2)
    return torch.complex(r[..., 0], r[..., 1])


# --------------------------------------------------------------------------
# FFT
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FFTStagePlan:
    gather: ShufflePlan          # interleaved input -> (half, nb, 4) rows
    twiddle: np.ndarray          # (half, 4, 4) real butterfly matrices
    scatter: ShufflePlan         # (half, nb, 4) flat -> interleaved output
    half: int
    nb: int


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    n: int
    bitrev: ShufflePlan
    stages: List[FFTStagePlan]
    fused: bool = False

    @property
    def shuffle_elements(self) -> int:
        """Total elements moved through the fabric (perf-model input)."""
        total = self.bitrev.n_out
        for s in self.stages:
            total += s.gather.n_out + s.scatter.n_out
        return total

    @property
    def mult_adds(self) -> int:
        # (N/2) log2 N butterflies x (4 real mult + 6 real add) ~ paper's
        # Table I counts one complex-mult+2 complex-add as 10 mult-adds.
        import math
        return (self.n // 2) * int(math.log2(self.n)) * 10


def _bitrev_indices(n: int) -> np.ndarray:
    bits = int(np.log2(n))
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _interleave(idx: np.ndarray) -> np.ndarray:
    """Element indices -> interleaved real indices [2i, 2i+1]."""
    out = np.empty(idx.size * 2, dtype=np.int64)
    out[0::2] = 2 * idx
    out[1::2] = 2 * idx + 1
    return out


def _perm_plan(elem_idx: np.ndarray, width: int = 16) -> ShufflePlan:
    gi = _interleave(elem_idx)
    return ShufflePlan(gi.astype(np.int32), np.zeros(gi.size, np.int64), width)


def make_fft_plan(n: int, fuse_adjacent: bool = True,
                  width: int = 16) -> FFTPlan:
    """Build the full radix-2 DIT plan for length-``n`` complex FFT.

    ``fuse_adjacent``: compose each stage's scatter with the next stage's
    gather into one fabric pass (beyond-paper optimization; halves shuffle
    traffic — see EXPERIMENTS.md §Perf-paper).
    """
    if n & (n - 1) or n < 2:
        raise ValueError("n must be a power of two >= 2")
    m = int(np.log2(n))
    bitrev = _perm_plan(_bitrev_indices(n), width)

    stages: List[FFTStagePlan] = []
    for s in range(1, m + 1):
        m2, half = 1 << s, 1 << (s - 1)
        nb = n // m2
        # gather: row (j, b) pulls [u_re, u_im, v_re, v_im]
        j = np.repeat(np.arange(half), nb)
        b = np.tile(np.arange(nb), half)
        k = b * m2
        u, v = k + j, k + j + half
        gi = np.stack([2 * u, 2 * u + 1, 2 * v, 2 * v + 1], axis=1).ravel()
        gather = ShufflePlan(gi.astype(np.int32),
                             np.zeros(gi.size, np.int64), width)
        # twiddles: w = exp(-2 pi i j / m2)
        ang = -2.0 * np.pi * np.arange(half) / m2
        wr, wi = np.cos(ang), np.sin(ang)
        tw = np.zeros((half, 4, 4), dtype=np.float32)
        tw[:, 0, 0] = 1; tw[:, 0, 2] = wr; tw[:, 0, 3] = -wi
        tw[:, 1, 1] = 1; tw[:, 1, 2] = wi; tw[:, 1, 3] = wr
        tw[:, 2, 0] = 1; tw[:, 2, 2] = -wr; tw[:, 2, 3] = wi
        tw[:, 3, 1] = 1; tw[:, 3, 2] = -wi; tw[:, 3, 3] = -wr
        # scatter: flat (j, b, o) -> interleaved natural order
        flat_pos = np.arange(half * nb * 4).reshape(half, nb, 4)
        tgt = np.empty(2 * n, dtype=np.int64)
        tgt[2 * u] = flat_pos[j, b, 0]
        tgt[2 * u + 1] = flat_pos[j, b, 1]
        tgt[2 * v] = flat_pos[j, b, 2]
        tgt[2 * v + 1] = flat_pos[j, b, 3]
        scatter = ShufflePlan(tgt.astype(np.int32),
                              np.zeros(tgt.size, np.int64), width)
        stages.append(FFTStagePlan(gather, tw, scatter, half, nb))

    if fuse_adjacent:
        fused: List[FFTStagePlan] = []
        for i, st in enumerate(stages):
            g = st.gather
            if i == 0:
                g = bitrev.then(g)
            if i + 1 < len(stages):
                # next stage's gather composed with our scatter
                nxt = stages[i + 1]
                object.__setattr__(nxt, "gather", st.scatter.then(nxt.gather))
                sc = None
            else:
                sc = st.scatter
            fused.append(FFTStagePlan(
                g, st.twiddle,
                sc if sc is not None else _null_plan(), st.half, st.nb))
        # Rebuild with flags: stages whose scatter is null skip the pass.
        return FFTPlan(n, _null_plan(), fused, fused=True)
    return FFTPlan(n, bitrev, stages, fused=False)


def _null_plan() -> ShufflePlan:
    return ShufflePlan(np.zeros(0, np.int32), np.zeros(0, np.int64), 16)


def fft_via_fabric(x: torch.Tensor, plan: FFTPlan) -> torch.Tensor:
    """Run the FFT through the fabric+array path.

    ``x``: (..., 2n) interleaved real, or (..., n) complex (converted).
    Returns the same layout it was given.
    """
    from .fabric import apply_plan
    complex_in = x.is_complex()
    if complex_in:
        x = complex_to_interleaved(x)
    if not plan.fused:
        x = apply_plan(x, plan.bitrev)
    for st in plan.stages:
        rows = apply_plan(x, st.gather)
        rows = rows.reshape(*rows.shape[:-1], st.half, st.nb, 4)
        tw = device_constant(st.twiddle, rows.device, rows.dtype)
        y = torch.einsum("...jbi,joi->...jbo", rows, tw)
        x = y.reshape(*y.shape[:-3], 2 * plan.n)
        if st.scatter.n_out:
            x = apply_plan(x, st.scatter)
    return interleaved_to_complex(x) if complex_in else x


def ifft_via_fabric(x: torch.Tensor, plan: FFTPlan) -> torch.Tensor:
    """Inverse FFT via conj -> FFT -> conj / n (reuses the same plans)."""
    complex_in = x.is_complex()
    xi = x if complex_in else interleaved_to_complex(x)
    y = torch.conj(fft_via_fabric(torch.conj(xi).resolve_conj(),
                                  plan)).resolve_conj() / plan.n
    return y if complex_in else complex_to_interleaved(y)


# --------------------------------------------------------------------------
# FIR
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FIRPlan:
    n: int
    taps: int
    im2col: ShufflePlan

    @property
    def shuffle_elements(self) -> int:
        return self.im2col.n_out

    @property
    def mult_adds(self) -> int:
        return self.n * self.taps


def make_fir_plan(n: int, taps: int, width: int = 16) -> FIRPlan:
    """im2col plan: row i = [x[i], x[i-1], ..., x[i-taps+1]], zero-padded
    (the zeros are DPU constants)."""
    rows = np.arange(n)[:, None] - np.arange(taps)[None, :]
    gi = np.where(rows < 0, PAD, rows).astype(np.int32).ravel()
    pv = np.zeros(gi.size, np.int64)
    return FIRPlan(n, taps, ShufflePlan(gi, pv, width))


def fir_via_fabric(x: torch.Tensor, h, plan: FIRPlan) -> torch.Tensor:
    from .fabric import apply_plan
    cols = apply_plan(x, plan.im2col)
    cols = cols.reshape(*cols.shape[:-1], plan.n, plan.taps)
    return torch.einsum("...nt,t->...n", cols,
                        device_constant(h, cols.device, cols.dtype))


@dataclasses.dataclass(frozen=True)
class FIRPhasePlan:
    """Beyond-paper FIR mapping: P output positions per array pass.

    The single-kernel mapping (Fig 3b) keeps only 1 of the DLA's 8 PEs
    busy.  Here P shifted copies of the tap vector become P convolution
    kernels (structural zeros supplied by the DPU), so one im2col window of
    length taps+P-1 produces P outputs — full PE utilization.  See
    EXPERIMENTS.md §Perf-paper (7.1x at 16-bit on the 80-tap benchmark).
    """
    n: int
    taps: int
    phases: int
    window: ShufflePlan           # (n/P, taps+P-1) windows, zero-padded

    @property
    def win_len(self) -> int:
        return self.taps + self.phases - 1


def make_fir_phase_plan(n: int, taps: int, phases: int = 8,
                        width: int = 16) -> FIRPhasePlan:
    if n % phases:
        raise ValueError("n must be divisible by phases")
    L = taps + phases - 1
    m = np.arange(n // phases)
    i = np.arange(L)
    # window w_m[i] = x[m*P + (P-1) - i]
    src = m[:, None] * phases + (phases - 1) - i[None, :]
    gi = np.where((src < 0) | (src >= n), PAD, src).astype(np.int32)
    return FIRPhasePlan(n, taps, phases,
                        ShufflePlan(gi.ravel(), np.zeros(gi.size, np.int64),
                                    width))


def fir_phase_weights(h: np.ndarray, phases: int) -> np.ndarray:
    """(taps+P-1, P) kernel bank: W[i, r] = h[i + r - P + 1] (0 outside)."""
    taps = h.shape[0]
    L = taps + phases - 1
    W = np.zeros((L, phases), dtype=np.float32)
    for r in range(phases):
        for i in range(L):
            t = i + r - phases + 1
            if 0 <= t < taps:
                W[i, r] = h[t]
    return W


def fir_phase_weights_torch(h: torch.Tensor, phases: int) -> torch.Tensor:
    """Differentiable tap bank: W[i, r] = h[i + r - P + 1] (0 outside)."""
    taps = h.shape[-1]
    L = taps + phases - 1
    i = torch.arange(L, device=h.device)[:, None]
    r = torch.arange(phases, device=h.device)[None, :]
    t = i + r - phases + 1
    valid = (t >= 0) & (t < taps)
    return torch.where(valid, h[t.clamp(0, taps - 1)],
                       torch.zeros((), dtype=h.dtype, device=h.device))


def fir_via_fabric_phased(x: torch.Tensor, h,
                          plan: FIRPhasePlan) -> torch.Tensor:
    from .fabric import apply_plan
    win = apply_plan(x, plan.window)
    win = win.reshape(*win.shape[:-1], plan.n // plan.phases, plan.win_len)
    W = fir_phase_weights_torch(device_constant(h, win.device, win.dtype),
                                plan.phases)
    y = torch.einsum("...ml,lp->...mp", win, W)
    return y.reshape(*y.shape[:-2], plan.n)


# --------------------------------------------------------------------------
# DCT (type-II, orthonormal) — already-regular GEMM (Fig 3c)
# --------------------------------------------------------------------------

def dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    c *= np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def dct_via_array(x: torch.Tensor) -> torch.Tensor:
    """1-D DCT-II along the last axis."""
    c = torch.as_tensor(dct_matrix(x.shape[-1]), device=x.device).to(x.dtype)
    return torch.einsum("...n,kn->...k", x, c)


def dct2_via_array(x: torch.Tensor) -> torch.Tensor:
    """2-D DCT-II over the last two axes (the paper's 2D-DCT workload)."""
    c = torch.as_tensor(dct_matrix(x.shape[-1]), device=x.device).to(x.dtype)
    r = torch.as_tensor(dct_matrix(x.shape[-2]), device=x.device).to(x.dtype)
    return torch.einsum("km,...mn,ln->...kl", r, x, c)


def dct_mult_adds(n: int) -> int:
    return n * n


# --------------------------------------------------------------------------
# DWT (single level, orthogonal filter bank)
# --------------------------------------------------------------------------

WAVELETS = {
    "haar": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([0.48296291314469025, 0.836516303737469,
                     0.22414386804185735, -0.12940952255092145]),
}


@dataclasses.dataclass(frozen=True)
class DWTPlan:
    n: int
    filt_len: int
    window: ShufflePlan      # (n/2, L) strided windows, periodic extension

    @property
    def shuffle_elements(self) -> int:
        return self.window.n_out

    @property
    def mult_adds(self) -> int:
        return self.n * self.filt_len  # (n/2 windows) x L x 2 filters


def make_dwt_plan(n: int, wavelet: str = "haar", width: int = 16) -> DWTPlan:
    if n % 2:
        raise ValueError("n must be even")
    h = WAVELETS[wavelet]
    L = h.size
    starts = 2 * np.arange(n // 2)
    gi = ((starts[:, None] + np.arange(L)[None, :]) % n).astype(np.int32)
    return DWTPlan(n, L, ShufflePlan(gi.ravel(), np.zeros(gi.size, np.int64),
                                     width))


def dwt_filters(wavelet: str = "haar") -> np.ndarray:
    """(L, 2) filter bank: column 0 lowpass, column 1 highpass (QMF)."""
    h = WAVELETS[wavelet]
    g = h[::-1].copy()
    g[1::2] *= -1.0
    return np.stack([h, g], axis=1).astype(np.float32)


def dwt_via_fabric(x: torch.Tensor, plan: DWTPlan, wavelet: str = "haar"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    from .fabric import apply_plan
    win = apply_plan(x, plan.window)
    win = win.reshape(*win.shape[:-1], plan.n // 2, plan.filt_len)
    fb = torch.as_tensor(dwt_filters(wavelet), device=win.device).to(win.dtype)
    out = torch.einsum("...wl,lf->...wf", win, fb)
    return out[..., 0], out[..., 1]
