"""Block-circulant weights: the dnn stage on the shared fabric + array.

PAPERS.md's "FFT-Based Deep Learning Deployment in Embedded Systems"
stores a dense layer as a grid of b×b *circulant* blocks — each block is
one length-``b`` tap vector ``c`` with ``W[r, s] = c[(r - s) mod b]`` —
an ``O(b)``-parameter, FFT-diagonalizable stand-in for the ``O(b^2)``
dense block.  The classic deployment runs it in the FFT domain:
``W_block @ x = ifft(fft(c) * fft(x))``.

That FFT-domain form is a *grouped* per-frequency multiply — precisely
the einsum family the array backends never int-route (the butterfly's
complex twiddle range is what the paper keeps at 16-bit).  So the
SigQuant lowering uses the mathematically identical **time-domain
circulant im2col** instead:

    y[f, j*b + r] = sum_{i, s} taps[j, i, s] * x[f, i*b + ((r - s) % b)]

i.e. one *duplicating* fabric gather (each input element fans out to the
``b`` rotations that read it — just another :class:`ShufflePlan`), one
**row-uniform** GEMM of shape ``(frames*b, d_in) @ (d_in, nb_out)``
against the canonical operand ``C[i*b + s, j] = taps[j, i, s]``, and a
pure output permutation ``(f, r, j) -> (f, j, r)`` that v2 fusion folds
into the einsum's ``post`` shuffle.  Row-uniform means the step
classifies like FIR/mel/DCT: it reaches :func:`repro_torch.kernels.
shuffle_gemm` when float and ``bitserial_mm`` when a
:class:`~repro_torch.signal.backends.PrecisionPolicy` names it — the paper's
DSP-and-DL-on-one-array claim, end to end.

Learning the canonical operand ``C`` directly (``param_key="weights"``)
*is* learning the taps — the map is a bijection — so gradient descent
stays inside the circulant family and keeps the b× parameter reduction.

All helpers are plain numpy (compile-time plan construction).
:func:`circulant_spectra` exposes the FFT-domain view for the docs'
equivalence demo.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.fabric import ShufflePlan

__all__ = ["circulant_init", "circulant_operand", "circulant_taps",
           "circulant_matrix", "circulant_project", "circulant_spectra",
           "circulant_gather_plan", "circulant_post_plan"]


def _check_block(d_in: int, d_out: int, block: int) -> Tuple[int, int]:
    if block < 1 or d_in % block or d_out % block:
        raise ValueError(
            f"block-circulant lowering needs block | d_in and "
            f"block | d_out; got block={block}, d_in={d_in}, "
            f"d_out={d_out}")
    return d_in // block, d_out // block


def circulant_init(d_in: int, d_out: int, block: int,
                   seed: int = 0) -> np.ndarray:
    """Deterministic near-identity taps ``(nb_out, nb_in, block)``:
    small gaussian noise plus a unit zeroth tap on the diagonal blocks,
    so an untrained dnn_circulant stage is a perturbed pass-through
    (well-conditioned for both calibration and training)."""
    nb_in, nb_out = _check_block(d_in, d_out, block)
    rng = np.random.default_rng(seed + 7919 * d_in + 104729 * d_out)
    taps = rng.standard_normal((nb_out, nb_in, block)) * (0.1 / np.sqrt(d_in))
    for j in range(nb_out):
        taps[j, j % nb_in, 0] += 1.0
    return taps.astype(np.float32)


def circulant_operand(taps: np.ndarray) -> np.ndarray:
    """Taps ``(nb_out, nb_in, b)`` -> canonical GEMM operand
    ``C (nb_in*b, nb_out)`` with ``C[i*b + s, j] = taps[j, i, s]``."""
    taps = np.asarray(taps)
    nb_out, nb_in, b = taps.shape
    return np.ascontiguousarray(
        np.transpose(taps, (1, 2, 0)).reshape(nb_in * b, nb_out)
    ).astype(np.float32)


def circulant_taps(operand: np.ndarray, block: int) -> np.ndarray:
    """Inverse of :func:`circulant_operand`: recover taps
    ``(nb_out, nb_in, block)`` from the canonical operand."""
    C = np.asarray(operand)
    nb_in = C.shape[0] // block
    nb_out = C.shape[1]
    return np.ascontiguousarray(
        np.transpose(C.reshape(nb_in, block, nb_out), (2, 0, 1)))


def circulant_matrix(taps: np.ndarray) -> np.ndarray:
    """Dense ``(d_out, d_in)`` equivalent: ``W[j*b + r, i*b + c] =
    taps[j, i, (r - c) % b]`` — the oracle the lowering is tested
    against."""
    taps = np.asarray(taps)
    nb_out, nb_in, b = taps.shape
    r = np.arange(b)
    blocks = taps[:, :, (r[:, None] - r[None, :]) % b]  # (j, i, r, c)
    return np.ascontiguousarray(
        blocks.transpose(0, 2, 1, 3).reshape(nb_out * b, nb_in * b))


def circulant_project(dense: np.ndarray, block: int) -> np.ndarray:
    """Project a dense ``(d_out, d_in)`` matrix onto the nearest
    block-circulant taps (least squares: average each wrapped diagonal
    of every b×b block) — how trained dense dnn weights seed a
    circulant re-lowering."""
    W = np.asarray(dense)
    d_out, d_in = W.shape
    nb_in, nb_out = _check_block(d_in, d_out, block)
    Wb = W.reshape(nb_out, block, nb_in, block)
    r = np.arange(block)
    sel = (r[:, None] - r[None, :]) % block
    taps = np.zeros((nb_out, nb_in, block), W.dtype)
    for s in range(block):
        rr, cc = np.nonzero(sel == s)
        # advanced indexing on axes 1 and 3 -> (block, nb_out, nb_in)
        taps[:, :, s] = Wb[:, rr, :, cc].mean(axis=0)
    return taps


def circulant_spectra(taps: np.ndarray) -> np.ndarray:
    """FFT-domain view ``Λ (nb_out, nb_in, b)`` complex: per frequency
    ``k``, the layer is the dense multiply ``Y[:, k] = Λ[:, :, k] @
    X[:, k]`` over block spectra ``X[i, k] = fft(x_block_i)[k]`` — the
    form "FFT-Based Deep Learning Deployment" runs.  SigQuant lowers
    the identical operator in the time domain instead (see module
    docstring) because the per-frequency multiply is a *grouped* einsum
    the array never int-routes."""
    return np.fft.fft(np.asarray(taps), axis=-1)


def circulant_gather_plan(frames: int, d_in: int, block: int,
                          width: int = 16) -> ShufflePlan:
    """Im2col-style fabric plan for the circulant GEMM: output row
    ``(f, r)`` gathers ``x[f*d_in + i*block + ((r - s) % block)]`` over
    ``(i, s)`` — a duplicating gather (n_out = frames*block*d_in), so it
    stays a real fabric pass rather than folding as a permutation."""
    nb_in, _ = _check_block(d_in, d_in, block)
    f = np.arange(frames)[:, None, None, None]
    r = np.arange(block)[None, :, None, None]
    i = np.arange(nb_in)[None, None, :, None]
    s = np.arange(block)[None, None, None, :]
    idx = f * d_in + i * block + ((r - s) % block)
    idx = np.ascontiguousarray(idx.reshape(-1).astype(np.int32))
    return ShufflePlan(idx, np.zeros(idx.size, np.int64), width)


def circulant_post_plan(frames: int, block: int, nb_out: int,
                        width: int = 16) -> ShufflePlan:
    """Pure permutation ``(f, r, j) -> (f, j, r)``: the GEMM emits
    ``flat[f*block*nb_out + r*nb_out + j]``; the stage's output layout
    wants ``flat[f*d_out + j*block + r]``.  Being a permutation, v2
    fusion folds it into the einsum's ``post`` shuffle at fuse level
    2 — zero standalone fabric passes."""
    f = np.arange(frames)[:, None, None]
    j = np.arange(nb_out)[None, :, None]
    r = np.arange(block)[None, None, :]
    src = f * (block * nb_out) + r * nb_out + j
    src = np.ascontiguousarray(src.reshape(-1).astype(np.int32))
    return ShufflePlan(src, np.zeros(src.size, np.int64), width)
