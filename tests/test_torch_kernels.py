"""The bitserial, FFT-stage and phased-FIR kernels of the PyTorch port
against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels in interpret mode, the way
its own tests run them (``tests/test_kernels.py``), with the same numpy
inputs and the same tolerances: the bitserial GEMM bit-exact (it is an
integer product mod 2^32), one FFT stage and the phased FIR at
rtol = atol = 1e-4, the full FFT at 2e-3 against ``np.fft``.  The CUDA
kernels themselves are held against the plain versions on the card in
``test_torch_gpu.py``.  The one-launch FFT's plain version (every stage,
then the final scatter) is held bit for bit against the stage-by-stage
path.  The int route's one-launch kernel (``bitserial_quant_matmul``) has
its plain version held bit for bit against the JAX package's composition
(``quantize`` x2, interpret-mode ``bitserial_matmul``, two multiplies),
and against a numpy emulation of the CUDA kernel's arithmetic, the CPU
spec the kernel follows.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitwidth as jbw
from repro.core import signal_mapping as jsm
from repro.kernels import bitserial_matmul as j_bitserial
from repro.kernels import fft_stage as j_fft_stage
from repro.kernels import fir_conv as j_fir_conv
from repro.kernels.bitserial_mm.ref import ref_bitserial_matmul as j_ref_bs
from repro.kernels.fft_stage.ops import fft_pallas
from repro_torch import kernels as tk
from repro_torch.core import signal_mapping as tsm
from repro_torch.core.fabric import apply_plan
from repro_torch.kernels import bitserial_mm
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.fft_stage import ref as fft_ref
from repro_torch.kernels.fir_conv import kernel as fir_kernel
from repro_torch.kernels.fir_conv import ops as fir_ops
from repro_torch.kernels.fir_conv import ref as fir_ref

WIDTHS = [(4, 4), (8, 4), (8, 8), (16, 8), (16, 16), (4, 16)]


def _ints(rng, width, shape):
    return rng.integers(-2 ** (width - 1), 2 ** (width - 1), shape)


def _bitserial_case(case):
    """(a, w, aw, ww) numpy int32 operands: a width sweep over two
    shapes, a batched ``a``, and 16x16-bit operands whose products wrap
    the int32 accumulator."""
    kind, aw, ww, shape = case
    if kind == "sweep":
        m, k, n = shape
        rng = np.random.default_rng(aw * 100 + ww + m)
        return (_ints(rng, aw, (m, k)).astype(np.int32),
                _ints(rng, ww, (k, n)).astype(np.int32), aw, ww)
    if kind == "batched":
        rng = np.random.default_rng(0)
        return (rng.integers(-8, 8, (2, 3, 10, 12)).astype(np.int32),
                rng.integers(-8, 8, (12, 7)).astype(np.int32), 4, 4)
    rng = np.random.default_rng(11)                     # "wrap"
    a = rng.integers(-32767, 32768, (24, 64)).astype(np.int32)
    w = rng.integers(-32767, 32768, (64, 9)).astype(np.int32)
    assert np.abs(a.astype(np.int64) @ w).max() > 2 ** 31
    return a, w, 16, 16


BITSERIAL_CASES = ([("sweep", aw, ww, s) for aw, ww in WIDTHS
                    for s in [(3, 5, 2), (37, 53, 19)]]
                   + [("batched", 4, 4, None), ("wrap", 16, 16, None)])


@pytest.mark.parametrize("case", BITSERIAL_CASES, ids=lambda c: "-".join(
    str(v) for v in c if v is not None))
def test_bitserial_matches_reference(case):
    a, w, aw, ww = _bitserial_case(case)
    want = np.asarray(j_bitserial(jnp.asarray(a), jnp.asarray(w), aw, ww,
                                  interpret=True))
    np.testing.assert_array_equal(want, j_ref_bs(a, w))
    got = bitserial_mm.bitserial_matmul(torch.as_tensor(a),
                                        torch.as_tensor(w), aw, ww)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bitserial_mm.ref_bitserial_matmul(torch.as_tensor(a),
                                          torch.as_tensor(w)).numpy(), want)


# -- the int route in one launch: quantize -> GEMM -> dequantize ---------------

QUANT_WIDTHS = [(4, 4), (8, 4), (8, 8), (16, 8), (16, 16)]
# Fig-9q's int-routed calls (batch 4, length 4096): front.taps (16384, 9,
# 1) cut to 384 rows, mask.gemm (496, 256, 64), mel_tap.mel (124, 129, 24)
QUANT_SHAPES = [(384, 9, 1), (496, 256, 64), (124, 129, 24)]


def _quant_case(aw, ww, shape, nan_row=False):
    """float32 h (R, K), w (K, N) from a seed: rows of spread magnitudes,
    row 1 all zeros (amax 0), optionally a NaN in row 2."""
    r, k, n = shape
    rng = np.random.default_rng(aw * 1000 + ww * 10 + k)
    h = (rng.standard_normal((r, k))
         * np.exp(rng.uniform(-4, 4, (r, 1)))).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    h[1] = 0.0
    if nan_row:
        h[2, k // 2] = np.nan
    return h, w


def _emulate_quant_matmul(h, w, aw, ww):
    """numpy emulation of ``repro_bitserial_quant_matmul``'s arithmetic:
    IEEE float32 division, round half to even, NaN-propagating max and
    clamp, a NaN quantized to 0 (the card's float-to-int conversion),
    the canonical digit split, int8 plane-pair products summed per shift
    ``i + j`` in int32 (wrapping), the uint32 shift-add, and two
    separately rounded float32 multiplies."""
    def quant(x, width, axis):
        qmax = np.float32(2 ** (width - 1) - 1)
        amax = np.abs(x).max(axis=axis, keepdims=True)
        scale = np.maximum(amax, np.float32(1e-8)) / qmax
        with np.errstate(invalid="ignore"):
            c = np.clip(np.rint(x / scale), -qmax, qmax)
        return np.where(np.isnan(c), 0, c).astype(np.int32), scale

    def planes(q, width):
        p = width // 4
        return [((q >> (4 * i)) & 0xF if i < p - 1 else q >> (4 * i))
                .astype(np.int8).astype(np.int64) for i in range(p)]

    (qh, sh), (qw, sw) = quant(h, aw, -1), quant(w, ww, 0)
    ap, wp = planes(qh, aw), planes(qw, ww)
    acc = np.zeros((h.shape[0], w.shape[1]), np.uint64)
    for s in range(len(ap) + len(wp) - 1):
        part = sum(ap[i] @ wp[s - i] for i in range(len(ap))
                   if 0 <= s - i < len(wp))
        acc = (acc + ((part.astype(np.uint64) & 0xFFFFFFFF) << (4 * s))) \
            & 0xFFFFFFFF
    acc = acc.astype(np.uint32).view(np.int32)
    return (acc.astype(np.float32) * sh) * sw


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("aw,ww", QUANT_WIDTHS)
def test_bitserial_quant_matmul_matches_reference(aw, ww, shape):
    """The one-launch int route's plain version against the JAX package's
    int-route composition (``src/repro/signal/backends.py``
    ``_int_unit``: quantize x2, ``bitserial_matmul`` in interpret mode,
    dequantize), bit for bit."""
    h, w = _quant_case(aw, ww, shape)
    xq, xs = jbw.quantize(jnp.asarray(h), aw, axis=-1)
    wq, ws = jbw.quantize(jnp.asarray(w), ww, axis=0)
    acc = j_bitserial(xq.astype(jnp.int32), wq.astype(jnp.int32), aw, ww,
                      interpret=True)
    want = np.asarray(acc.astype(jnp.float32) * xs * ws)
    got = bitserial_mm.bitserial_quant_matmul(torch.as_tensor(h),
                                              torch.as_tensor(w), aw, ww)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1].any()                      # the zero row
    batched = bitserial_mm.bitserial_quant_matmul(
        torch.as_tensor(h).reshape(2, -1, shape[1]), torch.as_tensor(w),
        aw, ww)
    np.testing.assert_array_equal(batched.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("nan_row", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("aw,ww", QUANT_WIDTHS)
def test_quant_kernel_emulation_equals_plain(aw, ww, shape, nan_row):
    """The numpy emulation of the CUDA kernel's arithmetic equals the
    plain version bit for bit; a NaN row comes out all NaN and leaves
    every other row as it was."""
    h, w = _quant_case(aw, ww, shape, nan_row)
    want = bitserial_mm.ref_bitserial_quant_matmul(
        torch.as_tensor(h), torch.as_tensor(w), aw, ww).numpy()
    got = _emulate_quant_matmul(h, w, aw, ww)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]).all() == nan_row
    assert not np.isnan(np.delete(got, 2, axis=0)).any()


def test_bitserial_quant_matmul_refuses_bad_widths():
    h, w = torch.zeros((3, 4)), torch.zeros((4, 2))
    for aw, ww in [(12, 8), (8, 2), (0, 4)]:
        with pytest.raises(ValueError, match="widths"):
            bitserial_mm.bitserial_quant_matmul(h, w, aw, ww)
    with pytest.raises(ValueError, match="K=4"):
        bitserial_mm.bitserial_quant_matmul(h, w.T, 8, 8)


@pytest.mark.parametrize("n", [8, 64, 512])
def test_fft_stage_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 2 * n)).astype(np.float32)
    jplan = jsm.make_fft_plan(n, fuse_adjacent=True)
    tplan = tsm.make_fft_plan(n, fuse_adjacent=True)
    for jst, tst in list(zip(jplan.stages, tplan.stages))[:3]:
        want = np.asarray(j_fft_stage(jnp.asarray(x), jst, interpret=True))
        got = fft_ops.fft_stage(torch.as_tensor(x), tst)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            fft_ref.ref_fft_stage(torch.as_tensor(x), tst).numpy(), want,
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [16, 128, 1024])
def test_fft_hopper_matches_reference(n):
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    got = fft_ops.fft_hopper(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, np.fft.fft(z, axis=-1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(fft_pallas(
        jnp.asarray(z), interpret=True)), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n", [2, 16, 256, 1024])
def test_fft_stage_list_plain_equals_stage_by_stage(n):
    """The one-launch path's plain version (every stage, then the final
    scatter) is bit for bit the stage-by-stage plain stages followed by
    ``apply_plan``, the path the JAX package's ``fft_pallas`` takes."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.standard_normal((3, 2 * n)).astype(np.float32))
    plan = fft_ops._plan(n)
    idx, tw, nb, scatter = fft_ops._stage_list(plan, "cpu", torch.float32)
    got = fft_ref.ref_fft_stages_hopper(x, idx, tw, nb, scatter)
    want = x
    for st in plan.stages:
        want = fft_ops.fft_stage(want, st)
        if st.scatter.n_out:
            want = apply_plan(want, st.scatter)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [(3,), (2, 5)])
@pytest.mark.parametrize("n", [2, 16, 256, 1024])
def test_fft_hopper_matches_fft_pallas(n, batch):
    """``fft_hopper`` (one launch on the card; its plain version here)
    against the JAX package's ``fft_pallas`` in interpret mode, at its
    full-FFT tolerance, over batch shapes of one and two axes."""
    rng = np.random.default_rng(n + len(batch))
    z = (rng.standard_normal(batch + (n,))
         + 1j * rng.standard_normal(batch + (n,))).astype(np.complex64)
    got = fft_ops.fft_hopper(torch.as_tensor(z)).numpy()
    assert got.shape == z.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, np.asarray(fft_pallas(
        jnp.asarray(z), interpret=True)), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("taps,phases", [(5, 2), (21, 8), (80, 8), (33, 16)])
def test_fir_conv_matches_reference(taps, phases):
    rng = np.random.default_rng(taps)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    h = rng.standard_normal(taps).astype(np.float32)
    want = np.asarray(j_fir_conv(jnp.asarray(x), jnp.asarray(h),
                                 phases=phases, interpret=True))
    for hh in (h, torch.as_tensor(h)):
        got = fir_ops.fir_conv(torch.as_tensor(x), hh, phases=phases)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        fir_ref.ref_fir(torch.as_tensor(x), torch.as_tensor(h)).numpy(),
        want, rtol=1e-4, atol=1e-4)


# -- the wrappers' contract ----------------------------------------------------

def _counts():
    return {**bitserial_mm.launch_counts(), **fft_kernel.launch_counts(),
            **fir_kernel.launch_counts()}


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    before = _counts()
    a = torch.as_tensor(rng.integers(-8, 8, (2, 5, 6)), dtype=torch.int8)
    w = torch.as_tensor(rng.integers(-8, 8, (1, 6, 3)), dtype=torch.int8)
    torch.testing.assert_close(
        bitserial_mm.bitserial_matmul_planes(a, w),
        bitserial_mm.ref_bitserial_matmul_planes(a, w), rtol=0, atol=0)
    x = torch.as_tensor(rng.standard_normal((2, 16)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 16, 16).astype(np.int32))
    tw = torch.as_tensor(rng.standard_normal((2, 4, 4)).astype(np.float32))
    torch.testing.assert_close(
        fft_kernel.fft_stage_hopper(x, idx, tw, 2, 2),
        fft_ref.ref_fft_stage_hopper(x, idx, tw, 2, 2), rtol=0, atol=0)
    widx = torch.as_tensor(rng.integers(-1, 16, (4, 5)).astype(np.int32))
    wb = torch.as_tensor(rng.standard_normal((5, 4)).astype(np.float32))
    torch.testing.assert_close(fir_kernel.fir_conv_hopper(x, widx, wb),
                               fir_ref.ref_fir_conv_hopper(x, widx, wb),
                               rtol=0, atol=0)
    h = torch.as_tensor(rng.standard_normal((5, 6)).astype(np.float32))
    wf = torch.as_tensor(rng.standard_normal((6, 3)).astype(np.float32))
    torch.testing.assert_close(
        bitserial_mm.bitserial_quant_matmul_hopper(h, wf, 16, 8),
        bitserial_mm.ref_bitserial_quant_matmul(h, wf, 16, 8), rtol=0,
        atol=0)
    assert _counts() == before


@pytest.mark.parametrize("kernel", ["bitserial", "bitserial_quant",
                                    "fft_stage", "fir_conv"])
def test_non_cpu_tensor_never_falls_back(kernel):
    """A tensor off the CPU goes to the kernel or raises: a ``meta``
    tensor (no card needed) is refused, not computed by the plain
    version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "bitserial":
            bitserial_mm.bitserial_matmul_planes(
                torch.empty((1, 4, 8), dtype=torch.int8, **meta),
                torch.empty((1, 8, 3), dtype=torch.int8, **meta))
        elif kernel == "bitserial_quant":
            bitserial_mm.bitserial_quant_matmul_hopper(
                torch.empty((4, 8), **meta), torch.empty((8, 3), **meta),
                8, 8)
        elif kernel == "fft_stage":
            fft_kernel.fft_stage_hopper(
                torch.empty((2, 16), **meta),
                torch.empty(16, dtype=torch.int32, **meta),
                torch.empty((2, 4, 4), **meta), 2, 2)
        else:
            fir_kernel.fir_conv_hopper(
                torch.empty((2, 16), **meta),
                torch.empty((4, 5), dtype=torch.int32, **meta),
                torch.empty((5, 4), **meta))


def test_one_library_holds_every_source():
    """Every ``csrc/*.cu`` is built into the one library, each exported C
    function has a ctypes signature, and the digest covers every
    source."""
    names = {p.name for p in tk.SOURCES}
    assert names == {"bitserial_mm.cu", "fft_stage.cu", "fir_conv.cu",
                     "flash_attention.cu", "shuffle_gemm.cu"}
    exported = {m for p in tk.SOURCES for m in re.findall(
        r"^int (repro_\w+)\(", p.read_text(), re.M)}
    assert exported == set(tk._SIGNATURES)


def test_build_digest_changes_with_any_source(tmp_path, monkeypatch):
    copies = []
    for p in tk.SOURCES:
        q = tmp_path / p.name
        q.write_bytes(p.read_bytes())
        copies.append(q)
    monkeypatch.setattr(tk, "SOURCES", tuple(copies))
    before = tk._digest()
    copies[0].write_bytes(copies[0].read_bytes() + b"\n")
    assert tk._digest() != before
    monkeypatch.setattr(tk, "NVCC_FLAGS", tk.NVCC_FLAGS + ("-lineinfo",))
    assert tk._digest() not in (before,)
