"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain PyTorch versions on the same card tensors, the Fig-9 path on the
``hopper`` backend against the ``reference`` backend on the card, the
int-routed (SigQuant) Fig-9q forward, the shuffle-GEMM kernels' backward
Function and ``value_and_grad`` on the card, the chain kernel (a list of
grouped steps in one launch) bit for bit its steps launched one at a time,
flash attention, streaming on ``hopper`` (a runner and lock-stepped
sessions against the offline compile, their launches a tick, gradients
through the runner, a session's checkpoint round trip), and
``shuffle_gemm_blocks`` with one operand a batch row (each row bit for
bit the shared-operand launch on its operand) with SigSched's
cross-graph wave of two Fig-9 registrations with different params,
SigMesh (a meshed wave and a meshed tick bit for bit the unmeshed ones,
their launches counted), the multi-device models (two gloo ranks on the
card through the staged group: its collectives, and a sharded train
step against one process), and the dense decoders: five reduced configs on the card against the port
on the CPU (float32, rtol 1e-4, atol 1e-5), gemma2-2b at full width
past its window on the bf16 flash kernel (each call within relative L2
1e-2 of the plain version, the local ring cache), and greedy
``DecodeWave`` against ``generate`` bit for bit.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False; whether a card is present is
decided inside the ``cuda`` fixture, never at import.  The file imports
no JAX, so it runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: shuffle-GEMM kernels rtol = atol = 1e-5 in float32 and 2e-2
in bfloat16; both bitserial kernels (planes, and the int route's
quantize -> GEMM -> dequantize in one launch) bit-exact; the FFT stage
and phased FIR kernels rtol = atol = 1e-4 (the JAX package's tolerance
for them), the full FFT 2e-3 against ``torch.fft.fft``; graph outputs
rtol 1e-4, atol 1e-5; served against offline ``out`` atol 1e-5 and
``mel_tap`` rtol = atol = 1e-4; the int-routed Fig-9q forward within the
SigQuant budget (relative L2 1e-2) of the float32 reference; gradients
through the backward Function rtol = atol = 1e-5 against autograd
through the plain versions (atol 1e-4 on ``dw``, a float32 sum of
thousands of terms), and Fig-9 gradients on ``hopper`` against
``reference`` rtol 1e-4, atol 1e-5 (the forward's card tolerance: sums
run in another order); flash attention rtol = atol = 1e-4 in float32, as
in the JAX package's tests, and a max abs error of 1e-5 (the split-TF32
body: three TF32 products for each float32 one), and in bfloat16 (tensor
cores, P rounded to bfloat16) rtol 1e-2, atol 5e-3 and a relative L2
error under 1e-2; the float32 pre-pass bit for bit its plain version.
The one-launch ``fft_hopper`` equals its plain version bit for bit; the
phased FIR kernel, unrolled or generic, its plain version at 1e-5.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.convert import params_from_jax
from repro_torch.kernels import bitserial_mm
from repro_torch.kernels.fft_stage import kernel as fft_kernel
from repro_torch.kernels.fft_stage import ops as fft_ops
from repro_torch.kernels.fft_stage import ref as fft_ref
from repro_torch.kernels.fir_conv import kernel as fir_kernel
from repro_torch.kernels.fir_conv import ops as fir_ops
from repro_torch.kernels.fir_conv import ref as fir_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.shuffle_gemm import (
    launch_counts, ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks,
    reset_launch_counts, shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SignalRequest, SignalService
from repro_torch.signal import HopperBackend, PrecisionPolicy, SignalGraph

from _chip_smoke_module import chip_smoke

pytestmark = pytest.mark.gpu

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LENGTH, CH = 4096, (2, 12, 12, 1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, dev, dt, rows, t, n_out, groups, n_in, pad, scaled):
    idx = rng.integers(0, n_in, (rows, t)).astype(np.int32)
    if pad:
        idx[rng.random((rows, t)) < 0.25] = -1
    w_shape = (groups, t, n_out) if groups else (t, n_out)
    arrays = dict(
        x=rng.standard_normal((4, n_in)), idx=idx,
        pad_vals=rng.standard_normal((rows, t)),
        w=rng.standard_normal(w_shape),
        scale=rng.standard_normal((rows, t)) if scaled else None)
    return {k: None if v is None else torch.as_tensor(v).to(
        dev, torch.int32 if k == "idx" else TDT[dt])
        for k, v in arrays.items()}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,t,n_out,n_in,pad,scaled", [
    (4096, 9, 1, 4096, True, False),       # Fig-9 front.taps
    (31, 129, 24, 3999, False, False),     # Fig-9 mel_tap.mel
    (1000, 5, 3, 777, True, True),         # ragged edge, PAD and scale
])
def test_blocks_kernel_matches_plain(cuda, dt, rows, t, n_out, n_in, pad,
                                     scaled):
    a = _case(np.random.default_rng(rows), cuda, dt, rows, t, n_out, 0,
              n_in, pad, scaled)
    before = shuffle_gemm_blocks.launches
    got = shuffle_gemm_blocks(**a)
    torch.cuda.synchronize()
    assert shuffle_gemm_blocks.launches == before + 1
    assert got.dtype == TDT[dt] and got.device.type == "cuda"
    want = ref_shuffle_gemm_blocks(**a)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt],
                               atol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,pad,scaled", [(1, True, True),
                                               (8, False, False),
                                               (128, False, True)])
def test_grouped_kernel_matches_plain(cuda, dt, groups, pad, scaled):
    """Fig-9 butterflies: rows 3968 = 31 x 128, t 4, n_out 4."""
    rows, reps, nb = 3968, 31, 128 // groups
    a = _case(np.random.default_rng(groups), cuda, dt, rows, 4, 4, groups,
              8192, pad, scaled)
    before = shuffle_gemm_grouped_blocks.launches
    got = shuffle_gemm_grouped_blocks(reps=reps, groups=groups, nb=nb, **a)
    torch.cuda.synchronize()
    assert shuffle_gemm_grouped_blocks.launches == before + 1
    want = ref_shuffle_gemm_grouped_blocks(reps=reps, groups=groups, nb=nb,
                                           **a)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt],
                               atol=TOL[dt])


def test_wrapper_refuses_bad_inputs(cuda):
    a = _case(np.random.default_rng(0), cuda, "float32", 64, 4, 2, 0, 100,
              True, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        shuffle_gemm_blocks(**{**a, "x": a["x"].double()})
    with pytest.raises(TypeError, match="int32"):
        shuffle_gemm_blocks(**{**a, "idx": a["idx"].long()})
    with pytest.raises(ValueError, match="contiguous"):
        shuffle_gemm_blocks(**{**a, "w": a["w"].t().contiguous().t()})
    with pytest.raises(ValueError, match="cpu"):
        shuffle_gemm_blocks(**{**a, "w": a["w"].cpu()})


def test_compiled_supported(cuda):
    assert tk.compiled_supported() is True


def _fig9(backend, dev):
    rng = np.random.default_rng(0)
    cnn = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
           .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=dev)
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, fuse=2,
                                               backend=backend, device=dev)
    with torch.no_grad():
        return c(x, {"mask": params_from_jax(cnn, device=dev)})


def test_fig9_forward_launches_and_matches_reference(cuda):
    reset_launch_counts()
    got = _fig9("hopper", cuda)
    torch.cuda.synchronize()
    # the FIR taps and mel GEMMs, then the STFT's and iSTFT's 8
    # butterflies each in one chain launch
    assert launch_counts() == {"shuffle_gemm_blocks": 2,
                               "shuffle_gemm_grouped_blocks": 0,
                               "shuffle_gemm_chain": 2}
    want = _fig9("reference", cuda)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_served_equals_offline(cuda):
    rng = np.random.default_rng(1)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    lens = [LENGTH - 500 - 200 * i for i in range(8)]
    xs = [rng.standard_normal(t).astype(np.float32) for t in lens]
    g = tse.build_graph(LENGTH, ch=CH)
    svc = SignalService(batch_size=4, backend="hopper", device=cuda)
    svc.register("se", g, params={"mask": cnn})
    reset_launch_counts()
    res = svc.serve([SignalRequest(rid=i, graph="se", samples=x)
                     for i, x in enumerate(xs)])
    assert launch_counts() == {"shuffle_gemm_blocks": 4,
                               "shuffle_gemm_grouped_blocks": 0,
                               "shuffle_gemm_chain": 4}
    with torch.no_grad():
        for i, t in enumerate(lens):
            off = g.compile(t, backend="hopper", device=cuda)(
                torch.as_tensor(xs[i][None], device=cuda), {"mask": cnn})
            np.testing.assert_allclose(res[i]["out"],
                                       off["out"][0].cpu().numpy(),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(res[i]["mel_tap"],
                                       off["mel_tap"][0].cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)


# -- per-row operands (SigSched's cross-graph waves) ------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 9, 33, 129])
@pytest.mark.parametrize("n_out", [1, 24, 64])
@pytest.mark.parametrize("b", [1, 4, 65])
def test_blocks_kernel_per_row_w(cuda, dt, t, n_out, b):
    """w (B, t, n_out): one launch, batch row i bit for bit the shared-w
    launch on w[i] (both bodies: t < 32 sequential, t >= 32 staged); a
    rank-2 call unchanged, bit for bit the per-row call on its operand
    repeated; within the tolerance of the plain version."""
    rng = np.random.default_rng(1000 * t + 10 * n_out + b)
    rows, n_in = 31, 3999
    idx = rng.integers(0, n_in, (rows, t)).astype(np.int32)
    idx[rng.random((rows, t)) < 0.2] = -1
    dev = dict(device=cuda, dtype=TDT[dt])
    x = torch.as_tensor(rng.standard_normal((b, n_in))).to(**dev)
    pads = torch.as_tensor(rng.standard_normal((rows, t))).to(**dev)
    scale = torch.as_tensor(rng.standard_normal((rows, t))).to(**dev)
    w = torch.as_tensor(rng.standard_normal((b, t, n_out))).to(**dev)
    idx = torch.as_tensor(idx, device=cuda)
    before = shuffle_gemm_blocks.launches
    got = shuffle_gemm_blocks(x, idx, pads, w, scale)
    torch.cuda.synchronize()
    assert shuffle_gemm_blocks.launches == before + 1
    assert tuple(got.shape) == (b, rows, n_out)
    for i in range(b):
        assert torch.equal(got[i], shuffle_gemm_blocks(x, idx, pads, w[i],
                                                       scale)[i])
    shared = shuffle_gemm_blocks(x, idx, pads, w[0], scale)
    assert torch.equal(shared, shuffle_gemm_blocks(
        x, idx, pads, w[0].expand(b, t, n_out).contiguous(), scale))
    torch.testing.assert_close(
        got.float(), ref_shuffle_gemm_blocks(x, idx, pads, w, scale).float(),
        rtol=TOL[dt], atol=TOL[dt])


def test_blocks_kernel_per_row_refusals(cuda):
    x = torch.ones((3, 10), device=cuda)
    idx = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    pads = torch.zeros((2, 4), device=cuda)
    with pytest.raises(ValueError, match="operands"):
        shuffle_gemm_blocks(x, idx, pads, torch.ones((2, 4, 1), device=cuda))
    from repro_torch.core.fabric import ShufflePlan
    plan = ShufflePlan(gather_idx=np.arange(8, dtype=np.int32),
                       pad_values=np.zeros(8, np.float32))
    w = torch.ones((3, 4, 1), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tk.shuffle_gemm(x, plan, w, rows=2)
    with torch.no_grad():
        y = tk.shuffle_gemm(x, plan, w, rows=2)
    assert tuple(y.shape) == (3, 2, 1) and bool((y == 4).all())


def test_cross_graph_wave_with_per_row_params(cuda):
    """Two Fig-9 registrations with different FIR taps and mask weights:
    one wave of 2 blocks (the FIR call on per-row operands) + 2 chain
    launches, each row within the served tolerances of its own graph's
    offline compile.  Rows 0 and 1 (graphs a and b) share a length, so
    the mask CNN runs them as one call under torch.func.vmap; the other
    rows run alone."""
    rng = np.random.default_rng(2)
    lens = [LENGTH - 500 - 200 * max(i - 1, 0) for i in range(8)]
    xs = [rng.standard_normal(t).astype(np.float32) for t in lens]
    params = {}
    for name in "ab":
        taps = (rng.standard_normal(9) * 0.3).astype(np.float32)
        taps[0] = 1.0
        params[name] = {"front": {"taps": torch.as_tensor(taps, device=cuda)},
                        "mask": params_from_jax(
            [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
             .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
            device=cuda)}
    g = tse.build_graph(LENGTH, ch=CH)
    svc = SignalService(batch_size=8, backend="hopper", device=cuda)
    for name in "ab":
        svc.register(name, g, params=params[name])
    for x in xs[:2]:                 # compile the bucket outside the count
        svc.serve([SignalRequest(rid=-1, graph="a", samples=x)])
    reset_launch_counts()
    res = svc.serve([SignalRequest(rid=i, graph="ab"[i % 2], samples=x)
                     for i, x in enumerate(xs)])
    assert svc.stats["param_splits"] == 0
    assert svc.scheduler.stats["cross_graph_batches"] == 1
    assert launch_counts() == {"shuffle_gemm_blocks": 2,
                               "shuffle_gemm_grouped_blocks": 0,
                               "shuffle_gemm_chain": 2}
    with torch.no_grad():
        for i, t in enumerate(lens):
            off = g.compile(t, backend="hopper", device=cuda)(
                torch.as_tensor(xs[i][None], device=cuda),
                params["ab"[i % 2]])
            np.testing.assert_allclose(res[i]["out"],
                                       off["out"][0].cpu().numpy(),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(res[i]["mel_tap"],
                                       off["mel_tap"][0].cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)


# -- the kernels of the precision slice and the entry points ----------------

@pytest.mark.parametrize("aw,ww", [(4, 4), (8, 4), (8, 8), (16, 8),
                                   (16, 16), (4, 16)])
@pytest.mark.parametrize("m,k,n", [(16384, 9, 1),     # Fig-9q front.taps
                                   (7936, 256, 64),   # Fig-9q mask.gemm
                                   (124, 129, 24),    # Fig-9q mel_tap.mel
                                   (37, 53, 19)])
def test_bitserial_kernel_is_exact(cuda, aw, ww, m, k, n):
    rng = np.random.default_rng(aw * 100 + ww + m)
    a = torch.as_tensor(rng.integers(-2 ** (aw - 1) + 1, 2 ** (aw - 1),
                                     (m, k)), dtype=torch.int32, device=cuda)
    w = torch.as_tensor(rng.integers(-2 ** (ww - 1) + 1, 2 ** (ww - 1),
                                     (k, n)), dtype=torch.int32, device=cuda)
    before = bitserial_mm.bitserial_matmul_planes.launches
    got = bitserial_mm.bitserial_matmul(a, w, aw, ww)
    torch.cuda.synchronize()
    assert bitserial_mm.bitserial_matmul_planes.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, bitserial_mm.ref_bitserial_matmul(a, w))
    want = bitserial_mm.ref_bitserial_matmul(a.cpu(), w.cpu())
    assert torch.equal(got.cpu(), want)


def test_bitserial_kernel_wraps_like_int32(cuda):
    """16x16-bit operands whose exact products leave the int32 range."""
    rng = np.random.default_rng(7)
    a = rng.integers(-32767, 32768, (64, 96))
    w = rng.integers(-32767, 32768, (96, 40))
    assert np.abs(a @ w).max() > 2 ** 31
    at = torch.as_tensor(a, dtype=torch.int32, device=cuda)
    wt = torch.as_tensor(w, dtype=torch.int32, device=cuda)
    got = bitserial_mm.bitserial_matmul(at, wt, 16, 16).cpu()
    want = ((a @ w + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def _digit_planes(rng, planes, rows, cols, dev):
    """int8 planes of non-canonical digits in [-8, 16) on every plane."""
    return torch.as_tensor(rng.integers(-8, 16, (planes, rows, cols)),
                           dtype=torch.int8, device=dev)


@pytest.mark.parametrize("k", [9, 32, 129, 256, 300])
@pytest.mark.parametrize("pa,pw", [(pa, pw) for pa in (1, 2, 4)
                                   for pw in (1, 2, 4)])
def test_bitserial_planes_kernel_is_exact(cuda, pa, pw, k):
    """The MMA planes kernel against the plain version on the same card
    tensors, bit for bit, over N 1, 24, 64, 200 (both tile shapes, ragged
    in M, N and K; K 32 and 256 take cp.async, the rest plain loads;
    K 300 takes two chunks)."""
    rng = np.random.default_rng(100 * pa + 10 * pw + k)
    for n in (1, 24, 64, 200):
        a = _digit_planes(rng, pa, 130, k, cuda)
        w = _digit_planes(rng, pw, k, n, cuda)
        before = bitserial_mm.bitserial_matmul_planes.launches
        got = bitserial_mm.bitserial_matmul_planes(a, w)
        torch.cuda.synchronize()
        assert bitserial_mm.bitserial_matmul_planes.launches == before + 1
        want = bitserial_mm.ref_bitserial_matmul_planes(a, w)
        assert torch.equal(got, want), (n, (got != want).nonzero()[:4])
        assert torch.equal(
            got.cpu(), bitserial_mm.ref_bitserial_matmul_planes(a.cpu(),
                                                                w.cpu()))


def test_bitserial_planes_kernel_unaligned_rows(cuda):
    """K a multiple of 16 but planes at an odd address: plain loads."""
    rng = np.random.default_rng(1)
    buf = torch.as_tensor(rng.integers(-8, 16, 2 * 70 * 32 + 1),
                          dtype=torch.int8, device=cuda)
    a = buf[1:].view(2, 70, 32)
    assert a.is_contiguous() and a.data_ptr() % 16
    w = _digit_planes(rng, 4, 32, 24, cuda)
    got = bitserial_mm.bitserial_matmul_planes(a, w)
    assert torch.equal(got, bitserial_mm.ref_bitserial_matmul_planes(a, w))


QUANT_SHAPES = [(16384, 9, 1),        # Fig-9q front.taps
                (496, 256, 64),       # Fig-9q mask.gemm
                (124, 129, 24),       # Fig-9q mel_tap.mel
                (37, 300, 200),       # two K chunks, wide N
                (300, 300, 3)]        # three K chunks, narrow N


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("aw,ww", [(4, 4), (8, 4), (8, 8), (16, 8),
                                   (16, 16)])
def test_bitserial_quant_kernel_is_exact(cuda, aw, ww, shape):
    """The one-launch quantize -> GEMM -> dequantize kernel against its
    plain version on the same card tensors and on the CPU, bit for bit,
    with a zero row and a NaN row (all NaN out, no other row touched)."""
    r, k, n = shape
    rng = np.random.default_rng(aw * 1000 + ww * 10 + k)
    h = (rng.standard_normal((r, k))
         * np.exp(rng.uniform(-4, 4, (r, 1)))).astype(np.float32)
    h[1] = 0.0
    h[2, k // 2] = np.nan
    w = rng.standard_normal((k, n)).astype(np.float32)
    ht, wt = (torch.as_tensor(v, device=cuda) for v in (h, w))
    before = bitserial_mm.bitserial_quant_matmul_hopper.launches
    got = bitserial_mm.bitserial_quant_matmul_hopper(ht, wt, aw, ww)
    torch.cuda.synchronize()
    assert bitserial_mm.bitserial_quant_matmul_hopper.launches == before + 1
    want = bitserial_mm.ref_bitserial_quant_matmul(ht, wt, aw, ww)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    on_cpu = bitserial_mm.ref_bitserial_quant_matmul(ht.cpu(), wt.cpu(), aw,
                                                     ww)
    torch.testing.assert_close(got.cpu(), on_cpu, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(got[2]).all() and not got[1].any()
    assert torch.isfinite(got[3:]).all()


@pytest.mark.parametrize("shape", [(37, 300, 200), (300, 300, 3),
                                   (1000, 700, 64), (4096, 520, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bitserial_quant_kernel_repeats_over_k_chunks(cuda, shape):
    """K over more than one staged chunk (256 digits for N > 8, 128 for
    N <= 8), with every row's and column's largest magnitude in the last
    chunk: the kernel stages chunk 0 again for its second pass while the
    maxima of the last are being taken, so a missing barrier there shows
    as a too-small scale.  20 launches, each bit for bit the plain
    version."""
    r, k, n = shape
    rng = np.random.default_rng(k + n)
    h = rng.standard_normal((r, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    h[:, -4:] *= 1000.0
    w[-4:] *= 1000.0
    ht, wt = (torch.as_tensor(v, device=cuda) for v in (h, w))
    for aw, ww in ((8, 8), (16, 16)):
        want = bitserial_mm.ref_bitserial_quant_matmul(ht, wt, aw, ww)
        for _ in range(20):
            got = bitserial_mm.bitserial_quant_matmul_hopper(ht, wt, aw, ww)
            assert torch.equal(got, want), (aw, ww)


def test_quantize_is_the_same_on_the_card(cuda):
    """``quantize`` divides by ``qmax`` as a tensor, so its scale and
    integers on the card are the CPU's bit for bit (a division by the
    Python number would multiply by its reciprocal there)."""
    from repro_torch.core import bitwidth as bw
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2000, 16))
         * np.exp(rng.uniform(-5, 5, (2000, 1)))).astype(np.float32)
    for width in (4, 8, 16):
        q_gpu, s_gpu = bw.quantize(torch.as_tensor(x, device=cuda), width)
        q_cpu, s_cpu = bw.quantize(torch.as_tensor(x), width)
        assert torch.equal(s_gpu.cpu(), s_cpu) and torch.equal(q_gpu.cpu(),
                                                               q_cpu)


def test_fft_stage_kernel_matches_plain(cuda):
    """Every stage of a 256-point FFT over the 124 Fig-9 STFT frames."""
    rng = np.random.default_rng(3)
    z = torch.as_tensor((rng.standard_normal((124, 256))
                         + 1j * rng.standard_normal((124, 256)))
                        .astype(np.complex64), device=cuda)
    plan = fft_ops._plan(256)
    xr = torch.view_as_real(z).reshape(124, -1).contiguous()
    for st in plan.stages:
        idx = fft_ops._stage_index(st, cuda)
        tw = torch.as_tensor(st.twiddle, device=cuda)
        before = fft_kernel.fft_stages_hopper.launches
        got = fft_kernel.fft_stage_hopper(xr, idx, tw, st.half, st.nb)
        torch.cuda.synchronize()
        assert fft_kernel.fft_stages_hopper.launches == before + 1
        want = fft_ref.ref_fft_stage_hopper(xr, idx, tw, st.half, st.nb)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        xr = got
    torch.testing.assert_close(fft_ops.fft_hopper(z), torch.fft.fft(z),
                               rtol=2e-3, atol=2e-3)


def _frames(n, batch=124, seed=5):
    rng = np.random.default_rng(seed + n)
    return ((rng.standard_normal((batch, n))
             + 1j * rng.standard_normal((batch, n))).astype(np.complex64))


@pytest.mark.parametrize("n", [2, 8, 256, 4096])
def test_fft_hopper_one_launch_matches_plain(cuda, n):
    """n <= 8192: every stage and the final scatter in one launch, bit
    for bit the plain stages on the same card tensors."""
    z = torch.as_tensor(_frames(n), device=cuda)
    fft_kernel.reset_launch_counts()
    got = fft_ops.fft_hopper(z)
    torch.cuda.synchronize()
    assert fft_kernel.launch_counts() == {"fft_stages_hopper": 1}
    xb = torch.view_as_real(z).reshape(z.shape[0], -1)
    idx, tw, nb, scatter = fft_ops._stage_list(fft_ops._plan(n), cuda,
                                               torch.float32)
    want = fft_ref.ref_fft_stages_hopper(xb, idx, tw, nb, scatter)
    assert torch.equal(torch.view_as_real(got).reshape(xb.shape), want)
    torch.testing.assert_close(got, torch.fft.fft(z), rtol=2e-3, atol=2e-3)


def test_fft_hopper_per_stage_branch(cuda):
    """n above the shared-memory limit: one launch a stage (log2 n) from
    device memory, then the scatter through apply_plan."""
    n = 2 * fft_ops.FUSED_MAX_N
    z = torch.as_tensor(_frames(n, batch=3), device=cuda)
    fft_kernel.reset_launch_counts()
    got = fft_ops.fft_hopper(z)
    torch.cuda.synchronize()
    assert fft_kernel.launch_counts() == {"fft_stages_hopper": 14}
    want = fft_ops.fft_hopper(z.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, torch.fft.fft(z), rtol=2e-3, atol=2e-3)


def test_fir_conv_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((4, 4096)).astype(np.float32),
                        device=cuda)
    h = torch.as_tensor((np.hanning(9) / np.hanning(9).sum())
                        .astype(np.float32), device=cuda)
    before = fir_kernel.fir_conv_hopper.launches
    got = fir_ops.fir_conv(x, h, phases=8)
    torch.cuda.synchronize()
    assert fir_kernel.fir_conv_hopper.launches == before + 1
    torch.testing.assert_close(got, fir_ref.ref_fir(x, h), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("batch", [1, 4, 65])
@pytest.mark.parametrize("phases", [1, 4, 8])
@pytest.mark.parametrize("win", [1, 9, 16, 23])
def test_fir_conv_kernel_matches_plain_on_any_table(cuda, win, phases,
                                                    batch):
    """The kernel on its own arguments, against its plain version at 1e-5:
    (16, 8), Fig 9's window and phases, takes the unrolled body, every
    other shape the generic one; M = 37 windows fills no block evenly,
    and a fifth of the indices are PAD (-1, read as 0)."""
    rng = np.random.default_rng(win * 100 + phases * 10 + batch)
    n, m = 200, 37
    x = torch.as_tensor(rng.standard_normal((batch, n)),
                        dtype=torch.float32, device=cuda)
    idx = rng.integers(0, n, (m, win))
    idx[rng.random((m, win)) < 0.2] = -1
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    wbank = torch.as_tensor(rng.standard_normal((win, phases)) / np.sqrt(win),
                            dtype=torch.float32, device=cuda)
    before = fir_kernel.fir_conv_hopper.launches
    got = fir_kernel.fir_conv_hopper(x, idx, wbank)
    torch.cuda.synchronize()
    assert fir_kernel.fir_conv_hopper.launches == before + 1
    assert got.shape == (batch, m * phases)
    torch.testing.assert_close(
        got, fir_ref.ref_fir_conv_hopper(x, idx, wbank), rtol=1e-5,
        atol=1e-5)


def test_new_wrappers_refuse_bad_inputs(cuda):
    a = torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        bitserial_mm.bitserial_matmul_planes(a.int(), a.transpose(1, 2))
    with pytest.raises(ValueError, match="planes"):     # any count >= 1
        bitserial_mm.bitserial_matmul_planes(a[:0].contiguous(),
                                             a.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="contracts"):
        bitserial_mm.bitserial_matmul_planes(a, a)
    qa = bitserial_mm.bitserial_quant_matmul_hopper
    h, wq = torch.zeros((4, 8), device=cuda), torch.zeros((8, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        qa(h.double(), wq, 8, 8)
    with pytest.raises(ValueError, match="cpu"):
        qa(h, wq.cpu(), 8, 8)
    with pytest.raises(ValueError, match="K > 0"):
        qa(h, wq.T.contiguous(), 8, 8)
    with pytest.raises(ValueError, match="K > 0"):
        qa(h[None], wq, 8, 8)
    with pytest.raises(ValueError, match="widths"):
        qa(h, wq, 12, 8)
    x = torch.zeros((2, 16), device=cuda)
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    tw = torch.zeros((2, 4, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fft_kernel.fft_stage_hopper(x.double(), idx, tw, 2, 2)
    with pytest.raises(ValueError, match="shapes"):
        fft_kernel.fft_stage_hopper(x, idx[:8], tw, 2, 2)
    with pytest.raises(ValueError, match="cpu"):
        fir_kernel.fir_conv_hopper(x, idx.reshape(2, 8).cpu(),
                                 torch.zeros((8, 2), device=cuda))


def _fig9q(length, frame=64, hop=32, n_mels=12):
    g = SignalGraph("fig9q")
    g.fir("front", "input", taps=np.hanning(9) / np.hanning(9).sum())
    g.stft("spec", "front", frame=frame, hop=hop)
    g.magnitude("mag", "spec", onesided=False)
    g.dnn_circulant("mask", "mag", frame, block=4,
                    activation=lambda v: torch.sigmoid(v - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=hop, length=length)
    g.magnitude("m2", "enh", onesided=True)
    g.mel_filterbank("mel", "m2", sr=16_000, n_mels=n_mels)
    g.outputs("out", "mel")
    return g


def test_int_routed_fig9q_forward(cuda):
    """Fig-9q at length 512 under its SigQuant policy: every routed step
    is one launch of the fused quantize -> GEMM -> dequantize kernel, and
    the outputs stay within the budget of the float32 reference."""
    policy = PrecisionPolicy(widths={"front.taps": (8, 8),
                                     "mask.gemm": (16, 8),
                                     "mel.mel": (16, 8)})
    c = _fig9q(512).compile(512, backend=HopperBackend(precision=policy),
                            device=cuda)
    assert c.lowering_report()["array_passes"]["int_routed"] == 3
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 512))
                        .astype(np.float32), device=cuda)
    bitserial_mm.reset_launch_counts()
    with torch.no_grad():
        got = c(x)
        torch.cuda.synchronize()
        assert bitserial_mm.launch_counts() == {
            "bitserial_matmul_planes": 0, "bitserial_quant_matmul_hopper": 3}
        want = c.with_backend("reference")(x)
    for k in ("out", "mel"):
        err = float(torch.linalg.vector_norm(got[k] - want[k])
                    / torch.linalg.vector_norm(want[k]))
        assert torch.isfinite(got[k]).all() and err <= 1e-2, (k, err)


# -- the training slice: backward Function, value_and_grad -----------------

def _plan(rng, n_in, n_out):
    from repro_torch.core.fabric import PAD, ShufflePlan
    idx = rng.integers(0, n_in, n_out).astype(np.int32)
    idx[rng.random(n_out) < 0.2] = PAD
    return ShufflePlan(idx, rng.standard_normal(n_out).astype(np.float32)
                       * (idx == PAD))


def _grads(fn, x0, w0, dy):
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = fn(x, w)
    y.backward(dy)
    return y.detach(), x.grad, w.grad


@pytest.mark.parametrize("grouped", [False, True])
def test_backward_functions_match_autograd(cuda, grouped):
    """Gradients through the backward Function (identity-gather GEMM,
    adjoint scatter-as-gather, dw einsum) on the card against autograd
    through the plain versions on the same card tensors."""
    rng = np.random.default_rng(int(grouped))
    if grouped:                          # a Fig-9 butterfly, groups 8
        reps, groups, nb, t, n_out, n_in = 31, 8, 16, 4, 4, 8192
    else:                                # the Fig-9 front-end taps
        reps, groups, nb, t, n_out, n_in = 1, 1, 4096, 9, 1, 4096
    rows = reps * groups * nb
    plan = _plan(rng, n_in, rows * t)
    diag = rng.standard_normal(rows * t).astype(np.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    x0 = f32(rng.standard_normal((4, n_in)))
    w0 = f32(rng.standard_normal((groups, t, n_out) if grouped
                                 else (t, n_out)))
    dy = f32(rng.standard_normal((4, rows * n_out) if grouped
                                 else (4, rows, n_out)))
    idx = torch.as_tensor(plan.gather_idx.reshape(rows, t), device=cuda)
    pads = f32(plan.pad_values.reshape(rows, t))
    scale = f32(diag.reshape(rows, t))
    if grouped:
        def kern(x, w):
            return tk.shuffle_gemm_grouped(x, plan, w, reps, groups, nb,
                                           diag=diag)

        def plain(x, w):
            return ref_shuffle_gemm_grouped_blocks(x, idx, pads, w, reps,
                                                   groups, nb, scale)
    else:
        def kern(x, w):
            return tk.shuffle_gemm(x, plan, w, rows, diag=diag)

        def plain(x, w):
            return ref_shuffle_gemm_blocks(x, idx, pads, w, scale)
    reset_launch_counts()
    got = _grads(kern, x0, w0, dy)
    torch.cuda.synchronize()
    # forward 1; backward: the transposed GEMM and the adjoint reduce
    assert launch_counts() == ({"shuffle_gemm_blocks": 1,
                                "shuffle_gemm_grouped_blocks": 2,
                                "shuffle_gemm_chain": 0}
                               if grouped else
                               {"shuffle_gemm_blocks": 3,
                                "shuffle_gemm_grouped_blocks": 0,
                                "shuffle_gemm_chain": 0})
    want = _grads(plain, x0, w0, dy)
    # y and dx at 1e-5; dw is a float32 sum over batch x rows (1,984
    # products of unit-variance terms for the butterfly, 16,384 for the
    # taps) that the einsum and autograd's matmul take in other orders:
    # atol 1e-4, about 2^-24 x sqrt(terms) x |terms| summed
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


def test_value_and_grad_on_hopper_launches_backward_kernels(cuda):
    """Fig 9 at full width: value_and_grad on ``hopper`` launches the
    shuffle-GEMM kernels in the backward pass (the 16 butterflies'
    transposed GEMMs and adjoint reductions as two chain launches, one a
    stage, and the STFT framing's adjoint on ``shuffle_gemm_blocks``; the
    front taps and mask CNN need no dx kernel) and equals the
    ``reference`` backend's gradients."""
    rng = np.random.default_rng(0)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    clean = torch.as_tensor(rng.standard_normal((4, LENGTH))
                            .astype(np.float32), device=cuda)
    got = {}
    for backend in ("hopper", "reference"):
        c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend=backend,
                                                   device=cuda)
        params = dict(c.init_params())
        params["mask"] = cnn
        vag = c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
        reset_launch_counts()
        got[backend] = vag(params, x, clean)
        torch.cuda.synchronize()
        if backend == "hopper":
            assert launch_counts() == {"shuffle_gemm_blocks": 2 + 1,
                                       "shuffle_gemm_grouped_blocks": 0,
                                       "shuffle_gemm_chain": 2 + 2}
    (lh, gh), (lr, gr) = got["hopper"], got["reference"]
    torch.testing.assert_close(lh, lr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gh["front"]["taps"], gr["front"]["taps"],
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(gh["mask"], gr["mask"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# -- the blocks form's wide-row body and the chain kernel ---------------------

@pytest.mark.parametrize("n_out", [1, 24, 64])
@pytest.mark.parametrize("t", [1, 2, 9, 33, 129, 300])
def test_blocks_kernel_wide_and_narrow_rows(cuda, t, n_out):
    """t < 32 takes the sequential body, t >= 32 the staged, split-K one
    (the mel call is t 129, n_out 24); both against the plain version,
    PAD entries and a scale included, rows 37 (a ragged last block)."""
    a = _case(np.random.default_rng(t * 100 + n_out), cuda, "float32", 37,
              t, n_out, 0, 500, True, True)
    before = shuffle_gemm_blocks.launches
    got = shuffle_gemm_blocks(**a)
    torch.cuda.synchronize()
    assert shuffle_gemm_blocks.launches == before + 1
    torch.testing.assert_close(got, ref_shuffle_gemm_blocks(**a), rtol=1e-5,
                               atol=1e-5)


def _record_chains(fn):
    """Run ``fn()`` with the chain wrapper, as ``ops.run_segments`` calls
    it, recorded: ``[(x, segment, ws)]`` with the tensors cloned."""
    from repro_torch.kernels.shuffle_gemm import ops
    orig, calls = ops.shuffle_gemm_chain, []

    def rec(x, seg, ws):
        calls.append((x.detach().clone(), seg,
                      [w.detach().clone() for w in ws]))
        return orig(x, seg, ws)
    ops.shuffle_gemm_chain = rec
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.shuffle_gemm_chain = orig
    return calls


def _assert_chain_exact(x, seg, ws):
    """One launch, ``torch.equal`` to the sub-steps launched one at a
    time, and within the float tolerance of the plain version."""
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    before = sgk.shuffle_gemm_chain.launches
    got = sgk.shuffle_gemm_chain(x, seg, ws)
    torch.cuda.synchronize()
    assert sgk.shuffle_gemm_chain.launches == before + 1
    want = sgk.shuffle_gemm_steps(x, seg, ws)
    torch.cuda.synchronize()
    bad = (got != want).nonzero()
    assert torch.equal(got, want), (seg.report(), bad[:4].tolist())
    tol = TOL["float32" if x.dtype == torch.float32 else "bfloat16"]
    torch.testing.assert_close(got.float(), sgk.ref_chain(x, seg, ws).float(),
                               rtol=tol, atol=tol)


def test_chain_kernel_equals_its_steps_on_fig9(cuda):
    """Fig 9's chains — the STFT and iSTFT butterflies of the forward,
    the backward lists of a value_and_grad step — each bit for bit its
    sub-steps launched one at a time."""
    rng = np.random.default_rng(0)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device=cuda)
    params = dict(c.init_params())
    params["mask"] = cnn
    vag = c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
    calls = _record_chains(lambda: vag(params, x, x))
    # forward: 8 butterflies a chain; backward: 8 transposed GEMMs, the
    # width-1 adjoint reductions folded into them, + the iSTFT's last
    # reduction (the STFT's, across frames, runs on shuffle_gemm_blocks)
    assert [len(seg.steps) for _, seg, _ in calls] == [8, 8, 9, 8]
    for x_, seg, ws in calls:
        assert seg.tiles * x_.shape[0] == 124
        _assert_chain_exact(x_, seg, ws)


def test_chain_kernel_with_a_table_copy_a_tile(cuda):
    """The Fig-9 STFT chain with every tile reading its own copy of its
    tables (the tiles' tables agree, so the segment keeps one copy; here
    each tile's rows are staged from their own place) — still bit for bit
    its sub-steps."""
    import dataclasses
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device=cuda)
    params = dict(c.init_params())
    params["mask"] = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    with torch.no_grad():
        calls = _record_chains(lambda: c(x, params))
    for x_, seg, ws in calls:
        own = dataclasses.replace(seg, periodic=(False,) * len(seg.steps),
                                  _device={})
        _assert_chain_exact(x_, own, ws)


def test_chain_wrapper_refuses_bad_inputs(cuda):
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    from repro_torch.kernels.shuffle_gemm.chain import segment_chain
    steps, ws, x = _grouped_chain(np.random.default_rng(0), cuda, "float32",
                                  2, 32, 100, False)
    (seg,) = segment_chain(steps)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sgk.shuffle_gemm_chain(x.double(), seg, ws)
    with pytest.raises(ValueError, match="one operand per sub-step"):
        sgk.shuffle_gemm_chain(x, seg, ws[:-1])
    with pytest.raises(ValueError, match="must be"):
        sgk.shuffle_gemm_chain(x, seg, [ws[0], ws[2], ws[1]])
    with pytest.raises(ValueError, match="reads past"):
        sgk.shuffle_gemm_chain(x[:, :10].contiguous(), seg, ws)


def _grouped_chain(rng, dev, dt, tiles, rpt, n_in, perm):
    """Three grouped sub-steps (G 1, 2, 4; t 4, n_out 4): the first reads
    anywhere in x (PAD entries, a scale), the later ones within their
    tile by a random table (``perm`` False) or a random permutation of
    the whole vector (``perm`` True, one tile a batch row)."""
    from repro_torch.core.fabric import ShufflePlan
    from repro_torch.kernels.shuffle_gemm.chain import SubStep
    steps, prev = [], None
    for i, g in enumerate((1, 2, 4)):
        rows = tiles * rpt
        if prev is None:
            idx = rng.integers(0, n_in, (rows, 4))
        elif perm:
            idx = rng.permutation(rows * 4).reshape(rows, 4)
        else:
            ept = prev.n_elems // tiles
            idx = (np.arange(rows) // rpt * ept)[:, None] \
                + rng.integers(0, ept, (rows, 4))
        idx = idx.astype(np.int32)
        if not perm:
            idx[rng.random(idx.shape) < 0.2] = -1
        plan = ShufflePlan(idx.ravel(), rng.standard_normal(idx.size)
                           .astype(np.float32))
        diag = None if i == 1 else rng.standard_normal(idx.size).astype(
            np.float32)
        prev = SubStep(f"s{i}", plan, diag, rows, 4, g, rpt // g)
        steps.append(prev)
    ws = [torch.as_tensor(rng.standard_normal((s.groups, 4, 4))).to(
        dev, TDT[dt]) for s in steps]
    x = torch.as_tensor(rng.standard_normal((3, n_in))).to(dev, TDT[dt])
    return steps, ws, x


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles,rpt,perm", [(5, 64, False), (1, 96, True),
                                            (40, 4, False)])
def test_chain_kernel_equals_its_steps(cuda, dt, tiles, rpt, perm):
    """Tiles with tables that differ (5 x 64 rows), one tile a batch row
    (no partition: a permutation of the whole vector), small tiles
    several to a block (40 x 4 rows), in float32 and bfloat16."""
    from repro_torch.kernels.shuffle_gemm.chain import segment_chain
    steps, ws, x = _grouped_chain(np.random.default_rng(tiles), cuda, dt,
                                  tiles, rpt, 300, perm)
    (seg,) = segment_chain(steps)
    assert seg.launch == "shuffle_gemm_chain" and seg.tiles == tiles
    if tiles == 40:
        assert seg.tiles_per_cta > 1
    _assert_chain_exact(x, seg, ws)


# -- flash attention ---------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap
    # (tests/test_flash_attention.py, and gemma2-2b's head dim)
    (2, 64, 64, 4, 4, 16, True, 0, 0.0),
    (2, 64, 64, 8, 2, 16, True, 0, 0.0),
    (1, 100, 100, 4, 2, 32, True, 24, 0.0),
    (2, 64, 64, 4, 4, 16, True, 0, 30.0),
    (2, 48, 48, 6, 3, 16, False, 0, 0.0),
    (1, 130, 130, 2, 1, 64, True, 0, 0.0),
    (1, 300, 300, 4, 2, 256, True, 100, 50.0),
    # Sq != Skv; rows of hd 20 (40 bytes) are no multiple of 16 bytes, so
    # bfloat16 loads them without TMA; hd 40 (80 bytes) takes TMA with the
    # head dim padded by its out-of-bounds fill
    (2, 77, 150, 4, 2, 20, True, 16, 0.0),
    (1, 150, 77, 6, 3, 40, False, 0, 30.0),
]
# float32: the JAX package's tests, and a max abs error of 1e-5;
# bfloat16: rtol 1e-2, atol 5e-3 and a relative L2 error under 1e-2, the
# limits chip_smoke.py holds at S 4096
FLASH_TOL = {torch.float32: (1e-4, 1e-4, None),
             torch.bfloat16: (1e-2, 5e-3, 1e-2)}
F32_MAX_ABS = 1e-5


def _qkv(rng, dev, dt, b, s, h, kv, hd, skv=None):
    skv = s if skv is None else skv
    return [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)
            for shape in ((b, s, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def _assert_flash_close(got, want, dt):
    rtol, atol, rel_l2 = FLASH_TOL[dt]
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if dt == torch.float32:
        err = float((got - want).abs().max())
        assert err <= F32_MAX_ABS, err
    if rel_l2 is not None:
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel < rel_l2, rel


def _launches_of(dt, fn):
    """Run ``fn`` and check the flash kernels' launches it made: one
    attention launch a call, plus the pre-pass in float32."""
    before = flash_kernel.launch_counts()
    got = fn()
    torch.cuda.synchronize()
    after = flash_kernel.launch_counts()
    made = {n: after[n] - before[n] for n in after if after[n] > before[n]}
    assert made == flash_kernel.LAUNCHES_PER_CALL[dt] == (
        {"flash_attention_hopper": 1} if dt == torch.bfloat16 else
        {"flash_attention_hopper": 1, "flash_split_kv_hopper": 1})
    return got


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dt):
    """Both types run on the tensor cores at every head dim, window,
    softcap, GQA/MQA and ragged shape here: bfloat16 in one launch,
    float32 in two (the pre-pass, then the split-TF32 body)."""
    b, sq, skv, h, kv, hd, causal, window, cap = case
    q, k, v = _qkv(np.random.default_rng(sq + h), cuda, dt, b, sq, h, kv, hd,
                   skv)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = _launches_of(dt, lambda: tk.flash_attention(q, k, v, **kw))
    _assert_flash_close(got, tk.ref_attention(q, k, v, **kw), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 128])
def test_flash_kernel_unaligned_base(cuda, dt, hd):
    """q, k and v start 4 bytes past a 16-byte boundary: bfloat16 takes
    its plain loads instead of TMA, float32's pre-pass and Q staging read
    any alignment (the bulk copies read only the aligned scratch)."""
    rng = np.random.default_rng(hd)
    shapes = ((1, 90, 4, hd), (1, 90, 2, hd), (1, 90, 2, hd))
    q, k, v = (torch.as_tensor(rng.standard_normal(int(np.prod(sh)) + 2),
                               dtype=torch.float32, device=cuda).to(dt)
               [2:].view(sh) for sh in shapes)
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    kw = dict(causal=True, window=40, softcap=20.0)
    got = _launches_of(dt, lambda: tk.flash_attention(q, k, v, **kw))
    _assert_flash_close(got, tk.ref_attention(q, k, v, **kw), dt)


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_kernel_f32_long_rows(cuda, hd):
    """Every query row sees 16384 keys (no causal mask, no window): the
    tensor cores truncate in their sums, so the float32 body's error
    grows with the keys a row sees; held at the JAX package's rtol = atol
    = 1e-4 against the plain version."""
    q, k, v = _qkv(np.random.default_rng(hd), cuda, torch.float32, 1, 256,
                   8, 2, hd, skv=16384)
    got = _launches_of(torch.float32,
                       lambda: tk.flash_attention(q, k, v, causal=False))
    torch.testing.assert_close(got, tk.ref_attention(q, k, v, causal=False),
                               rtol=1e-4, atol=1e-4)


def test_flash_f32_tiling_agrees_with_the_kernel(cuda):
    """The float32 tiling the wrapper and the plain pre-pass use
    (``ref.f32_tiling``) is the kernel's own (``Shape<D>``, read through
    ``repro_flash_f32_tiling``) at every head dim; 0 and 257 refused."""
    import ctypes
    lib = tk.library()
    d, bk = ctypes.c_int(), ctypes.c_int()
    for hd in range(1, flash_kernel.MAX_HEAD_DIM + 1):
        assert lib.repro_flash_f32_tiling(hd, ctypes.byref(d),
                                          ctypes.byref(bk)) == 0
        assert (d.value, bk.value) == flash_kernel.f32_tiling(hd), hd
    for hd in (0, flash_kernel.MAX_HEAD_DIM + 1):
        assert lib.repro_flash_f32_tiling(hd, ctypes.byref(d),
                                          ctypes.byref(bk)) != 0


@pytest.mark.parametrize("skv,kv,hd", [(150, 2, 20), (77, 3, 40),
                                       (300, 2, 256), (4096, 2, 128),
                                       (129, 1, 64)])
def test_flash_split_kv_kernel_is_exact(cuda, skv, kv, hd):
    """The float32 pre-pass bit for bit its plain version: K and V split
    into TF32 big and small, V transposed and key-permuted, laid out as
    the attention body's tile images, zero past hd and past Skv."""
    rng = np.random.default_rng(skv + hd)
    k, v = (torch.as_tensor(rng.standard_normal((2, skv, kv, hd)),
                            dtype=torch.float32, device=cuda)
            for _ in range(2))
    split = flash_kernel.flash_split_kv_hopper
    before = split.launches
    got = split(k, v)
    torch.cuda.synchronize()
    assert split.launches == before + 1
    assert torch.equal(got, flash_kernel.ref_split_kv(k, v))


def test_flash_split_kv_refuses_bad_inputs(cuda):
    split = flash_kernel.flash_split_kv_hopper
    k = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        split(k.to(torch.bfloat16), k.to(torch.bfloat16))
    with pytest.raises(ValueError, match="cpu"):
        split(k, k.cpu())
    with pytest.raises(ValueError, match="shapes"):
        split(k, k[:, :8].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 4, 1, 260), device=cuda)
        split(big, big)


def test_flash_kernel_bf16(cuda):
    q, k, v = _qkv(np.random.default_rng(7), cuda, torch.bfloat16, 2, 200,
                   8, 2, 128)
    got = tk.flash_attention(q, k, v)
    _assert_flash_close(got, tk.ref_attention(q, k, v), torch.bfloat16)


def test_flash_wrapper_refuses_bad_inputs(cuda):
    q, k, v = _qkv(np.random.default_rng(0), cuda, torch.float32, 1, 16, 4,
                   2, 16)
    fa = flash_kernel.flash_attention_hopper
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="float32"):
        fa(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="cpu"):
        fa(q, k.cpu(), v)
    with pytest.raises(ValueError, match="H % KV"):
        fa(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 4, 1, 260), device=cuda)
        fa(big, big, big)
    with pytest.raises(NotImplementedError, match="no backward"):
        tk.flash_attention(q.requires_grad_(), k, v)


# -- streaming on hopper: runner, lock-stepped sessions, gradients, ckpt -----

STREAM_TICK = {"shuffle_gemm_blocks": 1, "shuffle_gemm_grouped_blocks": 0,
               "shuffle_gemm_chain": 2}


def _stream_setup(dev, seed=0):
    rng = np.random.default_rng(seed)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=dev)
    g = tse.build_graph(LENGTH, ch=CH)
    c = g.compile(LENGTH, backend="hopper", device=dev)
    params = dict(c.init_params())
    params["mask"] = cnn
    return rng, g, c, params, cnn


def _stream_service(g, cnn, dev):
    svc = SignalService(backend="hopper", block_frames=8, device=dev)
    svc.register("se", g, params={"mask": cnn})
    return svc


def _drive(runner, x, splits):
    acc = {}
    for o in [runner.process(c) for c in torch.tensor_split(x, splits, -1)] \
            + [runner.flush()]:
        for k, v in o.items():
            acc.setdefault(k, []).append(v)
    return {k: torch.cat(v, dim=-1 if k == "out" else -2)
            for k, v in acc.items()}


def _hold(got, want):
    torch.testing.assert_close(got["out"], want["out"], rtol=0, atol=1e-5)
    torch.testing.assert_close(got["mel_tap"], want["mel_tap"], rtol=1e-5,
                               atol=1e-4)


def test_streaming_runner_matches_offline_on_card(cuda):
    """Fig 9 at full width, a batch of 4 in uneven chunks, blocks of 8
    frames on hopper, against the offline compile."""
    from repro_torch.signal import StreamingRunner
    rng, g, c, params, _ = _stream_setup(cuda)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    with torch.no_grad():
        got = _drive(StreamingRunner(g, params=params, block_frames=8,
                                     backend="hopper", device=cuda),
                     x, [256, 356, 1056, 1093])
        _hold(got, c(x, params))


def test_stream_sessions_one_core_call_and_its_launches_a_tick(cuda):
    """4 lock-stepped sessions, chunks of 256: at most one core call a
    tick, each the mel GEMM and the two butterfly chains; every session
    equals the offline compile and its private runner's stream."""
    from repro_torch.signal import StreamingRunner
    rng, g, c, params, cnn = _stream_setup(cuda, seed=1)
    svc = _stream_service(g, cnn, cuda)
    waves = [rng.standard_normal(LENGTH).astype(np.float32)
             for _ in range(4)]
    sessions = [svc.open_stream("se") for _ in waves]
    accs = [{} for _ in waves]
    for lo in range(0, LENGTH, 256):
        for s, w in zip(sessions, waves):
            s.feed(w[lo:lo + 256])
        reset_launch_counts()
        calls = svc.stream_step()
        torch.cuda.synchronize()
        assert calls <= 1
        assert launch_counts() == {n: k * calls for n, k in STREAM_TICK.items()}
        for acc, s in zip(accs, sessions):
            for k, v in s.read().items():
                acc.setdefault(k, []).append(v)
    for acc, s in zip(accs, sessions):
        for k, v in s.close().items():
            acc.setdefault(k, []).append(v)
    with torch.no_grad():
        for acc, w in zip(accs, waves):
            got = {k: torch.as_tensor(np.concatenate(
                v, axis=-1 if k == "out" else 0), device=cuda)
                for k, v in acc.items()}
            wt = torch.as_tensor(w, device=cuda)
            _hold(got, {k: v[0] for k, v in c(wt[None], params).items()})
            _hold(got, _drive(StreamingRunner(
                g, params=params, block_frames=8, backend="hopper",
                device=cuda), wt, list(range(256, LENGTH, 256))))


def test_streaming_gradients_launch_the_backward_kernels(cuda):
    """The loss of the streamed output differentiates through the carried
    state and the shuffle-GEMM backward Functions, equal to the offline
    value_and_grad."""
    from repro_torch.signal import StreamingRunner
    rng, g, c, params, cnn = _stream_setup(cuda, seed=2)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    clean = torch.as_tensor(rng.standard_normal((4, LENGTH))
                            .astype(np.float32), device=cuda)
    lo, go = c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)(params, x,
                                                              clean)
    taps = torch.tensor(np.asarray(params["front"]["taps"], np.float32),
                        device=cuda, requires_grad=True)
    mask = [w.detach().clone().requires_grad_() for w in cnn]
    r = StreamingRunner(g, params={**params, "front": {"taps": taps},
                                   "mask": mask},
                        block_frames=8, backend="hopper", device=cuda)
    loss = tse.loss_fn(_drive(r, x, [256, 356, 1056, 1093]), clean)
    reset_launch_counts()
    grads = torch.autograd.grad(loss, [taps, *mask])
    torch.cuda.synchronize()
    made = launch_counts()
    assert made["shuffle_gemm_blocks"] >= 1 and made["shuffle_gemm_chain"] >= 1
    torch.testing.assert_close(loss.detach(), lo, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grads[0], go["front"]["taps"], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(grads[1:], go["mask"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_stream_session_checkpoint_round_trip_on_card(cuda, tmp_path):
    """save_checkpoint mid-stream, restore_from_disk in a fresh service,
    the same feeds: the tails are equal bit for bit."""
    rng, g, c, params, cnn = _stream_setup(cuda, seed=3)
    w = rng.standard_normal(LENGTH).astype(np.float32)
    svc = _stream_service(g, cnn, cuda)
    s = svc.open_stream("se")
    for lo in range(0, LENGTH // 2, 256):
        s.feed(w[lo:lo + 256])
        svc.stream_step()
    s.read()
    svc.save_checkpoint(str(tmp_path / "ckpt"))
    svc2 = _stream_service(g, cnn, cuda)
    svc2.restore_from_disk(str(tmp_path / "ckpt"))
    s2 = svc2.session_by_sid(s.sid)
    assert s2.state.buf.device.type == "cuda"
    tails = []
    for sess, sv in ((s, svc), (s2, svc2)):
        acc = {}
        for lo in range(LENGTH // 2, LENGTH, 256):
            sess.feed(w[lo:lo + 256])
            sv.stream_step()
            for k, v in sess.read().items():
                acc.setdefault(k, []).append(v)
        for k, v in sess.close().items():
            acc.setdefault(k, []).append(v)
        tails.append(acc)
    for k in tails[0]:
        np.testing.assert_array_equal(
            np.concatenate(tails[0][k], axis=-1 if k == "out" else 0),
            np.concatenate(tails[1][k], axis=-1 if k == "out" else 0))


# -- SigMesh on the card: meshed waves and ticks against unmeshed -----------

FORWARD = {"shuffle_gemm_blocks": 2, "shuffle_gemm_grouped_blocks": 0,
           "shuffle_gemm_chain": 2}


def _mesh_service(g, cnn, dev, mesh=None):
    svc = SignalService(batch_size=4, backend="hopper", block_frames=8,
                        device=dev, mesh=mesh)
    svc.register("se", g, params={"mask": cnn})
    return svc


def test_meshed_wave_on_card_equals_unmeshed(cuda):
    """Fig 9 served on ``mesh=4`` over the card's devices: each wave of 4
    mixed-length requests is one call of 2 + 2 shuffle-GEMM launches on
    one card (the shards wrap onto it), every result equal bit for bit to
    the unmeshed service's, every shard charged its
    ``device_step_costs``; ``sharded_jit`` over ``make_data_mesh`` equals
    the plain call bit for bit."""
    from repro_torch.core.perf_model import device_step_costs
    from repro_torch.launch.mesh import make_data_mesh
    rng, g, c, params, cnn = _stream_setup(cuda, seed=4)
    sigs = [rng.standard_normal(LENGTH - 500 - 200 * i).astype(np.float32)
            for i in range(8)]
    unm, msh = _mesh_service(g, cnn, cuda), _mesh_service(g, cnn, cuda, 4)
    ref = unm.serve([SignalRequest(rid=i, graph="se", samples=x)
                     for i, x in enumerate(sigs)])
    for i, x in enumerate(sigs):
        msh.submit(SignalRequest(rid=i, graph="se", samples=x))
    got = {}
    while msh.pending():
        reset_launch_counts()
        got.update(msh.step())
        torch.cuda.synchronize()
        assert launch_counts() == FORWARD
    for i in ref:
        for k in ref[i]:
            np.testing.assert_array_equal(got[i][k], ref[i][k])
    per_item = msh.group_cost(("se", LENGTH))
    assert msh.router.device_cycles == [
        2 * c_ for c_ in device_step_costs(per_item, 4, 4)]
    x8 = torch.as_tensor(rng.standard_normal((8, LENGTH)).astype(
        np.float32), device=cuda)
    with torch.no_grad():
        want = c(x8, params)
        out = c.sharded_jit(make_data_mesh(device=cuda))(x8, params)
    for k in want:
        assert torch.equal(out[k], want[k])


def test_meshed_tick_on_card_equals_unmeshed(cuda):
    """4 sessions on ``mesh=4`` land on 4 shards and never stack: a tick
    is 4 core calls of the mel GEMM and two chains, and every session's
    stream equals the unmeshed sessions' (one stacked call a tick) bit
    for bit."""
    rng, g, _, _, cnn = _stream_setup(cuda, seed=5)
    waves = [rng.standard_normal(LENGTH).astype(np.float32)
             for _ in range(4)]
    outs = []
    for mesh in (None, 4):
        svc = _mesh_service(g, cnn, cuda, mesh)
        sessions = [svc.open_stream("se") for _ in waves]
        if mesh:
            assert sorted(s.device_index for s in sessions) == [0, 1, 2, 3]
        accs = [{} for _ in waves]
        for lo in range(0, LENGTH, 256):
            for s, w in zip(sessions, waves):
                s.feed(w[lo:lo + 256])
            reset_launch_counts()
            calls = svc.stream_step()
            torch.cuda.synchronize()
            assert calls in ((0, 4) if mesh else (0, 1))
            assert launch_counts() == {n: k * calls
                                       for n, k in STREAM_TICK.items()}
            for acc, s in zip(accs, sessions):
                for k, v in s.read().items():
                    acc.setdefault(k, []).append(v)
        for acc, s in zip(accs, sessions):
            for k, v in s.close().items():
                acc.setdefault(k, []).append(v)
        outs.append([{k: np.concatenate(v, axis=-1 if k == "out" else 0)
                      for k, v in acc.items()} for acc in accs])
    for a, b in zip(*outs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# -- dense models and the serving engine on the card ------------------------

MODEL_ARCHS = ["starcoder2-3b", "gemma2-2b", "chatglm3-6b", "minitron-8b",
               "internvl2-26b"]


def _model_batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        return {"embeds": torch.as_tensor(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32))}
    return {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (b, s)).astype(np.int32))}


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else
            v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_dense_model_on_card_matches_cpu(cuda, arch):
    """A reduced float32 decoder on the card (full-length attention on
    the float32 flash kernel, decode in plain torch) against the same
    port on the CPU: forward, prefill (logits and cache) and one decode
    step at rtol 1e-4, atol 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced()
    bundle = get_model(cfg)
    cpu_p = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    card_p = _on(cpu_p, cuda)
    batch = _model_batch(cfg, 1)
    s = next(iter(batch.values())).shape[1]

    def close(got, want):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        close(bundle.forward(card_p, _on(batch, cuda))[0],
              bundle.forward(cpu_p, batch)[0])
        head = {k: v[:, :s - 1] for k, v in batch.items()}
        last = {k: v[:, s - 1:] for k, v in batch.items()}
        lg, cg = bundle.prefill(card_p, _on(head, cuda), max_len=s + 2)
        lc, cc = bundle.prefill(cpu_p, head, max_len=s + 2)
        close(lg, lc)
        for name in cc["blocks"]:
            for leaf in ("k", "v"):
                close(cg["blocks"][name][leaf], cc["blocks"][name][leaf])
        close(bundle.decode_step(card_p, cg, _on(last, cuda))[0],
              bundle.decode_step(cpu_p, cc, last)[0])


def test_gemma2_full_width_past_window_on_flash(cuda):
    """gemma2-2b at its full width, 2 layers (one local, one global),
    bfloat16, a 5000-token prompt past the 4096 window: the local layer's
    call is the flash kernel with window 4096 and softcap 50, each call
    within relative L2 1e-2 of the plain version, and the local ring
    cache after prefill holds the last 4096 keys rolled by 5000 % 4096."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref_attention
    from repro_torch.models import get_model
    from repro_torch.models import layers as model_layers
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    assert cfg.layer_types == ("local", "global") and cfg.window == 4096
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    s = 5000
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, s)).astype(np.int32), device=cuda)
    calls, fa = [], model_layers.flash_attention

    def rec(q, k, v, **kw):
        calls.append((q.clone(), k.clone(), v.clone(), kw))
        return fa(q, k, v, **kw)
    model_layers.flash_attention = rec
    flash_kernel.reset_launch_counts()
    try:
        with torch.no_grad():
            logits, cache = bundle.prefill(params, {"tokens": toks},
                                           max_len=s + 4)
        torch.cuda.synchronize()
    finally:
        model_layers.flash_attention = fa
    assert flash_kernel.launch_counts() == {"flash_attention_hopper": 2,
                                            "flash_split_kv_hopper": 0}
    assert [c[3] for c in calls] == [
        dict(causal=True, window=4096, softcap=50.0),
        dict(causal=True, window=0, softcap=50.0)]
    with torch.no_grad():
        for q, k, v, kw in calls:
            assert q.dtype == torch.bfloat16 and q.shape[1] == s
            got, want = fa(q, k, v, **kw), ref_attention(q, k, v, **kw)
            rel = float((got.float() - want.float()).norm()
                        / want.float().norm())
            assert rel < 1e-2, rel
    ring = cache["blocks"]["b0"]["k"][0]
    assert tuple(ring.shape) == (1, 4096, cfg.n_kv_heads, cfg.head_dim)
    assert torch.equal(ring, torch.roll(calls[0][1][:, -4096:], s % 4096,
                                        dims=1))
    assert torch.equal(cache["blocks"]["b1"]["k"][0][:, :s], calls[1][1])
    assert bool(torch.isfinite(logits).all())
    assert float(logits.abs().max()) <= cfg.logit_softcap + 1e-3


def test_decode_wave_matches_generate_on_card(cuda):
    """Greedy ``DecodeWave`` stepped to the end gives ``generate``'s
    tokens bit for bit on the card (a bf16 reduced starcoder2), and each
    prefill launches the flash kernel once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeWave, Request, ServingEngine
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(
        n_layers=4, d_model=256, n_heads=8, d_ff=512, vocab=1024),
        dtype="bfloat16")
    bundle = get_model(cfg)
    eng = ServingEngine(bundle, batch_size=3)
    eng.load(bundle.init(torch.Generator(cuda).manual_seed(5),
                         device=cuda), device=cuda)
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(0, 1024, n).tolist(),
                    max_new=9) for i, n in enumerate((40, 17, 64))]
    flash_kernel.reset_launch_counts()
    wave = DecodeWave(eng, reqs)
    assert flash_kernel.launch_counts()["flash_attention_hopper"] == 4
    while not wave.done:
        wave.step()
    assert flash_kernel.launch_counts()["flash_attention_hopper"] == 4
    gen = eng.generate([r.prompt for r in reqs], max_new=9)
    assert wave.results() == {i: g for i, g in enumerate(gen)}
    assert eng.serve(reqs) == wave.results()


FAMILY_FLASH_CASES = [
    # B, Sq, Skv, H, KV, hd, causal, window, softcap: the serving shapes
    # of the families phase 12 of chip_smoke.py serves
    (2, 1500, 1500, 12, 12, 64, False, 0, 0.0),     # whisper-small encoder
    (1, 3072, 3072, 10, 1, 256, True, 2048, 0.0),   # recurrentgemma-2b local
    (1, 1024, 1024, 48, 8, 128, True, 0, 30.0),     # grok-1-314b
    (2, 2048, 2048, 16, 16, 128, True, 0, 0.0),     # qwen2-moe-a2.7b
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_FLASH_CASES)
def test_flash_kernel_at_family_serving_shapes(cuda, case, dt):
    """The flash kernel at the four new serving shapes (hd 64 non-causal
    over 1500 frames, a tile count no multiple of the block; MQA 10/1 at
    hd 256 with a window that bites; 48/8 heads with softcap 30; MHA at
    hd 128) against the plain version, at the limits of
    ``test_flash_kernel_matches_plain``."""
    b, sq, skv, h, kv, hd, causal, window, cap = case
    q, k, v = _qkv(np.random.default_rng(sq + h), cuda, dt, b, sq, h, kv, hd,
                   skv)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = _launches_of(dt, lambda: tk.flash_attention(q, k, v, **kw))
    _assert_flash_close(got, tk.ref_attention(q, k, v, **kw), dt)


FAMILY_ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "recurrentgemma-2b",
                "xlstm-350m", "whisper-small"]


def _family_batch(cfg, seed, b=2, s=40):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.input_kind == "encdec":
        batch["embeds"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return batch


def _close_trees(got, want, rtol, atol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_trees(got[k], want[k], rtol, atol)
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=rtol, atol=atol)
    else:
        assert got == want


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_model_on_card_matches_cpu(cuda, arch):
    """A reduced float32 model of each new family on the card against the
    same port on the CPU: forward logits and aux, prefill logits and every
    cache leaf, two decode steps, at rtol 1e-4, atol 1e-5 (xlstm-350m at
    atol 3e-4: its eight exponentially gated blocks amplify float32
    rounding about threefold a block, ``tests/test_torch_recurrent.py``).
    recurrentgemma's prompt of 40 passes its reduced window of 32."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced()
    tol = (1e-4, 3e-4) if arch == "xlstm-350m" else (1e-4, 1e-5)
    bundle = get_model(cfg)
    cpu_p = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    card_p = _on(cpu_p, cuda)
    batch = _family_batch(cfg, 3, s=42)

    def cut(lo, hi):
        return {k: v if k == "embeds" else v[:, lo:hi]
                for k, v in batch.items()}
    with torch.no_grad():
        (gl, ga), (cl, ca) = (bundle.forward(card_p, _on(cut(0, 40), cuda)),
                              bundle.forward(cpu_p, cut(0, 40)))
        _close_trees(gl, cl, *tol)
        _close_trees(torch.as_tensor(ga).cpu(), torch.as_tensor(ca), *tol)
        lg, cg = bundle.prefill(card_p, _on(cut(0, 40), cuda), max_len=42)
        lc, cc = bundle.prefill(cpu_p, cut(0, 40), max_len=42)
        _close_trees(lg, lc, *tol)
        _close_trees(cg, cc, *tol)
        for i in (40, 41):
            step = {"tokens": batch["tokens"][:, i:i + 1]}
            lg, cg = bundle.decode_step(card_p, cg, _on(step, cuda))
            lc, cc = bundle.decode_step(cpu_p, cc, step)
            _close_trees(lg, lc, *tol)
            _close_trees(cg, cc, *tol)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_wave_and_launches_on_card(cuda, arch):
    """Each new family at a small width in bf16 on the card: a prefill
    launches the flash kernel exactly once a full-length attention layer
    (the encoder's and the decoder's self-attention for Whisper, none for
    xLSTM), a decode step none, and ``DecodeWave`` stepped to the end
    gives ``generate``'s tokens bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeWave, Request, ServingEngine
    full = get_config(arch)
    cfg = dataclasses.replace(
        full.reduced(d_model=256, n_heads=8, n_kv_heads=min(
            full.n_kv_heads, 8), d_ff=512, vocab=1024),
        dtype="bfloat16", capacity_factor=full.capacity_factor)
    want = (cfg.enc_layers + cfg.n_layers if cfg.input_kind == "encdec"
            else sum(lt in ("global", "local") for lt in cfg.layer_types))
    bundle = get_model(cfg)
    eng = ServingEngine(bundle, batch_size=3)
    eng.load(bundle.init(torch.Generator(cuda).manual_seed(5),
                         device=cuda), device=cuda)
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(0, 1024, n).tolist(),
                    max_new=9) for i, n in enumerate((40, 17, 64))]
    flash_kernel.reset_launch_counts()
    wave = DecodeWave(eng, reqs)
    assert flash_kernel.launch_counts() == {"flash_attention_hopper": want,
                                            "flash_split_kv_hopper": 0}
    while not wave.done:
        wave.step()
    assert flash_kernel.launch_counts()["flash_attention_hopper"] == want
    gen = eng.generate([r.prompt for r in reqs], max_new=9)
    assert wave.results() == {i: g for i, g in enumerate(gen)}
    assert eng.serve(reqs) == wave.results()


# -- training the language models on the card --------------------------------

TRAIN_ARCHS = MODEL_ARCHS + FAMILY_ARCHS
XLSTM_CARD_REL = 5e-3        # 4x the worst leaf read on an H100, 1.18e-3


def _train_batch(cfg, seed, b=4, s=24):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        return {"embeds": torch.as_tensor(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)),
                "labels": torch.as_tensor(rng.integers(
                    0, cfg.vocab, (b, s)).astype(np.int32))}
    return _family_batch(cfg, seed, b=b, s=s)


def _rel_l2(got, want):
    got, want = got.float().cpu(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One ``make_train_step`` step of each config at ``reduced()`` width
    (float32, microbatch 2, remat) on the card against the same step on
    the CPU: no kernel launched on the card (attention under autograd is
    plain PyTorch), loss and gradient norm at rtol 1e-4, and the first
    moment — the clipped gradient times 0.1 — of every leaf within
    relative L2 1e-4.  xlstm-350m is held at ``XLSTM_CARD_REL``
    throughout: its eight exponentially gated blocks amplify float32
    rounding (its logits are held at atol 3e-4, its gradients against
    the JAX package at relative L2 1e-3 in ``test_torch_lm_train.py``);
    on an H100 its gradient norm (~600) read 2.9e-4 apart from the CPU's
    and its worst leaf 1.18e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatch=2,
                              remat=True)
    bundle = get_model(cfg)
    cpu_p, cpu_o = init_train_state(bundle, torch.Generator().manual_seed(0),
                                    device="cpu")
    card_p = _on(cpu_p, cuda)
    card_o = adamw_init(card_p)
    batch = _train_batch(cfg, 7)
    step = make_train_step(bundle)
    _, cpu_o, cpu_m = step(cpu_p, cpu_o, batch)
    flash_kernel.reset_launch_counts()
    reset_launch_counts()
    _, card_o, card_m = step(card_p, card_o, _on(batch, cuda))
    torch.cuda.synchronize()
    assert not any(flash_kernel.launch_counts().values())
    assert not any(launch_counts().values())
    limit = XLSTM_CARD_REL if arch == "xlstm-350m" else 1e-4
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(card_m[name].cpu(), cpu_m[name],
                                   rtol=limit, atol=1e-6)
    for got, want in zip(tree_leaves(card_o.m), tree_leaves(cpu_o.m)):
        assert got.device.type == cuda.type
        assert _rel_l2(got, want) <= limit


@pytest.mark.parametrize("window", [0, 1500])
def test_chunked_attention_on_card_matches_direct(cuda, window):
    """``attention`` under autograd at S 4096 takes the chunked route on
    the card (no kernel launch); its output and the gradients of q, k
    and v equal the direct route's within 1e-4 (float32, GQA 8 over 2,
    hd 64, causal)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.standard_normal((1, 4096, n, 64)).astype(
        np.float32), device=cuda, requires_grad=True) for n in (8, 2, 2))
    ct = torch.as_tensor(rng.standard_normal((1, 4096, 8, 64)).astype(
        np.float32), device=cuda)
    flash_kernel.reset_launch_counts()
    got = L.attention(q, k, v, causal=True, window=window)
    g_got = torch.autograd.grad(got, (q, k, v), ct)
    assert not any(flash_kernel.launch_counts().values())
    want = L.direct_attention(q, k, v, causal=True, window=window)
    g_want = torch.autograd.grad(want, (q, k, v), ct)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_flash_wrapper_refuses_a_differentiable_call_on_card(cuda):
    """The flash kernel has no backward pass: a call autograd would have
    to see through raises on the card, and the same call under
    ``torch.no_grad()`` launches the kernel once."""
    q = torch.randn((1, 64, 4, 32), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 32), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        tk.flash_attention(q, k, k, causal=True)
    flash_kernel.reset_launch_counts()
    with torch.no_grad():
        tk.flash_attention(q, k, k, causal=True)
    assert flash_kernel.launch_counts()["flash_attention_hopper"] == 1


# -- multi-device models: gloo ranks sharing the card --------------------------

def test_staged_collectives_on_card(cuda, tmp_path):
    """Two ranks on ``cuda:0`` through the staged gloo group: every
    collective the slice uses (all-reduce SUM and MAX, broadcast,
    all-gather, reduce-scatter, a send/recv ring, all-to-all) and
    DTensor's redistributions give the right results on CUDA tensors,
    and the group staged their bytes through the host."""
    import _torch_dist_ranks as R
    from _torch_dist import run_ranks
    got = run_ranks(R.card_collectives, 2, tmp_path, device="cuda")
    assert all(got["ok"].values()), got["ok"]
    assert got["counts"]["bytes_to_host"] > 0
    assert got["counts"]["bytes_to_device"] > 0


def test_sharded_train_step_on_card_matches_one_process(cuda, tmp_path):
    """A float32 step of reduced starcoder2-3b (microbatch 2) with params
    on a (1, 2) mesh of two ranks on the card equals the unsharded step
    in this process on the same card: loss and gradient norm at rtol
    1e-5, params at rtol 1e-4, atol 1e-6 (elements whose gradient is
    nonzero and under 1e-6, where AdamW's ratio is ill-conditioned, at
    2 lr: a flipped sign)."""
    import dataclasses

    import _torch_dist_ranks as R
    from _torch_dist import run_ranks
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(vocab=256),
                              microbatch=2)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    params_np = tree_map(lambda t: t.numpy(), params)
    tokens = np.random.default_rng(3).integers(0, 256, (8, 32)).astype(
        np.int32)
    lr = 1e-3
    p1 = tree_map(lambda a: torch.as_tensor(a, device=cuda), params_np)
    p1, o1, m1 = make_train_step(bundle, lambda s: lr)(
        p1, adamw_init(p1), {"tokens": torch.as_tensor(tokens, device=cuda)})
    out = str(tmp_path / "port.npz")
    got = run_ranks(R.card_sharded_step, 2, tmp_path, params_np, tokens, lr,
                    out, device="cuda")
    np.testing.assert_allclose(got["loss"], float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m1["grad_norm"]),
                               rtol=1e-5)
    port = np.load(out)
    want = {}
    R._flat("params", p1, want)
    R._flat("m", o1.m, want)
    for name, w in want.items():
        g = port[name]
        if name.startswith("params/"):
            grad = np.abs(want["m" + name[len("params"):]]) / 0.1
            near = (grad > 0) & (grad < 1e-6)
            np.testing.assert_allclose(g[near], w[near], rtol=0,
                                       atol=2 * lr, err_msg=name)
            g, w = g[~near], w[~near]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


# -- the launchers: the serve CLI, the flash op, the dry-run ------------------

def test_serve_cli_on_card(cuda):
    """``python -m repro_torch.launch.serve`` (reduced gemma2-2b, float32,
    the default device: the card) serves every request ``max_new``
    tokens, one float32 flash call (pre-pass and body) a full-length
    attention layer a prefill wave."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    flash_kernel.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve.main(["--arch", "gemma2-2b", "--requests", "6",
                          "--max-new", "5", "--quant-bits", "8"])
    cfg = get_config("gemma2-2b").reduced()
    layers = sum(lt in ("global", "local") for lt in cfg.layer_types)
    assert sorted(got) == list(range(6))
    assert all(len(v) == 5 for v in got.values())
    assert flash_kernel.launch_counts() == {
        "flash_attention_hopper": 2 * layers,
        "flash_split_kv_hopper": 2 * layers}
    assert "tok/s" in buf.getvalue() and "quant=8" in buf.getvalue()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_op_is_the_kernel(cuda, dt):
    """The custom op ``repro_torch::flash_attention`` on the card is
    ``flash_attention_hopper`` bit for bit, one call of its launches; its
    fake implementation under ``FakeTensorMode`` launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.kernel import LAUNCHES_PER_CALL
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 77, 8, 64), generator=gen, device=cuda).to(TDT[dt])
    k = torch.randn((2, 77, 2, 64), generator=gen, device=cuda).to(TDT[dt])
    v = torch.randn((2, 77, 2, 64), generator=gen, device=cuda).to(TDT[dt])
    want = flash_kernel.flash_attention_hopper(q, k, v, True, 16, 30.0)
    flash_kernel.reset_launch_counts()
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, 16, 30.0)
    torch.cuda.synchronize()
    assert flash_kernel.launch_counts() == {
        "flash_attention_hopper": 0, "flash_split_kv_hopper": 0,
        **LAUNCHES_PER_CALL[TDT[dt]]}
    assert torch.equal(got, want)
    assert torch.equal(flash_attention(q, k, v, window=16, softcap=30.0),
                       want)
    flash_kernel.reset_launch_counts()
    with FakeTensorMode():
        fq = torch.empty(q.shape, dtype=q.dtype, device=cuda)
        fk = torch.empty(k.shape, dtype=k.dtype, device=cuda)
        out = flash_attention(fq, fk, fk, window=16)
    assert out.shape == q.shape and out.device.type == "cuda"
    assert flash_kernel.launch_counts() == {
        "flash_attention_hopper": 0, "flash_split_kv_hopper": 0}


def _all_launch_counts() -> dict:
    return {**flash_kernel.launch_counts(), **launch_counts(),
            **bitserial_mm.launch_counts(), **fft_kernel.launch_counts(),
            **fir_kernel.launch_counts()}


def _reset_all_launch_counts() -> None:
    for reset in (flash_kernel.reset_launch_counts, reset_launch_counts,
                  bitserial_mm.reset_launch_counts,
                  fft_kernel.reset_launch_counts,
                  fir_kernel.reset_launch_counts):
        reset()


def _settled_memory_allocated() -> int:
    """``torch.cuda.memory_allocated()`` once earlier tests' unreachable
    card tensors are freed, so a collection inside the dry-run does not
    read as a change."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def test_dryrun_cell_on_fake_cuda_tensors(cuda):
    """gemma2-2b ``decode_32k`` on the fake (16, 16) world, every tensor
    a fake CUDA one: a record with the step's analytic FLOPs over 256
    (``_torch_flops``), no kernel launched and
    ``torch.cuda.memory_allocated()`` unchanged; and on the same world's
    CUDA mesh the cost counter reads one device's product of a sharded
    matmul, 15/16 of it repeated by the data ranks, on this torch's
    DTensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from _torch_flops import dense_step_flops
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_test_mesh
    before = _settled_memory_allocated()
    _reset_all_launch_counts()
    rec = dryrun.lower_cell("gemma2-2b", "decode_32k", False)
    counts = _all_launch_counts()
    assert not any(counts.values()), counts
    assert torch.cuda.memory_allocated() == before
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["cost"]["flops_per_device_naive"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["replicated"]["flops"] == 0
    assert rec["loop_aware"]["flops"] * 256 == dense_step_flops(
        get_config("gemma2-2b"), SHAPES["decode_32k"])

    with dryrun.fake_world(256):
        mesh = make_test_mesh((16, 16), device="cuda")
        with FakeTensorMode():
            a = torch.empty(4096, 8192, device=cuda)
            b = torch.empty(8192, 2048, device=cuda)
            da = distribute_tensor(a, mesh, [Replicate(), Shard(1)],
                                   src_data_rank=None)
            db = distribute_tensor(b, mesh, [Replicate(), Shard(0)],
                                   src_data_rank=None)
            for _ in range(2):
                with hlo_analysis.CostMode() as mode:
                    da @ db
                assert mode.summary.flops == 2 * 4096 * 512 * 2048
                assert mode.replicated_flops \
                    == 2 * 4096 * 512 * 2048 * 15 // 16
    assert not any(_all_launch_counts().values())
    assert torch.cuda.memory_allocated() == before


def test_dryrun_prefill_on_fake_cuda_tensors(cuda):
    """starcoder2-3b ``prefill_32k`` on the fake (16, 16) world through
    the flash kernel's op: 30 calls, no launch; its 24 heads do not
    split 16 ways, so every model rank attends over all of them and 15/16
    of the op's FLOPs are repeated; the rest, the rank's share, is the
    step's analytic count over 256 (``_torch_flops``)."""
    from _torch_flops import dense_step_flops
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    before = _settled_memory_allocated()
    _reset_all_launch_counts()
    rec = dryrun.lower_cell("starcoder2-3b", "prefill_32k", False)
    assert not any(_all_launch_counts().values())
    assert torch.cuda.memory_allocated() == before
    fl = rec["flash_attention"]
    assert fl["calls"] == 30
    assert rec["replicated"]["by_op"]["repro_torch.flash_attention"] \
        == fl["flops"] * 15 / 16
    share = rec["loop_aware"]["flops"] - rec["replicated"]["flops"]
    assert share * 256 == dense_step_flops(get_config("starcoder2-3b"),
                                           SHAPES["prefill_32k"])


# -- the MoE and xLSTM families on a DeviceMesh -------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m"])
def test_sharded_family_prefill_decode_on_card(cuda, tmp_path, arch):
    """Reduced qwen2-moe-a2.7b and xlstm-350m (float32, TF32 off) on a
    (2, 2) mesh of 4 ranks on the card (the staged gloo group): a sharded
    prefill and one greedy decode step against the unsharded ones in
    this process on the same card — logits at rtol 1e-4, atol 1e-5
    (xlstm 3e-4, the whole-model tolerance of the CPU tests), both
    tokens exactly; qwen2-moe's prefill one float32 flash call a layer
    on each rank's 2 of its 4 heads, each with its pre-pass, xLSTM
    none."""
    import _torch_dist_ranks as R
    from _torch_dist import run_ranks
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
    cfg = get_config(arch).reduced(**kw)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    params_np = tree_map(lambda t: t.numpy(), params)
    tokens = np.random.default_rng(11).integers(0, 256, (4, 16)).astype(
        np.int32)
    p1 = tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        lp, cache = bundle.prefill(p1, {"tokens": torch.as_tensor(
            tokens, device=cuda)}, max_len=17)
        t0 = lp[:, -1].argmax(-1).to(torch.int32)
        ld, _ = bundle.decode_step(p1, cache, {"tokens": t0[:, None]})
    got = run_ranks(R.sharded_prefill_decode, 4, tmp_path, arch, kw,
                    params_np, tokens, (2, 2), "cuda", device="cuda")
    atol = 3e-4 if arch == "xlstm-350m" else 1e-5
    for key, want in (("prefill", lp), ("decode", ld)):
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   want.cpu().numpy(), rtol=1e-4,
                                   atol=atol, err_msg=key)
    assert got["tokens"] == [t0.tolist(), ld[:, -1].argmax(-1).tolist()]
    calls = 2 if arch == "qwen2-moe-a2.7b" else 0
    assert got["launches"] == {"flash_attention_hopper": calls,
                               "flash_split_kv_hopper": calls}


@pytest.mark.parametrize("arch,shape", [("qwen2-moe-a2.7b", "decode_32k"),
                                        ("xlstm-350m", "long_500k"),
                                        ("grok-1-314b", "train_4k")])
def test_family_dryrun_cell_on_fake_cuda_tensors(cuda, arch, shape):
    """A MoE and an xLSTM cell on the fake (16, 16) world, every tensor a
    fake CUDA one: no kernel launched, ``memory_allocated`` unchanged,
    and the rank's share (FLOPs less ``replicated.flops``) times 256 the
    FLOPs of the same step traced on one fake device with no mesh.
    grok-1-314b's train step runs its expert FFN expert-major, the layout
    whose (B, C) merge DTensor can plan as a local view on the card's
    torch."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    before = _settled_memory_allocated()
    _reset_all_launch_counts()
    rec = dryrun.lower_cell(arch, shape, False)
    one = dryrun.unsharded_flops(get_config(arch), SHAPES[shape])
    assert not any(_all_launch_counts().values())
    assert torch.cuda.memory_allocated() == before
    share = rec["loop_aware"]["flops"] - rec["replicated"]["flops"]
    assert share * 256 == pytest.approx(one["flops"], rel=1e-9)


def test_full_width_moe_train_step_on_card(cuda):
    """One ``make_train_step`` step of qwen2-moe-a2.7b at full width cut
    to one layer (bf16, 60 experts top-4 and a shared expert, vocab
    151936; the config's microbatch 4 and remat) on 8 x 2048
    ``TokenStream`` tokens, the capacity path's expert FFN expert-major
    under autograd: loss and gradient norm finite, every moment finite,
    no kernel launched."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    bundle = get_model(cfg)
    params, opt = init_train_state(
        bundle, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    tokens = TokenStream(vocab=cfg.vocab, seq_len=2048, global_batch=8,
                         seed=0).batch_at(0)
    step = make_train_step(bundle, cosine_schedule(3e-4, 3, 10))
    _reset_all_launch_counts()
    _, opt, metrics = step(params, opt, {"tokens": torch.as_tensor(
        tokens, device=cuda)})
    torch.cuda.synchronize()
    assert not any(_all_launch_counts().values())
    assert opt.step == 1
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(opt.m))
    del params, opt
    torch.cuda.empty_cache()


# -- the paper's signal workloads (chip_smoke.py phase 19) --------------------

@pytest.mark.parametrize("t,n_out,grouped,per_row", [
    (4, 2, False, False), (32, 32, False, False),
    (4, 2, True, False), (32, 32, True, False),
    (4, 2, False, True), (32, 32, False, True),
])
def test_kernels_take_a_batch_past_the_grid_y_extent(cuda, t, n_out,
                                                     grouped, per_row):
    """70000 batch rows, past the 65535 of a grid's y extent (the 2-D
    DCT of 4096 blocks of 32 x 32 is a call on 131072 rows): one launch,
    its grid's z layers taking the rest, on the sequential body (t 4, and every
    grouped call) and the wide one (t 32 = kWideT), with one ``w`` for
    every batch row or (``per_row``) a ``w`` of each batch row's own,
    against the plain version."""
    batch, n_in = 70000, 64
    rng = np.random.default_rng(t)
    rows, groups = (4, 2) if grouped else (3, 0)
    a = _case(rng, cuda, "float32", rows, t, n_out, groups, n_in, True,
              True)
    a["x"] = torch.as_tensor(rng.standard_normal((batch, n_in)),
                             dtype=torch.float32, device=cuda)
    if per_row:
        a["w"] = torch.as_tensor(rng.standard_normal((batch, t, n_out)),
                                 dtype=torch.float32, device=cuda)
    fn, ref = ((shuffle_gemm_grouped_blocks, ref_shuffle_gemm_grouped_blocks)
               if grouped else (shuffle_gemm_blocks, ref_shuffle_gemm_blocks))
    kw = dict(reps=1, groups=2, nb=2) if grouped else {}
    before = fn.launches
    got = fn(**a, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got, ref(**a, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,t,n_out,n_in", [
    (256, 40, 1, 256), (256, 80, 1, 256),     # fir256_40, fir256_80
    (32, 87, 8, 256),                          # fir256_80_phased
    (1, 32, 32, 32),                           # dct2_32: t is kWideT
    (31, 513, 64, 15903),                      # front1024's mel: 2 passes
    (31, 64, 513, 1984),                       # its transposed GEMM: 17
])
def test_blocks_kernel_at_paper_suite_shapes(cuda, dt, rows, t, n_out,
                                             n_in):
    """The wide body at the paper suite's calls, 64 batch rows, against
    the plain version at rtol TOL and atol TOL, in float32 atol TOL x
    max|want|: an output is a sum of t unit-normal products, of size
    sqrt(t), summed in another order (K split over 8 lanes) than the plain
    matmul's, which at t 513 is beyond an absolute 1e-5 in float32."""
    a = _case(np.random.default_rng(rows * t), cuda, dt, rows, t, n_out, 0,
              n_in, False, False)
    a["x"] = torch.as_tensor(np.random.default_rng(n_in).standard_normal(
        (64, n_in)), device=cuda).to(TDT[dt])
    got = shuffle_gemm_blocks(**a).float()
    want = ref_shuffle_gemm_blocks(**a).float()
    scale = float(want.abs().max()) if dt == "float32" else 1.0
    torch.testing.assert_close(got, want, rtol=TOL[dt], atol=TOL[dt] * scale)


def test_paper_suite_graphs_on_card(cuda):
    """Every graph of ``chip_smoke.paper_suite`` at 4 batch rows (dct2_32:
    4 blocks) on hopper at fuse 0, 1 and 2 against reference on the card
    (rtol 1e-4, atol 1e-4 x max|want|), with exactly phase 19's
    ``SUITE_LAUNCHES``; the chains of fft512, fft1024 and front1024 hold
    74,256 and 156,240 bytes of shared memory a block."""
    cs = chip_smoke()
    suite = cs.paper_suite(SignalGraph, 0)
    rng = np.random.default_rng(0)
    for name, (g, length, _) in suite.items():
        x = torch.as_tensor(cs.suite_input(np, rng, name, length, 4),
                            device=cuda)
        for fuse in (0, 1, 2):
            h = g.compile(length, fuse=fuse, backend="hopper", device=cuda)
            r = g.compile(length, fuse=fuse, backend="reference",
                          device=cuda)
            with torch.no_grad():
                reset_launch_counts()
                got = cs.suite_forward(name, h, x)
                torch.cuda.synchronize()
                assert launch_counts() == cs.SUITE_LAUNCHES[name][fuse], \
                    (name, fuse)
                want = cs.suite_forward(name, r, x)
            for k in want:
                cs.suite_close(torch, f"{name} fuse {fuse} {k}", got[k],
                               want[k], cs.SUITE_REL)
        for rep in h.chain_report():
            for seg in rep["segments"]:
                assert seg["shared_bytes"] == cs.SUITE_SHARED_BYTES[name]


def test_paper_suite_front_end_gradients_on_card(cuda):
    """front1024's ``value_and_grad`` wrt its FIR taps and mel weights on
    hopper (the 10-step chain's backward as one chain, the mel's
    transposed GEMM at n_out 513) against reference on the card at rtol
    1e-4, atol 1e-5, launching ``SUITE_TRAIN_LAUNCHES``."""
    cs = chip_smoke()
    g, length, _ = cs.paper_suite(SignalGraph, 0)["front1024"]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(cs.suite_input(np, rng, "front1024", length, 2),
                        device=cuda)
    h = g.compile(length, fuse=2, backend="hopper", device=cuda)
    r = g.compile(length, fuse=2, backend="reference", device=cuda)
    params = {k: {f: torch.as_tensor(np.asarray(v, np.float32), device=cuda)
                  for f, v in d.items()} for k, d in h.init_params().items()}
    target = torch.as_tensor(rng.standard_normal((2, 31, 64)),
                             dtype=torch.float32, device=cuda)

    def loss_fn(outs, tgt):
        return torch.mean((outs["mel"] - tgt) ** 2)
    reset_launch_counts()
    loss_h, g_h = h.value_and_grad(loss_fn, wrt=("front", "mel"))(
        params, x, target)
    torch.cuda.synchronize()
    assert launch_counts() == cs.SUITE_TRAIN_LAUNCHES
    loss_r, g_r = r.value_and_grad(loss_fn, wrt=("front", "mel"))(
        params, x, target)
    torch.testing.assert_close(loss_h, loss_r, rtol=1e-4, atol=1e-5)
    for k, f in (("front", "taps"), ("mel", "weights")):
        torch.testing.assert_close(g_h[k][f], g_r[k][f], rtol=1e-4,
                                   atol=1e-5)


# -- the staged blocks body and the persistent chain at the suite's calls ----

def _suite_calls(cuda, batch, names=None, grad=False):
    """The shuffle-GEMM calls of each paper-suite workload's fuse-2
    forward (and, with ``grad``, front1024's value_and_grad) at ``batch``
    rows (dct2_32: blocks), as the ops make them: ``[(workload, kernel
    name, bound arguments)]``."""
    cs = chip_smoke()
    suite = cs.paper_suite(SignalGraph, 0)
    rng = np.random.default_rng(30)
    out = []
    for name, (g, length, _) in suite.items():
        if names is not None and name not in names:
            continue
        h = g.compile(length, fuse=2, backend="hopper", device=cuda)
        x = torch.as_tensor(cs.suite_input(np, rng, name, length, batch),
                            device=cuda)
        out += [(name, k, a) for k, a in cs.record_calls(
            torch, lambda: cs.suite_forward(name, h, x))]
        if grad and name == "front1024":
            params = {k: {f: torch.as_tensor(np.asarray(v, np.float32),
                                             device=cuda)
                          for f, v in d.items()}
                      for k, d in h.init_params().items()}
            vag = h.value_and_grad(lambda o, t: torch.mean(o["mel"] ** 2),
                                   wrt=("front", "mel"))
            out += [(name + " backward", k, a) for k, a in cs.record_calls(
                torch, lambda: vag(params, x, None), grad=True)]
    return out


def _fig9_blocks_calls(cuda):
    """Fig 9's shared-operand blocks calls of a batch-4 value_and_grad
    step: the FIR taps and the mel forward, the framing adjoint."""
    cs = chip_smoke()
    rng = np.random.default_rng(0)
    cnn = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    x = torch.as_tensor(rng.standard_normal((4, LENGTH)).astype(np.float32),
                        device=cuda)
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device=cuda)
    params = dict(c.init_params())
    params["mask"] = cnn
    vag = c.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)
    return [a for k, a in cs.record_calls(
        torch, lambda: vag(params, x, x), grad=True)
        if k == "shuffle_gemm_blocks"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_staged_body_at_every_suite_and_fig9_call(cuda, dt):
    """Every shared-operand shuffle_gemm_blocks call of the paper suite
    (forward, front1024's backward) and of a Fig-9 value_and_grad step
    takes the staged body, with its plan's spans, wherever
    ``blocks_tiling`` gives it a tiling (an output a sum of at least
    MIN_WORK products), the sequential one elsewhere (Fig 9's FIR and
    framing adjoint, the DWTs) — and holds against the plain version at
    rtol TOL and atol
    TOL (float32: TOL x max|want|, sums of up to 513 products in another
    order than the plain matmul's), on 70 batch rows (dct2_32: 70
    blocks): several passes of a block and a ragged last one."""
    from repro_torch.kernels import launch
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    from repro_torch.kernels.shuffle_gemm.tiling import MIN_WORK
    calls = [a for _, k, a in _suite_calls(cuda, 70, grad=True)
             if k == "shuffle_gemm_blocks"] + _fig9_blocks_calls(cuda)
    assert len(calls) >= 14
    staged = 0
    for a in calls:
        a = dict(a, **{k: a[k].to(TDT[dt]) for k in ("x", "pad_vals", "w")
                       if k in a},
                 scale=None if a["scale"] is None else a["scale"].to(TDT[dt]))
        assert a["spans"] is not None and a["w"].ndim == 2
        got = shuffle_gemm_blocks(**a)
        _, args = sgk.blocks_launch_args(**a)
        launch("repro_shuffle_gemm_blocks", a["x"].device, *args)
        torch.cuda.synchronize()
        tiling = sgk.blocks_tiling(a["x"], a["idx"], a["w"], a["scale"],
                                   a["spans"])
        body = "staged" if tiling is not None else "sequential"
        assert sgk.BODIES[args[13][-1]] == body
        (_, t), n_out = a["idx"].shape, a["w"].shape[-1]
        assert (body == "staged") == (t * n_out >= MIN_WORK), (t, n_out)
        staged += body == "staged"
        want = ref_shuffle_gemm_blocks(
            **{k: v for k, v in a.items() if k != "spans"}).float()
        scale = float(want.abs().max()) if dt == "float32" else 1.0
        torch.testing.assert_close(got.float(), want, rtol=TOL[dt],
                                   atol=TOL[dt] * scale)
    assert staged >= 10


def _split_rows(fn, a, splits):
    """``fn`` on ``a``'s batch rows cut at ``splits``, concatenated."""
    x, cuts = a["x"], [0, *splits, a["x"].shape[0]]
    return torch.cat([fn(**dict(a, x=x[s:e].contiguous()))
                      for s, e in zip(cuts, cuts[1:])])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_staged_body_rows_do_not_depend_on_their_batch(cuda, dt):
    """A shared-operand call on B batch rows equals, bit for bit, the same
    rows run as calls of 1, 7 and B - 8 rows (each output computed alone:
    what SigMesh's meshed calls rely on), and the per-row call on the
    operand repeated (the sequential or wide body, summing in the same
    order), at every suite call's shape."""
    for name, k, a in _suite_calls(cuda, 40):
        if k != "shuffle_gemm_blocks" or a["w"].ndim != 2:
            continue
        a = dict(a, x=a["x"].to(TDT[dt]), pad_vals=a["pad_vals"].to(TDT[dt]),
                 w=a["w"].to(TDT[dt]),
                 scale=None if a["scale"] is None else a["scale"].to(TDT[dt]))
        got = shuffle_gemm_blocks(**a)
        b = a["x"].shape[0]
        assert torch.equal(got, _split_rows(shuffle_gemm_blocks, a,
                                            (1, 8))), name
        per_row = dict(a, w=a["w"].expand(b, *a["w"].shape).contiguous(),
                       spans=None)
        assert torch.equal(got, shuffle_gemm_blocks(**per_row)), name


def _suite_chains(cuda, batch, names):
    return [(n, a) for n, k, a in _suite_calls(cuda, batch, names)
            if k == "shuffle_gemm_chain"]


def _chain_launch(a):
    """One launch of ``a``'s chain call: ``(blocks, slots)`` as the launch
    reports them (slots: the tiles a block holds at once)."""
    from repro_torch.kernels import launch
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    _, args = sgk.chain_launch_args(**a)
    launch("repro_shuffle_gemm_chain", a["x"].device, *args)
    torch.cuda.synchronize()
    return args[6][-3], args[6][-2]


def test_chain_rows_do_not_depend_on_their_batch(cuda):
    """The 128- and 1024-point FFT chains and front1024's STFT (31 tiles
    a batch row) on 1000 batch rows: bit for bit the same rows as calls of
    1, 7 and 992 rows — blocks of one tile at a time against blocks of
    several (the slots the launch picks from the batch) — and bit for bit
    their sub-steps one launch each; the 1024-point chain in bfloat16
    too."""
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    chains = _suite_chains(cuda, 1000, ("fft128", "fft1024", "front1024"))
    assert [n for n, _ in chains] == ["fft128", "fft1024", "front1024"]
    for name, a in chains:
        for dt in ((torch.float32, torch.bfloat16) if name == "fft1024"
                   else (torch.float32,)):
            a = dict(a, x=a["x"].to(dt), ws=[w.to(dt) for w in a["ws"]])
            got = sgk.shuffle_gemm_chain(**a)
            assert torch.equal(got, _split_rows(sgk.shuffle_gemm_chain, a,
                                                (1, 8))), name
            slots = [_chain_launch(dict(a, x=a["x"][s:e].contiguous()))[1]
                     for s, e in ((0, 1), (1, 8), (8, 1000))]
            assert slots[0] == slots[1] == 1 < slots[2], (name, slots)
            assert torch.equal(got, sgk.shuffle_gemm_steps(
                a["x"], a["segment"], a["ws"])), name


def test_every_suite_chain_equals_its_steps_at_4096_rows(cuda):
    """The FFT chains at 128-1024 points and FFT -> iFFT at 1024, at the
    suite's 4096 batch rows: each launch bit for bit its sub-steps
    through the grouped entry, within the float tolerance of the plain
    version, its blocks each staging the tables and operands once."""
    names = ("fft128", "fft256", "fft512", "fft1024", "fft_ifft1024")
    chains = _suite_chains(cuda, 4096, names)
    assert len(chains) == 6
    for name, a in chains:
        _assert_chain_exact(a["x"], a["segment"], a["ws"])
        blocks, slots = _chain_launch(a)
        assert blocks <= 4096 // slots


# -- per-row operands of every params class, and planes of any count ------

@pytest.mark.parametrize("k", [9, 129, 300])
@pytest.mark.parametrize("pa,pw", [(pa, pw) for pa in (3, 5, 8)
                                   for pw in (3, 5, 8)]
                         + [(9, 2), (1, 11), (2, 3)])
def test_bitserial_planes_kernel_any_count_is_exact(cuda, pa, pw, k):
    """Plane counts no width gives, on the body of any count: bit for bit
    the plain version over N 1 and 64 (both tile shapes, ragged in M, N
    and K), digits over the whole int8 range so the sums wrap, pairs of
    shift 32 and more adding nothing; one launch a call."""
    rng = np.random.default_rng(100 * pa + 10 * pw + k)
    for n in (1, 64):
        a = torch.as_tensor(rng.integers(-128, 128, (pa, 130, k)),
                            dtype=torch.int8, device=cuda)
        w = torch.as_tensor(rng.integers(-128, 128, (pw, k, n)),
                            dtype=torch.int8, device=cuda)
        before = bitserial_mm.bitserial_matmul_planes.launches
        got = bitserial_mm.bitserial_matmul_planes(a, w)
        torch.cuda.synchronize()
        assert bitserial_mm.bitserial_matmul_planes.launches == before + 1
        want = bitserial_mm.ref_bitserial_matmul_planes(a, w)
        assert torch.equal(got, want), (n, (got != want).nonzero()[:4])
        assert torch.equal(got.cpu(), bitserial_mm.ref_bitserial_matmul_planes(
            a.cpu(), w.cpu()))


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("aw,ww", [(8, 8), (16, 8), (4, 16)])
@pytest.mark.parametrize("b", [1, 8])
def test_bitserial_quant_kernel_per_row_w(cuda, aw, ww, shape, b):
    """h (B, R, K) with w (B, K, N): one launch of the per-row kernel,
    batch row i bit for bit the shared-w launch on (h[i], w[i]) and the
    plain version, with a zero row and a NaN row in batch row 0."""
    r, k, n = shape
    r = min(r, 2048)
    rng = np.random.default_rng(aw * 1000 + ww * 10 + k + b)
    h = (rng.standard_normal((b, r, k))
         * np.exp(rng.uniform(-4, 4, (b, r, 1)))).astype(np.float32)
    w = (rng.standard_normal((b, k, n))
         * np.exp(rng.uniform(-2, 2, (b, 1, 1)))).astype(np.float32)
    h[0, 1] = 0.0
    h[0, 2, k // 2] = np.nan
    ht, wt = (torch.as_tensor(v, device=cuda) for v in (h, w))
    before = bitserial_mm.bitserial_quant_matmul_hopper.launches
    got = bitserial_mm.bitserial_quant_matmul_hopper(ht, wt, aw, ww)
    torch.cuda.synchronize()
    assert bitserial_mm.bitserial_quant_matmul_hopper.launches == before + 1
    assert tuple(got.shape) == (b, r, n)
    for i in range(b):
        torch.testing.assert_close(
            got[i], bitserial_mm.bitserial_quant_matmul_hopper(
                ht[i], wt[i], aw, ww), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        got, bitserial_mm.ref_bitserial_quant_matmul(ht, wt, aw, ww),
        rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[0, 2]).all() and not got[0, 1].any()


def test_per_row_kernels_refuse_bad_batches(cuda):
    h = torch.ones((3, 5, 4), device=cuda)
    with pytest.raises(ValueError, match="B, K, N"):
        bitserial_mm.bitserial_quant_matmul_hopper(
            h, torch.ones((2, 4, 2), device=cuda), 8, 8)
    x = torch.ones((3, 10), device=cuda)
    idx = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    pads = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError, match="operands"):
        shuffle_gemm_grouped_blocks(x, idx, pads,
                                    torch.ones((2, 2, 4, 4), device=cuda),
                                    1, 2, 2)


# -- the per-row quantized GEMM's bodies (row, tiles, chunked) -------------

QUANT_PAIRS = [(aw, ww) for aw in (4, 8, 16) for ww in (4, 8, 16)]


def _quant_rows_launch(h, w, aw, ww):
    """One launch of the per-row entry through its C arguments (not
    counted): (y, the body its dims report)."""
    y, args = bitserial_mm.quant_rows_launch_args(h, w, aw, ww)
    tk.launch("repro_bitserial_quant_matmul_rows", h.device, *args)
    return y, bitserial_mm.QUANT_ROWS_BODIES[args[9][0]]


def _assert_rows_exact(h, w, aw, ww, rows_to_check=None):
    """The per-row call on (h, w): one counted launch, the body of
    ``quant_rows_body``, bit for bit (NaN positions equal) the plain
    version and the shared call on (h[b], w[b]) for every checked b."""
    before = bitserial_mm.bitserial_quant_matmul_hopper.launches
    got = bitserial_mm.bitserial_quant_matmul_hopper(h, w, aw, ww)
    torch.cuda.synchronize()
    assert bitserial_mm.bitserial_quant_matmul_hopper.launches == before + 1
    again, body = _quant_rows_launch(h, w, aw, ww)
    assert body == bitserial_mm.quant_rows_body(h.shape[2], w.shape[2])
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(again, got, **exact)
    torch.testing.assert_close(
        got, bitserial_mm.ref_bitserial_quant_matmul(h, w, aw, ww), **exact)
    for b in (range(h.shape[0]) if rows_to_check is None else rows_to_check):
        torch.testing.assert_close(
            got[b], bitserial_mm.bitserial_quant_matmul_hopper(
                h[b], w[b], aw, ww), **exact)
    return got, body


def _quant_operands(rng, b, r, k, n, dev):
    h = (rng.standard_normal((b, r, k))
         * np.exp(rng.uniform(-4, 4, (b, r, 1)))).astype(np.float32)
    w = (rng.standard_normal((b, k, n))
         * np.exp(rng.uniform(-2, 2, (b, 1, n)))).astype(np.float32)
    return (torch.as_tensor(v, device=dev) for v in (h, w))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 24, 64])
@pytest.mark.parametrize("k", [1, 4, 9, 31, 32, 33, 129, 256, 257])
def test_bitserial_quant_rows_bodies_are_exact(cuda, k, n):
    """Every body of the per-row entry at every width pair and batch 1, 3
    and 8 (150 rows: ragged for every body's CTA): bit for bit its plain
    version and the shared call on each batch row's operands, and the
    body ``quant_rows_body`` names."""
    rng = np.random.default_rng(1000 * k + n)
    for b in (1, 3, 8):
        h, w = _quant_operands(rng, b, 150, k, n, cuda)
        for aw, ww in QUANT_PAIRS:
            _assert_rows_exact(h, w, aw, ww)


@pytest.mark.parametrize("k,n", [(9, 1), (129, 24), (257, 9)],
                         ids=["row", "tiles", "chunked"])
@pytest.mark.parametrize("aw,ww", QUANT_PAIRS)
def test_bitserial_quant_rows_zero_nan_inf_rows(cuda, k, n, aw, ww):
    """A zero row, a NaN row and an inf row in batch rows 0 and 2 (and a
    zero column of w): the zero row 0, the NaN row all NaN, the inf row
    not finite (its scale is inf), no other row touched; every body bit
    for bit its plain version and the shared calls."""
    rng = np.random.default_rng(aw * 10 + ww + k)
    h, w = _quant_operands(rng, 3, 40, k, n, cuda)
    for b in (0, 2):
        h[b, 1] = 0.0
        h[b, 2, k // 2] = float("nan")
        h[b, 3, 0] = float("inf")
    w[1, :, 0] = 0.0
    got, _ = _assert_rows_exact(h, w, aw, ww)
    assert not got[0, 1].any() and torch.isnan(got[0, 2]).all()
    assert not torch.isfinite(got[0, 3]).any()
    assert torch.isfinite(got[0, 4:]).all() and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("k", [9, 32, 256, 257])
def test_bitserial_quant_rows_unaligned_h(cuda, k):
    """h a contiguous view one float into its buffer (4- but not 16-byte
    aligned): each body takes its unaligned loads, bit for bit."""
    rng = np.random.default_rng(k)
    for n in (1, 24):
        b, r = 3, 70
        buf = torch.as_tensor(rng.standard_normal(b * r * k + 1),
                              dtype=torch.float32, device=cuda)
        h = buf[1:].view(b, r, k)
        assert h.is_contiguous() and h.data_ptr() % 16 == 4
        w = torch.as_tensor(rng.standard_normal((b, k, n)),
                            dtype=torch.float32, device=cuda)
        for aw, ww in ((16, 8), (8, 8), (4, 16)):
            _assert_rows_exact(h, w, aw, ww)


@pytest.mark.parametrize("k,n", [(9, 1), (129, 24), (256, 64), (257, 9)])
def test_bitserial_quant_rows_wrap_like_int32(cuda, k, n):
    """Widths (16, 16) on positive operands: each row's integer sum leaves
    the int32 range and must wrap mod 2^32 in every body."""
    rng = np.random.default_rng(k + n)
    b, r = 3, 50
    h = torch.as_tensor(rng.uniform(0.5, 1.0, (b, r, k)),
                        dtype=torch.float32, device=cuda)
    w = torch.as_tensor(rng.uniform(0.5, 1.0, (b, k, n)),
                        dtype=torch.float32, device=cuda)
    from repro_torch.core import bitwidth as bw
    hq = bw.quantize(h.cpu(), 16)[0].to(torch.int64)
    wq = bw.quantize(w.cpu(), 16, axis=-2)[0].to(torch.int64)
    assert (torch.matmul(hq, wq).abs() > 2 ** 31).any()
    _assert_rows_exact(h, w, 16, 16)


def _near_half(rng, shape, width, axis):
    """float32 values whose quotients by their row's (``axis`` -1) or
    column's (-2) scale lie on a half-integer or within two ulps of one,
    each row's (column's) maximum first: where the per-row bodies'
    reciprocal quantizer hands over to the IEEE division."""
    qmax = np.float32(2 ** (width - 1) - 1)
    x = np.empty(shape, np.float32)
    xt = np.moveaxis(x, axis, -1)
    lead, k = xt.shape[:-1], xt.shape[-1]
    amax = (qmax * np.exp(rng.uniform(-6, 6, lead)).astype(np.float32)) \
        .astype(np.float32)
    scale = (np.maximum(amax, np.float32(1e-8)) / qmax).astype(np.float32)
    n = rng.integers(-int(qmax) + 1, int(qmax) - 1, lead + (k,))
    v = ((n.astype(np.float32) + np.float32(0.5))
         * scale[..., None]).astype(np.float32)
    steps = rng.integers(-2, 3, v.shape)
    for _ in range(2):
        v = np.where(steps > 0, np.nextafter(v, np.float32(np.inf)),
                     np.where(steps < 0, np.nextafter(v, np.float32(-np.inf)),
                              v))
        steps = steps - np.sign(steps)
    v[..., 0] = amax
    xt[...] = v
    return x


@pytest.mark.parametrize("k,n", [(9, 1), (129, 24), (256, 64), (257, 9)],
                         ids=["row", "tiles", "tiles_aligned", "chunked"])
@pytest.mark.parametrize("aw,ww", [(4, 4), (8, 8), (16, 8), (8, 16),
                                   (16, 16)])
def test_bitserial_quant_rows_half_integer_quotients(cuda, k, n, aw, ww):
    """Operands whose quotients by their scales sit on half-integers (ties,
    rounded to even) or within two ulps of one, in h and in w: each body
    bit for bit its plain version (the IEEE division) and the shared
    calls."""
    rng = np.random.default_rng(aw * 100 + ww + k)
    h = torch.as_tensor(_near_half(rng, (3, 40, k), aw, -1), device=cuda)
    w = torch.as_tensor(_near_half(rng, (3, k, n), ww, -2), device=cuda)
    _assert_rows_exact(h, w, aw, ww)


@pytest.mark.parametrize("k,n", [(4, 1), (33, 9), (257, 3)],
                         ids=["row", "tiles", "chunked"])
def test_bitserial_quant_rows_past_65535_batch_rows(cuda, k, n):
    """One call of 70000 batch rows (small R, K, N): served in one
    launch, not refused; bit for bit the plain version, and the shared
    call on the first, a middle and the last batch row."""
    rng = np.random.default_rng(k)
    b, r = 70000, 2
    h, w = _quant_operands(rng, b, r, k, n, cuda)
    _assert_rows_exact(h, w, 8, 8, rows_to_check=(0, 35017, b - 1))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,b", [(1, 1), (8, 8), (128, 65)])
def test_grouped_kernel_per_row_w(cuda, dt, groups, b):
    """Fig-9 butterfly shapes with w (B, G, 4, 4): one launch, batch row i
    bit for bit the shared launch on w[i], within the tolerance of the
    plain version."""
    rows, reps, nb = 3968, 31, 128 // groups
    rng = np.random.default_rng(groups + b)
    dev = dict(device=cuda, dtype=TDT[dt])
    idx = rng.integers(0, 8192, (rows, 4)).astype(np.int32)
    idx[rng.random((rows, 4)) < 0.2] = -1
    a = dict(x=torch.as_tensor(rng.standard_normal((b, 8192))).to(**dev),
             idx=torch.as_tensor(idx, device=cuda),
             pad_vals=torch.as_tensor(rng.standard_normal((rows, 4))).to(
                 **dev),
             w=torch.as_tensor(rng.standard_normal((b, groups, 4, 4))).to(
                 **dev),
             scale=torch.as_tensor(rng.standard_normal((rows, 4))).to(**dev),
             reps=reps, groups=groups, nb=nb)
    before = shuffle_gemm_grouped_blocks.launches
    got = shuffle_gemm_grouped_blocks(**a)
    torch.cuda.synchronize()
    assert shuffle_gemm_grouped_blocks.launches == before + 1
    for i in range(b):
        assert torch.equal(got[i], shuffle_gemm_grouped_blocks(
            **dict(a, w=a["w"][i].contiguous()))[i])
    torch.testing.assert_close(
        got.float(), ref_shuffle_gemm_grouped_blocks(**a).float(),
        rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows_of", [(0, 1, 2), (1,), (0, 2)],
                         ids=["all", "middle", "ends"])
def test_chain_kernel_per_row_operands(cuda, dt, rows_of):
    """A chain whose sub-steps ``rows_of`` take one operand a batch row:
    one launch of the per-row instance, batch row i bit for bit the
    shared chain on row i's operands and the sub-steps launched one at a
    time on the grouped kernel, within the tolerance of the plain
    version."""
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    from repro_torch.kernels.shuffle_gemm.chain import segment_chain
    rng = np.random.default_rng(len(rows_of))
    steps, ws, x = _grouped_chain(rng, cuda, dt, 5, 64, 300, False)
    (seg,) = segment_chain(steps)
    b = x.shape[0]
    wr = [(w[None] * (1 + 0.1 * torch.as_tensor(rng.standard_normal(
        (b, *w.shape))).to(w))).contiguous() if i in rows_of else w
        for i, w in enumerate(ws)]
    _assert_chain_exact(x, seg, wr)
    got = sgk.shuffle_gemm_chain(x, seg, wr)
    for i in range(b):
        own = [w[i].contiguous() if w.ndim == 4 else w for w in wr]
        assert torch.equal(got[i], sgk.shuffle_gemm_chain(x, seg, own)[i])
    with pytest.raises(ValueError, match="must be"):
        sgk.shuffle_gemm_chain(x[:2].contiguous(), seg, wr)


def test_chain_kernel_per_row_on_fig9(cuda):
    """Fig 9's two forward chains at batch 8 with one operand set a batch
    row: bit for bit the shared chain on each row's operands and its
    sub-steps one launch each."""
    from repro_torch.kernels.shuffle_gemm import kernel as sgk
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((8, LENGTH)).astype(np.float32),
                        device=cuda)
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device=cuda)
    params = dict(c.init_params())
    params["mask"] = params_from_jax(
        [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
         .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])],
        device=cuda)
    with torch.no_grad():
        calls = _record_chains(lambda: c(x, params))
    assert len(calls) == 2
    for x_, seg, ws in calls:
        wr = [(w[None] * (1 + 0.05 * torch.as_tensor(rng.standard_normal(
            (8, *w.shape)), dtype=w.dtype, device=cuda))).contiguous()
            for w in ws]
        _assert_chain_exact(x_, seg, wr)
        got = sgk.shuffle_gemm_chain(x_, seg, wr)
        for i in range(8):
            assert torch.equal(got[i], sgk.shuffle_gemm_chain(
                x_, seg, [w[i].contiguous() for w in wr])[i])


def _two_tenant_graph(kind):
    """(graph, params a, params b, service kwargs) of a stage kind whose
    params a per-row wave stacks: an int-routed FIR, a biquad, a
    learnable window, at Fig 9's widths."""
    g = SignalGraph(kind)
    rng = np.random.default_rng(7)
    if kind == "int_routed":
        g.fir("out", "input", taps=np.hanning(9) / np.hanning(9).sum())
        g.outputs("out")
        return (g, *({"out": {"taps": (0.3 * rng.standard_normal(9))
                              .astype(np.float32)}} for _ in range(2)),
                {"precision": PrecisionPolicy(widths={"out": (16, 8)})})
    if kind == "biquad":
        g.iir_biquad("out", "input", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.25])
        g.outputs("out")
        return (g, {"out": {"b": np.float32([0.2, 0.3, 0.2]),
                            "a": np.float32([1.0, -0.5, 0.25])}},
                {"out": {"b": np.float32([0.1, 0.3, 0.1]),
                         "a": np.float32([1.0, -0.4, 0.2])}}, {})
    g.stft("spec", frame=256, hop=128, window="learnable")
    g.istft("out", "spec", hop=128)
    g.outputs("out")
    return (g, *({"spec": {"window": rng.random(256).astype(np.float32)}}
                 for _ in range(2)), {})


@pytest.mark.parametrize("kind", ["int_routed", "biquad",
                                  "learnable_window"])
def test_per_row_wave_of_each_params_class(cuda, kind):
    """Two tenants' params of an int-routed FIR, a biquad or a learnable
    window: one wave, no params split, one forward's launches (the int
    route's quantized GEMM once), each row equal to its tenant's offline
    compile (atol 1e-5)."""
    g, pa, pb, kw = _two_tenant_graph(kind)
    length = 2048 if kind == "biquad" else LENGTH
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal(length).astype(np.float32) for _ in range(8)]
    svc = SignalService(batch_size=8, backend="hopper", device=cuda, **kw)
    for name, p in (("a", pa), ("b", pb)):
        svc.register(name, g, params=p)
    svc.serve([SignalRequest(rid=-1, graph="a", samples=xs[0])])
    backend = HopperBackend(precision=kw.get("precision"))
    comp = g.compile(length, backend=backend, device=cuda)
    with torch.no_grad():
        reset_launch_counts()
        bitserial_mm.reset_launch_counts()
        comp(torch.as_tensor(np.stack(xs), device=cuda), pa)
        torch.cuda.synchronize()
        one = {**launch_counts(), **bitserial_mm.launch_counts()}
    reset_launch_counts()
    bitserial_mm.reset_launch_counts()
    res = svc.serve([SignalRequest(rid=i, graph="ab"[i % 2], samples=x)
                     for i, x in enumerate(xs)])
    torch.cuda.synchronize()
    assert {**launch_counts(), **bitserial_mm.launch_counts()} == one
    assert svc.stats["param_splits"] == 0
    assert svc.scheduler.stats["cross_graph_batches"] == 1
    if kind == "int_routed":
        assert one["bitserial_quant_matmul_hopper"] == 1
    with torch.no_grad():
        for i, x in enumerate(xs):
            off = comp(torch.as_tensor(x[None], device=cuda),
                       pa if i % 2 == 0 else pb)
            np.testing.assert_allclose(res[i]["out"],
                                       off["out"][0].cpu().numpy(), rtol=0,
                                       atol=1e-5)
