"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain PyTorch versions on the same card tensors, the Fig-9 path on the
``hopper`` backend against the ``reference`` backend on the card, and
the int-routed (SigQuant) Fig-9q forward.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False; whether a card is present is
decided inside the ``cuda`` fixture, never at import.  The file imports
no JAX, so it runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: shuffle-GEMM kernels rtol = atol = 1e-5 in float32 and 2e-2
in bfloat16; the bitserial kernel bit-exact; the FFT stage and phased FIR
kernels rtol = atol = 1e-4 (the JAX package's tolerance for them), the
full FFT 2e-3 against ``torch.fft.fft``; graph outputs rtol 1e-4, atol
1e-5; served against offline ``out`` atol 1e-5 and ``mel_tap`` rtol =
atol = 1e-4; the int-routed Fig-9q forward within the SigQuant budget
(relative L2 1e-2) of the float32 reference.
"""

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
from repro_torch.kernels.shuffle_gemm import (
    launch_counts, ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks,
    reset_launch_counts, shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SignalRequest, SignalService
from repro_torch.signal import HopperBackend, PrecisionPolicy, SignalGraph

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
    assert launch_counts() == {"shuffle_gemm_blocks": 2,
                               "shuffle_gemm_grouped_blocks": 16}
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
                               "shuffle_gemm_grouped_blocks": 32}
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
        before = fft_kernel.fft_stage_hopper.launches
        got = fft_kernel.fft_stage_hopper(xr, idx, tw, st.half, st.nb)
        torch.cuda.synchronize()
        assert fft_kernel.fft_stage_hopper.launches == before + 1
        want = fft_ref.ref_fft_stage_hopper(xr, idx, tw, st.half, st.nb)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        xr = got
    torch.testing.assert_close(fft_ops.fft_hopper(z), torch.fft.fft(z),
                               rtol=2e-3, atol=2e-3)


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


def test_new_wrappers_refuse_bad_inputs(cuda):
    a = torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        bitserial_mm.bitserial_matmul_planes(a.int(), a.transpose(1, 2))
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
    launches the bitserial kernel once and the outputs stay within the
    budget of the float32 reference."""
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
        assert bitserial_mm.launch_counts() == {"bitserial_matmul_planes": 3}
        want = c.with_backend("reference")(x)
    for k in ("out", "mel"):
        err = float(torch.linalg.vector_norm(got[k] - want[k])
                    / torch.linalg.vector_norm(want[k]))
        assert torch.isfinite(got[k]).all() and err <= 1e-2, (k, err)
