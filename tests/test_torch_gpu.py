"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain PyTorch versions on the same card tensors, and the Fig-9 path on
the ``hopper`` backend against the ``reference`` backend on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is False; whether a card is present is
decided inside the ``cuda`` fixture, never at import.  The file imports
no JAX, so it runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: kernels rtol = atol = 1e-5 in float32 and 2e-2 in bfloat16;
graph outputs rtol 1e-4, atol 1e-5; served against offline ``out`` atol
1e-5 and ``mel_tap`` rtol = atol = 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.convert import params_from_jax
from repro_torch.kernels.shuffle_gemm import (
    launch_counts, ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks,
    reset_launch_counts, shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SignalRequest, SignalService

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
