"""The paper's own signal workloads (``chip_smoke.paper_suite``) in the
PyTorch port against the JAX package.

``paper_suite`` builds the workloads of ``configs/sigdla_paper.py`` at
the paper's sizes — FFT 128-1024, FFT -> iFFT 1024, FIR 256 x {20, 40,
80} taps and 80 taps in 8 phases, the DCT-II of 32 (the 2-D transform of
a 32 x 32 block as two calls), the Haar and db2 DWT of 1024, and the
1024-point audio front end ``front1024`` — from either package's
``SignalGraph``.  Here each runs at batch 2 on the port's ``hopper``
backend (its kernels' plain versions on the CPU) and ``reference``
backend against the JAX package's compile of the same graph, at rtol
1e-4, atol 1e-4 (``tests/test_torch_graph.py``'s limits); the lowering
reports equal the JAX ``pallas`` backend's at every fuse level; the
chain segmentation, the launches ``chip_smoke.py`` phase 19 holds the
card to (each wrapper call counted as the launch it makes on the card)
and front1024's gradients against ``jax.value_and_grad`` (rtol 1e-4,
atol 1e-5) are pinned; the 2-D DCT equals the float64 product with
``dct_matrix``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import signal as jsig
from repro_torch import signal as tsig
from repro_torch.convert import params_from_jax
from repro_torch.core.signal_mapping import dct_matrix

from _chip_smoke_module import chip_smoke

CS = chip_smoke()
NAMES = list(CS.paper_suite(tsig.SignalGraph, 0))
BATCH = 2
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_LENGTH = 4096
_JAX_OUT = {}


def _suite(pkg):
    return CS.paper_suite(pkg.SignalGraph, 0)


def _x(name):
    length = _suite(tsig)[name][1]
    return CS.suite_input(np, np.random.default_rng(len(name)), name,
                          length, BATCH)


def _jax_out(name):
    if name not in _JAX_OUT:
        g, length, _ = _suite(jsig)[name]
        _JAX_OUT[name] = {k: np.asarray(v) for k, v in CS.suite_forward(
            name, g.compile(length), jnp.asarray(_x(name))).items()}
    return _JAX_OUT[name]


def test_suite_names_are_the_paper_workloads():
    from repro.configs.sigdla_paper import list_workloads
    signal = {n for n in list_workloads() if n.startswith(("fft", "fir",
                                                           "dct"))}
    assert signal <= set(NAMES)
    assert set(NAMES) - signal == {"fft_ifft1024", "dwt_haar", "dwt_db2",
                                   "front1024"}


@pytest.mark.parametrize("backend", ["reference", "hopper"])
@pytest.mark.parametrize("name", NAMES)
def test_suite_graph_matches_the_jax_package(name, backend):
    g, length, _ = _suite(tsig)[name]
    with torch.no_grad():
        got = CS.suite_forward(name, g.compile(length, backend=backend,
                                               device="cpu"),
                               torch.as_tensor(_x(name)))
    want = _jax_out(name)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].numpy().dtype == w.dtype
        np.testing.assert_allclose(got[k].numpy(), w, **TOL)


@pytest.mark.parametrize("fuse", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_suite_lowering_report_matches_pallas(name, fuse):
    jg, length, _ = _suite(jsig)[name]
    tg = _suite(tsig)[name][0]
    jr = jg.compile(length, fuse=fuse, backend="pallas").lowering_report()
    tr = tg.compile(length, fuse=fuse, backend="hopper",
                    device="cpu").lowering_report()
    jr.pop("name"), tr.pop("name")
    assert tr == jr


# segments of each chain: (sub-steps, tiles a batch row, floats a tile,
# tiles a block, dynamic shared memory of a block)
CHAINS = {
    "fft128": [(7, 1, 256, 32, 80368)],
    "fft256": [(8, 1, 512, 16, 96832)],
    "fft512": [(9, 1, 1024, 8, 131744)],
    "fft1024": [(10, 1, 2048, 4, 205552)],
    "fft_ifft1024": [(10, 1, 2048, 4, 205552)] * 2,
    "front1024": [(10, 31, 2048, 4, 205552)],
}


@pytest.mark.parametrize("name", NAMES)
def test_suite_chain_report(name):
    g, length, _ = _suite(tsig)[name]
    rep = g.compile(length, backend="hopper", device="cpu").chain_report()
    got = [(len(s["steps"]), s["tiles"], s["tile_floats"],
            s["tiles_per_cta"], s["shared_bytes"])
           for r in rep for s in r["segments"]]
    assert got == CHAINS.get(name, [])
    assert all(s["launch"] == "shuffle_gemm_chain"
               for r in rep for s in r["segments"])
    for bytes_ in {b for *_, b in got}:
        assert bytes_ == CS.SUITE_SHARED_BYTES[name]


@pytest.fixture
def counted(monkeypatch):
    """Each shuffle-GEMM wrapper call, as ``ops.py`` and ``vjp.py`` make
    it, counted by kernel: on the card each is one launch."""
    counts = CS._suite_launches()
    for mod in ("repro_torch.kernels.shuffle_gemm.ops",
                "repro_torch.kernels.shuffle_gemm.vjp"):
        m = importlib.import_module(mod)
        for n in counts:
            if hasattr(m, n):
                def wrap(*a, _n=n, _fn=getattr(m, n), **k):
                    counts[_n] += 1
                    return _fn(*a, **k)
                monkeypatch.setattr(m, n, wrap)
    return counts


@pytest.mark.parametrize("name", NAMES)
def test_suite_launches_are_phase_19s(name, counted):
    g, length, _ = _suite(tsig)[name]
    x = torch.as_tensor(_x(name))
    for fuse in (0, 1, 2):
        c = g.compile(length, fuse=fuse, backend="hopper", device="cpu")
        for k in counted:
            counted[k] = 0
        with torch.no_grad():
            CS.suite_forward(name, c, x)
        assert counted == CS.SUITE_LAUNCHES[name][fuse], fuse


def _front(pkg, length):
    g = _suite(pkg)["front1024"][0]
    return g.compile(length, backend="hopper" if pkg is tsig else
                     "reference", **({"device": "cpu"} if pkg is tsig
                                     else {}))


def test_front_end_training_launches_are_phase_19s(counted):
    c = _front(tsig, GRAD_LENGTH)
    x = torch.as_tensor(CS.suite_input(np, np.random.default_rng(3),
                                       "front1024", GRAD_LENGTH, BATCH))
    c.value_and_grad(lambda o: torch.mean(o["mel"] ** 2),
                     wrt=("front", "mel"))(c.init_params(), x)
    assert counted == CS.SUITE_TRAIN_LAUNCHES


@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_front_end_gradients_match_jax(backend):
    """front1024 at 4096 samples (7 frames): the loss of phase 19 (the
    mel's squared error against a target over the target's power) and
    its gradients wrt the FIR taps and the mel weights, the JAX
    package's params carried across by ``params_from_jax``."""
    rng = np.random.default_rng(4)
    x = CS.suite_input(np, rng, "front1024", GRAD_LENGTH, BATCH)
    target = np.abs(rng.standard_normal((BATCH, 7, 64))).astype(
        np.float32) * 50
    jc = _front(jsig, GRAD_LENGTH)
    jp = jc.init_params()
    jl, jgrads = jc.value_and_grad(
        lambda o, t: jnp.mean((o["mel"] - t) ** 2) / jnp.mean(t ** 2),
        wrt=("front", "mel"))(jp, jnp.asarray(x), jnp.asarray(target))
    tg = _suite(tsig)["front1024"][0]
    tc = tg.compile(GRAD_LENGTH, backend=backend, device="cpu")
    tp = params_from_jax({k: dict(v) for k, v in jp.items()}, device="cpu")
    tl, tgrads = tc.value_and_grad(
        lambda o, t: torch.mean((o["mel"] - t) ** 2) / torch.mean(t ** 2),
        wrt=("front", "mel"))(tp, torch.as_tensor(x),
                              torch.as_tensor(target))
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    for k, f in (("front", "taps"), ("mel", "weights")):
        got = tgrads[k][f].numpy()
        assert float(np.abs(got).max()) > 0
        np.testing.assert_allclose(got, np.asarray(jgrads[k][f]),
                                   **GRAD_TOL)


@pytest.mark.parametrize("backend", ["reference", "hopper"])
def test_dct2_is_the_float64_matrix_product(backend):
    g, length, _ = _suite(tsig)["dct2_32"]
    x = _x("dct2_32")
    with torch.no_grad():
        got = CS.suite_forward("dct2_32", g.compile(
            length, backend=backend, device="cpu"), torch.as_tensor(x))["y"]
    c = dct_matrix(32).astype(np.float64)
    want = c @ x.astype(np.float64) @ c.T
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_front_end_streaming_refused_as_in_the_jax_package():
    msg = CS.SUITE_STREAM_REFUSED["front1024"]
    with pytest.raises(ValueError, match=msg):
        jsig.StreamingRunner(_suite(jsig)["front1024"][0])
    with pytest.raises(ValueError, match=msg):
        tsig.StreamingRunner(_suite(tsig)["front1024"][0], device="cpu")
