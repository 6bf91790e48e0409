"""SignalGraph, its fuse levels and its backends in the PyTorch port
against the JAX package.

The Fig-9 speech-enhancement SigProgram (``examples/speech_enhancement.py``
in the JAX package, ``repro_torch.pipelines.speech_enhancement`` in the
port) is built at length 1024 with a small mask CNN (2, 4, 4, 1); its
weights and inputs are made with numpy from a seed and given to both.
Outputs of the port's ``reference`` and ``hopper`` backends (the latter's
kernels run their plain versions on the CPU) match the JAX package's
``reference`` backend at rtol 1e-4, atol 1e-5 — the tolerance its own
``tests/test_exec_backends.py`` holds ``pallas`` to.  Pass counts and
lowering reports must be equal.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import signal as jsig
from repro_torch import signal as tsig
from repro_torch.convert import params_from_jax
from repro_torch.pipelines import speech_enhancement as tse

LENGTH, CH = 1024, (2, 4, 4, 1)
TOL = dict(rtol=1e-4, atol=1e-5)
_JAX_OUT = {}


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "speech_enhancement.py"
    spec = importlib.util.spec_from_file_location("_fig9_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JSE = _jax_example()


def _inputs(seed=0, batch=3, length=LENGTH, ch=CH):
    rng = np.random.default_rng(seed)
    cnn = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
           .astype(np.float32) for ci, co in zip(ch[:-1], ch[1:])]
    x = rng.standard_normal((batch, length)).astype(np.float32)
    return cnn, x


def _jax_fig9(fuse):
    if fuse not in _JAX_OUT:
        cnn, x = _inputs()
        c = _JSE.build_graph(LENGTH, ch=CH).compile(LENGTH, fuse=fuse)
        params = dict(c.init_params())
        params["mask"] = [jnp.asarray(w) for w in cnn]
        _JAX_OUT[fuse] = {k: np.asarray(v)
                          for k, v in c(jnp.asarray(x), params).items()}
    return _JAX_OUT[fuse]


def _port_fig9(fuse, backend, device="cpu"):
    cnn, x = _inputs()
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, fuse=fuse,
                                               backend=backend,
                                               device=device)
    params = dict(c.init_params())
    params["mask"] = params_from_jax(cnn, device=device)
    with torch.no_grad():
        return c(torch.as_tensor(x, device=device), params)


# -- Fig 9 -------------------------------------------------------------------

@pytest.mark.parametrize("fuse,fabric", [(0, 38), (1, 19), (2, 3)])
def test_fig9_pass_counts_match_reference(fuse, fabric):
    jc = _JSE.build_graph(LENGTH, ch=CH).compile(LENGTH, fuse=fuse)
    tc = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, fuse=fuse,
                                                device="cpu")
    assert tc.fabric_pass_count() == jc.fabric_pass_count() == fabric
    assert tc.array_pass_count() == jc.array_pass_count() == 18
    assert tc.folded_pass_names() == jc.folded_pass_names()


@pytest.mark.parametrize("backend", ["reference", "hopper"])
@pytest.mark.parametrize("fuse", [0, 1, 2])
def test_fig9_outputs_match_reference(fuse, backend):
    want = _jax_fig9(fuse)
    got = _port_fig9(fuse, backend)
    assert list(got) == list(want) == ["out", "mel_tap"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL)


@pytest.mark.parametrize("fuse", [0, 1, 2])
def test_fig9_lowering_report_matches_pallas(fuse):
    jr = _JSE.build_graph(LENGTH, ch=CH).compile(
        LENGTH, fuse=fuse, backend="pallas").lowering_report()
    tr = tse.build_graph(LENGTH, ch=CH).compile(
        LENGTH, fuse=fuse, backend="hopper", device="cpu").lowering_report()
    assert (jr.pop("name"), tr.pop("name")) == ("pallas", "hopper")
    assert tr == jr


def test_fig9_lowering_at_full_width():
    """At length 4096 every array pass lands on the two kernels: 2
    row-uniform GEMMs and 16 butterflies."""
    tr = tse.build_graph(4096).compile(4096, fuse=2, backend="hopper",
                                       device="cpu").lowering_report()
    assert tr["routes"] == {"fused_gemm": 2, "fused_grouped": 16,
                            "host": 7, "jnp": 1}
    assert tr["fabric_passes"] == {"fused": 2, "emulated": 1}


def test_jit_entry_points_are_plain_callables():
    cnn, x = _inputs()
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, device="cpu")
    params = {"mask": params_from_jax(cnn, device="cpu")}
    a = c(torch.as_tensor(x), params)
    b = c.jit()(torch.as_tensor(x), params)
    m = c.masked_jit()(torch.as_tensor(x), torch.full((3,), 7), params)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        torch.testing.assert_close(a[k], m[k], rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["params_from_jax", "init_cnn"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Weights go to the card unless the caller names the CPU; on a host
    without a card the default raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cnn, _ = _inputs()
    call = {"params_from_jax": lambda **kw: params_from_jax(cnn, **kw),
            "init_cnn": lambda **kw: tse.init_cnn(
                torch.Generator().manual_seed(0), ch=CH, **kw)}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    assert all(w.device.type == "cpu" for w in call(device="cpu"))


def test_value_and_grad_names_the_training_slice():
    """value_and_grad runs on ``hopper`` with no rebind and equals the
    ``reference`` backend's gradients.  The name dates from when the call
    raised, naming the training slice; it is kept so the test's record
    stays continuous."""
    cnn, x = _inputs()
    grads = {}
    for backend in ("hopper", "reference"):
        c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend=backend,
                                                   device="cpu")
        params = dict(c.init_params())
        params["mask"] = params_from_jax(cnn, device="cpu")
        loss, grads[backend] = c.value_and_grad(
            lambda outs: outs["out"].square().mean(),
            wrt=("front", "mask"))(params, x)
        assert bool(torch.isfinite(loss))
    h, r = grads["hopper"], grads["reference"]
    assert set(h) == {"front", "mask"} and len(h["mask"]) == len(CH) - 1
    torch.testing.assert_close(h["front"]["taps"], r["front"]["taps"],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(h["mask"], r["mask"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cnn_mask_matches_reference():
    cnn, _ = _inputs()
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((2, 7, 129))
         + 1j * rng.standard_normal((2, 7, 129))).astype(np.complex64)
    want = _JSE.cnn_mask([jnp.asarray(w) for w in cnn], jnp.asarray(z))
    got = tse.cnn_mask(params_from_jax(cnn, device="cpu"),
                       torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got1 = tse.cnn_mask(params_from_jax(cnn, device="cpu"),
                        torch.as_tensor(z[0]))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want)[0],
                               rtol=1e-5, atol=1e-6)


# -- every stage kind ----------------------------------------------------------

H9 = (np.hanning(9) / 4).astype(np.float32)


def _kind_graph(pkg, kind):
    g = pkg.SignalGraph(kind)
    out = {
        "fir": lambda: g.fir("y", "input", taps=H9),
        "fir_phased": lambda: g.fir("y", "input", taps=H9, phases=4),
        "iir": lambda: g.iir_biquad("y", "input", b=[0.2, 0.3, 0.2],
                                    a=[1.0, -0.5, 0.25]),
        "dct": lambda: g.dct("y", "input"),
        "dwt_haar": lambda: g.dwt("y", "input", wavelet="haar"),
        "dwt_db2": lambda: g.dwt("y", "input", wavelet="db2"),
        "fft": lambda: g.fft("y", "input"),
        "fft_ifft": lambda: (g.fft("F", "input"), g.ifft("y", "F")),
        "stft_mel": lambda: (g.stft("s", frame=64, hop=32),
                             g.magnitude("m", "s", onesided=True),
                             g.mel_filterbank("y", "m", sr=16_000,
                                              n_mels=8)),
        "stft_istft": lambda: (g.stft("s", frame=64, hop=32),
                               g.istft("y", "s", hop=32)),
        "overlap_add": lambda: (g.stft("s", frame=64, hop=32),
                                g.magnitude("m", "s"),
                                g.overlap_add("y", "m", hop=32)),
        "circulant": lambda: (g.stft("s", frame=64, hop=32),
                              g.magnitude("m", "s"),
                              g.dnn_circulant("y", "m", 32, block=4)),
    }
    out[kind]()
    g.outputs("y")
    return g


KINDS = ["fir", "fir_phased", "iir", "dct", "dwt_haar", "dwt_db2", "fft",
         "fft_ifft", "stft_mel", "stft_istft", "overlap_add", "circulant"]


@pytest.mark.parametrize("backend", ["reference", "hopper"])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_kind_matches_reference(kind, backend):
    x = np.random.default_rng(len(kind)).standard_normal((2, 256)).astype(
        np.float32)
    want = np.asarray(_kind_graph(jsig, kind).compile(256)(
        jnp.asarray(x))["y"])
    with torch.no_grad():
        got = _kind_graph(tsig, kind).compile(256, backend=backend,
                                              device="cpu")(
            torch.as_tensor(x))["y"].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_stage_kind_lowering_report_matches_pallas(kind):
    jr = _kind_graph(jsig, kind).compile(256, backend="pallas") \
        .lowering_report()
    tr = _kind_graph(tsig, kind).compile(256, backend="hopper",
                                         device="cpu").lowering_report()
    jr.pop("name"), tr.pop("name")
    assert tr == jr


def test_masked_call_without_context_matches_reference():
    """Valid-frame masking of a graph with no frame context is the JAX
    package's, row for row."""
    x = np.random.default_rng(3).standard_normal((3, 256)).astype(
        np.float32)
    vf = np.array([7, 4, 1], np.int32)
    want = _kind_graph(jsig, "stft_istft").compile(256)(
        jnp.asarray(x), valid_frames=jnp.asarray(vf))["y"]
    got = _kind_graph(tsig, "stft_istft").compile(256, device="cpu")(
        torch.as_tensor(x), valid_frames=torch.as_tensor(vf))["y"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_masked_context_stage_equals_unpadded_run():
    """A dnn stage with frame context runs on each row's valid frames, so a
    masked row equals compiling at its true length (the JAX package feeds
    the masked zero frames to the CNN instead)."""
    cnn, x = _inputs(batch=2)
    g = tse.build_graph(LENGTH, ch=CH)
    params = {"mask": params_from_jax(cnn, device="cpu")}
    lens = [LENGTH - 300, LENGTH - 500]
    xb = np.zeros_like(x)
    for i, t in enumerate(lens):
        xb[i, :t] = x[i, :t]
    vf = [1 + (t - tse.FRAME) // tse.HOP for t in lens]
    with torch.no_grad():
        got = g.compile(LENGTH, device="cpu")(
            torch.as_tensor(xb), params, valid_frames=torch.as_tensor(vf))
        for i, t in enumerate(lens):
            want = g.compile(t, device="cpu")(
                torch.as_tensor(x[i:i + 1, :t]), params)
            np.testing.assert_allclose(got["mel_tap"][i, :vf[i]].numpy(),
                                       want["mel_tap"][0].numpy(),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got["out"][i].numpy(),
                                       want["out"][0].numpy(), atol=1e-5)
