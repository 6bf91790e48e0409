"""The PyTorch port's core against the JAX package's: plans, the fabric,
signal mappings, bitwidth arithmetic, the exec IR, the perf model, the
import boundary and device selection.

Inputs are made with numpy from a seed and given to both packages.  Plans
must be identical (exact equality); float results agree to rtol 1e-5,
atol 1e-5 (float32 arithmetic in another summation order) unless a test
says otherwise.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitwidth as jbw
from repro.core import fabric as jfab
from repro.core import signal_mapping as jsm
from repro.signal import graph as jgraph
from repro_torch.core import bitwidth as tbw
from repro_torch.core import fabric as tfab
from repro_torch.core import signal_mapping as tsm
from repro_torch.signal import graph as tgraph

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-5, atol=1e-5)


def _same_plan(a, b):
    np.testing.assert_array_equal(a.gather_idx, b.gather_idx)
    np.testing.assert_array_equal(a.pad_values, b.pad_values)
    assert a.width == b.width


# -- plans: bit-identical to the reference's ---------------------------------

@pytest.mark.parametrize("n", [2, 8, 64, 256])
@pytest.mark.parametrize("fused", [True, False])
def test_fft_plan_identical(n, fused):
    a, b = jsm.make_fft_plan(n, fuse_adjacent=fused), \
        tsm.make_fft_plan(n, fuse_adjacent=fused)
    assert a.fused == b.fused and len(a.stages) == len(b.stages)
    _same_plan(a.bitrev, b.bitrev)
    for sa, sb in zip(a.stages, b.stages):
        _same_plan(sa.gather, sb.gather)
        _same_plan(sa.scatter, sb.scatter)
        np.testing.assert_array_equal(sa.twiddle, sb.twiddle)
        assert (sa.half, sa.nb) == (sb.half, sb.nb)


@pytest.mark.parametrize("n,taps", [(16, 3), (128, 9), (1024, 9)])
def test_fir_plan_identical(n, taps):
    _same_plan(jsm.make_fir_plan(n, taps).im2col,
               tsm.make_fir_plan(n, taps).im2col)


@pytest.mark.parametrize("n,taps,phases", [(64, 5, 2), (256, 21, 8)])
def test_fir_phase_plan_identical(n, taps, phases):
    a = jsm.make_fir_phase_plan(n, taps, phases)
    b = tsm.make_fir_phase_plan(n, taps, phases)
    _same_plan(a.window, b.window)
    h = np.random.default_rng(taps).standard_normal(taps)
    np.testing.assert_array_equal(jsm.fir_phase_weights(h, phases),
                                  tsm.fir_phase_weights(h, phases))


@pytest.mark.parametrize("length,frame,hop", [(1024, 256, 128),
                                              (4096, 256, 128),
                                              (512, 64, 32)])
def test_frame_and_interleave_plans_identical(length, frame, hop):
    _same_plan(jgraph._frame_plan(length, frame, hop, 16),
               tgraph._frame_plan(length, frame, hop, 16))
    _same_plan(jgraph._interleave_plan(frame, 16),
               tgraph._interleave_plan(frame, 16))
    _same_plan(jgraph._deinterleave_plan(frame, 16),
               tgraph._deinterleave_plan(frame, 16))


@pytest.mark.parametrize("wavelet", ["haar", "db2"])
def test_dwt_plan_identical(wavelet):
    a, b = jsm.make_dwt_plan(64, wavelet), tsm.make_dwt_plan(64, wavelet)
    _same_plan(a.window, b.window)
    np.testing.assert_array_equal(jsm.dwt_filters(wavelet),
                                  tsm.dwt_filters(wavelet))


def test_dct_and_mel_matrices_identical():
    np.testing.assert_array_equal(jsm.dct_matrix(32), tsm.dct_matrix(32))
    np.testing.assert_array_equal(
        jgraph.mel_filterbank_matrix(129, 16_000, 24),
        tgraph.mel_filterbank_matrix(129, 16_000, 24))
    np.testing.assert_array_equal(jgraph.hann_window(256),
                                  tgraph.hann_window(256))


# -- the fabric --------------------------------------------------------------

def _random_plan(rng, n_in, n_out, pad_share):
    gi = rng.integers(0, n_in, n_out).astype(np.int32)
    gi[rng.random(n_out) < pad_share] = jfab.PAD
    pv = rng.standard_normal(n_out).astype(np.float32)
    return gi, pv


@pytest.mark.parametrize("pad_share", [0.0, 0.3])
def test_apply_plan_matches_reference(pad_share):
    rng = np.random.default_rng(7)
    gi, pv = _random_plan(rng, 50, 80, pad_share)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    want = jfab.apply_plan(jnp.asarray(x), jfab.ShufflePlan(gi, pv))
    got = tfab.apply_plan(torch.as_tensor(x), tfab.ShufflePlan(gi, pv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plan_algebra_matches_reference():
    rng = np.random.default_rng(3)
    gi, pv = _random_plan(rng, 24, 24, 0.2)
    diag = rng.standard_normal(24).astype(np.float32)
    ja, ta = jfab.ShufflePlan(gi, pv), tfab.ShufflePlan(gi, pv)
    perm = rng.permutation(24).astype(np.int32)
    jp = jfab.ShufflePlan(perm, np.zeros(24, np.int64))
    tp = tfab.ShufflePlan(perm, np.zeros(24, np.int64))
    _same_plan(ja.then(jp), ta.then(tp))
    _same_plan(jfab.fuse_plans(ja, jp), tfab.fuse_plans(ta, tp))
    _same_plan(jfab.tile_plan(ja, 3, 24), tfab.tile_plan(ta, 3, 24))
    assert jfab.is_permutation(jp) == tfab.is_permutation(tp)
    assert jfab.is_permutation(ja) == tfab.is_permutation(ta)
    assert jfab.block_perm_tile(jp) == tfab.block_perm_tile(tp)
    (jc, jd), (tc, td) = (jfab.compose_into_einsum(ja, diag, jp, None),
                          tfab.compose_into_einsum(ta, diag, tp, None))
    _same_plan(jc, tc)
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(td))
    (jadj, jad, jm), (tadj, tad, tm) = (jfab.adjoint_plan(ja, 24, diag),
                                        tfab.adjoint_plan(ta, 24, diag))
    _same_plan(jadj, tadj)
    np.testing.assert_array_equal(np.asarray(jad), np.asarray(tad))
    assert jm == tm


def test_apply_plan_via_isa_matches_reference():
    rng = np.random.default_rng(11)
    gi = rng.integers(0, 16, 20).astype(np.int32)
    gi[::5] = jfab.PAD
    pv = np.zeros(20, np.int64)
    x = rng.integers(0, 15, 16)
    for width in (4, 8, 16):
        (ja, jc), (ta, tc) = (
            jfab.apply_plan_via_isa(x, jfab.ShufflePlan(gi, pv, width)),
            tfab.apply_plan_via_isa(x, tfab.ShufflePlan(gi, pv, width)))
        np.testing.assert_array_equal(ja, ta)
        assert vars(jc) == vars(tc)


# -- signal mappings ---------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64, 256])
def test_fft_via_fabric_matches_reference(n):
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    for fused in (True, False):
        want = jsm.fft_via_fabric(jnp.asarray(z),
                                  jsm.make_fft_plan(n, fuse_adjacent=fused))
        got = tsm.fft_via_fabric(torch.as_tensor(z),
                                 tsm.make_fft_plan(n, fuse_adjacent=fused))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        back = tsm.ifft_via_fabric(got, tsm.make_fft_plan(n, fused))
        np.testing.assert_allclose(back.numpy(), z, rtol=1e-4, atol=1e-4)


def test_fir_dct_dwt_match_reference():
    from repro import signal as jsig
    from repro_torch import signal as tsig
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    h = rng.standard_normal(9).astype(np.float32)
    np.testing.assert_allclose(
        tsig.fir(torch.as_tensor(x), torch.as_tensor(h)).numpy(),
        np.asarray(jsig.fir(jnp.asarray(x), jnp.asarray(h))), **TOL)
    np.testing.assert_allclose(
        tsig.fir_phased(torch.as_tensor(x), torch.as_tensor(h), 4).numpy(),
        np.asarray(jsig.fir_phased(jnp.asarray(x), jnp.asarray(h), 4)),
        **TOL)
    np.testing.assert_allclose(
        tsig.dct(torch.as_tensor(x)).numpy(),
        np.asarray(jsig.dct(jnp.asarray(x))), **TOL)
    for a, b in zip(tsig.dwt(torch.as_tensor(x)), jsig.dwt(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_interleave_helpers_match_reference():
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((2, 16))
         + 1j * rng.standard_normal((2, 16))).astype(np.complex64)
    il = tsm.complex_to_interleaved(torch.as_tensor(z))
    np.testing.assert_array_equal(
        il.numpy(), np.asarray(jsm.complex_to_interleaved(jnp.asarray(z))))
    back = tsm.interleaved_to_complex(il)
    assert back.dtype == torch.complex64
    np.testing.assert_array_equal(back.numpy(), z)


def test_stft_istft_match_reference():
    from repro.signal import istft as jistft, stft as jstft
    from repro_torch.signal import istft as tistft, stft as tstft
    x = np.random.default_rng(5).standard_normal((2, 1024)).astype(
        np.float32)
    js, ts = jstft(jnp.asarray(x)), tstft(torch.as_tensor(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tistft(ts, length=1024).numpy(),
                               np.asarray(jistft(js, length=1024)),
                               rtol=1e-4, atol=1e-4)


# -- bitwidth ----------------------------------------------------------------

@pytest.mark.parametrize(
    "width,rows",
    [(w, "tie") for w in (4, 8, 16)] + [(w, "wide_range") for w in (4, 8, 16)],
    ids=["4", "8", "16", "4-wide_range", "8-wide_range", "16-wide_range"])
def test_quantize_and_planes_match_reference(width, rows):
    """``quantize``, ``split_planes`` and ``plane_matmul`` against the JAX
    package's.  ``wide_range``: rows over ten orders of magnitude, on
    which the multiply by the float32 reciprocal of ``qmax`` misses the
    IEEE quotient ``max(amax, 1e-8) / qmax`` that the JAX package and
    the one-launch kernel compute (the card test
    ``test_quantize_is_the_same_on_the_card`` holds the port's card path
    to it)."""
    rng = np.random.default_rng(width)
    if rows == "tie":
        x = rng.standard_normal((5, 12)).astype(np.float32)
        x[0, 0] = 0.5 * np.abs(x[0]).max() / (2 ** (width - 1) - 1)
    else:
        x = (rng.standard_normal((2000, 12))
             * np.exp(rng.uniform(-5, 5, (2000, 1)))).astype(np.float32)
        qmax = np.float32(2 ** (width - 1) - 1)
        amax = np.maximum(np.abs(x).max(-1, keepdims=True),
                          np.float32(1e-8))
        assert (amax * (np.float32(1) / qmax) != amax / qmax).any()
    jq, js = jbw.quantize(jnp.asarray(x), width)
    tq, ts = tbw.quantize(torch.as_tensor(x), width)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for a, b in zip(tbw.split_planes(tq, width),
                    jbw.split_planes(jq, width)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w = rng.integers(-7, 8, (12, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tbw.plane_matmul(tq, torch.as_tensor(w), width, 4).numpy(),
        np.asarray(jbw.plane_matmul(jq, jnp.asarray(w), width, 4)))
    assert tbw.int_headroom_bits(width, 8, 129) \
        == jbw.int_headroom_bits(width, 8, 129)


def test_round_half_to_even_like_jnp():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.as_tensor(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))


# -- exec IR -----------------------------------------------------------------

def _small_graph(mod, fn):
    g = mod.SignalGraph("small")
    g.fir("f", "input", taps=np.hanning(5) / 2)
    g.stft("spec", "f", frame=64, hop=32)
    g.dnn("mask", "spec", fn=fn)
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=32)
    g.outputs("out")
    return g


def _tmask(p, z):
    return torch.sigmoid(torch.abs(z) - 1.0)


def _tmask_other(p, z):
    return torch.sigmoid(torch.abs(z) - 2.0)


def test_fingerprint_tokenizes_torch_callables():
    from repro_torch import signal as tsig
    a = _small_graph(tsig, _tmask).compile(256, device="cpu")
    b = _small_graph(tsig, _tmask).compile(256, device="cpu")
    c = _small_graph(tsig, _tmask_other).compile(256, device="cpu")
    d = _small_graph(tsig, torch.sigmoid).compile(256, device="cpu")
    fa = a.program.fingerprint()
    assert fa is not None and fa == b.program.fingerprint()
    assert c.program.fingerprint() not in (None, fa)
    assert d.program.fingerprint() not in (None, fa)


def test_mask_frames_zeroes_past_valid_rows():
    from repro.core.exec_ir import mask_frames as jmask
    from repro_torch.core.exec_ir import mask_frames as tmask
    y = np.random.default_rng(0).standard_normal((3, 6, 4)).astype(
        np.float32)
    vf = np.array([6, 2, 0], np.int32)
    np.testing.assert_array_equal(
        tmask(torch.as_tensor(y), torch.as_tensor(vf), 2).numpy(),
        np.asarray(jmask(jnp.asarray(y), jnp.asarray(vf), 2)))


def test_run_steps_reference_matches_reference():
    from repro.core import exec_ir as jir
    from repro_torch.core import exec_ir as tir
    rng = np.random.default_rng(9)
    gi, pv = _random_plan(rng, 32, 48, 0.2)
    op = rng.standard_normal((6, 5)).astype(np.float32)
    diag = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((2, 32)).astype(np.float32)

    def steps(ir, fab):
        return [ir.GatherStep("g", fab.ShufflePlan(gi, pv), diag),
                ir.EinsumStep("e", "...rt,to->...ro", op, reshape_in=(8, 6),
                              out_rank=2, rows=8, cin=6, cout=5)]
    want = jir.run_steps_reference(steps(jir, jfab), jnp.asarray(x), None)
    got = tir.run_steps_reference(steps(tir, tfab), torch.as_tensor(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- perf model and obs ------------------------------------------------------

def test_signal_graph_report_matches_reference():
    import jax
    from repro.core.perf_model import signal_graph_report as jrep
    from repro.core.perf_model import step_cost_estimate as jcost
    from repro_torch import signal as tsig
    from repro_torch.core.perf_model import signal_graph_report as trep
    from repro_torch.core.perf_model import step_cost_estimate as tcost

    def jmask(p, z):
        return jax.nn.sigmoid(jnp.abs(z) - 1.0)
    from repro import signal as jsig
    for fuse in (0, 1, 2):
        jc = _small_graph(jsig, jmask).compile(512, fuse=fuse)
        tc = _small_graph(tsig, _tmask).compile(512, fuse=fuse,
                                                device="cpu")
        ja, ta = jrep(jc), trep(tc)
        for key in ("fabric_passes", "shuffle_words", "shuffle_elems",
                    "streamed_passes", "streamed_words", "folded_passes",
                    "macs", "total", "per_output"):
            assert ja[key] == ta[key], key
        assert jcost(jc) == tcost(tc)


def test_obs_trace_and_report_roundtrip(tmp_path):
    from repro_torch import obs
    obs.reset()
    obs.enable()
    try:
        t0 = obs.now()
        obs.complete("SignalService", "core_call", t0, batch=2)
        obs.metrics().counter("service.submitted").inc(3)
        path = obs.get_tracer().export(str(tmp_path / "trace.json"))
        stats = obs.validate_trace(path)
        assert stats["events"] >= 1
        assert obs.metrics().snapshot()["counters"]["service.submitted"] == 3
    finally:
        obs.reset()


# -- the import boundary and device selection --------------------------------

def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imported in a fresh interpreter leaves no
    ``jax`` and no ``repro`` module behind, and no source line imports
    them."""
    pkg = SRC / "repro_torch"
    mods = sorted(".".join(("repro_torch",) + p.relative_to(pkg)
                           .with_suffix("").parts).replace(".__init__", "")
                  for p in pkg.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    for p in list(pkg.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import",
                                     "import repro\n")), (p, line)
            assert s != "import repro", (p, line)


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch import signal as tsig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        _small_graph(tsig, _tmask).compile(256)
    assert resolve_device("cpu") == torch.device("cpu")
