"""Gradients of the PyTorch port's SigProgram against the JAX package's.

``CompiledSignalGraph.value_and_grad`` on the port's ``hopper`` backend
(whose shuffle-GEMM kernels run their plain versions on the CPU, under
the hand-written backward Function of ``kernels/shuffle_gemm/vjp.py``)
is held against ``repro``'s ``pallas`` backend (interpret mode, its own
custom VJPs) on the same numpy inputs: loss and every gradient leaf at
rtol = atol = 1e-5, the tolerance ``tests/test_pallas_vjp.py`` holds
``pallas`` to against ``reference``.  The graphs are that file's: every
learnable stage kind, the full Fig-9 shape (batched too) and four random
streamable graphs, each built in both packages.

Also here: the backward Function against autograd through the plain
versions, the int route's straight-through gradient, the ``"hopper:vjp"``
plan-cache accounting, and the ``ValueError`` s of ``value_and_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import signal as jsig
from repro_torch import signal as tsig
from repro_torch.core.fabric import PAD, ShufflePlan, apply_plan
from repro_torch.kernels.shuffle_gemm import (
    ref_shuffle_gemm_grouped_blocks, shuffle_gemm, shuffle_gemm_grouped)
from repro_torch.precision.calibration import (CalibrationRecord,
                                               _ObserverBackend)

FRAME, HOP = 64, 32
LENGTH = 768
RTOL = ATOL = 1e-5

# the two packages' spellings of what a graph builder needs; a dnn hook
# may get a host array for a params entry nobody differentiates
JAX = dict(sig=jsig, tanh=jnp.tanh, sigmoid=jax.nn.sigmoid,
           mm=lambda m, w: m @ w)
TORCH = dict(sig=tsig, tanh=torch.tanh, sigmoid=torch.sigmoid,
             mm=lambda m, w: m @ torch.as_tensor(w))


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def _x(length, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (length,) if batch is None else (batch, length)
    return rng.standard_normal(shape).astype(np.float32)


def _sq_loss_jax(outs):
    if not isinstance(outs, dict):
        outs = {"out": outs}
    return sum(jnp.mean(jnp.abs(v) ** 2) for v in outs.values())


def _sq_loss_torch(outs):
    if not isinstance(outs, dict):
        outs = {"out": outs}
    return sum(torch.mean(torch.abs(v) ** 2) for v in outs.values())


def _leaves(tree):
    """Leaves in a fixed order: dict keys sorted (as ``ravel_pytree``),
    lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                       else tree, np.float32).ravel()]


# -- the graphs of tests/test_pallas_vjp.py, in either package ---------------

def _g_fir(o):
    g = o["sig"].SignalGraph("fir")
    g.fir("f", "input",
          taps=np.random.default_rng(1).standard_normal(9) * 0.3)
    g.outputs("f")
    return g


def _g_fir_phased(o):
    g = o["sig"].SignalGraph("fir_phased")
    g.fir("f", "input",
          taps=np.random.default_rng(2).standard_normal(8) * 0.3, phases=4)
    g.outputs("f")
    return g


def _g_stft_window(o):
    g = o["sig"].SignalGraph("win")
    g.stft("spec", "input", frame=FRAME, hop=HOP, window="learnable")
    g.magnitude("mag", "spec", onesided=True)
    g.outputs("mag")
    return g


def _g_mel(o):
    g = o["sig"].SignalGraph("mel")
    g.stft("spec", "input", frame=FRAME, hop=HOP)
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=12)
    g.outputs("mel")
    return g


def _g_biquad(o):
    g = o["sig"].SignalGraph("biquad")
    g.iir_biquad("iir", "input", b=[0.2, 0.3, 0.2], a=[1.0, -0.4, 0.1])
    g.outputs("iir")
    return g


def _g_dnn(o):
    rng = np.random.default_rng(3)
    tanh, mm = o["tanh"], o["mm"]
    g = o["sig"].SignalGraph("dnn")
    g.stft("spec", "input", frame=FRAME, hop=HOP)
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=12)
    g.dnn("net", "mel", fn=lambda p, m: tanh(mm(m, p["w"]) + p["b"]),
          init={"w": np.asarray(rng.standard_normal((12, 8)) * 0.2,
                                np.float32),
                "b": np.zeros(8, np.float32)})
    g.outputs("net")
    return g


def _g_fig9_full(o):
    """Learnable fir front-end + learnable window + mel + dnn mask +
    complex mul + istft: the uniform AND grouped kernels' backward and
    the adjoint of the framing gather in one program."""
    rng = np.random.default_rng(4)
    sigmoid, mm = o["sigmoid"], o["mm"]
    g = o["sig"].SignalGraph("fig9")
    g.fir("front", "input", taps=rng.standard_normal(7) * 0.2)
    g.stft("spec", "front", frame=FRAME, hop=HOP, window="learnable")
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=12)
    g.dnn("mask", "mel", fn=lambda p, m: sigmoid(mm(m, p["w"])),
          init={"w": np.asarray(rng.standard_normal((12, FRAME)) * 0.1,
                                np.float32)})
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=LENGTH)
    g.outputs("out", "mel")
    return g


def _random_streamable(o, seed):
    rng = np.random.default_rng(seed)
    sigmoid, mm = o["sigmoid"], o["mm"]
    frame = int(rng.choice([32, 64]))
    hop = frame // 2
    n_mels = int(rng.choice([8, 16]))
    g = o["sig"].SignalGraph(f"rand{seed}")
    src = "input"
    if rng.random() < 0.5:
        g.iir_biquad("iir", src, b=[0.3, 0.2, 0.1], a=[1.0, -0.3, 0.05])
        src = "iir"
    g.fir("f", src, taps=rng.standard_normal(int(rng.integers(3, 12))) * 0.3)
    window = "learnable" if rng.random() < 0.5 else True
    g.stft("spec", "f", frame=frame, hop=hop, window=window)
    g.magnitude("mag", "spec", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=n_mels)
    g.dnn("mask", "mel", fn=lambda p, m: sigmoid(mm(m, p["w"])),
          init={"w": np.asarray(
              rng.standard_normal((n_mels, frame)) * 0.1, np.float32)})
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=hop, length=LENGTH)
    g.outputs("out")
    return g


_STAGE_GRAPHS = {
    "fir_taps": _g_fir,
    "fir_phased_weights": _g_fir_phased,
    "stft_window": _g_stft_window,
    "mel_weights": _g_mel,
    "biquad_coeffs": _g_biquad,
    "dnn_hook": _g_dnn,
    "fig9_full": _g_fig9_full,
}


def _assert_grad_parity(build, batch=None, seed=0):
    """value_and_grad on the port's ``hopper`` (CPU) and on ``repro``'s
    ``pallas``: loss and every gradient leaf agree to 1e-5."""
    x = _x(LENGTH, batch=batch, seed=seed)
    jc = build(JAX).compile(LENGTH, fuse=jsig.FuseLevel.STREAM,
                            backend="pallas")
    tc = build(TORCH).compile(LENGTH, fuse=2, backend="hopper",
                              device="cpu")
    assert tc.backend.differentiable
    jl, jg = jc.value_and_grad(_sq_loss_jax)(jc.init_params(),
                                             jnp.asarray(x))
    tl, tg = tc.value_and_grad(_sq_loss_torch)(tc.init_params(),
                                               torch.as_tensor(x))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    assert sorted(tg) == sorted(jg)
    tf, jf = np.concatenate(_leaves(tg)), np.concatenate(_leaves(jg))
    assert tf.shape == jf.shape and tf.size > 0
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    assert float(np.abs(jf).max()) > 0     # informative, not zeros


@pytest.mark.parametrize("kind", sorted(_STAGE_GRAPHS))
def test_grad_parity_per_stage_kind(kind):
    _assert_grad_parity(_STAGE_GRAPHS[kind])


def test_grad_parity_batched():
    _assert_grad_parity(_g_fig9_full, batch=3, seed=7)


@pytest.mark.parametrize("seed", range(4))
def test_grad_parity_random_streamable_graphs(seed):
    _assert_grad_parity(lambda o: _random_streamable(o, seed),
                        seed=seed + 10)


def test_grads_keep_the_params_structure():
    """Grads come back as the selected params: field dicts, the dnn
    hook's init dict, a list of tensors; numpy leaves become tensors on
    the graph's device; a stage the loss never reaches gets zeros."""
    c = _g_fig9_full(TORCH).compile(LENGTH, device="cpu")
    params = c.init_params()
    params["extra"] = [np.ones(3, np.float32), torch.zeros(2)]
    loss, grads = c.value_and_grad(
        lambda outs: outs["out"].square().mean(),
        wrt=("front", "mask", "extra"))(params, _x(LENGTH))
    assert loss.ndim == 0 and not loss.requires_grad
    assert set(grads) == {"front", "mask", "extra"}
    assert set(grads["front"]) == {"taps"} and set(grads["mask"]) == {"w"}
    assert grads["front"]["taps"].shape == params["front"]["taps"].shape
    assert isinstance(grads["extra"], list)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads["extra"])
    (l2, aux), g2 = c.value_and_grad(
        lambda outs: (outs["out"].square().mean(), 7), wrt=("front",),
        has_aux=True)(params, _x(LENGTH))
    assert aux == 7 and float(l2) == float(loss)
    torch.testing.assert_close(g2["front"]["taps"], grads["front"]["taps"])


# -- the backward Function against autograd through the plain versions ------

def _plan(rng, n_in, n_out, pad):
    idx = rng.integers(0, n_in, n_out).astype(np.int32)
    if pad:
        idx[rng.random(n_out) < 0.2] = PAD
    return ShufflePlan(idx, rng.standard_normal(n_out).astype(np.float32)
                       * (idx == PAD))


@pytest.mark.parametrize("pad,scaled", [(False, False), (True, True)])
def test_shuffle_gemm_fn_matches_autograd(pad, scaled):
    rng = np.random.default_rng(int(pad) * 2 + int(scaled))
    rows, t, n_out, n_in = 40, 6, 5, 90
    plan = _plan(rng, n_in, rows * t, pad)
    diag = rng.standard_normal(rows * t).astype(np.float32) if scaled \
        else None
    x0 = _f32(rng.standard_normal((2, 3, n_in)))
    w0 = _f32(rng.standard_normal((t, n_out)))
    dy = _f32(rng.standard_normal((2, 3, rows, n_out)))

    def plain(x, w):
        g = apply_plan(x, plan)
        if diag is not None:
            g = g * torch.as_tensor(diag)
        return torch.matmul(g.reshape(2, 3, rows, t), w)

    got, want = [], []
    for fn, out in ((lambda x, w: shuffle_gemm(x, plan, w, rows, diag=diag),
                     got), (plain, want)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(x, w)
        y.backward(dy)
        out.extend([y.detach(), x.grad, w.grad])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("groups,pad,scaled", [(1, True, False),
                                               (4, False, True)])
def test_shuffle_gemm_grouped_fn_matches_autograd(groups, pad, scaled):
    rng = np.random.default_rng(groups)
    reps, nb, t, n_out, n_in = 3, 8 // groups, 4, 4, 70
    rows = reps * groups * nb
    plan = _plan(rng, n_in, rows * t, pad)
    diag = rng.standard_normal(rows * t).astype(np.float32) if scaled \
        else None
    x0 = _f32(rng.standard_normal((2, n_in)))
    w0 = _f32(rng.standard_normal((groups, t, n_out)))
    dy = _f32(rng.standard_normal((2, rows * n_out)))
    idx = torch.as_tensor(plan.gather_idx.reshape(rows, t))
    pads = torch.as_tensor(plan.pad_values.reshape(rows, t))
    scale = None if diag is None else torch.as_tensor(diag.reshape(rows, t))

    def kernel(x, w):
        return shuffle_gemm_grouped(x, plan, w, reps, groups, nb, diag=diag)

    def plain(x, w):
        return ref_shuffle_gemm_grouped_blocks(x, idx, pads, w, reps, groups,
                                               nb, scale)

    got, want = [], []
    for fn, out in ((kernel, got), (plain, want)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(x, w)
        y.backward(dy)
        out.extend([y.detach(), x.grad, w.grad])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_backward_skips_unneeded_grads():
    """Only ``w`` needs a gradient: the backward makes no kernel call
    for ``dx`` (the identity-gather and adjoint launches)."""
    from repro_torch.kernels.shuffle_gemm import vjp
    rng = np.random.default_rng(5)
    plan = _plan(rng, 30, 40, True)
    calls = []
    orig = vjp.shuffle_gemm_blocks
    vjp.shuffle_gemm_blocks = lambda *a: calls.append(1) or orig(*a)
    try:
        w = torch.ones((4, 2), requires_grad=True)
        shuffle_gemm(torch.ones((1, 30)), plan, w, 10).sum().backward()
    finally:
        vjp.shuffle_gemm_blocks = orig
    assert w.grad is not None and calls == [1]      # the forward only


# -- the int route's straight-through gradient -------------------------------

def test_precision_policy_straight_through_gradient():
    """Int-routed GEMMs differentiate by deliberate policy: backward is
    the float GEMM's VJP at the unquantized residuals with the cotangent
    at the quantized output, literally ``y = y_float + (y_int -
    y_float).detach()`` — asserted against that construction."""
    g = _g_mel(TORCH)
    pol = tsig.PrecisionPolicy({"mel": (16, 8)})
    ref = g.compile(LENGTH, backend="reference", device="cpu")
    hop = g.compile(LENGTH, backend=tsig.HopperBackend(precision=pol),
                    device="cpu")
    assert hop.lowering_report()["array_passes"]["int_routed"] == 1
    params = ref.init_params()
    x = torch.as_tensor(_x(LENGTH, seed=31))

    lq, gq = hop.value_and_grad(_sq_loss_torch, wrt=("mel",))(params, x)

    w = torch.as_tensor(params["mel"]["weights"]).requires_grad_()
    p = {**params, "mel": {"weights": w}}
    y_float = ref(x, p)["mel"]
    y_int = hop(x, p)["mel"]
    y = y_float + (y_int - y_float).detach()
    l_st = torch.mean(torch.abs(y) ** 2)
    (g_st,) = torch.autograd.grad(l_st, w)
    torch.testing.assert_close(lq, l_st.detach(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gq["mel"]["weights"], g_st, rtol=RTOL,
                               atol=ATOL)
    # informative (rounding's true gradient is zero) and really quantized
    assert float(gq["mel"]["weights"].abs().max()) > 0
    assert float((lq - _sq_loss_torch(ref(x, params))).abs()) > 0


# -- adjoint plan-cache accounting -------------------------------------------

def test_adjoint_lowerings_cached_independently():
    """Forward lowerings live under "hopper", adjoint lowerings under
    "hopper:vjp"; a second value_and_grad call rebuilds nothing."""
    tsig.clear_plan_caches()
    c = _g_fig9_full(TORCH).compile(LENGTH, fuse=2, backend="hopper",
                                    device="cpu")
    params = c.init_params()
    x = torch.as_tensor(_x(LENGTH, seed=41))
    info = tsig.plan_cache_info()["by_backend"]
    assert info["hopper"]["misses"] > 0
    assert "hopper:vjp" not in info

    c.value_and_grad(_sq_loss_torch)(params, x)
    info = tsig.plan_cache_info()["by_backend"]
    assert info["hopper:vjp"]["misses"] > 0
    assert info["hopper:vjp"]["entries"] > 0

    tsig.reset_plan_cache_stats()
    c.value_and_grad(_sq_loss_torch)(params, x)
    info = tsig.plan_cache_info()["by_backend"]
    assert info["hopper:vjp"]["hits"] > 0
    for label, bucket in info.items():
        assert bucket["misses"] == 0, (label, bucket)


# -- refusals ----------------------------------------------------------------

def test_value_and_grad_refuses_missing_wrt_stage():
    c = _g_fir(TORCH).compile(LENGTH, backend="hopper", device="cpu")
    vag = c.value_and_grad(_sq_loss_torch, wrt=("f", "nope"))
    with pytest.raises(ValueError, match="nope"):
        vag(c.init_params(), _x(LENGTH))
    with pytest.raises(ValueError, match="params dict"):
        c.value_and_grad(_sq_loss_torch)([1.0], _x(LENGTH))


def test_value_and_grad_refuses_non_differentiable_backend():
    c = _g_fir(TORCH).compile(LENGTH, backend="hopper", device="cpu")
    observer = c.with_backend(_ObserverBackend(CalibrationRecord("fir")))
    with pytest.raises(ValueError, match="differentiable=False"):
        observer.value_and_grad(_sq_loss_torch)
