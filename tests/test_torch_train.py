"""The Fig-9 training path of the PyTorch port against the JAX package's.

* ``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on the same
  numpy params and gradients, three steps, clipped and unclipped, with
  and without decay: params, moments and gradient norm at rtol = atol =
  1e-6 (float32 arithmetic in both, in another order);
* ``repro_torch.data.SignalStream`` batches equal to the JAX package's,
  bit for bit (the same numpy calls);
* the first training step of the Fig-9 example at length 768 (mask CNN
  (2, 4, 4, 1) from numpy): loss and every gradient of the port's
  ``hopper`` backend (plain versions on the CPU) against the JAX
  package's ``pallas`` backend at rtol = atol = 1e-5;
* ``train`` lowers the held-out loss over 3 steps.

Multi-step trajectories are not compared element by element: AdamW's
first update is about ``lr * sign(g)``, so a gradient near 0 flips a
whole step between the two frameworks.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SignalStream as JSignalStream
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.data import SignalStream
from repro_torch.optim import adamw as tadamw
from repro_torch.pipelines import speech_enhancement as tse

LENGTH, BATCH, CH = 768, 2, (2, 4, 4, 1)


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "speech_enhancement.py"
    spec = importlib.util.spec_from_file_location("_fig9_example_train",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cnn(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
            .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
    return [np.asarray(tree, np.float32)]


# -- AdamW --------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale,decay", [(0.01, 0.1), (10.0, 0.1),
                                              (3.0, 0.0)])
def test_adamw_matches_reference(grad_scale, decay):
    rng = np.random.default_rng(int(grad_scale * 10))
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "cnn": [rng.standard_normal((2, 2, 3)).astype(np.float32),
                      rng.standard_normal(2).astype(np.float32)]}
    grads = [{k: (v * 0 + rng.standard_normal(np.shape(v)) * grad_scale
                  if not isinstance(v, list) else
                  [rng.standard_normal(a.shape) * grad_scale for a in v])
              for k, v in params.items()} for _ in range(3)]
    cast = {"jax": lambda a: jnp.asarray(a, jnp.float32),
            "torch": lambda a: torch.as_tensor(a, dtype=torch.float32)}

    def tree(t, fn):
        return {k: [fn(a) for a in v] if isinstance(v, list) else fn(v)
                for k, v in t.items()}

    jp, tp = tree(params, cast["jax"]), tree(params, cast["torch"])
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for g in grads:
        jp, js, jn = jadamw.adamw_update(tree(g, cast["jax"]), js, jp,
                                         lr=1e-2, weight_decay=decay)
        tp, ts, tn = tadamw.adamw_update(tree(g, cast["torch"]), ts, tp,
                                         lr=1e-2, weight_decay=decay)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert ts.step == int(js.step) == 3
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for a, b in zip(_flat(got), _flat(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_cosine_schedule_matches_reference():
    j, t = jadamw.cosine_schedule(3e-3, 10, 100), \
        tadamw.cosine_schedule(3e-3, 10, 100)
    # the JAX package evaluates in float32, the port in float64: near the
    # end of the decay 1 + cos cancels, so atol is 1e-6 of the base rate
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 140):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                   atol=3e-9)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_signal_stream_is_bit_identical(seed):
    j = JSignalStream(length=LENGTH, global_batch=BATCH, seed=seed)
    t = SignalStream(length=LENGTH, global_batch=BATCH, seed=seed)
    for step in (0, 1, 10_000):
        a, b = j.batch_at(step), t.batch_at(step)
        assert sorted(a) == sorted(b) == ["clean", "noisy"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# -- the first training step of Fig 9 -----------------------------------------

def test_first_step_matches_jax_example():
    jse = _jax_example()
    batch = SignalStream(LENGTH, BATCH, seed=0).batch_at(0)
    cnn = _cnn()
    edge = tse.FRAME

    def jloss(outs, clean):
        return jnp.mean((outs["out"][:, edge:-edge]
                         - clean[:, edge:-edge]) ** 2)

    jc = jse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="pallas")
    jp = dict(jc.init_params())
    jp["mask"] = [jnp.asarray(w) for w in cnn]
    jl, jg = jc.value_and_grad(jloss, wrt=tse.TRAINABLE)(
        jp, jnp.asarray(batch["noisy"]), jnp.asarray(batch["clean"]))

    tc = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                                device="cpu")
    tp = dict(tc.init_params())
    tp["mask"] = params_from_jax(cnn, device="cpu")
    tl, tg = tc.value_and_grad(tse.loss_fn, wrt=tse.TRAINABLE)(
        tp, torch.as_tensor(batch["noisy"]),
        torch.as_tensor(batch["clean"]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg["front"]["taps"].numpy(),
                               np.asarray(jg["front"]["taps"]), rtol=1e-5,
                               atol=1e-5)
    # the port keeps the mask CNN's weights OIHW, the JAX package HWIO
    want = params_from_jax([np.asarray(w) for w in jg["mask"]],
                           device="cpu")
    assert len(tg["mask"]) == len(want) == len(CH) - 1
    for got, w in zip(tg["mask"], want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_train_lowers_held_out_loss():
    c = tse.build_graph(LENGTH, ch=CH).compile(LENGTH, backend="hopper",
                                               device="cpu")
    params = dict(c.init_params())
    params["mask"] = params_from_jax(_cnn(), device="cpu")
    res = tse.train(c, params, SignalStream(LENGTH, BATCH, seed=0), steps=3)
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert res.eval_after < res.eval_before
    assert set(res.params) == set(params)
    # the mel weights were not trained
    np.testing.assert_array_equal(res.params["mel_tap"]["weights"],
                                  params["mel_tap"]["weights"])
