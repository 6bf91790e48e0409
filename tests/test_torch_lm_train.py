"""Training the language models on the PyTorch port, against the JAX
package.

Weights come from the JAX package's own ``bundle.init`` through
:func:`repro_torch.convert.model_params_from_jax`, inputs from numpy
seeds, configs at ``reduced()`` size in float32:

  * ``loss_fn``'s value and the gradient of every leaf against
    ``jax.value_and_grad`` for all ten configs (internvl2-26b on an
    ``embeds`` / ``labels`` batch, whisper-small with its frames) at
    rtol 1e-4, atol 1e-5; xlstm-350m by each leaf's relative L2 error,
    at most 1e-3 (its blocks amplify float32 rounding: its logits are
    held at atol 3e-4 in ``test_torch_recurrent.py``);
  * under autograd ``kernels.flash_attention`` is never called, and
    without it every full-length attention layer calls it;
  * ``chunked_attention`` forward and gradients against the JAX
    package's at small chunks (causal, window, softcap, GQA, lengths not
    a multiple of the chunks) at 1e-5, and ``attention``'s route;
  * the remat forward's gradients ``torch.equal`` to the plain one's;
  * ``make_train_step`` with microbatch 1, 2 and 4 agrees (the
    counterpart of ``tests/test_train_step.py``), one step's params,
    optimizer state and metrics match the JAX package's
    ``make_train_step`` at rtol 1e-4, atol 1e-5, and the loss falls;
  * the in-place AdamW is ``torch.equal`` to ``adamw_update`` on float32
    and bfloat16 trees and writes into the given storage;
  * ``chip_smoke.py`` phase 17's per-model body (``family_train_run``)
    for its four families at ``reduced()`` width on the CPU, 3 steps:
    finite losses and gradient norms, no launch, the batches it trains on
    (Whisper's ``embeds`` beside the tokens).
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import layers as jL
from repro.models.zoo import get_model as jget_model
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.convert import model_params_from_jax
from repro_torch.launch.train import init_train_state, make_train_step
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     adamw_update_, cosine_schedule)
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["starcoder2-3b", "gemma2-2b", "chatglm3-6b", "minitron-8b",
         "internvl2-26b", "qwen2-moe-a2.7b", "grok-1-314b",
         "recurrentgemma-2b", "xlstm-350m", "whisper-small"]
RTOL, ATOL = 1e-4, 1e-5
XLSTM_REL_L2 = 1e-3


def _pair(arch, seed=0, **replace):
    """(port cfg, JAX bundle, JAX params, port bundle, port params) at
    ``reduced()``, with ``replace`` set on both configs."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               **replace)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               **replace)
    jb = jget_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    return tcfg, jb, jp, get_model(tcfg), model_params_from_jax(jp, "cpu")


def _batch(cfg, seed, b=2, s=16):
    """One training batch as (JAX dict, port dict) from a numpy seed."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        raw = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32),
               "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    else:
        raw = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
        if cfg.input_kind == "encdec":
            raw["embeds"] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


def _grads(tb, tp, batch):
    """(loss, nll, aux, grads tree) of the port's ``loss_fn``."""
    live = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    it = iter(live)
    loss, (nll, aux) = tb.loss_fn(tree_map(lambda _: next(it), tp), batch)
    g = torch.autograd.grad(loss, live, allow_unused=True,
                            materialize_grads=True)
    it = iter(g)
    aux = aux.detach() if isinstance(aux, torch.Tensor) else aux
    return (loss.detach(), nll.detach(), aux,
            tree_map(lambda _: next(it), tp))


def _ptrs(tree):
    return [t.data_ptr() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


# -- loss and gradients against the reference --------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and the gradient of every param leaf against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn`` on the same
    weights and batch."""
    cfg, jb, jp, tb, tp = _pair(arch)
    jbatch, tbatch = _batch(cfg, 3)
    (jl, (jnll, jaux)), jg = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(jp, jbatch)
    tl, tnll, taux, tg = _grads(tb, tp, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tnll), float(jnll), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(torch.as_tensor(taux)), float(jaux),
                               rtol=RTOL, atol=ATOL)
    jpaths = dict(_paths(jg))
    tpaths = dict(_paths(tg))
    assert sorted(jpaths) == sorted(tpaths)
    for path, want in jpaths.items():
        got = tpaths[path].numpy()
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, path
        if arch == "xlstm-350m":
            rel = float(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want), 1e-30))
            assert rel <= XLSTM_REL_L2, (path, rel)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=path)
    # a gradient of nothing but zeros would pass any tolerance
    assert any(float(np.abs(np.asarray(w)).max()) > 1e-3
               for w in jpaths.values())


def test_grad_tolerance_catches_a_wrong_gradient():
    """The per-leaf check fails when one leaf's gradient is off by 1e-3
    of its scale: a dropped term in one block would show."""
    cfg, jb, jp, tb, tp = _pair("starcoder2-3b")
    jbatch, tbatch = _batch(cfg, 3)
    _, jg = jax.value_and_grad(jb.loss_fn, has_aux=True)(jp, jbatch)
    *_, tg = _grads(tb, tp, tbatch)
    path = "/blocks/b0/wq"
    got = _leaf(tg, path).numpy()
    want = np.asarray(_leaf(jg, path))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    bad = got.copy()
    bad[0, 0, 0] += 1e-3 * float(np.abs(want).max())
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, want, rtol=RTOL, atol=ATOL)


def test_flash_is_never_called_under_grad(monkeypatch):
    """A differentiable forward makes no ``flash_attention`` call (the
    kernel has no backward pass); the same forward under
    ``torch.no_grad()`` calls it once a full-length attention layer, as
    serving does."""
    calls = []
    real = L.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(L, "flash_attention", counted)
    for arch in ("starcoder2-3b", "whisper-small"):
        cfg, _, _, tb, tp = _pair(arch)
        _, tbatch = _batch(cfg, 1)
        calls.clear()
        _grads(tb, tp, tbatch)
        assert calls == [], arch
        with torch.no_grad():
            tb.loss_fn(tp, tbatch)
        want = (cfg.enc_layers + cfg.n_layers if cfg.input_kind == "encdec"
                else sum(lt in ("global", "local")
                         for lt in cfg.layer_types))
        assert len(calls) == want, arch


# -- chunked attention -------------------------------------------------------

CHUNK_CASES = [
    # (S, H, KV, hd, causal, window, softcap)
    (21, 4, 2, 8, True, 0, 0.0),
    (19, 4, 1, 16, True, 6, 0.0),
    (16, 2, 2, 8, True, 0, 30.0),
    (23, 6, 2, 8, False, 0, 0.0),
    (18, 4, 4, 8, True, 5, 20.0),
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunked_attention_matches_reference(case):
    """The port's ``chunked_attention`` against the JAX package's at
    q_chunk 8, kv_chunk 4: the output, and the gradients of q, k and v
    for a random cotangent (``jax.vjp``), at 1e-5."""
    s, h, kv, hd, causal, window, softcap = case
    rng = np.random.default_rng(s * 7 + h)
    q, k, v = (rng.standard_normal((2, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    ct = rng.standard_normal((2, s, h, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=8,
              kv_chunk=4)
    want, vjp = jax.vjp(functools.partial(jL.chunked_attention, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    wgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = L.chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    ggrads = torch.autograd.grad(got, (tq, tk, tv), torch.as_tensor(ct))
    for g, w, name in zip(ggrads, wgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_attention_route_under_grad(monkeypatch):
    """``attention(chunked_threshold=16)`` under autograd: a full-length
    call of 20 positions is ``chunked_attention`` (also under remat,
    whose gradients are the plain call's bit for bit), one of 12 is
    ``direct_attention``; without a gradient both go to
    ``flash_attention``; a decode call (``kv_len``) stays direct."""
    seen = []
    for name in ("chunked_attention", "direct_attention",
                 "flash_attention"):
        real = getattr(L, name)

        def wrap(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(L, name, wrap)
    rng = np.random.default_rng(0)

    def qkv(s, grad):
        return [torch.tensor(rng.standard_normal((1, s, n, 8)).astype(
            np.float32), requires_grad=grad) for n in (4, 2, 2)]
    kw = dict(causal=True, window=0, softcap=0.0, chunked_threshold=16)
    for s, want in ((20, "chunked_attention"), (12, "direct_attention")):
        seen.clear()
        L.attention(*qkv(s, True), **kw)
        assert seen == [want], (s, seen)
        seen.clear()
        L.attention(*qkv(s, False), **kw)
        assert seen == ["flash_attention"], (s, seen)
    seen.clear()
    q, k, v = qkv(1, True)
    L.attention(q, *qkv(6, True)[1:], q_offset=5, kv_len=6, **kw)
    assert seen == ["direct_attention"]
    q, k, v = qkv(20, True)
    plain = torch.autograd.grad(L.attention(q, k, v, **kw).sum(), (q, k, v))
    remat = torch.autograd.grad(L.attention(q, k, v, remat=True, **kw).sum(),
                                (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


# -- remat -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "whisper-small"])
def test_remat_grads_equal_plain(arch):
    """With ``cfg.remat`` each pattern group (each Whisper layer) runs
    under ``torch.utils.checkpoint``; loss and every gradient leaf equal
    the plain forward's bit for bit."""
    cfg = tconfigs.get_config(arch).reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(2), device="cpu")
    rb = get_model(dataclasses.replace(cfg, remat=True))
    _, tbatch = _batch(cfg, 4)
    l0, _, _, g0 = _grads(tb, tp, tbatch)
    l1, _, _, g1 = _grads(rb, tp, tbatch)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(_paths(g0), _paths(g1)):
        assert torch.equal(a, b), p


def test_remat_checkpoints_each_group(monkeypatch):
    """The remat forward calls ``torch.utils.checkpoint`` once a pattern
    group in a recorded training forward, and never without a gradient
    or in the plain config."""
    from repro_torch.models import transformer as T
    calls = []
    real = T.checkpoint

    def counted(fn, *a, **kw):
        calls.append(kw)
        return real(fn, *a, **kw)
    monkeypatch.setattr(T, "checkpoint", counted)
    cfg = dataclasses.replace(tconfigs.get_config("gemma2-2b").reduced(),
                              remat=True)
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    _, tbatch = _batch(cfg, 1)
    _grads(tb, tp, tbatch)
    assert len(calls) == cfg.n_groups()
    assert all(kw["use_reentrant"] is False for kw in calls)
    calls.clear()
    with torch.no_grad():
        tb.loss_fn(tp, tbatch)
    assert calls == []


# -- the train step ----------------------------------------------------------

def _step_setup(microbatch, remat=False, seed=0):
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-3b").reduced(
        n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128),
        microbatch=microbatch, remat=remat)
    bundle = get_model(cfg)
    params, opt = init_train_state(
        bundle, torch.Generator().manual_seed(seed), device="cpu")
    return bundle, params, opt


def test_microbatch_equals_single_shot():
    """Microbatch 2 and 4 (strided split, float32 accumulation) give the
    single-shot step's loss within 1e-5 and its params at 2e-4, as the
    JAX package's ``test_microbatch_equals_single_shot``."""
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, 128, (8, 16)).astype(np.int32))}
    outs = {}
    for k in (1, 2, 4):
        bundle, params, opt = _step_setup(k)
        p2, o2, m = make_train_step(bundle)(params, opt, batch)
        outs[k] = (float(m["loss"]), tree_leaves(p2)[0].clone(), o2.step)
    assert abs(outs[1][0] - outs[2][0]) < 1e-5
    assert abs(outs[1][0] - outs[4][0]) < 1e-5
    np.testing.assert_allclose(outs[1][1].numpy(), outs[4][1].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert outs[1][2] == outs[2][2] == outs[4][2] == 1


def test_microbatch_split_is_strided(monkeypatch):
    """Microbatch m of k is rows m, m + k, ... of the batch, as the JAX
    package splits it."""
    bundle, params, opt = _step_setup(4)
    seen = []
    real = bundle.loss_fn
    bundle = dataclasses.replace(
        bundle, loss_fn=lambda p, b: (seen.append(b["tokens"].clone()),
                                      real(p, b))[1])
    toks = torch.arange(8, dtype=torch.int32)[:, None].repeat(1, 16)
    make_train_step(bundle)(params, opt, {"tokens": toks})
    assert [s[:, 0].tolist() for s in seen] == [[0, 4], [1, 5], [2, 6],
                                                [3, 7]]


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(microbatch):
    """One ``make_train_step`` step against the JAX package's on the same
    weights and batch: params, ``m``, ``v``, the step count, loss,
    gradient norm and learning rate at rtol 1e-4, atol 1e-5."""
    cfg, jb, jp, tb, tp = _pair("starcoder2-3b", microbatch=microbatch)
    jbatch, tbatch = _batch(cfg, 6, b=4)
    lr = (jadamw.cosine_schedule(1e-3, 0, 100),
          cosine_schedule(1e-3, 0, 100))
    jnew, jopt, jm = jax.jit(jtrain.make_train_step(jb, lr[0]))(
        jp, jadamw.adamw_init(jp), jbatch)
    tnew, topt, tm = make_train_step(tb, lr[1])(tp, adamw_init(tp), tbatch)
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert topt.step == int(jopt.step) == 1
    for got, want, what in ((tnew, jnew, "params"), (topt.m, jopt.m, "m"),
                            (topt.v, jopt.v, "v")):
        for path, w in _paths(want):
            np.testing.assert_allclose(
                _leaf(got, path).float().numpy(), np.asarray(w, np.float32),
                rtol=RTOL, atol=ATOL, err_msg=what + path)
    # the step moved the params (lr 1e-3 at step 0, no warmup)
    assert not torch.equal(tnew["head"], model_params_from_jax(
        jp, "cpu")["head"])


def test_train_step_updates_in_place_and_loss_decreases():
    """30 steps at ``cosine_schedule(5e-3, 3, 1000)`` on four recurring
    batches: the mean of the last 5 losses is under the first 5's minus
    0.2 (the JAX package's ``test_loss_decreases``), every step writes
    into the tensors it was given, and the step count is 30."""
    bundle, params, opt = _step_setup(1)
    ptrs = _ptrs((params, opt))
    step = make_train_step(bundle, cosine_schedule(5e-3, 3, 1000))
    losses = []
    for i in range(30):
        batch = {"tokens": torch.as_tensor(np.random.default_rng(
            100 + i % 4).integers(0, 128, (8, 16)).astype(np.int32))}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    assert opt.step == 30
    assert _ptrs((params, opt)) == ptrs


def test_remat_and_microbatch_step_equals_plain():
    """The remat step with microbatch 2 equals the plain remat-free step
    with microbatch 2 bit for bit (params and moments)."""
    batch = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(
        0, 128, (4, 16)).astype(np.int32))}
    outs = []
    for remat in (False, True):
        bundle, params, opt = _step_setup(2, remat=remat)
        outs.append(make_train_step(bundle, cosine_schedule(1e-3, 0, 10))(
            params, opt, batch))
    for a, b in zip(tree_leaves(outs[0][:2]), tree_leaves(outs[1][:2])):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


# -- in-place AdamW ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_adamw_equals_functional(dtype):
    """``adamw_update_`` gives ``adamw_update``'s params, moments and
    gradient norm bit for bit over three steps — a stacked leaf sliced
    along its group axis, a leaf of one row a slice, a vector, a scalar
    leaf — and writes them into the tensors it was given."""
    g = torch.Generator().manual_seed(0)
    shapes = {"stack": (5, 7, 3), "mat": (9, 4), "vec": (6,), "one": ()}
    params = {k: (torch.randn(s, generator=g) * 0.3).to(dtype)
              for k, s in shapes.items()}
    ref_p, ref_s = params, adamw_init(params)
    p = {k: t.clone() for k, t in params.items()}
    st = adamw_init(p)
    ptrs = _ptrs((p, st))
    for i in range(3):
        grads = {k: torch.randn(s, generator=g).to(dtype)
                 for k, s in shapes.items()}
        ref_p, ref_s, ref_n = adamw_update(grads, ref_s, ref_p, 1e-2)
        p, st, n = adamw_update_(grads, st, p, 1e-2, chunk_elems=10)
        assert torch.equal(n, ref_n)
        assert st.step == ref_s.step == i + 1
        for k in shapes:
            assert torch.equal(p[k], ref_p[k]), k
            assert torch.equal(st.m[k], ref_s.m[k]), k
            assert torch.equal(st.v[k], ref_s.v[k]), k
    assert _ptrs((p, st)) == ptrs
    assert isinstance(st, AdamWState)


FAMILY_TRAIN_ARCHS = ["qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-350m",
                      "whisper-small"]


@pytest.mark.parametrize("arch", FAMILY_TRAIN_ARCHS)
def test_family_train_body_on_the_cpu(arch, tmp_path):
    """``chip_smoke.py`` phase 17 trains these four families at full width
    on the card; its per-model body — ``make_batch_iterator`` over
    ``family_stream`` -> ``make_train_step`` -> ``TrainLoop`` — runs here
    at ``reduced()`` width (microbatch 2, remat; xlstm-350m at 2 layers)
    for 3 steps: every loss
    and gradient norm finite, the learning rates the schedule's, no
    kernel launch, the batch keys and shapes each family trains on, and
    the MoE's routed slots counted once a forward pass."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as CS
    assert FAMILY_TRAIN_ARCHS == [spec[0] for spec in CS.FAMILY_TRAIN]
    # xlstm-350m cut to one mLSTM and one sLSTM block: each mLSTM block
    # pads a call to its 256-position chunk, seconds a step on the CPU
    depth = dict(n_layers=2, pattern=("m", "s")) if arch == "xlstm-350m" \
        else {}
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              microbatch=2, remat=True, **depth)
    b, s, steps = 4, 24, 3
    run = CS.family_train_run(torch, np, cfg, b, s, steps, 0, "cpu",
                              str(tmp_path / "ck"))
    assert len(run["history"]) == steps and run["opt"].step == steps
    assert np.all(np.isfinite(run["history"]))
    assert np.all(np.isfinite(run["grad_norms"]))
    lr = cosine_schedule(*CS.FAMILY_TRAIN_LR, steps)
    assert run["lrs"] == [lr(i) for i in range(steps)]
    assert run["launches"] == [{}] * steps
    want = {"tokens": (b, s)}
    if cfg.input_kind == "encdec":
        want["embeds"] = (b, cfg.enc_seq, cfg.d_model)
    assert run["batch_keys"] == want
    if cfg.n_experts:
        # one capacity-path call a layer a microbatch, counted in the
        # forward pass only (remat routes each microbatch again)
        routed = cfg.n_layers * b * s * cfg.top_k
        assert [n for _, n in run["drops"]] == [routed] * steps
    else:
        assert run["drops"] == [(0, 0)] * steps
