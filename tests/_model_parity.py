"""Shared checks of a whole model of the PyTorch port against the JAX
package's: one set of weights (the JAX package's own ``bundle.init``
crossed by ``model_params_from_jax``), seeded numpy inputs, float32
``reduced()`` configs.  Used by ``test_torch_moe.py``,
``test_torch_recurrent.py`` and ``test_torch_whisper.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import serving as js
from repro.models.zoo import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch import serving as ts
from repro_torch.convert import model_params_from_jax
from repro_torch.models import get_model

RTOL, ATOL = 1e-4, 1e-5          # float32 logits, aux, loss, cache leaves


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def close_tree(got, want, path="", tol=(RTOL, ATOL)):
    """Every leaf of the port's tree against the JAX package's: the same
    keys, shapes and (at ``tol``) values; ``pos`` exact."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            close_tree(got[k], want[k], f"{path}/{k}", tol)
        return
    if path.endswith("/pos"):
        assert int(got) == int(want), path
        return
    assert tuple(got.shape) == tuple(want.shape), path
    close(got, want, *tol, what=path)


def pair(arch, seed=0, **kw):
    """(port cfg, JAX bundle, JAX params, port bundle, port params) of
    ``arch`` at ``reduced(**kw)``; ``kw`` may also replace fields."""
    jcfg = jconfigs.get_config(arch).reduced(**kw)
    tcfg = tconfigs.get_config(arch).reduced(**kw)
    jb = jget_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    return tcfg, jb, jp, get_model(tcfg), model_params_from_jax(jp, "cpu")


def batch(cfg, seed, b=2, s=16):
    """One batch as (JAX dict, port dict) from a numpy seed; an
    encoder-decoder batch carries ``cfg.enc_seq`` frame embeddings."""
    rng = np.random.default_rng(seed)
    raw = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_kind == "encdec":
        raw["embeds"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


def cut(batch_, lo, hi):
    """Positions ``lo:hi`` of the token inputs (frame embeddings whole)."""
    return {k: v if k == "embeds" else v[:, lo:hi] for k, v in batch_.items()}


def check_model(arch, seed=0, s=16, steps=4, tol=(RTOL, ATOL), **kw):
    """forward_train logits and aux, loss_fn, prefill logits and every
    cache leaf, then ``steps`` decode steps (logits and every cache leaf
    each step), against the JAX package's at ``tol`` (rtol, atol)."""
    cfg, jb, jp, tb, tp = pair(arch, seed=seed, **kw)
    jbatch, tbatch = batch(cfg, seed + 5, s=s + steps)
    jforward, jloss, jdecode = (jax.jit(f) for f in (
        jb.forward, jb.loss_fn, jb.decode_step))
    jprefill = jax.jit(functools.partial(jb.prefill, max_len=s + steps))
    jf, jaux = jforward(jp, cut(jbatch, 0, s))
    tf, taux = tb.forward(tp, cut(tbatch, 0, s))
    close(tf, jf, *tol, what="forward logits")
    close(torch.as_tensor(taux), jaux, *tol, what="aux")
    (jl, (jnll, jax_aux)), (tl, (tnll, t_aux)) = (
        jloss(jp, cut(jbatch, 0, s)), tb.loss_fn(tp, cut(tbatch, 0, s)))
    close(tl, jl, *tol, what="loss")
    close(tnll, jnll, *tol, what="nll")
    jlp, jc = jprefill(jp, cut(jbatch, 0, s))
    tlp, tc = tb.prefill(tp, cut(tbatch, 0, s), max_len=s + steps)
    close(tlp, jlp, *tol, what="prefill logits")
    close_tree(tc, jc, tol=tol)
    for i in range(s, s + steps):
        jtok, ttok = ({"tokens": bb["tokens"][:, i:i + 1]}
                      for bb in (jbatch, tbatch))
        jld, jc = jdecode(jp, jc, jtok)
        tld, tc = tb.decode_step(tp, tc, ttok)
        close(tld, jld, *tol, what=f"decode logits at {i}")
        close_tree(tc, jc, f"decode cache at {i}", tol)
    return cfg, taux


def check_generate(arch, seed=0, lens=(9, 14), max_new=8, **kw):
    """Greedy ``generate`` of the port's ``ServingEngine`` gives the JAX
    package's tokens exactly (two left-padded prompts)."""
    cfg, jb, jp, tb, tp = pair(arch, seed=seed, **kw)
    rng = np.random.default_rng(seed + 9)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    jeng = js.ServingEngine(jb, batch_size=len(prompts))
    jeng.load(jp)
    teng = ts.ServingEngine(tb, batch_size=len(prompts))
    teng.load(tp, device="cpu")
    want = jeng.generate(prompts, max_new=max_new)
    got = teng.generate(prompts, max_new=max_new)
    assert got == want
    return got
