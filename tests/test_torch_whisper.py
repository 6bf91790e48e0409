"""The PyTorch port's Whisper encoder-decoder against the JAX package's
(float32, CPU, ``reduced()``: 2 + 2 layers, 32 encoder frames; weights
from the JAX package's own init through ``model_params_from_jax``;
rtol 1e-4, atol 1e-5):

  * ``sinusoid``, ``encode``, ``prefill`` (logits and every cache leaf:
    the self K/V stacked per layer and the cross K/V) and ``decode_step``
    (logits and cache, step by step);
  * the whole model: forward logits, loss, prefill, decode steps, and
    greedy ``generate`` through ``ServingEngine`` (which adds the
    ``enc_seq`` zero frames) equal to the JAX package's tokens over 8
    steps;
  * the launches of a prefill's attention: the encoder's and the
    decoder's self-attention go to ``flash_attention`` (full length), the
    cross-attention never does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _model_parity import (batch, check_generate, check_model, close,
                           close_tree, cut, pair)
from repro.models import whisper as jwh
from repro_torch.models import layers as L
from repro_torch.models import whisper

ARCH = "whisper-small"


def test_sinusoid_matches_reference():
    """Positions a reduced model reaches.  (At 1499, the full encoder's
    last frame, the two differ by up to 1e-4: 35 of the 384 frequencies
    differ in their last bit between the two ``exp``s, and the angle
    carries that 1499-fold.)"""
    for pos in (np.arange(64), np.full((3, 1), 40)):
        close(whisper.sinusoid(torch.as_tensor(pos), 768),
              jwh.sinusoid(jnp.asarray(pos), 768))


def test_encode_matches_reference():
    cfg, _, jp, _, tp = pair(ARCH, seed=1)
    jbatch, tbatch = batch(cfg, 2)
    close(whisper.encode(tp, tbatch["embeds"], cfg),
          jwh.encode(jp, jbatch["embeds"], cfg))


@pytest.mark.parametrize("s", [1, 9])
def test_prefill_and_decode_steps_match_reference(s):
    cfg, _, jp, _, tp = pair(ARCH, seed=3)
    jbatch, tbatch = batch(cfg, 4, s=s + 3)
    jl, jc = jwh.prefill(jp, cut(jbatch, 0, s), cfg, max_len=s + 3)
    tl, tc = whisper.prefill(tp, cut(tbatch, 0, s), cfg, max_len=s + 3)
    close(tl, jl)
    close_tree(tc, jc)
    assert tuple(tc["cross_k"].shape) == (cfg.n_layers, 2, cfg.enc_seq,
                                          cfg.n_kv_heads, cfg.head_dim)
    for i in range(s, s + 3):
        jl, jc = jwh.decode_step(
            jp, jc, {"tokens": jbatch["tokens"][:, i:i + 1]}, cfg)
        tl, tc = whisper.decode_step(
            tp, tc, {"tokens": tbatch["tokens"][:, i:i + 1]}, cfg)
        close(tl, jl)
        close_tree(tc, jc)


def test_whisper_matches_reference():
    check_model(ARCH, seed=5, s=12, steps=3)


def test_whisper_generate_matches_reference():
    toks = check_generate(ARCH, seed=6)
    assert [len(t) for t in toks] == [8, 8]


def test_prefill_attention_routes(monkeypatch):
    """A prefill of S decoder tokens makes 2 x 2 full-length attention
    calls (the encoder's, non-causal over the frames, and the decoder's
    causal self-attention); the cross-attention (S queries over the
    frames) runs the direct form."""
    cfg, _, _, _, tp = pair(ARCH, seed=7)
    _, tbatch = batch(cfg, 8, s=10)
    seen = []
    flash = L.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)
    monkeypatch.setattr(L, "flash_attention", spy)
    whisper.prefill(tp, tbatch, cfg)
    assert seen == [(cfg.enc_seq, cfg.enc_seq, False)] * cfg.enc_layers \
        + [(10, 10, True)] * cfg.n_layers
