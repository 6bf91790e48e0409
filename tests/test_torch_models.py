"""The PyTorch port's dense decoders against the JAX package's.

For each of the five dense decoder configs (starcoder2-3b, gemma2-2b,
chatglm3-6b with 2d-RoPE, minitron-8b with squared ReLU, internvl2-26b
with embedding input) at ``reduced()`` size in float32, weights come
from the JAX package's own ``bundle.init(PRNGKey(...))`` through
:func:`repro_torch.convert.model_params_from_jax`, inputs from numpy or
JAX seeds, and:

  * the configs (every one of the ten, full and ``reduced()``) equal the
    JAX package's field for field;
  * ``forward_train`` logits, ``prefill`` logits and every cache leaf,
    and ``decode_step`` logits and cache equal the JAX package's at
    rtol 1e-4, atol 1e-5 (float32; the port's full-length attention is
    the flash kernel's plain version here, the reference's direct
    attention below 4096 positions);
  * the JAX package's teacher-forcing consistency holds on the port;
  * gemma2-2b past its window (S 40 > 32) keeps the local layer's ring
    cache and decodes over it as the reference does, bounds its logits
    by the softcap and restricts local attention to the window;
  * the port's ``attention`` equals the JAX package's XLA
    ``chunked_attention`` (its route at 4096 positions and more) called
    with small chunks, with GQA, a window and a softcap;
  * ``TokenStream`` batches equal the JAX package's bit for bit, and the
    model params converter maps leaf for leaf, dtypes included, for the
    dense trees and every other family's;
  * the other five configs (MoE, RG-LRU hybrid, xLSTM, Whisper) build,
    prefill and decode on the port (their parity: ``test_torch_moe.py``,
    ``test_torch_recurrent.py``, ``test_torch_whisper.py``);
  * the slice's new modules import neither ``jax`` nor ``repro``, and
    their entry points default to the card.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import sigdla_paper as jpaper
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import layers as jL
from repro.models.zoo import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch.configs import sigdla_paper as tpaper
from repro_torch.convert import model_params_from_jax
from repro_torch.data import TokenStream
from repro_torch.models import get_model
from repro_torch.models import layers as L

DENSE = ["starcoder2-3b", "gemma2-2b", "chatglm3-6b", "minitron-8b",
         "internvl2-26b"]
OTHER = ["xlstm-350m", "whisper-small", "recurrentgemma-2b",
         "qwen2-moe-a2.7b", "grok-1-314b"]
RTOL, ATOL = 1e-4, 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want,
                               np.float32), rtol=rtol, atol=atol)


def _pair(arch, seed=0, **kw):
    """(cfg, JAX bundle, JAX params, port bundle, port params)."""
    jcfg = jconfigs.get_config(arch).reduced(**kw)
    tcfg = tconfigs.get_config(arch).reduced(**kw)
    jb = jget_model(jcfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    return tcfg, jb, jp, get_model(tcfg), model_params_from_jax(jp, "cpu")


def _batch(cfg, seed, b=2, s=16):
    """One batch as (JAX dict, port dict) from a numpy seed."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        raw = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32), "labels": np.zeros((b, s), np.int32)}
    else:
        raw = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


def _split(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def _close_cache(got, want):
    assert int(got["pos"]) == int(want["pos"])
    assert sorted(got) == sorted(want)
    for name in want["blocks"]:
        for leaf in ("k", "v"):
            g, w = got["blocks"][name][leaf], want["blocks"][name][leaf]
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.list_configs())
def test_config_equals_reference(arch):
    assert tconfigs.list_configs() == jconfigs.list_configs()
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    kw = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128)
    assert dataclasses.asdict(t.reduced(**kw)) \
        == dataclasses.asdict(j.reduced(**kw))
    assert (t.layer_types, t.n_groups(), t.padded_vocab, t.q_dim, t.kv_dim) \
        == (j.layer_types, j.n_groups(), j.padded_vocab, j.q_dim, j.kv_dim)
    for s in jconfigs.SHAPES:
        assert tconfigs.cell_applicable(arch, s) \
            == jconfigs.cell_applicable(arch, s)


def test_shapes_and_paper_workloads_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tpaper.list_workloads() == jpaper.list_workloads()
    for name in jpaper.list_workloads():
        assert dataclasses.asdict(tpaper.get_workload(name)) \
            == dataclasses.asdict(jpaper.get_workload(name))


# -- the model converter -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_params_from_jax_leaf_for_leaf(dtype):
    cfg = dataclasses.replace(jconfigs.get_config("gemma2-2b").reduced(),
                              dtype=dtype)
    jp = jget_model(cfg).init(jax.random.PRNGKey(3))
    tp = model_params_from_jax(jp, "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda _: 0, tp)))
    for path, leaf in jleaves:
        got = tp
        for k in path:
            got = got[k.key]
        assert tuple(got.shape) == tuple(leaf.shape), path
        want_dt = torch.bfloat16 if leaf.dtype == jnp.bfloat16 \
            else torch.float32
        assert got.dtype == want_dt, path
        assert np.array_equal(got.float().numpy(),
                              np.asarray(leaf, np.float32)), path
    # norms float32, weights in the config's dtype
    assert tp["norm_f"].dtype == torch.float32
    assert tp["blocks"]["b0"]["wq"].dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tp["blocks"]["b0"]["wq"].shape[0] == cfg.n_groups()


# -- the models against the JAX package --------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(arch):
    cfg, jb, jp, tb, tp = _pair(arch, seed=1)
    B, S = 2, 12
    jbatch, tbatch = _batch(cfg, seed=5, b=B, s=S)
    j_logits, _ = jb.forward(jp, jbatch)
    t_logits, aux = tb.forward(tp, tbatch)
    assert aux == 0.0
    assert tuple(t_logits.shape) == (B, S, cfg.padded_vocab)
    _close(t_logits, j_logits)

    j_lp, j_cache = jb.prefill(jp, _split(jbatch, 0, S - 1), max_len=S + 2)
    t_lp, t_cache = tb.prefill(tp, _split(tbatch, 0, S - 1), max_len=S + 2)
    _close(t_lp, j_lp)
    _close_cache(t_cache, j_cache)
    j_ld, j_cache = jb.decode_step(jp, j_cache, _split(jbatch, S - 1, S))
    t_ld, t_cache = tb.decode_step(tp, t_cache, _split(tbatch, S - 1, S))
    _close(t_ld, j_ld)
    _close_cache(t_cache, j_cache)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference(arch):
    cfg, jb, jp, tb, tp = _pair(arch, seed=2)
    jbatch, tbatch = _batch(cfg, seed=6)
    (jl, (jnll, _)) = jb.loss_fn(jp, jbatch)
    (tl, (tnll, taux)) = tb.loss_fn(tp, tbatch)
    assert taux == 0.0
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tnll), float(jnll), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(arch):
    """The JAX package's teacher-forcing consistency on the port: decode
    after an (s-1)-token prefill reproduces the full forward's last two
    positions (``tests/test_models.py``'s limits)."""
    cfg = tconfigs.get_config(arch).reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(1), device="cpu")
    B, S = 2, 12
    _, batch = _batch(cfg, seed=7, b=B, s=S)
    full, _ = tb.forward(tp, batch)
    lp, cache = tb.prefill(tp, _split(batch, 0, S - 1), max_len=S + 2)
    np.testing.assert_allclose(lp[:, -1].numpy(), full[:, S - 2].numpy(),
                               rtol=2e-2, atol=2e-2)
    ld, cache = tb.decode_step(tp, cache, _split(batch, S - 1, S))
    np.testing.assert_allclose(ld[:, -1].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_teacher_forcing_limit_catches_a_wrong_position():
    """The bf16 teacher-forcing check ``chip_smoke.py`` holds at relative
    L2 2e-2 separates a decode step at the right position (equal to the
    forward on the CPU) from one whose RoPE position and cache slot are
    one off."""
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-3b").reduced(
        n_layers=4, d_model=256, n_heads=8, d_ff=512, vocab=1024),
        dtype="bfloat16")
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1024, (2, 128)).astype(np.int32))
    full, _ = tb.forward(tp, {"tokens": toks})
    rel = []
    for shift in (0, 1):
        _, cache = tb.prefill(tp, {"tokens": toks[:, :-1]}, max_len=130)
        cache["pos"] += shift
        ld, _ = tb.decode_step(tp, cache, {"tokens": toks[:, -1:]})
        rel.append(float((ld[:, -1] - full[:, -1]).norm()
                         / full[:, -1].norm()))
    assert rel[0] < 2e-2 < 0.1 < rel[1], rel


def test_decode_step_refuses_a_consumed_cache():
    """``decode_step`` writes the cache's tensors in place, so a second
    step from the cache it was given (a retry, or two steps compared from
    one prefill) raises instead of attending over the first step's keys;
    the returned cache steps on."""
    cfg = tconfigs.get_config("gemma2-2b").reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(2), device="cpu")
    _, batch = _batch(cfg, seed=5, b=2, s=6)
    _, cache = tb.prefill(tp, _split(batch, 0, 4), max_len=8)
    _, nxt = tb.decode_step(tp, cache, _split(batch, 4, 5))
    assert cache["pos"] is None and nxt["pos"] == 5
    with pytest.raises(ValueError, match="consumed"):
        tb.decode_step(tp, cache, _split(batch, 4, 5))
    _, nxt = tb.decode_step(tp, nxt, _split(batch, 5, 6))
    assert nxt["pos"] == 6


def test_gemma2_past_window_ring_cache_and_decode():
    """gemma2-2b at S 40 > window 32: the local layer's prefill keeps the
    last 32 keys rolled into ring order, and four decode steps write ring
    slots ``pos % 32`` and attend over them, as the reference does."""
    cfg, jb, jp, tb, tp = _pair("gemma2-2b", seed=4)
    assert cfg.pattern == ("local", "global") and cfg.window == 32
    S = 40
    jbatch, tbatch = _batch(cfg, seed=8, b=2, s=S + 4)
    j_lp, j_cache = jb.prefill(jp, _split(jbatch, 0, S), max_len=S + 4)
    t_lp, t_cache = tb.prefill(tp, _split(tbatch, 0, S), max_len=S + 4)
    _close(t_lp, j_lp)
    assert tuple(t_cache["blocks"]["b0"]["k"].shape[2:3]) == (32,)
    _close_cache(t_cache, j_cache)
    for i in range(4):
        j_ld, j_cache = jb.decode_step(jp, j_cache,
                                       _split(jbatch, S + i, S + i + 1))
        t_ld, t_cache = tb.decode_step(tp, t_cache,
                                       _split(tbatch, S + i, S + i + 1))
        _close(t_ld, j_ld)
        _close_cache(t_cache, j_cache)


def test_gemma2_softcap_bounds_logits():
    cfg = tconfigs.get_config("gemma2-2b").reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg, seed=9)
    logits, _ = tb.forward(tp, batch)
    assert float(logits.abs().max()) <= cfg.logit_softcap + 1e-3


def test_local_window_restricts_context():
    """A token beyond the window does not reach local-attention logits
    (``tests/test_models.py``'s case on the port)."""
    cfg = dataclasses.replace(
        tconfigs.get_config("gemma2-2b").reduced(
            n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab=64),
        pattern=("local",), tail=(), window=4, logit_softcap=0.0)
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    t1 = torch.zeros((1, 12), dtype=torch.int32)
    t2 = t1.clone()
    t2[0, 0] = 5
    l1, _ = tb.forward(tp, {"tokens": t1})
    l2, _ = tb.forward(tp, {"tokens": t2})
    np.testing.assert_allclose(l1[0, 11].numpy(), l2[0, 11].numpy(),
                               atol=1e-5)
    assert not np.allclose(l1[0, 1].numpy(), l2[0, 1].numpy())


# -- layers ------------------------------------------------------------------

ATTN_CASES = [
    # B, S, H, KV, hd, window, softcap
    (2, 40, 4, 2, 16, 0, 0.0),             # GQA
    (1, 37, 6, 3, 8, 9, 0.0),              # window, ragged chunks
    (2, 33, 4, 1, 16, 0, 50.0),            # MQA, softcap
    (1, 48, 8, 4, 32, 16, 30.0),           # window and softcap
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_chunked_reference(case):
    """The port's full-length ``attention`` (the flash kernel's plain
    version here) against the JAX package's chunked XLA attention with
    small chunks: its route for full-length calls of 4096 or more."""
    b, s, h, kv, hd, window, cap = case
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                softcap=cap, q_chunk=8, kv_chunk=16)
    got = L.attention(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(v), causal=True, window=window,
                      softcap=cap)
    _close(got, want)


def test_direct_attention_and_rope_match_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
            for _ in range(2))
    for kv_len, cap in ((7, 0.0), (10, 20.0)):
        want = jL.direct_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   softcap=cap, kv_len=kv_len)
        got = L.direct_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=False,
                                 softcap=cap, kv_len=kv_len)
        _close(got, want)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    for frac, pos in ((1.0, np.arange(5)), (0.5, np.arange(5) + 3),
                      (0.5, np.array([[4], [9]]))):
        xs = x[:, :pos.shape[-1]] if pos.ndim == 2 else x
        want = jL.apply_rope(jnp.asarray(xs), jnp.asarray(pos), frac, 1e6)
        got = L.apply_rope(torch.as_tensor(xs), torch.as_tensor(pos), frac,
                           1e6)
        _close(got, want)
    w = rng.standard_normal(16).astype(np.float32)
    _close(L.rms_norm(torch.as_tensor(x), torch.as_tensor(w)),
           jL.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(kind):
    p = jL.init_mlp(jax.random.PRNGKey(0), 16, 32, kind, jnp.float32)
    x = np.random.default_rng(12).standard_normal((2, 3, 16)).astype(
        np.float32)
    want = jL.mlp_forward(p, jnp.asarray(x), kind)
    got = L.mlp_forward(model_params_from_jax(p, "cpu"), torch.as_tensor(x),
                        kind)
    _close(got, want)


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 17])
def test_token_stream_bit_for_bit(step):
    j = JTokenStream(vocab=49152, seq_len=64, global_batch=4, seed=3)
    t = TokenStream(vocab=49152, seq_len=64, global_batch=4, seed=3)
    got, want = t.batch_at(step), j.batch_at(step)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- scope and entry points --------------------------------------------------

@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_naming_the_roadmap(arch):
    """Once the families other than the dense decoders raised here; since
    they are ported (MoE, RG-LRU, xLSTM, Whisper) ``get_model`` returns a
    working bundle for each: params on the CPU, a prefill and a decode
    step with finite logits over the padded vocabulary, and nothing
    raises ``NotImplementedError``.  Their parity with the JAX package is
    held in ``test_torch_moe.py``, ``test_torch_recurrent.py`` and
    ``test_torch_whisper.py``."""
    cfg = tconfigs.get_config(arch).reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    batch = {"tokens": toks[:, :8]}
    if cfg.input_kind == "encdec":
        batch["embeds"] = torch.zeros((2, cfg.enc_seq, cfg.d_model))
    lp, cache = tb.prefill(tp, batch, max_len=9)
    ld, cache = tb.decode_step(tp, cache, {"tokens": toks[:, 8:]})
    for logits in (lp, ld):
        assert tuple(logits.shape) == (2, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
    assert cache["pos"] == 9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", OTHER)
def test_model_params_from_jax_new_families(arch, dtype):
    """The converter on every other family's tree, leaf for leaf: the
    3-D expert leaves, ``rg_lambda``, the xLSTM recurrent weights, the
    per-layer Whisper stacks, in each leaf's own dtype."""
    cfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                              dtype=dtype)
    jp = jget_model(cfg).init(jax.random.PRNGKey(4))
    tp = model_params_from_jax(jp, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in leaves:
        got = tp
        for k in path:
            got = got[k.key]
        assert tuple(got.shape) == tuple(leaf.shape), path
        assert got.dtype == (torch.bfloat16 if leaf.dtype == jnp.bfloat16
                             else torch.float32), path
        assert np.array_equal(got.float().numpy(),
                              np.asarray(leaf, np.float32)), path
    names = {str(p[-1].key) for p, _ in leaves}
    want = {"qwen2-moe-a2.7b": {"experts_gate", "shared_route"},
            "grok-1-314b": {"experts_down", "router"},
            "recurrentgemma-2b": {"rg_lambda", "conv_w"},
            "xlstm-350m": {"m_wi", "s_rz"},
            "whisper-small": {"xwk", "norm_x"}}[arch]
    assert want <= names, names


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.serving import ServingEngine
    cfg = tconfigs.get_config("starcoder2-3b").reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tb.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        ServingEngine(tb).load(tp)
    with pytest.raises(RuntimeError, match="is_available"):
        model_params_from_jax({"w": np.zeros(2, np.float32)})


def test_new_modules_import_neither_jax_nor_repro():
    mods = ["repro_torch.configs", "repro_torch.configs.sigdla_paper",
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.zoo",
            "repro_torch.models.moe", "repro_torch.models.rglru",
            "repro_torch.models.xlstm", "repro_torch.models.whisper",
            "repro_torch.data.pipeline", "repro_torch.serving.engine",
            "repro_torch.serving.quantized",
            "repro_torch.serving.signal_service", "repro_torch.convert"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
