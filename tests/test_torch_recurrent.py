"""The PyTorch port's recurrent blocks (RG-LRU, mLSTM, sLSTM), their
layers (causal conv, layer and group norm) and the two recurrent models
against the JAX package's (float32, CPU; weights from the JAX package's
own init through ``model_params_from_jax``; rtol 1e-4, atol 1e-5 unless
a test says otherwise):

  * the port's log-depth doubling scan against ``lax.associative_scan``,
    and its op count growing with ceil(log2 S), not with S;
  * ``rglru_block_prefill``'s state and ``rglru_block_step`` continued
    from it, step by step;
  * ``causal_conv`` / ``causal_conv_step``, ``layer_norm``,
    ``group_norm``;
  * ``mlstm_chunkwise`` (S not a multiple of the chunk, with its final
    state) against the JAX package's chunkwise form and its
    ``mlstm_quadratic`` oracle; ``mlstm_step``; ``slstm_scan`` from zeros
    and from a carried state;
  * recurrentgemma-2b (past its reduced window of 32, through the tail's
    two ``rec`` blocks) and xlstm-350m at ``reduced()``: forward logits,
    loss, prefill logits and every cache leaf, decode steps, and greedy
    ``generate`` tokens exactly over 8 steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _model_parity import (batch, check_generate, check_model, close,
                           close_tree, pair)
from repro.models import layers as jL
from repro.models import rglru as jrg
from repro.models import transformer as JT
from repro.models import xlstm as jxl
from repro_torch.convert import model_params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import rglru, xlstm
from repro_torch.models import transformer as TT


def _np(seed, *shape, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _rglru_params(seed=0, d=16, r=24):
    jp = jrg.init_rglru_block(jax.random.PRNGKey(seed), d, r, 4,
                              jnp.float32)
    return jp, model_params_from_jax(jp, "cpu")


# -- RG-LRU --------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_rglru_scan_matches_associative_scan(s):
    jp, tp = _rglru_params()
    ju, tu = _both(_np(1, 2, s, 24))
    close(rglru.rglru_scan(tp, tu), jrg.rglru_scan(jp, ju))


class _CountOps(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_rglru_scan_is_log_depth():
    """The torch ops of one scan grow by a constant per doubling of S
    (one doubling step each, ceil(log2 S) of them), not with S."""
    _, tp = _rglru_params(r=8)
    counts = {}
    for s in (8, 16, 64, 512, 4096, 40, 2049):
        with _CountOps() as c:
            rglru.rglru_scan(tp, torch.zeros((1, s, 8)))
        counts[s] = c.n
    per_step = counts[16] - counts[8]
    for s, n in counts.items():
        assert n == counts[8] + per_step * (math.ceil(math.log2(s)) - 3), \
            counts
    assert counts[4096] < 200, counts


def test_rglru_prefill_state_then_steps_match_reference():
    """The prefill's carried state ``(h_last, conv)`` and 6 decode steps
    continued from it, step by step against the JAX package's."""
    jp, tp = _rglru_params(2)
    jx, tx = _both(_np(3, 2, 30, 16))
    j_out, (jh, jconv) = jrg.rglru_block_prefill(jp, jx[:, :24])
    t_out, (th, tconv) = rglru.rglru_block_prefill(tp, tx[:, :24])
    close(t_out, j_out)
    close(th, jh)
    close(tconv, jconv)
    close(rglru.rglru_block(tp, tx), jrg.rglru_block(jp, jx))
    jstate, tstate = (jh, jconv), (th, tconv)
    jstep = jax.jit(jrg.rglru_block_step)
    for t in range(24, 30):
        jo, jstate = jstep(jp, jx[:, t], jstate)
        to, tstate = rglru.rglru_block_step(tp, tx[:, t], tstate)
        close(to, jo)
        close(tstate[0], jstate[0])
        close(tstate[1], jstate[1])


def test_causal_conv_and_norms_match_reference():
    jw, tw = _both(_np(4, 4, 12))
    jx, tx = _both(_np(5, 2, 9, 12))
    close(L.causal_conv({"conv_w": tw}, tx),
          jL.causal_conv({"conv_w": jw}, jx))
    js, ts = _both(_np(6, 2, 3, 12))
    jo, jn = jL.causal_conv_step({"conv_w": jw}, jx[:, 0], js)
    to, tn = L.causal_conv_step({"conv_w": tw}, tx[:, 0], ts)
    close(to, jo)
    close(tn, jn)
    (jg, tg), (jb, tb) = _both(_np(7, 12)), _both(_np(8, 12))
    close(L.layer_norm(tx, tg, tb), jL.layer_norm(jx, jg, jb))
    jh, th = _both(_np(9, 2, 5, 3, 4, shift=0.5))
    close(L.group_norm(th, 1.0, 3), jL.group_norm(jh, jnp.asarray(1.0), 3))
    jw4, tw4 = _both(_np(10, 4))
    close(L.group_norm(th, tw4, 3), jL.group_norm(jh, jw4, 3))


# -- mLSTM / sLSTM -------------------------------------------------------------

def _mlstm_inputs(seed, b=2, s=41, h=2, hd=8):
    """q, k, v, i, f as numpy (``tests/test_mixers.py``'s draw: f shifted
    by +1)."""
    return (_np(seed, b, s, h, hd), _np(seed + 1, b, s, h, hd),
            _np(seed + 2, b, s, h, hd), _np(seed + 3, b, s, h),
            _np(seed + 4, b, s, h, shift=1.0))


@pytest.mark.parametrize("chunk", [16, 41, 256])
def test_mlstm_chunkwise_matches_reference(chunk):
    """Against the JAX package's chunkwise form at rtol 1e-4, atol 1e-5
    (output and final state), and its quadratic oracle at the reference
    suite's own 3e-4 (``tests/test_mixers.py``: the two forms round
    differently)."""
    raw = _mlstm_inputs(11)
    jin = [jnp.asarray(a) for a in raw]
    tin = [torch.as_tensor(a) for a in raw]
    j_out, j_state = jxl.mlstm_chunkwise(*jin, chunk=chunk,
                                         return_state=True)
    t_out, t_state = xlstm.mlstm_chunkwise(*tin, chunk=chunk,
                                           return_state=True)
    close(t_out, j_out)
    for got, want in zip(t_state, j_state):
        close(got, want)
    close(t_out, jxl.mlstm_quadratic(*jin), rtol=3e-4, atol=3e-4)
    close(xlstm.mlstm_quadratic(*tin), jxl.mlstm_quadratic(*jin))


def test_mlstm_step_matches_reference():
    raw = _mlstm_inputs(21, s=12)
    jin = [jnp.asarray(a) for a in raw]
    tin = [torch.as_tensor(a) for a in raw]
    _, j_state = jxl.mlstm_chunkwise(*(a[:, :8] for a in jin), chunk=4,
                                     return_state=True)
    _, t_state = xlstm.mlstm_chunkwise(*(a[:, :8] for a in tin), chunk=4,
                                       return_state=True)
    for t in range(8, 12):
        jo, j_state = jxl.mlstm_step(*(a[:, t] for a in jin), j_state)
        to, t_state = xlstm.mlstm_step(*(a[:, t] for a in tin), t_state)
        close(to, jo)
        for got, want in zip(t_state, j_state):
            close(got, want)


def test_slstm_scan_matches_reference():
    d, heads = 32, 4
    jp = jxl.init_slstm_block(jax.random.PRNGKey(3), d, heads, jnp.float32)
    tp = model_params_from_jax(jp, "cpu")
    jx, tx = _both(_np(31, 2, 10, d))
    j_h, j_carry = jxl.slstm_scan(jp, jx[:, :6])
    t_h, t_carry = xlstm.slstm_scan(tp, tx[:, :6])
    close(t_h, j_h)
    for got, want in zip(t_carry, j_carry):
        close(got, want)
    j_h, j_carry = jxl.slstm_scan(jp, jx[:, 6:], h0=j_carry)
    t_h, t_carry = xlstm.slstm_scan(tp, tx[:, 6:], h0=t_carry)
    close(t_h, j_h)
    for got, want in zip(t_carry, j_carry):
        close(got, want)
    j_out, _ = jxl.slstm_block(jp, jx, heads)
    t_out, _ = xlstm.slstm_block(tp, tx, heads)
    close(t_out, j_out)


# -- whole models --------------------------------------------------------------

def test_recurrentgemma_matches_reference_past_its_window():
    """S 40 > the reduced window 32: the local layer's ring cache, the
    ``rec`` layers' states and the tail's two ``rec`` blocks."""
    cfg, _ = check_model("recurrentgemma-2b", seed=3, s=40, steps=4)
    assert cfg.window == 32 and cfg.tail == ("rec", "rec")


def test_xlstm_blocks_match_reference_one_by_one():
    """Each of xlstm-350m's 8 blocks (7 mLSTM, 1 sLSTM) fed the JAX
    package's residual stream: train output, prefill output and every
    state leaf, and a decode step from the JAX package's prefill state,
    at rtol 1e-4, atol 1e-5."""
    cfg, _, jp, _, tp = pair("xlstm-350m", seed=4)
    jbatch, _ = batch(cfg, 9, s=21)
    jx = JT._embed_in(jp, jbatch, cfg)
    japply = jax.jit(JT.block_apply, static_argnums=(0, 3, 4, 5, 6))

    def tapply(lt, pt, x, mode, pos, cache):
        return TT.block_apply(lt, pt, torch.as_tensor(np.array(x)), cfg,
                              mode, None, pos, cache)[0]
    for i, lt in enumerate(cfg.pattern):
        pj = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"][f"b{i}"])
        pt = {k: v[0] for k, v in tp["blocks"][f"b{i}"].items()}
        jo, _, _ = japply(lt, pj, jx, cfg, "train", None, 0, None)
        close(tapply(lt, pt, jx, "train", 0, None), jo,
              what=f"block {i} train")
        jc0 = JT.init_block_cache(lt, cfg, 2, 21)
        tc = TT.init_block_cache(lt, cfg, 2, 21, "cpu")
        jpo, jc, _ = japply(lt, pj, jx[:, :20], cfg, "prefill", None, 0, jc0)
        close(tapply(lt, pt, jx[:, :20], "prefill", 0, tc), jpo,
              what=f"block {i} prefill")
        close_tree(tc, jc, f"block {i} prefill state")
        tc = model_params_from_jax(jc, "cpu")
        jdo, jc, _ = japply(lt, pj, jx[:, 20:], cfg, "decode", None, 20, jc)
        close(tapply(lt, pt, jx[:, 20:], "decode", 20, tc), jdo,
              what=f"block {i} decode")
        close_tree(tc, jc, f"block {i} decode state")
        jx = jo


def test_xlstm_matches_reference():
    """The whole model at rtol 1e-4, atol 3e-4: its eight exponentially
    gated blocks amplify one block's float32 rounding (a few 1e-6, held
    at 1e-5 block by block above) about threefold a block, to 1.3e-4 in
    the residual stream and 2.1e-4 in a decode step's logits."""
    cfg, _ = check_model("xlstm-350m", seed=4, s=20, steps=4,
                         tol=(1e-4, 3e-4))
    assert set(cfg.layer_types) == {"m", "s"}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_recurrent_generate_matches_reference(arch):
    lens = (36, 41) if arch == "recurrentgemma-2b" else (9, 14)
    toks = check_generate(arch, seed=5, lens=lens)
    assert [len(t) for t in toks] == [8, 8]


TF_F32_LIMIT = 1e-3       # chip_smoke.py's FAMILY_TF_F32_REL_L2


@pytest.mark.parametrize("arch,leaf", [("recurrentgemma-2b", "h"),
                                       ("xlstm-350m", "C")])
def test_teacher_forcing_limit_catches_a_lost_state(arch, leaf):
    """``chip_smoke.py`` holds the recurrent families' teacher forcing
    (a prefill of S - 1 tokens and one decode step against the forward)
    at relative L2 1e-3 in float32.  It separates a decode step from the
    prefill's state (1e-4 or less) from one whose recurrent layers lost
    their carried state (``leaf`` zeroed in every layer that has it:
    5.4e-3 for recurrentgemma, whose RG-LRU states carry little at this
    size, so the bf16 limit of 2e-2 would not catch it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced()
    tb = get_model(cfg)
    tp = tb.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 33)).astype(np.int32))
    full, _ = tb.forward(tp, {"tokens": toks})
    rel = []
    for lose in (False, True):
        _, cache = tb.prefill(tp, {"tokens": toks[:, :-1]}, max_len=34)
        if lose:
            for blk in [*cache["blocks"].values()] + [
                    cache[k] for k in cache if k.startswith("tail")]:
                if leaf in blk:
                    blk[leaf].zero_()
        ld, _ = tb.decode_step(tp, cache, {"tokens": toks[:, -1:]})
        rel.append(float((ld[:, -1] - full[:, -1]).norm()
                         / full[:, -1].norm()))
    assert rel[0] < 1e-4 < TF_F32_LIMIT < rel[1], rel


@pytest.mark.parametrize("arch,kw", [
    ("xlstm-350m", dict(d_model=128, n_layers=8)),
    ("recurrentgemma-2b", dict(d_model=384, n_heads=6, n_kv_heads=1,
                               n_layers=26, d_ff=768, window=64)),
])
def test_bf16_teacher_forcing_gap_is_the_references_own(arch, kw):
    """Why ``chip_smoke.py`` holds the families' teacher forcing in
    float32: in bf16 the decode step rounds other forms than the forward
    (the conv's one-rounding einsum against its per-tap sum, the
    bf16-rounded carried state), and on one set of weights the JAX
    package's own bf16 model reads above the 2e-2 a bf16 limit would
    allow, as the port's does (in float32 both hold 1e-4:
    ``test_teacher_forcing_limit_catches_a_lost_state`` and the parity
    tests above)."""
    s = 128
    cfg, jb, jp, tb, tp = pair(arch, seed=0, dtype="bfloat16", vocab=1024,
                               **kw)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    jf, _ = jax.jit(jb.forward)(jp, {"tokens": jt})
    _, jc = jax.jit(lambda p, b: jb.prefill(p, b, max_len=s + 2))(
        jp, {"tokens": jt[:, :-1]})
    jd, _ = jax.jit(jb.decode_step)(jp, jc, {"tokens": jt[:, -1:]})
    tf, _ = tb.forward(tp, {"tokens": tt})
    _, tc = tb.prefill(tp, {"tokens": tt[:, :-1]}, max_len=s + 2)
    td, _ = tb.decode_step(tp, tc, {"tokens": tt[:, -1:]})
    jf, jd = (np.asarray(a[:, -1], np.float32) for a in (jf, jd))
    read = (float(np.linalg.norm(jd - jf) / np.linalg.norm(jf)),
            float((td[:, -1] - tf[:, -1]).float().norm()
                  / tf[:, -1].float().norm()))
    print(f"{arch} bf16 teacher forcing, relative L2 (JAX package, port): "
          f"{read}")
    assert cfg.dtype == "bfloat16" and min(read) > 2e-2, read
