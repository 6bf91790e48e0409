"""The PyTorch port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain version (the
port's copy of the JAX package's direct attention); it is held against
``repro.kernels.flash_attention`` — the Pallas kernel in interpret mode,
as ``tests/test_flash_attention.py`` runs it — on the same numpy inputs,
over that file's six cases (GQA, causal, window, softcap,
bidirectional, MQA and ragged lengths), in bfloat16, and at two of the
TPU kernel's block sizes (the port has no block size: its result cannot
depend on one).  Tolerances are that file's: rtol = atol = 1e-4 in
float32, 3e-2 in bfloat16.  The CUDA kernel is held against the plain
version on the card in ``test_torch_gpu.py``.  A numpy emulation of the
bfloat16 kernel's tensor-core arithmetic (P rounded to bfloat16 before
P V) shows here that this rounding fits the limits the card tests and
``chip_smoke.py`` hold it to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import ref_attention as j_ref
from repro_torch.kernels import flash_attention, ref_attention

CASES = [
    # B, S, H, KV, hd, causal, window, softcap
    (2, 64, 4, 4, 16, True, 0, 0.0),
    (2, 64, 8, 2, 16, True, 0, 0.0),       # GQA 4:1
    (1, 100, 4, 2, 32, True, 24, 0.0),     # window + ragged S
    (2, 64, 4, 4, 16, True, 0, 30.0),      # softcap
    (2, 48, 6, 3, 16, False, 0, 0.0),      # bidirectional
    (1, 130, 2, 1, 64, True, 0, 0.0),      # MQA, ragged
]


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_reference(case):
    b, s, h, kv, hd, causal, window, cap = case
    q, k, v = _qkv(s + h, b, s, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), bq=32, bk=32, **kw))
    np.testing.assert_allclose(
        want, np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)), rtol=1e-4, atol=1e-4)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        ref_attention(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(v), **kw).numpy(), got.numpy())


def test_flash_bf16():
    q, k, v = _qkv(7, 2, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, bq=32, bk=32), np.float32)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def test_flash_block_size_invariance():
    """The JAX kernel at two block sizes and the port (which has none)
    give one result."""
    q, k, v = _qkv(9, 1, 96, 4, 4, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    a = np.asarray(j_flash(jq, jk, jv, bq=16, bk=16))
    b = np.asarray(j_flash(jq, jk, jv, bq=96, bk=32))
    got = flash_attention(*(torch.as_tensor(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for want in (a, b):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _bf16(a):
    """Round float32 values to bfloat16 (nearest even), kept as float32."""
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def _tensor_core_attention(q, k, v, bk=128):
    """The bfloat16 CUDA kernel's arithmetic, causal, in numpy: S = Q K^T
    from bfloat16 operands accumulated in float32, scaled by 1/sqrt(hd)
    in float32, masked to -1e30; an online softmax over tiles of ``bk``
    keys with float32 m, l and accumulator; P rounded to bfloat16 before
    P V (l sums the float32 P); the output rounded to bfloat16.
    q (S, H, hd), k/v (S, KV, hd) float32 holding bfloat16 values."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    qh = q.transpose(1, 0, 2)                          # (H, S, hd)
    kh = np.repeat(k.transpose(1, 0, 2), g, axis=0)
    vh = np.repeat(v.transpose(1, 0, 2), g, axis=0)
    scale = np.float32(1.0 / np.sqrt(hd))
    m = np.full((h, s, 1), -1e30, np.float32)
    l = np.zeros((h, s, 1), np.float32)
    acc = np.zeros((h, s, hd), np.float32)
    rows = np.arange(s)[:, None]
    for k0 in range(0, s, bk):
        keys = np.arange(k0, min(k0 + bk, s))[None, :]
        x = (qh @ kh[:, k0:k0 + bk].transpose(0, 2, 1)) * scale
        x = np.where(keys <= rows, x, np.float32(-1e30))
        m_new = np.maximum(m, x.max(axis=-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(x - m_new)
        l = l * alpha + p.sum(axis=-1, keepdims=True)
        acc = acc * alpha + _bf16(p) @ vh[:, k0:k0 + bk]
        m = m_new
    return _bf16(acc / np.maximum(l, np.float32(1e-30))).transpose(1, 0, 2)


def test_tensor_core_rounding_fits_the_bf16_limits():
    """At S 1024, 4 heads over 2, hd 128, causal: the emulated kernel
    against the JAX package's plain ``ref_attention`` in float32 on the
    same bfloat16-rounded inputs stays within rtol 1e-2, atol 5e-3 and a
    relative L2 error of 1e-2."""
    q, k, v = (_bf16(a[0]) for a in _qkv(14, 1, 1024, 4, 2, 128))
    got = _tensor_core_attention(q, k, v)
    want = np.asarray(j_ref(*(jnp.asarray(a[None]) for a in (q, k, v)),
                            causal=True))[0]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-3)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-2, rel
