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
``chip_smoke.py`` hold it to.  A numpy emulation of the float32 kernel's
arithmetic (every product as three TF32 products of split operands, on
the key order and tile images of the kernel's pre-pass) shows that it
stays within 1e-5 of the float32 reference, and that one TF32 product
would not; the pre-pass's plain version is checked to lay out its tiles
as the kernel reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import ref_attention as j_ref
from repro_torch.kernels import flash_attention, ref_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref

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


# -- the float32 kernel: split-TF32 products on the tensor cores ----------

def _tf32(a):
    """Nearest TF32 to float32 ``a``, ties away from zero, on the bit
    patterns (PTX ``cvt.rna.tf32.f32``): half a unit of the 13 dropped
    bits added to the magnitude, then cut."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    big = _tf32(a)
    return big, _tf32(a - big)


def _offset(r, c, rows, row_floats):
    """Float offset of element (r, c) in a tile image: 128-byte rows (32
    floats a chunk, 16-byte unit XOR r % 8) or 64-byte rows (16 floats,
    unit XOR (r / 2) % 4) -- the forward map the kernel's descriptors
    read, written out independently of the plain pre-pass's inverse."""
    if row_floats == 32:
        return ((c >> 5) * rows * 32 + r * 32
                + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3))
    return r * 16 + ((((c >> 2) & 3) ^ ((r >> 1) & 3)) << 2) + (c & 3)


def _decode(blob, d, bk):
    """The plain pre-pass's (B, KV, tiles, 4, BK * D) images back to
    per-tile (K big, K small) as (B, KV, tiles, BK, D) and (V^T big, V^T
    small) as (B, KV, tiles, D, BK), V^T's columns in image order."""
    r, c = np.meshgrid(np.arange(bk), np.arange(d), indexing="ij")
    k_off = _offset(r, c, bk, 32)
    r, c = np.meshgrid(np.arange(d), np.arange(bk), indexing="ij")
    v_off = _offset(r, c, d, 32 if bk >= 32 else 16)
    return ([blob[..., i, :][..., k_off] for i in (0, 1)],
            [blob[..., i, :][..., v_off] for i in (2, 3)])


# Key held at column c of a TF32 A fragment's k-step: a thread of the S
# accumulator holds keys (2t, 2t + 1) of each group of 8, the A fragment
# wants them at columns (t, t + 4).
A_KEY = np.array([2 * t for t in range(4)] + [2 * t + 1 for t in range(4)])


def _split_tf32_attention(q, k, v, products=3):
    """The float32 CUDA kernel's arithmetic, causal, in numpy: Q
    pre-scaled by 1/sqrt(hd) in float32 and split; K and V^T from the
    plain pre-pass's tile images (``ref_split_kv``); S = Qb Kb^T + (Qb
    Ks^T + Qs Kb^T) (``products=1``: Qb Kb^T alone) in float32; scores in log2
    units, masked to -1e30; an online softmax over the kernel's tiles of
    BK keys with float32 m, l and accumulator; P split, and O += P V
    k-step by k-step of 8 keys, P's columns taken in the A fragment's key
    order against V^T's image columns.  It models the split, the order
    of the products and the tiling, not the tensor cores' rounding: numpy
    rounds every sum to nearest, where the card's accumulation truncates,
    so the card's error, which grows with the keys a row sees, is larger
    than this emulation's.  q (S, H, hd), k/v (S, KV, hd)."""
    s, h, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    d, bk = flash_ref.f32_tiling(hd)
    blob = flash_ref.ref_split_kv(torch.as_tensor(k[None]),
                                  torch.as_tensor(v[None])).numpy()[0]
    (kb, ks), (vb, vs) = _decode(blob, d, bk)       # (KV, tiles, ...)
    kb, ks, vb, vs = (np.repeat(a, g, axis=0) for a in (kb, ks, vb, vs))
    qh = np.zeros((h, s, d), np.float32)
    qh[..., :hd] = q.transpose(1, 0, 2) * np.float32(1.0 / np.sqrt(hd))
    qb, qs = _split(qh)
    log2e = np.float32(1.4426950408889634)
    m = np.full((h, s, 1), -1e30, np.float32)
    l = np.zeros((h, s, 1), np.float32)
    acc = np.zeros((h, s, d), np.float32)
    rows = np.arange(s)[:, None]
    for t in range(-(-s // bk)):
        keys = t * bk + np.arange(bk)[None, :]
        x = qb @ kb[:, t].transpose(0, 2, 1)
        if products == 3:           # the correction products, summed apart
            x = x + (qb @ ks[:, t].transpose(0, 2, 1)
                     + qs @ kb[:, t].transpose(0, 2, 1))
        x = np.where((keys <= rows) & (keys < s), x * log2e,
                     np.float32(-1e30))
        m_new = np.maximum(m, x.max(axis=-1, keepdims=True))
        alpha = np.exp2(m - m_new)
        p = np.exp2(x - m_new)
        l = l * alpha + p.sum(axis=-1, keepdims=True)
        acc = acc * alpha
        pb, ps = _split(p)
        for j in range(bk // 8):
            cols = 8 * j + A_KEY
            vbj = vb[:, t, :, 8 * j:8 * j + 8].transpose(0, 2, 1)
            vsj = vs[:, t, :, 8 * j:8 * j + 8].transpose(0, 2, 1)
            acc = acc + pb[..., cols] @ vbj
            if products == 3:
                acc = acc + pb[..., cols] @ vsj + ps[..., cols] @ vbj
        m = m_new
    out = acc / np.maximum(l, np.float32(1e-30))
    return out[..., :hd].transpose(1, 0, 2)


def test_tf32_rounding_on_bit_patterns():
    """The port's ``tf32_rna`` (the pre-pass's plain version) and the
    emulation's numpy rounding agree, round to nearest with ties away
    from zero, and the split recovers float32 to within 2^-22."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)) \
        .astype(np.float32)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                     2 - 2 ** -11], np.float32)
    np.testing.assert_array_equal(
        flash_ref.tf32_rna(torch.as_tensor(x)).numpy(), _tf32(x))
    np.testing.assert_array_equal(
        _tf32(ties), np.array([1 + 2 ** -10, -(1 + 2 ** -10),
                               1 + 2 * 2 ** -10, 2.0], np.float32))
    big, small = _split(x)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x - big) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x - big - small) <= np.abs(x) * 2.0 ** -22)


@pytest.mark.parametrize("skv,kv,hd", [(100, 2, 128), (37, 1, 20),
                                       (50, 3, 256), (130, 2, 64)])
def test_split_kv_tiles_are_the_kernel_images(skv, kv, hd):
    """The plain pre-pass (the CUDA pre-pass's spec, held to it bit for
    bit on the card) writes each tile's K and V^T, split, where the
    kernel's descriptors read them: decoded by the forward swizzle, K big
    + small is K and V^T's columns are the tile's keys in the order
    [0, 2, 4, 6, 1, 3, 5, 7] of each 8, zero past hd and past Skv."""
    rng = np.random.default_rng(skv + hd)
    k, v = (rng.standard_normal((2, skv, kv, hd)).astype(np.float32)
            for _ in range(2))
    d, bk = flash_ref.f32_tiling(hd)
    blob = flash_kernel.flash_split_kv_hopper(torch.as_tensor(k),
                                              torch.as_tensor(v)).numpy()
    tiles = -(-skv // bk)
    assert blob.shape == (2, kv, tiles, 4, bk * d)
    (kb, ks), (vb, vs) = _decode(blob, d, bk)
    pad = ((0, 0), (0, tiles * bk - skv), (0, 0), (0, d - hd))
    kp, vp = (np.pad(a, pad).reshape(2, tiles, bk, kv, d)
              .transpose(0, 3, 1, 2, 4) for a in (k, v))
    np.testing.assert_array_equal(kb, _tf32(kp))
    np.testing.assert_array_equal(ks, _tf32(kp - _tf32(kp)))
    order = (np.arange(bk) & ~7) | np.tile(A_KEY, bk // 8)
    vt = vp[..., order, :].swapaxes(-1, -2)         # (.., D, BK) permuted
    np.testing.assert_array_equal(vb, _tf32(vt))
    np.testing.assert_array_equal(vs, _tf32(vt - _tf32(vt)))


def test_split_tf32_arithmetic_fits_the_float32_limits():
    """At S 1024, 4 heads over 2, hd 128, causal: the emulated float32
    kernel against the JAX package's plain ``ref_attention`` in float32
    on the same inputs stays within 1e-5 everywhere; with one TF32
    product for each float32 one it does not."""
    q, k, v = (a[0] for a in _qkv(17, 1, 1024, 4, 2, 128))
    want = np.asarray(j_ref(*(jnp.asarray(a[None]) for a in (q, k, v)),
                            causal=True))[0]
    got = _split_tf32_attention(q, k, v)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5, err
    one = float(np.abs(_split_tf32_attention(q, k, v, products=1)
                       - want).max())
    assert one > 1e-5, one
