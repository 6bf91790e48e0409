"""Int8 gradient compression with error feedback on the PyTorch port,
bit for bit the JAX package's ``repro.optim.compression``.

  * ``compress_int8`` / ``decompress_int8`` on seeded data over six
    orders of magnitude, zeros and a single element: the int8 levels,
    the scale and the dequantized values equal the JAX package's;
  * ``ef_compress_update`` over the 50 steps of ``tests/test_optim.py``
    's error-feedback case: every payload and residual equal, and its
    bound (the sent total within the residual of the true total);
  * ``allreduce_compressed`` on 4 gloo ranks (``_torch_dist.run_ranks``,
    its own deadline) equal to the JAX package's run under
    ``jax.vmap(..., axis_name="pod")`` — its collectives on one device —
    and within its test's 0.1 of the mean (relative to the mean's
    largest element), over the world and over a mesh dim's group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from _torch_dist import run_ranks
from repro.optim import compression as JC
from repro_torch.optim import compression as TC


def _cases():
    rng = np.random.default_rng(0)
    out = {f"normal_1e{e}": (rng.standard_normal(1000) * 10.0 ** e).astype(
        np.float32) for e in (-6, -3, 0, 3)}
    out["zeros"] = np.zeros(17, np.float32)
    out["one"] = np.array([-2.5], np.float32)
    out["matrix"] = (rng.standard_normal((31, 7)) * 1e-2).astype(np.float32)
    out["halves"] = (np.arange(-300, 300) / 2.0).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(_cases()))
def test_compress_int8_matches_reference(name):
    x = _cases()[name]
    jq, js = JC.compress_int8(jnp.asarray(x))
    tq, ts = TC.compress_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(TC.decompress_int8(tq, ts).numpy(),
                                  np.asarray(JC.decompress_int8(jq, js)))


def test_error_feedback_matches_reference():
    """The 50 steps of the JAX package's ``test_error_feedback_accumulates``
    through both packages: payloads and residuals equal step by step,
    and the sent total stays within the residual of the true total."""
    rng = np.random.default_rng(1)
    grads_seq = [{"w": (rng.standard_normal(64) * 1e-3).astype(np.float32)}
                 for _ in range(50)]
    jres = JC.ef_init({"w": jnp.asarray(grads_seq[0]["w"])})
    tres = TC.ef_init({"w": torch.as_tensor(grads_seq[0]["w"])})
    assert tres["w"].dtype == torch.float32 and not tres["w"].any()
    sent_total = np.zeros(64, np.float32)
    true_total = np.zeros(64, np.float32)
    for g in grads_seq:
        jpay, jres = JC.ef_compress_update({"w": jnp.asarray(g["w"])}, jres)
        tpay, tres = TC.ef_compress_update({"w": torch.as_tensor(g["w"])},
                                           tres)
        (jq, js), (tq, ts) = jpay["w"], tpay["w"]
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(tres["w"].numpy(),
                                      np.asarray(jres["w"]))
        sent_total += TC.decompress_int8(tq, ts).numpy()
        true_total += g["w"]
    gap = np.abs(sent_total - true_total)
    assert gap.max() <= np.abs(tres["w"].numpy()).max() + 1e-6


def test_allreduce_compressed_matches_reference_vmap(tmp_path):
    """4 ranks, each row of a (4, 128) array at scale 1e-3 (the JAX
    package's test case, from a numpy seed): the port's all-reduce
    equals the JAX package's ``allreduce_compressed`` under ``vmap``
    bit for bit, on the world and on a ``"pod"`` mesh dim's group, and
    is within 0.1 of the mean."""
    x = (np.random.default_rng(0).standard_normal((4, 128)) * 1e-3).astype(
        np.float32)

    def body(row):
        q, s = JC.compress_int8(row)
        return JC.allreduce_compressed(q, s, "pod")
    want = np.asarray(jax.vmap(body, axis_name="pod")(jnp.asarray(x)))
    got = run_ranks(R.compressed_allreduce, 4, tmp_path, x)
    out = np.asarray(got["out"], np.float32)
    assert got["dtype"] == "torch.float32" and got["mesh_equal"]
    np.testing.assert_array_equal(out, want[0])
    ref = x.mean(axis=0)
    assert np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12) < 0.1
