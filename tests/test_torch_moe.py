"""The PyTorch port's Mixture-of-Experts layer and MoE models against the
JAX package's (float32, CPU; weights from the JAX package's own init
through ``model_params_from_jax``; rtol 1e-4, atol 1e-5 unless a test
says otherwise):

  * ``moe_forward`` on the capacity path, with no drops and at
    ``capacity_factor=1.25`` where slots really drop: the output, the
    aux loss, the routing (``expert_idx`` exactly) and each slot's
    position and kept/dropped mask exactly;
  * the capacity path's expert FFN expert-major: the down projection's
    operand ``(E, B, C, F)`` with a contiguous block whose ``(B, C)``
    merge is a view, on plain tensors and on 2 gloo ranks with
    grok-1-314b's specs (``fsdp``) at ``reduced()`` width, where DTensor
    plans that merge as a local view;
  * the dense path of a call of at most 4 positions (a decode step);
  * ``capacity`` over a grid;
  * qwen2-moe-a2.7b (shared expert) and grok-1-314b (softcaps, scaled
    embeddings) at ``reduced()``: forward logits and aux, loss, prefill
    logits and every cache leaf, decode steps, and greedy ``generate``
    tokens exactly over 8 steps; at the shipped capacity factor 1.25 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from _model_parity import check_generate, check_model, close
from _torch_dist import run_ranks
from repro.models import moe as jmoe
from repro_torch.convert import model_params_from_jax
from repro_torch.models import moe

MOE_ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b"]


def _layer(seed, d=32, f=64, e=8, shared=1):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, shared, 48,
                       jnp.float32)
    return jp, model_params_from_jax(jp, "cpu")


def _x(seed, b, s, d=32):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _jax_plan(jp, x, e, k, c):
    """The JAX package's routing of ``moe_forward``, step for step."""
    b, s, _ = x.shape
    probs = jax.nn.softmax(x @ jp["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(expert_idx.reshape(b, s * k), e, dtype=jnp.int32)
    pos_all = jnp.cumsum(oh, axis=1) - 1
    pos = jnp.take_along_axis(pos_all, expert_idx.reshape(b, s * k, 1),
                              axis=-1).reshape(b, s, k)
    return np.asarray(probs), np.asarray(expert_idx), np.asarray(pos), \
        np.asarray(pos < c)


def _min_margin(probs, k):
    """The smallest gap between neighbours among each token's top k + 1
    probabilities: how far the draw is from a tie that could order the
    two frameworks' top-k differently."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


@pytest.mark.parametrize("cf,drops", [(8.0, False), (1.25, True)])
def test_moe_forward_capacity_path_matches_reference(cf, drops):
    e, k, b, s = 8, 2, 2, 64
    jp, tp = _layer(1, e=e)
    x = _x(2, b, s)
    c = moe.capacity(s, e, k, cf)
    assert c == jmoe.capacity(s, e, k, cf)
    want, jaux = jmoe.moe_forward(jp, jnp.asarray(x), n_experts=e, top_k=k,
                                  capacity_factor=cf)
    got, taux = moe.moe_forward(tp, torch.as_tensor(x), n_experts=e,
                                top_k=k, capacity_factor=cf)
    close(got, want)
    close(taux, jaux)
    probs, jidx, jpos, jkeep = _jax_plan(jp, jnp.asarray(x), e, k, c)
    _, _, tidx = moe.route(tp, torch.as_tensor(x), k)
    tpos, tkeep = moe.dispatch_plan(tidx, e, c)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert (not jkeep.all()) == drops, int((~jkeep).sum())
    print(f"capacity_factor {cf}: C {c}, dropped slots "
          f"{int((~jkeep).sum())} of {jkeep.size}, smallest top-{k} "
          f"probability margin {_min_margin(probs, k):.3e}")


def test_expert_ffn_is_expert_major(monkeypatch):
    """The three expert GEMMs run on an expert-major slot buffer, (E, B,
    C, D), and the down projection's operand is a contiguous (E, B, C,
    F) block, so the (B, C) merge its product needs is a view of the same
    storage (on torch 2.11 DTensor plans that merge as a local ``view``,
    which a batch-major block refuses); the output is the reference's."""
    e, k, b, s = 8, 2, 3, 64
    jp, tp = _layer(7, e=e)
    x = _x(8, b, s)
    calls = []
    real = moe.einsum

    def spy(eq, *ops):
        calls.append((eq, ops[0]))
        return real(eq, *ops)
    monkeypatch.setattr(moe, "einsum", spy)
    got, _ = moe.moe_forward(tp, torch.as_tensor(x), n_experts=e, top_k=k,
                             capacity_factor=1.25)
    want, _ = jmoe.moe_forward(jp, jnp.asarray(x), n_experts=e, top_k=k,
                               capacity_factor=1.25)
    close(got, want)
    c = moe.capacity(s, e, k, 1.25)
    assert [eq for eq, _ in calls] == ["ebcd,edf->ebcf"] * 2 \
        + ["ebcf,efd->ebcd"]
    for _, op in calls:
        assert tuple(op.shape[:3]) == (e, b, c) and op.is_contiguous()
    op = calls[-1][1]
    merged = op.view(e, b * c, op.shape[-1])
    assert merged.untyped_storage().data_ptr() \
        == op.untyped_storage().data_ptr()


def test_expert_ffn_is_expert_major_on_a_mesh(tmp_path):
    """grok-1-314b's MoE layer at ``reduced()`` width with its ``fsdp``
    specs on 2 gloo ranks, as (2, 1) (the batch and the experts' d split
    over data) and (1, 2) (the experts' d_ff over model): each rank's
    block of the down projection's operand is expert-major and
    contiguous, its (B, C) merge a view, and the output and aux loss
    those of the layer on plain tensors.  The experts' d and the LM
    head's, split over data by fsdp, are gathered before their products
    (each rank's rows times whole-d weights split over the model axis):
    the plan torch 2.11's DTensor would otherwise replace by one that
    repeats the down projection's and the head's backward on every
    rank."""
    x = _x(9, 4, 40, d=64)
    got = run_ranks(R.moe_expert_layout, 2, tmp_path, "grok-1-314b",
                    [(2, 1), (1, 2)], x)
    e = got["n_experts"]
    for m in got["meshes"]:
        assert m["equation"] == "ebcf,efd->ebcd", m
        assert m["global_shape"][:2] == [e, 4], m
        assert m["contiguous"] and m["merge_shares_storage"], m
        assert m["out_err"] < 1e-5 and m["aux_err"] < 1e-6, m
    # (2, 1): fsdp splits d over data (the experts' dim 1 or 2, the head's
    # dim 0); the products read it whole
    split = got["meshes"][0]
    assert split["params_placed"] == {
        "experts_gate": ["S1", "R"], "experts_up": ["S1", "R"],
        "experts_down": ["S2", "R"], "head": ["S0", "R"]}
    assert split["weights_read"] == [["R", "R"]] * 4
    # (1, 2): d_ff and the vocab split over model stay split
    assert got["meshes"][1]["weights_read"] == [
        ["R", "S2"], ["R", "S2"], ["R", "S1"], ["R", "S1"]]
    assert [m["local_shape"][1] for m in got["meshes"]] == [2, 4]
    assert got["meshes"][1]["local_shape"][-1] \
        == got["meshes"][1]["global_shape"][-1] // 2


@pytest.mark.parametrize("s", [1, 4])
def test_moe_dense_path_matches_reference(s):
    """A call of at most 4 positions computes every expert and combines
    them with the top-k gates (aux 0), as the reference's decode path."""
    e, k = 8, 2
    jp, tp = _layer(3, e=e)
    x = _x(4, 3, s)
    want, jaux = jmoe.moe_forward(jp, jnp.asarray(x), n_experts=e, top_k=k)
    got, taux = moe.moe_forward(tp, torch.as_tensor(x), n_experts=e,
                                top_k=k)
    close(got, want)
    assert float(taux) == float(jaux) == 0.0
    dense, _ = moe.moe_forward_dense(tp, torch.as_tensor(x), n_experts=e,
                                     top_k=k)
    assert torch.equal(dense, got)


def test_moe_dense_path_equals_capacity_path_without_drops():
    """The port's two paths compute one function when nothing drops
    (``tests/test_mixers.py``'s case, on the port)."""
    _, tp = _layer(5, e=8, shared=0)
    x = torch.as_tensor(_x(6, 3, 1))
    dense, _ = moe.moe_forward_dense(tp, x, n_experts=8, top_k=2)
    scat, _ = moe.moe_forward(tp, x.repeat(1, 16, 1), n_experts=8, top_k=2,
                              capacity_factor=8.0)
    close(dense[:, 0], scat[:, 0].numpy())


def test_capacity_matches_reference():
    for s in (1, 5, 64, 2048):
        for e, k in ((4, 2), (8, 2), (60, 4)):
            for cf in (0.25, 1.0, 1.25, 8.0):
                assert moe.capacity(s, e, k, cf) == jmoe.capacity(s, e, k,
                                                                  cf)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [None, 1.25])
def test_moe_model_matches_reference(arch, cf):
    """The whole model, ``reduced()`` (capacity factor 8, no drops) and
    at the shipped 1.25, where the capacity path drops slots in the
    prefill and forward."""
    kw = {} if cf is None else {"capacity_factor": cf}
    cfg, aux = check_model(arch, seed=1, s=40, steps=3, **kw)
    assert cfg.n_experts == 4 and float(aux) > 0
    if arch == "qwen2-moe-a2.7b":
        assert cfg.n_shared_experts == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_generate_matches_reference(arch):
    toks = check_generate(arch, seed=2)
    assert [len(t) for t in toks] == [8, 8]

