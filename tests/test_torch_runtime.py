"""The PyTorch port's training runtime against the JAX package's:
``make_batch_iterator``, ``TrainLoop`` and ``StepMonitor``, and the
checkpointer under a training state.  The counterparts of
``tests/test_checkpoint_runtime.py``'s data, crash-restart and straggler
tests, on the CPU:

  * the data is a pure function of the step, and ``make_batch_iterator``
    yields the JAX package's batches bit for bit; ``sharding=`` raises;
  * a run that fails hard (retries exhausted) restores its last
    committed checkpoint and ends on the uninterrupted trajectory (rtol
    1e-6 for the toy model, as the JAX package's test; exactly for a
    reduced LM on the CPU);
  * the straggler monitor flags a slow step and keeps it out of its
    EWMA; SIGTERM checkpoints at the end of the step and stops;
  * bfloat16 leaves round-trip bit for bit, and ``(params,
    AdamWState)`` saves, restores (its step an ``int``) and resumes the
    uninterrupted losses exactly;
  * the entry points raise on a host without a card unless given
    ``device="cpu"``.
"""

import dataclasses
import signal
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenStream as JTokenStream
from repro.data import make_batch_iterator as jmake_batch_iterator
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.data import SignalStream, TokenStream, make_batch_iterator
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import init_train_state, make_train_step
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamWState, adamw_init, cosine_schedule
from repro_torch.runtime import StepMonitor, TrainLoop
from repro_torch.tree import tree_leaves, tree_map, tree_structure


# -- data --------------------------------------------------------------------

def test_data_determinism():
    s = TokenStream(vocab=100, seq_len=32, global_batch=4, seed=9)
    np.testing.assert_array_equal(s.batch_at(7), s.batch_at(7))
    assert not np.array_equal(s.batch_at(7), s.batch_at(8))
    sig = SignalStream(length=64, global_batch=2, seed=9)
    b = sig.batch_at(3)
    np.testing.assert_array_equal(b["noisy"], sig.batch_at(3)["noisy"])


@pytest.mark.parametrize("start", [0, 5])
def test_batch_iterator_matches_reference(start):
    """``(step, batch)`` pairs from ``start``, each batch's arrays equal
    to the JAX package's iterator's bit for bit, int32 tokens."""
    ours = make_batch_iterator(TokenStream(300, 24, 4, seed=3),
                               start_step=start, device="cpu")
    ref = jmake_batch_iterator(JTokenStream(300, 24, 4, seed=3),
                               start_step=start)
    for _ in range(3):
        (s, b), (js, jb) = next(ours), next(ref)
        assert s == js
        assert sorted(b) == sorted(jb) == ["tokens"]
        assert b["tokens"].dtype == torch.int32
        assert np.array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))


def test_batch_iterator_dict_stream_and_sharding():
    """A stream of dicts passes its keys through; ``sharding=`` takes a
    sharding bound to a ``DeviceMesh`` and refuses anything else (the
    sharded batches themselves: ``tests/test_torch_distributed.py``)."""
    step, b = next(make_batch_iterator(SignalStream(64, 2, seed=1),
                                       start_step=2, device="cpu"))
    assert step == 2 and sorted(b) == ["clean", "noisy"]
    np.testing.assert_array_equal(b["noisy"].numpy(),
                                  SignalStream(64, 2, seed=1)
                                  .batch_at(2)["noisy"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_batch_iterator(TokenStream(10, 4, 2), sharding=object(),
                            device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device="cpu"`` the iterator, ``init_train_state`` and
    the CLI ask for the card and raise on a host without one."""
    cfg = tconfigs.get_config("starcoder2-3b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_batch_iterator(TokenStream(10, 4, 2))
    with pytest.raises(RuntimeError, match="is_available"):
        init_train_state(get_model(cfg), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.main(["--steps", "1"])


# -- the loop on a toy model -------------------------------------------------

def _toy_setup(tmp_path):
    """A linear regression driven through the real loop (the JAX
    package's toy: plain gradient descent on the batch's tokens)."""
    target = torch.as_tensor(np.random.default_rng(0).standard_normal(16),
                             dtype=torch.float32)

    def step_fn(params, opt, batch):
        x = batch["tokens"].float()
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((x @ w - x @ target) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        return {"w": params["w"] - 0.01 * g}, opt, {"loss": loss.detach()}

    stream = TokenStream(vocab=50, seq_len=16, global_batch=4, seed=1)

    def batch_iter(start):
        return make_batch_iterator(stream, start_step=start, device="cpu")

    params = {"w": torch.zeros(16)}
    return step_fn, batch_iter, params, Checkpointer(str(tmp_path), keep=5)


def test_crash_restart_reproduces_trajectory(tmp_path):
    """A hard failure at step 12 (retries exhausted) restores step 10 and
    ends on the uninterrupted run's last 5 losses and params (rtol 1e-6,
    the JAX package's limit)."""
    step_fn, batch_iter, params, ck = _toy_setup(tmp_path)
    ref = TrainLoop(step_fn, batch_iter, ck, ckpt_every=5).run(
        params, {}, n_steps=20)
    ck2 = Checkpointer(str(tmp_path / "b"), keep=5)
    loop2 = TrainLoop(step_fn, batch_iter, ck2, ckpt_every=5, max_retries=1)
    fails = {"n": 0}

    def injector(step, attempt):
        if step == 12 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("simulated device failure")

    out = loop2.run(params, {}, n_steps=20, fail_injector=injector)
    assert fails["n"] == 2
    assert len(out["history"]) == 22          # steps 10, 11 replayed
    np.testing.assert_allclose(out["history"][-5:], ref["history"][-5:],
                               rtol=1e-6)
    np.testing.assert_allclose(out["params"]["w"].numpy(),
                               ref["params"]["w"].numpy(), rtol=1e-6)


def test_retry_within_budget_keeps_the_state(tmp_path):
    """A failure within ``max_retries`` retries the step on the same
    state: the trajectory is the uninterrupted one, no restore."""
    step_fn, batch_iter, params, ck = _toy_setup(tmp_path)
    ref = TrainLoop(step_fn, batch_iter, ck, ckpt_every=100).run(
        params, {}, n_steps=8)

    def injector(step, attempt):
        if step == 3 and attempt < 2:
            raise RuntimeError("transient")
    out = TrainLoop(step_fn, batch_iter, Checkpointer(str(tmp_path / "r")),
                    ckpt_every=100, max_retries=2).run(
        params, {}, n_steps=8, fail_injector=injector)
    assert out["history"] == ref["history"]


def test_straggler_monitor():
    m = StepMonitor(alpha=0.5, straggler_factor=2.0)
    assert not m.observe(0, 1.0)
    assert not m.observe(1, 1.1)
    assert m.observe(2, 5.0)          # 5x slower -> straggler
    assert m.stragglers == [2]
    # straggler samples must not poison the EWMA
    assert m.ewma < 1.2


def test_straggler_hook_fires_in_the_loop(tmp_path, monkeypatch):
    """A step the monitor flags fires ``on_straggler(step, dt)`` and is
    listed in the loop's ``stragglers``."""
    from repro_torch.runtime import fault_tolerance as ft
    step_fn, batch_iter, params, ck = _toy_setup(tmp_path)
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 12.0, 12.0, 13.0])
    monkeypatch.setattr(ft.time, "monotonic", lambda: next(clock))
    hits = []
    out = TrainLoop(step_fn, batch_iter, ck, ckpt_every=100,
                    on_straggler=lambda s, dt: hits.append((s, dt))).run(
        params, {}, n_steps=4)
    assert hits == [(2, 10.0)]
    assert out["stragglers"] == [2]


@pytest.fixture
def sigterm_restored():
    """Puts back the process's SIGTERM handler after the test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def test_sigterm_checkpoints_and_stops(tmp_path, sigterm_restored):
    """SIGTERM during step 3 makes the loop finish the step, checkpoint
    step 4 and stop with ``preempted``."""
    if threading.current_thread() is not threading.main_thread():
        pytest.fail("signal handlers install on the main thread only")
    step_fn, batch_iter, params, ck = _toy_setup(tmp_path)

    def step_and_signal(p, o, b):
        out = step_fn(p, o, b)
        if len(seen) == 3:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "the loop installed no handler"
            signal.raise_signal(signal.SIGTERM)
        seen.append(1)
        return out
    seen = []
    out = TrainLoop(step_and_signal, batch_iter, ck, ckpt_every=100).run(
        params, {}, n_steps=20)
    assert out["preempted"] and out["stop_step"] == 4
    assert len(out["history"]) == 4
    assert latest_step(str(tmp_path)) == 4
    step, back = ck.restore(like=(out["params"], {}))
    assert step == 4
    np.testing.assert_array_equal(back[0]["w"], out["params"]["w"].numpy())


# -- checkpoints of a training state -----------------------------------------

def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """bfloat16 leaves — NaN payloads, infinities, -0, subnormals and
    random values — come back as host bfloat16 tensors equal bit for bit;
    the manifest names the dtype and the stored pattern."""
    import json
    bits = np.concatenate([np.array([0x7FC1, 0xFF81, 0x7F80, 0xFF80, 0x8000,
                                     0x0001, 0x807F], np.uint16),
                           np.random.default_rng(0).integers(
                               0, 2 ** 16, 983).astype(np.uint16)])
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    tree = {"w": t.reshape(33, 30), "f": torch.ones(3)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    _, back = ck.restore(like=tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    np.testing.assert_array_equal(back["f"], np.ones(3, np.float32))
    with open(tmp_path / "step_000001" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert {"shape": [3], "dtype": "float32"} in leaves
    assert {"shape": [33, 30], "dtype": "bfloat16",
            "stored_as": "int16"} in leaves


def test_named_tuple_tree_map_and_structure():
    """``tree_map`` rebuilds a NamedTuple field by field (positionally)
    and ``tree_structure`` tells it apart from a plain tuple."""
    st = AdamWState(3, {"a": torch.ones(2)}, {"a": torch.zeros(2)})
    doubled = tree_map(lambda x: x * 2, st)
    assert isinstance(doubled, AdamWState) and doubled.step == 6
    assert torch.equal(doubled.m["a"], torch.full((2,), 2.0))
    assert tree_structure(st) != tree_structure(tuple(st))
    assert tree_structure(st) == tree_structure(doubled)
    assert tree_leaves(st)[0] == 3


def _lm(tmp_path, name, dtype="float32"):
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-3b").reduced(
        n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128),
        microbatch=2, dtype=dtype)
    bundle = get_model(cfg)
    params, opt = init_train_state(bundle, torch.Generator().manual_seed(0),
                                   device="cpu")
    stream = TokenStream(vocab=128, seq_len=16, global_batch=4, seed=2)
    return (make_train_step(bundle, cosine_schedule(3e-3, 2, 12)),
            lambda s: make_batch_iterator(stream, start_step=s,
                                          device="cpu"),
            params, opt, Checkpointer(str(tmp_path / name), keep=3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_saves_restores_and_resumes(tmp_path, dtype):
    """``(params, AdamWState)`` of a reduced LM saved at step 5 restores
    (leaves equal bit for bit, the step an ``int``) and, put into a
    fresh state, continues the uninterrupted run's losses exactly."""
    step_fn, batches, params, opt, ck = _lm(tmp_path, "a", dtype)
    ref = TrainLoop(step_fn, batches, ck, ckpt_every=100).run(
        params, opt, n_steps=10)
    step_fn, batches, params, opt, ck = _lm(tmp_path, "b", dtype)
    first = TrainLoop(step_fn, batches, ck, ckpt_every=5).run(
        params, opt, n_steps=5)
    step_fn, batches, fresh, fresh_opt, _ = _lm(tmp_path, "c", dtype)
    step, (hp, ho) = ck.restore(like=(fresh, fresh_opt))
    assert step == 5 and isinstance(ho, AdamWState) and ho.step == 5
    assert type(ho.step) is int
    for got, want in zip(tree_leaves((hp, ho)),
                         tree_leaves((first["params"], first["opt_state"]))):
        if isinstance(want, torch.Tensor):
            assert torch.equal(torch.as_tensor(got), want.cpu())
    from repro_torch.runtime.fault_tolerance import _restore_into
    p, o = _restore_into((hp, ho), (fresh, fresh_opt))
    rest = TrainLoop(step_fn, batches, ck, ckpt_every=100).run(
        p, o, n_steps=10, start_step=5)
    assert first["history"] + rest["history"] == ref["history"]


def test_lm_crash_restart_is_exact_on_cpu(tmp_path):
    """A reduced LM through ``make_train_step`` (in-place AdamW) failing
    hard at step 7 restores step 4 into its tensors and ends on the
    uninterrupted run's losses exactly."""
    step_fn, batches, params, opt, ck = _lm(tmp_path, "a")
    ref = TrainLoop(step_fn, batches, ck, ckpt_every=4).run(
        params, opt, n_steps=10)
    step_fn, batches, params, opt, ck = _lm(tmp_path, "b")
    fails = {"n": 0}

    def injector(step, attempt):
        if step == 7 and fails["n"] < 3:
            fails["n"] += 1
            raise RuntimeError("injected failure")
    out = TrainLoop(step_fn, batches, ck, ckpt_every=4, max_retries=2).run(
        params, opt, n_steps=10, fail_injector=injector)
    assert fails["n"] == 3
    assert out["history"][-6:] == ref["history"][-6:]
    assert out["opt_state"].step == 10
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(ref["params"])):
        assert torch.equal(a, b)
