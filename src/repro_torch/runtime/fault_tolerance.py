"""Fault-tolerant runtime — the port's counterpart of the JAX package's
``runtime/fault_tolerance.py``: the training loop and, for serving, the
supervised stream (:class:`StreamSupervisor`, :class:`DeviceLoss`).

Training contract, as in the JAX package:

- checkpoint every ``ckpt_every`` steps (the leaves are copied to the
  host at once, then written on a background thread), and on preemption
  (SIGTERM sets a flag; the loop checkpoints at the end of the step and
  stops); after a crash-restart the loop resumes from the last committed
  step and, because the data pipeline is a pure function of the step,
  reproduces the loss trajectory it would have had;
- a failing step is retried up to ``max_retries`` times; past that the
  last committed checkpoint is restored and the steps since it are
  replayed (node replacement);
- straggler mitigation: :class:`StepMonitor` keeps an EWMA of step time;
  a step slower than ``straggler_factor`` x the EWMA fires
  ``on_straggler(step, dt)`` and is recorded.

Where the JAX package calls ``jax.block_until_ready`` on the loss, the
port reads the loss to the host, which waits for the step.
:class:`StreamSupervisor` transplants the retry / restore contract onto
a checkpointable stream service (see its docstring).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..tree import tree_map

__all__ = ["StepMonitor", "TrainLoop", "StreamSupervisor", "DeviceLoss"]


@dataclasses.dataclass
class StepMonitor:
    alpha: float = 0.1
    straggler_factor: float = 2.5
    ewma: Optional[float] = None
    stragglers: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record step ``step``'s time ``dt``; True when it is a
        straggler, which is kept out of the EWMA."""
        is_straggler = (self.ewma is not None
                        and dt > self.straggler_factor * self.ewma)
        if is_straggler:
            self.stragglers.append(step)
        else:
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@torch.no_grad()
def _restore_into(tree, like):
    """A restored tree's host leaves put back where the template's are:
    a tensor leaf's values are written into the template tensor (its
    device and dtype, no second copy of the state), an int leaf comes
    back as an int."""
    def put(a, t):
        if isinstance(t, torch.Tensor):
            src = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a))
            return t.copy_(src)
        if isinstance(t, int) and not isinstance(t, bool):
            return int(a)
        return a
    return tree_map(put, tree, like)


class TrainLoop:
    def __init__(self, step_fn: Callable, batch_iter_fn: Callable,
                 ckpt: Checkpointer, ckpt_every: int = 50,
                 max_retries: int = 2,
                 on_straggler: Optional[Callable] = None,
                 monitor: Optional[StepMonitor] = None):
        """``step_fn(params, opt, batch) -> (params, opt, metrics)``;
        ``batch_iter_fn(start_step) -> iterator of (step, batch)``.

        A retry runs the step again on the state the failure left.  The
        port's train step (:func:`repro_torch.launch.train.make_train_step`)
        updates params and moments in place, so a failure inside its
        AdamW update leaves some leaves updated and the retry starts from
        them — the JAX package's donated buffers are lost the same way.
        A failure before the update (the tests' ``fail_injector`` raises
        before the step starts) leaves the state whole.  Retry
        exhaustion restores the last committed checkpoint, which is
        always whole, into the state's tensors."""
        self.step_fn = step_fn
        self.batch_iter_fn = batch_iter_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.monitor = monitor or StepMonitor()
        self.on_straggler = on_straggler
        self._preempted = False

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread

    def run(self, params, opt_state, n_steps: int,
            start_step: int = 0,
            fail_injector: Optional[Callable] = None) -> Dict[str, Any]:
        """Returns the final state and the history of losses.
        ``fail_injector(step, attempt)`` raising simulates a device
        failure (tests)."""
        self._install_preemption_handler()
        history: List[float] = []
        step = start_step
        it = self.batch_iter_fn(start_step)
        while step < n_steps:
            data_step, batch = next(it)
            assert data_step == step, "data pipeline out of sync"
            t0 = time.monotonic()
            attempt = 0
            while True:
                try:
                    if fail_injector is not None:
                        fail_injector(step, attempt)
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    loss = float(metrics["loss"])    # waits for the step
                    break
                except Exception:
                    attempt += 1
                    if attempt > self.max_retries:
                        # node replacement: reload the last good state and
                        # replay from there (data is step-addressed, so the
                        # trajectory is reproduced)
                        self.ckpt.wait()
                        s, host = self.ckpt.restore(like=(params, opt_state))
                        params, opt_state = _restore_into(
                            host, (params, opt_state))
                        step = s
                        it = self.batch_iter_fn(step)
                        data_step, batch = next(it)
                        attempt = 0
            dt = time.monotonic() - t0
            if self.monitor.observe(step, dt) and self.on_straggler:
                self.on_straggler(step, dt)
            history.append(loss)
            step += 1
            if step % self.ckpt_every == 0 or self._preempted:
                self.ckpt.save(step, (params, opt_state))
            if self._preempted:
                self.ckpt.wait()
                break
        self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": history, "stop_step": step,
                "stragglers": list(self.monitor.stragglers),
                "preempted": self._preempted}


# --------------------------------------------------------------------------
# Serving-side fault tolerance: checkpointable stream supervision
# --------------------------------------------------------------------------

class DeviceLoss(Exception):
    """Simulated loss of one mesh shard.  Raising this from a fail
    injector makes :class:`StreamSupervisor` drop the shard from the
    service's router, restore the last durable checkpoint onto the
    surviving shards and replay — the serving analogue of
    :class:`TrainLoop`'s node replacement."""

    def __init__(self, device: int, msg: str = ""):
        super().__init__(msg or f"device {device} lost")
        self.device = device


class StreamSupervisor:
    """:class:`TrainLoop`'s retry/restore contract transplanted onto a
    checkpointable stream service (duck-typed: anything with
    ``checkpoint() / restore(ckpt) / stream_step() / session_by_sid(sid)
    / stream_pending()`` and optionally ``drop_device(index,
    carry_state)`` — i.e.
    :class:`repro_torch.serving.signal_service.SignalService`).

    Contract, as in the JAX package:

    - every ``ckpt_every`` successful ticks the service state becomes the
      durable checkpoint and the input journal is truncated;
    - a tick failure rolls the service back to its pre-tick snapshot and
      retries, up to ``max_retries`` times;
    - retry exhaustion (node replacement) restores the durable checkpoint
      and replays the journal: feeds are recorded per session, and so is
      the end of every tick that ran since the checkpoint, so the replay
      feeds and steps exactly as the ticks did — the same blocks go
      through the same core calls, and the resumed streams reproduce the
      output they would have produced without the failure, bit for bit
      (exactly-once delivery drops what the client already read).  The
      JAX package replays the feeds alone and lets the next ticks catch
      up in larger blocks, whose core calls may round otherwise;
    - :class:`DeviceLoss` skips retries: ``drop_device`` first marks the
      shard dead and re-homes its sessions without reading their state,
      then the durable restore loads that state from the host checkpoint
      onto the sessions' new shards and the replay runs there — nothing
      touches the lost device after the loss.  The JAX package restores
      and replays first and drops the shard last, so its replay runs on
      the lost shard;
    - tick wall-times feed a :class:`StepMonitor`; stragglers fire
      ``on_straggler(tick, dt)``.

    Inputs must go through :meth:`feed` (not ``session.feed``) so the
    journal sees them; the journal keeps host copies.
    """

    def __init__(self, service, ckpt_every: int = 4, max_retries: int = 2,
                 on_straggler: Optional[Callable] = None,
                 monitor: Optional[StepMonitor] = None):
        self.service = service
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.monitor = monitor or StepMonitor()
        self.on_straggler = on_straggler
        self.ticks = 0
        self.stats = {"retries": 0, "checkpoint_restores": 0,
                      "device_losses": 0}
        # (sid, chunk) feeds and (None, None) tick ends since the last
        # durable checkpoint
        self._journal: List[tuple] = []
        self._durable = service.checkpoint()

    # -- input path ----------------------------------------------------------
    def feed(self, session, chunk) -> None:
        """Journal ``chunk`` for replay-after-restore, then feed it."""
        host = chunk.detach().cpu().numpy() \
            if isinstance(chunk, torch.Tensor) else np.array(chunk)
        self._journal.append((session.sid, host))
        session.feed(chunk)

    def checkpoint_now(self) -> None:
        self._durable = self.service.checkpoint()
        self._journal.clear()

    def _restore_durable(self) -> None:
        self.service.restore(self._durable)
        self.stats["checkpoint_restores"] += 1
        for sid, chunk in self._journal:
            if sid is None:
                self.service.stream_step()
                continue
            sess = self.service.session_by_sid(sid)
            if sess is not None and not sess.closed:
                sess.feed(chunk)

    # -- the supervised step -------------------------------------------------
    def tick(self, fail_injector: Optional[Callable] = None) -> None:
        """One supervised ``service.stream_step()``.
        ``fail_injector(tick, attempt)`` raising simulates a step failure
        (tests); raising :class:`DeviceLoss` simulates losing a shard."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            snap = self.service.checkpoint()
            try:
                if fail_injector is not None:
                    fail_injector(self.ticks, attempt)
                self.service.stream_step()
                self._journal.append((None, None))
                break
            except DeviceLoss as e:
                self.stats["device_losses"] += 1
                self.service.drop_device(e.device, carry_state=False)
                self._restore_durable()
                attempt = 0
            except Exception:
                attempt += 1
                self.stats["retries"] += 1
                if attempt > self.max_retries:
                    self._restore_durable()
                    attempt = 0
                else:
                    self.service.restore(snap)
        dt = time.monotonic() - t0
        if self.monitor.observe(self.ticks, dt) and self.on_straggler:
            self.on_straggler(self.ticks, dt)
        self.ticks += 1
        if self.ticks % self.ckpt_every == 0:
            self.checkpoint_now()

    def run_until_drained(self, fail_injector: Optional[Callable] = None,
                          max_ticks: int = 10_000) -> None:
        """Tick until the service reports no pending stream work."""
        while self.service.stream_pending() and self.ticks < max_ticks:
            self.tick(fail_injector)
