"""Fault-tolerant training runtime — the port's counterpart of the JAX
package's ``runtime/fault_tolerance.py`` (its training half).

Contract, as in the JAX package:

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
port reads the loss to the host, which waits for the step.  The
device-loss half (``DeviceLoss``, ``StreamSupervisor``) waits for signal
scale-out (ROADMAP Queue 1 item 5).
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

__all__ = ["StepMonitor", "TrainLoop"]


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
