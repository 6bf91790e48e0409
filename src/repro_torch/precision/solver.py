"""SigQuant width solver: greedy narrow-then-repair over the 4/8/16 menu.

The port of the JAX package's ``repro.precision.solver``.  Given a
:class:`~repro_torch.precision.calibration.CalibrationRecord`, pick
per-step ``(a_width, w_width)`` from :data:`LADDER` (cheapest-first by
array throughput) such that

* no step can overflow the int32 array accumulator — a candidate width
  is *admissible* only when :meth:`StepStats.fits` proves it from both
  the worst-case static bound and the recorded-range bound;
* every declared output's relative L2 error against the fp32 reference,
  measured on the **held-out** batches through the real hopper int
  route, stays within ``budget``.

Strategy (narrow-then-repair): start every step at its narrowest
admissible widths, evaluate the candidate policy end to end, and while
any output exceeds the budget, widen one step — the one with the
largest recorded *local* fake-quant error among those reaching the
worst output — then re-evaluate.  Evaluation uses
``compiled.with_backend(HopperBackend(precision=...))`` on the compiled
graph's device: on the card the solver scores exactly the kernels
serving will run, not a proxy.  Steps with no admissible widths
(contraction too large even for ``(4, 4)``) are left off the policy and
stay on the float kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..signal.backends import HopperBackend, PrecisionPolicy
from .calibration import (LADDER, CalibrationRecord, _outputs_to_host,
                          calibrate)

__all__ = ["solve_widths", "auto_policy", "policy_errors", "LADDER"]


def _as_dict(compiled, out) -> Dict[str, np.ndarray]:
    if isinstance(out, dict):
        return out
    return {compiled.outputs[0]: out}


def policy_errors(record: CalibrationRecord,
                  policy: Optional[PrecisionPolicy]) -> Dict[str, float]:
    """Worst per-output relative L2 error of ``policy`` on the record's
    held-out batches, evaluated through the real hopper route (int
    kernels for routed steps, float kernels otherwise)."""
    compiled = record.compiled
    fn = compiled.with_backend(HopperBackend(precision=policy)).jit()
    errs: Dict[str, float] = {}
    with torch.no_grad():
        for batch, base in zip(record.holdout, record.baselines):
            outs = _as_dict(compiled,
                            _outputs_to_host(fn(batch, record.params)))
            for name, ref in _as_dict(compiled, base).items():
                y = outs[name]
                denom = max(float(np.sqrt((np.abs(ref) ** 2).mean())),
                            1e-12)
                err = float(np.sqrt((np.abs(y - ref) ** 2).mean())) / denom
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


def solve_widths(record: CalibrationRecord, budget: float = 1e-2,
                 ladder: Sequence[Tuple[int, int]] = LADDER,
                 max_rounds: int = 64) -> PrecisionPolicy:
    """Solve per-step widths meeting ``budget`` on every output; returns
    a :class:`PrecisionPolicy` naming every admissible GEMM-shaped step.
    Raises ``ValueError`` when the budget is unreachable even with every
    step at its widest admissible widths."""
    t0 = obs.now() if obs.ENABLED else 0
    admissible = {
        name: [tuple(p) for p in ladder if record.steps[name].fits(p)]
        for name in record.gemm_steps()}
    admissible = {n: ps for n, ps in admissible.items() if ps}
    if not admissible:
        return PrecisionPolicy()
    level = {n: 0 for n in admissible}

    def current() -> PrecisionPolicy:
        return PrecisionPolicy(widths={n: admissible[n][level[n]]
                                       for n in admissible})

    for _ in range(max_rounds):
        policy = current()
        errs = policy_errors(record, policy)
        worst = max(errs, key=lambda k: errs[k])
        if errs[worst] <= budget:
            record.assert_no_overflow(policy)
            if obs.ENABLED:
                obs.complete("SigQuant", "solve_widths", t0,
                             graph=record.graph, budget=budget,
                             steps=len(admissible),
                             worst_err=errs[worst])
            return policy
        grow = [n for n in admissible
                if level[n] + 1 < len(admissible[n])
                and worst in record.steps[n].reaches]
        if not grow:       # nothing reaching the worst output can widen
            grow = [n for n in admissible
                    if level[n] + 1 < len(admissible[n])]
        if not grow:
            raise ValueError(
                f"width solver cannot meet the {budget:g} error budget "
                f"for output {worst!r} (error {errs[worst]:.3g}) — every "
                f"int-routable step is already at its widest admissible "
                f"widths; raise the budget or leave steps on the float "
                f"kernels")

        def local(name: str) -> float:
            st = record.steps[name]
            return st.local_err.get(admissible[name][level[name]], 0.0)

        level[max(grow, key=local)] += 1
    raise ValueError(
        f"width solver did not converge in {max_rounds} rounds")


def auto_policy(compiled, batches, params=None, budget: float = 1e-2,
                holdout=None, ladder: Sequence[Tuple[int, int]] = LADDER
                ) -> Tuple[PrecisionPolicy, CalibrationRecord]:
    """Calibrate-then-solve convenience: observe ``batches`` through
    ``compiled`` and return ``(policy, record)`` meeting ``budget``."""
    record = calibrate(compiled, batches, params=params,
                       holdout=holdout, ladder=ladder)
    policy = solve_widths(record, budget=budget, ladder=ladder)
    return policy, record
