"""SigQuant observer pass: calibrate a compiled SignalGraph from traffic.

The port of the JAX package's ``repro.precision.calibration``.
:func:`calibrate` binds a :class:`~repro_torch.signal.graph.
CompiledSignalGraph` to a private observer backend and runs
representative batches through it.  The observer mirrors the hopper
backend's grouping walk exactly (:func:`repro_torch.signal.backends.
group_plan`), so every statistic lands on precisely the step a
:class:`~repro_torch.signal.backends.PrecisionPolicy` can name — and
executes each step on the reference path, so observation never perturbs
outputs.  It is strictly opt-in: the normal compile / serve routes never
construct the observer, so calibration is zero-cost when off; a single
``obs.complete`` span records each pass when SigTrace is enabled.

Per row-uniform (int-routable) step group the record accumulates, over
all calibration batches:

* ``a_max`` / ``w_max`` — activation-row / operand magnitude ranges;
* the **range-proof triple** ``(h_l1, w_l1, acc_norm)`` over row- and
  column-normalized magnitudes ``hn = |h| / rowmax``, ``wn = |w| /
  colmax``: with symmetric per-row/per-column quantization at widths
  ``(aw, ww)`` (``qa = 2^(aw-1)-1``, ``qw = 2^(ww-1)-1``) every
  quantized entry obeys ``|ha| <= qa*hn + 1/2`` and ``|wq| <= qw*wn +
  1/2``, so each int accumulator is bounded *exactly* by

      ``qa*qw*acc_norm + qa*h_l1/2 + qw*w_l1/2 + K/4``

  (``acc_norm = max (hn @ wn)``, ``h_l1 = max_r sum_t hn``, ``w_l1 =
  max_c sum_t wn``).  :meth:`StepStats.fits` demands this bound stay
  within the int32 accumulator **and** the worst-case static proof
  (:func:`repro_torch.core.bitwidth.int_headroom_bits`) that the backend
  re-checks at bind time — the solver never emits a policy the array
  could wrap;
* per-width local fake-quant error (used by the solver's repair rule to
  pick *which* step to widen);
* the declared outputs the step reaches (error attribution).

The statistics are float64 numpy on the host, as in the JAX package: the
observer copies each gathered block off the device (``.detach().cpu()``)
before folding it in.  The record also snapshots held-out batches and
their fp32 reference outputs, so :func:`repro_torch.precision.solver.
solve_widths` can evaluate candidate policies on data calibration never
saw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import bitwidth as bw
from ..core.exec_ir import (EinsumStep, GatherStep, resolve_operand,
                            run_steps_reference)
from ..core.fabric import apply_plan, device_constant
from ..signal.backends import (ExecBackend, PrecisionPolicy, StepRoute,
                               _operand_to_canonical, group_plan)

__all__ = ["LADDER", "StepStats", "CalibrationRecord", "calibrate"]

# The 4/8/16 menu ordered cheapest-first by array throughput
# (macs_per_cycle: 128 / 64 / 32 / 16 / 8 — paper Fig. 7).
LADDER: Tuple[Tuple[int, int], ...] = \
    ((4, 4), (8, 4), (8, 8), (16, 8), (16, 16))

ACC_MAX = 2 ** bw.ACC_BITS - 1


def _host(v) -> np.ndarray:
    """A tensor (on any device) or host array as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class StepStats:
    """Calibration statistics for one int-routable step group."""
    stage: str
    step: str
    k: int                       # contraction size (accumulator terms)
    rows: int
    grouped: bool                # grouped (butterfly) steps: observed
    #                              but never int-routed / solved
    reaches: Tuple[str, ...] = ()
    is_complex: bool = False     # complex data: ranges only, never solved
    batches: int = 0
    a_max: float = 0.0
    w_max: float = 0.0
    h_l1: float = 0.0
    w_l1: float = 0.0
    acc_norm: float = 0.0
    local_err: Dict[Tuple[int, int], float] = \
        dataclasses.field(default_factory=dict)

    def overflow_bound(self, widths: Tuple[int, int]) -> float:
        """Exact data-driven bound on the integer accumulator magnitude
        at ``widths`` (see module docstring for the derivation)."""
        qa = float(2 ** (widths[0] - 1) - 1)
        qw = float(2 ** (widths[1] - 1) - 1)
        return (qa * qw * self.acc_norm + 0.5 * qa * self.h_l1
                + 0.5 * qw * self.w_l1 + 0.25 * self.k)

    def fits(self, widths: Tuple[int, int]) -> bool:
        """True when ``widths`` provably cannot wrap the int32 array
        accumulator on this step: both the worst-case static proof (the
        bind-time guard) and the recorded-range proof must hold."""
        return (bw.int_headroom_bits(widths[0], widths[1], self.k)
                <= bw.ACC_BITS
                and self.overflow_bound(widths) <= ACC_MAX)

    def update_ranges(self, h: np.ndarray, w: np.ndarray) -> None:
        """Magnitude ranges only — all a grouped (butterfly) step gets,
        since the solver never int-routes it."""
        self.batches += 1
        self.a_max = max(self.a_max, float(np.abs(h).max()))
        self.w_max = max(self.w_max, float(np.abs(w).max()))

    def update(self, h: np.ndarray, w: np.ndarray,
               ladder: Sequence[Tuple[int, int]]) -> None:
        """Fold one observed batch into the running statistics.
        ``h``: gathered activation rows flattened to ``(N, k)``;
        ``w``: canonical operand ``(k, cout)``.  Quantization runs on
        the CPU through :func:`repro_torch.core.bitwidth.quantize`, the
        backend's own arithmetic."""
        self.batches += 1
        ah, aw_ = np.abs(h), np.abs(w)
        rowmax = np.maximum(ah.max(axis=-1, keepdims=True), 1e-8)
        colmax = np.maximum(aw_.max(axis=0, keepdims=True), 1e-8)
        hn, wn = ah / rowmax, aw_ / colmax
        self.a_max = max(self.a_max, float(ah.max()))
        self.w_max = max(self.w_max, float(aw_.max()))
        self.h_l1 = max(self.h_l1, float(hn.sum(axis=-1).max()))
        self.w_l1 = max(self.w_l1, float(wn.sum(axis=0).max()))
        self.acc_norm = max(self.acc_norm, float((hn @ wn).max()))
        ref = h.astype(np.float64) @ w.astype(np.float64)
        scale = max(float(np.sqrt((ref ** 2).mean())), 1e-12)
        for pair in ladder:
            if bw.int_headroom_bits(pair[0], pair[1], self.k) \
                    > bw.ACC_BITS:
                continue
            hq, hs = bw.quantize(torch.as_tensor(h), pair[0], axis=-1)
            wq, ws = bw.quantize(torch.as_tensor(w), pair[1], axis=0)
            y = (hq.numpy().astype(np.float64)
                 @ wq.numpy().astype(np.float64)
                 * hs.numpy().astype(np.float64)
                 * ws.numpy().astype(np.float64))
            err = float(np.sqrt(((y - ref) ** 2).mean())) / scale
            self.local_err[pair] = max(self.local_err.get(pair, 0.0), err)


@dataclasses.dataclass
class CalibrationRecord:
    """Everything the width solver needs: per-step range/error stats,
    the calibrated compiled graph, and held-out batches with fp32
    reference baselines (host arrays)."""
    graph: str
    steps: Dict[str, StepStats] = dataclasses.field(default_factory=dict)
    compiled: object = None
    params: object = None
    batches: List[np.ndarray] = dataclasses.field(default_factory=list)
    holdout: List[np.ndarray] = dataclasses.field(default_factory=list)
    baselines: List[object] = dataclasses.field(default_factory=list)
    _reach: Dict[str, frozenset] = \
        dataclasses.field(default_factory=dict, repr=False)

    def _step(self, stage: str, e: EinsumStep, shape) -> StepStats:
        st = self.steps.get(e.name)
        if st is None:
            st = StepStats(stage=stage, step=e.name, k=shape.t,
                           rows=shape.rows_total, grouped=shape.grouped,
                           reaches=tuple(sorted(
                               self._reach.get(stage, ()))))
            self.steps[e.name] = st
        return st

    def gemm_steps(self) -> List[str]:
        """Int-routable (row-uniform, real) step names, program order."""
        return [k for k, s in self.steps.items()
                if not s.grouped and not s.is_complex]

    def assert_no_overflow(self, policy: PrecisionPolicy) -> None:
        """Prove from recorded ranges that ``policy`` cannot wrap the
        int32 accumulator on any step it routes; raises ``ValueError``
        naming every violating step otherwise."""
        bad = []
        for name, st in self.steps.items():
            if st.grouped or st.is_complex:
                continue
            widths = policy.widths_for(st.stage, name)
            if widths is not None and not st.fits(widths):
                bad.append(
                    f"{name!r} at {tuple(widths)}: bound "
                    f"{st.overflow_bound(widths):.3g} vs {ACC_MAX}")
        if bad:
            raise ValueError(
                "policy overflows the int32 array accumulator on "
                + "; ".join(bad))


class _ObserverBackend(ExecBackend):
    """Reference-semantics backend that additionally records, for every
    step group the hopper backend would lower as one kernel call, the
    gathered activation rows and operand statistics the width solver
    needs.  Statistics land as host floats; every step still *runs* on
    the reference path, so observed outputs are bit-identical to the
    reference backend."""

    name = "observe"
    differentiable = False
    bind_cacheable = False      # stats land in THIS instance's record

    def __init__(self, record: CalibrationRecord,
                 ladder: Sequence[Tuple[int, int]] = LADDER):
        self.record = record
        self.ladder = tuple(tuple(p) for p in ladder)

    def lower_stage(self, stage):
        units = []
        routes = []
        steps = stage.steps
        i = 0
        while i < len(steps):
            s = steps[i]
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            if isinstance(s, GatherStep) and isinstance(nxt, EinsumStep):
                g = group_plan(nxt, s)
                if g is not None:
                    units.append(self._observe_unit(
                        stage.name, nxt, g, run=[s, nxt]))
                    i += 2
                    continue
            if isinstance(s, EinsumStep):
                g = group_plan(s, None)
                if g is not None:
                    units.append(self._observe_unit(
                        stage.name, s, g, run=[s]))
                    i += 1
                    continue
            units.append(lambda x, sp, s=s:
                         run_steps_reference([s], x, sp))
            kind = ("gather" if isinstance(s, GatherStep) else
                    "einsum" if isinstance(s, EinsumStep) else "lambda")
            routes.append(StepRoute(stage.name, s.name, kind,
                                    "host" if kind == "lambda" else "jnp"))
            i += 1

        def fn(x, sp):
            for u in units:
                x = u(x, sp)
            return x
        return fn, routes

    def _observe_unit(self, stage_name, e, group, run):
        shape, plan, diag = group
        stats = self.record._step(stage_name, e, shape)

        def unit(x, sp):
            # reconstruct exactly what the int route would contract:
            # composed-plan gather, diag, (rows, k) reshape.
            g = apply_plan(x, plan)
            if diag is not None:
                g = g * device_constant(diag, g.device, g.dtype)
            h = _host(g.reshape(*g.shape[:-1], shape.rows_total, shape.t)
                      ).reshape(-1, shape.t)
            op = _host(resolve_operand(e, sp))
            if np.iscomplexobj(h) or np.iscomplexobj(op):
                stats.is_complex = True
                stats.update_ranges(h, op)
            elif shape.grouped:
                stats.update_ranges(h, op)
            else:
                w = _host(_operand_to_canonical(op, shape, torch.float32,
                                                "cpu"))
                stats.update(h.astype(np.float32), w, self.ladder)
            return run_steps_reference(run, x, sp)
        return unit


def _outputs_to_host(out):
    """A compiled graph's outputs (dict or bare tensor) as numpy."""
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    return _host(out)


def calibrate(compiled, batches: Sequence[np.ndarray], params=None,
              holdout: Optional[Sequence[np.ndarray]] = None,
              ladder: Sequence[Tuple[int, int]] = LADDER
              ) -> CalibrationRecord:
    """Observer pass: run ``batches`` through ``compiled`` and record
    per-step activation/weight ranges, overflow range-proofs, local
    quantization error, and per-output reach.

    ``compiled`` may be bound to any backend — calibration rebinds a
    private observer over the *same* lowered program (plans and
    operands shared, nothing re-lowered), on the compiled graph's
    device.  When ``holdout`` is omitted, the trailing half of
    ``batches`` is held out; fp32 reference outputs for the held-out
    batches are snapshotted (as host arrays) as the solver's error
    baselines.
    """
    batches = [np.asarray(b, np.float32) for b in batches]
    if not batches:
        raise ValueError("calibrate() needs at least one batch")
    if holdout is None:
        if len(batches) > 1:
            n = max(1, len(batches) // 2)
            batches, holdout = batches[:-n], batches[-n:]
        else:
            holdout = batches
    holdout = [np.asarray(b, np.float32) for b in holdout]

    record = CalibrationRecord(graph=compiled.name, compiled=compiled,
                               params=params)
    record._reach = compiled._stage_reach()
    observed = compiled.with_backend(_ObserverBackend(record, ladder))
    t0 = obs.now() if obs.ENABLED else 0
    reference = (compiled if compiled.backend.name == "reference"
                 else compiled.with_backend("reference"))
    with torch.no_grad():
        for b in batches:
            observed(b, params)                # stats land per step
        record.baselines = [_outputs_to_host(reference(b, params))
                            for b in holdout]
    record.batches = batches
    record.holdout = holdout
    if obs.ENABLED:
        obs.complete("SigQuant", "calibrate", t0, graph=compiled.name,
                     batches=len(batches), holdout=len(holdout),
                     steps=len(record.steps))
    return record
