"""Pluggable execution backends for compiled SignalGraphs.

A :class:`~repro_torch.core.exec_ir.ExecProgram` says *what* to execute — the
fused gather/einsum/lambda step sequence with plans, operands, masks and
param slots as data.  An :class:`ExecBackend` says *how*: it binds a
program to per-stage step executors once at compile time, and the shared
walker (:func:`repro_torch.core.exec_ir.execute_program`) threads the stage
environment, multi-input combines and valid-frame masks identically for
every backend.

Two backends ship:

  * ``reference`` — interprets the step list with plain torch ops
    (:func:`repro_torch.core.exec_ir.run_steps_reference`): the JAX
    package's step semantics verbatim, the parity oracle.
  * ``hopper`` — lowers each ``gather ∘ einsum (∘ post-shuffle)`` group
    onto the fused fabric+array CUDA kernels written for the H100, the
    software analogue of the paper's fabric feeding the computing array
    (the counterpart of the JAX package's ``pallas`` backend):

      - row-uniform einsums (FIR taps, DCT, mel, DWT banks) run through
        :func:`repro_torch.kernels.shuffle_gemm` — the standalone gather
        ahead of the einsum AND the v2-folded ``pre``/``pre_diag`` stream
        shuffle are absorbed into the kernel's gather;
      - grouped einsums (the FFT butterfly: per-twiddle-class matmuls)
        run through :func:`repro_torch.kernels.shuffle_gemm_grouped`,
        and a run of two or more consecutive ones (a stage's
        butterflies) through :func:`repro_torch.kernels.shuffle_gemm.
        run_chain`: one launch a segment of the run
        (``kernels/shuffle_gemm/chain.py``);
      - steps named by a :class:`PrecisionPolicy` are *int-routed*: the
        gathered rows and the operand are symmetrically quantized
        (:mod:`repro_torch.core.bitwidth`), contracted exactly on the
        variable-bitwidth array and dequantized, in one launch of
        :func:`repro_torch.kernels.bitserial_quant_matmul` —
        the paper's 4/8/16-bit menu per array pass;
      - everything else (host lambdas, gathers feeding no array pass)
        is *emulated* on the reference path.

    For tensors on the CPU the kernel wrappers run their plain PyTorch
    versions; for tensors on the card they launch the kernels.  Both
    backends differentiate: the shuffle-GEMM ops' backward passes launch
    the same kernels on adjoint operands (``kernels/shuffle_gemm/
    vjp.py``), and an int-routed step takes the straight-through
    gradient (:meth:`HopperBackend._int_unit`).

:meth:`ExecBackend.bind` returns a :class:`BoundProgram` whose
``report()`` attributes every lowered step to its route — how many
fabric passes were actually fused into an array kernel vs emulated as an
plain gather — surfaced per backend by
:func:`repro_torch.core.perf_model.signal_graph_report`.

Backend-specific lowering artifacts are cached in the signal package's
keyed plan cache under the backend's name
(:func:`repro_torch.signal.plan_cache_get`), so repeated compiles of the
same pipeline — offline and serving buckets — reuse one lowering, and
:func:`repro_torch.signal.plan_cache_info` exposes per-backend hit/miss
counts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import bitwidth as bw
from ..core.exec_ir import (EinsumStep, ExecProgram, GatherStep,
                            execute_program, resolve_operand, row_operand,
                            run_steps_reference)
from ..core.fabric import (ShufflePlan, apply_plan, compose_into_einsum,
                           device_constant, identity_plan)

__all__ = ["ExecBackend", "ReferenceBackend", "HopperBackend",
           "PrecisionPolicy", "BoundProgram", "StepRoute",
           "register_backend", "get_backend", "available_backends",
           "group_plan", "iter_step_groups", "classify_einsum",
           "bind_cached", "program_cache_key"]


# --------------------------------------------------------------------------
# Route accounting
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepRoute:
    """Where one lowered step executes under a backend.  ``route`` is one
    of ``fused_gemm`` / ``fused_grouped`` / ``int_bitserial`` (array
    kernels), ``jnp`` (emulated on the plain torch path; the route name
    is kept from the JAX package so route reports compare field by
    field), ``host`` (lambda glue); ``absorbed_gathers`` counts
    standalone fabric passes folded into the kernel's gather."""
    stage: str
    step: str
    kind: str                   # 'gather' | 'einsum' | 'lambda'
    route: str
    absorbed_gathers: int = 0


def _routes_report(name: str, routes: Sequence[StepRoute]) -> dict:
    fabric_fused = sum(r.absorbed_gathers for r in routes)
    fabric_emulated = sum(1 for r in routes
                          if r.kind == "gather" and r.route == "jnp")
    array = [r for r in routes if r.kind == "einsum"]
    by_route: Dict[str, int] = {}
    for r in routes:
        by_route[r.route] = by_route.get(r.route, 0) + 1
    return {
        "name": name,
        "fabric_passes": {"fused": fabric_fused,
                          "emulated": fabric_emulated},
        "array_passes": {
            "fused": sum(1 for r in array
                         if r.route in ("fused_gemm", "fused_grouped")),
            "int_routed": sum(1 for r in array
                              if r.route == "int_bitserial"),
            "emulated": sum(1 for r in array if r.route == "jnp"),
        },
        "host_steps": sum(1 for r in routes if r.kind == "lambda"),
        "routes": by_route,
    }


@dataclasses.dataclass
class BoundProgram:
    """A program bound to one backend: callable ``(x, params,
    valid_frames) -> outputs`` plus the per-step route attribution."""
    backend: "ExecBackend"
    program: ExecProgram
    stage_fns: Dict[str, Callable]
    routes: List[StepRoute]

    def __call__(self, x, params=None, valid_frames=None,
                 row_params: bool = False):
        return execute_program(self.program, self.stage_fns, x, params,
                               valid_frames, row_params)

    def report(self) -> dict:
        return _routes_report(self.backend.name, self.routes)

    def chain_report(self) -> List[dict]:
        """Every chain of grouped steps the backend bound, by stage: its
        sub-steps and, per segment, the kernel that runs it and its
        tiling (tiles a batch row, floats a tile, tiles a block)."""
        return [{"stage": name, **chain.report()}
                for name, fn in self.stage_fns.items()
                for chain in getattr(fn, "chains", ())]


# --------------------------------------------------------------------------
# Precision policy (int routing through the variable-bitwidth array)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-step operand/activation bitwidths for the array backend.

    ``widths`` maps a stage name (or a fully-qualified step name such as
    ``"mel.mel"``) to ``(a_width, w_width)``; ``default`` optionally
    applies to every *row-uniform* einsum not named explicitly.  A
    matched step is int-routed: activations quantize per contraction row,
    the operand per output channel (symmetric,
    :func:`repro_torch.core.bitwidth.quantize`), the integer contraction runs
    exactly on the ``bitserial_mm`` kernel, and the result is
    dequantized with the product of scales — output error is pure
    quantization error, bounded by the chosen widths.  Routings whose
    accumulation could wrap the int32 array accumulator
    (``aw + ww - 2 + ceil(log2 K) > 31``) are rejected at bind time
    rather than silently wrapping.  Grouped (butterfly) einsums are
    never int-routed: their twiddle dynamic range is what the paper
    keeps in 16-bit."""
    widths: Mapping[str, Tuple[int, int]] = \
        dataclasses.field(default_factory=dict)
    default: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        # Collect every invalid entry before raising: a calibration- or
        # hand-built table with several bad rows reports them all in one
        # error instead of one per edit-rerun cycle.
        problems = []
        bad = [(key, (aw, ww)) for key, (aw, ww) in dict(self.widths).items()
               if aw not in bw.VALID_WIDTHS or ww not in bw.VALID_WIDTHS]
        if bad:
            listing = "; ".join(f"{key!r}: {w}" for key, w in bad)
            problems.append(
                f"PrecisionPolicy widths for {listing} must be from "
                f"{bw.VALID_WIDTHS}")
        if self.default is not None and (
                self.default[0] not in bw.VALID_WIDTHS
                or self.default[1] not in bw.VALID_WIDTHS):
            problems.append(f"invalid default widths {self.default}")
        if problems:
            raise ValueError("; ".join(problems))

    def widths_for(self, stage: str,
                   step: str) -> Optional[Tuple[int, int]]:
        """Most-specific match: step name, then stage name, then the
        default."""
        w = dict(self.widths)
        if step in w:
            return tuple(w[step])
        if stage in w:
            return tuple(w[stage])
        return None if self.default is None else tuple(self.default)

    def cache_token(self) -> Tuple:
        """Hashable identity for lowering-cache keys."""
        return (tuple(sorted((k, tuple(v))
                             for k, v in dict(self.widths).items())),
                None if self.default is None else tuple(self.default))


# --------------------------------------------------------------------------
# Einsum classification (which kernel shape a step maps onto)
# --------------------------------------------------------------------------

def _spec_axes(spec: str) -> Tuple[str, str, str]:
    lhs, out = spec.split("->")
    ins, op = lhs.split(",")
    return ins.replace("...", ""), op.replace("...", ""), \
        out.replace("...", "")


def _prod(xs) -> int:
    return int(math.prod(xs)) if xs else 1


@dataclasses.dataclass(frozen=True)
class _EinsumShape:
    """Canonical GEMM view of an EinsumStep: gathered rows reshape to
    ``(rows_total, t)`` and contract against a ``(t, cout)`` operand —
    shared across all rows (``groups == 1``) or per-group
    (``(groups, t, cout)``, rows in ``(reps, groups, nb)`` layout)."""
    rows_total: int
    t: int
    grouped: bool                # True => per-group operand (butterfly)
    groups: int
    reps: int
    nb: int
    op_perm: Tuple[int, ...]     # operand transpose to canonical order
    op_shape: Tuple[int, ...]    # canonical operand shape after reshape


def classify_einsum(step: EinsumStep) -> Optional[_EinsumShape]:
    """Map a step onto a kernel shape, or None when the spec falls
    outside the supported family (the backend then emulates it).

    Supported: the input reshapes to row axes followed by trailing
    contracted axes; the output keeps the row axes leading (input
    order) followed by the operand's output-only axes; the operand
    indexes the contracted and output-only axes plus at most ONE row
    axis (the *group* axis — the FFT butterfly's twiddle class)."""
    ins, op, out = _spec_axes(step.spec)
    if len(ins) != len(step.reshape_in) or len(set(ins)) != len(ins) \
            or len(set(op)) != len(op) or len(set(out)) != len(out):
        return None
    dims = dict(zip(ins, step.reshape_in))
    contracted = [c for c in ins if c not in out]
    if not contracted or list(ins[-len(contracted):]) != contracted:
        return None
    if step.out_rank != len(out):
        # the reference semantics flatten only the last out_rank axes of
        # the einsum result; the kernels flatten the whole suffix — only
        # equivalent when out_rank covers every output axis.
        return None
    rows_axes = [c for c in ins if c in out]
    out_only = [c for c in op if c not in ins]
    group_axes = [c for c in op if c in ins and c in out]
    if list(out) != rows_axes + out_only:
        return None
    if any(c not in op for c in contracted):
        return None          # contraction without an operand axis
    t = _prod([dims[c] for c in contracted])
    rows_total = _prod([dims[c] for c in rows_axes])
    if not group_axes:
        desired = contracted + out_only
        perm = tuple(op.index(c) for c in desired)
        return _EinsumShape(rows_total, t, False, 1, rows_total, 1,
                            perm, (t, -1))
    if len(group_axes) != 1:
        return None
    gax = group_axes[0]
    gi = ins.index(gax)
    reps = _prod([dims[c] for c in ins[:gi]])
    nb = _prod([dims[c] for c in ins[gi + 1:len(ins) - len(contracted)]])
    desired = [gax] + contracted + out_only
    perm = tuple(op.index(c) for c in desired)
    return _EinsumShape(rows_total, t, True, dims[gax], reps, nb, perm,
                        (dims[gax], t, -1))


def _operand_to_canonical(op_arr, shape: _EinsumShape, dtype, device):
    """Transpose/reshape an einsum operand into the kernel's canonical
    ``(t, cout)`` / ``(groups, t, cout)`` layout on ``device``."""
    if isinstance(op_arr, torch.Tensor):
        w = op_arr.to(device=device, dtype=dtype)
        return w.permute(shape.op_perm).reshape(shape.op_shape)
    w = np.transpose(np.asarray(op_arr), shape.op_perm)
    return torch.as_tensor(np.ascontiguousarray(w.reshape(shape.op_shape)),
                           device=device).to(dtype)


class _CanonicalOperand:
    """Per-unit cache of the canonical operand: a host array (the static
    operand, or a params entry passed again) is transposed and uploaded
    once per (device, dtype); a tensor operand is re-laid out on every
    call, since tensors may change in place between calls.
    :meth:`rows` lays out a row-stacked operand, one a batch row;
    :meth:`of` resolves a step's operand for one call, either way."""

    def __init__(self, shape: _EinsumShape):
        self.shape = shape
        self._cache: Dict[Tuple, Tuple] = {}

    def rows(self, op, like: torch.Tensor) -> torch.Tensor:
        """``op`` (B, *operand shape) -> the kernel's (B, t, n_out): each
        row converted as :meth:`__call__` converts one operand."""
        w = torch.as_tensor(op).to(device=like.device, dtype=like.dtype)
        perm = (0, *(p + 1 for p in self.shape.op_perm))
        return w.permute(perm).reshape(w.shape[0], *self.shape.op_shape)

    def of(self, e: EinsumStep, sp, like: torch.Tensor
           ) -> Tuple[torch.Tensor, bool]:
        """``(canonical operand, per_row)`` of step ``e`` under the
        stage's params entry ``sp``: the row-stacked one in the kernel's
        ``(B, ...)`` layout where ``sp`` holds it (``per_row`` True), else
        the params entry or the static operand."""
        op = row_operand(e, sp)
        if op is not None:
            return self.rows(op, like), True
        return self(resolve_operand(e, sp), like), False

    def __call__(self, op, like: torch.Tensor) -> torch.Tensor:
        if isinstance(op, torch.Tensor):
            return _operand_to_canonical(op, self.shape, like.dtype,
                                         like.device)
        key = (id(op), str(like.device), like.dtype)
        hit = self._cache.get(key)
        if hit is None or hit[0] is not op:
            hit = (op, _operand_to_canonical(op, self.shape, like.dtype,
                                             like.device))
            self._cache[key] = hit
        return hit[1]


def group_plan(e: EinsumStep, gather: Optional[GatherStep]
               ) -> Optional[Tuple[_EinsumShape, ShufflePlan, object]]:
    """Classify a ``(gather?) ∘ einsum`` pair as one fused kernel group.

    Returns ``(shape, plan, diag)`` — the canonical GEMM shape and the
    single composed fabric plan the kernel gathers — or ``None``
    when the spec is outside the kernel family or the plan's output
    length disagrees with the einsum's flat input.  This is the single
    source of truth for *which* step groups lower onto the array: the
    hopper backend's :meth:`HopperBackend._lower_group` routes through
    it, as the SigQuant calibration observer does."""
    shape = classify_einsum(e)
    if shape is None:
        return None
    n_in_flat = _prod(e.reshape_in)
    # compose the standalone gather and the v2-folded stream-in shuffle
    # into ONE plan the kernel gathers.
    if gather is not None:
        plan, diag = compose_into_einsum(gather.plan, gather.diag,
                                         e.pre, e.pre_diag)
    elif e.pre is not None:
        plan, diag = e.pre, e.pre_diag
    else:
        plan, diag = identity_plan(n_in_flat), e.pre_diag
    if plan.n_out != n_in_flat:
        return None
    return shape, plan, diag


def iter_step_groups(program: ExecProgram):
    """Yield ``(stage_name, gather, einsum, shape, plan, diag)`` for
    every step group the hopper backend would lower as one kernel
    call, walking stages with exactly the pairing rule of
    :meth:`HopperBackend.lower_stage`: an adjacent gather∘einsum pair
    groups when :func:`group_plan` accepts it, otherwise the einsum is
    tried alone.  The calibration observer iterates this to attach
    range statistics to precisely the steps a :class:`PrecisionPolicy`
    can name."""
    for st in program.stages:
        steps = st.steps
        i = 0
        while i < len(steps):
            s = steps[i]
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            if isinstance(s, GatherStep) and isinstance(nxt, EinsumStep):
                g = group_plan(nxt, s)
                if g is not None:
                    yield (st.name, s, nxt, *g)
                    i += 2
                    continue
            if isinstance(s, EinsumStep):
                g = group_plan(s, None)
                if g is not None:
                    yield (st.name, None, s, *g)
            i += 1


# --------------------------------------------------------------------------
# Backends
# --------------------------------------------------------------------------

class ExecBackend:
    """Base class: subclasses implement :meth:`lower_stage`.  ``bind``
    lowers every stage once (compile time) and returns the bound
    program; ``cache_key`` keys compile caches (streaming cores, serving
    buckets) so two backends never share a compiled program slot."""

    name = "base"
    differentiable = False
    # bindings are shared through the fingerprint-keyed compile cache
    # (bind_cached) unless a backend opts out — backends carrying
    # per-instance mutable state (the calibration observer writes into
    # its own CalibrationRecord) must bind privately or a second
    # instance would execute through the first's closures.
    bind_cacheable = True

    @property
    def cache_key(self) -> Tuple:
        return (self.name,)

    def lower_stage(self, stage) -> Tuple[Callable, List[StepRoute]]:
        raise NotImplementedError

    def bind(self, program: ExecProgram) -> BoundProgram:
        stage_fns: Dict[str, Callable] = {}
        routes: List[StepRoute] = []
        for st in program.stages:
            fn, rs = self.lower_stage(st)
            stage_fns[st.name] = fn
            routes.extend(rs)
        return BoundProgram(self, program, stage_fns, routes)


def program_cache_key(backend: ExecBackend,
                      program: ExecProgram) -> Optional[Tuple]:
    """The fingerprint-keyed compile-cache key for one (backend,
    program) pair, or ``None`` when the program has no fingerprint
    (opaque lambda closure — never shared).  Combines the program's
    structural digest with the backend's ``cache_key`` (name,
    precision-policy token), so two structurally
    identical programs share a slot only under the same lowering
    configuration."""
    fp = program.fingerprint()
    if fp is None:
        return None
    return (backend.cache_key, fp)


def bind_cached(backend: ExecBackend,
                program: ExecProgram) -> BoundProgram:
    """Bind through the fingerprint-keyed compile cache.

    Two compiles whose programs carry the same structural fingerprint
    under the same backend configuration share ONE :class:`BoundProgram`
    — one stage-lowering pass, one set of kernel closures — instead of
    re-lowering per registered graph name.  The shared bound program is
    a pure function of the fingerprint (lambda content included), so
    executing graph B through graph A's binding is exact.  Programs
    without a fingerprint bind privately, as before.  Hits/misses count
    in the plan-cache stats under the backend's name
    (:func:`repro_torch.signal.plan_cache_info`)."""
    if not backend.bind_cacheable:
        return backend.bind(program)
    key = program_cache_key(backend, program)
    if key is None:
        return backend.bind(program)
    from . import plan_cache_get
    return plan_cache_get("bound_program", key,
                          lambda: backend.bind(program),
                          backend=backend.name)


class ReferenceBackend(ExecBackend):
    """The plain torch interpreter: every gather is an ``index_select``
    plus a PAD ``where``, every array pass a ``torch.einsum``.  This is
    the parity oracle; autograd differentiates it as plain torch, which
    makes it the reference for the ``hopper`` backend's gradients."""

    name = "reference"
    differentiable = True

    def lower_stage(self, stage):
        steps = stage.steps
        routes = []
        for s in steps:
            kind = ("gather" if isinstance(s, GatherStep) else
                    "einsum" if isinstance(s, EinsumStep) else "lambda")
            routes.append(StepRoute(stage.name, s.name, kind,
                                    "host" if kind == "lambda" else "jnp"))

        def run(x, sp):
            return run_steps_reference(steps, x, sp)
        return run, routes


class HopperBackend(ExecBackend):
    """Lower gather∘einsum(∘post) groups onto the fused shuffle-GEMM CUDA
    kernels — the counterpart of the JAX package's ``PallasBackend``.

    Routes are named as there (``fused_gemm`` / ``fused_grouped`` /
    ``int_bitserial``), so ``lowering_report()`` compares field by
    field.  Bound units are device-agnostic: the kernel wrappers launch
    for tensors on the card and run their plain PyTorch versions for
    tensors on the CPU, and plan blocks / canonical operands are cached
    per device.  ``precision`` optionally int-routes named steps through
    :func:`repro_torch.kernels.bitserial_quant_matmul` (see
    :class:`PrecisionPolicy` and :meth:`_int_unit`)."""

    name = "hopper"
    differentiable = True

    def __init__(self, precision: Optional[PrecisionPolicy] = None):
        self.precision = precision or PrecisionPolicy()

    @property
    def cache_key(self) -> Tuple:
        return (self.name, self.precision.cache_token())

    # -- lowering -----------------------------------------------------------
    def lower_stage(self, stage):
        """One unit a group (:meth:`_lower_group`), then each maximal run
        of two or more consecutive ``fused_grouped`` units whose members
        but the last carry no ``post`` becomes one chain unit
        (:meth:`_chain_unit`): the run's butterflies in one launch a
        segment.  Routes stay one a step, as the JAX package's."""
        units: List[Tuple[Callable, Optional[tuple]]] = []
        routes: List[StepRoute] = []
        steps = stage.steps
        i = 0
        while i < len(steps):
            s = steps[i]
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            if isinstance(s, GatherStep) and isinstance(nxt, EinsumStep):
                unit = self._lower_group(stage.name, nxt, gather=s)
                if unit is not None:
                    fn, route, grouped = unit
                    units.append((fn, grouped))
                    if route.route == "int_bitserial":
                        # the int route gathers via apply_plan (the
                        # bitserial kernel has no fused gather, as in the
                        # JAX package): the absorbed pass is emulated.
                        routes.append(StepRoute(stage.name, s.name,
                                                "gather", "jnp"))
                        routes.append(route)
                    else:
                        routes.append(dataclasses.replace(
                            route, absorbed_gathers=1))
                    i += 2
                    continue
            if isinstance(s, EinsumStep):
                unit = self._lower_group(stage.name, s, gather=None)
                if unit is not None:
                    fn, route, grouped = unit
                    units.append((fn, grouped))
                    routes.append(route)
                    i += 1
                    continue
            kind = ("gather" if isinstance(s, GatherStep) else
                    "einsum" if isinstance(s, EinsumStep) else "lambda")
            routes.append(StepRoute(stage.name, s.name, kind,
                                    "host" if kind == "lambda" else "jnp"))
            units.append((_reference_unit(s), None))
            i += 1

        fns, chains, run_ = [], [], []

        def flush():
            if len(run_) == 1:
                fns.append(run_[0][0])
            elif run_:
                fn, chain = self._chain_unit([g for _, g in run_])
                fns.append(fn)
                chains.append(chain)
            run_.clear()

        for fn, grouped in units:
            if grouped is None:
                flush()
                fns.append(fn)
                continue
            if run_ and run_[-1][1][0].post is not None:
                flush()
            run_.append((fn, grouped))
        flush()

        def run(x, sp):
            for u in fns:
                x = u(x, sp)
            return x
        run.chains = chains
        return run, routes

    def _lower_group(self, stage_name: str, e: EinsumStep,
                     gather: Optional[GatherStep]):
        """One fused kernel call for (gather?) ∘ einsum ∘ (post?) as
        ``(unit, route, grouped)`` — ``grouped`` the ``(e, shape, plan,
        diag)`` of a ``fused_grouped`` group, which a run may chain, else
        None — or None when the einsum spec is outside the kernel family
        (the caller then runs the reference path step by step)."""
        g = group_plan(e, gather)
        if g is None:
            return None
        shape, plan, diag = g
        widths = self.precision.widths_for(stage_name, e.name)
        if widths is not None and not shape.grouped:
            _check_int_headroom(e.name, widths, shape.t)

        def build():
            if widths is not None and not shape.grouped:
                return self._int_unit(e, shape, plan, diag,
                                      widths), "int_bitserial"
            if not shape.grouped:
                return self._gemm_unit(e, shape, plan, diag), "fused_gemm"
            return self._grouped_unit(e, shape, plan, diag), "fused_grouped"

        key = _group_digest(e, plan, diag, widths)
        from . import plan_cache_get
        fn, route_name = plan_cache_get("exec_group", key, build,
                                        backend=self.name)
        grouped = (e, shape, plan, diag) if route_name == "fused_grouped" \
            else None
        return fn, StepRoute(stage_name, e.name, "einsum", route_name), \
            grouped

    # -- unit builders ------------------------------------------------------
    def _gemm_unit(self, e: EinsumStep, shape: _EinsumShape,
                   plan: ShufflePlan, diag):
        from ..kernels import shuffle_gemm
        post = e.post
        canonical = _CanonicalOperand(shape)

        def unit(x, sp):
            w, _ = canonical.of(e, sp, x)
            y = shuffle_gemm(x, plan, w, rows=shape.rows_total, diag=diag)
            y = y.reshape(*y.shape[:-2], -1)
            return apply_plan(y, post) if post is not None else y
        return unit

    def _grouped_unit(self, e: EinsumStep, shape: _EinsumShape,
                      plan: ShufflePlan, diag):
        from ..kernels import shuffle_gemm_grouped
        post = e.post
        canonical = _CanonicalOperand(shape)

        def unit(x, sp):
            w, _ = canonical.of(e, sp, x)
            y = shuffle_gemm_grouped(x, plan, w, reps=shape.reps,
                                     groups=shape.groups, nb=shape.nb,
                                     diag=diag)
            return apply_plan(y, post) if post is not None else y
        return unit

    def _chain_unit(self, groups: Sequence[tuple]):
        """A run of consecutive grouped groups ``(e, shape, plan, diag)``
        as one unit: :func:`repro_torch.kernels.shuffle_gemm.run_chain`
        over the run's sub-steps (segments and tiles found here, at bind
        time, and cached with the lowering), then the last group's
        ``post``.  Returns ``(unit, chain)``."""
        from ..kernels.shuffle_gemm import ShuffleGemmChain, run_chain
        from ..kernels.shuffle_gemm.chain import SubStep

        def build():
            steps = [SubStep(e.name, plan, diag, shape.rows_total,
                             int(np.asarray(e.operand).size)
                             // (shape.groups * shape.t),
                             shape.groups, shape.nb)
                     for e, shape, plan, diag in groups]
            return ShuffleGemmChain(steps)

        from . import plan_cache_get
        key = tuple(_group_digest(e, plan, diag, None)
                    for e, _, plan, diag in groups)
        chain = plan_cache_get("exec_chain", key, build, backend=self.name)
        operands = [(e, _CanonicalOperand(shape)) for e, shape, _, _ in groups]
        post = groups[-1][0].post

        def unit(x, sp):
            ws, per_row = [], []
            for i, (e, canonical) in enumerate(operands):
                w, rows = canonical.of(e, sp, x)
                ws.append(w)
                if rows:
                    per_row.append(i)
            y = run_chain(x, chain, ws, per_row)
            return apply_plan(y, post) if post is not None else y
        return unit, chain

    def _int_unit(self, e: EinsumStep, shape: _EinsumShape,
                  plan: ShufflePlan, diag, widths: Tuple[int, int]):
        """Int-routed GEMM with a straight-through / dequantized
        gradient — the JAX package's ``PallasBackend._int_unit`` step
        for step.

        Forward: symmetric quantization of the gathered rows (per row)
        and of the operand (per output column), exact bitserial integer
        contraction, dequantization by the product of scales.
        ``round`` is piecewise-constant — zero gradient almost
        everywhere — so the backward pass is, by deliberate policy, the
        float GEMM's VJP at the *unquantized* residuals with the
        cotangent taken at the quantized output: ``y = y_float +
        (y_int - y_float).detach()`` (:class:`_IntSTEFn`).  A row-stacked
        operand (one a batch row) is quantized per column within its
        row, as inside one lane of the JAX package's ``vmap``: one launch
        of the per-row kernel."""
        post = e.post
        canonical = _CanonicalOperand(shape)

        def unit(x, sp):
            g = apply_plan(x, plan)
            if diag is not None:
                g = g * device_constant(diag, g.device, g.dtype)
            h = g.reshape(*g.shape[:-1], shape.rows_total, shape.t).float()
            w, _ = canonical.of(e, sp, h)
            y = _IntSTEFn.apply(h, w, widths).to(x.dtype)
            y = y.reshape(*y.shape[:-2], -1)
            return apply_plan(y, post) if post is not None else y
        return unit


class _IntSTEFn(torch.autograd.Function):
    """``quantize -> bitserial_matmul -> dequantize`` of ``h`` (..., r, t)
    against ``w`` (t, c), or (B, t, c) one a batch row of ``h`` (B, ...,
    r, t), at ``widths = (aw, ww)`` — on the card one launch of the fused
    bitserial kernel (:func:`repro_torch.kernels.
    bitserial_quant_matmul`), bit for bit the composition — with the
    straight-through backward: ``dh = dy @ w^T``, ``dw = sum h^T dy``
    (per batch row for a row-stacked ``w``)."""

    @staticmethod
    def forward(ctx, h, w, widths):
        from ..kernels import bitserial_quant_matmul
        ctx.save_for_backward(h, w)
        return bitserial_quant_matmul(h, w, *widths)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dh = dw = None
        if w.ndim == 3:                  # one w a batch row
            hb = h.reshape(w.shape[0], -1, h.shape[-1])
            dyb = dy.reshape(w.shape[0], -1, dy.shape[-1]).to(h.dtype)
            if ctx.needs_input_grad[0]:
                dh = torch.einsum("brc,btc->brt", dyb, w).reshape(
                    h.shape).to(h.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.einsum("brt,brc->btc", hb, dyb).to(w.dtype)
            return dh, dw, None
        if ctx.needs_input_grad[0]:
            dh = torch.einsum("...rc,tc->...rt", dy, w).to(h.dtype)
        if ctx.needs_input_grad[1]:
            hb = h.reshape(-1, *h.shape[-2:])
            dyb = dy.reshape(-1, *dy.shape[-2:]).to(h.dtype)
            dw = torch.einsum("brt,brc->tc", hb, dyb).to(w.dtype)
        return dh, dw, None


def _check_int_headroom(step_name: str, widths: Tuple[int, int],
                        k: int) -> None:
    """Reject precision-policy routings whose integer accumulation can
    wrap the array's 32-bit accumulator: each quantized product is
    < 2^(aw+ww-2) and ``k`` of them sum per output, so the policy needs
    ``aw + ww - 2 + ceil(log2 k) <= 31``.  Failing loudly at bind time
    beats silently wrapped (sign-flipped) outputs."""
    aw, ww = widths
    need = bw.int_headroom_bits(aw, ww, k)
    if need > bw.ACC_BITS:
        raise ValueError(
            f"PrecisionPolicy({aw}, {ww}) on step {step_name!r} with "
            f"contraction size {k} needs {need} accumulator bits and "
            f"would overflow the int32 array accumulator; choose "
            f"narrower widths (aw + ww - 2 + ceil(log2 K) must be "
            f"<= 31)")


def _reference_unit(step):
    def unit(x, sp):
        return run_steps_reference([step], x, sp)
    return unit


def _group_digest(e: EinsumStep, plan: ShufflePlan, diag,
                  widths) -> Tuple:
    """Content digest of one lowered group: everything the built unit
    closure depends on.  Lambdas never reach here, so cached units are
    pure functions of this key and safe to share across programs."""
    h = hashlib.sha1()
    for arr in (plan.gather_idx, plan.pad_values,
                np.asarray(diag) if diag is not None else np.zeros(0),
                np.asarray(e.operand),
                e.post.gather_idx if e.post is not None else np.zeros(0),
                e.post.pad_values if e.post is not None else np.zeros(0)):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    meta = (e.spec, tuple(e.reshape_in), e.out_rank, e.rows, e.cin,
            e.cout, e.param_key, widths)
    return (h.hexdigest(), meta)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable[[], ExecBackend]] = {
    "reference": ReferenceBackend,
    "hopper": HopperBackend,
}


def register_backend(name: str,
                     factory: Callable[[], ExecBackend]) -> None:
    """Register a backend factory under ``name`` (resolved by
    :func:`get_backend` / ``compile(backend=name)``)."""
    _BACKENDS[name] = factory


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def get_backend(backend) -> ExecBackend:
    """Resolve a backend name to a fresh instance, or pass an
    :class:`ExecBackend` instance through (custom precision
    configurations)."""
    if isinstance(backend, ExecBackend):
        return backend
    try:
        return _BACKENDS[backend]()
    except KeyError:
        raise ValueError(
            f"unknown execution backend {backend!r}; choose from "
            f"{available_backends()} or pass an ExecBackend instance")
