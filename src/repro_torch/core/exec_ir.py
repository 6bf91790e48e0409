"""The executable-program IR of a compiled SignalGraph.

``signal/graph.py`` lowers a declared pipeline DAG into per-stage lists of
three primitive step kinds and fuses them; this module is where those
steps live **as data**, together with the program container the execution
backends (:mod:`repro_torch.signal.backends`) consume:

  * :class:`GatherStep` — one standalone pass through the shuffling
    fabric (a static :class:`~repro_torch.core.fabric.ShufflePlan` plus an
    optional constant per-element ``diag`` scale);
  * :class:`EinsumStep` — one computing-array pass (reshape, contract
    against a static operand, flatten back), optionally carrying the
    v2-folded ``pre``/``pre_diag``/``post`` stream shuffles and a
    ``param_key`` marking a learnable operand slot;
  * :class:`LambdaStep` — host/array glue that moves no data through the
    fabric (complex repacking, overlap-add, the DNN hook).

A :class:`StageProgram` is one lowered stage (steps + DAG wiring + output
type); an :class:`ExecProgram` is the whole pipeline: the ordered stage
list, the declared outputs, and the input/output types.  Everything a
backend needs to execute — plans, operands, masks, param slots — is
reachable from the program without consulting the builder graph, which is
what makes the execution strategy pluggable: the ``reference`` backend
interprets the steps with plain torch ops (:func:`run_steps_reference`,
the JAX package's step semantics verbatim), while the ``hopper`` backend
lowers gather∘einsum groups onto the fused fabric+array CUDA kernels.

:func:`execute_program` is the shared program walker (environment
threading, multi-input ``combine``, per-stage valid-frame masking, output
collection); backends plug in only the per-stage step executor, so every
backend agrees on graph-level semantics by construction.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tree import tree_map
from . import fabric as _fabric
from .fabric import ShufflePlan, apply_plan, device_constant

__all__ = ["GatherStep", "EinsumStep", "LambdaStep", "Step",
           "StageProgram", "ExecProgram", "RowParams", "run_steps_reference",
           "execute_program", "mask_frames", "adjoint_gather_steps",
           "callable_token", "row_operand", "INPUT"]

INPUT = "input"     # the reserved graph-input name (SignalGraph.INPUT)


# --------------------------------------------------------------------------
# Primitive steps (the compiled artifact)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GatherStep:
    """One shuffling-fabric pass: ``out = in[plan] (* diag)``.  ``diag`` is
    a static per-element scale folded into the consuming array pass (window
    functions, 1/n iFFT normalization, conjugation sign patterns)."""
    name: str
    plan: ShufflePlan
    diag: Optional[np.ndarray] = None


@dataclasses.dataclass
class EinsumStep:
    """One computing-array pass: reshape the flat last axis to
    ``reshape_in``, einsum against the static operand, flatten back.

    ``pre`` / ``post`` are optional pure-permutation shuffle plans the
    fabric applies on the buffer->array stream-in and array->buffer
    stream-out of the SAME pass (the v2 fusion target): they move words
    in lock-step with the array and cost no standalone fabric pass.
    ``pre_diag`` is the constant per-element stream-in scale (window /
    conjugation / 1/n patterns) inherited from a folded gather.
    ``folded`` records the names of the absorbed passes for the perf
    report's attribution.

    ``param_key`` marks a *learnable* operand: when the stage's params
    entry is a dict containing that key, its value replaces ``operand``
    at run time (same shape/meaning — FIR taps, the mel matrix), so the
    operand participates in autodiff instead of being baked into the
    trace.  ``operand`` stays the static default and seeds
    ``CompiledSignalGraph.init_params``.
    """
    name: str
    spec: str
    operand: np.ndarray
    reshape_in: Tuple[int, ...]
    out_rank: int                 # rank of the einsum-result suffix to flatten
    rows: int                     # output positions  (perf: ConvLayer.h)
    cin: int                      # contraction size  (perf: ConvLayer.cin)
    cout: int                     # output features   (perf: ConvLayer.cout)
    pre: Optional[ShufflePlan] = None    # stream-in permutation (v2 fold)
    pre_diag: Optional[np.ndarray] = None
    post: Optional[ShufflePlan] = None   # stream-out permutation (v2 fold)
    folded: Tuple[str, ...] = ()
    param_key: Optional[str] = None      # learnable-operand params key


@dataclasses.dataclass
class LambdaStep:
    """Glue with no fabric traffic (repacking, OLA, DNN hook).
    ``param_init`` is the stage's default learnable-params entry, when
    the lambda consumes one (biquad ``b``/``a``, a dnn hook's declared
    ``init``) — collected by ``CompiledSignalGraph.init_params``.
    ``row_params`` marks a params-taking ``fn`` that runs under
    ``torch.func.vmap`` over row-stacked params (:class:`RowParams`):
    the dnn hook, a user callable of one unbatched row, as the JAX
    package ``vmap`` s the whole row program.  A params-taking ``fn``
    not so marked takes the :class:`RowParams` itself and computes each
    batch row with its own row (the biquad's coefficients, broadcast
    over the batch)."""
    name: str
    fn: Callable
    takes_params: bool = False
    param_init: Optional[object] = None
    row_params: bool = False


Step = object  # GatherStep | EinsumStep | LambdaStep


class RowParams:
    """One stage's params entry with a leading row axis on every leaf:
    batch row i computes with row i of each leaf (a served wave whose
    rows come from graphs that registered different weights).  The
    program walker wraps each stage's entry in one when a call is
    per-row (:func:`execute_program` ``row_params``).  Every step takes
    it, as the JAX package's ``vmap`` over the row program does: an
    :class:`EinsumStep` through :func:`row_operand` (a batched einsum on
    the plain path; one kernel launch with one operand a row on the
    lowered one), a :class:`LambdaStep` marked ``row_params`` under
    ``vmap`` over rows, any other params-taking :class:`LambdaStep` as
    its own argument."""

    def __init__(self, tree):
        self.tree = tree

    def take(self, index) -> "RowParams":
        """The rows ``index`` (a 1-D index tensor) of every leaf."""
        return RowParams(tree_map(lambda a: a[index], self.tree))

    def row(self, i: int):
        """Row ``i`` of every leaf: a plain params entry."""
        return tree_map(lambda a: a[i], self.tree)


# --------------------------------------------------------------------------
# The reference step semantics (the plain torch interpreter)
# --------------------------------------------------------------------------

def run_steps_reference(steps: Sequence[Step], x: torch.Tensor,
                        params) -> torch.Tensor:
    """Interpret a step list with plain torch ops.  This IS the
    execution contract: every backend must match it (the ``reference``
    backend byte-for-byte; lowered backends to float tolerance, since a
    fused kernel may re-associate the same multiplies)."""
    for s in steps:
        if isinstance(s, GatherStep):
            x = apply_plan(x, s.plan)
            if s.diag is not None:
                x = x * device_constant(s.diag, x.device, x.dtype)
        elif isinstance(s, EinsumStep):
            if s.pre is not None:
                x = apply_plan(x, s.pre)
            if s.pre_diag is not None:
                # applied even without a pre plan (identity stream-in):
                # the lowered backends honor a bare pre_diag too, and
                # the two must agree on every expressible program.
                x = x * device_constant(s.pre_diag, x.device, x.dtype)
            h = x.reshape(*x.shape[:-1], *s.reshape_in)
            op = row_operand(s, params)
            if op is not None:
                # one operand a batch row: the einsum batched over rows
                y = torch.func.vmap(functools.partial(torch.einsum,
                                                      s.spec))(
                    h, device_constant(op, h.device, h.dtype))
            else:
                op = resolve_operand(s, params)
                y = torch.einsum(s.spec, h,
                                 device_constant(op, h.device, h.dtype))
            x = y.reshape(*y.shape[:-s.out_rank], -1)
            if s.post is not None:
                x = apply_plan(x, s.post)
        elif isinstance(params, RowParams) and s.takes_params \
                and s.row_params:
            x = torch.func.vmap(s.fn, in_dims=(0, 0))(params.tree, x)
        else:
            x = s.fn(params, x) if s.takes_params else s.fn(x)
    return x


def adjoint_gather_steps(name: str, plan: ShufflePlan, n_in: int,
                         diag=None) -> List[Step]:
    """The adjoint of one fabric gather as a two-step program in THIS IR.

    The forward pass is ``GatherStep(plan, diag)``: ``out = diag *
    in[plan]`` with ``len(out) == plan.n_out`` and ``len(in) == n_in``.
    Its linear transpose — the cotangent route ``d_out -> d_in`` — is
    returned as ``[GatherStep, EinsumStep]`` over the *cotangent*
    stream: gather the inverse index map (scatter-as-gather, PAD slots
    contributing 0; see :func:`repro_torch.core.fabric.adjoint_plan`), then
    reduce the ``m`` duplicate-read slots per source element on the
    computing array (``"...nm,m->...n"`` against a ones vector — a
    width-``m`` GEMM row).

    The returned steps run under :func:`run_steps_reference` (the
    oracle) *and* lower through the same gather∘einsum kernel family as
    any forward group, which is how the backward pass of the training
    slice stays on the fabric+array machinery.
    """
    adj, adj_diag, m = _fabric.adjoint_plan(plan, n_in, diag)
    return [
        GatherStep(f"{name}.adjoint", adj, adj_diag),
        EinsumStep(f"{name}.reduce", "...nm,m->...n",
                   np.ones(m, np.float32), reshape_in=(n_in, m),
                   out_rank=1, rows=n_in, cin=m, cout=1),
    ]


def resolve_operand(step: EinsumStep, params):
    """The einsum operand for one call: the stage's params entry when the
    step declares a ``param_key`` present there, else the static
    default.  For a row-stacked entry (:class:`RowParams`) holding the
    key, the ``(B, *operand.shape)`` operands, one a batch row:
    :func:`row_operand` tells the two apart."""
    if isinstance(params, RowParams):
        op = row_operand(step, params)
        return step.operand if op is None else op
    if step.param_key is not None and isinstance(params, dict) \
            and step.param_key in params:
        return params[step.param_key]
    return step.operand


def row_operand(step: EinsumStep, params):
    """The step's row-stacked operand — ``(B, *operand.shape)``, one a
    batch row — when ``params`` is a :class:`RowParams` holding the
    step's ``param_key``, else None."""
    if isinstance(params, RowParams) and step.param_key is not None \
            and isinstance(params.tree, dict) \
            and step.param_key in params.tree:
        return params.tree[step.param_key]
    return None


# --------------------------------------------------------------------------
# Structural fingerprinting (cross-graph batching / compile-cache sharing)
# --------------------------------------------------------------------------
#
# Two *registered* graphs frequently lower to the same core program —
# same builder called twice, the same pipeline registered under two
# serving names, A/B copies of one front-end.  Their compiled programs
# are then interchangeable: identical step sequences, identical
# operands, identical stage/output names.  ``ExecProgram.fingerprint``
# digests exactly that content (everything execution depends on; the
# program's *display name* is excluded) so schedulers and compile
# caches can key on "same lowered program" instead of "same registry
# name".  The hard part is lambdas: a LambdaStep's ``fn`` is hashed by
# code-object content (filename, line, bytecode) plus the *values* of
# its closure cells and defaults — ints, tuples, arrays, dataclasses
# (SigType, ShufflePlan) and nested callables all tokenize.  Anything
# opaque (an unhashable closure, a C extension object) makes the whole
# fingerprint ``None``: the program is then simply never shared, which
# is always safe.  Torch callables token like any Python function (a
# ``torch.nn.functional`` builtin by its qualified name); a captured
# tensor tokens by its content, moved to the host.

def _array_token(arr) -> Tuple:
    a = np.ascontiguousarray(np.asarray(arr))
    return ("arr", str(a.dtype), a.shape,
            hashlib.sha1(a.tobytes()).hexdigest())


def _plan_token(plan: Optional[ShufflePlan]):
    if plan is None:
        return ("c", "None")
    return ("plan", _array_token(plan.gather_idx),
            _array_token(plan.pad_values), int(plan.width))


def _const_token(v):
    """Content token of one closure-cell / default / const value, or
    ``None`` when the value is opaque (disables fingerprint sharing)."""
    if v is None or isinstance(v, (bool, int, float, complex, str,
                                   bytes)):
        return ("c", repr(v))
    if isinstance(v, np.generic):
        return ("c", repr(v))
    if isinstance(v, ShufflePlan):
        return _plan_token(v)
    if isinstance(v, np.ndarray):
        return _array_token(v)
    if isinstance(v, torch.Tensor):
        return _array_token(v.detach().cpu().numpy())
    if isinstance(v, (tuple, list)):
        toks = tuple(_const_token(x) for x in v)
        if any(t is None for t in toks):
            return None
        return ("seq", type(v).__name__, toks)
    if isinstance(v, dict):
        try:
            items = sorted(v.items())
        except TypeError:
            return None
        toks = tuple((repr(k), _const_token(x)) for k, x in items)
        if any(t is None for _, t in toks):
            return None
        return ("map", toks)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        toks = []
        for f in dataclasses.fields(v):
            t = _const_token(getattr(v, f.name))
            if t is None:
                return None
            toks.append((f.name, t))
        return ("dc", type(v).__name__, tuple(toks))
    if callable(v):
        return callable_token(v)
    return None


def _code_token(code) -> Tuple:
    consts = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            consts.append(_code_token(c))
        else:
            consts.append(repr(c))
    return ("code", code.co_filename, code.co_firstlineno, code.co_name,
            hashlib.sha1(code.co_code).hexdigest(), tuple(consts),
            code.co_names)


def callable_token(fn) -> Optional[Tuple]:
    """A content-based identity token for a callable, or ``None`` when
    one cannot be computed safely.

    Plain Python functions token as (code location + bytecode digest,
    closure-cell values, default values) — so two function objects from
    the same ``def``/``lambda`` with equal captured values compare
    equal, while same-source closures over *different* values do not.
    ``functools.partial`` recurses; builtins / ufuncs token by
    module-qualified name.  No ``id()`` is ever used: tokens stay valid
    across garbage collection."""
    if isinstance(fn, functools.partial):
        ft = callable_token(fn.func)
        at = _const_token(tuple(fn.args))
        kt = _const_token(dict(fn.keywords))
        if ft is None or at is None or kt is None:
            return None
        return ("partial", ft, at, kt)
    code = getattr(fn, "__code__", None)
    if code is None:
        mod = getattr(fn, "__module__", None)
        qn = getattr(fn, "__qualname__", None)
        if mod and qn and "<locals>" not in qn:
            return ("builtin", mod, qn)
        return None
    cell_toks = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:            # empty cell (recursive def)
            return None
        t = _const_token(v)
        if t is None:
            return None
        cell_toks.append(t)
    dflt_toks = []
    for v in getattr(fn, "__defaults__", None) or ():
        t = _const_token(v)
        if t is None:
            return None
        dflt_toks.append(t)
    return ("fn", _code_token(code), tuple(cell_toks), tuple(dflt_toks))


def _type_token(t) -> Tuple:
    suffix = getattr(t, "suffix", ()) or ()
    return ("type", getattr(t, "domain", None), tuple(suffix),
            bool(getattr(t, "is_complex", False)),
            getattr(t, "frame", None), getattr(t, "hop", None))


def _step_token(s):
    if isinstance(s, GatherStep):
        return ("gather", s.name, _plan_token(s.plan),
                _const_token(s.diag))
    if isinstance(s, EinsumStep):
        return ("einsum", s.name, s.spec, tuple(s.reshape_in),
                s.out_rank, s.rows, s.cin, s.cout, s.param_key,
                _array_token(s.operand), _plan_token(s.pre),
                _const_token(s.pre_diag), _plan_token(s.post),
                tuple(s.folded))
    ft = callable_token(s.fn)
    if ft is None:
        return None
    pi = _const_token(s.param_init)
    if pi is None:
        return None
    return ("lambda", s.name, ft, bool(s.takes_params), pi)


# --------------------------------------------------------------------------
# Program containers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StageProgram:
    """One lowered stage: its step list plus the DAG wiring the walker
    needs (``inputs`` name upstream stages or the graph input;
    ``combine`` merges multiple inputs before the steps run).
    ``out_type`` is the stage's :class:`~repro_torch.signal.graph.SigType`
    (duck-typed here — the IR only reads ``domain`` and ``suffix`` for
    masking and ``elems`` for accounting); ``extra_layers`` carries
    user-declared perf-model ConvLayer descriptors (dnn hooks);
    ``frame_context`` is the across-frame receptive field of a dnn hook
    (masked execution runs such a stage on each row's valid frames)."""
    name: str
    inputs: Tuple[str, ...]
    combine: Optional[Callable]
    steps: List[Step]
    out_type: object
    extra_layers: Tuple = ()
    frame_context: int = 0


@dataclasses.dataclass
class ExecProgram:
    """A whole compiled pipeline as data: the ordered stage list, the
    declared outputs, input/output types and the fuse level it was
    compiled at.  Consumed by :class:`repro_torch.signal.backends.ExecBackend`
    implementations via :func:`execute_program`."""
    name: str
    stages: List[StageProgram]
    outputs: Tuple[str, ...]
    in_type: object
    out_types: Dict[str, object]
    single: bool
    fuse_level: int

    # -- step queries (accounting + backend lowering) -----------------------
    def gather_steps(self) -> List[GatherStep]:
        """The standalone fabric passes (buffer -> fabric -> buffer)."""
        return [s for st in self.stages for s in st.steps
                if isinstance(s, GatherStep)]

    def einsum_steps(self) -> List[EinsumStep]:
        """The computing-array passes, in execution order."""
        return [s for st in self.stages for s in st.steps
                if isinstance(s, EinsumStep)]

    def param_slots(self) -> Dict[str, Tuple[str, ...]]:
        """Learnable-parameter slots per stage: einsum ``param_key`` s
        plus ``"<lambda>"`` markers for param-consuming lambdas."""
        slots: Dict[str, Tuple[str, ...]] = {}
        for st in self.stages:
            keys = []
            for s in st.steps:
                if isinstance(s, EinsumStep) and s.param_key is not None:
                    keys.append(s.param_key)
                elif isinstance(s, LambdaStep) and s.takes_params:
                    keys.append("<lambda>")
            if keys:
                slots[st.name] = tuple(keys)
        return slots

    # -- structural identity (cross-graph batching / compile sharing) -------
    def fingerprint(self) -> Optional[str]:
        """Canonical structural digest of the program, or ``None`` when
        one cannot be computed (an opaque lambda closure).

        Covers everything execution depends on: stage names and DAG
        wiring, every step's plans / operands / shapes / param slots,
        combine and lambda callables by code + captured-value content,
        output names and input/output types, and the fuse level.  The
        program's display ``name`` is deliberately excluded — two
        graphs registered under different serving names but lowering
        to this same content are interchangeable: same results, same
        params schema (params are keyed by stage name, which the
        digest pins), same output dict keys.  That is the contract the
        serving scheduler's cross-graph batching and the backends'
        fingerprint-keyed bind cache rely on.

        Computed once and cached on the instance (programs are frozen
        after compile)."""
        cached = getattr(self, "_fingerprint", False)
        if cached is not False:
            return cached
        fp: Optional[str] = None
        toks = self._fingerprint_tokens()
        if toks is not None:
            fp = hashlib.sha1(repr(toks).encode()).hexdigest()
        self._fingerprint = fp
        return fp

    def _fingerprint_tokens(self) -> Optional[Tuple]:
        stage_toks = []
        for st in self.stages:
            step_toks = []
            for s in st.steps:
                t = _step_token(s)
                if t is None:
                    return None
                step_toks.append(t)
            comb = ("c", "None") if st.combine is None \
                else callable_token(st.combine)
            if comb is None:
                return None
            stage_toks.append((st.name, tuple(st.inputs), comb,
                               tuple(step_toks), _type_token(st.out_type),
                               int(st.frame_context)))
        return (tuple(stage_toks), tuple(self.outputs),
                _type_token(self.in_type),
                tuple(sorted((k, _type_token(v))
                             for k, v in self.out_types.items())),
                bool(self.single), int(self.fuse_level))


# --------------------------------------------------------------------------
# The shared program walker
# --------------------------------------------------------------------------

def mask_frames(y: torch.Tensor, valid_frames,
                suffix_rank: int) -> torch.Tensor:
    """Zero the frame rows at index >= ``valid_frames`` of a frames-domain
    value.  ``y`` is ``(*batch, F, *rest)`` with ``suffix_rank`` trailing
    suffix axes (the frames axis leads the suffix); ``valid_frames`` is an
    int tensor broadcastable over the batch axes (scalar or one count per
    batch row).  Valid rows pass through untouched — ``torch.where``
    selects, it never rescales — so the valid region stays
    bit-identical."""
    axis = y.ndim - suffix_rank
    idx = torch.arange(y.shape[axis], device=y.device).reshape(
        (-1,) + (1,) * (suffix_rank - 1))
    vf = torch.as_tensor(valid_frames, device=y.device)
    vf = vf.reshape(vf.shape + (1,) * suffix_rank)
    return torch.where(idx < vf, y, torch.zeros((), dtype=y.dtype,
                                                device=y.device))


def run_valid_prefix(fn: Callable, h: torch.Tensor, sp, valid_frames,
                     suffix_rank: int) -> torch.Tensor:
    """``fn(h, sp)`` with every batch row cut to its first
    ``valid_frames`` frame rows, zero beyond them.  A stage that reads
    across frames (a dnn hook's ``frame_context``) then sees the same
    frames as an unpadded run at the row's true length: a convolution's
    own zero padding, not features of the masked zero frames (``cos``
    of the angle of 0 is 1), meets the last valid frames.  Rows sharing
    a count run as one call; row-stacked params (:class:`RowParams`,
    their row axis the leading batch axis) are cut to the same rows, and
    a row alone with its count runs as a batch of one with its own
    params entry (the per-row semantics without ``vmap``'s dispatch).
    Rows of 0 valid frames (a meshed wave's zero pad rows) stay zero:
    the stage runs on their first frame only when no row has any, to
    learn its output's shape."""
    axis = h.ndim - suffix_rank
    batch = h.shape[:axis]
    hb = h.reshape(-1, *h.shape[axis:])
    vf = torch.as_tensor(valid_frames).expand(batch).reshape(-1).tolist()
    # flat row i of hb computes with row i // per of row-stacked params
    per = hb.shape[0] // batch[0] if batch else 1
    out = None
    counts = sorted(set(vf))
    if len(counts) > 1 and counts[0] == 0:
        counts = counts[1:]
    for v in counts:
        rows = [i for i, c in enumerate(vf) if c == v]
        sel = torch.as_tensor(rows, device=h.device)
        n = max(v, 1)
        if not isinstance(sp, RowParams):
            y = fn(hb[sel, :n], sp)
        elif len(rows) == 1:
            y = fn(hb[sel, :n], sp.row(rows[0] // per))
        else:
            y = fn(hb[sel, :n], sp.take(torch.as_tensor(
                [i // per for i in rows], device=h.device)))
        if out is None:
            out = y.new_zeros((hb.shape[0], hb.shape[1], *y.shape[2:]))
        if v:
            out[sel, :v] = y
    return out.reshape(*batch, *out.shape[1:])


def execute_program(program: ExecProgram, stage_fns: Dict[str, Callable],
                    x: torch.Tensor, params=None, valid_frames=None,
                    row_params: bool = False):
    """Run a program: thread the stage environment, combine multi-input
    stages, execute each stage's steps through ``stage_fns[name]``
    (``(x, stage_params) -> y``, supplied by the backend), mask
    frames-domain outputs when ``valid_frames`` is given, and collect the
    declared outputs (ordered dict, or the bare primary array for
    ``single`` programs).  With ``valid_frames``, a stage with a
    ``frame_context`` runs on each row's valid frames
    (:func:`run_valid_prefix`), so masked results equal unpadded ones
    there too; the JAX package runs it on the masked zero frames.

    ``row_params``: every leaf of ``params`` carries a leading row axis
    of ``x``'s batch (row i of the batch computes with row i of each
    leaf); each stage's entry reaches its steps as a
    :class:`RowParams`."""
    env = {INPUT: x}
    for st in program.stages:
        vals = [env[i] for i in st.inputs]
        h = st.combine(*vals) if st.combine is not None else vals[0]
        sp = (params or {}).get(st.name) if isinstance(params, dict) \
            else params
        if row_params and sp is not None:
            sp = RowParams(sp)
        if valid_frames is not None and st.frame_context > 0:
            y = run_valid_prefix(stage_fns[st.name], h, sp, valid_frames,
                                 len(st.out_type.suffix))
        else:
            y = stage_fns[st.name](h, sp)
        if valid_frames is not None and st.out_type.domain == "frames":
            y = mask_frames(y, valid_frames, len(st.out_type.suffix))
        env[st.name] = y
    if program.single:
        return env[program.outputs[0]]
    return {name: env[name] for name in program.outputs}
