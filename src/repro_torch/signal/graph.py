"""SigStream: a declarative DSP pipeline-graph compiler for the SigDLA path.

The paper's headline workload (Fig 9) is not a single transform but a
*pipeline* — FFT -> CNN -> iFFT speech enhancement — and the win of the
shuffling-fabric architecture comes from keeping the whole pipeline on the
accelerator.  A :class:`SignalGraph` is a DAG of typed stages (stft, fft,
ifft, fir, iir_biquad, dct, dwt, mel_filterbank, magnitude, overlap_add,
mul, dnn-model hook).  ``compile()`` lowers every stage to a sequence of
three primitive step kinds:

  * :class:`GatherStep` — one pass through the shuffling fabric (a static
    :class:`~repro_torch.core.fabric.ShufflePlan`, with an optional constant
    per-element scale the consuming array pass applies on stream-in);
  * :class:`EinsumStep` — one dense GEMM/einsum on the computing array
    against a static operand (twiddles, taps, DCT matrix, mel filterbank);
  * :class:`LambdaStep` — host/array glue (complex repacking, overlap-add
    accumulation, the DNN hook) that moves no data through the fabric.

Two fusion passes then shrink the step list:

  * **v1 — gather∘gather** composes adjacent gathers via
    :func:`repro_torch.core.fabric.fuse_plans` — back-to-back data-movement
    plans (framing -> complex interleave -> FFT bit-reversal -> stage-1
    butterfly gather) collapse into ONE fabric pass, the graph-level
    generalization of the per-FFT ``fuse_adjacent`` optimization.
  * **v2 — cross-einsum permutation folding** eliminates the fabric
    passes *between* einsums.  A :class:`GatherStep` whose plan is a pure
    permutation (:func:`repro_torch.core.fabric.is_permutation`; block-diagonal
    tiled permutations included) reads every source element exactly once,
    so the fabric can apply it on the buffer->array stream of the
    adjacent array pass instead of making a write-back round trip.  Two
    rewrite rules apply, in order:

      1. a *row-aligned* permutation (it moves whole contraction rows,
         untouched inside) ahead of a *row-equivariant* einsum (operand
         does not index the row axes) commutes through the einsum at
         compile time and re-emerges as a row permutation of the output,
         where the re-run gather∘gather pass fuses it onward (identities
         vanish entirely);
      2. any remaining pure-permutation neighbor folds into the
         :class:`EinsumStep` itself as its ``pre``/``post`` stream
         shuffle via :func:`repro_torch.core.fabric.compose_into_einsum` — the
         ``gather ∘ einsum ∘ gather`` chain becomes a single array pass
         with pre/post-permuted operands.

    Duplicating or padding plans (STFT framing at hop < frame, FIR
    im2col) are *not* permutations and keep their standalone pass.  Both
    rules move data without re-associating any arithmetic, so v2 output
    is bit-identical to the unfused lowering.

The result is a single callable plus per-graph fabric-pass /
shuffle-word / cycle accounting consumed by
:func:`repro_torch.core.perf_model.signal_graph_report`, which attributes
the passes and words saved by each fusion level.

**The SigProgram contract.**  A graph declares plural, ordered, named
outputs (:meth:`SignalGraph.outputs`, plus :meth:`SignalGraph.tap` for
diagnostic taps); the compiled callable returns an ordered
``dict[str, Array]``, dead stages are pruned, and stages shared by
several outputs are lowered once
(:meth:`CompiledSignalGraph.output_attribution` exposes the split).
Learnable stage parameters — FIR taps, biquad ``b``/``a``, the mel
matrix, dnn hooks — form a first-class params dict
(:meth:`CompiledSignalGraph.init_params`) accepted per call (hot-swap,
no recompile).  The same contract rides the serving layer
(:mod:`repro_torch.serving.signal_service`): one compiled program per
pipeline and length bucket, per-request results.  The historical
single-``output()`` spelling still works (bare-array results) with a
``DeprecationWarning``.

**This port.**  PyTorch runs eagerly, so a compiled graph is a plain
callable on tensors of its ``device`` (``"cuda"`` unless the caller asks
for the CPU); :meth:`CompiledSignalGraph.jit` and ``masked_jit`` return
plain callables.  ``backend="hopper"`` lowers gather∘einsum groups onto
the hand-written shuffle-GEMM CUDA kernels, and the steps a SigQuant
``PrecisionPolicy`` names onto the bitserial integer kernel.
Differentiation (:meth:`CompiledSignalGraph.value_and_grad`) runs on
``torch.autograd`` through the same kernels (their backward passes are
``torch.autograd.Function`` s on adjoint operands), and so does the
streaming runtime (:mod:`repro_torch.signal.streaming`), whose per-block
cores are compiled graphs too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import signal_mapping as _sm
from ..core import exec_ir as _exec_ir
from ..core.exec_ir import (EinsumStep, ExecProgram, GatherStep, LambdaStep,
                            RowParams, StageProgram, Step)
from ..core.exec_ir import mask_frames as _mask_frames          # noqa: F401
from ..core.exec_ir import run_steps_reference as _run_steps    # noqa: F401
from ..core.fabric import (PAD, ShufflePlan, compose_into_einsum,
                           device_constant, is_identity, is_permutation,
                           tile_plan)
from ..device import DEFAULT_DEVICE, resolve_device
from ..tree import tree_leaves, tree_map

__all__ = ["SignalGraph", "CompiledSignalGraph", "SigType", "FuseLevel",
           "GatherStep", "EinsumStep", "LambdaStep",
           "biquad_apply", "overlap_add", "mel_filterbank_matrix"]

class FuseLevel(enum.IntEnum):
    """Fusion level of the graph compiler (see the module docstring).

    * ``NONE``   (0) — op-by-op lowering, one fabric pass per gather;
    * ``GATHER`` (1) — v1: compose back-to-back gathers into one pass;
    * ``STREAM`` (2) — v2: additionally fold pure-permutation passes
      across einsum boundaries into the adjacent array pass.

    All levels produce bit-identical outputs.  Plain ints 0/1/2 are
    accepted anywhere a ``FuseLevel`` is; the historical ``True`` /
    ``False`` spelling still works but is deprecated.
    """

    NONE = 0
    GATHER = 1
    STREAM = 2

    @classmethod
    def coerce(cls, value: "FuseLevel | bool | int") -> "FuseLevel":
        """Normalize a user-supplied fusion level.  Booleans map to
        ``STREAM`` / ``NONE`` for back-compat and raise a
        ``DeprecationWarning``; ints must be 0, 1 or 2."""
        if isinstance(value, cls):
            return value
        if isinstance(value, (bool, np.bool_)):
            warnings.warn(
                "fuse=True/False is deprecated; pass FuseLevel.STREAM / "
                "FuseLevel.NONE (or the ints 2 / 0)",
                DeprecationWarning, stacklevel=3)
            return cls.STREAM if value else cls.NONE
        if isinstance(value, (int, np.integer)) and int(value) in (0, 1, 2):
            return cls(int(value))
        raise ValueError(
            f"fuse must be a FuseLevel, 0, 1 or 2 (or the deprecated "
            f"True/False); got {value!r}")


# --------------------------------------------------------------------------
# Types carried along graph edges
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SigType:
    """Shape/domain of a stage output: ``suffix`` is the trailing shape
    (leading axes are batch), ``domain`` is 'samples' or 'frames'."""
    suffix: Tuple[int, ...]
    is_complex: bool = False
    domain: str = "samples"
    frame: int = 0
    hop: int = 0

    @property
    def elems(self) -> int:
        n = 1
        for d in self.suffix:
            n *= d
        return n * (2 if self.is_complex else 1)


# --------------------------------------------------------------------------
# Primitive steps (the compiled artifact)
# --------------------------------------------------------------------------
#
# The step dataclasses — GatherStep / EinsumStep / LambdaStep — and the
# canonical torch step interpreter live in :mod:`repro_torch.core.exec_ir` (the
# executable-program IR); they are re-exported here for the builder API
# and back-compat.  ``_run_steps`` is the reference interpreter
# (:func:`repro_torch.core.exec_ir.run_steps_reference`).


def _compose_gathers(a: GatherStep, b: GatherStep) -> GatherStep:
    """a then b -> one fabric pass.  a's diag sinks through b's gather."""
    plan, diag = compose_into_einsum(a.plan, a.diag, b.plan, b.diag)
    return GatherStep(f"{a.name}+{b.name}", plan, diag)


def _peephole(steps: List[Step]) -> List[Step]:
    """v1 fusion: collapse runs of back-to-back gathers into one pass."""
    out: List[Step] = []
    for s in steps:
        if out and isinstance(s, GatherStep) and isinstance(out[-1],
                                                            GatherStep):
            out[-1] = _compose_gathers(out[-1], s)
        else:
            out.append(s)
    return out


# --------------------------------------------------------------------------
# v2 fusion: fold permutation passes across einsum boundaries
# --------------------------------------------------------------------------

def _spec_axes(spec: str) -> Tuple[str, str, str]:
    """Split an EinsumStep spec into (input, operand, output) subscripts
    with the batch ellipses stripped."""
    lhs, out = spec.split("->")
    ins, op = lhs.split(",")
    return ins.replace("...", ""), op.replace("...", ""), \
        out.replace("...", "")


def _row_equivariant(spec: str) -> bool:
    """True iff the einsum applies the same contraction to every row: the
    operand indexes no row axis (axes shared by input and output), and the
    contracted axes trail the rows in the input layout.  Such einsums
    commute with any permutation of whole rows."""
    ins, op, out = _spec_axes(spec)
    rows = [c for c in ins if c in out]
    contracted = [c for c in ins if c not in out]
    if not contracted or any(c in op for c in rows):
        return False
    first_contract = min(ins.index(c) for c in contracted)
    if not all(ins.index(c) < first_contract for c in rows):
        return False
    # output must keep the rows leading and in input order, so the flat
    # result is rows-major and a row permutation maps to cout-blocks.
    return out[:len(rows)] == "".join(rows)


def _row_aligned_perm(plan: ShufflePlan, rows: int,
                      cin: int) -> Optional[np.ndarray]:
    """If ``plan`` permutes whole ``cin``-sized rows without reordering
    inside them (``P[r*cin + i] == sigma(r)*cin + i``), return ``sigma``;
    else None."""
    if plan.n_out != rows * cin or not is_permutation(plan):
        return None
    gi = plan.gather_idx.reshape(rows, cin)
    base = gi[:, 0]
    if bool((base % cin).any()):
        return None
    if not bool((gi == base[:, None] + np.arange(cin)[None, :]).all()):
        return None
    return base // cin


def _step_out_len(step) -> Optional[int]:
    """Flat last-axis length a step produces, when statically known
    (None after a LambdaStep — host glue may reshape arbitrarily)."""
    if isinstance(step, GatherStep):
        return step.plan.n_out
    if isinstance(step, EinsumStep):
        return step.post.n_out if step.post is not None \
            else step.rows * step.cout
    return None


def _commute_row_perms(steps: List[Step],
                       in_len: Optional[int] = None) -> List[Step]:
    """Rule 1: sink row-aligned permutations through row-equivariant
    einsums.  ``[G_perm, E]`` becomes ``[E, G_rows]`` where ``G_rows``
    permutes the einsum *output* rows (granularity ``cout``) — pure data
    movement, computed at compile time, so outputs stay bit-identical.
    The emitted gather then meets whatever follows and is eligible for
    the gather∘gather peephole (or vanishes if the permutation was the
    identity, e.g. the haar-DWT polyphase window).

    Because the rule *moves* the gather instead of executing it in
    place, it only fires when the gather's source length is statically
    known (``in_len`` for the first step, the previous step's output
    length otherwise) and equals ``n_out`` — a prefix *selection* of a
    longer input must stay put."""
    out: List[Step] = []
    i = 0
    cur = in_len
    while i < len(steps):
        s = steps[i]
        nxt = steps[i + 1] if i + 1 < len(steps) else None
        if (isinstance(s, GatherStep) and s.diag is None
                and cur == s.plan.n_out
                and isinstance(nxt, EinsumStep)
                and _row_equivariant(nxt.spec)):
            sigma = _row_aligned_perm(s.plan, nxt.rows, nxt.cin)
            if sigma is not None:
                e = dataclasses.replace(nxt, folded=nxt.folded + (s.name,))
                out.append(e)
                if not bool(np.array_equal(sigma, np.arange(sigma.size))):
                    gi = (sigma[:, None] * e.cout
                          + np.arange(e.cout)[None, :]).ravel()
                    out.append(GatherStep(
                        f"{s.name}>>{e.name}",
                        ShufflePlan(gi.astype(np.int32),
                                    np.zeros(gi.size, np.int64),
                                    s.plan.width)))
                cur = _step_out_len(out[-1])
                i += 2
                continue
        out.append(s)
        cur = _step_out_len(s)
        i += 1
    return out


def _stream_fold(steps: List[Step],
                 in_len: Optional[int] = None) -> List[Step]:
    """Rule 2: absorb remaining pure-permutation gathers into the
    adjacent array pass as its stream-in (``pre``) or stream-out
    (``post``) shuffle.  The fabric applies these in lock-step with the
    array's operand stream — the folded plan still executes verbatim at
    runtime (same ops, no standalone pass), so this is safe even when
    the source length cannot be verified.  Identity gathers (no
    movement, no scale) are dropped outright — that *does* change the
    executed ops, so it additionally requires the statically-known
    source length to match (a prefix selection of a longer input is not
    an identity)."""
    out: List[Step] = []
    i = 0
    cur = in_len
    while i < len(steps):
        s = steps[i]
        if isinstance(s, GatherStep) and s.diag is None \
                and cur is not None and is_identity(s.plan, n_in=cur):
            i += 1
            continue
        nxt = steps[i + 1] if i + 1 < len(steps) else None
        if isinstance(s, GatherStep) and is_permutation(s.plan, n_in=cur) \
                and isinstance(nxt, EinsumStep):
            pre, pre_diag = compose_into_einsum(s.plan, s.diag,
                                                nxt.pre, nxt.pre_diag)
            out.append(dataclasses.replace(
                nxt, pre=pre, pre_diag=pre_diag,
                folded=nxt.folded + (s.name,)))
            cur = _step_out_len(out[-1])
            i += 2
            continue
        if isinstance(s, GatherStep) and is_permutation(s.plan, n_in=cur) \
                and s.diag is None and out \
                and isinstance(out[-1], EinsumStep) \
                and out[-1].post is None:
            out[-1] = dataclasses.replace(
                out[-1], post=s.plan, folded=out[-1].folded + (s.name,))
            cur = s.plan.n_out
            i += 1
            continue
        out.append(s)
        cur = _step_out_len(s)
        i += 1
    return out


def _fuse_steps(steps: List[Step], level: int,
                in_len: Optional[int] = None) -> List[Step]:
    """Run the fusion pipeline up to ``level``: 0 = op-by-op lowering,
    1 = gather∘gather composition, 2 = cross-einsum permutation folding
    (rule 1 commute, re-peephole, rule 2 stream fold).  ``in_len`` is
    the flat last-axis length entering the first step when statically
    known; the v2 rules that delete or relocate a gather only fire with
    a verified source length."""
    if level >= 1:
        steps = _peephole(steps)
    if level >= 2:
        steps = _commute_row_perms(steps, in_len)
        steps = _peephole(steps)
        steps = _stream_fold(steps, in_len)
    return steps


# --------------------------------------------------------------------------
# Reference DSP helpers shared with the streaming runtime
# --------------------------------------------------------------------------

def _biquad_coeffs(sp, b_static, a_static):
    """Resolve a biquad stage's (b, a): per-call learnable coefficients
    from a params dict (keys ``b`` / ``a``) with the compile-time taps as
    the fallback; from row-stacked params (:class:`~repro_torch.core.
    exec_ir.RowParams`) the ``(B, 3)`` coefficients, one row a batch
    row.  Shared by the offline lowering and the streaming IIR stage."""
    if isinstance(sp, RowParams):
        sp = sp.tree
    if isinstance(sp, dict) and ("b" in sp or "a" in sp):
        return sp.get("b", b_static), sp.get("a", a_static)
    return b_static, a_static


def biquad_apply(x: torch.Tensor, b, a, zi: Optional[torch.Tensor] = None):
    """Second-order IIR (transposed direct-form II), last axis = time.

    Matches ``scipy.signal.lfilter(b, a, x, zi=zi)`` semantics for 3-tap
    numerator/denominator: returns ``(y, zf)`` where ``zf`` is the final
    2-element filter state (leading axes batched).  ``b`` and ``a`` are
    ``(3,)``, or ``(B, 3)``: batch row i (the leading axis of ``x``)
    filtered with row i's coefficients, the JAX package's ``vmap`` of
    the filter over per-row params.  On the DLA the 3-tap
    feedforward half is an array FIR; the order-2 feedback recurrence runs
    on the scalar path — here both live in one Python loop over samples
    (the JAX package's ``lax.scan``; off the Fig-9 path).
    """
    b = torch.as_tensor(b, device=x.device).to(x.dtype)
    a = torch.as_tensor(a, device=x.device).to(x.dtype)
    b = b / a[..., :1]
    a = a / a[..., :1]

    def tap(c, i):
        # tap i: a scalar, or one a batch row broadcast over the row's
        # other axes
        c = c[..., i]
        return c.reshape(*c.shape, *(1,) * (x.ndim - 1 - c.ndim)) \
            if c.ndim else c
    b0, b1, b2, a1, a2 = (tap(b, 0), tap(b, 1), tap(b, 2), tap(a, 1),
                          tap(a, 2))
    if zi is None:
        zi = torch.zeros((*x.shape[:-1], 2), dtype=x.dtype, device=x.device)
    z0, z1 = zi[..., 0], zi[..., 1]
    ys = []
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = b0 * xn + z0
        z0, z1 = b1 * xn - a1 * yn + z1, b2 * xn - a2 * yn
        ys.append(yn)
    y = torch.stack(ys, dim=-1) if ys else torch.zeros_like(x)
    return y, torch.stack([z0, z1], dim=-1)


def ola_index(n_frames: int, frame: int, hop: int) -> np.ndarray:
    """Flat output position of every (frame, sample) overlap-add term
    (cached: one array per shape)."""
    return _cached_plan(
        "ola_index", (n_frames, frame, hop),
        lambda: (np.arange(n_frames)[:, None] * hop
                 + np.arange(frame)[None, :]).ravel().astype(np.int64))


def overlap_add(frames: torch.Tensor, hop: int,
                length: Optional[int] = None) -> torch.Tensor:
    """OLA of (..., F, frame) real frames at the given hop: one
    ``index_add_`` of every frame sample onto its output position."""
    n_frames, frame = frames.shape[-2], frames.shape[-1]
    natural = (n_frames - 1) * hop + frame
    idx = device_constant(ola_index(n_frames, frame, hop), frames.device,
                          torch.int64)
    flat = frames.reshape(*frames.shape[:-2], n_frames * frame)
    out = torch.zeros((*frames.shape[:-2], natural), dtype=flat.dtype,
                      device=flat.device)
    out.index_add_(out.ndim - 1, idx, flat)
    if length is None or length == natural:
        return out
    if length < natural:
        return out[..., :length]
    return F.pad(out, (0, length - natural))


def hann_window(n: int) -> np.ndarray:
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
            ).astype(np.float64)


def mel_filterbank_matrix(bins: int, sr: float, n_mels: int,
                          fmin: float = 0.0,
                          fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, bins) triangular HTK-mel filterbank over a one-sided
    spectrum with ``bins`` linear frequencies in [0, sr/2]."""
    fmax = fmax or sr / 2.0

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, bins)
    edges = mel2hz(np.linspace(hz2mel(fmin), hz2mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, bins))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - freqs) / max(hi - mid, 1e-9)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb.astype(np.float32)


# --------------------------------------------------------------------------
# Small plan builders
# --------------------------------------------------------------------------
# All go through the process plan cache (``plan_cache_get``, backend
# key ``None``): plans are static numpy artifacts fully determined by
# their arguments and treated as read-only everywhere (``tile_plan``
# derives, never mutates), so a service compiling many buckets of the
# same graph — or many graphs sharing a frame size — rebuilds each
# distinct plan once.  This is also what the plan-cache hit-rate
# instrumentation on the serving path observes.

def _cached_plan(kind: str, args: tuple, builder):
    from . import plan_cache_get
    return plan_cache_get(kind, args, builder)


def _frame_plan(length: int, frame: int, hop: int, width: int) -> ShufflePlan:
    def build():
        n_frames = 1 + (length - frame) // hop
        idx = (np.arange(n_frames)[:, None] * hop
               + np.arange(frame)[None, :]).astype(np.int32)
        return ShufflePlan(idx.ravel(), np.zeros(idx.size, np.int64), width)
    return _cached_plan("graph_frame", (length, frame, hop, width), build)


def _interleave_plan(n: int, width: int) -> ShufflePlan:
    """Real length-n -> interleaved complex [x0, 0, x1, 0, ...]: the zero
    imaginary parts are DPU pad constants."""
    def build():
        gi = np.full(2 * n, PAD, np.int32)
        gi[0::2] = np.arange(n)
        return ShufflePlan(gi, np.zeros(2 * n, np.int64), width)
    return _cached_plan("graph_interleave", (n, width), build)


def _deinterleave_plan(n: int, width: int) -> ShufflePlan:
    """Interleaved complex -> the n real parts."""
    def build():
        gi = (2 * np.arange(n)).astype(np.int32)
        return ShufflePlan(gi, np.zeros(n, np.int64), width)
    return _cached_plan("graph_deinterleave", (n, width), build)


def _fft_steps(name: str, n: int, frames: int, fused: bool, width: int,
               pre_diag: Optional[np.ndarray] = None) -> List[Step]:
    """Batched radix-2 FFT over ``frames`` interleaved length-2n rows
    (flat last axis of size frames*2n).  ``pre_diag`` is an elementwise
    scale applied to the *input* (sunk through the first gather)."""
    plan = _cached_plan(
        "fft", (n, fused, width),
        lambda: _sm.make_fft_plan(n, fuse_adjacent=fused, width=width))
    steps: List[Step] = []

    def _gather(tag, p, diag=None):
        steps.append(GatherStep(f"{name}.{tag}", tile_plan(p, frames, 2 * n),
                                diag))

    first = True

    def _sink(p: ShufflePlan) -> Optional[np.ndarray]:
        nonlocal first
        if not first or pre_diag is None:
            return None
        first = False
        tiled = tile_plan(p, frames, 2 * n)
        return np.where(tiled.gather_idx == PAD, 1.0,
                        pre_diag[np.clip(tiled.gather_idx, 0, None)])

    if not plan.fused:
        _gather("bitrev", plan.bitrev, _sink(plan.bitrev))
    for i, st in enumerate(plan.stages):
        _gather(f"s{i}.gather", st.gather, _sink(st.gather))
        steps.append(EinsumStep(
            f"{name}.s{i}.butterfly", "...fjbi,joi->...fjbo", st.twiddle,
            reshape_in=(frames, st.half, st.nb, 4), out_rank=4,
            rows=frames * st.half * st.nb, cin=4, cout=4))
        if st.scatter.n_out:
            _gather(f"s{i}.scatter", st.scatter)
    return steps


def _conj_pattern(n: int, frames: int) -> np.ndarray:
    """Elementwise sign flipping the imaginary lanes of interleaved data."""
    return np.tile(np.array([1.0, -1.0]), frames * n)


# --------------------------------------------------------------------------
# Stages and the graph builder
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    name: str
    kind: str
    inputs: Tuple[str, ...]
    params: Dict

    @property
    def frame_context(self) -> int:
        """Frames of temporal context this stage needs on each side (0 for
        pointwise stages; user-declared for DNN hooks with receptive field
        across frames).  The streaming runtime uses this for exactness."""
        return int(self.params.get("frame_context", 0))


# One lowered stage of the executable program (steps + DAG wiring +
# output type) — defined by the IR; the compiler builds these directly.
CompiledStage = StageProgram


class SignalGraph:
    """Builder for a DAG of DSP stages.  ``"input"`` names the graph input;
    every ``add_*`` method returns the stage name for chaining."""

    INPUT = _exec_ir.INPUT      # the IR's reserved graph-input name

    def __init__(self, name: str = "signal_graph"):
        self.name = name
        self.stages: Dict[str, Stage] = {}
        self._order: List[str] = []
        self._outputs: Optional[List[str]] = None
        self._plural = False          # True once outputs() was used
        self._taps: List[str] = []
        self._deadlines: Dict[str, float] = {}

    @property
    def _output(self) -> Optional[str]:
        """Primary declared output (back-compat spelling)."""
        return self._outputs[0] if self._outputs else None

    # -- construction -------------------------------------------------------
    def add(self, kind: str, name: str, inputs, **params) -> str:
        """Add a stage of ``kind`` reading from ``inputs`` (a stage name
        or tuple of names; ``"input"`` is the graph input).  The typed
        helpers below are thin wrappers over this.  Returns ``name``."""
        if isinstance(inputs, str):
            inputs = (inputs,)
        if name in self.stages or name == self.INPUT:
            raise ValueError(f"duplicate stage name {name!r}")
        for i in inputs:
            if i != self.INPUT and i not in self.stages:
                raise ValueError(f"unknown input {i!r} for stage {name!r}")
        self.stages[name] = Stage(name, kind, tuple(inputs), dict(params))
        self._order.append(name)
        return name

    def stft(self, name, inp=INPUT, frame=256, hop=128, window=True):
        """Hann-windowed STFT: real samples ``(..., T)`` -> complex frames
        ``(..., F, frame)`` with ``F = 1 + (T - frame) // hop``.
        ``window=False`` frames without the Hann taper.

        ``window="learnable"`` registers the taper as a learnable
        params-pytree entry (``{name: {"window": ...}}``, seeded with
        the Hann taper by :meth:`CompiledSignalGraph.init_params`):
        instead of baking the window into the framing gather's ``diag``,
        it is applied as a per-frame elementwise array pass so the
        window participates in autodiff — offline and streamed."""
        return self.add("stft", name, inp, frame=frame, hop=hop,
                        window=window)

    def istft(self, name, inp, hop=128, length=None):
        """Inverse STFT + overlap-add: complex frames ``(..., F, frame)``
        -> real samples.  ``length`` trims or zero-pads the natural
        ``(F - 1) * hop + frame`` output."""
        return self.add("istft", name, inp, hop=hop, length=length)

    def fft(self, name, inp):
        """Radix-2 FFT along the last axis (power-of-two length); real or
        complex input, complex output of the same suffix shape."""
        return self.add("fft", name, inp)

    def ifft(self, name, inp):
        """Inverse FFT along the last axis (complex input required),
        via conj -> FFT -> conj / n on the same butterfly plans."""
        return self.add("ifft", name, inp)

    def fir(self, name, inp, taps, phases=1):
        """Causal FIR filter over real samples (im2col gather + tap GEMM;
        Fig 3b).  ``phases > 1`` uses the multi-phase mapping that keeps
        all 8 PEs busy (offline only — streaming needs ``phases=1``).
        With ``phases=1`` the taps are a learnable params-pytree entry
        (``{name: {"taps": ...}}``); with ``phases > 1`` the learnable
        entry is the polyphase weight matrix (``{name: {"weights":
        ...}}``, shape ``(win_len, phases)`` — the phase-interleaved
        spreading of the taps, seeded from the declared taps).  Either
        way the declared taps seed
        :meth:`CompiledSignalGraph.init_params`."""
        return self.add("fir", name, inp,
                        taps=np.asarray(taps, np.float64), phases=phases)

    def iir_biquad(self, name, inp, b, a):
        """Second-order IIR section, ``scipy.signal.lfilter(b, a, x)``
        semantics with 3-tap ``b`` and ``a`` (normalized by ``a[0]``).
        Runs as a sequential loop on the scalar path.  ``b``/``a`` are a
        learnable params entry (``{name: {"b": ..., "a": ...}}``)."""
        b = np.asarray(b, np.float64)
        a = np.asarray(a, np.float64)
        if b.shape != (3,) or a.shape != (3,):
            raise ValueError("biquad needs 3-tap b and a")
        return self.add("iir_biquad", name, inp, b=b / a[0], a=a / a[0])

    def dct(self, name, inp):
        """Orthonormal DCT-II along the last axis: a plain dense GEMM
        against the transform matrix (Fig 3c — no shuffle traffic)."""
        return self.add("dct", name, inp)

    def dwt(self, name, inp, wavelet="haar"):
        """Single-level DWT (``haar`` or ``db2``): last axis ``n`` ->
        ``(n // 2, 2)`` with approx/detail on the trailing axis
        (polyphase window gather + filter-bank GEMM, Fig 3d)."""
        return self.add("dwt", name, inp, wavelet=wavelet)

    def magnitude(self, name, inp, onesided=False):
        """``abs`` of a complex stage; ``onesided=True`` keeps the first
        ``n // 2 + 1`` bins of the (symmetric) spectrum."""
        return self.add("magnitude", name, inp, onesided=onesided)

    def mel_filterbank(self, name, inp, sr, n_mels):
        """Triangular HTK-mel filterbank GEMM over one-sided magnitude
        bins: ``(..., F, bins)`` -> ``(..., F, n_mels)``.  The matrix is
        a learnable params entry (``{name: {"weights": ...}}``); the HTK
        triangles seed :meth:`CompiledSignalGraph.init_params`."""
        return self.add("mel_filterbank", name, inp, sr=sr, n_mels=n_mels)

    def mul(self, name, a, b):
        """Elementwise product of two stages (e.g. spectrum x mask);
        a real operand is cast to the complex operand's dtype."""
        return self.add("mul", name, (a, b))

    def dnn(self, name, inp, fn, frame_context=0, layers=(), init=None):
        """Model hook: ``fn(params, x)`` with ``x`` the input stage's value.
        ``frame_context`` declares the across-frame receptive field (for
        streaming); ``layers`` optionally lists perf_model.ConvLayer
        descriptors so the cycle report covers the DNN too; ``init``
        optionally declares the hook's initial params so
        :meth:`CompiledSignalGraph.init_params` includes this stage."""
        return self.add("dnn", name, inp, fn=fn,
                        frame_context=frame_context, layers=tuple(layers),
                        init=init)

    def dnn_circulant(self, name, inp, d_out, block=4, taps=None,
                      activation=None):
        """Block-circulant dense layer on the shared fabric + array path
        (PAPERS.md "FFT-Based Deep Learning Deployment in Embedded
        Systems"): the ``(d_out, d_in)`` weight matrix is constrained to
        b×b circulant blocks — ``taps (d_out/b, d_in/b, b)`` parameters,
        a b× reduction — and lowers as a duplicating im2col fabric plan
        plus ONE row-uniform GEMM, so the DL matmul runs through the
        same ``shuffle_gemm`` / ``bitserial_mm`` kernels as the DSP
        stages (see :mod:`repro_torch.precision.circulant` for the math and
        why the time-domain form beats the FFT-domain one here).

        Applies per frame along the last axis (framewise: streams with
        zero frame context).  ``taps=None`` seeds deterministic
        near-identity taps; the canonical GEMM operand is a learnable
        params entry (``{name: {"weights": ...}}`` — learning it *is*
        learning the taps).  ``activation`` optionally applies an
        elementwise nonlinearity after the layer."""
        return self.add("dnn_circulant", name, inp, d_out=int(d_out),
                        block=int(block),
                        taps=None if taps is None else np.asarray(taps),
                        activation=activation)

    def overlap_add(self, name, inp, hop=128, length=None):
        """Overlap-add real frames ``(..., F, frame)`` back to samples at
        ``hop`` (the iSTFT tail without the inverse FFT)."""
        return self.add("overlap_add", name, inp, hop=hop, length=length)

    def outputs(self, *names: str, deadline=None) -> None:
        """Declare the graph outputs: plural, ordered, named.  The
        compiled graph returns an ordered ``dict`` mapping each name to
        its value (the SigProgram contract shared by offline execution,
        the streaming runtime's chunks, and
        :class:`~repro_torch.serving.signal_service.SignalService` results).
        Stages feeding no declared output (or tap) are pruned from the
        compiled program; stages shared by several outputs are lowered
        once.

        ``deadline`` optionally attaches a latency hint in seconds —
        either one float (applies to the first output) or a mapping
        ``{output_name: seconds}``.  A deadline on a *deframed* (sample
        -domain) output makes the streaming runtime emit a cheap early
        tap: the framer stage joins the per-block frame taps, whose
        rows finalize ``context`` frames in — far ahead of the
        overlap-add stream's ``frame - hop + context*hop`` sample
        latency (see
        :meth:`~repro_torch.signal.streaming.StreamStructure.output_latencies`).
        Offline results are unchanged: the hint only shapes streaming
        emission."""
        if not names:
            raise ValueError("outputs() needs at least one stage name")
        for n in names:
            if n not in self.stages:
                raise ValueError(f"unknown output stage {n!r}")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate output names in {names!r}")
        self._outputs = list(names)
        self._plural = True
        self._deadlines = {}
        if deadline is not None:
            if isinstance(deadline, (int, float)):
                deadline = {names[0]: float(deadline)}
            for k, v in dict(deadline).items():
                if k not in names:
                    raise ValueError(
                        f"deadline hint for non-output stage {k!r}")
                self._deadlines[k] = float(v)

    def tap(self, stage: str) -> str:
        """Mark ``stage`` as a diagnostic tap: its value is appended to
        the compiled outputs (after the declared ones) under the stage's
        own name, without changing the primary outputs.  Tapping makes
        the result a ``dict`` even for graphs declared via the single
        ``output()`` spelling.  Returns ``stage`` for chaining."""
        if stage not in self.stages:
            raise ValueError(f"unknown tap stage {stage!r}")
        if stage not in self._taps:
            self._taps.append(stage)
        return stage

    def output(self, name: str) -> None:
        """Deprecated single-output spelling of :meth:`outputs`.  The
        compiled graph returns a bare array (not a dict) for graphs
        declared this way, preserving the pre-SigProgram contract."""
        if name not in self.stages:
            raise ValueError(f"unknown output stage {name!r}")
        warnings.warn(
            "SignalGraph.output(name) is deprecated; use "
            "SignalGraph.outputs(name, ...) — compiled graphs then "
            "return an ordered dict of named outputs",
            DeprecationWarning, stacklevel=2)
        self._set_outputs([name], plural=False)

    # -- output bookkeeping (shared with the streaming analysis) ------------
    def _set_outputs(self, names: List[str], plural: bool) -> None:
        """Internal, warning-free output declaration (the streaming
        runtime re-builds core graphs through this)."""
        for n in names:
            if n not in self.stages:
                raise ValueError(f"unknown output stage {n!r}")
        self._outputs = list(names)
        self._plural = plural

    def _declared_outputs(self) -> List[str]:
        """Ordered output names: declared outputs (default: the last
        added stage) followed by any taps not already declared."""
        outs = list(self._outputs) if self._outputs else (
            [self._order[-1]] if self._order else [])
        outs.extend(t for t in self._taps if t not in outs)
        return outs

    def _single_output(self) -> bool:
        """True when the compiled graph returns a bare array (the
        deprecated ``output()`` / default-last-stage contract)."""
        return not self._plural and not self._taps

    def _live_stages(self, out_names: Sequence[str]) -> set:
        """Stages reachable (as ancestors) from the declared outputs —
        everything else is dead code the compiler prunes."""
        live: set = set()
        stack = list(out_names)
        while stack:
            n = stack.pop()
            if n in live or n == self.INPUT:
                continue
            live.add(n)
            stack.extend(self.stages[n].inputs)
        return live

    # -- compilation --------------------------------------------------------
    def compile(self, length: int, fuse: "FuseLevel | int" = FuseLevel.STREAM,
                width: int = 16,
                backend="reference",
                device=DEFAULT_DEVICE) -> "CompiledSignalGraph":
        """Shape-specialize and lower the graph for input length ``length``.

        ``fuse`` selects the fusion level (a :class:`FuseLevel` or the
        equivalent int):

        * ``FuseLevel.NONE``   (0) — op-by-op lowering, one fabric pass
          per emitted gather (the unfused baseline in benchmarks/tests);
        * ``FuseLevel.GATHER`` (1) — v1: compose back-to-back gathers
          into one pass;
        * ``FuseLevel.STREAM`` (2, default) — v2: additionally fold
          pure-permutation passes across einsum boundaries into the
          adjacent array pass (see the module docstring).

        All levels produce bit-identical outputs; they differ only in
        how many standalone fabric passes the step list executes.
        (``True`` / ``False`` still coerce to STREAM / NONE with a
        ``DeprecationWarning``.)

        ``backend`` selects the execution backend consuming the lowered
        program (:mod:`repro_torch.signal.backends`): ``"reference"``
        (default) interprets the steps with plain torch ops;
        ``"hopper"`` lowers gather∘einsum groups onto the fused
        fabric+array CUDA kernels (:mod:`repro_torch.kernels`), whose
        plain PyTorch versions run for tensors on the CPU.  An
        :class:`~repro_torch.signal.backends.ExecBackend` instance is
        accepted for custom configurations.  The same argument threads
        through :class:`~repro_torch.serving.signal_service.SignalService`.

        ``device`` is where the compiled graph computes: ``"cuda"`` by
        default (raising ``RuntimeError`` on a host without a card),
        ``"cpu"`` when asked for.
        """
        dev = resolve_device(device)
        level = int(FuseLevel.coerce(fuse))
        out_names = self._declared_outputs()
        if not out_names:
            raise ValueError("empty graph")
        live = self._live_stages(out_names)
        types: Dict[str, SigType] = {
            self.INPUT: SigType((length,), False, "samples")}
        compiled: List[CompiledStage] = []

        for sname in self._order:
            if sname not in live:
                continue                      # multi-output DAG pruning
            st = self.stages[sname]
            in_types = [types[i] for i in st.inputs]
            combine, steps, out_t = _lower_stage(st, in_types, level > 0,
                                                 width)
            # flat last-axis length entering the stage's first step, when
            # statically known (complex values reach steps via an unpack
            # lambda, so their entry length is tracked as unknown).
            in_len = None if (not in_types or in_types[0].is_complex) \
                else in_types[0].suffix[-1]
            steps = _fuse_steps(steps, level, in_len)
            types[sname] = out_t
            compiled.append(CompiledStage(
                sname, st.inputs, combine, steps, out_t,
                extra_layers=tuple(st.params.get("layers", ())),
                frame_context=st.frame_context))

        return CompiledSignalGraph(self.name, compiled, tuple(out_names),
                                   types[self.INPUT],
                                   {n: types[n] for n in out_names},
                                   fuse=level,
                                   single=self._single_output(),
                                   backend=backend, device=dev)


# --------------------------------------------------------------------------
# Per-kind lowering
# --------------------------------------------------------------------------

def _flat_len(t: SigType) -> int:
    n = 1
    for d in t.suffix:
        n *= d
    return n


def _rows_last(t: SigType) -> Tuple[int, int]:
    rows = 1
    for d in t.suffix[:-1]:
        rows *= d
    return rows, t.suffix[-1]


def _require_real(st: Stage, t: SigType) -> None:
    if t.is_complex:
        raise ValueError(f"stage {st.name!r} ({st.kind}) needs real input")


def _require_flat(st: Stage, t: SigType) -> None:
    """Stages whose gathers/reshapes assume the suffix IS the last axis
    (fir, dwt, dct, real-input fft) reject multi-dim suffixes loudly:
    their plans index a flattened rows*n layout that a multi-dim value
    does not have, which would otherwise gather out of bounds and return
    garbage.  (Leading *batch* axes are fine — they are not part of the
    suffix.)"""
    if len(t.suffix) > 1:
        raise ValueError(
            f"stage {st.name!r} ({st.kind}) supports a 1-D suffix only, "
            f"got {t.suffix}; route through magnitude/mel-style stages "
            f"or reshape upstream")


def _lower_stage(st: Stage, in_types: List[SigType], fuse: bool,
                 width: int):
    """Returns (combine, steps, out_type)."""
    kind, p = st.kind, st.params
    t = in_types[0]

    if kind == "mul":
        def combine(a, b):
            return a * b.to(a.dtype) if (a.is_complex()
                                         and not b.is_complex()) \
                else a * b
        big = in_types[0] if in_types[0].elems >= in_types[1].elems \
            else in_types[1]
        return combine, [], big

    if kind == "stft":
        _require_real(st, t)
        _require_flat(st, t)
        frame, hop = p["frame"], p["hop"]
        length = t.suffix[-1]
        if length < frame:
            raise ValueError(
                f"stft stage {st.name!r}: input length {length} is shorter "
                f"than the frame size {frame}")
        n_frames = 1 + (length - frame) // hop
        steps: List[Step] = []
        learnable_win = p["window"] == "learnable"
        win = np.tile(hann_window(frame), n_frames) \
            if (p["window"] and not learnable_win) else None
        steps.append(GatherStep(f"{st.name}.frame",
                                _frame_plan(length, frame, hop, width), win))
        if learnable_win:
            # learnable taper: an elementwise per-frame array pass
            # instead of a baked framing diag, so the window is a
            # params entry ({name: {"window": ...}}) and autodiff sees
            # it.  The spec has no contraction, so both backends run it
            # on the plain torch path.
            steps.append(EinsumStep(
                f"{st.name}.window", "...fw,w->...fw",
                hann_window(frame).astype(np.float32),
                reshape_in=(n_frames, frame), out_rank=2,
                rows=n_frames * frame, cin=1, cout=1,
                param_key="window"))
        steps.append(GatherStep(
            f"{st.name}.interleave",
            tile_plan(_interleave_plan(frame, width), n_frames, frame)))
        steps.extend(_fft_steps(st.name, frame, n_frames, fuse, width))

        def to_complex(x):
            z = _sm.interleaved_to_complex(x)
            return z.reshape(*z.shape[:-1], n_frames, frame)
        steps.append(LambdaStep(f"{st.name}.pack", to_complex))
        return None, steps, SigType((n_frames, frame), True, "frames",
                                    frame=frame, hop=hop)

    if kind in ("istft", "istft_frames"):
        if t.domain != "frames" or not t.is_complex:
            raise ValueError("istft needs complex frames input")
        n_frames, frame = t.suffix
        hop = p["hop"]
        steps = [LambdaStep(
            f"{st.name}.unpack",
            lambda x: _sm.complex_to_interleaved(
                x).reshape(*x.shape[:-2], n_frames * 2 * frame))]
        steps.extend(_fft_steps(st.name, frame, n_frames, fuse, width,
                                pre_diag=_conj_pattern(frame, n_frames)))
        steps.append(GatherStep(
            f"{st.name}.deinterleave",
            tile_plan(_deinterleave_plan(frame, width), n_frames, 2 * frame),
            np.full(n_frames * frame, 1.0 / frame)))
        if kind == "istft_frames":
            steps.append(LambdaStep(
                f"{st.name}.frames",
                lambda x: x.reshape(*x.shape[:-1], n_frames, frame)))
            return None, steps, SigType((n_frames, frame), False, "frames",
                                        frame=frame, hop=hop)
        length = p.get("length")

        def ola(x):
            fr = x.reshape(*x.shape[:-1], n_frames, frame)
            return overlap_add(fr, hop, length)
        steps.append(LambdaStep(f"{st.name}.ola", ola))
        out_len = length or (n_frames - 1) * hop + frame
        return None, steps, SigType((out_len,), False, "samples")

    if kind == "overlap_add":
        _require_real(st, t)
        if t.domain != "frames":
            raise ValueError("overlap_add needs frames input")
        n_frames, frame = t.suffix
        hop, length = p["hop"], p.get("length")

        def ola2(x):
            return overlap_add(x, hop, length)
        out_len = length or (n_frames - 1) * hop + frame
        return None, [LambdaStep(f"{st.name}.ola", ola2)], \
            SigType((out_len,), False, "samples")

    if kind == "fft":
        n = t.suffix[-1]
        rows, _ = _rows_last(t)
        steps = []
        if t.is_complex:
            steps.append(LambdaStep(
                f"{st.name}.unpack",
                lambda x: _sm.complex_to_interleaved(x).reshape(
                    *x.shape[:-len(t.suffix)], rows * 2 * n)))
        else:
            _require_flat(st, t)
            steps.append(GatherStep(
                f"{st.name}.interleave",
                tile_plan(_interleave_plan(n, width), rows, n)))
        steps.extend(_fft_steps(st.name, n, rows, fuse, width))

        def pack(x):
            z = _sm.interleaved_to_complex(x)
            return z.reshape(*z.shape[:-1], *t.suffix[:-1], n)
        steps.append(LambdaStep(f"{st.name}.pack", pack))
        return None, steps, dataclasses.replace(t, is_complex=True)

    if kind == "ifft":
        if not t.is_complex:
            raise ValueError("ifft needs complex input")
        n = t.suffix[-1]
        rows, _ = _rows_last(t)
        steps = [LambdaStep(
            f"{st.name}.unpack",
            lambda x: _sm.complex_to_interleaved(x).reshape(
                *x.shape[:-len(t.suffix)], rows * 2 * n))]
        steps.extend(_fft_steps(st.name, n, rows, fuse, width,
                                pre_diag=_conj_pattern(n, rows)))

        def pack_inv(x):
            z = torch.conj(_sm.interleaved_to_complex(x)).resolve_conj() / n
            return z.reshape(*z.shape[:-1], *t.suffix[:-1], n)
        steps.append(LambdaStep(f"{st.name}.pack", pack_inv))
        return None, steps, t

    if kind == "fir":
        _require_real(st, t)
        _require_flat(st, t)
        h = p["taps"]
        taps, phases = h.shape[0], p["phases"]
        n = t.suffix[-1]
        if phases > 1:
            plan = _cached_plan(
                "fir_phase", (n, taps, phases, width),
                lambda: _sm.make_fir_phase_plan(n, taps, phases, width))
            W = _sm.fir_phase_weights(h, phases)
            steps = [
                GatherStep(f"{st.name}.window", plan.window),
                EinsumStep(f"{st.name}.taps", "...ml,lp->...mp", W,
                           reshape_in=(n // phases, plan.win_len), out_rank=2,
                           rows=n // phases, cin=plan.win_len, cout=phases,
                           param_key="weights")]
        else:
            plan = _cached_plan(
                "fir", (n, taps, width),
                lambda: _sm.make_fir_plan(n, taps, width))
            steps = [
                GatherStep(f"{st.name}.im2col", plan.im2col),
                EinsumStep(f"{st.name}.taps", "...nt,t->...n",
                           h.astype(np.float32), reshape_in=(n, taps),
                           out_rank=1, rows=n, cin=taps, cout=1,
                           param_key="taps")]
        return None, steps, t

    if kind == "iir_biquad":
        _require_real(st, t)
        b, a = p["b"], p["a"]

        def iir(sp, x):
            bb, aa = _biquad_coeffs(sp, b, a)
            y, _ = biquad_apply(x, bb, aa)
            return y
        return None, [LambdaStep(
            f"{st.name}.scan", iir, takes_params=True,
            param_init={"b": np.asarray(b, np.float32),
                        "a": np.asarray(a, np.float32)})], t

    if kind == "dct":
        _require_real(st, t)
        _require_flat(st, t)
        rows, n = _rows_last(t)
        C = _sm.dct_matrix(n)
        return None, [EinsumStep(f"{st.name}.dct", "...rn,kn->...rk", C,
                                 reshape_in=(rows, n), out_rank=2,
                                 rows=rows, cin=n, cout=n)], t

    if kind == "dwt":
        _require_real(st, t)
        _require_flat(st, t)
        rows, n = _rows_last(t)
        plan = _cached_plan(
            "dwt", (n, p["wavelet"], width),
            lambda: _sm.make_dwt_plan(n, p["wavelet"], width))
        fb = _sm.dwt_filters(p["wavelet"])
        steps = [
            GatherStep(f"{st.name}.window", tile_plan(plan.window, rows, n)),
            EinsumStep(f"{st.name}.bank", "...wl,lf->...wf", fb,
                       reshape_in=(rows * n // 2, plan.filt_len), out_rank=2,
                       rows=rows * n // 2, cin=plan.filt_len, cout=2)]
        out_suffix = (*t.suffix[:-1], n // 2, 2)

        def shape_dwt(x):
            return x.reshape(*x.shape[:-1], *out_suffix)
        steps.append(LambdaStep(f"{st.name}.pack", shape_dwt))
        return None, steps, dataclasses.replace(t, suffix=out_suffix)

    if kind == "magnitude":
        if not t.is_complex:
            raise ValueError("magnitude needs complex input")
        onesided = p["onesided"]
        n = t.suffix[-1]
        keep = n // 2 + 1 if onesided else n

        def mag(x):
            y = torch.abs(x)
            return y[..., :keep] if onesided else y
        out_suffix = (*t.suffix[:-1], keep)
        return None, [LambdaStep(f"{st.name}.abs", mag)], \
            dataclasses.replace(t, suffix=out_suffix, is_complex=False)

    if kind == "mel_filterbank":
        _require_real(st, t)
        rows, bins = _rows_last(t)
        M = mel_filterbank_matrix(bins, p["sr"], p["n_mels"])
        out_suffix = (*t.suffix[:-1], p["n_mels"])
        steps = [
            LambdaStep(f"{st.name}.flatten",
                       lambda x: x.reshape(*x.shape[:-len(t.suffix)], -1)),
            EinsumStep(f"{st.name}.mel", "...rb,mb->...rm", M,
                       reshape_in=(rows, bins), out_rank=2,
                       rows=rows, cin=bins, cout=p["n_mels"],
                       param_key="weights"),
            LambdaStep(f"{st.name}.pack",
                       lambda x: x.reshape(*x.shape[:-1], *out_suffix))]
        return None, steps, dataclasses.replace(t, suffix=out_suffix)

    if kind == "dnn":
        fn = p["fn"]
        return None, [LambdaStep(f"{st.name}.model", fn,
                                 takes_params=True,
                                 param_init=p.get("init"),
                                 row_params=True)], t

    if kind == "dnn_circulant":
        # Block-circulant dense layer as a duplicating im2col gather +
        # ONE row-uniform GEMM + a pure output permutation (folds into
        # the einsum's post shuffle at fuse=2) — the DL matmul on the
        # same kernels as every DSP stage.  Plan/operand math lives in
        # repro_torch.precision.circulant (imported lazily: precision
        # sits above the signal package).
        from ..precision.circulant import (circulant_gather_plan,
                                           circulant_init,
                                           circulant_operand,
                                           circulant_post_plan)
        _require_real(st, t)
        rows, d_in = _rows_last(t)
        b, d_out = p["block"], p["d_out"]
        if b < 1 or d_in % b or d_out % b:
            raise ValueError(
                f"dnn_circulant {st.name!r} needs block | d_in and "
                f"block | d_out; got block={b}, d_in={d_in}, "
                f"d_out={d_out}")
        nb_out = d_out // b
        taps = p.get("taps")
        if taps is None:
            taps = circulant_init(d_in, d_out, b)
        else:
            taps = np.asarray(taps, np.float64)
            if taps.shape != (nb_out, d_in // b, b):
                raise ValueError(
                    f"dnn_circulant {st.name!r} taps must have shape "
                    f"{(nb_out, d_in // b, b)}; got {taps.shape}")
        C = circulant_operand(taps)
        g_plan = _cached_plan(
            "circulant_im2col", (rows, d_in, b, width),
            lambda: circulant_gather_plan(rows, d_in, b, width))
        p_plan = _cached_plan(
            "circulant_post", (rows, b, nb_out, width),
            lambda: circulant_post_plan(rows, b, nb_out, width))
        out_suffix = (*t.suffix[:-1], d_out)
        steps = [
            LambdaStep(f"{st.name}.flatten",
                       lambda x: x.reshape(*x.shape[:-len(t.suffix)], -1)),
            GatherStep(f"{st.name}.im2col", g_plan),
            EinsumStep(f"{st.name}.gemm", "...rt,tj->...rj", C,
                       reshape_in=(rows * b, d_in), out_rank=2,
                       rows=rows * b, cin=d_in, cout=nb_out,
                       param_key="weights"),
            GatherStep(f"{st.name}.blockperm", p_plan),
            LambdaStep(f"{st.name}.pack",
                       lambda x: x.reshape(*x.shape[:-1], *out_suffix))]
        act = p.get("activation")
        if act is not None:
            steps.append(LambdaStep(f"{st.name}.act", act))
        return None, steps, dataclasses.replace(t, suffix=out_suffix)

    raise ValueError(f"unknown stage kind {kind!r}")


# --------------------------------------------------------------------------
# The compiled graph
# --------------------------------------------------------------------------
#
# ``_mask_frames`` (re-exported above) lives in core.exec_ir: masking is
# part of the shared program-walker semantics every backend inherits.


class CompiledSignalGraph:
    """Shape-specialized, lowered, (optionally) fused signal graph — the
    **SigProgram** artifact shared by offline execution and the serving
    layer.

    Calling it runs the whole pipeline as one function of ``(x, params)``
    on the graph's ``device``; all plans and operands are static compile
    artifacts, uploaded to the device once and reused by every call.
    Graphs declared with :meth:`SignalGraph.outputs` /
    :meth:`SignalGraph.tap` return an ordered ``dict`` mapping output
    name -> tensor; the deprecated single-``output()`` spelling returns
    the bare tensor (``single``).

    Learnable stage parameters (FIR taps, biquad ``b``/``a``, the mel
    matrix, dnn hooks with a declared ``init``) form a first-class params
    dict: :meth:`init_params` yields the compile-time defaults and every
    call accepts overrides per stage (numpy arrays or tensors).
    """

    def __init__(self, name: str, stages: List[CompiledStage],
                 outputs: Tuple[str, ...], in_type: SigType,
                 out_types: Dict[str, SigType], fuse: int,
                 single: bool = True, backend="reference",
                 device=DEFAULT_DEVICE):
        from .backends import get_backend
        self.name = name
        self.stages = stages
        self.outputs = tuple(outputs)
        self.output = self.outputs[0]     # primary (back-compat spelling)
        self.in_type = in_type
        self.out_types = dict(out_types)
        self.out_type = self.out_types[self.output]
        self.single = bool(single)
        self.fuse_level = int(fuse)   # 0 = unfused, 1 = gathers, 2 = v2
        self.fused = self.fuse_level > 0
        self.device = resolve_device(device)
        # the executable-program IR + its backend binding: the program is
        # the step sequence as data; the backend decides how each stage's
        # steps execute (plain torch interpretation vs fused CUDA kernels).
        self.program = ExecProgram(name, stages, self.outputs, in_type,
                                   self.out_types, self.single,
                                   self.fuse_level)
        self.backend = get_backend(backend)
        # fingerprint-keyed bind: structurally identical programs under
        # one backend configuration share a single lowering
        # (backends.bind_cached) — repeated compiles of the same
        # pipeline shape, and different registered graphs that lower to
        # the same core program, reuse one BoundProgram.  Bound units
        # are device-agnostic: device tensors are cached per device.
        from .backends import bind_cached
        self._exec = bind_cached(self.backend, self.program)

    def with_backend(self, backend) -> "CompiledSignalGraph":
        """The same lowered program bound to another execution backend
        (no re-lowering of the graph; plans and operands are shared)."""
        return CompiledSignalGraph(self.name, self.stages, self.outputs,
                                   self.in_type, self.out_types,
                                   fuse=self.fuse_level, single=self.single,
                                   backend=backend, device=self.device)

    def lowering_report(self) -> Dict:
        """Per-backend route attribution of the bound program: how many
        fabric passes were actually fused into array kernels vs emulated
        as plain gathers, and which kernel family each array pass took
        (surfaced by :func:`repro_torch.core.perf_model.signal_graph_report`
        as the ``backend`` section)."""
        return self._exec.report()

    def chain_report(self) -> List[Dict]:
        """The chains of grouped steps the backend runs one launch a
        segment (:meth:`~repro_torch.signal.backends.BoundProgram.
        chain_report`); empty for a backend that chains nothing."""
        return self._exec.chain_report()

    # -- execution ----------------------------------------------------------
    def _input(self, x) -> torch.Tensor:
        """``x`` as a tensor on the graph's device.  Host arrays are
        uploaded (float64 narrows to float32, the JAX package's default
        precision); a tensor must already live on the graph's device."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(
                    f"input is on {x.device}; this graph was compiled for "
                    f"{self.device}")
            return x
        arr = np.asarray(x)
        if arr.dtype == np.float64 or arr.dtype.kind in "iub":
            arr = arr.astype(np.float32)
        return torch.as_tensor(arr, device=self.device)

    def __call__(self, x, params=None, *, valid_frames=None):
        """Run the pipeline through the bound execution backend.
        Returns an ordered ``dict[str, Tensor]``
        (declaration order: outputs then taps) unless the graph used the
        deprecated single-``output()`` spelling, which returns the bare
        tensor.  ``valid_frames`` enables the masked /
        padded execution path used by length-bucketed serving: ``x`` is
        zero-padded past each row's true length, ``valid_frames`` is the
        per-row count of frames computed from real samples (an int array
        broadcastable over the batch axes), and every frames-domain stage
        output has its rows at index >= ``valid_frames`` zeroed.  Zeroed
        frames contribute exact ``+0.0`` terms to overlap-add and match
        the zero padding a SAME-padded conv sees at the signal boundary,
        so the valid region equals compiling at the true length."""
        x = self._input(x)
        if valid_frames is not None:
            valid_frames = torch.as_tensor(valid_frames, device=self.device)
        return self._exec(x, params, valid_frames)

    # -- the params dict -----------------------------------------------------
    def init_params(self) -> Dict[str, object]:
        """The compile-time defaults of every learnable stage, as the
        params dict :meth:`__call__` accepts: ``{stage_name: entry}``
        where the entry is a field dict for DSP stages (``{"taps": ...}``
        for fir, ``{"b": ..., "a": ...}`` for iir_biquad, ``{"weights":
        ...}`` for mel_filterbank) and the hook's declared ``init`` for
        dnn stages.  Stages without learnable parameters are absent;
        merge your own model params over the result."""
        params: Dict[str, object] = {}
        for st in self.stages:
            entry = None
            fields: Dict[str, np.ndarray] = {}
            for s in st.steps:
                if isinstance(s, EinsumStep) and s.param_key is not None:
                    fields[s.param_key] = np.array(s.operand)
                elif isinstance(s, LambdaStep) and s.param_init is not None:
                    entry = s.param_init
            if fields:
                entry = fields
            if entry is not None:
                params[st.name] = entry
        return params

    def value_and_grad(self, loss_fn: Callable, wrt=None,
                       has_aux: bool = False) -> Callable:
        """Autodiff surface of the SigProgram: returns
        ``fn(params, x, *args) -> (loss, grads)`` where ``loss_fn``
        receives this graph's outputs (the ordered dict, or the bare
        tensor for single-output graphs) plus ``*args`` and returns a
        scalar tensor.  ``wrt`` restricts differentiation to the named
        stages (default: every entry present in ``params``); gradients
        come back in the structure of the selected params — field dicts,
        lists (the mask CNN's weights), bare leaves — as tensors on the
        graph's device.  Host (numpy) leaves are uploaded there first,
        float64 narrowed to float32.  The gradient flows through the
        whole fabric lowering — gather plans are ``index_select`` s and
        folded ``diag`` scales carry their cotangents — so a learned FIR
        front-end or mel matrix trains exactly like the dnn hook.
        ``has_aux`` follows ``jax.value_and_grad``: ``loss_fn`` returns
        ``(scalar, aux)`` and ``fn`` returns ``((loss, aux), grads)``.

        Differentiation runs on the *bound* backend with
        ``torch.autograd.grad``: both ``reference`` and ``hopper``
        differentiate (the shuffle-GEMM kernels' backward passes launch
        the same kernels on adjoint operands —
        kernels/shuffle_gemm/vjp.py), so training and serving stay on
        one backend.  A backend declaring ``differentiable = False`` is
        a hard error here: training must never silently change which
        kernels execute — re-bind explicitly with :meth:`with_backend`
        if that is what you want."""
        names = None if wrt is None else tuple(wrt)
        if not self.backend.differentiable:
            raise ValueError(
                f"value_and_grad: backend {self.backend.name!r} declares "
                f"differentiable=False (its kernels define no "
                f"reverse-mode transpose); refusing to silently change "
                f"backends for the gradient path. Re-bind explicitly — "
                f"e.g. compiled.with_backend('reference') or "
                f"with_backend('hopper') — to pick the training backend.")
        run_graph = self

        def split(params):
            params = dict(params) if isinstance(params, dict) else \
                ({} if params is None else params)
            if not isinstance(params, dict):
                raise ValueError(
                    "value_and_grad needs a params dict keyed by stage "
                    f"name; got {type(params).__name__}")
            if names is None:
                return params, {}
            missing = [n for n in names if n not in params]
            if missing:
                raise ValueError(
                    f"wrt stages {missing!r} have no entry in params; "
                    f"available: {sorted(params)}")
            diff = {k: params[k] for k in names}
            rest = {k: v for k, v in params.items() if k not in names}
            return diff, rest

        def leaf(v):
            if isinstance(v, torch.Tensor):
                t = v.detach().to(self.device)
            else:
                arr = np.asarray(v)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                t = torch.as_tensor(arr, device=self.device)
            return t.requires_grad_(True)

        def fn(params, x, *args):
            diff, rest = split(params)
            diff = tree_map(leaf, diff)
            leaves = tree_leaves(diff)
            res = loss_fn(run_graph(x, {**rest, **diff}), *args)
            loss, aux = res if has_aux else (res, None)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            it = iter([torch.zeros_like(v) if g is None else g
                       for v, g in zip(leaves, grads)])
            grads = tree_map(lambda _: next(it), diff)
            loss = loss.detach()
            return ((loss, aux), grads) if has_aux else (loss, grads)
        return fn

    def jit(self):
        """The graph as a plain callable ``(x, params) -> outputs``:
        PyTorch runs eagerly, so there is nothing to trace (the JAX
        package's traced entry point)."""
        return self.__call__

    def masked_jit(self):
        """Masked entry point ``(x, valid_frames, params) -> y`` for
        length-bucketed execution: one compiled graph serves every mix
        of request lengths in the bucket."""
        def call(x, valid_frames, params=None):
            return self.__call__(x, params, valid_frames=valid_frames)
        return call

    def per_row(self, x, params, *, valid_frames=None):
        """Run the pipeline with ``params`` carrying a leading row axis on
        every leaf: batch row i of ``x`` computes with row i of each leaf,
        masked (``valid_frames``) or not — the JAX package's ``vmap`` of
        the row program over (row, params row), which the serving
        scheduler runs for a wave of graphs that registered different
        weights.  Every stage takes its rows' params: each kernel unit
        launches once for the batch with one operand a row (the
        row-uniform GEMM, the grouped GEMM, the chain and the int route's
        quantized GEMM on ``hopper``; a batched einsum on ``reference``
        and for the learnable window), a biquad filters each row with its
        own coefficients, and a dnn hook runs under ``torch.func.vmap``.
        A forward only on the card."""
        x = self._input(x)
        if valid_frames is not None:
            valid_frames = torch.as_tensor(valid_frames, device=self.device)
        return self._exec(x, params, valid_frames, row_params=True)

    def sharded_jit(self, mesh, batch_axis: str = "data"):
        """Batch-sharded entry point ``(x, params=None, *,
        valid_frames=None) -> outputs`` over a 1-D
        :class:`~repro_torch.launch.mesh.DataMesh` (or a
        :class:`~repro_torch.serving.signal_mesh.SignalMesh` 's): the
        input's rows (and ``valid_frames``, one count a row) split over
        the mesh's slots by :func:`~repro_torch.models.sharding.
        split_rows` — one block on the first slot when they do not
        divide —, params replicated (tensor leaves moved once to each
        slot's device and cached there for the params object last seen;
        host leaves upload through the per-device constant cache, as on
        an unsharded call), each slot's
        block run through this graph's bound lowering on its own device,
        and the outputs concatenated back in row order on the first
        slot's device.  Slots are called one after another from this
        process; on one device the call is this graph's own on all the
        rows."""
        from ..models.sharding import split_rows
        mesh = getattr(mesh, "mesh", mesh)
        if tuple(mesh.axis_names) != (batch_axis,):
            raise ValueError(f"sharded_jit needs a 1-D mesh over "
                             f"{batch_axis!r}; got axes {mesh.axis_names}")
        replicas: Dict[torch.device, Tuple[object, object]] = {}

        def on(dev, params):
            hit = replicas.get(dev)
            if hit is None or hit[0] is not params:
                hit = (params, tree_map(
                    lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                    else a, params))
                replicas[dev] = hit
            return hit[1]

        def call(x, params=None, *, valid_frames=None):
            x = x if isinstance(x, torch.Tensor) else self._input(x)
            xs = split_rows(mesh, x)
            vfs = (None,) * len(xs) if valid_frames is None else \
                split_rows(mesh, torch.as_tensor(valid_frames).reshape(-1))
            outs = []
            for xb, vb in zip(xs, vfs):
                dev = xb.device
                with torch.cuda.device(dev) if dev.type == "cuda" \
                        else contextlib.nullcontext():
                    outs.append(self._exec(xb, on(dev, params), vb))
            if len(outs) == 1:
                return outs[0]
            first = mesh.devices[0]
            if isinstance(outs[0], dict):
                return {k: torch.cat([o[k].to(first) for o in outs])
                        for k in outs[0]}
            return torch.cat([o.to(first) for o in outs])
        return call

    # -- accounting (consumed by perf_model.signal_graph_report) ------------
    def gather_steps(self) -> List[GatherStep]:
        """The standalone fabric passes (buffer -> fabric -> buffer)."""
        return [s for st in self.stages for s in st.steps
                if isinstance(s, GatherStep)]

    def einsum_steps(self) -> List[EinsumStep]:
        """The computing-array passes, in execution order."""
        return [s for st in self.stages for s in st.steps
                if isinstance(s, EinsumStep)]

    def fabric_pass_count(self) -> int:
        """Standalone fabric passes; v2-folded permutations ride the
        array passes and are NOT counted here."""
        return len(self.gather_steps())

    def array_pass_count(self) -> int:
        return len(self.einsum_steps())

    def shuffle_passes(self):
        from ..core.perf_model import ShufflePass
        return [ShufflePass(s.name, s.plan.n_out, s.plan.width)
                for s in self.gather_steps()]

    def streamed_shuffles(self):
        """One :class:`~repro_torch.core.perf_model.ShufflePass` per
        permutation the v2 pass folded into an array pass's stream-in /
        stream-out path.  These words still traverse the fabric but in
        lock-step with the array (no buffer round trip), so the perf
        report attributes them separately from ``shuffle_passes``."""
        from ..core.perf_model import ShufflePass
        out = []
        for s in self.einsum_steps():
            if s.pre is not None:
                out.append(ShufflePass(f"{s.name}.stream_in",
                                       s.pre.n_out, s.pre.width))
            if s.post is not None:
                out.append(ShufflePass(f"{s.name}.stream_out",
                                       s.post.n_out, s.post.width))
        return out

    def folded_pass_names(self) -> List[str]:
        """Names of the lowered passes absorbed by v2 folding (both the
        stream folds and the commuted/eliminated row permutations)."""
        return [n for s in self.einsum_steps() for n in s.folded]

    def conv_layers(self):
        from ..core.perf_model import ConvLayer
        out = []
        for st in self.stages:
            for s in st.steps:
                if isinstance(s, EinsumStep):
                    out.append(ConvLayer(s.name, h=s.rows, w=1, k=1,
                                         cin=s.cin, cout=s.cout))
            out.extend(st.extra_layers)
        return out

    def out_elems(self) -> int:
        """DRAM-stream elements across ALL outputs (the perf model's
        ``dram_out_elems``)."""
        return sum(t.elems for t in self.out_types.values())

    # -- per-output attribution ---------------------------------------------
    def _stage_reach(self) -> Dict[str, frozenset]:
        """For each compiled stage, the set of declared outputs its value
        reaches (itself included when it IS an output)."""
        consumers: Dict[str, List[str]] = {}
        for st in self.stages:
            for i in st.inputs:
                consumers.setdefault(i, []).append(st.name)
        reach: Dict[str, frozenset] = {}
        for st in reversed(self.stages):
            outs = {st.name} if st.name in self.outputs else set()
            for c in consumers.get(st.name, ()):
                outs |= reach[c]
            reach[st.name] = frozenset(outs)
        return reach

    def output_attribution(self) -> Dict[str, Dict]:
        """Fabric/array accounting bucketed by which output each lowered
        stage feeds: one entry per declared output covering the stages
        *exclusive* to it, plus a ``"shared"`` entry for stages feeding
        two or more outputs.  Because the compiler lowers every live
        stage exactly once, the shared prefix of a multi-output program
        is counted once here — compiling the same outputs separately
        would pay the shared counts per compile.  Consumed by
        :func:`repro_torch.core.perf_model.signal_graph_report` (its
        ``per_output`` field)."""
        import math as _math
        if "shared" in self.outputs:
            raise ValueError(
                "output_attribution reserves the bucket name 'shared'; "
                "rename the output stage 'shared' to attribute this graph")
        reach = self._stage_reach()
        buckets: Dict[str, Dict] = {
            name: dict(stages=[], fabric_passes=0, array_passes=0,
                       shuffle_words=0, streamed_words=0, macs=0)
            for name in (*self.outputs, "shared")}

        def words(plan) -> int:
            return _math.ceil(plan.n_out * plan.width / 64)

        for st in self.stages:
            outs = reach[st.name]
            b = buckets[next(iter(outs))] if len(outs) == 1 \
                else buckets["shared"]
            b["stages"].append(st.name)
            for s in st.steps:
                if isinstance(s, GatherStep):
                    b["fabric_passes"] += 1
                    b["shuffle_words"] += words(s.plan)
                elif isinstance(s, EinsumStep):
                    b["array_passes"] += 1
                    b["macs"] += s.rows * s.cin * s.cout
                    if s.pre is not None:
                        b["streamed_words"] += words(s.pre)
                    if s.post is not None:
                        b["streamed_words"] += words(s.post)
            b["macs"] += sum(l.macs for l in st.extra_layers)
        return buckets
