"""The GPU-side execution of SigDLA shuffle plans.

A :class:`ShufflePlan` is the compiled artifact of the programmable shuffling
fabric: a static gather-index map plus constant padding.  On the ASIC the
plan is an instruction stream driving 16 nibble-granular shuffle units; in
this PyTorch port the same plan is applied either

  * as an ``index_select`` on a cached device index tensor plus a PAD
    ``where``-fill (:func:`apply_plan`), or
  * inside the hand-written shuffle-GEMM CUDA kernel
    (:mod:`repro_torch.kernels.shuffle_gemm`), which gathers each row
    straight from the source vector on its way into the contraction.

The plan algebra (composition, tiling, classification, adjoints) is plain
numpy and identical to the JAX package's; only execution touches torch.
Equivalence of this fast path with the instruction-level semantics
(`shuffle_ir` + `shuffle_compiler`) is a tested invariant.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from .shuffle_compiler import PAD, run_plan_via_isa

__all__ = ["ShufflePlan", "PAD", "apply_plan", "apply_plan_np",
           "pad_plan_to_word", "concat_plans", "identity_plan",
           "fuse_plans", "tile_plan", "is_permutation", "is_identity",
           "block_perm_tile", "compose_into_einsum", "adjoint_plan",
           "device_constant"]


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """out[i] = in[gather_idx[i]] if gather_idx[i] != PAD else pad_values[i].

    ``width`` is the element bitwidth (4/8/16) used when the plan is lowered
    to the nibble-granular ISA; the tensor fast path is width-agnostic
    (element granularity).
    """
    gather_idx: np.ndarray   # (n_out,) int32
    pad_values: np.ndarray   # (n_out,) — same dtype domain as the data
    width: int = 16

    def __post_init__(self):
        gi = np.asarray(self.gather_idx, dtype=np.int32)
        pv = np.asarray(self.pad_values)
        if gi.shape != pv.shape or gi.ndim != 1:
            raise ValueError("gather_idx / pad_values must be equal-shape 1-D")
        object.__setattr__(self, "gather_idx", gi)
        object.__setattr__(self, "pad_values", pv)

    @property
    def n_out(self) -> int:
        return int(self.gather_idx.size)

    def elems_per_word(self) -> int:
        return 64 // self.width

    # -- composition helpers -------------------------------------------------
    def then(self, other: "ShufflePlan") -> "ShufflePlan":
        """Compose: apply self, then other (other indexes self's output)."""
        gi = np.where(other.gather_idx == PAD, PAD,
                      self.gather_idx[np.clip(other.gather_idx, 0, None)])
        pv = np.where(other.gather_idx == PAD, other.pad_values,
                      self.pad_values[np.clip(other.gather_idx, 0, None)])
        return ShufflePlan(gi, pv, self.width)

    # -- device side ---------------------------------------------------------
    def device_index(self, device) -> tuple:
        """``(index, pad_mask)`` on ``device``: the PAD-clipped int64
        gather index and the boolean PAD mask (``None`` when the plan has
        no PAD lane), built once per device and kept on the plan (plans
        are read-only after construction)."""
        cache = self.__dict__.setdefault("_device_index", {})
        key = str(torch.device(device))
        hit = cache.get(key)
        if hit is None:
            idx = torch.as_tensor(np.clip(self.gather_idx, 0, None)
                                  .astype(np.int64), device=device)
            pad = self.gather_idx == PAD
            mask = torch.as_tensor(pad, device=device) if pad.any() \
                else None
            hit = cache[key] = (idx, mask)
        return hit


def identity_plan(n: int, width: int = 16) -> ShufflePlan:
    return ShufflePlan(np.arange(n, dtype=np.int32), np.zeros(n, np.int64), width)


def concat_plans(*plans: ShufflePlan) -> ShufflePlan:
    """Concatenate plans that index the same source array."""
    width = plans[0].width
    gi = np.concatenate([p.gather_idx for p in plans])
    pv = np.concatenate([p.pad_values for p in plans])
    return ShufflePlan(gi, pv, width)


def fuse_plans(*plans: ShufflePlan) -> ShufflePlan:
    """Collapse a chain of back-to-back gathers into one fabric pass.

    ``fuse_plans(p1, p2, ..., pk)`` is the plan whose single application
    equals applying ``p1`` then ``p2`` ... then ``pk``.  This is the
    graph-compiler's workhorse (signal/graph.py): adjacent data-movement
    stages of a pipeline become one rd-buf/shuffle/wr-buf sequence instead
    of k round trips through the buffer.
    """
    out = plans[0]
    for p in plans[1:]:
        out = out.then(p)
    return out


def tile_plan(plan: ShufflePlan, reps: int, in_stride: int) -> ShufflePlan:
    """Block-diagonal replication: apply ``plan`` independently to ``reps``
    consecutive length-``in_stride`` segments of the source.  Output is the
    concatenation of the per-segment outputs.  Used to batch a per-frame
    plan (e.g. one FFT stage) over all frames of a framed signal while
    keeping it a single fabric pass."""
    gi = plan.gather_idx[None, :] + in_stride * np.arange(reps)[:, None]
    gi = np.where(plan.gather_idx[None, :] == PAD, PAD, gi)
    pv = np.broadcast_to(plan.pad_values, (reps, plan.n_out))
    return ShufflePlan(gi.ravel().astype(np.int32), pv.ravel().copy(),
                       plan.width)


# --------------------------------------------------------------------------
# Plan classification (consumed by the SignalGraph v2 fusion pass)
# --------------------------------------------------------------------------

def is_permutation(plan: ShufflePlan,
                   n_in: Optional[int] = None) -> bool:
    """True iff the plan is a pure permutation of its input: no DPU pad
    constants and every source element read exactly once.

    Pure permutations are exactly the plans the fabric can execute in
    *stream mode* — reordering the buffer->array stream in lock-step with
    the consuming array pass instead of materializing an intermediate in
    the buffer.  Plans that duplicate sources (framing at hop < frame,
    im2col) or inject pad constants still need the write-back pass, since
    a streamed element can feed the array only once.

    A :class:`ShufflePlan` does not record its source length, so a plan
    whose indices happen to cover ``[0, n_out)`` of a *longer* input (a
    prefix selection) is indistinguishable from a true permutation here.
    Pass ``n_in`` when the caller knows the source length to close that
    hole — required before any transform that would *drop* or *reorder
    around* the plan rather than still executing it verbatim.
    """
    gi = plan.gather_idx
    if gi.size == 0 or bool((gi == PAD).any()):
        return False
    if n_in is not None and int(n_in) != gi.size:
        return False
    return bool(np.array_equal(np.sort(gi), np.arange(gi.size)))


def is_identity(plan: ShufflePlan, n_in: Optional[int] = None) -> bool:
    """True iff the plan moves nothing: ``out == in`` elementwise.
    Same source-length caveat as :func:`is_permutation` — a prefix
    selection of a longer input looks like an identity; pass ``n_in``
    before treating the plan as droppable."""
    gi = plan.gather_idx
    if gi.size == 0 or bool((gi == PAD).any()):
        return False
    if n_in is not None and int(n_in) != gi.size:
        return False
    return bool(np.array_equal(gi, np.arange(gi.size)))


def block_perm_tile(plan: ShufflePlan) -> Optional[int]:
    """Smallest tile size ``t`` (a divisor of ``n_out``) such that the plan
    is a block-diagonal permutation over independent ``t``-sized tiles;
    ``None`` if the plan is not a permutation at all.

    ``t`` bounds the reorder window the fabric needs in stream mode:
    ``tile_plan`` of a per-frame permutation reports the frame stride,
    while ``t == n_out`` means the permutation is global.  ``t == 1`` is
    the identity.
    """
    if not is_permutation(plan):
        return None
    n = plan.n_out
    pos = np.arange(n)
    for t in range(1, n + 1):
        if n % t:
            continue
        if bool((plan.gather_idx // t == pos // t).all()):
            return t
    return n  # unreachable: t == n always satisfies the check


def compose_into_einsum(plan: ShufflePlan, diag,
                        pre: Optional[ShufflePlan], pre_diag):
    """Fold a standalone (plan, diag) fabric pass into the stream-in
    shuffle of a downstream array pass that already carries
    ``(pre, pre_diag)``.

    Returns the composed ``(pre, pre_diag)``: the earlier plan is applied
    first, so ``pre`` indexes its output, and the earlier diag sinks
    through ``pre``'s gather (pad lanes keep their DPU constants, scale 1).
    This is the plan/scale algebra behind both the v1 gather∘gather
    peephole and the v2 permutation folding in signal/graph.py.
    """
    if pre is None:
        # identity stream-in: scales compose elementwise in plan-output
        # space (an existing pre_diag without a pre plan must not drop).
        if diag is None and pre_diag is None:
            return plan, None
        d = (np.asarray(diag) if diag is not None else 1.0) \
            * (np.asarray(pre_diag) if pre_diag is not None else 1.0)
        return plan, d
    fused = fuse_plans(plan, pre)
    new_diag = None
    if diag is not None or pre_diag is not None:
        d1 = np.asarray(diag) if diag is not None else np.ones(plan.n_out)
        sunk = np.where(pre.gather_idx == PAD, 1.0,
                        d1[np.clip(pre.gather_idx, 0, None)])
        new_diag = sunk * (np.asarray(pre_diag) if pre_diag is not None
                           else 1.0)
    return fused, new_diag


def adjoint_plan(plan: ShufflePlan, n_in: int, diag=None):
    """Transpose of a gather, expressed as another gather
    (scatter-as-gather).

    The forward fabric pass computes ``out[p] = diag[p] * in[idx[p]]``
    (pad lanes read a constant), so its linear transpose is the scatter
    ``d_in[j] = sum_{p : idx[p] == j} diag[p] * d_out[p]``.  The fabric
    has no scatter primitive — but a scatter with bounded multiplicity
    IS a gather of the inverse index map followed by a width-``m``
    reduction, where ``m`` is the largest read multiplicity of any
    source element.  Returns ``(adj, adj_diag, m)``:

      * ``adj`` — an ``(n_in * m,)`` plan over the forward *output*
        space: row ``j`` gathers the (up to ``m``) forward positions
        that read source ``j``, PAD-filled (pad value 0, so absent
        slots contribute nothing to the reduction);
      * ``adj_diag`` — the forward ``diag`` routed to the gathered
        positions (``None`` when ``diag`` is ``None``);
      * ``m`` — the reduction width: summing each row of the
        ``(n_in, m)``-reshaped gathered cotangent yields ``d_in``.

    Forward pad lanes are constants with zero cotangent flow; they
    simply do not appear in ``adj``.  The shuffle-GEMM kernels' backward
    (``kernels/shuffle_gemm/vjp.py``) runs this adjoint on the same
    kernels as the forward.
    """
    gi = np.asarray(plan.gather_idx)
    valid = gi != PAD
    pos = np.nonzero(valid)[0]
    srcs = gi[valid].astype(np.int64)
    if srcs.size and (int(srcs.min()) < 0 or int(srcs.max()) >= n_in):
        raise ValueError(
            f"plan reads indices outside [0, {n_in}): "
            f"[{srcs.min()}, {srcs.max()}]")
    order = np.argsort(srcs, kind="stable")
    srcs, pos = srcs[order], pos[order]
    counts = np.bincount(srcs, minlength=n_in)
    m = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.zeros(n_in, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(srcs.size, dtype=np.int64) - starts[srcs]
    adj_gi = np.full((n_in, m), PAD, np.int32)
    adj_gi[srcs, slot] = pos
    adj = ShufflePlan(adj_gi.ravel(),
                      np.zeros(n_in * m, np.float64), plan.width)
    adj_diag = None
    if diag is not None:
        d = np.asarray(diag)
        ad = np.zeros((n_in, m), d.dtype if d.dtype.kind == "f"
                      else np.float64)
        ad[srcs, slot] = d[pos]
        adj_diag = ad.ravel()
    return adj, adj_diag, m


def pad_plan_to_word(plan: ShufflePlan) -> ShufflePlan:
    """Extend a plan with zero-padding so it fills whole 64-bit words (the
    granularity required by the ISA lowering)."""
    per_word = plan.elems_per_word()
    rem = (-plan.n_out) % per_word
    if rem == 0:
        return plan
    gi = np.concatenate([plan.gather_idx, np.full(rem, PAD, np.int32)])
    pv = np.concatenate([plan.pad_values, np.zeros(rem, plan.pad_values.dtype)])
    return ShufflePlan(gi, pv, plan.width)


# --------------------------------------------------------------------------
# Device constants
# --------------------------------------------------------------------------
#
# Plans, diag scales and einsum operands are static numpy arrays; every
# execution needs them as tensors on the compute device.  ``device_constant``
# uploads each array once per (device, dtype) and hands back the cached
# tensor afterwards.  Entries are keyed by the array's identity and hold a
# reference to it, so an id can never be reused while its entry lives; the
# arrays are compile artifacts that nothing mutates.

_DEVICE_CONSTS: "collections.OrderedDict" = collections.OrderedDict()
_DEVICE_CONSTS_MAX = 4096


def device_constant(arr, device, dtype) -> torch.Tensor:
    """``arr`` as a tensor of ``dtype`` on ``device``.  Tensors pass
    through ``Tensor.to``; numpy arrays are uploaded once and cached."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype)
    key = (id(arr), str(torch.device(device)), dtype)
    hit = _DEVICE_CONSTS.get(key)
    if hit is not None and hit[0] is arr:
        _DEVICE_CONSTS.move_to_end(key)
        return hit[1]
    t = torch.as_tensor(np.asarray(arr), device=device).to(dtype)
    _DEVICE_CONSTS[key] = (arr, t)
    while len(_DEVICE_CONSTS) > _DEVICE_CONSTS_MAX:
        _DEVICE_CONSTS.popitem(last=False)
    return t


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

def apply_plan(x: torch.Tensor, plan: ShufflePlan,
               pad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tensor fast path.  Applies the plan along the *last* axis of ``x``;
    leading axes are batch: an ``index_select`` on the plan's cached
    device index, then the PAD lanes take their constants."""
    idx, mask = plan.device_index(x.device)
    gathered = torch.index_select(x, -1, idx)
    if mask is None:
        return gathered
    pads = device_constant(plan.pad_values, x.device, pad_dtype or x.dtype)
    return torch.where(mask, pads.to(gathered.dtype), gathered)


def apply_plan_np(x: np.ndarray, plan: ShufflePlan) -> np.ndarray:
    """Pure-numpy element-level oracle (width-agnostic)."""
    idx = np.clip(plan.gather_idx, 0, None)
    out = np.take(x, idx, axis=-1)
    mask = plan.gather_idx == PAD
    out[..., mask] = plan.pad_values[mask]
    return out


def apply_plan_via_isa(x: np.ndarray, plan: ShufflePlan):
    """Full nibble-granular ISA execution (compile -> engine).  Integer data
    only; returns (out, CycleReport).  Used by tests and the perf model."""
    p = pad_plan_to_word(plan)
    out, cycles = run_plan_via_isa(np.asarray(x).ravel(), p.gather_idx,
                                   p.pad_values, p.width)
    return out[:plan.n_out], cycles
