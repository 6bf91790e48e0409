"""Streaming execution of :class:`~repro_torch.signal.graph.SignalGraph`.

Real serving traffic arrives as chunks, not whole utterances.  This module
has three layers, as the JAX package's ``signal/streaming.py``:

  * :class:`StreamStructure` — the *analysis* of a graph into the
    streamable shape ``sample pre-chain -> stft -> framewise core ->
    istft -> sample post-chain`` (any prefix of that shape).  The
    structure owns the per-block core-graph compile cache, keyed by
    ``(n_frames, fuse, backend.cache_key, device)``, so many connections
    over the same graph share one set of compiled programs and a CPU
    runner never receives a card runner's program.  The serving layer
    also uses it to decide length-bucketing legality and to compute
    per-request valid-frame counts / output lengths.
  * :class:`StreamState` — the carried state of ONE connection: tensors
    (FIR ring carries, IIR state vectors, the sample ring buffer, the
    overlap-add tail) plus host-side counters.  States of lock-stepped
    connections stack / unstack across a leading batch axis
    (:func:`stack_states` / :func:`unstack_states`), and the pure step
    functions (:func:`push_chunk`, :func:`ready_spec`,
    :func:`take_block`, :func:`commit_frames`, :func:`finalize_piece`)
    let a scheduler interleave and batch the core computation of many
    connections — ``SignalService.stream_step`` stacks same-shape
    blocks from concurrent sessions into ONE core call.
    :func:`snapshot_state` / :func:`restore_state` copy a state to host
    numpy and back onto a device (service checkpoints).
  * :class:`StreamingRunner` — the single-connection wrapper
    (``process`` / ``flush``) over those pieces.

The runtime carries the **SigProgram multi-output contract**: graphs
declared with :meth:`SignalGraph.outputs` / :meth:`SignalGraph.tap`
stream a dict per call — the deframed sample stream, frame taps on the
framewise core (emitted as their block's frames become final, the DNN
``context`` of lookahead held back), and causal chain taps on the
pre-chain (zero latency).  :meth:`StreamStructure.output_latencies`
reports the per-output delay; one per-block core program serves the
deframed stream and every frame tap.  Per-call ``params`` (learnable FIR
taps / biquad coefficients / mel matrices / dnn params) thread through
both the sample chains and the core, and gradients flow through the
carried state with ``torch.autograd`` (inside one runner: the state's
tensors keep their history until the runner is dropped).

The per-stage state the DSP math needs:

  * FIR stages carry the last ``taps-1`` input samples, so chunk-boundary
    windows equal the offline im2col windows;
  * IIR biquad stages carry their order-2 state vector across chunks;
  * the STFT->...->iSTFT core keeps a sample ring buffer for hop
    continuity plus an overlap-add tail accumulator, and re-reads
    ``frame_context`` frames of lookback so DNN stages with across-frame
    receptive fields see the same context they would offline.

**What streaming matches.**  The sample chains run outside the compiled
core, as in the JAX package: a FIR stage is a gather plus an ``einsum``
and an IIR stage :func:`~repro_torch.signal.graph.biquad_apply`, on the
plain torch path, where the offline compile runs the FIR taps on the
backend (``shuffle_gemm_blocks`` on ``hopper``).  So a streamed graph
with a FIR stage equals its offline compile to float32 rounding, and the
framewise core to the rounding of a row-count-dependent contraction (the
mask CNN's convolution, the CPU's batched matmuls); the overlap-add of
hop >= frame/2 sums two terms a sample in either order, exactly.  The
tests hold streamed outputs to atol 1e-5.  On ``hopper`` a block's
core launches the shuffle-GEMM kernels at ``n_frames`` frames a batch
row (the mel filterbank on ``shuffle_gemm_blocks``, the STFT and iSTFT
butterflies one ``shuffle_gemm_chain`` launch each); the chain plans and
tables are built once per core compile.

A sample ``s`` is emitted once no future frame can touch it, so the
runner's latency is ``frame - hop`` samples plus ``frame_context * hop``
for DNN lookahead; everything else is pipelined per chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..core.fabric import device_constant
from ..device import DEFAULT_DEVICE, resolve_device
from .graph import (CompiledSignalGraph, FuseLevel, SignalGraph,
                    _biquad_coeffs, biquad_apply, overlap_add)

__all__ = ["StreamingRunner", "StreamState", "StreamStructure", "BlockSpec",
           "stack_states", "unstack_states", "drain_state", "tap_rows",
           "snapshot_state", "restore_state"]

_SAMPLE_KINDS = ("fir", "iir_biquad")
_FRAMEWISE_KINDS = ("dnn", "dnn_circulant", "magnitude", "mel_filterbank",
                    "mul", "dct", "fft", "ifft")


# --------------------------------------------------------------------------
# Stateful sample-domain stages (pure transforms with explicit carry)
# --------------------------------------------------------------------------

class _FIRStage:
    """Causal FIR over chunks: the carry is the last ``taps-1`` inputs.
    Per-call params (``{"taps": ...}``) override the compile-time taps,
    matching the offline graph's learnable-operand contract."""

    def __init__(self, stage):
        if stage.params.get("phases", 1) != 1:
            raise ValueError("streaming supports fir with phases=1 only")
        self.h = np.asarray(stage.params["taps"], np.float32)

    def init(self, x: torch.Tensor) -> torch.Tensor:
        taps = self.h.shape[0]
        return torch.zeros((*x.shape[:-1], taps - 1), dtype=x.dtype,
                           device=x.device)

    def apply(self, carry, x, sp=None):
        h = sp["taps"] if isinstance(sp, dict) and "taps" in sp else self.h
        taps = self.h.shape[0]
        block = torch.cat([carry, x], dim=-1) if taps > 1 else x
        n = x.shape[-1]
        # window i covers block[taps-1+i-t] for t in 0..taps-1 — the
        # offline im2col + einsum contraction.
        idx = ((taps - 1) + np.arange(n)[:, None]
               - np.arange(taps)[None, :])
        cols = block[..., torch.as_tensor(idx, device=block.device)]
        y = torch.einsum("...nt,t->...n", cols,
                         device_constant(h, cols.device, cols.dtype))
        carry = block[..., -(taps - 1):] if taps > 1 else carry
        return carry, y


class _IIRStage:
    """Second-order IIR: the carry is the 2-element filter state.
    Per-call params (``{"b": ..., "a": ...}``) override the compile-time
    coefficients."""

    def __init__(self, stage):
        self.b = stage.params["b"]
        self.a = stage.params["a"]

    def init(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((*x.shape[:-1], 2), dtype=x.dtype,
                           device=x.device)

    def apply(self, carry, x, sp=None):
        b, a = _biquad_coeffs(sp, self.b, self.a)
        y, zf = biquad_apply(x, b, a, carry)
        return zf, y


def _make_sample_stage(stage):
    return _FIRStage(stage) if stage.kind == "fir" else _IIRStage(stage)


def _stage_params(params, name):
    """The per-stage params entry, mirroring the compiled graph's
    lookup: dict params index by stage name, anything else passes
    through whole (the legacy single-model spelling)."""
    return (params or {}).get(name) if isinstance(params, dict) else params


def _apply_chain(stages: Sequence, names: Sequence[str], carries: Tuple,
                 x: torch.Tensor, params=None, collect=()):
    """Run a sample-domain chain, threading (and lazily initializing)
    the per-stage carries.  ``params`` supplies per-stage learnable
    overrides; stages named in ``collect`` have their output captured
    (chain taps) and returned as a dict."""
    if stages and not carries:
        carries = tuple(s.init(x) for s in stages)
    new = []
    taps: Dict[str, torch.Tensor] = {}
    for s, name, c in zip(stages, names, carries):
        c, x = s.apply(c, x, _stage_params(params, name))
        if name in collect:
            taps[name] = x
        new.append(c)
    return tuple(new), x, taps


def _as_input(chunk, device: torch.device) -> torch.Tensor:
    """A chunk as a tensor on ``device``: tensors move (keeping their
    type), host arrays upload, float64 and integers narrowed to float32
    as the compiled graph's input is."""
    if isinstance(chunk, torch.Tensor):
        return chunk.to(device)
    arr = np.asarray(chunk)
    if arr.dtype == np.float64 or arr.dtype.kind in "iub":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


# --------------------------------------------------------------------------
# Carried state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StreamState:
    """Carried state of one streaming connection.

    Tensor leaves (``pre`` / ``post`` carries, sample ring buffer ``buf``,
    overlap-add ``tail``) sit beside the host-side counters (absolute
    buffer offset, samples received, next frame, samples emitted) — plain
    ints, so deciding a block never reads the device.  Two states stack
    with :func:`stack_states` exactly when their counters agree, i.e. when
    the connections are in lock-step.
    """

    pre: Tuple = ()
    post: Tuple = ()
    buf: Optional[torch.Tensor] = None
    tail: Optional[torch.Tensor] = None
    buf_start: int = 0
    total: int = 0
    f_next: int = 0
    emitted: int = 0
    batch_shape: Tuple[int, ...] = ()


def _state_counters(s: StreamState) -> Tuple:
    return (s.buf_start, s.total, s.f_next, s.emitted, s.batch_shape)


def _map_state(fn, *states: StreamState) -> StreamState:
    """``fn`` over the corresponding leaves of ``states`` (None leaves stay
    None), counters from the first — the JAX package's pytree map over a
    registered ``StreamState``."""
    def leaf(*xs):
        return None if xs[0] is None else fn(*xs)
    first = states[0]
    return dataclasses.replace(
        first,
        pre=tuple(leaf(*xs) for xs in zip(*(s.pre for s in states))),
        post=tuple(leaf(*xs) for xs in zip(*(s.post for s in states))),
        buf=leaf(*(s.buf for s in states)),
        tail=leaf(*(s.tail for s in states)))


def stack_states(states: Sequence[StreamState]) -> StreamState:
    """Stack lock-stepped connection states along a new leading batch
    axis.  All counters (and the None-ness of every leaf) must agree."""
    first = _state_counters(states[0])
    shape = [(s.buf is None, s.tail is None, len(s.pre), len(s.post))
             for s in states]
    for s, sh in zip(states[1:], shape[1:]):
        if _state_counters(s) != first or sh != shape[0]:
            raise ValueError("stack_states needs lock-stepped states "
                             "(matching counters)")
    return _map_state(lambda *xs: torch.stack(xs), *states)


def unstack_states(state: StreamState, n: int) -> List[StreamState]:
    """Inverse of :func:`stack_states`."""
    return [_map_state(lambda x, i=i: x[i], state) for i in range(n)]


def snapshot_state(state: StreamState) -> StreamState:
    """Deep host-side copy of a connection's carried state: every tensor
    leaf becomes an owned numpy array, detached from any autograd
    history (the host counters ride along).  The snapshot is independent
    of the device — restoring it (:func:`restore_state`; service-level
    checkpoint/restore in ``SignalService.checkpoint``) reproduces the
    stream exactly."""
    return _map_state(lambda a: a.detach().cpu().numpy().copy()
                      if isinstance(a, torch.Tensor) else np.array(a), state)


def restore_state(snap: StreamState, device=DEFAULT_DEVICE) -> StreamState:
    """Rebuild tensors on ``device`` (the card unless the caller names
    the CPU; raises on a host without a card) from a
    :func:`snapshot_state` host copy; the tensors own their memory, so
    one snapshot restores any number of times."""
    dev = resolve_device(device)
    return _map_state(lambda a: torch.tensor(np.asarray(a), device=dev),
                      snap)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One core-graph execution: frames ``[f_lo, f_hi)`` become final,
    computed from buffered frames ``[g0, g1]`` (context included).
    ``lo:hi`` is the slice of the current ring buffer to feed."""

    f_lo: int
    f_hi: int
    g0: int
    g1: int
    lo: int
    hi: int
    f_avail: int

    @property
    def count(self) -> int:
        return self.f_hi - self.f_lo

    @property
    def n_frames(self) -> int:
        return self.g1 - self.g0 + 1

    @property
    def block_len(self) -> int:
        return self.hi - self.lo


# --------------------------------------------------------------------------
# Graph analysis (shared by StreamingRunner and SignalService)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StreamStructure:
    """Streamable decomposition of a :class:`SignalGraph`:
    ``input -> pre (fir/iir) -> stft -> framewise core -> istft ->
    post (fir/iir) -> output`` — every piece optional from the outside
    in.  Graphs with a framer but no deframer (e.g. stft -> magnitude ->
    mel feature frontends) analyze fine and are length-bucketable, but
    only deframed graphs stream sample-wise.

    Raises ``ValueError`` for graphs outside this shape (multiple
    framers, non-streamable stages in a sample chain, global transforms
    over raw samples like ``dct``/``fft``/``dwt`` on the input axis) —
    such graphs neither stream nor bucket: their math is not local in
    time, so padded execution could not be masked back to exactness.
    """

    graph: SignalGraph
    pre_names: List[str]
    core_names: List[str]
    post_names: List[str]
    framer: Optional[str]
    deframer: Optional[str]
    frame: int
    hop: int
    context: int
    out_length: Optional[int]
    output: str
    outputs: List[str] = dataclasses.field(default_factory=list)
    frame_outputs: List[str] = dataclasses.field(default_factory=list)
    chain_outputs: List[str] = dataclasses.field(default_factory=list)
    single: bool = True
    # per-output deadline hints (seconds) from outputs(deadline=...),
    # and the cheap early taps they induce: non-output stages added to
    # frame_outputs so sessions emit them ahead of the deframed stream.
    deadlines: Dict[str, float] = dataclasses.field(default_factory=dict)
    early_taps: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.outputs:
            self.outputs = [self.output]
        stages = self.graph.stages
        self.pre_stages = [_make_sample_stage(stages[s])
                           for s in self.pre_names]
        self.post_stages = [_make_sample_stage(stages[s])
                            for s in self.post_names]
        # keyed by (n_frames, fuse, backend.cache_key, device): two
        # execution backends, or two devices, never share a compiled
        # core program slot.
        self._core_cache: Dict[Tuple, CompiledSignalGraph] = {}

    # -- analysis -----------------------------------------------------------
    @classmethod
    def analyze(cls, graph: SignalGraph) -> "StreamStructure":
        stages = graph.stages
        out_names = graph._declared_outputs()
        if not out_names:
            raise ValueError("empty graph")
        single = graph._single_output()
        live = graph._live_stages(out_names)
        order = [s for s in graph._order if s in live]
        out = out_names[0]
        framers = [s for s in order if stages[s].kind == "stft"]
        deframers = [s for s in order
                     if stages[s].kind in ("istft", "overlap_add")]
        if len(framers) > 1 or len(deframers) > 1:
            raise ValueError("streaming supports at most one stft/istft")
        if deframers and not framers:
            raise ValueError("istft/overlap_add without a matching stft")

        consumers: Dict[str, List[str]] = {}
        for s in order:
            for i in stages[s].inputs:
                consumers.setdefault(i, []).append(s)

        if not framers:
            # pure sample-domain chain input -> ... -> output(s); declared
            # non-terminal outputs are chain taps (zero added latency).
            cur, seen = SignalGraph.INPUT, []
            while consumers.get(cur):
                nxts = consumers[cur]
                if len(nxts) != 1:
                    raise ValueError("streaming needs a linear sample chain")
                cur = nxts[0]
                if stages[cur].kind not in _SAMPLE_KINDS:
                    raise ValueError(
                        f"stage {cur!r} ({stages[cur].kind}) is not "
                        "streamable in a sample-domain chain")
                seen.append(cur)
            if single and cur != out:
                raise ValueError("output is not the end of the chain")
            return cls(graph, pre_names=seen, core_names=[], post_names=[],
                       framer=None, deframer=None, frame=0, hop=0,
                       context=0, out_length=None, output=cur,
                       outputs=out_names, frame_outputs=[],
                       chain_outputs=list(out_names), single=single,
                       deadlines=dict(getattr(graph, "_deadlines", {})))

        framer = framers[0]
        deframer = deframers[0] if deframers else None
        fst = stages[framer]
        frame = int(fst.params["frame"])
        hop = int(fst.params["hop"])
        out_length = None
        if deframer is not None:
            dst = stages[deframer]
            if int(dst.params["hop"]) != hop:
                raise ValueError("streaming needs stft hop == istft hop")
            out_length = dst.params.get("length")

        # pre-chain: walk back from the framer to the input.
        chain = []
        cur = fst.inputs[0]
        while cur != SignalGraph.INPUT:
            st = stages[cur]
            if st.kind not in _SAMPLE_KINDS or len(st.inputs) != 1:
                raise ValueError(f"pre-stft stage {cur!r} not streamable")
            chain.append(cur)
            cur = st.inputs[0]
        pre_names = list(reversed(chain))

        # post-chain: walk forward from the deframer to its chain end
        # (with multi-output pruning, the end is always a declared
        # output; mid-chain declared outputs become chain taps).
        post: List[str] = []
        primary = out
        if deframer is not None:
            cur = deframer
            while consumers.get(cur):
                nxts = consumers[cur]
                if len(nxts) != 1:
                    raise ValueError("post-istft stages must form a chain")
                cur = nxts[0]
                st = stages[cur]
                if st.kind not in _SAMPLE_KINDS:
                    raise ValueError(
                        f"post-istft stage {cur!r} not streamable")
                post.append(cur)
            if single and cur != out:
                raise ValueError("output is not the end of the chain")
            primary = cur

        # interior: everything else must be framewise.
        skip = set(chain) | set(post) | {framer}
        if deframer is not None:
            skip.add(deframer)
        interior = [s for s in order if s not in skip]
        context = 0
        for s in interior:
            st = stages[s]
            if st.kind not in _FRAMEWISE_KINDS:
                raise ValueError(
                    f"stage {s!r} ({st.kind}) is not framewise-streamable")
            for i in st.inputs:
                if i == SignalGraph.INPUT or i in chain or i in post:
                    raise ValueError(
                        f"framewise stage {s!r} reads outside the core")
            context += st.frame_context
        if deframer is None:
            bad = [o for o in out_names
                   if o not in interior and o != framer
                   and o not in pre_names]
            if bad:
                raise ValueError(
                    f"output {bad[0]!r} is outside the framewise core")
            if single:
                primary = out
            elif out in interior or out == framer:
                primary = out
            else:
                primary = next(o for o in out_names
                               if o in interior or o == framer)
        core_names = [s for s in order
                      if s == framer or s == deframer or s in interior]
        frame_outputs = [o for o in out_names
                         if o in interior or o == framer]
        chain_outputs = [o for o in out_names
                         if o in pre_names
                         or (o in post and o != primary)
                         or (o == deframer and post)]
        deadlines = dict(getattr(graph, "_deadlines", {}))
        early_taps: List[str] = []
        if deadlines and deframer is not None and framer not in frame_outputs:
            # a deadline on the deframed stream earns a cheap early tap:
            # the framer joins the per-block frame taps (shared-prefix
            # lowering — zero extra array work), whose rows finalize
            # `context` frames in, far ahead of OLA sample finality.
            deframed = [o for o in deadlines
                        if o not in frame_outputs and o not in pre_names]
            if deframed:
                frame_outputs = frame_outputs + [framer]
                early_taps.append(framer)
        return cls(graph, pre_names=pre_names, core_names=core_names,
                   post_names=post, framer=framer, deframer=deframer,
                   frame=frame, hop=hop, context=context,
                   out_length=out_length, output=primary,
                   outputs=out_names, frame_outputs=frame_outputs,
                   chain_outputs=chain_outputs, single=single,
                   deadlines=deadlines, early_taps=early_taps)

    # -- length bookkeeping (used by bucketed serving) ----------------------
    @property
    def min_length(self) -> int:
        """Shortest input the graph compiles for."""
        return self.frame if self.framer is not None else 1

    def valid_frames(self, length: int) -> int:
        """Frames computed entirely from the first ``length`` samples."""
        if length < self.frame:
            return 0
        return 1 + (length - self.frame) // self.hop

    def out_count(self, valid_len: int) -> int:
        """Valid output extent along the output's leading suffix axis for
        a request of true length ``valid_len``: samples for deframed /
        sample-chain graphs, frame rows for frames-domain outputs."""
        if self.framer is None:
            return valid_len
        vf = self.valid_frames(valid_len)
        if self.deframer is None:
            return vf
        if self.out_length is not None:
            return self.out_length
        return (vf - 1) * self.hop + self.frame

    def out_count_for(self, name: str, valid_len: int) -> int:
        """Per-output :meth:`out_count` (the SigProgram multi-output
        contract): frames-domain outputs count valid frame rows;
        sample-domain outputs on the pre-chain count input samples; the
        deframed side counts output samples (capped by a declared istft
        length)."""
        if self.framer is None or name in self.pre_names:
            return valid_len
        if name in self.frame_outputs:
            return self.valid_frames(valid_len)
        return self.out_count(valid_len)

    def output_latencies(self) -> Dict[str, Dict]:
        """Streaming delay of each output: how far behind the fed input
        an output's emission runs.  Sample-domain outputs report samples
        (``frame - hop`` for OLA finality plus ``context * hop`` DNN
        lookahead; pre-chain taps are causal: 0); frames-domain taps
        report ``context`` frames of held-back lookahead."""
        out: Dict[str, Dict] = {}
        for name in self.outputs:
            if self.framer is None or name in self.pre_names:
                out[name] = {"domain": "samples", "latency": 0}
            elif name in self.frame_outputs:
                out[name] = {"domain": "frames", "latency": self.context}
            else:
                out[name] = {"domain": "samples",
                             "latency": (self.frame - self.hop
                                         + self.context * self.hop)}
            if name in self.deadlines:
                out[name]["deadline"] = self.deadlines[name]
        for name in self.early_taps:
            out[name] = {"domain": "frames", "latency": self.context,
                         "early_tap": True}
        return out

    # -- per-block core graph (shared compile cache) ------------------------
    @property
    def core_multi(self) -> bool:
        """True when the per-block core emits a dict (frame taps ride
        along with the deframed output)."""
        return bool(self.frame_outputs)

    def core_graph(self, n_frames: int,
                   fuse: FuseLevel = FuseLevel.STREAM,
                   backend="reference",
                   device=DEFAULT_DEVICE) -> CompiledSignalGraph:
        """The per-block core (framer -> framewise stages -> frames-domain
        deframer, plus the frame taps) compiled for ``n_frames`` frames on
        ``device``; cached per ``(n_frames, fuse, backend.cache_key,
        device)``."""
        from .backends import get_backend
        backend = get_backend(backend)
        dev = resolve_device(device)
        key = (n_frames, int(fuse), backend.cache_key, dev)
        if key not in self._core_cache:
            g = SignalGraph(f"{self.graph.name}_core")
            for s in self.core_names:
                st = self.graph.stages[s]
                if s == self.framer:
                    g.add("stft", s, SignalGraph.INPUT, **st.params)
                elif s == self.deframer:
                    g.add("istft_frames", s, st.inputs[0], hop=self.hop)
                else:
                    g.add(st.kind, s, st.inputs, **st.params)
            if self.core_multi:
                # one core program serves the deframed stream AND the
                # frame taps — the shared prefix is lowered once.
                g._set_outputs([self.deframer, *self.frame_outputs],
                               plural=True)
            else:
                g._set_outputs([self.deframer], plural=False)
            block_len = (n_frames - 1) * self.hop + self.frame
            self._core_cache[key] = g.compile(block_len, fuse=fuse,
                                              backend=backend, device=dev)
        return self._core_cache[key]

    def core_jit(self, n_frames: int, fuse: FuseLevel = FuseLevel.STREAM,
                 backend="reference", device=DEFAULT_DEVICE):
        """The cached core as a callable ``(block, params) -> frames``
        (:meth:`CompiledSignalGraph.jit`: PyTorch runs eagerly)."""
        return self.core_graph(n_frames, fuse, backend, device).jit()


# --------------------------------------------------------------------------
# Pure step functions over (structure, state)
# --------------------------------------------------------------------------

def push_chunk(struct: StreamStructure, state: StreamState, chunk,
               params=None, device=DEFAULT_DEVICE):
    """Move ``chunk`` (numpy or a tensor) to ``device``, apply the
    pre-chain and append to the ring buffer.  Returns ``(state, out)``.
    For single-output graphs ``out`` is the chunk's final samples for pure
    sample-chain graphs (no core => no latency) and ``None`` otherwise.
    For multi-output graphs ``out`` is a dict holding the chain outputs
    that emitted with this chunk (pre-chain taps are causal: zero
    latency)."""
    x = _as_input(chunk, resolve_device(device))
    collect = () if struct.single else tuple(struct.chain_outputs)
    pre, x, taps = _apply_chain(struct.pre_stages, struct.pre_names,
                                state.pre, x, params, collect)
    if struct.framer is None:
        state = dataclasses.replace(state, pre=pre,
                                    batch_shape=tuple(x.shape[:-1]))
        if struct.single:
            return state, x
        taps[struct.output] = x
        return state, {o: taps[o] for o in struct.outputs if o in taps}
    buf = x if state.buf is None else torch.cat([state.buf, x], dim=-1)
    state = dataclasses.replace(state, pre=pre, buf=buf,
                                total=state.total + x.shape[-1])
    if obs.ENABLED:
        obs.metrics().histogram(
            "streaming.chunk_samples").record(x.shape[-1])
    return state, (None if struct.single else taps)


def ready_spec(struct: StreamStructure, state: StreamState,
               block_frames: int, final: bool) -> Optional[BlockSpec]:
    """The next core block to execute, or None if no frames are ready.
    Non-final drains hold back ``context`` frames of lookahead so DNN
    receptive fields see the same neighbors they would offline.  Reads
    only the state's host counters."""
    if struct.framer is None:
        return None
    frame, hop, C = struct.frame, struct.hop, struct.context
    f_avail = 0 if state.total < frame else \
        1 + (state.total - frame) // hop
    f_ready = f_avail if final else max(state.f_next, f_avail - C)
    if state.f_next >= f_ready:
        return None
    count = min(block_frames, f_ready - state.f_next)
    f_lo, f_hi = state.f_next, state.f_next + count
    g0 = max(0, f_lo - C)
    g1 = min(f_avail - 1, f_hi - 1 + C)
    return BlockSpec(f_lo, f_hi, g0, g1,
                     lo=g0 * hop - state.buf_start,
                     hi=g1 * hop + frame - state.buf_start,
                     f_avail=f_avail)


def take_block(state: StreamState, spec: BlockSpec) -> torch.Tensor:
    """The ring-buffer slice feeding one core execution."""
    if obs.ENABLED:
        obs.metrics().histogram(
            "streaming.block_frames").record(spec.count)
    return state.buf[..., spec.lo:spec.hi]


def commit_frames(struct: StreamStructure, state: StreamState,
                  spec: BlockSpec, frames: torch.Tensor, final: bool):
    """Overlap-add the core's output frames for one block, merge the
    carried tail, advance the frame cursor and trim the ring buffer.
    Returns ``(state, piece)`` with ``piece`` the newly-final samples
    (before the length cap / post-chain — see :func:`finalize_piece`)."""
    frame, hop, C = struct.frame, struct.hop, struct.context
    sel = frames[..., spec.f_lo - spec.g0:spec.f_hi - spec.g0, :]
    acc = overlap_add(sel, hop)              # count*hop + frame-hop samples
    tail = state.tail
    if tail is not None:
        acc = torch.cat([acc[..., :frame - hop] + tail,
                         acc[..., frame - hop:]], dim=-1)
    last = final and spec.f_hi == spec.f_avail
    if last:
        piece, tail = acc, None              # includes the natural tail
    else:
        piece, tail = acc[..., :spec.count * hop], acc[..., spec.count * hop:]
    buf, buf_start = state.buf, state.buf_start
    keep = max(0, spec.f_hi - C) * hop
    if keep > buf_start:
        buf = buf[..., keep - buf_start:]
        buf_start = keep
    state = dataclasses.replace(state, tail=tail, f_next=spec.f_hi,
                                buf=buf, buf_start=buf_start)
    return state, piece


def tap_rows(arr: torch.Tensor, spec: BlockSpec, axis: int) -> torch.Tensor:
    """The newly-final frame rows ``[f_lo, f_hi)`` of one core tap
    output for a block (context rows trimmed); ``axis`` is the frames
    axis (the batch rank of the fed block).  Shared with the serving
    layer's batched :meth:`SignalService.stream_step`."""
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(spec.f_lo - spec.g0, spec.f_hi - spec.g0)
    return arr[tuple(sl)]


def drain_state(struct: StreamStructure, state: StreamState,
                block_frames: int, run_core, final: bool, params=None):
    """The shared drain loop: execute ready blocks through ``run_core``
    (``(block, n_frames) -> frames``, or ``-> dict`` when the core
    carries frame taps), overlap-add and finalize.  Returns
    ``(state, out)`` with ``out`` None when nothing became final; for
    multi-output graphs ``out`` is a dict of the outputs that emitted
    (frame taps concatenate along the frames axis).  Both
    :class:`StreamingRunner` and the service's
    :class:`~repro_torch.serving.signal_service.StreamSession` flush path
    use this single implementation."""
    pieces: List[torch.Tensor] = []
    tap_pieces: Dict[str, List[torch.Tensor]] = \
        {t: [] for t in struct.frame_outputs}
    while True:
        spec = ready_spec(struct, state, block_frames, final)
        if spec is None:
            break
        axis = state.buf.ndim - 1            # frames axis of core outputs
        res = run_core(take_block(state, spec), spec.n_frames)
        if isinstance(res, dict):
            frames = res[struct.deframer]
            for t in struct.frame_outputs:
                tap_pieces[t].append(tap_rows(res[t], spec, axis))
        else:
            frames = res
        state, piece = commit_frames(struct, state, spec, frames, final)
        pieces.append(piece)
    if final and not pieces and state.tail is not None:
        pieces.append(state.tail)            # everything already OLA'd
        state = dataclasses.replace(state, tail=None)
    sample_out = None
    if pieces:
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
        state, sample_out = finalize_piece(struct, state, out, final,
                                           params)
    if struct.single:
        return state, sample_out
    outs: Dict[str, torch.Tensor] = {}
    if isinstance(sample_out, dict):
        outs.update(sample_out)
    elif sample_out is not None:
        outs[struct.output] = sample_out
    for t, ps in tap_pieces.items():
        if not ps:
            continue
        ax = state.buf.ndim - 1 if state.buf is not None else 0
        outs[t] = ps[0] if len(ps) == 1 else torch.cat(ps, dim=ax)
    return state, (outs or None)


def finalize_piece(struct: StreamStructure, state: StreamState,
                   out: torch.Tensor, final: bool, params=None):
    """Apply the istft length cap (a running budget across the whole
    stream) and the sample post-chain to newly-final samples.  For
    multi-output graphs returns a dict: the primary sample output plus
    any post-chain / deframer taps that emitted."""
    if struct.out_length is not None:
        allowed = struct.out_length - state.emitted
        if out.shape[-1] > allowed:
            out = out[..., :max(0, allowed)]
        elif final and out.shape[-1] < allowed:
            out = F.pad(out, (0, allowed - out.shape[-1]))
    collect = () if struct.single else tuple(struct.chain_outputs)
    taps: Dict[str, torch.Tensor] = {}
    if not struct.single and struct.deframer in collect:
        taps[struct.deframer] = out
    post, out, post_taps = _apply_chain(struct.post_stages,
                                        struct.post_names, state.post,
                                        out, params, collect)
    state = dataclasses.replace(state, post=post,
                                emitted=state.emitted + out.shape[-1])
    if struct.single:
        return state, out
    taps.update(post_taps)
    taps[struct.output] = out
    return state, taps


# --------------------------------------------------------------------------
# Runner (single-connection wrapper)
# --------------------------------------------------------------------------

class StreamingRunner:
    """Push chunks with :meth:`process`, finish with :meth:`flush`.

    ``graph`` must be a streamable pipeline: a linear chain of sample-domain
    stages (fir / iir_biquad), optionally wrapped around one
    stft -> framewise-stages -> istft core (any DAG of framewise stages in
    between, e.g. the Fig-9 mask DNN with fan-out).  ``params`` is the same
    per-stage dict the compiled graph takes (tensors with
    ``requires_grad`` differentiate through the stream).  Chunks — numpy
    arrays or tensors — may have leading batch / channel axes; the last
    axis is time and chunk lengths may vary.

    ``block_frames`` sets how many new frames each drain executes at
    once (one compiled core program per distinct block size); ``fuse``
    is forwarded to :meth:`SignalGraph.compile` for the per-block core;
    ``backend`` picks the core's execution backend
    (:mod:`repro_torch.signal.backends`: ``"reference"`` plain torch,
    ``"hopper"`` the shuffle-GEMM / bitserial CUDA kernels — same
    switch as ``compile(backend=...)``); ``device`` is where the stream
    computes: the card by default (raising on a host without one), the
    CPU when asked for.

    The carried state lives in ``self.state`` (a :class:`StreamState`);
    the graph analysis and compile caches in ``self.struct`` (a
    :class:`StreamStructure`, shareable across runners of one graph).
    """

    def __init__(self, graph: SignalGraph, params=None,
                 block_frames: int = 8,
                 fuse: "FuseLevel | int" = FuseLevel.STREAM,
                 struct: Optional[StreamStructure] = None,
                 backend="reference",
                 device=DEFAULT_DEVICE):
        from .backends import get_backend
        self.graph = graph
        self.params = params
        self.block_frames = int(block_frames)
        self.fuse = FuseLevel.coerce(fuse)
        self.backend = get_backend(backend)
        self.device = resolve_device(device)
        self.struct = struct if struct is not None \
            else StreamStructure.analyze(graph)
        if self.struct.framer is not None and self.struct.deframer is None:
            raise ValueError("stft and istft must appear together")
        self.state = StreamState()

    # -- streaming ----------------------------------------------------------
    def process(self, chunk):
        """Feed one chunk; returns the output data that became final.

        Single-output graphs return the bare sample tensor (possibly
        empty).  Multi-output graphs return a dict holding the outputs
        that produced new data this call — pre-chain taps emit with the
        chunk, frame taps and the deframed stream emit as blocks become
        ready; absent keys simply emitted nothing yet."""
        self.state, out = push_chunk(self.struct, self.state, chunk,
                                     self.params, self.device)
        if self.struct.single:
            if out is not None:
                return out                     # pure sample chain: no latency
            return self._drain(final=False)
        outs: Dict[str, torch.Tensor] = dict(out or {})
        if self.struct.framer is not None:
            self.state, more = drain_state(self.struct, self.state,
                                           self.block_frames,
                                           self._run_core, False,
                                           self.params)
            outs.update(more or {})
        return outs

    def flush(self):
        """Process remaining frames and emit the overlap-add tail.
        Multi-output graphs return a dict of the remaining per-output
        data (possibly empty)."""
        if self.struct.framer is None:
            return {} if not self.struct.single \
                else torch.zeros((*self.state.batch_shape, 0),
                                 device=self.device)
        if self.struct.single:
            return self._drain(final=True)
        self.state, out = drain_state(self.struct, self.state,
                                      self.block_frames, self._run_core,
                                      True, self.params)
        return out or {}

    def _run_core(self, block: torch.Tensor, n_frames: int):
        return self.struct.core_jit(n_frames, self.fuse, self.backend,
                                    self.device)(block, self.params)

    def _drain(self, final: bool) -> torch.Tensor:
        self.state, out = drain_state(self.struct, self.state,
                                      self.block_frames, self._run_core,
                                      final, self.params)
        if out is None:
            shape = (0,) if self.state.buf is None else \
                (*self.state.buf.shape[:-1], 0)
            return torch.zeros(shape, device=self.device)
        return out
