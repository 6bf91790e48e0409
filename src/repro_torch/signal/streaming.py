"""Streamable decomposition of a :class:`~repro_torch.signal.graph.SignalGraph`.

:class:`StreamStructure` analyses a graph into the streamable shape
``sample pre-chain -> stft -> framewise core -> istft -> sample
post-chain`` (any prefix of that shape).  The serving layer uses it to
decide length-bucketing legality and to compute per-request valid-frame
counts and output lengths.  :class:`BlockSpec` describes one core-graph
execution of a streamed block.

The carried per-connection state (``StreamState``), the chunk functions
and ``StreamingRunner`` of the JAX package are the streaming slice of the
port and are not here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .graph import SignalGraph

__all__ = ["StreamStructure", "BlockSpec"]

_SAMPLE_KINDS = ("fir", "iir_biquad")
_FRAMEWISE_KINDS = ("dnn", "dnn_circulant", "magnitude", "mel_filterbank",
                    "mul", "dct", "fft", "ifft")


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

    In this slice of the port the structure serves length-bucketed
    serving: :meth:`analyze`, the framer/deframer split, and the
    per-request length bookkeeping (:attr:`min_length`,
    :meth:`valid_frames`, :meth:`out_count_for`).  The per-block core
    programs and carried sample-stage state belong to the streaming
    slice.

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
