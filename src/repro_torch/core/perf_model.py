"""Cycle / energy / area model of SigDLA and the paper's baselines (§VI).

We cannot run Verilog + Design Compiler here; instead this is an analytical
model with the paper's published constants (Table II) plus
literature-calibrated baseline constants, used to reproduce the paper's
*ratios* (Fig 7, Fig 8, Fig 10).  Every constant is annotated with its
source.  The model is deliberately mechanistic — the Fig 7a "<16x" CNN
speedups fall out of array under-utilization on Cin<16 layers, and the
Fig 7b FFT ratio falls out of shuffle-traffic accounting, not curve fitting.

Array micro-architecture (paper §IV): 8 precision-scalable PEs x 16 4-bit
multipliers.  A (aw x ww) MAC consumes (aw/4)*(ww/4) 4-bit multipliers, so
each PE processes 16/(pa*pw) input channels per cycle; the 8 PEs cover 8
output channels.

    layer cycles(compute) = out_positions * K * ceil(Cin * pa*pw / 16)
                                          * ceil(Cout / 8)
    layer cycles(dma)     = dram_bytes / (BW / freq)
    layer cycles          = max(compute, dma, weight_stream) + fixed_overhead

Shuffle passes produce one 64-bit word per cycle (16 units x 4-bit nibbles,
§V-B), serialized before the consuming tensor op (the fabric writes back to
the buffer before the array streams, §III).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

# Version stamp carried by every dict this module emits
# (:func:`signal_graph_report`, :func:`step_cost_report`) so the
# report/trajectory tooling (repro_torch.obs.report, benchmarks/trajectory.py,
# the committed BENCH_PR*.json files) can evolve the shapes without
# breaking consumers of old JSON.  Bump on any key rename/removal or
# unit change; pure additions keep the version.
PERF_SCHEMA_VERSION = 1

# --------------------------------------------------------------------------
# Hardware constants
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SigDLAHW:
    freq_hz: float = 100e6          # paper: all platforms at 100 MHz
    n_pe: int = 8
    mult4_per_pe: int = 16
    dram_bw: float = 1600e6         # B/s  [paper Fig 7 setup, ref 36]
    sram_bytes: int = (128 + 16) * 1024   # Table II
    area_mm2: float = 5.21          # Table II
    power_w: float = 0.3025         # Table II (total @1.2V, UMC 55nm)
    leakage_w: float = 0.00202
    layer_overhead_cycles: int = 16   # pipeline fill + config stream

    @property
    def bytes_per_cycle(self) -> float:
        return self.dram_bw / self.freq_hz


@dataclasses.dataclass(frozen=True)
class NVDLAHW:
    """small-NVDLA reference point (Table II): 8-bit only, no fabric."""
    freq_hz: float = 100e6
    area_mm2: float = 4.45
    power_w: float = 0.2764
    leakage_w: float = 0.00172


# Baseline platform models.  Cycle coefficients calibrated against public
# numbers; platform power is *dev-kit* power, which is what the paper
# measured (MAX78000 EVKit / TMS320F28335 controlCARD):
#   - ARM Cortex-M4 + CMSIS-DSP on MAX78000: ideal CMSIS q15 cFFT is
#     ~4 cycles per (N log2 N) radix-op, but the MAX78000 executes from
#     flash with wait states (effective CPI ~2.5-3x ideal; see Moss et al.
#     [35] resource characterization), giving ~10 c/radix-op and ~2.9 c/MAC
#     for q15 FIR.  Kit power ~0.33 W (EVKit, active).
#   - TMS320F28x: TI C28x FFT library ~3.1 cycles per (N log2 N) radix-op
#     (32-bit lib incl. bit-reversal); FIR via RPT||MAC ~1.05 cycles/MAC
#     from zero-wait SRAM.  controlCARD power ~0.71 W (300+ mA @1.9V +IO).
@dataclasses.dataclass(frozen=True)
class ARMM4:
    freq_hz: float = 100e6
    fft_coeff: float = 10.0
    fir_cycles_per_mac: float = 2.9
    dct2_cycles_per_mac: float = 2.9
    power_w: float = 0.33


@dataclasses.dataclass(frozen=True)
class TMS320:
    freq_hz: float = 100e6
    fft_coeff: float = 3.1
    fir_cycles_per_mac: float = 1.05
    dct2_cycles_per_mac: float = 1.05
    power_w: float = 0.71


# --------------------------------------------------------------------------
# Workload descriptors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """Conv (or FC: H=W=K=1) layer on the computing array."""
    name: str
    h: int; w: int; k: int; cin: int; cout: int

    @property
    def macs(self) -> int:
        return self.h * self.w * self.k * self.k * self.cin * self.cout

    @property
    def params(self) -> int:
        return self.k * self.k * self.cin * self.cout

    @property
    def out_elems(self) -> int:
        return self.h * self.w * self.cout


@dataclasses.dataclass(frozen=True)
class ShufflePass:
    """Data movement through the shuffling fabric: one output word / cycle."""
    name: str
    elems: int          # elements moved
    elem_bits: int      # 4 / 8 / 16

    @property
    def words(self) -> int:
        return math.ceil(self.elems * self.elem_bits / 64)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    layers: List[ConvLayer]
    shuffles: List[ShufflePass] = dataclasses.field(default_factory=list)
    dram_in_elems: int = 0       # streamed input (activations / signal)
    dram_out_elems: int = 0

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def params(self) -> int:
        return sum(l.params for l in self.layers)


# --------------------------------------------------------------------------
# SigDLA cycle model
# --------------------------------------------------------------------------

def _planes(width: int) -> int:
    return width // 4


def conv_compute_cycles(l: ConvLayer, aw: int, ww: int,
                        hw: SigDLAHW = SigDLAHW()) -> int:
    pa, pw = _planes(aw), _planes(ww)
    ch_per_cycle = hw.mult4_per_pe // (pa * pw)      # input chans / PE / cycle
    return (l.h * l.w * l.k * l.k
            * math.ceil(l.cin / ch_per_cycle)
            * math.ceil(l.cout / hw.n_pe))


def sigdla_cycles(w: Workload, aw: int, ww: int,
                  hw: SigDLAHW = SigDLAHW(),
                  weights_resident: bool = False) -> dict:
    """Total cycles = max(compute, dma, shuffle) per phase + overheads.

    The fabric runs ahead of the array on double-buffered SRAM ("streamed
    to the computing array without breaking the lock-step processing",
    paper §III), so shuffle traffic overlaps compute and only binds when it
    exceeds it."""
    bpc = hw.bytes_per_cycle
    total_compute = total_dma = 0
    for l in w.layers:
        comp = conv_compute_cycles(l, aw, ww, hw)
        w_bytes = 0 if weights_resident else l.params * ww / 8
        act_bytes = l.out_elems * aw / 8        # streamed out (worst case)
        dma = (w_bytes + act_bytes) / bpc
        total_compute += max(comp, dma) + hw.layer_overhead_cycles
        total_dma += dma
    shuffle = sum(s.words for s in w.shuffles)
    io = (w.dram_in_elems * aw / 8 + w.dram_out_elems * aw / 8) / bpc
    total = max(total_compute, shuffle) + io
    return dict(total=int(total), compute=int(total_compute),
                shuffle=int(shuffle), io=int(io), dma=int(total_dma))


def sigdla_time_s(w: Workload, aw: int, ww: int,
                  hw: SigDLAHW = SigDLAHW(), **kw) -> float:
    return sigdla_cycles(w, aw, ww, hw, **kw)["total"] / hw.freq_hz


def sigdla_energy_j(w: Workload, aw: int, ww: int,
                    hw: SigDLAHW = SigDLAHW(), **kw) -> float:
    return sigdla_time_s(w, aw, ww, hw, **kw) * hw.power_w


# --------------------------------------------------------------------------
# Graph-level accounting (SigStream pipeline graphs, signal/graph.py)
# --------------------------------------------------------------------------

def signal_graph_report(compiled, aw: int = 16, ww: int = 16,
                        hw: SigDLAHW = SigDLAHW(),
                        weights_resident: bool = True) -> dict:
    """Cycle / traffic report for a compiled :class:`SignalGraph`.

    ``compiled`` is duck-typed: it supplies ``shuffle_passes()`` (one
    :class:`ShufflePass` per standalone fabric pass the graph executes),
    ``conv_layers()`` (one :class:`ConvLayer` per array einsum, plus any
    user-declared DNN layers), and ``in_type`` / ``out_type`` element
    counts for the DRAM streams.  This is the graph-level generalization of
    the per-op workload builders above: fusing two back-to-back gathers
    shows up here as one fewer pass and fewer shuffle words.

    The v2 cross-einsum fusion pass is attributed explicitly.  Optional
    ``streamed_shuffles()`` lists the permutations folded into array
    passes: their words traverse the fabric in lock-step with the array's
    operand stream (no buffer round trip), so they are *excluded* from
    ``shuffle_words`` — which counts serialized buffer->fabric->buffer
    traffic — and reported as ``streamed_words`` instead (their cycles
    hide under the consuming layer's compute/DMA bound).  Optional
    ``folded_pass_names()`` gives ``folded_passes``, the number of
    lowered passes the fusion absorbed (stream folds plus commuted /
    eliminated row permutations).
    """
    shuffles = list(compiled.shuffle_passes())
    layers = list(compiled.conv_layers())
    out_elems = getattr(compiled, "out_elems",
                        lambda: compiled.out_type.elems)()
    w = Workload(getattr(compiled, "name", "signal_graph"), layers, shuffles,
                 dram_in_elems=compiled.in_type.elems,
                 dram_out_elems=out_elems)
    rep = sigdla_cycles(w, aw, ww, hw, weights_resident=weights_resident)
    rep["fabric_passes"] = len(shuffles)
    rep["shuffle_words"] = sum(s.words for s in shuffles)
    rep["shuffle_elems"] = sum(s.elems for s in shuffles)
    streamed = list(getattr(compiled, "streamed_shuffles", lambda: [])())
    rep["streamed_passes"] = len(streamed)
    rep["streamed_words"] = sum(s.words for s in streamed)
    rep["folded_passes"] = len(
        getattr(compiled, "folded_pass_names", lambda: [])())
    rep["macs"] = w.macs
    # multi-output SigPrograms: bucket the pass/word/MAC counts by which
    # output each lowered stage feeds (``shared`` = stages feeding 2+
    # outputs).  Because every live stage is lowered exactly once, the
    # shared prefix appears once here — compiling the outputs separately
    # would pay the shared bucket per compile.
    attribution = getattr(compiled, "output_attribution", None)
    if attribution is not None:
        rep["outputs"] = list(getattr(compiled, "outputs",
                                      [compiled.output]))
        rep["per_output"] = attribution()
    # execution-backend attribution (compiled graphs bound to an
    # ExecBackend expose ``lowering_report()``): which fabric passes the
    # backend actually fused into array kernels vs emulated as plain
    # gathers, and the kernel route of every array pass — the runtime
    # counterpart of the static pass/word counts above.
    lowering = getattr(compiled, "lowering_report", None)
    if lowering is not None:
        rep["backend"] = lowering()
    rep["time_s"] = rep["total"] / hw.freq_hz
    rep["energy_j"] = rep["time_s"] * hw.power_w
    rep["schema_version"] = PERF_SCHEMA_VERSION
    return rep


# --------------------------------------------------------------------------
# Scheduler cost estimates (consumed by the serving CoScheduler policies)
# --------------------------------------------------------------------------

def decode_step_layers(cfg, batch: int = 1) -> List[ConvLayer]:
    """One LLM decode step as array FC layers (per token: the attention
    projections, the FF pair, and the LM head), batched over ``batch``
    rows.  A deliberate first-order model — the CoScheduler only needs
    *relative* cost between a decode step and a DSP batch, not absolute
    latency."""
    d, ff = cfg.d_model, cfg.d_ff
    vocab = getattr(cfg, "padded_vocab", cfg.vocab)
    layers = []
    for i in range(cfg.n_layers):
        layers.append(ConvLayer(f"l{i}.qkvo", h=batch, w=1, k=1,
                                cin=d, cout=4 * d))
        layers.append(ConvLayer(f"l{i}.ff", h=batch, w=1, k=1,
                                cin=d, cout=2 * ff))
    layers.append(ConvLayer("head", h=batch, w=1, k=1, cin=d, cout=vocab))
    return layers


def decode_step_cost(cfg, batch: int = 1, aw: int = 16, ww: int = 16,
                     hw: SigDLAHW = SigDLAHW()) -> int:
    """Estimated array cycles for ONE batched decode step of ``cfg``."""
    w = Workload("decode_step", decode_step_layers(cfg, batch))
    return sigdla_cycles(w, aw, ww, hw, weights_resident=True)["total"]


def step_cost_estimate(compiled, batch: int = 1, aw: int = 16,
                       ww: int = 16, hw: SigDLAHW = SigDLAHW()) -> int:
    """Estimated array cycles for ONE batched execution of a compiled
    signal graph (:func:`signal_graph_report` total, scaled by the batch
    size — the graph's layers/passes all scale with the leading batch
    axis).  The cost-balanced scheduling policy compares this against
    :func:`decode_step_cost` to keep the DSP/DL occupancy split near its
    target (the paper's §V utilization argument)."""
    rep = signal_graph_report(compiled, aw, ww, hw)
    return int(rep["total"]) * max(1, int(batch))


def device_step_costs(per_item_cycles: int, batch: int,
                      n_devices: int) -> List[int]:
    """Per-device cycles of ONE data-parallel sharded execution of a
    ``batch``-row wave: the serving mesh pads rows up to a multiple of
    the shard count, so every device executes ``ceil(batch/n)`` rows
    (pad rows compute like real rows — the array does not know they
    will be thrown away).  ``per_item_cycles`` is the single-row cost
    (:func:`step_cost_estimate` at batch=1).  This is what the
    sharded ``SignalService`` charges its :class:`DeviceRouter` ledger
    and what ``CoScheduler.occupancy()['per_device']`` reports."""
    n = max(1, int(n_devices))
    if batch <= 0:
        return [0] * n
    rows_per_device = math.ceil(batch / n)
    return [int(per_item_cycles) * rows_per_device] * n


def sharded_step_cost(per_item_cycles: int, batch: int,
                      n_devices: int) -> int:
    """Wall-clock cycles of a sharded execution: the max per-device
    share (devices run concurrently).  Equals the unsharded cost at
    ``n_devices=1``; the mesh bench's p50/p95 latencies tick on this
    clock."""
    return max(device_step_costs(per_item_cycles, batch, n_devices))


def wave_chunk_costs(per_item_cycles: int, rows: int,
                     row_budget) -> List[int]:
    """Per-tick cycle costs of one wave under a preemptible row budget:
    a ``rows``-row wave above the budget splits into ``ceil(rows /
    budget)`` chunks executed on successive scheduler ticks, each
    costing its own row count (the last chunk is the remainder).
    ``row_budget=None`` (or a budget covering the wave) is the
    unsplit single-tick execution.  This is what the serving
    scheduler's deferral threshold and the split-wave trace spans
    report — total cycles are invariant under splitting; only the
    per-tick granularity changes."""
    rows = int(rows)
    if rows <= 0:
        return []
    if row_budget is None or int(row_budget) >= rows:
        return [int(per_item_cycles) * rows]
    b = max(1, int(row_budget))
    return [int(per_item_cycles) * min(b, rows - lo)
            for lo in range(0, rows, b)]


def step_cost_estimate_per_device(compiled, batch: int = 1,
                                  n_devices: int = 1, aw: int = 16,
                                  ww: int = 16,
                                  hw: SigDLAHW = SigDLAHW()) -> List[int]:
    """Per-device extension of :func:`step_cost_estimate`: one
    perf-model evaluation, split by the sharded row partition."""
    per = step_cost_estimate(compiled, 1, aw, ww, hw)
    return device_step_costs(per, batch, n_devices)


def step_cost_report(compiled, batch: int = 1, aw: int = 16,
                     ww: int = 16, hw: SigDLAHW = SigDLAHW()) -> dict:
    """Structured form of :func:`step_cost_estimate` for tooling that
    serializes costs (the serving report / trajectory files): the same
    cycle estimate plus its inputs, under a stable ``schema_version``.
    :func:`step_cost_estimate` stays the scalar fast path the scheduler
    policies consume."""
    return {
        "schema_version": PERF_SCHEMA_VERSION,
        "cycles": step_cost_estimate(compiled, batch, aw, ww, hw),
        "batch": max(1, int(batch)),
        "aw": aw,
        "ww": ww,
    }


# --------------------------------------------------------------------------
# Baseline cycle models (FFT / FIR / DCT on DSP-class processors)
# --------------------------------------------------------------------------

def proc_fft_cycles(n: int, p) -> float:
    return p.fft_coeff * n * math.log2(n)


def proc_fir_cycles(n: int, taps: int, p) -> float:
    return p.fir_cycles_per_mac * n * taps + 64


def proc_dct2_cycles(n: int, p) -> float:
    return p.dct2_cycles_per_mac * 2 * n ** 3


def proc_time_s(cycles: float, p) -> float:
    return cycles / p.freq_hz


def proc_energy_j(cycles: float, p) -> float:
    return proc_time_s(cycles, p) * p.power_w


# --------------------------------------------------------------------------
# Workload builders (reconstructions; see benchmarks/table1_workloads.py for
# the Table I cross-check of MACs / params)
# --------------------------------------------------------------------------

def fft_workload(n: int, width: int, fused_plans: bool = True) -> Workload:
    """Radix-2 FFT mapped via the fabric: per stage, n/2 butterflies as
    (nb,4)x(4,4) GEMMs (the array executes the padded 1/0 entries too)."""
    stages = int(math.log2(n))
    layers = [ConvLayer(f"bfly_s{s}", h=n // 2, w=1, k=1, cin=4, cout=4)
              for s in range(stages)]
    per_stage = 2 * n                         # gather elems (re+im pairs)
    n_pass = stages + 1 if fused_plans else 2 * stages + 1
    shuffles = [ShufflePass(f"stage{i}", per_stage, width)
                for i in range(n_pass)]
    return Workload(f"fft{n}", layers, shuffles,
                    dram_in_elems=2 * n, dram_out_elems=2 * n)


def fir_workload(n: int, taps: int, width: int, phases: int = 1) -> Workload:
    """FIR as im2col + GEMM.  ``phases=1`` is the paper's mapping (a single
    tap kernel -> one PE active).  ``phases=8`` is our beyond-paper mapping:
    8 shifted tap kernels (structural zeros padded by the DPU) compute 8
    output positions per array pass, using all 8 PEs (EXPERIMENTS.md
    §Perf-paper)."""
    if phases == 1:
        layers = [ConvLayer("fir", h=n, w=1, k=1, cin=taps, cout=1)]
        shuffles = [ShufflePass("im2col", n * taps, width)]
    else:
        layers = [ConvLayer("fir", h=n // phases, w=1, k=1,
                            cin=taps + phases, cout=phases)]
        shuffles = [ShufflePass("im2col", (n // phases) * (taps + phases),
                                width)]
    return Workload(f"fir{n}_{taps}", layers, shuffles,
                    dram_in_elems=n, dram_out_elems=n)


def dct2_workload(n: int, width: int) -> Workload:
    # 2D DCT = two NxN GEMMs; regular — no shuffle traffic (Fig 3c).
    layers = [ConvLayer("dct_rows", h=n, w=1, k=1, cin=n, cout=n),
              ConvLayer("dct_cols", h=n, w=1, k=1, cin=n, cout=n)]
    return Workload(f"dct2_{n}", layers, [],
                    dram_in_elems=n * n, dram_out_elems=n * n)


def tiny_vggnet() -> Workload:
    """Reconstructed Tiny-VGGNet (32x32x3): ~1.4e8 MACs / ~1.0e6 params,
    vs Table I's 1.69e8 / 1.15e6 (within reconstruction tolerance)."""
    L = [
        ConvLayer("conv1_1", 32, 32, 3, 3, 64),
        ConvLayer("conv1_2", 32, 32, 3, 64, 64),
        ConvLayer("conv1_3", 32, 32, 3, 64, 64),
        ConvLayer("conv2_1", 16, 16, 3, 64, 128),
        ConvLayer("conv2_2", 16, 16, 3, 128, 128),
        ConvLayer("conv3_1", 8, 8, 3, 128, 128),
        ConvLayer("fc1", 1, 1, 1, 2048, 256),
        ConvLayer("fc2", 1, 1, 1, 256, 10),
    ]
    return Workload("tiny_vggnet", L, [], dram_in_elems=32 * 32 * 3,
                    dram_out_elems=10)


def ultranet() -> Workload:
    """Reconstructed UltraNet (DAC-SDC'20) backbone at 32x32x3:
    ~5.2e6 MACs / ~0.20e6 params vs Table I's 3.83e6 / 2.07e5."""
    L = [
        ConvLayer("conv1", 32, 32, 3, 3, 16),
        ConvLayer("conv2", 16, 16, 3, 16, 32),
        ConvLayer("conv3", 8, 8, 3, 32, 64),
        ConvLayer("conv4", 4, 4, 3, 64, 64),
        ConvLayer("conv5", 4, 4, 3, 64, 64),
        ConvLayer("conv6", 4, 4, 3, 64, 64),
        ConvLayer("conv7", 4, 4, 3, 64, 64),
    ]
    return Workload("ultranet", L, [], dram_in_elems=32 * 32 * 3,
                    dram_out_elems=4 * 4 * 64)


def resnet20() -> Workload:
    """ResNet-20 (CIFAR): 16/32/64 channels x 3 stages x 3 blocks."""
    L = [ConvLayer("conv1", 32, 32, 3, 3, 16)]
    spec = [(32, 16, 6), (16, 32, 6), (8, 64, 6)]
    cin = 16
    for hw_, c, reps in spec:
        for r in range(reps):
            L.append(ConvLayer(f"conv{hw_}_{c}_{r}", hw_, hw_, 3,
                               cin if r == 0 else c, c))
            cin = c
    L.append(ConvLayer("fc", 1, 1, 1, 64, 10))
    return Workload("resnet20", L, [], dram_in_elems=32 * 32 * 3,
                    dram_out_elems=10)


def speech_enhancement_cnn(frames: int = 125, bins: int = 128) -> Workload:
    """The Fig 9 CNN (mask estimator over a (frames x bins) spectrogram),
    reconstructed after [34]: 4 conv layers, 2->16->32->16->1 channels."""
    L = [
        ConvLayer("se_conv1", frames, bins, 3, 2, 16),
        ConvLayer("se_conv2", frames, bins, 3, 16, 32),
        ConvLayer("se_conv3", frames, bins, 3, 32, 16),
        ConvLayer("se_conv4", frames, bins, 3, 16, 1),
    ]
    return Workload("se_cnn", L, [], dram_in_elems=frames * bins * 2,
                    dram_out_elems=frames * bins)
