"""The paper's Fig 9 pipeline as a SigProgram, in PyTorch:

    noisy speech -> learned FIR front-end -> STFT (fabric FFT)
                 -> CNN mask -> masked spectrum -> iSTFT -> enhanced
                                          `-> mel monitoring tap

The counterpart of ``build_graph`` / ``init_cnn`` / ``cnn_mask`` in the
JAX package's ``examples/speech_enhancement.py``.  The graph declares
two named outputs — ``outputs("out", "mel_tap")`` — and compiles to one
fused shuffle-plan + einsum program; with ``backend="hopper"`` its two
array-pass families run on the shuffle-GEMM CUDA kernels.

Layouts differ from the JAX package only inside the mask CNN: weights
are OIHW (``repro_torch.convert.params_from_jax`` maps the JAX HWIO
kernels) and activations NCHW, with ``padding=1`` for the 3x3 "SAME"
convolutions; the GELU is the tanh form, JAX's default.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.fabric import device_constant

__all__ = ["FRAME", "HOP", "init_cnn", "cnn_mask", "build_graph"]

FRAME, HOP = 256, 128


def init_cnn(generator: torch.Generator, ch: Sequence[int] = (2, 12, 12, 1),
             device="cpu") -> List[torch.Tensor]:
    """Mask-CNN weights, OIHW ``(co, ci, 3, 3)`` per layer, drawn from
    ``generator`` with the JAX package's scale ``1 / sqrt(9 * ci)``.
    The two frameworks draw different numbers from one seed: parity
    tests build the weights with numpy and convert them instead."""
    return [torch.randn((co, ci, 3, 3), generator=generator)
            .mul_(1.0 / (9 * ci) ** 0.5).to(device)
            for ci, co in zip(ch[:-1], ch[1:])]


def cnn_mask(params, spec: torch.Tensor) -> torch.Tensor:
    """Complex spectrum (B, T, F) or (T, F) -> sigmoid mask of the same
    shape.  ``params`` is the list of OIHW conv weights (tensors or host
    arrays)."""
    mag = torch.abs(spec)
    x = torch.stack([torch.log1p(mag), torch.cos(torch.angle(spec))],
                    dim=-3)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    for i, w in enumerate(params):
        x = F.conv2d(x, device_constant(w, x.device, x.dtype), padding=1)
        if i < len(params) - 1:
            x = F.gelu(x, approximate="tanh")
    m = torch.sigmoid(x[:, 0])
    return m[0] if squeeze else m


def build_graph(length: int, ch: Sequence[int] = (2, 12, 12, 1),
                fir_taps: int = 9, n_mels: int = 24):
    """The Fig-9 SigProgram: learned-FIR front-end, mask CNN, enhanced
    stream plus a mel monitoring tap — one graph, two named outputs.
    Same stages and defaults as the JAX package's ``build_graph``."""
    from ..core.perf_model import ConvLayer
    from ..signal import SignalGraph

    n_frames = 1 + (length - FRAME) // HOP
    g = SignalGraph("speech_enhancement")
    # learnable front-end: starts as a delta (identity) filter
    taps0 = np.zeros(fir_taps, np.float32)
    taps0[0] = 1.0
    g.fir("front", "input", taps=taps0)
    g.stft("spec", "front", frame=FRAME, hop=HOP)
    # 3x3 convs over (frames, bins): receptive field len(ch)-1 frames each
    # side; the declared layers let signal_graph_report cover the DNN.
    layers = [ConvLayer(f"mask_conv{i}", h=n_frames, w=FRAME, k=3,
                        cin=ci, cout=co)
              for i, (ci, co) in enumerate(zip(ch[:-1], ch[1:]))]
    g.dnn("mask", "spec", fn=cnn_mask, frame_context=len(ch) - 1,
          layers=layers)
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=HOP, length=length)
    # monitoring tap: mel energies of the enhanced spectrum, from the
    # SAME compiled program.
    g.magnitude("mag", "enh", onesided=True)
    g.mel_filterbank("mel_tap", "mag", sr=16_000, n_mels=n_mels)
    g.outputs("out", "mel_tap")
    return g
