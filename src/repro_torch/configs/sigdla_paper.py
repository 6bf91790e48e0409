"""The paper's own benchmark workloads (§VI) as selectable configs —
the SigDLA-side counterpart of the assigned-LM registry.

    from repro_torch.configs.sigdla_paper import get_workload, list_workloads
    wl = get_workload("fft1024")          # perf_model.Workload
    cyc = perf_model.sigdla_cycles(wl, aw=16, ww=16)

Covers Table I / Fig 7 / Fig 8 / Fig 10: FFT{128..1024}, FIR 256×{20,40,80}
(+ the beyond-paper phased variant), 2D-DCT 32, Tiny-VGGNet, UltraNet,
ResNet-20, and the Fig 9 speech-enhancement CNN."""

from __future__ import annotations

from functools import partial

from ..core import perf_model as pm

_WORKLOADS = {
    "fft128": partial(pm.fft_workload, 128, 16),
    "fft256": partial(pm.fft_workload, 256, 16),
    "fft512": partial(pm.fft_workload, 512, 16),
    "fft1024": partial(pm.fft_workload, 1024, 16),
    "fir256_20": partial(pm.fir_workload, 256, 20, 16),
    "fir256_40": partial(pm.fir_workload, 256, 40, 16),
    "fir256_80": partial(pm.fir_workload, 256, 80, 16),
    "fir256_80_phased": partial(pm.fir_workload, 256, 80, 16, phases=8),
    "dct2_32": partial(pm.dct2_workload, 32, 16),
    "tiny_vggnet": pm.tiny_vggnet,
    "ultranet": pm.ultranet,
    "resnet20": pm.resnet20,
    "speech_enhance_cnn": pm.speech_enhancement_cnn,
}


def list_workloads():
    return sorted(_WORKLOADS)


def get_workload(name: str) -> pm.Workload:
    if name not in _WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {list_workloads()}")
    return _WORKLOADS[name]()
