"""User-facing signal-processing API, executed through the SigDLA fabric.

Plans are built once per shape and cached; every function takes torch
tensors and batches over leading axes.  These are the operations the paper deploys
on the DLA (FFT / FIR / DCT / DWT) plus the STFT frontend used by the
speech-enhancement pipeline (Fig 9).
"""

from __future__ import annotations

import torch

from .. import obs as _obs
from ..core import signal_mapping as _sm
from ..core.signal_mapping import (complex_to_interleaved,
                                   interleaved_to_complex,
                                   dct_via_array as dct,
                                   dct2_via_array as dct2)
from .spectrogram import stft, istft, magnitude_spectrogram
from .graph import (SignalGraph, CompiledSignalGraph, SigType, FuseLevel,
                    biquad_apply, overlap_add, mel_filterbank_matrix)
from .streaming import BlockSpec, StreamingRunner, StreamStructure
from .backends import (ExecBackend, ReferenceBackend, HopperBackend,
                       PrecisionPolicy, get_backend, register_backend,
                       available_backends)

__all__ = ["fft", "ifft", "fir", "fir_phased", "dct", "dct2", "dwt",
           "stft", "istft", "magnitude_spectrogram",
           "complex_to_interleaved", "interleaved_to_complex",
           "SignalGraph", "CompiledSignalGraph", "SigType", "FuseLevel",
           "biquad_apply", "overlap_add", "mel_filterbank_matrix",
           "BlockSpec", "StreamingRunner", "StreamStructure",
           "clear_plan_caches",
           "plan_cache_info", "plan_cache_get", "reset_plan_cache_stats",
           "ExecBackend", "ReferenceBackend", "HopperBackend",
           "PrecisionPolicy", "get_backend", "register_backend",
           "available_backends"]


# One keyed plan cache for every compiled plan artifact: the functional
# API's plan kinds (formerly four ad-hoc ``functools.lru_cache`` s) AND
# the execution backends' lowered kernel groups
# (:mod:`repro_torch.signal.backends` caches each gather∘einsum lowering here
# under its backend's name).  Keys are ``(backend, kind, *args)`` with
# ``backend=None`` for backend-agnostic plans; entries are static
# compile artifacts, never traced values, so clearing is always safe.
# ``clear_plan_caches()`` lets property tests bound memory across
# thousands of generated shapes; ``_PLAN_CACHE_MAX`` keeps the old LRU
# eviction so long-lived services over many distinct signal lengths
# cannot grow the cache without bound.  Per-backend hit/miss counters
# (``plan_cache_info()["by_backend"]``) make cache-key regressions —
# a backend leaking into, or missing from, the key — directly testable.

_PLAN_BUILDERS = {
    "fft": lambda n, fused=True: _sm.make_fft_plan(n, fuse_adjacent=fused),
    "fir": _sm.make_fir_plan,
    "fir_phase": _sm.make_fir_phase_plan,
    "dwt": _sm.make_dwt_plan,
}
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 256
_FUNCTIONAL = "functional"          # stats bucket for backend-None plans
_PLAN_STATS: dict = {}


def _stats_bucket(backend) -> dict:
    label = _FUNCTIONAL if backend is None else str(backend)
    return _PLAN_STATS.setdefault(label, {"hits": 0, "misses": 0})


def plan_cache_get(kind: str, args: tuple, builder, backend=None):
    """Fetch-or-build a cached plan artifact.

    ``(backend, kind, *args)`` is the cache key — ``backend`` is the
    execution-backend name for backend-specific lowerings (so two
    backends never share an entry) and ``None`` for backend-agnostic
    plans.  ``builder`` is called on a miss.  Hits/misses are counted
    per backend (:func:`plan_cache_info`)."""
    key = (backend, kind, *tuple(args))
    stats = _stats_bucket(backend)
    hit = _PLAN_CACHE.pop(key, None)
    was_hit = hit is not None
    if not was_hit:
        stats["misses"] += 1
        hit = builder()
        while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:      # LRU eviction
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    else:
        stats["hits"] += 1
    if _obs.ENABLED:
        # mirror the per-backend hit/miss tally into the metrics
        # registry so the post-run report and the trajectory entries
        # see it without reaching into this module's private state.
        label = _FUNCTIONAL if backend is None else str(backend)
        _obs.metrics().counter(
            f"plan_cache.{label}.{'hits' if was_hit else 'misses'}").inc()
    _PLAN_CACHE[key] = hit          # (re-)insert as most recently used
    return hit


def _plan(kind: str, *args):
    return plan_cache_get(kind, args,
                          lambda: _PLAN_BUILDERS[kind](*args))


def clear_plan_caches() -> None:
    """Drop every cached plan artifact — the functional API's shuffle
    plans (``fft``/``ifft``/``fir``/``fir_phased``/``dwt``) and the
    backends' lowered kernel groups — and reset the hit/miss counters.
    Plans are static compile artifacts keyed by shape; the next call
    simply rebuilds."""
    _PLAN_CACHE.clear()
    _PLAN_STATS.clear()


def reset_plan_cache_stats() -> None:
    """Zero the hit/miss counters WITHOUT dropping cached plans — test
    isolation (the autouse fixture in tests/conftest.py): hit-rate
    assertions see only their own test's traffic, while the expensive
    compile artifacts stay warm across tests."""
    _PLAN_STATS.clear()


def plan_cache_info() -> dict:
    """Cache observability for tests/benchmarks: entry count per plan
    kind, the total, and per-backend-key ``{"entries", "hits",
    "misses"}`` under ``"by_backend"`` (functional-API plans count
    under ``"functional"``)."""
    info: dict = {kind: 0 for kind in _PLAN_BUILDERS}
    by_backend: dict = {label: {"entries": 0, **dict(stats)}
                        for label, stats in _PLAN_STATS.items()}
    for key in _PLAN_CACHE:
        backend, kind = key[0], key[1]
        info[kind] = info.get(kind, 0) + 1
        label = _FUNCTIONAL if backend is None else str(backend)
        bucket = by_backend.setdefault(label,
                                       {"entries": 0, "hits": 0,
                                        "misses": 0})
        bucket["entries"] += 1
    info["total"] = len(_PLAN_CACHE)
    info["by_backend"] = by_backend
    return info


def _fft_plan(n: int, fused: bool = True) -> _sm.FFTPlan:
    return _plan("fft", n, fused)


def _fir_plan(n: int, taps: int) -> _sm.FIRPlan:
    return _plan("fir", n, taps)


def _fir_phase_plan(n: int, taps: int, phases: int) -> _sm.FIRPhasePlan:
    return _plan("fir_phase", n, taps, phases)


def _dwt_plan(n: int, wavelet: str) -> _sm.DWTPlan:
    return _plan("dwt", n, wavelet)


def fft(x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """Complex FFT along the last axis via the shuffle-fabric mapping."""
    n = x.shape[-1] if x.is_complex() else x.shape[-1] // 2
    return _sm.fft_via_fabric(x, _fft_plan(n, fused))


def ifft(x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    n = x.shape[-1] if x.is_complex() else x.shape[-1] // 2
    return _sm.ifft_via_fabric(x, _fft_plan(n, fused))


def fir(x: torch.Tensor, h) -> torch.Tensor:
    """Causal FIR filter (paper Fig 3b mapping: 1 tap-kernel)."""
    return _sm.fir_via_fabric(x, h, _fir_plan(x.shape[-1], h.shape[-1]))


def fir_phased(x: torch.Tensor, h, phases: int = 8) -> torch.Tensor:
    """Beyond-paper FIR mapping using all 8 PEs (see perf_model)."""
    plan = _fir_phase_plan(x.shape[-1], h.shape[-1], phases)
    return _sm.fir_via_fabric_phased(x, h, plan)


def dwt(x: torch.Tensor, wavelet: str = "haar"):
    """Single-level DWT -> (approx, detail)."""
    return _sm.dwt_via_fabric(x, _dwt_plan(x.shape[-1], wavelet), wavelet)
