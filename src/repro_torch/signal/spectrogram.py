"""STFT / iSTFT frontend built entirely from fabric primitives.

Framing is a shuffle plan (strided window gather), the per-frame FFT is the
fabric-mapped radix-2 pipeline, and overlap-add inversion uses a periodic
Hann window with hop = frame/2 (exact COLA).  This is the FFT->CNN->iFFT
speech-enhancement frontend of the paper's Fig 9.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import signal_mapping as _sm
from ..core.fabric import ShufflePlan, apply_plan


def hann(n: int) -> np.ndarray:
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
            ).astype(np.float32)


def _make_frame_plan(length: int, frame: int, hop: int) -> ShufflePlan:
    n_frames = 1 + (length - frame) // hop
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(frame)[None, :]).astype(np.int32)
    return ShufflePlan(idx.ravel(), np.zeros(idx.size, np.int64), 16)


def _frame_plan(length: int, frame: int, hop: int) -> ShufflePlan:
    # routed through the package's unified plan cache (signal/__init__)
    # so clear_plan_caches() bounds this module's memory too.
    from . import _PLAN_BUILDERS, _plan
    _PLAN_BUILDERS.setdefault("stft_frame", _make_frame_plan)
    return _plan("stft_frame", length, frame, hop)


def _fft_plan(n: int) -> _sm.FFTPlan:
    from . import _plan
    return _plan("fft", n, True)


def frame_signal(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    plan = _frame_plan(x.shape[-1], frame, hop)
    n_frames = plan.n_out // frame
    return apply_plan(x, plan).reshape(*x.shape[:-1], n_frames, frame)


def stft(x: torch.Tensor, frame: int = 256, hop: int = 128,
         window: bool = True) -> torch.Tensor:
    """(..., T) real -> (..., n_frames, frame) complex spectrum."""
    frames = frame_signal(x, frame, hop)
    if window:
        frames = frames * torch.as_tensor(hann(frame), device=frames.device
                                          ).to(frames.dtype)
    z = frames.to(torch.complex64)
    return _sm.fft_via_fabric(z, _fft_plan(frame))


def istft(spec: torch.Tensor, hop: int = 128, length: int | None = None
          ) -> torch.Tensor:
    """Inverse of :func:`stft` (analysis-window OLA; exact for hop=frame/2
    periodic Hann in the interior)."""
    from .graph import overlap_add
    frame = spec.shape[-1]
    frames = torch.real(_sm.ifft_via_fabric(spec, _fft_plan(frame)))
    return overlap_add(frames, hop, length)


def magnitude_spectrogram(x: torch.Tensor, frame: int = 256,
                          hop: int = 128) -> torch.Tensor:
    s = stft(x, frame, hop)
    return torch.abs(s)[..., : frame // 2 + 1]
