"""Device selection for the port's entry points.

``SignalGraph.compile`` and ``SignalService`` take ``device=`` and
default to ``"cuda"``: the port is written for the card.  A CUDA request
on a host without one raises instead of quietly running on the CPU; the
CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`, a CUDA device with its index
    (``"cuda"`` is the current card, as tensors report it); raises
    ``RuntimeError`` for a CUDA device when this host has no usable
    card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False on this host; pass device='cpu' to run the plain "
            f"PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
