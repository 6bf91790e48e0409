"""Weights across: the JAX package's params pytrees -> the port's.

A params tree of the JAX package is a dict keyed by stage name whose
leaves are arrays (FIR ``taps``, mel ``weights``, a dnn hook's own
params).  The port takes the same tree, with tensors, except for
convolution kernels: JAX keeps them HWIO (``(3, 3, ci, co)``), PyTorch
OIHW (``(co, ci, 3, 3)``).  Every 4-D leaf is such a kernel in this
repository's models (the Fig-9 mask CNN), so :func:`params_from_jax`
transposes 4-D leaves and maps every other leaf 1:1.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(params, device=DEFAULT_DEVICE, dtype=torch.float32):
    """Map a JAX-side params tree (dicts, lists, tuples; numpy-convertible
    leaves) onto the port's: the same structure with ``dtype`` tensors
    on ``device`` (the card by default, raising on a host without one),
    4-D conv kernels transposed HWIO -> OIHW."""
    device = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_from_jax(v, device, dtype)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_from_jax(v, device, dtype)
                            for v in params)
    if params is None:
        return None
    arr = np.asarray(params)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return torch.as_tensor(np.ascontiguousarray(arr), device=device
                           ).to(dtype)
