"""Weights across: the JAX package's params pytrees -> the port's.

A params tree of the JAX package is a dict keyed by stage name whose
leaves are arrays (FIR ``taps``, mel ``weights``, a dnn hook's own
params).  The port takes the same tree, with tensors, except for
convolution kernels: JAX keeps them HWIO (``(3, 3, ci, co)``), PyTorch
OIHW (``(co, ci, 3, 3)``).  Every 4-D leaf is such a kernel in this
repository's models (the Fig-9 mask CNN), so :func:`params_from_jax`
transposes 4-D leaves and maps every other leaf 1:1.

A language model's params tree (``repro.models``) maps 1:1 and keeps
each leaf's own dtype: :func:`model_params_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["params_from_jax", "model_params_from_jax"]


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


def model_params_from_jax(params, device=DEFAULT_DEVICE):
    """Map a JAX-side model params tree (``bundle.init(key)`` of the JAX
    package's zoo: dicts of arrays, block leaves with their leading group
    axis) onto the port's, leaf for leaf, each in its own dtype (norms
    float32; weights bfloat16 in full configs, float32 in ``reduced()``)
    on ``device`` (the card by default, raising on a host without one).
    A bfloat16 leaf crosses as float32 (numpy has no bfloat16 of its
    own), which holds every bfloat16 value exactly."""
    device = resolve_device(device)
    if isinstance(params, dict):
        return {k: model_params_from_jax(v, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(model_params_from_jax(v, device)
                            for v in params)
    arr = np.asarray(params)
    if arr.dtype.name == "bfloat16":
        return torch.as_tensor(arr.astype(np.float32), device=device
                               ).to(torch.bfloat16)
    return torch.tensor(arr, device=device)     # a copy: never aliases
