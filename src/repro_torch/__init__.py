"""SigDLA on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module, so each file here has one
counterpart there.  Plain tensor code is PyTorch; every Pallas kernel of
the JAX package on the ported path is a hand-written CUDA kernel for the
H100 (``sm_90a``) under :mod:`repro_torch.kernels`.  The package imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
never ``repro``.

Entry points (:meth:`repro_torch.signal.SignalGraph.compile`,
:class:`repro_torch.serving.SignalService`) run on ``device="cuda"``
unless the caller asks for the CPU.
"""

from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
