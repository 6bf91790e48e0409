"""Model zoo: one uniform bundle API over the decoder LMs — the port's
counterpart of the JAX package's ``models/zoo.py``.

    bundle = get_model(cfg)
    params = bundle.init(torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    loss, _ = bundle.loss_fn(params, batch)
    logits, cache = bundle.prefill(params, batch, max_len=...)
    logits, cache = bundle.decode_step(params, cache, batch_t)

Every config of ``repro_torch.configs`` has a bundle: the decoder LMs
(dense, MoE, RG-LRU hybrid, xLSTM) from :mod:`.transformer`, the
encoder-decoder (``input_kind == "encdec"``) from :mod:`.whisper`.
:func:`batch_pspec` gives a batch's partition specs on a mesh;
``input_specs`` and ``cache_specs_for`` (the dry-run's abstract inputs)
wait for the dry-run (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..configs.base import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import sharding, transformer, whisper

__all__ = ["ModelBundle", "get_model", "batch_pspec"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _on_device(gen: torch.Generator, device) -> torch.Generator:
    """``gen``, checked to draw on ``device`` (the card by default,
    raising on a host without one)."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, params asked for on "
                         f"{device}")
    return gen


def get_model(cfg: ArchConfig) -> ModelBundle:
    """The bundle of ``cfg``'s model functions."""
    mod = whisper if cfg.input_kind == "encdec" else transformer
    return ModelBundle(
        cfg=cfg,
        init=lambda gen, device=DEFAULT_DEVICE: mod.init_params(
            _on_device(gen, device), cfg),
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        forward=lambda p, b: mod.forward_train(p, b, cfg),
        prefill=lambda p, b, **kw: mod.prefill(p, b, cfg, **kw),
        decode_step=lambda p, c, bt: mod.decode_step(p, c, bt, cfg),
        init_cache=lambda batch, max_len, device=DEFAULT_DEVICE, **kw:
            mod.init_cache(cfg, batch, max_len, resolve_device(device),
                           **kw),
    )


def batch_pspec(specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The partition spec of each batch entry (anything with a
    ``shape``) on ``mesh``: its batch dim over (pod, data) by
    :func:`~repro_torch.models.sharding.batch_spec`."""
    axes = sharding.mesh_axes_of(mesh)
    return {k: sharding.batch_spec(tuple(v.shape), axes)
            for k, v in specs.items()}
