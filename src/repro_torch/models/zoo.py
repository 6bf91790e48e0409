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
:func:`input_specs` and :func:`cache_specs_for` give the abstract inputs
of every (shape x mode) cell — the dry-run's contract — as ``meta``
tensors (shape and dtype, no storage), the counterpart of the JAX
package's ``jax.ShapeDtypeStruct`` s; :func:`batch_pspec` gives a batch's
partition specs on a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import sharding, transformer, whisper

__all__ = ["ModelBundle", "get_model", "input_specs", "cache_specs_for",
           "batch_pspec"]


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The inputs of the cell as ``meta`` tensors; ``mode`` defaults to
    ``shape.kind``.

    train  : full batch {tokens|embeds(+labels)} (+ decoder tokens, encdec)
    prefill: same tensors, serving batch (encdec: ``cfg.enc_seq`` frames)
    decode : single-token batch (the cache comes separately)

    Token ids are int32 and embeddings bfloat16, as in the JAX package."""
    mode = mode or shape.kind
    b, s = shape.global_batch, shape.seq_len

    def tok(bb, ss):
        return torch.empty((bb, ss), dtype=torch.int32, device="meta")

    def emb(bb, ss):
        return torch.empty((bb, ss, cfg.d_model), dtype=torch.bfloat16,
                           device="meta")

    if mode == "decode":
        if cfg.input_kind == "embeds":
            return {"embeds": emb(b, 1), "labels": tok(b, 1)}
        return {"tokens": tok(b, 1)}
    if cfg.input_kind == "embeds":
        return {"embeds": emb(b, s), "labels": tok(b, s)}
    if cfg.input_kind == "encdec":
        if mode == "train":
            return {"embeds": emb(b, s), "tokens": tok(b, s)}
        return {"embeds": emb(b, cfg.enc_seq), "tokens": tok(b, s)}
    return {"tokens": tok(b, s)}


def cache_specs_for(cfg: ArchConfig, shape: ShapeConfig) -> Any:
    """The abstract cache of a decode cell: the bundle's ``init_cache``
    for ``shape.global_batch`` rows of ``shape.seq_len`` positions on
    ``meta`` (its ``pos`` a Python int, as the port keeps it)."""
    return get_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")


def batch_pspec(specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The partition spec of each batch entry (anything with a
    ``shape``) on ``mesh``: its batch dim over (pod, data) by
    :func:`~repro_torch.models.sharding.batch_spec`."""
    axes = sharding.mesh_axes_of(mesh)
    return {k: sharding.batch_spec(tuple(v.shape), axes)
            for k, v in specs.items()}
