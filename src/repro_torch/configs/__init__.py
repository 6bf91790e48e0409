"""Config registry: --arch <id> resolution for every assigned architecture
(+ the paper's own workloads live in configs/sigdla_paper.py).

The port's own copy of the JAX package's ``configs``, as data: the same
``ArchConfig`` / ``ShapeConfig`` schema, the same ten architectures and
``reduced()``, so a config here equals its counterpart field for field
(``dataclasses.asdict``)."""

from .base import ArchConfig, ShapeConfig, SHAPES, LONG_CONTEXT_ARCHS

from . import (chatglm3_6b, gemma2_2b, grok1_314b, internvl2_26b,
               minitron_8b, qwen2_moe_a2_7b, recurrentgemma_2b,
               starcoder2_3b, whisper_small, xlstm_350m)

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    internvl2_26b, starcoder2_3b, chatglm3_6b, gemma2_2b, minitron_8b,
    xlstm_350m, whisper_small, recurrentgemma_2b, qwen2_moe_a2_7b,
    grok1_314b)}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    cfg.validate()
    return cfg


def list_configs():
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_applicable(arch: str, shape: str) -> bool:
    """The 40-cell grid minus documented skips (DESIGN.md §5)."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
