"""Architecture config registry of the port — ``--arch <id>`` resolution.

The port runs the dense, attention-only families so far: ``qwen2-7b``,
``llama3-8b`` and the paper's own Qwen2.5 ladder. The JAX package's other
families (recurrent, hybrid, MoE, encoder-decoder, vision) join with their
models in later slices; asking for one raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.core.schedule import SyncSchedule
from repro_torch.types import ModelConfig, reduced

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
}

PORTED_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    """Resolve an architecture id to its full-size ModelConfig."""
    if name in _MODULES:
        return importlib.import_module(_MODULES[name]).CONFIG
    from repro_torch.configs.qwen25_paper import LADDER

    if name in LADDER:
        return LADDER[name]
    raise KeyError(
        f"unknown or not yet ported arch {name!r}; available: "
        f"{sorted(_MODULES) + sorted(LADDER)}"
    )


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of the same family (2 layers-ish, d<=256)."""
    return reduced(get_config(name), **overrides)


def list_configs() -> list[str]:
    from repro_torch.configs.qwen25_paper import LADDER

    return list(PORTED_ARCHS) + list(LADDER)


def schedule_from_config(config: ModelConfig) -> SyncSchedule:
    """The sync schedule induced by the pattern's structural sync flags."""
    return SyncSchedule(tuple(s.sync for s in config.layer_specs()))
