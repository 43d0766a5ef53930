"""repro_torch.configs — the assigned architecture configs and shapes: a
copy of the reference's pure dataclasses (``repro.configs``), so the port
needs no JAX.  ``--arch <id>`` resolves through :mod:`.registry`."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_for
from repro_torch.configs.registry import ARCH_IDS, ARCHS, get_config, smoke_config

__all__ = [
    "ARCHS",
    "ARCH_IDS",
    "ModelConfig",
    "SHAPES",
    "ShapeConfig",
    "get_config",
    "shape_for",
    "smoke_config",
]
