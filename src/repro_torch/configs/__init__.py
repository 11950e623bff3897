"""Architecture registry of the port: only the dense configs it serves."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [llama3_8b, qwen2_1_5b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable"]
