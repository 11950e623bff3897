"""Architecture registry of the port: only the configs of the families it
has (dense, ssm, moe, mla_moe)."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.llama4_scout_17b_16e import CONFIG as llama4_scout_17b_16e
from repro_torch.configs.phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in
                                 [deepseek_v2_lite_16b, llama3_8b,
                                  llama4_scout_17b_16e, phi3_mini_3_8b,
                                  qwen2_1_5b, qwen3_14b, rwkv6_7b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable"]
