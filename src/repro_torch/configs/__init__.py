"""Architecture registry: ``--arch <id>`` resolves through ARCHS (the
reference's ten configs, each a copy)."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.llama4_scout_17b_16e import CONFIG as llama4_scout_17b_16e
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as llama_3_2_vision_11b
from repro_torch.configs.phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b

#: In the reference's registry order, which its sweeps and the dry-run's
#: ``--all`` follow.
ARCHS: dict[str, ModelConfig] = {c.name: c for c in
                                 [phi3_mini_3_8b, llama3_8b, qwen3_14b,
                                  qwen2_1_5b, deepseek_v2_lite_16b,
                                  llama4_scout_17b_16e, zamba2_2_7b, rwkv6_7b,
                                  whisper_medium, llama_3_2_vision_11b]}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable"]
