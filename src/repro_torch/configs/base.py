"""Model / run configuration dataclasses (a copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX package;
``ModelConfig``, ``ShapeConfig`` and ``reduced()`` are kept verbatim so that a
config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    first_dense_layers: int = 0  # leading dense layers before MoE stack


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 = no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"         # "mamba2" | "rwkv6"
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 256             # SSD/WKV sequence-chunk length
    scores_dtype: str = "float32"   # intra-chunk decay-matrix dtype


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 131_072

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # Zamba2: one weight-shared attention+MLP block invoked every k layers.
    shared_attn_every: int = 0
    shared_attn_heads: int = 0
    shared_attn_d_ff: int = 0

    # Llama-3.2-Vision: cross-attention layers every k layers.
    cross_attn_every: int = 0
    num_media_tokens: int = 0    # stub frontend: precomputed patch/frame embeds

    # Whisper: encoder-decoder; n_layers is the decoder depth.
    encoder_layers: int = 0

    # numerics
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"

    # attention memory policy: chunked (online-softmax) KV blocking above this
    attn_chunk: int = 1024
    # fully unroll layer/sequence scans (roofline costing only)
    scan_unroll: bool = False
    # activation remat policy: nothing | dots | dots_nb
    remat_policy: str = "nothing"

    sub_quadratic: bool = False  # True for ssm/hybrid: may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.shared_attn_every else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab=256,
            max_seq=128,
            num_media_tokens=min(self.num_media_tokens, 16) if self.num_media_tokens else 0,
            attn_chunk=32,
            dtype="float32",
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                num_shared=min(self.moe.num_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.mla:
            changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                       qk_nope_head_dim=16, qk_rope_head_dim=8,
                                       v_head_dim=16)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
            changes["shared_attn_heads"] = 4
            changes["shared_attn_d_ff"] = 128
        if self.cross_attn_every:
            changes["cross_attn_every"] = 2
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (DESIGN.md S4)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


import dataclasses as _dc


def depth_scaled(cfg: ModelConfig, units: int) -> ModelConfig:
    """A structurally-identical config with ``units`` repeating units
    (layers or groups) and fully-unrolled scans — used by the roofline
    analysis to measure exact per-unit HLO cost marginals (XLA's
    cost_analysis counts while-loop bodies once, so full-depth scanned
    programs cannot be costed directly)."""
    ch: dict = {"scan_unroll": True}
    if cfg.family == "hybrid":
        ch["n_layers"] = cfg.shared_attn_every * units
    elif cfg.family == "vlm":
        ch["n_layers"] = cfg.cross_attn_every * units
    elif cfg.family == "encdec":
        ch["n_layers"] = units
        ch["encoder_layers"] = units
    elif cfg.moe is not None and cfg.moe.first_dense_layers:
        ch["n_layers"] = cfg.moe.first_dense_layers + units
    else:
        ch["n_layers"] = units
    return _dc.replace(cfg, **ch)


def depth_units(cfg: ModelConfig) -> int:
    """Number of repeating units at full depth (for extrapolation)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "encdec":
        return cfg.n_layers
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        return cfg.n_layers - cfg.moe.first_dense_layers
    return cfg.n_layers
