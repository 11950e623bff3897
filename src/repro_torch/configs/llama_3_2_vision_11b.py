"""llama-3.2-vision-11b [vlm] — dense decoder + gated cross-attn image layers
every 5th layer; ViT frontend is a STUB (precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
    cross_attn_every=5, num_media_tokens=1601,
)
