"""qwen3-14b [dense] — qk_norm, GQA kv=8, head_dim=128 [hf:Qwen/Qwen3-14B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
)
