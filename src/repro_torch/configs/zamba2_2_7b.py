"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every 6
layers (32 heads over 2*d_model concat input) [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, tie_embeddings=True,
    ssm=SSMConfig(kind="mamba2", d_state=64, expand=2, head_dim=64,
                  conv_kernel=4),
    shared_attn_every=6, shared_attn_heads=32, shared_attn_d_ff=10240,
    sub_quadratic=True,
)
