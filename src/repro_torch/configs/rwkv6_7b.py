"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    sub_quadratic=True,
)
