"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].  Early-fusion frontend out of scope
(the text backbone)."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, num_shared=1),
)
