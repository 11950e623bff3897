"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 + 2 shared
experts, expert d_ff=1408 [arXiv:2405.04434; hf].

64 routed experts match the HF V2-Lite checkpoint (160 is the full V2)."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,                       # dense first layer (HF config)
    vocab=102400, rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)
