"""whisper-medium [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs supplies 1500 precomputed frame embeddings) [arXiv:2212.04356].
24 encoder + 24 decoder layers."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, num_media_tokens=1500,
    max_seq=524_288,     # positional table sized for the assigned shapes
)
