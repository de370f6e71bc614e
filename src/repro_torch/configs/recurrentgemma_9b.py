"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 2:1."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, pattern=("rglru", "rglru", "local"),
    sliding_window=2048, lru_width=4096, conv_width=4, act="gelu",
    embed_scale=True, rope_theta=10000.0,
)
