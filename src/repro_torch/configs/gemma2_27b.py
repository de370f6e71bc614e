"""Gemma2-27B [arXiv:2408.00118] — local+global alternating, softcaps."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense", num_layers=46, d_model=4608,
    num_heads=32, num_kv_heads=16, head_dim=128, d_ff=36864,
    vocab_size=256000, pattern=("local", "global"), sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, act="gelu",
    embed_scale=True, rope_theta=10000.0,
)
