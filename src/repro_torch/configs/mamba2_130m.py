"""Mamba2-130M [arXiv:2405.21060] — SSD (state-space duality), attn-free."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
    pattern=("ssd",), ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    conv_width=4, ssd_chunk=128, act="silu",
)
