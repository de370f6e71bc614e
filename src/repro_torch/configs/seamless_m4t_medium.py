"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec backbone, frame stub."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    enc_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, pattern=("global",),
    cross_attention=True, frontend="frames", act="gelu",
)
