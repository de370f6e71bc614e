"""PaliGemma-3B [arXiv:2407.07726] — SigLIP patch stub + gemma backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=257216, pattern=("global",), frontend="patches",
    frontend_tokens=256, act="gelu", embed_scale=True,
)
