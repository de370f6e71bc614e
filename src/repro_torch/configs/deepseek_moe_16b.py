"""DeepSeekMoE-16B [arXiv:2401.06066] — 2 shared + 64 routed top-6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
    vocab_size=102400, pattern=("moe",), num_experts=64, top_k=6,
    num_shared_experts=2, expert_d_ff=1408, first_dense_layers=1,
    first_dense_ff=10944, act="silu", rope_theta=10000.0,
)
