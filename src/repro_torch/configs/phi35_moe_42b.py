"""Phi-3.5-MoE (42B/6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=6400,
    vocab_size=32064, pattern=("moe",), num_experts=16, top_k=2,
    expert_d_ff=6400, act="silu", rope_theta=10000.0,
    tie_embeddings=False,
)
