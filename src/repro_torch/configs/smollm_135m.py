"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense", num_layers=30, d_model=576,
    num_heads=9, num_kv_heads=3, d_ff=1536, vocab_size=49152,
    pattern=("global",), act="silu", rope_theta=10000.0,
)
