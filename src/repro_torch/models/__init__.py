"""Model zoo of the port: the architectures ported so far, on torch."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (build_model, get_model, list_archs,
                                         reduced_config)
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import CausalLM

__all__ = ["ModelConfig", "build_model", "get_model", "list_archs",
           "reduced_config", "CausalLM", "EncDecLM"]
