"""Data pipeline (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_batch

__all__ = ["DataConfig", "SyntheticLMData", "make_batch"]
