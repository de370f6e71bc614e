"""Data pipeline (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                       batch_specs, make_batch)

__all__ = ["DataConfig", "SyntheticLMData", "batch_specs", "make_batch"]
