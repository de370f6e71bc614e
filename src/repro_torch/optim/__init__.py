"""Optimizer: AdamW with a warmup + cosine schedule and global-norm
clipping (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_updates, global_norm,
                                     init_state, schedule)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "schedule"]
