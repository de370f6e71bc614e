"""Optimizer: AdamW with a warmup + cosine schedule, global-norm clipping
and the ZeRO-1 moment layout (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_sharded_updates,
                                     global_norm, schedule, state_logical,
                                     zero1_logical)

__all__ = ["AdamWConfig", "apply_sharded_updates", "global_norm", "schedule",
           "state_logical", "zero1_logical"]
