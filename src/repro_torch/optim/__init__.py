"""Optimizer: AdamW with a warmup + cosine schedule, global-norm clipping
and the ZeRO-1 moment layout, and the int8 compressed gradient all-reduce
(counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_sharded_updates,
                                     global_norm, schedule, state_logical,
                                     zero1_logical)
from repro_torch.optim.compression import (compressed_psum_grads,
                                           make_compressed_allreduce)

__all__ = ["AdamWConfig", "apply_sharded_updates", "compressed_psum_grads",
           "global_norm", "make_compressed_allreduce", "schedule",
           "state_logical", "zero1_logical"]
