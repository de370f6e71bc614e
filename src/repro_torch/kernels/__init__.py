"""Hand-written CUDA kernels for Hopper (sm_90a).

flash_attention -- causal / sliding-window / softcap / GQA attention,
                   forward (replaces the Pallas TPU kernel of the same name;
                   also writes the rows' log-sum-exp for training) and
                   backward (dq, dk, dv; the Pallas kernel has none)
ssd             -- the Mamba-2 SSD chunked scan, forward, with its final
                   state (replaces the Pallas TPU kernel ``ssd_scan``), and
                   backward (dx, ddt, da_log, dB, dC; the Pallas kernel has
                   none)
rglru           -- the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t,
                   with an optional initial state (replaces the Pallas TPU
                   kernel ``rglru_scan_pallas``), and backward (da, db,
                   dh0; the Pallas kernel has none)
reshard         -- the reshard's transfer engine: a table of strided boxes
                   copied bit for bit in one launch (replaces no TPU
                   kernel: the reference's reshard is ``jax.device_put``)

Each has csrc/ (the CUDA source, plain C interface), kernel.py (build,
ctypes binding, checks, launch count), ops.py (dispatch: the kernel for CUDA
tensors, the plain version for CPU tensors; through a
``torch.autograd.Function`` whose backward is the backward kernel when a
gradient is needed) and ref.py (the plain PyTorch version the kernel is
held against). build.py compiles the sources; bench.py times each kernel
against its plain version and its bound.

Besides its own ``launches``, each wrapper adds the CUDA kernels a call
puts on the stream, by name, to ``CUDA_KERNELS``: a profiled interval is
held to them (``bench.check_profile``).
"""
from collections import Counter

# every CUDA kernel the wrappers launched, by the name the profiler gives it
CUDA_KERNELS: Counter = Counter()
