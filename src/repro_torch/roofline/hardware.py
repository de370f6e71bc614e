"""The NVIDIA H100 SXM5 (80 GB HBM3) constants every count in the port is
held against, kept in this one place: the kernels' bounds
(``kernels/bench.py``, ``kernels/work.py``) and the dry-run's roofline
(``roofline/analysis.py``) import them from here.

Sources: the NVIDIA H100 Tensor Core GPU data sheet (SXM5 column: dense
BF16 989 TFLOP/s, FP32 67 TFLOP/s, 3.35 TB/s of HBM3, 80 GB, NVLink 900
GB/s), at the card's full 700 W; a card set below that runs slower.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
PEAK_FP32_FLOPS = 67e12       # fp32 FLOP/s on the CUDA cores
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
HBM_BYTES = 80e9              # HBM3 capacity (the data sheet's 80 GB)
# NVLink 4: 18 links of 50 GB/s, 900 GB/s both directions together, so
# 450 GB/s each way between a card and the NVSwitches of an HGX H100 node
NVLINK_BYTES = 450e9
