"""Mamba-2 SSD chunked scan: CUDA kernel, its binding and plain version."""
