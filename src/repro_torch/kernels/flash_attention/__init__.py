"""Causal GQA flash attention: CUDA kernel, its binding and plain version."""
