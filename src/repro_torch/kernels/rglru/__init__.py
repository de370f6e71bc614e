"""RG-LRU linear recurrence: CUDA kernel, its binding and plain version."""
