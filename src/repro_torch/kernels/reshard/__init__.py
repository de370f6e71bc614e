"""The reshard's transfer engine: CUDA box-copy kernel, its binding and
plain version."""
