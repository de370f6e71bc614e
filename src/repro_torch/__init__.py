"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

It mirrors ``repro``'s module names, imports ``torch`` and never ``jax``
or anything of ``repro``, and keeps its own copy of what it needs. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
