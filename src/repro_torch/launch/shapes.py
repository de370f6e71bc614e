"""Assigned input shapes x applicability rules (40 cells).

The port's copy of ``repro.launch.shapes``: the four shapes and which
architectures take the 500k one define the dry-run's cells, so they are
copied unchanged.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid (+ gemma2,
# whose local layers are O(window) and whose 23 global layers shard their
# 500k KV over the data axis); skip for pure full-attention archs.
LONG_OK = {"recurrentgemma-9b", "mamba2-130m", "gemma2-27b"}


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.name not in LONG_OK:
        return False, "pure full-attention arch: 500k KV has no sub-quadratic escape"
    return True, ""


def all_cells():
    from repro_torch.configs import list_archs
    for arch in list_archs():
        for shape in SHAPES:
            yield arch, shape
