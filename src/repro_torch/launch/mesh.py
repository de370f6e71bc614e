"""Production meshes of H100 cards for the dry-run.

Counterpart of ``repro.launch.mesh``, whose meshes are TPU v5e pods (a
16 x 16 pod with a model axis of 16). The port's are H100 deployments:
``"h100x1"``, one card, and one HGX H100 node of 8 cards joined all to all
by NVLink through its NVSwitches, laid out (data x model) as 8 data-parallel
slices (``"h100x8"``), as one slice of 8 model coordinates (``"h100x8_m8"``)
or as 2 slices of 4 (``"h100x8_m4"``): tensor parallelism inside a slice,
which ``launch/cells.py`` counts for one card, the collectives over the
model axis among them. The meshes are of meta devices: the dry-run counts
one card's program and touches no card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.meshes import Mesh

MESHES = {"h100x1": {"data": 1, "model": 1},
          "h100x8": {"data": 8, "model": 1},
          "h100x8_m8": {"data": 1, "model": 8},
          "h100x8_m4": {"data": 2, "model": 4}}


def meta_mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh whose every entry is the meta device."""
    devices = np.empty(data * model, dtype=object)
    devices[:] = [torch.device("meta")] * (data * model)
    return Mesh(devices.reshape(data, model), ("data", "model"))


def make_production_mesh(name: str = "h100x1") -> Mesh:
    """The mesh ``name`` (``MESHES``), each entry the meta device."""
    return meta_mesh(MESHES[name]["data"], MESHES[name]["model"])
