"""Production meshes of H100 cards for the dry-run.

Counterpart of ``repro.launch.mesh``, whose meshes are TPU v5e pods. The
port's are H100 deployments: ``"h100x1"``, one card, and ``"h100x8"``, one
HGX H100 node of 8 cards joined all to all by NVLink through its
NVSwitches, as 8 data-parallel slices. Both have ``model`` 1: the trainer
runs tensor parallelism inside a slice, but the dry-run's count of one
card's share of it (a node as 1 x 8 or 2 x 4, and the bytes of its
collectives) is not ported yet (ROADMAP.md, Queue 1 item 13), so
``launch.cells.build_cell`` raises for a mesh with ``model > 1``. The
meshes are of meta devices: the dry-run counts one card's program and
touches no card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.meshes import Mesh

MESHES = {"h100x1": {"data": 1, "model": 1},
          "h100x8": {"data": 8, "model": 1}}


def make_production_mesh(name: str = "h100x1") -> Mesh:
    """The mesh ``name`` (``MESHES``), each entry the meta device."""
    data, model = MESHES[name]["data"], MESHES[name]["model"]
    devices = np.empty(data * model, dtype=object)
    devices[:] = [torch.device("meta")] * (data * model)
    return Mesh(devices.reshape(data, model), ("data", "model"))
