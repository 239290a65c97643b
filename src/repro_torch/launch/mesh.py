"""Mesh descriptors: the port of ``repro/launch/mesh.py``.

The JAX package lays its steps out over TPU pod meshes.  The port runs on
one card, so a mesh here is a descriptor only: its ``axis_names``, a
``shape`` mapping from name to size and a ``devices`` array (``.size`` is
the chip count).  The production meshes keep the JAX package's axes and
sizes with no devices behind them, so that the sharding rules
(``repro_torch.sharding``, ``launch/shardings.py``) can be held against
JAX's under the same names; ``make_local_mesh`` is (data=1, model=1) over
the one visible card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.kernels.common import resolve_device


class Mesh:
    """Axis names, their sizes, and the devices (None where the mesh is a
    descriptor of chips this process does not have)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[np.ndarray] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not name its axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.devices = (np.full(tuple(shape), None, dtype=object)
                        if devices is None else devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod:  (pod=2, data=16, model=16) = 512 chips.
    Descriptors only: no device stands behind them."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """(data=1, model=1) over the one visible card (CUDA unless ``device``
    names another): the port runs on one device, so larger sizes are cut
    to 1, as the JAX package cuts them to the devices it sees."""
    del data, model
    dev = np.empty((1, 1), dtype=object)
    dev[0, 0] = resolve_device(device)
    return Mesh((1, 1), ("data", "model"), dev)


def mesh_num_chips(mesh) -> int:
    return mesh.devices.size


def data_axis_size(mesh) -> int:
    size = mesh.shape.get("data", 1)
    if "pod" in mesh.axis_names:
        size *= mesh.shape["pod"]
    return size


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
