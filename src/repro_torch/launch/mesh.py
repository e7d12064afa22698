"""Device meshes for the sharded planner (PyTorch port of the JAX
package's ``launch/mesh.py``, its planner and solver meshes).

A mesh here is a grid of ``torch.device``s with named axes, driven by one
process: ``core/vectorized.py`` runs each shard of a solve on its entry's
device and steps every shard sweep by sweep, as the reference's single
controller drives every device of a ``jax.sharding.Mesh``. No process
group is formed. The same device may fill several entries, so one card,
or the CPU, can run a (2, 1) or (1, 2) mesh; that changes no result.

The model substrate's production meshes (``make_production_mesh``,
``make_mesh_for``) are not ported yet (ROADMAP.md, Queue 1, item 10).
Nothing here touches a device when the module is imported.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class DeviceMesh:
    """A grid of devices (``devices``, a numpy object array) with one name
    per axis; ``shape`` maps each name to its size, as a JAX mesh's."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        grid[...] = devices
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs as many "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _devices(devices: Optional[Sequence]) -> list:
    """The caller's devices, or every CUDA card (raises without one)."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_solver_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """1-D chains mesh for the distributed annealer."""
    return DeviceMesh(_devices(devices), ("chains",))


def make_planner_mesh(chains: int = 1,
                      devices: Optional[Sequence] = None) -> DeviceMesh:
    """2-D (prob, chain) mesh for the batched multi-tenant annealer
    (``Agora.plan_many`` / ``vectorized_anneal_many``): the problem axis
    spreads over ``len(devices) // chains`` devices, the chain axis over
    ``chains``. ``chains=1`` keeps the solve bit-identical to the
    single-device batched result (see core/vectorized.py).

    The problem axis is clamped to the largest power of two that fits, so
    it always divides the power-of-two problem bucket: with 6 devices and
    ``chains=1`` the mesh is (4, 1) and two devices sit out. ``devices``
    defaults to every CUDA card; a list may name one device more than
    once."""
    devs = _devices(devices)
    n = len(devs)
    if chains < 1 or n < chains or n % chains:
        raise ValueError(f"{n} devices do not split into chain shards of "
                         f"{chains}")
    prob = 1 << ((n // chains).bit_length() - 1)
    grid = np.empty((prob, chains), dtype=object)
    for k, d in enumerate(devs[:prob * chains]):
        grid[k // chains, k % chains] = d
    return DeviceMesh(grid, ("prob", "chain"))
