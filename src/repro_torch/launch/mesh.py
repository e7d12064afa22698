"""Device meshes (PyTorch port of the JAX package's ``launch/mesh.py``):
the model substrate's production meshes and the planner's and solver's.

A mesh here is a grid of ``torch.device``s with named axes, driven by one
process: ``core/vectorized.py`` runs each shard of a solve on its entry's
device and steps every shard sweep by sweep, and
``models/pipeline.py`` runs each pipeline stage on its entry's device,
as the reference's single controller drives every device of a
``jax.sharding.Mesh``. No process group is formed. The same device may
fill several entries, so one card, or the CPU, can run a (2, 1) or (1,
2) mesh; that changes no result. ``models/transformer.py`` runs a model
sharded over a (data, model) mesh, each entry's part on its device and
the collectives between entries through ``DeviceMesh.all_reduce``,
``all_gather``, ``reduce_scatter``, ``all_to_all`` and ``pmean``. A mesh
of ``"meta"`` entries is the dry run's stand-in for the reference's
placeholder devices (``--xla_force_host_platform_device_count``): it has
the production shape, and nothing runs on it (``launch/dryrun.py``). A
mesh's
``hops`` counts the bytes moved between its entries
(``DeviceMesh.hop``).

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
        self.hops: Dict[str, int] = {}

    def hop(self, x: torch.Tensor, device, kind: str = "collective-permute"
            ) -> torch.Tensor:
        """``x`` copied to ``device`` (an entry's), a copy even where the
        entry is ``x``'s own device, as a transfer between two entries is;
        autograd flows through it. Its bytes are added to ``hops[kind]``,
        the reference's count of a collective: each participant's output
        bytes."""
        self.count(kind, x.numel() * x.element_size())
        return x.to(device, copy=True)

    def count(self, kind: str, nbytes: int) -> None:
        """Add ``nbytes`` to ``hops[kind]``."""
        self.hops[kind] = self.hops.get(kind, 0) + int(nbytes)

    # -- collectives ----------------------------------------------------
    # Each works over the entries along one named axis: ``xs`` holds one
    # tensor for each entry along ``axis``, in the axis's order, each on
    # its entry's device, and the result is one tensor for each of those
    # entries, on its device. Data moves between entries by ``hop``'s copy,
    # autograd flows through every one, and each adds to ``hops[kind]`` the
    # bytes of every participant's output, as the reference counts a
    # collective. Along an axis of size 1 each returns ``xs`` as it is and
    # counts nothing, as XLA drops a collective over one device.

    def _along(self, xs: Sequence[torch.Tensor], axis: str) -> int:
        n = self.shape[axis]
        if len(xs) != n:
            raise ValueError(f"axis {axis!r} has {n} entries, got "
                             f"{len(xs)} tensors")
        return n

    def _out(self, kind: str, outs: list) -> list:
        self.count(kind, sum(t.numel() * t.element_size() for t in outs))
        return outs

    @staticmethod
    def _sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The sum of ``parts`` on ``device`` in a fixed order: entry 0
        first, then 1, 2, ..., in float32 where they are narrower (bfloat16,
        float16), cast back once at the end."""
        dtype = parts[0].dtype
        wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
            else dtype
        acc = parts[0].to(device=device, dtype=wide, copy=True)
        for x in parts[1:]:
            acc = acc + x.to(device=device, dtype=wide)
        return acc.to(dtype)

    def all_reduce(self, xs, axis: str) -> list:
        """Every entry gets the sum of ``xs``, summed in a fixed order
        (entry 0 first, then 1, 2, ...; bfloat16 and float16 accumulated in
        float32 and cast back once), so every entry holds the same bits and
        a run is deterministic."""
        if self._along(xs, axis) == 1:
            return list(xs)
        total = self._sum(xs, xs[0].device)
        return self._out("all-reduce",
                         [total.to(x.device, copy=True) for x in xs])

    def pmean(self, xs, axis: str) -> list:
        """``all_reduce`` divided by the axis's size (counted as an
        all-reduce)."""
        n = self._along(xs, axis)
        return [t / n for t in self.all_reduce(xs, axis)] if n > 1 \
            else list(xs)

    def all_gather(self, xs, axis: str, dim: int) -> list:
        """Every entry gets ``xs`` concatenated along ``dim`` in the
        entries' order."""
        if self._along(xs, axis) == 1:
            return list(xs)
        return self._out("all-gather", [
            torch.cat([x.to(d.device) for x in xs], dim) for d in xs])

    def reduce_scatter(self, xs, axis: str, dim: int) -> list:
        """Entry j gets the j-th of n equal chunks along ``dim`` of the sum
        of ``xs``, summed in ``all_reduce``'s fixed order."""
        n = self._along(xs, axis)
        if n == 1:
            return list(xs)
        if xs[0].shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(xs[0].shape)} does "
                             f"not split into {n} chunks")
        chunks = [x.chunk(n, dim) for x in xs]
        return self._out("reduce-scatter", [
            self._sum([c[j] for c in chunks], xs[j].device)
            for j in range(n)])

    def all_to_all(self, xs, axis: str, split_axis: int,
                   concat_axis: int) -> list:
        """``jax.lax.all_to_all(..., tiled=True)``: each entry's tensor
        split into n equal chunks along ``split_axis``; entry j gets the
        j-th chunk of every entry, concatenated along ``concat_axis`` in
        the entries' order."""
        n = self._along(xs, axis)
        if n == 1:
            return list(xs)
        if xs[0].shape[split_axis] % n:
            raise ValueError(f"dimension {split_axis} of "
                             f"{tuple(xs[0].shape)} does not split into {n} "
                             f"chunks")
        chunks = [x.chunk(n, split_axis) for x in xs]
        return self._out("all-to-all", [
            torch.cat([c[j].to(xs[j].device) for c in chunks], concat_axis)
            for j in range(n)])

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


def _grid(shape, axes, devices: Optional[Sequence]) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (every CUDA card unless given;
    a list may name one device more than once), which must fill it."""
    devs = _devices(devices)
    n = int(np.prod(shape))
    if len(devs) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> DeviceMesh:
    """Single pod: (16, 16) = 256 entries on ("data", "model"). Multi-pod:
    (2, 16, 16) = 512 on ("pod", "data", "model"); the pod axis carries
    the cross-pod data-parallel replica dimension. ``devices`` (256 or
    512 of them) defaults to every CUDA card, as the reference's defaults
    to every JAX device; the dry run passes ``["meta"] * n``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)


def make_mesh_for(devices: Sequence, model_parallel: int = 1) -> DeviceMesh:
    """Elastic-scaling helper: the (data, model) mesh over ``devices``,
    which may name one device more than once (the reference's takes a
    count of the process's JAX devices)."""
    devs = _devices(devices)
    if model_parallel < 1 or len(devs) % model_parallel:
        raise ValueError(f"{len(devs)} devices do not split into model "
                         f"shards of {model_parallel}")
    return _grid((len(devs) // model_parallel, model_parallel),
                 ("data", "model"), devs)


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
