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
``all_gather``, ``reduce_scatter``, ``all_to_all`` and ``pmean``; the
entries may sit on different devices (the card and the CPU), each
collective moving its tensors between them. A mesh of ``"meta"``
entries is the dry run's stand-in for the reference's placeholder
devices (``--xla_force_host_platform_device_count``): it has the
production shape, and the model traces on it without allocating
(``launch/dryrun.py``). A mesh's ``hops`` counts the bytes moved
between its entries, by collective kind, in the reference's convention:
each participant's output bytes. While autograd records, a collective's
backward is counted too, under the kind of its transpose
(``DeviceMesh.count_backward``).

A mesh whose every entry is ``meta`` is abstract (``DeviceMesh.abstract``):
its entries all compute the same shapes, so the model runs entry (0, ...,
0) alone for all of them (``models/common.py:Entries``), each collective
returns that entry's ``meta`` result and counts every participant's
output bytes, and the dry run's counter weighs each op by the entries it
stands for (``standing_for``).

Nothing here touches a device when the module is imported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# the transpose of each collective kind: what its backward moves
TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
             "reduce-scatter": "all-gather", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute"}

_local = threading.local()


def stands_for() -> Optional[int]:
    """How many mesh entries each op that runs now stands for, as the
    innermost ``standing_for`` of this thread says; None outside one."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def listen(fn: Optional[Callable[[int, Optional[int]], None]]) -> None:
    """Have ``fn(sequence_nr, weight)`` called on this thread each time
    ``standing_for`` changes the weight: from autograd's next sequence
    number on, the nodes it creates stand for ``weight`` entries
    (``launch/dryrun.py``'s counter weighs the backward by them). None
    stops it."""
    _local.listener = fn


def _note(weight) -> None:
    fn = getattr(_local, "listener", None)
    if fn is not None:
        fn(torch._C._autograd._get_sequence_nr(), weight)


@contextlib.contextmanager
def standing_for(n: int):
    """Within it, each op stands for ``n`` mesh entries: the work of the
    one entry an abstract mesh runs for ``n`` (``Entries.grid``), 1 for
    work done once, 0 for a collective's own copies and sums, which
    ``hops`` counts apart. Only the dry run's counter reads it."""
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(n)
    _note(n)
    try:
        yield
    finally:
        stack.pop()
        _note(stack[-1] if stack else None)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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
        self.abstract = all(torch.device(d).type == "meta"
                            for d in grid.flat)

    def hop(self, x: torch.Tensor, device, kind: str = "collective-permute"
            ) -> torch.Tensor:
        """``x`` copied to ``device`` (an entry's), a copy even where the
        entry is ``x``'s own device, as a transfer between two entries is;
        autograd flows through it. Its bytes are added to ``hops[kind]``,
        the reference's count of a collective: each participant's output
        bytes; its backward, the same bytes back, under the same kind."""
        with standing_for(0):
            out = x.to(device, copy=True)
        return self._out(kind, [out], [x])[0]

    def count(self, kind: str, nbytes: int) -> None:
        """Add ``nbytes`` to ``hops[kind]``."""
        self.hops[kind] = self.hops.get(kind, 0) + int(nbytes)

    def count_backward(self, kind: str, outs, nbytes: int) -> None:
        """Where autograd records ``outs``, count ``nbytes`` under ``kind``
        once in the backward: when the first of ``outs`` receives its
        gradient. A hook only: no gradient changes, and a forward with no
        backward counts nothing here."""
        if not torch.is_grad_enabled():
            return
        live = {id(o): o for o in outs if o.requires_grad}
        if not live:
            return
        fired = []

        def hook(grad):
            if not fired:
                fired.append(True)
                self.count(kind, nbytes)
        for o in live.values():
            o.register_hook(hook)

    # -- collectives ----------------------------------------------------
    # Each works over the entries along one named axis: ``xs`` holds one
    # tensor for each entry along ``axis``, in the axis's order, each on
    # its entry's device, and the result is one tensor for each of those
    # entries, on its device. Data moves between entries by ``hop``'s copy,
    # autograd flows through every one, and each adds to ``hops[kind]`` the
    # bytes of every participant's output, as the reference counts a
    # collective, ``times`` over (the same collective on that many rows of
    # an abstract mesh's entries). Where autograd records, the backward
    # counts the transpose (``TRANSPOSE``): every participant's output
    # there is the gradient of its input, so the inputs' bytes. Along an
    # axis of size 1 each returns ``xs`` as it is and counts nothing, as
    # XLA drops a collective over one device. On an abstract mesh each
    # computes entry 0's result alone and gives it to every entry (every
    # entry's has the same shape); it still reads every input, so each
    # takes its gradient. A collective's own copies and sums stand for no
    # entry's compute (``standing_for(0)``).

    def _along(self, xs: Sequence[torch.Tensor], axis: str) -> int:
        n = self.shape[axis]
        if len(xs) != n:
            raise ValueError(f"axis {axis!r} has {n} entries, got "
                             f"{len(xs)} tensors")
        return n

    def _out(self, kind: str, outs: list, ins, times: int = 1) -> list:
        if self.abstract:
            outs = outs[:1] * len(ins)
        self.count(kind, times * _nbytes(outs))
        self.count_backward(TRANSPOSE[kind], outs, times * _nbytes(ins))
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

    def all_reduce(self, xs, axis: str, times: int = 1) -> list:
        """Every entry gets the sum of ``xs``, summed in a fixed order
        (entry 0 first, then 1, 2, ...; bfloat16 and float16 accumulated in
        float32 and cast back once), so every entry holds the same bits and
        a run is deterministic."""
        n = self._along(xs, axis)
        if n == 1:
            return list(xs)
        with standing_for(0):
            total = self._sum(xs, xs[0].device)
            outs = ([total] * n if self.abstract else
                    [total.to(x.device, copy=True) for x in xs])
        return self._out("all-reduce", outs, xs, times)

    def pmean(self, xs, axis: str, times: int = 1) -> list:
        """``all_reduce`` divided by the axis's size (counted as an
        all-reduce); each entry divides its own sum."""
        n = self._along(xs, axis)
        return [t / n for t in self.all_reduce(xs, axis, times)] if n > 1 \
            else list(xs)

    def all_gather(self, xs, axis: str, dim: int, times: int = 1) -> list:
        """Every entry gets ``xs`` concatenated along ``dim`` in the
        entries' order."""
        n = self._along(xs, axis)
        if n == 1:
            return list(xs)
        with standing_for(0):
            outs = [torch.cat([x.to(d.device) for x in xs], dim)
                    for d in (xs[:1] if self.abstract else xs)]
        return self._out("all-gather", outs, xs, times)

    def reduce_scatter(self, xs, axis: str, dim: int, times: int = 1) -> list:
        """Entry j gets the j-th of n equal chunks along ``dim`` of the sum
        of ``xs``, summed in ``all_reduce``'s fixed order."""
        n = self._along(xs, axis)
        if n == 1:
            return list(xs)
        if xs[0].shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(xs[0].shape)} does "
                             f"not split into {n} chunks")
        with standing_for(0):
            chunks = [x.chunk(n, dim) for x in xs]
            outs = [self._sum([c[j] for c in chunks], xs[j].device)
                    for j in range(1 if self.abstract else n)]
        return self._out("reduce-scatter", outs, xs, times)

    def all_to_all(self, xs, axis: str, split_axis: int,
                   concat_axis: int, times: int = 1) -> list:
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
        with standing_for(0):
            chunks = [x.chunk(n, split_axis) for x in xs]
            outs = [torch.cat([c[j].to(xs[j].device) for c in chunks],
                              concat_axis)
                    for j in range(1 if self.abstract else n)]
        return self._out("all-to-all", outs, xs, times)

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
