"""Shared model-config and parameter utilities (PyTorch port of
``repro/models/common.py``).

Every assigned architecture is expressed as one ``ModelConfig``, the
reference's own fields; ``cdtype`` and ``pdtype`` are torch dtypes here.
Parameters are nested dicts of tensors, drawn by ``Initializer`` from an
explicit ``torch.Generator`` on the card (or the CPU where the caller asks
for it) with the reference's init kinds and scales.

The mesh rules are the reference's: the axis names (``DATA_AXES``,
``TP_AXIS``), the logical-axis table (``_phys``) and ``spec_for``, which
read only a mesh's ``axis_names`` and ``shape`` and so take the port's
``launch/mesh.py:DeviceMesh``. ``P`` stands in for JAX's
``PartitionSpec``: a tuple with one entry a dimension (a mesh axis name, a
tuple of names, or None). The specs say how the reference lays each leaf
out; the dry run divides each argument's bytes by them
(``launch/dryrun.py``), and a model sharded at run time
(``models/transformer.py``) gives each mesh entry its block of a leaf by
them (``shard``, ``Entries``). An abstract ``Initializer``
(``abstract=True``, or ``device="meta"``) draws nothing: every leaf is an
empty tensor on the ``meta`` device, its spec recorded under the
reference's path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import standing_for
from repro_torch.tree import flatten, leaves, map_tree

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 256

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0          # merged shared-expert hidden width (0 = none)
    capacity_factor: float = 1.25
    first_dense: int = 0          # leading dense layers (deepseek-v2-lite: 1)
    router_aux_coef: float = 0.01

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = True       # absorbed (compressed-space) decode attention

    # --- SSM / hybrid ---
    block_pattern: str = "attn"   # attn | mamba2 | rwkv6 | zamba2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    shared_attn_every: int = 0    # zamba2: shared attn block every N mamba layers
    gla_chunk: int = 128          # chunk length for chunked linear attention

    # --- VLM ---
    cross_attn_every: int = 0     # insert a cross-attn layer every N self layers
    num_patches: int = 0          # image patch-embedding count (stub frontend)

    # --- modality stubs ---
    embedding_inputs: bool = False  # inputs are precomputed frame embeddings

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"
    remat: str = "full"           # none | full | dots
    logit_chunk: int = 0          # 0 = single-shot loss; else seq-chunked CE
    attn_chunk: int = 1024        # query-chunk for blockwise (flash-style) attention
    scan_layers: bool = True      # False: unroll layer loop (dry-run accounting —
                                  # XLA cost_analysis counts while bodies once)
    # --- performance flags (hillclimb levers; see EXPERIMENTS.md §Perf) ---
    fast_norm: bool = False       # RMSNorm keeps the tensor bf16 (f32 stats
                                  # only) so TP all-reduces stay bf16
    seq_parallel: bool = False    # sequence-sharded residual stream between
                                  # blocks (all-reduce -> RS+AG)
    moe_sp_dispatch: bool = False # MoE routes sequence-sharded tokens per TP
                                  # rank instead of replicated routing

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Mesh axis conventions
# ---------------------------------------------------------------------------

DATA_AXES: Tuple[str, ...] = ("pod", "data")  # pod axis absent on single-pod
TP_AXIS = "model"


class P(tuple):
    """A partition spec: one entry a dimension of the array, each a mesh
    axis name, a tuple of names, or None (replicated), as JAX's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def dp_for(mesh, dim: int):
    """The reference's ``_dp_for``: the data axes of ``mesh``, where their
    sizes' product is above 1 and divides ``dim`` (a batch), else None (the
    batch replicated over them)."""
    if mesh is None:
        return None
    dp = data_axes(mesh)
    n = math.prod(axis_size(mesh, a) for a in dp)
    return dp if (n > 1 and dim % n == 0) else None


# ---------------------------------------------------------------------------
# Logical-axis -> partition spec rules
# ---------------------------------------------------------------------------

# Logical axis vocabulary used by param initializers.
#   "embed"    : d_model            -> replicated
#   "vocab"    : vocabulary          -> model
#   "heads"    : attention heads     -> model
#   "kv_heads" : kv heads            -> model if divisible else replicated
#   "mlp"      : ffn hidden          -> model
#   "experts"  : MoE experts         -> model (expert parallel)
#   "inner"    : ssm inner dim       -> model
#   "layers"   : stacked scan dim    -> replicated
#   None       : replicated


def _phys(logical: str, mesh, dim: int):
    if mesh is None:
        return None
    if logical in ("vocab", "heads", "mlp", "experts", "inner", "kv_heads"):
        m = axis_size(mesh, TP_AXIS)
        return TP_AXIS if (m > 1 and dim % m == 0) else None
    return None


def spec_for(logical_axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             mesh) -> P:
    """The spec of an array of ``shape`` whose dimensions carry
    ``logical_axes``: each logical axis on its mesh axis where that axis
    is larger than 1 and divides the dimension, one mesh axis at most once
    a spec."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    used = set()
    out = []
    for ax, dim in zip(logical_axes, shape):
        p = _phys(ax, mesh, dim) if ax else None
        if p in used:  # one mesh axis at most once per spec
            p = None
        if p:
            used.add(p)
        out.append(p)
    return P(*out)


def shard(x: torch.Tensor, spec, mesh, coords: Dict[str, int]):
    """The block of ``x`` that the entry at ``coords`` (mesh axis name ->
    index) holds under ``spec``: each dimension whose entry names mesh axes
    cut into as many equal parts as those axes have entries together (the
    first axis named the major one), the entry's part kept. A view of
    ``x``; ``x`` itself where ``spec`` shards nothing."""
    index = []
    for dim, entry in zip(x.shape, spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n, pos = 1, 0
        for a in axes:
            n, pos = n * mesh.shape[a], pos * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"a dimension of {dim} does not split over "
                             f"{axes}")
        index.append(slice(pos * (dim // n), (pos + 1) * (dim // n))
                     if n > 1 else slice(None))
    return x[tuple(index)] if any(s != slice(None) for s in index) else x


def block_bytes(x: torch.Tensor, spec, mesh) -> int:
    """The bytes of one entry's block of ``x`` under ``spec``: ``x``'s
    bytes over the sizes of the mesh axes the spec names."""
    ways = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                ways *= mesh.shape[axis]
    return x.numel() * x.element_size() // ways


class _Represent(torch.autograd.Function):
    """The leaf that an abstract mesh's one entry reads for all ``n``
    (``Entries.part``): the leaf itself forward; backward, the ``n - 1``
    sums with which autograd gathers the ``n`` entries' gradients of a
    shared leaf, done once for all (``standing_for(1)``), so the dry run
    counts them as a run of every entry does."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with standing_for(1):
            acc = g
            for _ in range(ctx.n - 1):
                acc = acc + g
        return acc, None


class Entries:
    """A (data, model) mesh as a model runs over it: D rows, one a data
    shard (the data axes "pod" and "data", pod the major), by M columns,
    one a ``model`` rank. ``devices[i][j]`` and ``coords[i][j]`` (mesh axis
    name -> index) are entry (i, j)'s; axes of the mesh other than these
    stand at index 0 (their replicas compute what index 0 does, and are
    not run). A grid is a list of D lists of M values, one an entry.
    ``part`` cuts a leaf by its spec; the ``model_*`` collectives run each
    row's entries through the mesh's collective over ``model``, and
    ``pmean`` over the named axes.

    On an abstract mesh (every entry ``meta``: the dry run's) every entry
    computes the same shapes, so ``grid`` runs entry (0, 0) alone, its ops
    standing for all D M entries (``launch/mesh.py:standing_for``), and
    gives its value to every cell; each ``model_*`` collective runs row 0
    for the D rows; ``part`` and ``head_rows`` keep the tape's sums those
    of a run of every entry. Work that loops over the entries itself (the
    ``pmean`` groups, a cache write that only the rank holding the
    position does) runs for each, so it is counted as it runs."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = data_axes(mesh)
        sizes = [axis_size(mesh, a) for a in self.dp]
        self.D = math.prod(sizes)
        self.M = axis_size(mesh, TP_AXIS)
        self.one = bool(getattr(mesh, "abstract", False))
        self.coords, self.devices = [], []
        for i in range(self.D):
            at, rest = {}, i
            for a, n in reversed(list(zip(self.dp, sizes))):
                at[a], rest = rest % n, rest // n
            row_c, row_d = [], []
            for j in range(self.M):
                c = {a: 0 for a in mesh.axis_names}
                c.update(at)
                if TP_AXIS in c:
                    c[TP_AXIS] = j
                row_c.append(c)
                row_d.append(resolve_device(mesh.devices[tuple(
                    c[a] for a in mesh.axis_names)]))
            self.coords.append(row_c)
            self.devices.append(row_d)

    def grid(self, fn):
        """[[fn(i, j) for each model rank j] for each data row i]; on an
        abstract mesh fn(0, 0) in every cell."""
        if self.one:
            with standing_for(self.D * self.M):
                r = fn(0, 0)
            return [[r] * self.M for _ in range(self.D)]
        return [[fn(i, j) for j in range(self.M)] for i in range(self.D)]

    def part(self, x: torch.Tensor, spec, i: int, j: int) -> torch.Tensor:
        """Entry (i, j)'s block of ``x`` by ``spec`` (``shard``) on its
        device: a view of ``x`` where ``x`` is on that device already (no
        copy: a replicated leaf is ``x`` itself), else a copy there. On an
        abstract mesh a leaf that takes a gradient is read through
        ``_Represent``."""
        if self.one and x.requires_grad:
            x = _Represent.apply(x, self.D * self.M)
        return shard(x, spec, self.mesh, self.coords[i][j]).to(
            self.devices[i][j])

    def head_rows(self, g, device):
        """Each data row's value at model rank 0, on ``device``, for work
        done once over every row (the logits' concatenation). On an
        abstract mesh row 0's value, and for the other rows its copies cut
        from the tape: their work is row 0's, already weighed."""
        if self.one:
            return [g[0][0]] + [g[0][0].detach()] * (self.D - 1)
        return [row[0].to(device) for row in g]

    def _rows(self, g, call):
        """``call(row, times)`` on each row of ``g``: the mesh's collective
        over ``model`` (nothing where the mesh has no model axis); on an
        abstract mesh row 0's, counted for the D rows."""
        if self.M == 1:
            return g
        if self.one:
            outs = call(g[0], self.D)
            return [list(outs) for _ in range(self.D)]
        return [call(row, 1) for row in g]

    def model_all_reduce(self, g):
        return self._rows(g, lambda row, t: self.mesh.all_reduce(
            row, TP_AXIS, times=t))

    def model_all_gather(self, g, dim: int):
        return self._rows(g, lambda row, t: self.mesh.all_gather(
            row, TP_AXIS, dim, times=t))

    def model_reduce_scatter(self, g, dim: int):
        return self._rows(g, lambda row, t: self.mesh.reduce_scatter(
            row, TP_AXIS, dim, times=t))

    def model_all_to_all(self, g, split_axis: int, concat_axis: int):
        return self._rows(g, lambda row, t: self.mesh.all_to_all(
            row, TP_AXIS, split_axis, concat_axis, times=t))

    def pmean(self, g, axes):
        """``g`` averaged over each of ``axes`` in turn (the mesh's
        ``pmean``: among the entries that differ only in that axis)."""
        out = [list(row) for row in g]
        for axis in axes:
            groups: Dict[tuple, list] = {}
            for i in range(self.D):
                for j in range(self.M):
                    c = self.coords[i][j]
                    key = tuple(v for a, v in c.items() if a != axis)
                    groups.setdefault(key, []).append((c[axis], i, j))
            for members in groups.values():
                members.sort()
                vals = self.mesh.pmean([out[i][j] for _, i, j in members],
                                       axis)
                for (_, i, j), v in zip(members, vals):
                    out[i][j] = v
        return out


def tree_specs(specs: Dict[str, Any], tree) -> Any:
    """A tree of specs mirroring ``tree`` from a flat path map, each leaf's
    path its keys joined by "/"."""
    paths = iter(path for path, _ in flatten(tree))
    return map_tree(lambda _: specs[next(paths)], tree)


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


class Initializer:
    """Draws parameter leaves on ``device`` (the card unless the caller asks
    for the CPU) from one ``torch.Generator`` seeded with ``seed``: the
    reference's init kinds and scales, in its order of draws. Drawn leaves
    come in ``dtype`` (``cfg.pdtype`` unless given), constant leaves (the
    norms' scales) in ``cfg.pdtype``. Draws are float32, a slice of the
    leading axis at a time, cast as they come, so a stacked leaf never
    stands whole in float32. torch's generator gives other numbers than
    ``jax.random`` from the same seed; tests carry the reference's
    parameters across (``models/convert.py``).

    Each leaf's spec on ``mesh`` (None: every entry None) goes into
    ``specs``, under the leaf's path, as the reference's does. With
    ``abstract=True`` or a ``meta`` device nothing is drawn and no
    generator made (one cannot live on ``meta``): every leaf is an empty
    ``meta`` tensor of its shape and dtype, at any size."""

    def __init__(self, cfg: ModelConfig, mesh=None, abstract: bool = False,
                 seed: int = 0, device=None, dtype=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device("meta") if abstract else \
            resolve_device(device)
        self.abstract = self.device.type == "meta"
        self.dtype = cfg.pdtype if dtype is None else dtype
        self.specs: Dict[str, P] = {}
        self.generator = None
        if not self.abstract:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(seed)

    def _draw(self, shape, fill, dtype):
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for part in (out if len(shape) >= 3 else (out,)):
            part.copy_(fill(tuple(part.shape)))
        return out

    def _normal(self, shape, s, dtype):
        return self._draw(shape, lambda sh: torch.randn(
            sh, generator=self.generator, dtype=torch.float32,
            device=self.device) * s, dtype)

    def param(self, path: str, shape, logical=None, init="normal",
              scale=None, dtype=None):
        """One leaf. ``path`` names it, as the reference's does, and
        ``logical`` names its dimensions' logical axes (None: all
        replicated). A stacked leaf (leading layer axis, or zamba2's (G,
        M) group axes) takes its fan-in from its first axis, as the
        reference's does. ``dtype`` overrides the drawn leaves' dtype for
        a leaf the model keeps in another (the MoE router, RWKV6's decay
        path and bonus)."""
        shape = tuple(int(s) for s in shape)
        logical = (None,) * len(shape) if logical is None else tuple(logical)
        self.specs[path] = spec_for(logical, shape, self.mesh)
        drawn = self.dtype if dtype is None else dtype
        if init in ("zeros", "ones"):
            drawn = self.cfg.pdtype
        if self.abstract:
            return torch.empty(shape, dtype=drawn, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=drawn, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=drawn, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            return self._normal(shape, scale if scale is not None
                                else 1.0 / math.sqrt(fan_in), drawn)
        if init == "embed":
            return self._normal(shape, scale if scale is not None else 1.0,
                                drawn)
        if init == "uniform":
            s = scale if scale is not None else 1.0
            return self._draw(shape, lambda sh: torch.rand(
                sh, generator=self.generator, dtype=torch.float32,
                device=self.device) * (2 * s) - s, drawn)
        raise ValueError(init)


def cast(tree, dtype):
    """``tree`` with every floating leaf cast to ``dtype`` (other leaves as
    they are); dicts and lists keep their structure."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast(v, dtype) for v in tree)
    return tree


def param_count(params: Dict[str, Any]) -> int:
    return sum(int(x.numel()) for x in leaves(params))


def unstack(tree, n):
    """The slices along the leading axis of every leaf of ``tree``: a
    stacked (L, ...) layer tree -> a list of L per-layer trees (views).
    ``n`` is L, or a tuple of leading axes, as zamba2's (G, M) groups of
    Mamba2 layers: the list then holds their G * M layers in order."""
    lead = (n,) if isinstance(n, int) else tuple(n)
    if isinstance(tree, dict):
        parts = {k: unstack(v, lead) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()}
                for i in range(math.prod(lead))]
    if tuple(tree.shape[:len(lead)]) != lead:
        raise ValueError(f"leading axes {tuple(tree.shape[:len(lead)])}, "
                         f"expected {lead}")
    return list(tree.reshape(-1, *tree.shape[len(lead):]).unbind(0))
