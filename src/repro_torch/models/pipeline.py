"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (PyTorch
port of ``repro/models/pipeline.py``).

The layer stack is split across the mesh's ``stage`` axis: K stages, each
holding L / K consecutive blocks on its mesh entry's device, and
``n_micro`` microbatches stream through them on a fill / drain schedule of
``n_micro + K - 1`` ticks. At tick t, stage 0 takes in microbatch t and
stage k works on microbatch t - k; the last stage stores microbatch t - (K
- 1). Each activation a stage produces hops to the next stage's device
(``DeviceMesh.hop``: a copy even where both entries are one device, its
bytes counted), and autograd flows through the hops. The batch of each
microbatch is split over the mesh's data axes ("pod", "data"), one shard
a data entry, as the reference's ``shard_map`` splits it.

Where the port departs from the reference: one process drives every
entry, as it drives the planner's meshes (``launch/mesh.py``), in place of
a ``shard_map`` over SPMD devices. A stage runs only at the ticks that
carry a microbatch; the reference's SPMD program computes every stage at
every tick, the bubble's ticks on clipped inputs whose results it masks
away, and permutes every stage's activation at every tick, the last
stage's back to the first among them. So the port moves only the
activations a later stage reads: (K - 1) hops a microbatch and data
shard, counted as the reference counts its ``collective_permute``, each
hop's output bytes. The reference's final ``psum`` over ``stage`` of the
masked output buffer becomes taking the last stage's outputs, counted as
the reference counts that ``psum``: the buffer's bytes on each of the
mesh's entries. Scope, asserts and block are the reference's:
the homogeneous dense family (``block_pattern == "attn"``, no MoE, no dense
prefix, no cross-attention groups), L % K == 0 and B % n_micro == 0, each
stage's blocks without remat. ``_stage_block`` is the model's own block
(``Model._attn_block`` without a cache), so ``pp_apply_blocks`` takes the
model where the reference's takes its config. Where autograd records, the
backward counts each hop's transpose (a hop back) and the ``psum``'s (an
all-reduce of the same bytes), and where the data axes have more than one
entry the gradients' all-reduce over them (``pp_loss_fn``), as the
reference's partitioner reduces every leaf replicated over data.

The embedding and head stay outside the staged region. A model built
with ``mesh=None`` runs them on its device. A model built on the
pipeline's mesh runs them sharded over its (data, model) entries by
their specs, as the reference's ``Model(cfg, mesh=mesh)`` does, the
other axes (``stage``) at index 0 (``common.Entries``); the blocks are
replicated over ``model`` (the entries at model index 0 run them, as
``_grid`` takes the other axes at index 0). The embedding's data row i
holds the batch's rows [i B / D, (i + 1) B / D), while the pipeline's
data shard d takes the d-th of D slices of each microbatch, so a slice
that lies in another row hops in, from the embedding's entry (i, 0) to
the stage-0 entry of shard d, and back out, to each of the head's M
entries of its row (``_handoff_in``, ``_handoff_out``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import DATA_AXES
from repro_torch.tree import leaves

STAGE_AXIS = "stage"


def _stage_block(model, blk, x, positions):
    """One dense block of ``model``, without a cache or remat."""
    return model._attn_block(blk, x, positions, None, None)[0]


def _on(tree, device):
    """A block's parameter dicts with each leaf on ``device`` (the leaf
    itself where it is there already)."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device)


def _grid(mesh):
    """(D, K) devices: the entry of data shard d and stage k, the other
    axes (which the reference replicates over) at their first index."""
    names = list(mesh.axis_names)
    dp = [a for a in names if a in DATA_AXES]
    rest = [a for a in names if a != STAGE_AXIS and a not in dp]
    grid = np.transpose(mesh.devices, [names.index(a)
                                       for a in rest + dp + [STAGE_AXIS]])
    grid = grid[(0,) * len(rest)]
    return grid.reshape(-1, mesh.shape[STAGE_AXIS])


def _check(L: int, K: int, B: int, n_micro: int, D: int) -> int:
    """The reference's asserts, and microbatches that split over the data
    shards; returns the microbatch size."""
    assert L % K == 0, (L, K)
    assert B % n_micro == 0, (B, n_micro)
    mb = B // n_micro
    if mb % D:
        raise ValueError(f"microbatches of {mb} do not split over {D} data "
                         f"shards")
    return mb


def _stages(params_blocks, grid):
    """Each (data shard, stage)'s blocks on its entry's device."""
    D, K = grid.shape
    per = len(params_blocks) // K
    return [[[_on(blk, grid[d, k])
              for blk in params_blocks[k * per:(k + 1) * per]]
             for k in range(K)] for d in range(D)]


def _run_shard(model, stages, pieces, positions, mesh, grid, d: int):
    """Data shard ``d``'s fill / drain schedule: ``pieces[m]``, microbatch
    m's slice of the shard, through its K stages (``stages[k]`` the blocks
    of stage k). Returns the microbatches' outputs on the last stage's
    entry."""
    K = grid.shape[1]
    n_micro = len(pieces)
    buf = {}                            # stage -> the activation it takes in
    done = [None] * n_micro             # filled by the last stage
    for t in range(n_micro + K - 1):
        arriving = {}
        for k in range(K):
            m = t - k                   # the microbatch at stage k
            if not 0 <= m < n_micro:
                continue                # the bubble
            dev = grid[d, k]
            h = pieces[m].to(dev) if k == 0 else buf[k]
            pos = positions.to(dev)
            for blk in stages[k]:
                h = _stage_block(model, blk, h, pos)
            if k == K - 1:
                done[m] = h
            else:
                arriving[k + 1] = mesh.hop(h, grid[d, k + 1])
        buf = arriving
    return done


def _psum(mesh, done) -> None:
    """Count the reference's final ``psum`` over ``stage`` of the masked
    output buffer: the buffer's bytes on each of the mesh's entries, and
    the same again in the backward (its transpose)."""
    n = sum(h.numel() * h.element_size() for h in done[0])
    nbytes = mesh.devices.size * n
    mesh.count("all-reduce", nbytes)
    mesh.count_backward("all-reduce", [h for row in done for h in row],
                        nbytes)


def pp_apply_blocks(model, params_blocks, x, positions, mesh, n_micro: int):
    """x: (B, S, d) hidden states after embedding. ``params_blocks``: the L
    per-layer block dicts (the port's unstacked ``blocks``). Returns (B,
    S, d) after all layers, pipelined over ``mesh``'s ``stage`` axis with
    ``n_micro`` microbatches, on ``x``'s device."""
    K = mesh.shape[STAGE_AXIS]
    B = x.shape[0]
    grid = _grid(mesh)
    D = grid.shape[0]
    mb = _check(len(params_blocks), K, B, n_micro, D)
    stages = _stages(params_blocks, grid)
    xs = x.reshape(n_micro, D, mb // D, *x.shape[1:])
    done, out = [], []
    for d in range(D):
        done.append(_run_shard(model, stages[d], xs[:, d], positions, mesh,
                               grid, d))
        out.append(torch.stack([h.to(x.device) for h in done[-1]]))
    y = torch.stack(out, dim=1)         # (n_micro, D, mb / D, S, d)
    _psum(mesh, done)
    return y.reshape(B, *x.shape[1:])


def _rows_of(B: int, n_micro: int, D: int):
    """For each (microbatch m, data shard d) slice of the pipeline, the
    embedding's data row that holds it and the slice's offset there."""
    mb, per = B // n_micro, B // D
    return {(m, d): divmod(m * mb + d * (mb // D), per)
            for m in range(n_micro) for d in range(D)}


def _handoff_in(mesh, X, grid, n_micro):
    """The pipeline's input slices from the sharded embedding's grid ``X``
    (each data row's (B / D, S, d) at every model rank): slice (m, d) from
    entry (i, 0) of its row, hopped to shard d's stage-0 entry where i is
    not d (``_rows_of``)."""
    D = grid.shape[0]
    n = X[0][0].shape[0] // n_micro     # mb / D rows a slice
    rows = _rows_of(n * n_micro * D, n_micro, D)
    pieces = [[None] * n_micro for _ in range(D)]
    for (m, d), (i, off) in rows.items():
        h = X[i][0][off:off + n]
        pieces[d][m] = h.to(grid[d, 0]) if i == d else mesh.hop(
            h, grid[d, 0])
    return pieces


def _handoff_out(mesh, ents, done, n_micro):
    """Each head entry's (i, j) rows of the pipeline's outputs ``done``
    (after the ``psum`` every entry of shard d holds shard d's): a slice
    of shard d that lies in row i hops to each of the row's M entries
    where d is not i. Returns the grid of (B / D, S, d) rows."""
    D = ents.D
    n = done[0][0].shape[0]
    rows = _rows_of(n * n_micro * D, n_micro, D)
    at = {(i, off): (m, d) for (m, d), (i, off) in rows.items()}

    def row(i, j):
        dev = ents.devices[i][j]
        out = []
        for off in range(0, n * n_micro, n):
            m, d = at[(i, off)]
            h = done[d][m]
            out.append(h.to(dev) if d == i else mesh.hop(h, dev))
        return torch.cat(out, 0)
    return [[row(i, j) for j in range(ents.M)] for i in range(D)]


def pp_loss_fn(model, mesh, n_micro: int):
    """Drop-in loss for the dense family with the block stack pipelined:
    ``loss(batch) -> (ce, {"ce", "tokens"})``, the reference's
    ``pp_loss_fn`` over the model's own parameters. A model built on
    ``mesh`` embeds and projects sharded over its (data, model) entries
    (the module docstring); one built with ``mesh=None`` on its device.
    Where the data axes have more than one entry, the backward counts the
    gradients' all-reduce over them (``_grad_bytes``)."""
    from repro_torch.models.transformer import _masked_ce
    cfg = model.cfg
    if (cfg.block_pattern != "attn" or cfg.moe or cfg.first_dense
            or cfg.cross_attn_every):
        raise ValueError(f"{cfg.name}: the pipeline takes the homogeneous "
                         f"dense family only")
    ents = model._ents
    if ents is not None and model.mesh != mesh:
        raise ValueError(f"{cfg.name} runs sharded over {model.mesh}, not "
                         f"the pipeline's {mesh}")

    def loss(batch):
        blocks = model.params()["blocks"]
        if ents is None:
            x = model._embed_in(batch)
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            x = pp_apply_blocks(model, blocks, x, positions, mesh, n_micro)
            logits = model._logits(x)
        else:
            logits = _sharded_ends(model, mesh, batch, blocks, n_micro)
        D = _grid(mesh).shape[0]
        if model.trainable and D > 1:
            mesh.count_backward("all-reduce", [logits],
                                _grad_bytes(model, mesh, blocks, D))
        labels = torch.as_tensor(batch["labels"]).to(model.device).long()
        ce, n = _masked_ce(logits, labels)
        return ce, {"ce": ce, "tokens": n}

    return loss


def _grad_bytes(model, mesh, blocks, D: int) -> int:
    """The gradients' all-reduce over the D data shards, every participant
    its block of each leaf: a stage's blocks whole on each of its D M
    entries (the blocks are replicated over ``model``), and where the
    model runs sharded, each (data, model) entry's block of the others
    (``Model._grad_bytes``)."""
    M = mesh.shape.get("model", 1)
    whole = sum(w.numel() * w.element_size() for w in leaves(blocks))
    rest = (model._grad_bytes(skip=("blocks",)) if model._ents is not None
            else 0)
    return D * M * whole + rest


def _sharded_ends(model, mesh, batch, blocks, n_micro):
    """The logits of ``batch``: the embedding sharded over the model's
    entries, the blocks pipelined over ``mesh``, the head sharded; every
    slice moved between them counted (``_handoff_in``, ``_handoff_out``)."""
    e = model._ents
    cfg = model.cfg
    inp = torch.as_tensor(batch["embeds" if cfg.embedding_inputs
                                else "tokens"]).to(model.device)
    B, S = inp.shape[:2]
    grid = _grid(mesh)
    K = mesh.shape[STAGE_AXIS]
    _check(len(blocks), K, B, n_micro, e.D)
    parts = model._parts()
    X = model._embed_sharded(parts, list(inp.chunk(e.D)))
    positions = torch.arange(S, device=model.device)[None, :]
    stages = _stages(blocks, grid)
    pieces = _handoff_in(mesh, X, grid, n_micro)
    done = [_run_shard(model, stages[d], pieces[d], positions, mesh, grid, d)
            for d in range(e.D)]
    _psum(mesh, done)
    return model._head_sharded(parts, _handoff_out(mesh, e, done, n_micro),
                               e.D > 1)
