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
mesh's entries. Scope, asserts and block are the reference's: the
homogeneous dense family (``block_pattern == "attn"``, no MoE, no dense
prefix, no cross-attention groups), L % K == 0 and B % n_micro == 0, each
stage's blocks without remat. ``_stage_block`` is the model's own block
(``Model._attn_block`` without a cache), so ``pp_apply_blocks`` takes the
model where the reference's takes its config. The embedding and head stay
outside the staged region, on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import DATA_AXES

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


def pp_apply_blocks(model, params_blocks, x, positions, mesh, n_micro: int):
    """x: (B, S, d) hidden states after embedding. ``params_blocks``: the L
    per-layer block dicts (the port's unstacked ``blocks``). Returns (B,
    S, d) after all layers, pipelined over ``mesh``'s ``stage`` axis with
    ``n_micro`` microbatches, on ``x``'s device."""
    K = mesh.shape[STAGE_AXIS]
    L = len(params_blocks)
    assert L % K == 0, (L, K)
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    mb = B // n_micro
    grid = _grid(mesh)
    D = grid.shape[0]
    if mb % D:
        raise ValueError(f"microbatches of {mb} do not split over {D} data "
                         f"shards")
    per = L // K
    stages = [[[_on(blk, grid[d, k])
                for blk in params_blocks[k * per:(k + 1) * per]]
               for k in range(K)] for d in range(D)]
    xs = x.reshape(n_micro, D, mb // D, *x.shape[1:])
    out = []
    for d in range(D):
        buf = {}                        # stage -> the activation it takes in
        done = [None] * n_micro         # filled by the last stage
        for t in range(n_micro + K - 1):
            arriving = {}
            for k in range(K):
                m = t - k               # the microbatch at stage k
                if not 0 <= m < n_micro:
                    continue            # the bubble
                dev = grid[d, k]
                h = xs[m, d].to(dev) if k == 0 else buf[k]
                pos = positions.to(dev)
                for blk in stages[d][k]:
                    h = _stage_block(model, blk, h, pos)
                if k == K - 1:
                    done[m] = h
                else:
                    arriving[k + 1] = mesh.hop(h, grid[d, k + 1])
            buf = arriving
        out.append(torch.stack([h.to(x.device) for h in done]))
    y = torch.stack(out, dim=1)         # (n_micro, D, mb / D, S, d)
    mesh.count("all-reduce", mesh.devices.size * (y.numel() // D)
               * y.element_size())
    return y.reshape(B, *x.shape[1:])


def pp_loss_fn(model, mesh, n_micro: int):
    """Drop-in loss for the dense family with the block stack pipelined:
    ``loss(batch) -> (ce, {"ce", "tokens"})``, the reference's
    ``pp_loss_fn`` over the model's own parameters."""
    from repro_torch.models.transformer import _masked_ce
    cfg = model.cfg
    if (cfg.block_pattern != "attn" or cfg.moe or cfg.first_dense
            or cfg.cross_attn_every):
        raise ValueError(f"{cfg.name}: the pipeline takes the homogeneous "
                         f"dense family only")

    def loss(batch):
        x = model._embed_in(batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        blocks = model.params()["blocks"]
        x = pp_apply_blocks(model, blocks, x, positions, mesh, n_micro)
        logits = model._logits(x)
        labels = torch.as_tensor(batch["labels"]).to(model.device).long()
        ce, n = _masked_ce(logits, labels)
        return ce, {"ce": ce, "tokens": n}

    return loss
