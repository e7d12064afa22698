"""The decoder-only model (PyTorch port of ``repro/models/transformer.py``),
every architecture of ``repro_torch.configs``: the ``block_pattern ==
"attn"`` family, dense GQA/MQA/MHA (smollm, yi, granite, phi3), MoE
(olmoe) and MLA + MoE with a dense prefix (deepseek-v2-lite), with tied or
separate embeddings; the VLM backbone (llama-3.2-vision: groups of self
attention blocks, each group followed by a gated cross-attention sublayer
over patch embeddings and an MLP); the audio backbone (musicgen: dense
blocks fed precomputed frame embeddings in place of tokens, no embedding
table); RWKV6 "Finch" (``rwkv6``: time mix and channel mix,
attention-free); and the Mamba2 hybrid (``zamba2``: groups of Mamba2
layers, each group followed by one attention block whose weights every
group shares).

``Model`` is an ``nn.Module`` with ``forward(batch)``, the training
objective ``loss(batch)``, the single-token serving step
``decode_step(cache, batch, cache_index)`` and ``init_cache(B, S_max)``.
Its parameters are the reference's tree with the stacked
layer axes unstacked into one entry a layer: ``prefix``, the
``first_dense`` leading dense blocks (unstacked in the reference too), and
``blocks``, the other layers, each with an ``mlp`` or, for MoE configs,
``moe`` and the merged shared expert ``shared``; for the VLM the (G, M)
stack of self blocks, its G * M layers in order, and ``cross``, one dict a
group of the reference's (G,) stacks ``cross``, ``cross_ln``,
``cross_mlp`` and ``cross_ln2``; for ``rwkv6`` the (L,) stack of ``ln1``,
``tm``, ``ln2``, ``cm``; for ``zamba2`` the (G, M) stack of ``ln`` and
``mamba``, its G * M layers in order, and the one unstacked
``shared_attn`` block.

The reference keeps every leaf in ``cfg.param_dtype`` (float32) and casts
a matrix to ``cfg.dtype`` at each use. A model built to serve holds each
matrix once, in ``cfg.dtype``, which computes the same forward numbers,
with no autograd; it keeps in ``cfg.param_dtype`` the leaves the reference
reads in float32: the norms' scales (``kv_norm``, RWKV6's ``ln_scale`` and
Mamba2's gated ``norm`` among them), the MoE router, RWKV6's decay path
(``w0``, ``decay_w1``, ``decay_w2``) and bonus ``u``, and Mamba2's
``a_log`` and ``dt_bias``. A model built to train (``trainable=True``)
holds every leaf in ``cfg.param_dtype`` as a parameter that takes a
gradient, and every use casts it, as the reference's does: each use's
``cfg.dtype`` gradient is widened on its own and the uses are summed in
float32 (the tied embedding's gather and head, zamba2's shared block in
each group, every leaf a remat body reads). While autograd records, each
scanned layer of the reference (each group for zamba2 and the VLM) runs
under ``cfg.remat``: "full" recomputes it in the backward
(``torch.utils.checkpoint``), "dots" keeps the outputs of its products
with no batch dimensions and recomputes the rest; neither changes a
number. Decode never remats.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import standing_for
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import (TP_AXIS, Entries, Initializer,
                                      ModelConfig, P, axis_size,
                                      block_bytes, dp_for, shard,
                                      tree_specs, unstack)
from repro_torch.tree import flatten, map_tree

# the leaves a block keeps in cfg.param_dtype: the norms' scales, the
# router, which routes in float32, and the SSM leaves the reference reads in
# float32 (ssm.py: RWKV6's decay path, bonus and group-norm scale; Mamba2's
# decay, step bias and gated-norm scale)
_NORMS = ("ln", "ln1", "ln2", "cross_ln", "cross_ln2")
_KEPT = ("kv_norm", "router", "w0", "decay_w1", "decay_w2", "u", "ln_scale",
         "a_log", "dt_bias", "norm")

_PATTERNS = ("attn", "rwkv6", "zamba2")
_REMAT = ("none", "full", "dots")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block pattern the reference has no model
    of, or a remat policy it has not."""
    if cfg.block_pattern not in _PATTERNS:
        raise ValueError(f"{cfg.name}: block_pattern {cfg.block_pattern!r}")
    if cfg.remat not in _REMAT:
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r}")


def runs_sharded(mesh, device=None) -> bool:
    """Whether a model on ``device`` runs sharded over ``mesh``: a mesh with
    an axis of more than one entry. A mesh whose every axis has size 1
    runs the one-device program, as the reference's (1, 1) mesh gives the
    unsharded result. A mesh of ``meta`` entries (the dry run's
    production meshes) runs the sharded program on ``meta``, one entry for
    all (``common.Entries``), and takes a model on ``meta``; a model on
    ``meta`` takes such a mesh (``ValueError`` otherwise)."""
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return False
    meta = device is not None and torch.device(device).type == "meta"
    if meta != bool(getattr(mesh, "abstract", False)):
        raise ValueError(f"a model on {device} over a mesh of "
                         f"{sorted({str(d) for d in mesh.devices.flat})}: "
                         f"a mesh of meta entries and a model on meta go "
                         f"together")
    return True


def _init_attn_block(ini, cfg: ModelConfig, path: str, stack, use_moe: bool):
    d = cfg.d_model
    blk = {"ln1": ll.init_rmsnorm(ini, f"{path}/ln1", d, stack),
           "ln2": ll.init_rmsnorm(ini, f"{path}/ln2", d, stack)}
    init_attn = ll.init_mla if cfg.mla else ll.init_attention
    blk["attn"] = init_attn(ini, f"{path}/attn", cfg, stack)
    if use_moe:
        blk["moe"] = moe_mod.init_moe(ini, f"{path}/moe", cfg, stack)
        if cfg.d_ff_shared:
            blk["shared"] = ll.init_mlp(ini, f"{path}/shared", d,
                                        cfg.d_ff_shared, stack)
    else:
        blk["mlp"] = ll.init_mlp(ini, f"{path}/mlp", d, cfg.d_ff, stack)
    return blk


def _groups(cfg: ModelConfig):
    """(G, M): zamba2's G groups of M Mamba2 layers, each group followed by
    the shared attention block; the VLM's G groups of M self-attention
    blocks, each followed by its cross-attention sublayer."""
    M = cfg.shared_attn_every or cfg.cross_attn_every
    return cfg.num_layers // M, M


def _num_blocks(cfg: ModelConfig) -> int:
    """The entries of ``blocks``: the layers past the dense prefix, or for
    ``zamba2`` and the VLM the G * M layers of their groups."""
    if cfg.block_pattern == "zamba2" or cfg.cross_attn_every:
        G, M = _groups(cfg)
        return G * M
    return cfg.num_layers - cfg.first_dense


def _init_blocks(ini, cfg: ModelConfig):
    """The reference's ``Model._init_blocks``: each pattern's stack drawn at
    the reference's stack shape, (L,) or (G, M), so a leaf takes its fan-in
    from the same axis, then unstacked."""
    d, pat = cfg.d_model, cfg.block_pattern
    if pat == "rwkv6":
        L = cfg.num_layers
        return {"blocks": unstack({
            "ln1": ll.init_rmsnorm(ini, "blocks/ln1", d, (L,)),
            "tm": ssm.init_rwkv6_tm(ini, "blocks/tm", cfg, (L,)),
            "ln2": ll.init_rmsnorm(ini, "blocks/ln2", d, (L,)),
            "cm": ssm.init_rwkv6_cm(ini, "blocks/cm", cfg, (L,)),
        }, L)}
    if pat == "zamba2":
        GM = _groups(cfg)
        return {"blocks": unstack({
            "ln": ll.init_rmsnorm(ini, "blocks/ln", d, GM),
            "mamba": ssm.init_mamba2(ini, "blocks/mamba", cfg, GM),
        }, GM), "shared_attn": _init_attn_block(ini, cfg, "shared_attn", (),
                                                False)}
    out = {}
    if cfg.first_dense:
        out["prefix"] = [_init_attn_block(ini, cfg, f"prefix{i}", (), False)
                         for i in range(cfg.first_dense)]
    if cfg.cross_attn_every:
        G, M = _groups(cfg)
        out["blocks"] = unstack(_init_attn_block(ini, cfg, "blocks", (G, M),
                                                 cfg.moe), (G, M))
        out["cross"] = unstack({
            "cross": ll.init_cross_attention(ini, "cross", cfg, (G,)),
            "cross_ln": ll.init_rmsnorm(ini, "cross_ln", d, (G,)),
            "cross_mlp": ll.init_mlp(ini, "cross_mlp", d, cfg.d_ff, (G,)),
            "cross_ln2": ll.init_rmsnorm(ini, "cross_ln2", d, (G,)),
        }, G)
        return out
    n = _num_blocks(cfg)
    out["blocks"] = unstack(_init_attn_block(ini, cfg, "blocks", (n,),
                                             cfg.moe), n)
    return out


def _init(ini, cfg: ModelConfig):
    check_supported(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {}
    if not cfg.embedding_inputs:
        p["embed"] = ini.param("embed", (cfg.vocab_size, d), ("vocab", None),
                               init="embed", scale=0.02)
    p.update(_init_blocks(ini, cfg))
    p["final_norm"] = ll.init_rmsnorm(ini, "final_norm", d)
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.param("lm_head", (d, cfg.vocab_size),
                                 (None, "vocab"), scale=0.02)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None):
    """The parameter tree drawn as the reference's ``Model.init`` draws it
    (the prefix blocks unstacked, the others stacked; the same kinds,
    scales and order; no ``embed`` under ``embedding_inputs``), layers
    unstacked, on ``device`` (the card unless the caller asks for the
    CPU; on ``meta`` nothing is drawn, at any size). The matrices come in
    ``dtype`` (``cfg.pdtype`` unless given); the leaves of ``_NORMS`` and
    ``_KEPT`` in ``cfg.pdtype``."""
    return _init(Initializer(cfg, seed=seed, device=device, dtype=dtype),
                 cfg)


def _stack_depth(cfg: ModelConfig) -> int:
    """The leading axes of the reference's ``blocks`` stack: (G, M) for
    zamba2 and the VLM, (L,) otherwise."""
    return 2 if cfg.block_pattern == "zamba2" or cfg.cross_attn_every else 1


def param_specs(cfg: ModelConfig, mesh):
    """The spec on ``mesh`` of every leaf of the port's parameter tree, a
    tree of ``P`` mirroring ``init_params``'s. A leaf the port keeps
    unstacked takes the reference's spec of its stack without the
    leading layer entries, which the reference never shards ("layers" is
    replicated): ``blocks/i/...`` that of ``blocks/...`` without one
    entry, or two for zamba2's and the VLM's (G, M) stacks;
    ``cross/g/part/...`` that of the VLM's (G,) stack ``part/...``
    without one; ``prefix/i/...`` is the reference's unstacked
    ``prefix{i}/...``."""
    ini = Initializer(cfg, mesh=mesh, abstract=True)
    params = _init(ini, cfg)

    def spec(path):
        head, *rest = path.split("/")
        if head == "prefix":
            return ini.specs["/".join([f"prefix{rest[0]}", *rest[1:]])]
        if head == "blocks":
            return P(*ini.specs["/".join(["blocks", *rest[1:]])]
                     [_stack_depth(cfg):])
        if head == "cross":
            return P(*ini.specs["/".join(rest[1:])][1:])
        return ini.specs[path]

    return tree_specs({path: spec(path) for path, _ in flatten(params)},
                      params)


def _param(x, device, dtype=None, trainable=False) -> nn.Parameter:
    """A leaf as a parameter; a trainable one is a copy of ``x``, so the
    optimizer never writes to the caller's tree."""
    t = torch.as_tensor(x).to(device=device, dtype=dtype, copy=trainable)
    return nn.Parameter(t, requires_grad=trainable)


def _block(tree, device, dt, trainable=False) -> nn.ModuleDict:
    """One block's parameters: to serve, each matrix cast to ``dt``, the
    leaves of ``_NORMS`` and ``_KEPT`` as they are; to train, every leaf in
    ``dt`` (the caller's ``cfg.pdtype``)."""
    return nn.ModuleDict({part: nn.ParameterDict({
        name: _param(w, device, dt if trainable or not (
            part in _NORMS or name in _KEPT) else None, trainable)
        for name, w in leaves.items()})
        for part, leaves in tree.items()})


def _call(fn, *args):
    return fn(*args)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy (the reference's
    ``dots_with_no_batch_dims_saveable``): keep the output of a product with
    no batch dimensions, recompute every other op. An einsum lowers to
    ``bmm``, of batch 1 where the product has no batch dimensions."""
    from torch.utils.checkpoint import CheckpointPolicy
    nobatch = op is torch.ops.aten.mm.default or (
        op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if nobatch
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Model(nn.Module):
    """The decoder on ``device`` (the card unless the caller asks for the
    CPU; without a card asking for it raises). ``params`` (the tree of
    ``init_params`` or of ``models/convert.from_reference``) is loaded as
    the module docstring says: to serve (the default), each matrix cast to
    ``cfg.dtype`` once and the leaves of ``_NORMS`` and ``_KEPT`` as they
    are, no autograd; with ``trainable=True``, a copy of every leaf in
    ``cfg.param_dtype``, each a parameter that takes a gradient. Without
    ``params`` the parameters are drawn from ``seed`` on ``device``,
    straight into those dtypes; on ``meta`` nothing is drawn, at any
    size, and every step traces shapes only (the dry run's model).
    ``embed`` is None under ``embedding_inputs``; ``cross`` holds the VLM's
    G cross-attention groups (empty for every other model).

    ``mesh`` (a ``launch/mesh.py:DeviceMesh`` with axes "data" and
    "model", and "pod" where present, or None): where ``runs_sharded``, the
    model runs sharded over it at run time, as the reference's does under
    the same mesh (``_sharded``): each entry computes with its block of
    every leaf by ``param_specs`` (on the model's device a view of the
    model's own parameter, so no parameter is copied for each entry and
    gradients reach ``parameters()`` by themselves; on another device a
    copy), the batch split over the data axes where they divide it
    (``common.dp_for``), attention (GQA, MLA, the VLM's cross-attention),
    the RWKV6 and Mamba2 layers and the MLPs tensor-parallel over
    ``model``, the MoE blocks expert-parallel, the residual held as S / m
    slices under ``cfg.seq_parallel``, and every byte moved between
    entries counted in ``mesh.hops`` (``_run_sharded``), the backward's
    too where autograd records (each collective's transpose, and the
    gradients' all-reduce over the data axes: ``_sharded``). Axes other
    than the data axes and ``model`` (GPipe's "stage") stand at index 0
    (``models/pipeline.py`` runs the blocks over them). An entry may sit
    on another device than the model's: its blocks are copies there, and
    its part of a cache is copied there and back. None, or a mesh whose
    every axis has size 1, runs the one-device program; a mesh of
    ``meta`` entries runs the sharded program on ``meta``, one entry for
    all (the dry run's)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 params=None, trainable: bool = False, mesh=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.trainable = trainable
        self.mesh = mesh
        device = resolve_device(device)
        self._ents = None
        if runs_sharded(mesh, device):
            self._ents = Entries(mesh)
            self._specs = param_specs(cfg, mesh)
            self._parts_kept = None
        dt = cfg.pdtype if trainable else cfg.cdtype
        if params is None:
            params = init_params(cfg, seed=seed, device=device, dtype=dt)
        prefix = params.get("prefix", [])
        if len(prefix) != cfg.first_dense or \
                len(params["blocks"]) != _num_blocks(cfg):
            raise ValueError(f"{len(prefix)} + {len(params['blocks'])} "
                             f"layers of parameters for a config of "
                             f"{cfg.first_dense} + {_num_blocks(cfg)}")
        cross = params.get("cross", [])
        if len(cross) != (_groups(cfg)[0] if cfg.cross_attn_every else 0):
            raise ValueError(f"{len(cross)} cross-attention groups of "
                             f"parameters for a config of "
                             f"cross_attn_every={cfg.cross_attn_every}")

        def block(tree):
            return _block(tree, device, dt, trainable)

        self.embed = (None if cfg.embedding_inputs
                      else _param(params["embed"], device, dt, trainable))
        self.prefix = nn.ModuleList(block(b) for b in prefix)
        self.blocks = nn.ModuleList(block(b) for b in params["blocks"])
        self.cross = nn.ModuleList(block(g) for g in cross)
        self.shared_attn = (block(params["shared_attn"])
                            if cfg.block_pattern == "zamba2" else None)
        self.final_norm = nn.ParameterDict({
            k: _param(v, device, dt if trainable else None, trainable)
            for k, v in params["final_norm"].items()})
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(params["lm_head"], device, dt, trainable))

    @property
    def head(self) -> torch.Tensor:
        """The (d_model, vocab) output matrix: the embedding's transpose
        where the embeddings are tied."""
        return self.embed.T if self.lm_head is None else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    # ------------------------------------------------------------------
    # block application
    # ------------------------------------------------------------------

    def _remat(self, fn, *args):
        """``fn(*args)`` under ``cfg.remat`` where the model trains and
        autograd records, else plainly."""
        policy = self.cfg.remat
        if not (self.trainable and torch.is_grad_enabled()) or \
                policy == "none":
            return fn(*args)
        if policy == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        return checkpoint(fn, *args, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts,
                              _save_dots)))

    def _attn_block(self, p, x, positions, cache, cache_index):
        """One block. Returns (x, the MoE load-balance loss, or None for a
        block with a dense MLP)."""
        cfg = self.cfg
        h = ll.rmsnorm(p["ln1"], x, cfg.norm_eps, fast=cfg.fast_norm)
        attend = ll.mla_attention if cfg.mla else ll.attention
        a, _ = attend(p["attn"], h, cfg, positions=positions, cache=cache,
                      cache_index=cache_index)
        x = x + a
        h = ll.rmsnorm(p["ln2"], x, cfg.norm_eps, fast=cfg.fast_norm)
        if "moe" not in p:
            return x + ll.mlp(p["mlp"], h, cfg.cdtype), None
        y, aux = moe_mod.moe_layer(p["moe"], h, cfg)
        if "shared" in p:
            y = y + ll.mlp(p["shared"], h, cfg.cdtype)
        return x + y, aux

    def _rwkv6_layer(self, blk, x, tm_state, cm_state):
        """The reference's ``rwkv6`` body: norm, time mix, residual, norm,
        channel mix, residual. Returns (x, the new time-mix and channel-mix
        states, None without a cache)."""
        cfg = self.cfg
        a, tm_new = ssm.rwkv6_time_mix(
            blk["tm"], ll.rmsnorm(blk["ln1"], x, cfg.norm_eps,
                                  fast=cfg.fast_norm), cfg, state=tm_state)
        x = x + a
        m, cm_new = ssm.rwkv6_channel_mix(
            blk["cm"], ll.rmsnorm(blk["ln2"], x, cfg.norm_eps,
                                  fast=cfg.fast_norm), cfg, state=cm_state)
        return x + m, tm_new, cm_new

    def _rwkv6_blocks(self, x, cache):
        """The ``rwkv6`` layers; with a cache, each layer's shifts and wkv
        state written back in place."""
        run = self._remat if cache is None else _call
        for i, blk in enumerate(self.blocks):
            tm_state = cm_state = None
            if cache is not None:
                c = cache["blocks"]
                tm_state = {"tm_shift": c["tm_shift"][i], "wkv": c["wkv"][i]}
                cm_state = {"cm_shift": c["cm_shift"][i]}
            x, tm_new, cm_new = run(self._rwkv6_layer, blk, x, tm_state,
                                    cm_state)
            if cache is not None:
                for state, new in ((tm_state, tm_new), (cm_state, cm_new)):
                    for k, v in new.items():
                        state[k].copy_(v)
        return x

    def _zamba2_group(self, g, x, positions, cache, cache_index):
        """Group ``g`` of the reference's ``zamba2``: M Mamba2 layers behind
        their norms, then the shared attention block, the same weights in
        every group and a KV cache of its own a group; with a cache, each
        Mamba2 layer's conv and ssm state written back in place."""
        cfg = self.cfg
        M = cfg.shared_attn_every
        for j in range(M):
            lp = self.blocks[g * M + j]
            state = None
            if cache is not None:
                state = {k: v[g, j] for k, v in
                         cache["blocks"]["mamba"].items()}
            z = ll.rmsnorm(lp["ln"], x, cfg.norm_eps, fast=cfg.fast_norm)
            out, new = ssm.mamba2_layer(lp["mamba"], z, cfg, state=state)
            x = x + out
            if cache is not None:
                for k, v in new.items():
                    state[k].copy_(v)
        kv = None if cache is None else {
            k: v[g] for k, v in cache["blocks"]["attn"].items()}
        x, _ = self._attn_block(self.shared_attn, x, positions, kv,
                                cache_index)
        return x

    def _vlm_group(self, g, x, positions, cache, cache_index, patches):
        """Group ``g`` of the reference's ``_vlm_groups``: its M self
        attention blocks (their k and v under the cache's
        ``cross_groups.self`` (G, M, ...)), then the cross-attention
        sublayer behind ``cross_ln``, over the group's ``cross_kv`` when
        decoding and over ``patches`` when not, then the MLP behind
        ``cross_ln2``. Returns (x, the group's summed load-balance loss)."""
        cfg = self.cfg
        M = cfg.cross_attn_every
        gp = self.cross[g]
        aux = torch.zeros((), device=x.device)
        for j in range(M):
            kv = None if cache is None else {
                k: v[g, j] for k, v in cache["cross_groups"]["self"].items()}
            x, a = self._attn_block(self.blocks[g * M + j], x, positions, kv,
                                    cache_index)
            if a is not None:
                aux = aux + a
        kvc = None if cache is None else {
            k: v[g] for k, v in cache["cross_groups"]["cross_kv"].items()}
        z = ll.rmsnorm(gp["cross_ln"], x, cfg.norm_eps, fast=cfg.fast_norm)
        x = x + ll.cross_attention(gp["cross"], z, patches, cfg,
                                   kv_cache=kvc)
        z = ll.rmsnorm(gp["cross_ln2"], x, cfg.norm_eps, fast=cfg.fast_norm)
        return x + ll.mlp(gp["cross_mlp"], z, cfg.cdtype), aux

    def _run_blocks(self, x, positions, cache, cache_index, patches=None):
        """Returns (x, the summed load-balance loss, float32). Without a
        cache, each scanned layer (each group) runs under ``_remat``; the
        dense prefix does not, as the reference's does not."""
        run = self._remat if cache is None else _call
        aux = torch.zeros((), device=x.device)
        if self.cfg.block_pattern == "rwkv6":
            return self._rwkv6_blocks(x, cache), aux
        if self.cfg.block_pattern == "zamba2":
            for g in range(len(self.blocks) // self.cfg.shared_attn_every):
                x = run(self._zamba2_group, g, x, positions, cache,
                        cache_index)
            return x, aux
        for i, blk in enumerate(self.prefix):
            c = None if cache is None else cache["prefix"][i]
            x, _ = self._attn_block(blk, x, positions, c, cache_index)
        if self.cross:
            for g in range(len(self.cross)):
                x, a = run(self._vlm_group, g, x, positions, cache,
                           cache_index, patches)
                aux = aux + a
            return x, aux
        for i, blk in enumerate(self.blocks):
            c = None if cache is None else {
                k: v[i] for k, v in cache["blocks"].items()}
            x, a = run(self._attn_block, blk, x, positions, c, cache_index)
            if a is not None:
                aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # forward / loss / decode
    # ------------------------------------------------------------------

    def _embed_in(self, batch):
        """The token embeddings of ``batch["tokens"]`` (B, S), the table
        cast to the compute dtype before the gather as the reference casts
        it, or under ``embedding_inputs`` ``batch["embeds"]`` (B, S, d) in
        the compute dtype."""
        dt = self.cfg.cdtype
        if self.cfg.embedding_inputs:
            return torch.as_tensor(batch["embeds"]).to(device=self.device,
                                                       dtype=dt)
        return self.embed.to(dt)[torch.as_tensor(batch["tokens"]).long()
                                 .to(self.device)]

    def _head_in(self, x):
        """The final norm of the last block's output."""
        return ll.rmsnorm(self.final_norm, x, self.cfg.norm_eps)

    def _logits(self, x):
        return torch.einsum("bsd,dv->bsv", self._head_in(x),
                            self.head.to(self.cfg.cdtype))

    def _hidden(self, batch):
        """The last block's output (B, S, d) and the summed load-balance
        loss."""
        x = self._embed_in(batch)
        patches = batch.get("patches")
        if patches is not None:
            patches = torch.as_tensor(patches).to(device=x.device,
                                                  dtype=self.cfg.cdtype)
        elif self.cross:
            raise ValueError(f"{self.cfg.name}: forward needs "
                             f'batch["patches"] (B, num_patches, d_model)')
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return self._run_blocks(x, positions, None, None, patches)

    def forward(self, batch):
        """Logits (B, S, V) of ``batch["tokens"]`` (B, S) (or ``"embeds"``
        (B, S, d)), and the summed load-balance loss of the MoE blocks
        (zero without them), as the reference's ``Model.forward``. The VLM
        needs ``batch["patches"]`` (B, P, d), cast to the compute dtype."""
        if self._ents is not None:
            return self._sharded(batch)
        x, aux = self._hidden(batch)
        return self._logits(x), aux

    def loss(self, batch):
        """The reference's ``Model.loss``: the mean cross entropy of the
        logits against ``batch["labels"]`` (B, S), labels below 0 masked,
        plus ``router_aux_coef`` times the load-balance loss. Where
        ``cfg.logit_chunk`` divides S and is smaller, the logits are made
        and reduced a chunk of positions at a time, the (sum, count) pairs
        summed. Returns (loss, {"ce", "aux", "tokens"}), float32."""
        cfg = self.cfg
        labels = torch.as_tensor(batch["labels"]).to(self.device).long()
        S, C = labels.shape[1], cfg.logit_chunk
        if C and S % C == 0 and S > C and self._ents is not None:
            heads, aux = self._sharded(batch, chunk=C)
            tot = n = torch.zeros((), device=self.device)
            for c, logits in zip(range(0, S, C), heads):
                s, k = _masked_ce_sums(logits, labels[:, c:c + C])
                tot, n = tot + s, n + k
            ce = tot / torch.clamp(n, min=1.0)
        elif C and S % C == 0 and S > C:
            x, aux = self._hidden(batch)
            h = self._head_in(x)
            head = self.head.to(cfg.cdtype)
            tot = n = torch.zeros((), device=x.device)
            for c in range(0, S, C):
                logits = torch.einsum("bsd,dv->bsv", h[:, c:c + C], head)
                s, k = _masked_ce_sums(logits, labels[:, c:c + C])
                tot, n = tot + s, n + k
            ce = tot / torch.clamp(n, min=1.0)
        else:
            logits, aux = self.forward(batch)
            ce, n = _masked_ce(logits, labels)
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"ce": ce, "aux": aux, "tokens": n}

    def decode_step(self, cache, batch, cache_index: int):
        """One-token decode: ``batch["tokens"]`` (B, 1) (or ``"embeds"``
        (B, 1, d)) at position ``cache_index``; the VLM's cross-attention
        reads the patch k and v pre-cached under ``cross_groups.cross_kv``.
        Returns (logits (B, 1, V), cache), the cache written in place."""
        if self._ents is not None:
            return self._sharded(batch, cache, int(cache_index))[0], cache
        x = self._embed_in(batch)
        positions = torch.full((x.shape[0], 1), int(cache_index),
                               device=x.device)
        x, _ = self._run_blocks(x, positions, cache, int(cache_index))
        return self._logits(x), cache

    def init_cache(self, B: int, S_max: int):
        """The cache, as the reference's: zeros, in ``cfg.dtype`` but for
        the recurrent states, float32 (float64 in a float64 model). Under
        "blocks" k and v (L, B, S_max, KH, Dh), or for MLA the compressed
        c_kv (L, B, S_max, r) and k_rope (L, B, S_max, dr); under
        "prefix" one such dict, unstacked, for
        each of the ``first_dense`` blocks. The VLM: under "cross_groups",
        "self", the self blocks' k and v (G, M, B, S_max, KH, Dh), and
        "cross_kv", the patch cache's k and v (G, B, num_patches, KH, Dh),
        which the caller fills (serving leaves it zero, as the reference's
        does). ``rwkv6``: tm_shift and
        cm_shift (L, B, d), wkv (L, B, H, hd, hd). ``zamba2``: under
        "mamba" conv (G, M, B, K - 1, conv_dim) and ssm (G, M, B, H,
        d_state, head_dim), under "attn" the shared block's k and v (G, B,
        S_max, KH, Dh)."""
        cfg = self.cfg
        dev = self.device

        def zeros(*shape, dtype=cfg.cdtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        kv = (cfg.num_kv_heads, cfg.head_dim)
        if cfg.block_pattern == "rwkv6":
            L, (H, hd) = len(self.blocks), ssm.rwkv6_dims(cfg)
            return {"blocks": {
                "tm_shift": zeros(L, B, cfg.d_model),
                "cm_shift": zeros(L, B, cfg.d_model),
                "wkv": zeros(L, B, H, hd, hd, dtype=ssm.state_dtype(cfg))}}
        if cfg.block_pattern == "zamba2":
            G, M = _groups(cfg)
            _, H, conv_dim = ssm.mamba2_dims(cfg)
            return {"blocks": {
                "mamba": {"conv": zeros(G, M, B, cfg.conv_kernel - 1,
                                        conv_dim),
                          "ssm": zeros(G, M, B, H, cfg.ssm_state,
                                       cfg.ssm_head_dim,
                                       dtype=ssm.state_dtype(cfg))},
                "attn": {n: zeros(G, B, S_max, *kv) for n in ("k", "v")}}}
        if cfg.cross_attn_every:
            G, M = _groups(cfg)
            return {"cross_groups": {
                "self": {n: zeros(G, M, B, S_max, *kv) for n in ("k", "v")},
                "cross_kv": {n: zeros(G, B, cfg.num_patches, *kv)
                             for n in ("k", "v")}}}
        if cfg.mla:
            tails = {"c_kv": (cfg.kv_lora_rank,),
                     "k_rope": (cfg.qk_rope_dim,)}
        else:
            tails = {n: kv for n in ("k", "v")}

        def caches(*stack):
            return {n: zeros(*stack, B, S_max, *tail)
                    for n, tail in tails.items()}

        out = {"blocks": caches(len(self.blocks))}
        if self.prefix:
            out["prefix"] = [caches() for _ in self.prefix]
        return out

    def cache_specs(self, B: int, S_max: int):
        """The specs on ``self.mesh`` of ``init_cache(B, S_max)``'s leaves,
        a tree mirroring it, by the reference's ``init_cache`` rules: the
        batch over the data axes where they divide it; k and v by kv head
        over ``model`` where it divides the heads, else by position where
        it divides S_max; MLA's latent cache by position; Mamba2's conv
        channels and ssm heads by head where ``model`` divides the heads;
        RWKV6's state by batch only."""
        cfg, mesh = self.cfg, self.mesh
        m = axis_size(mesh, TP_AXIS)
        tp = TP_AXIS if m > 1 else None
        dp = dp_for(mesh, B)

        def kv(stack, KH, S=S_max):
            lead = (None,) * stack
            if tp and KH % m == 0:
                sp = P(*lead, dp, None, tp, None)
            elif tp and S % m == 0:
                sp = P(*lead, dp, tp, None, None)
            else:
                sp = P(*lead, dp, None, None, None)
            return {"k": sp, "v": sp}

        KH = cfg.num_kv_heads
        if cfg.block_pattern == "rwkv6":
            return {"blocks": {"tm_shift": P(None, dp, None),
                               "cm_shift": P(None, dp, None),
                               "wkv": P(None, dp, None, None, None)}}
        if cfg.block_pattern == "zamba2":
            _, H, _ = ssm.mamba2_dims(cfg)
            htp = tp if (tp and H % m == 0) else None
            return {"blocks": {
                "mamba": {"conv": P(None, None, dp, None, htp),
                          "ssm": P(None, None, dp, htp, None, None)},
                "attn": kv(1, KH)}}
        if cfg.cross_attn_every:
            return {"cross_groups": {"self": kv(2, KH),
                                     "cross_kv": kv(1, KH,
                                                    S=cfg.num_patches)}}
        if cfg.mla:
            seq = tp if (tp and S_max % m == 0) else None

            def latent(stack):
                sp = P(*(None,) * stack, dp, seq, None)
                return {"c_kv": sp, "k_rope": sp}
            out = {"blocks": latent(1)}
            if self.prefix:
                out["prefix"] = [latent(0) for _ in self.prefix]
            return out
        return {"blocks": kv(1, KH)}

    def params(self):
        """The parameter tree, as ``params`` takes it."""
        def tree(blocks):
            return [{k: dict(v.items()) for k, v in b.items()} for b in blocks]

        p = {"blocks": tree(self.blocks),
             "final_norm": dict(self.final_norm.items())}
        if self.embed is not None:
            p["embed"] = self.embed
        if self.prefix:
            p["prefix"] = tree(self.prefix)
        if self.cross:
            p["cross"] = tree(self.cross)
        if self.shared_attn is not None:
            p["shared_attn"] = tree([self.shared_attn])[0]
        if self.lm_head is not None:
            p["lm_head"] = self.lm_head
        return p

    # ------------------------------------------------------------------
    # run-time sharding over a (data, model) mesh
    # ------------------------------------------------------------------

    def _remat_entries(self, fn, *args):
        """``_remat`` of a sharded layer, its whole forward rerun in the
        backward (checkpoint's early stop off: it would cut the last
        entry's trailing work and no other's), so a rerun moves every
        collective of the layer again. On an abstract mesh its body runs at
        ``standing_for(1)``, so the work it does once, outside
        ``Entries.grid``, is weighed so in the rerun too. Where the entries
        sit on several devices the layer is rerun by ``_Rerun`` instead."""
        run = fn
        if self._ents.one:
            def run(*a):
                with standing_for(1):
                    return fn(*a)
        if (len({str(d) for row in self._ents.devices for d in row}) > 1
                and self.trainable and torch.is_grad_enabled()
                and self.cfg.remat != "none"):
            return _Rerun.run(run, *args)
        with set_checkpoint_early_stop(False):
            return self._remat(run, *args)

    def _parts(self):
        """The grid of each entry's parameter tree: its block of every leaf
        by ``param_specs`` (``Entries.part``). A serving model keeps it once
        built (the views follow in-place updates of the parameters); a
        trainable one builds it anew at each call, so that autograd
        records the views."""
        if self._parts_kept is not None:
            return self._parts_kept
        e, tree = self._ents, self.params()
        parts = e.grid(lambda i, j: map_tree(
            lambda x, s: e.part(x, s, i, j), tree, self._specs))
        if not self.trainable:
            self._parts_kept = parts
        return parts

    def _add(self, a, b):
        return self._ents.grid(lambda i, j: a[i][j] + b[i][j])

    def _slices(self, g):
        """Each entry's S / m slice of its (Bl, S, d) value, by model
        rank: a cut of a value the ranks hold alike, no transfer."""
        e = self._ents
        return e.grid(lambda i, j: g[i][j].chunk(e.M, 1)[j])

    def _reduce(self, g, partial: bool, sp: bool):
        """A sublayer's outputs into the residual's layout: partial sums
        over ``model`` all-reduced, or under the sequence-parallel residual
        reduce-scattered into its S / m slices; complete outputs kept, or
        cut into those slices."""
        e = self._ents
        if partial:
            return e.model_reduce_scatter(g, 1) if sp else \
                e.model_all_reduce(g)
        return self._slices(g) if sp else g

    def _norm(self, ps, name, X):
        cfg = self.cfg
        return self._ents.grid(lambda i, j: ll.rmsnorm(
            ps[i][j][name], X[i][j], cfg.norm_eps, fast=cfg.fast_norm))

    def _pre(self, ps, name, X, sp):
        """A sublayer's input: the norm ``name`` of the residual grid ``X``,
        under the sequence-parallel residual its slices all-gathered into
        the whole sequence."""
        H = self._norm(ps, name, X)
        return self._ents.model_all_gather(H, 1) if sp else H

    def _mlp_sharded(self, ps, name, spec, H, sp):
        """A SwiGLU MLP (``ps[i][j][name]``; ``spec`` the specs of its
        block), ``w_gate`` and ``w_up`` by column and ``w_down`` by row
        over ``model`` where it divides the hidden width (then an
        all-reduce, or a reduce-scatter), else replicated; under the
        sequence-parallel residual its input slices are all-gathered
        first."""
        e = self._ents
        if sp:
            H = e.model_all_gather(H, 1)
        Y = e.grid(lambda i, j: ll.mlp(ps[i][j][name], H[i][j],
                                       self.cfg.cdtype))
        return self._reduce(Y, spec[name]["w_down"][0] == TP_AXIS, sp)

    def _moe_sharded(self, ps, spec, H, sp):
        """The MoE sublayer (``moe.moe_layer`` over the mesh): each entry
        routes its data shard's whole sequence, or under
        ``moe_sp_dispatch`` (where ``model`` divides S and S >= m) its
        rank's S / m slice, as the reference's ``shard_map`` takes it; the
        outputs come back in the residual's layout; the shared expert
        (``spec`` its block's specs) beside it. Returns (outputs, the
        averaged load-balance loss)."""
        cfg, e = self.cfg, self._ents
        S = H[0][0].shape[1] * (e.M if sp else 1)
        spd = (cfg.moe_sp_dispatch and TP_AXIS in e.mesh.axis_names
               and S % e.M == 0 and S >= e.M)
        if spd and not sp:
            H_in = self._slices(H)
        elif sp and not spd:
            H_in = e.model_all_gather(H, 1)
        else:
            H_in = H
        Y, aux = moe_mod.moe_layer(e.grid(lambda i, j: ps[i][j]["moe"]),
                                   H_in, cfg, e)
        if spd and not sp:
            Y = e.model_all_gather(Y, 1)
        elif sp and not spd:
            Y = self._slices(Y)
        if "shared" in ps[0][0]:
            Y = self._add(Y, self._mlp_sharded(ps, "shared", spec, H, sp))
        return Y, aux

    def _block_sharded(self, ps, spec, X, positions, caches, layout,
                       cache_index, sp):
        """``_attn_block`` over the mesh: ``ps`` and ``X`` the grids of
        each entry's block parameters and residual (the whole sequence, or
        under ``sp`` its S / m slice), ``spec`` the block's specs; GQA
        attention or MLA (``ll.attention_sharded``,
        ``ll.mla_attention_sharded``), with ``caches`` each entry's part of
        the block's cache, laid out as ``layout`` says. Returns (X, the
        grid of the MoE load-balance loss, or None)."""
        e = self._ents
        H = self._pre(ps, "ln1", X, sp)
        attend = (ll.mla_attention_sharded if self.cfg.mla
                  else ll.attention_sharded)
        A, partial = attend(e.grid(lambda i, j: ps[i][j]["attn"]), H,
                            self.cfg, e, positions=positions, caches=caches,
                            layout=layout, cache_index=cache_index)
        X = self._add(X, self._reduce(A, partial, sp))
        H = self._norm(ps, "ln2", X)
        if "moe" not in ps[0][0]:
            return self._add(X, self._mlp_sharded(ps, "mlp", spec, H,
                                                  sp)), None
        Y, aux = self._moe_sharded(ps, spec, H, sp)
        return self._add(X, Y), aux

    def _rwkv6_sharded(self, ps, X, states, sp):
        """``_rwkv6_layer`` over the mesh (``ssm.rwkv6_time_mix_sharded``,
        ``rwkv6_channel_mix_sharded``): the time mix's partial sums
        reduced into the residual; the channel mix's values reduced, then
        gated by the receptance. ``states`` is the grid of each entry's
        part of the layer's {"tm_shift", "wkv", "cm_shift"} (decode).
        Returns (X, the grid of new time-mix states, of new channel-mix
        states; None without ``states``)."""
        cfg, e = self.cfg, self._ents
        H = self._pre(ps, "ln1", X, sp)
        A, partial, tm_new = ssm.rwkv6_time_mix_sharded(
            e.grid(lambda i, j: ps[i][j]["tm"]), H, cfg, e, states=states)
        X = self._add(X, self._reduce(A, partial, sp))
        H = self._pre(ps, "ln2", X, sp)
        V, partial, R, cm_new = ssm.rwkv6_channel_mix_sharded(
            e.grid(lambda i, j: ps[i][j]["cm"]), H, cfg, e, states=states)
        V = self._reduce(V, partial, sp)
        if sp:
            R = self._slices(R)
        return self._add(X, e.grid(lambda i, j: R[i][j] * V[i][j])), \
            tm_new, cm_new

    def _cache_parts(self, tree, specs, index):
        """Each entry's part of the cache leaves ``tree`` (name -> tensor)
        as ``specs`` lays them out, at the layer ``index`` of their stack
        (an int, a (group, layer) pair, or None for an unstacked leaf).
        Returns (the grid of views of the cache, the grid of parts: each
        the view, or where its entry sits on another device a copy, which
        ``_write_back`` returns to the view; the layout of an attention
        cache's layer, ``_layout``)."""
        e = self._ents
        depth = 0 if index is None else len(index) if isinstance(
            index, tuple) else 1

        def view(i, j):
            out = {}
            for k, v in tree.items():
                v = shard(v, specs[k], self.mesh, e.coords[i][j])
                out[k] = v if index is None else v[index]
            return out

        views = e.grid(view)
        return views, e.grid(lambda i, j: {
            k: v.to(e.devices[i][j]) for k, v in views[i][j].items()}), \
            _layout(next(iter(specs.values()))[depth:])

    def _cached_block(self, ps, spec, X, positions, cache, specs, index,
                      cache_index, sp):
        """``_block_sharded`` over each entry's part of the block's cache
        leaves ``cache`` (``specs`` their specs; None without a cache) at
        the layer ``index`` of their stack, the parts written back
        after."""
        views = caches = layout = None
        if cache is not None:
            views, caches, layout = self._cache_parts(cache, specs, index)
        X, aux = self._block_sharded(ps, spec, X, positions, caches, layout,
                                     cache_index, sp)
        if cache is not None:
            self._write_back(views, caches)
        return X, aux

    @staticmethod
    def _write_back(views, parts, new=None):
        """Write ``new`` (a grid of {name: value}, or None) into the cache
        ``parts``, and each part that is a copy back into its view."""
        for i, (vrow, prow) in enumerate(zip(views, parts)):
            for j, (v, c) in enumerate(zip(vrow, prow)):
                for k, t in (new[i][j].items() if new else ()):
                    c[k].copy_(t)
                for k in v:
                    if c[k] is not v[k]:
                        v[k].copy_(c[k])

    def _embed_sharded(self, parts, rows):
        """Each entry's embeddings of its data row's tokens: where the
        table is cut by vocabulary over ``model``, each rank looks up the
        tokens its rows hold, zeros elsewhere, and the ranks' lookups are
        all-reduced (one of them is non-zero: the sum is exact); else the
        whole table on each entry. Under ``embedding_inputs`` the row's
        embeddings, in the compute dtype."""
        cfg, e = self.cfg, self._ents
        dt = cfg.cdtype
        if cfg.embedding_inputs:
            return e.grid(lambda i, j: rows[i].to(device=e.devices[i][j],
                                                  dtype=dt))

        def look(i, j):
            emb = parts[i][j]["embed"].to(dt)
            tok = rows[i].long().to(emb.device)
            n = emb.shape[0]
            if n == cfg.vocab_size:
                return emb[tok]
            local = tok - j * n
            inside = (local >= 0) & (local < n)
            return torch.where(inside[..., None],
                               emb[local.clamp(0, n - 1)], 0)

        X = e.grid(look)
        if parts[0][0]["embed"].shape[0] < cfg.vocab_size:
            X = e.model_all_reduce(X)
        return X

    def _head_sharded(self, parts, X, split: bool):
        """The logits of the residual grid ``X`` (each entry its data
        row's whole sequence), the head by vocabulary over ``model`` where
        it divides the vocabulary (the tied head is the embedding's
        transpose), all-gathered over ``model``; the rows' logits
        concatenated on the model's device (``split``: the batch was cut
        over the data rows; else row 0's)."""
        cfg, e = self.cfg, self._ents

        def logits(i, j):
            p = parts[i][j]
            h = ll.rmsnorm(p["final_norm"], X[i][j], cfg.norm_eps)
            head = p["embed"].T if self.lm_head is None else p["lm_head"]
            return torch.einsum("bsd,dv->bsv", h, head.to(cfg.cdtype))

        L = e.grid(logits)
        if L[0][0].shape[-1] < cfg.vocab_size:
            L = e.model_all_gather(L, -1)
        rows = e.head_rows(L, self.device)
        return torch.cat(rows, 0) if split else rows[0]

    def _sharded(self, batch, cache=None, cache_index=None, chunk=0):
        """The model over its mesh: (the logits (B, S, V), or where
        ``chunk`` the list of each chunk of positions' logits, and the
        summed load-balance loss). With ``cache`` a decode step at
        ``cache_index``: each entry reads and writes its part of the cache
        as ``cache_specs`` lays it out (a view of the cache, or where its
        device is another a copy, written back after the layer)."""
        cfg, e = self.cfg, self._ents
        parts = self._parts()
        inp = torch.as_tensor(batch["embeds" if cfg.embedding_inputs
                                    else "tokens"]).to(self.device)
        B, S = inp.shape[:2]
        split = dp_for(self.mesh, B) is not None
        if not split and e.D > 1 and cfg.moe:
            raise ValueError(f"a batch of {B} does not split over the "
                             f"{e.D} data shards the MoE layer routes")
        rows = list(inp.chunk(e.D)) if split else [inp] * e.D
        X = self._embed_sharded(parts, rows)
        decode = cache is not None
        patches = None
        if self.cross and not decode:
            if batch.get("patches") is None:
                raise ValueError(f"{cfg.name}: forward needs "
                                 f'batch["patches"] (B, num_patches, '
                                 f'd_model)')
            pt = torch.as_tensor(batch["patches"]).to(device=self.device,
                                                      dtype=cfg.cdtype)
            patches = list(pt.chunk(e.D)) if split else [pt] * e.D
        positions = (torch.full((1, 1), cache_index, device=self.device)
                     if decode else
                     torch.arange(S, device=self.device)[None, :])
        sp = cfg.seq_parallel and e.M > 1 and S % e.M == 0
        if sp:
            X = self._slices(X)
        specs = self.cache_specs(B, _cache_len(cache)) if decode else None
        X, aux = self._run_sharded(parts, X, positions, cache, specs,
                                   cache_index, sp, patches)
        if sp:
            X = e.model_all_gather(X, 1)
        if chunk:
            out = [self._head_sharded(parts, e.grid(
                lambda i, j: X[i][j][:, c:c + chunk]), split)
                for c in range(0, S, chunk)]
        else:
            out = self._head_sharded(parts, X, split)
        if self.trainable and e.D > 1:
            self.mesh.count_backward(
                "all-reduce", out if chunk else [out], self._grad_bytes())
        return out, aux

    def _grad_bytes(self, skip=()) -> int:
        """The gradients' all-reduce over the data axes, as the reference
        counts it (every leaf is replicated over them): each entry's block
        of every leaf (``param_specs``) but those under the top-level keys
        ``skip``, once an entry, D M times in all."""
        e, total = self._ents, []
        tree = {k: v for k, v in self.params().items() if k not in skip}
        specs = {k: self._specs[k] for k in tree}
        map_tree(lambda x, s: total.append(block_bytes(x, s, self.mesh)),
                 tree, specs)
        return e.D * e.M * sum(total)

    def _run_sharded(self, parts, X, positions, cache, specs, cache_index,
                     sp, patches):
        """``_run_blocks`` over the mesh, each pattern's layers in its
        order: the ``rwkv6`` layers; zamba2's groups; the dense prefix,
        then the VLM's groups or the blocks. ``specs`` is
        ``cache_specs``' tree for ``cache`` (decode). Without a cache each
        scanned layer (each group) runs under ``_remat``. Returns (X, the
        summed load-balance loss)."""
        cfg, e = self.cfg, self._ents
        decode = cache is not None
        run = _call if decode else self._remat_entries
        aux = torch.zeros((), device=self.device)

        def entries(*path):
            return e.grid(lambda i, j: _at(parts[i][j], *path))

        if cfg.block_pattern == "rwkv6":
            for n in range(len(self.blocks)):
                views = states = None
                if decode:
                    views, states, _ = self._cache_parts(
                        cache["blocks"], specs["blocks"], n)
                X, tm, cm = run(self._rwkv6_sharded, entries("blocks", n), X,
                                states, sp)
                if decode:
                    self._write_back(views, states, e.grid(
                        lambda i, j: {**tm[i][j], **cm[i][j]}))
            return X, aux
        if cfg.block_pattern == "zamba2":
            for g in range(len(self.blocks) // cfg.shared_attn_every):
                X = run(self._zamba2_group_sharded, g, entries, X, positions,
                        cache, specs, cache_index, sp)
            return X, aux
        for i in range(len(self.prefix)):
            X, _ = self._cached_block(
                entries("prefix", i), self._specs["prefix"][i], X, positions,
                _at(cache, "prefix", i), _at(specs, "prefix", i), None,
                cache_index, sp)
        if self.cross:
            for g in range(len(self.cross)):
                X, a = run(self._vlm_group_sharded, g, entries, X, positions,
                           cache, specs, cache_index, sp, patches)
                aux = aux + a
            return X, aux
        for n in range(len(self.blocks)):
            X, a = run(self._cached_block, entries("blocks", n),
                       self._specs["blocks"][n], X, positions,
                       _at(cache, "blocks"), _at(specs, "blocks"), n,
                       cache_index, sp)
            if a is not None:
                aux = aux + a[0][0].to(self.device)
        return X, aux

    def _zamba2_group_sharded(self, g, entries, X, positions, cache, specs,
                              cache_index, sp):
        """``_zamba2_group`` over the mesh: its M Mamba2 layers
        (``ssm.mamba2_sharded``), each entry on its part of the conv and
        SSM states, then the shared attention block (``_block_sharded``)
        on its part of the group's k and v cache."""
        cfg, e = self.cfg, self._ents
        M = cfg.shared_attn_every
        for m in range(M):
            ps = entries("blocks", g * M + m)
            views = states = None
            if cache is not None:
                views, states, _ = self._cache_parts(
                    cache["blocks"]["mamba"], specs["blocks"]["mamba"],
                    (g, m))
            Y, partial, new = ssm.mamba2_sharded(
                e.grid(lambda i, j: ps[i][j]["mamba"]),
                self._pre(ps, "ln", X, sp), cfg, e, states=states)
            X = self._add(X, self._reduce(Y, partial, sp))
            if cache is not None:
                self._write_back(views, states, new)
        X, _ = self._cached_block(
            entries("shared_attn"), self._specs["shared_attn"], X, positions,
            _at(cache, "blocks", "attn"), _at(specs, "blocks", "attn"), g,
            cache_index, sp)
        return X

    def _vlm_group_sharded(self, g, entries, X, positions, cache, specs,
                           cache_index, sp, patches):
        """``_vlm_group`` over the mesh: its M self-attention blocks
        (``_block_sharded``, their k and v under the cache's
        ``cross_groups.self``), the cross-attention sublayer
        (``ll.cross_attention_sharded``, over each data row's ``patches``,
        or at decode over the entries' parts of the group's ``cross_kv``),
        its partial sums reduced before the gate, then the MLP. Returns
        (X, the group's summed load-balance loss)."""
        cfg, e = self.cfg, self._ents
        M = cfg.cross_attn_every
        aux = torch.zeros((), device=self.device)
        for m in range(M):
            n = g * M + m
            X, a = self._cached_block(
                entries("blocks", n), self._specs["blocks"][n], X, positions,
                _at(cache, "cross_groups", "self"),
                _at(specs, "cross_groups", "self"), (g, m), cache_index, sp)
            if a is not None:
                aux = aux + a[0][0].to(self.device)
        gp = entries("cross", g)
        kv = layout = None
        if cache is not None:
            _, kv, layout = self._cache_parts(
                cache["cross_groups"]["cross_kv"],
                specs["cross_groups"]["cross_kv"], g)
        A, partial = ll.cross_attention_sharded(
            e.grid(lambda i, j: gp[i][j]["cross"]),
            self._pre(gp, "cross_ln", X, sp), patches, cfg, e, kv_caches=kv,
            layout=layout)
        A = self._reduce(A, partial, sp)
        X = self._add(X, e.grid(lambda i, j: ll.cross_gate(
            gp[i][j]["cross"], A[i][j], cfg)))
        Y = self._mlp_sharded(gp, "cross_mlp", self._specs["cross"][g],
                              self._norm(gp, "cross_ln2", X), sp)
        return self._add(X, Y), aux


class _Rerun(torch.autograd.Function):
    """Remat of a sharded layer whose entries sit on several devices, "full"
    or "dots" alike: the layer runs without autograd, and its backward
    reruns it with autograd and takes the gradients of every tensor it was
    given (the entries' blocks of the leaves among them), in this one
    node. A backward over several devices runs a thread a device, and
    ``torch.utils.checkpoint`` reruns a layer in whichever thread first
    reads one of its saved tensors, with no lock, so two threads can rerun
    it at once and break its frame; here one thread does. The numbers are
    the layer's own; the gradients of a leaf's uses within the layer are
    summed before the leaf's other uses, where a checkpoint sums them with
    those (rounding only)."""

    @staticmethod
    def run(fn, *args):
        flat, spec = tree_flatten(args)
        where = [k for k, x in enumerate(flat) if isinstance(x, torch.Tensor)]
        box = {}
        outs = _Rerun.apply(fn, flat, spec, where, box,
                            *[flat[k] for k in where])
        out, ospec, owhere = box["out"]
        oflat = list(out)
        for k, t in zip(owhere, outs):
            oflat[k] = t
        return tree_unflatten(oflat, ospec)

    @staticmethod
    def forward(ctx, fn, flat, spec, where, box, *tensors):
        ctx.fn, ctx.flat, ctx.spec, ctx.where = fn, flat, spec, where
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        out = fn(*tree_unflatten(flat, spec))
        oflat, ospec = tree_flatten(out)
        owhere = [k for k, x in enumerate(oflat)
                  if isinstance(x, torch.Tensor)]
        box["out"] = (oflat, ospec, owhere)
        return tuple(oflat[k] for k in owhere)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in ctx.saved_tensors]
        flat = list(ctx.flat)
        for k, x in zip(ctx.where, inputs):
            flat[k] = x
        with torch.enable_grad():
            out = ctx.fn(*tree_unflatten(flat, ctx.spec))
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, None, None, None, None,
                *[next(got) if x.requires_grad else None for x in inputs])


def _at(tree, *path):
    """The subtree of ``tree`` at ``path`` (keys and indices); None where
    ``tree`` is None (no cache)."""
    return None if tree is None else functools.reduce(
        lambda t, k: t[k], path, tree)


def _layout(spec):
    """The layout of one layer's k and v cache (or MLA's latent) by its
    spec, (batch, position, kv head, ...): "heads" (by kv head over
    ``model``), "seq" (by position) or None (replicated)."""
    if len(spec) > 2 and spec[2] == TP_AXIS:
        return "heads"
    return "seq" if spec[1] == TP_AXIS else None


def _cache_len(cache) -> int:
    """S_max of a cache: the positions of its attention or latent cache (0
    for ``rwkv6``'s, which holds none)."""
    if "cross_groups" in cache:
        return cache["cross_groups"]["self"]["k"].shape[3]
    blocks = cache["blocks"]
    if "attn" in blocks:
        return blocks["attn"]["k"].shape[2]
    for name in ("k", "c_kv"):
        if name in blocks:
            return blocks[name].shape[2]
    return 0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _masked_ce_sums(logits, labels):
    """(the sum of the cross entropies of the positions whose label is at
    least 0, their count), logsumexp in float32 or wider."""
    lf = ll.wide(logits)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(lf.dtype)
    return ((lse - gold) * mask).sum(), mask.sum()


def _masked_ce(logits, labels):
    s, n = _masked_ce_sums(logits, labels)
    return s / torch.clamp(n, min=1.0), n
