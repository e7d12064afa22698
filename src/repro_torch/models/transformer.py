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
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import Initializer, ModelConfig, unstack

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


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None):
    """The parameter tree drawn as the reference's ``Model.init`` draws it
    (the prefix blocks unstacked, the others stacked; the same kinds,
    scales and order; no ``embed`` under ``embedding_inputs``), layers
    unstacked, on ``device`` (the card unless the caller asks for the
    CPU). The matrices come in ``dtype`` (``cfg.pdtype`` unless given);
    the leaves of ``_NORMS`` and ``_KEPT`` in ``cfg.pdtype``."""
    check_supported(cfg)
    ini = Initializer(cfg, seed=seed, device=device, dtype=dtype)
    d = cfg.d_model
    p: Dict[str, Any] = {}
    if not cfg.embedding_inputs:
        p["embed"] = ini.param("embed", (cfg.vocab_size, d), init="embed",
                               scale=0.02)
    p.update(_init_blocks(ini, cfg))
    p["final_norm"] = ll.init_rmsnorm(ini, "final_norm", d)
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.param("lm_head", (d, cfg.vocab_size), scale=0.02)
    return p


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
    straight into those dtypes. ``embed`` is None under
    ``embedding_inputs``; ``cross`` holds the VLM's G cross-attention
    groups (empty for every other model)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 params=None, trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.trainable = trainable
        device = resolve_device(device)
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
        if C and S % C == 0 and S > C:
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
        x = self._embed_in(batch)
        positions = torch.full((x.shape[0], 1), int(cache_index),
                               device=x.device)
        x, _ = self._run_blocks(x, positions, cache, int(cache_index))
        return self._logits(x), cache

    def init_cache(self, B: int, S_max: int):
        """The cache, as the reference's: zeros, in ``cfg.dtype`` but for
        the recurrent states, float32. Under "blocks" k and v (L, B, S_max,
        KH, Dh), or for MLA the compressed c_kv (L, B, S_max, r) and k_rope
        (L, B, S_max, dr); under "prefix" one such dict, unstacked, for
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
                "wkv": zeros(L, B, H, hd, hd, dtype=torch.float32)}}
        if cfg.block_pattern == "zamba2":
            G, M = _groups(cfg)
            _, H, conv_dim = ssm.mamba2_dims(cfg)
            return {"blocks": {
                "mamba": {"conv": zeros(G, M, B, cfg.conv_kernel - 1,
                                        conv_dim),
                          "ssm": zeros(G, M, B, H, cfg.ssm_state,
                                       cfg.ssm_head_dim, dtype=torch.float32)},
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
