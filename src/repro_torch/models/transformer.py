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

``Model`` is an ``nn.Module`` with ``forward(batch)``, the single-token
serving step ``decode_step(cache, batch, cache_index)`` and
``init_cache(B, S_max)``. It serves: no autograd and no remat (training is
a later slice). Its parameters are the reference's tree with the stacked
layer axes unstacked into one entry a layer: ``prefix``, the
``first_dense`` leading dense blocks (unstacked in the reference too), and
``blocks``, the other layers, each with an ``mlp`` or, for MoE configs,
``moe`` and the merged shared expert ``shared``; for the VLM the (G, M)
stack of self blocks, its G * M layers in order, and ``cross``, one dict a
group of the reference's (G,) stacks ``cross``, ``cross_ln``,
``cross_mlp`` and ``cross_ln2``; for ``rwkv6`` the (L,) stack of ``ln1``,
``tm``, ``ln2``, ``cm``; for ``zamba2`` the (G, M) stack of ``ln`` and
``mamba``, its G * M layers in order, and the one unstacked
``shared_attn`` block. The reference keeps them in
``cfg.param_dtype`` and casts the matrices to ``cfg.dtype`` at every use;
the model holds each matrix once, in ``cfg.dtype``, which computes the
same numbers, and keeps in ``cfg.param_dtype`` the leaves the reference
reads in float32: the norms' scales (``kv_norm``, RWKV6's ``ln_scale`` and
Mamba2's gated ``norm`` among them), the MoE router, RWKV6's decay path
(``w0``, ``decay_w1``, ``decay_w2``) and bonus ``u``, and Mamba2's
``a_log`` and ``dt_bias``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

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


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block pattern the reference has no model
    of."""
    if cfg.block_pattern not in _PATTERNS:
        raise ValueError(f"{cfg.name}: block_pattern {cfg.block_pattern!r}")


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


def _param(x, device, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(x).to(device=device, dtype=dtype),
                        requires_grad=False)


def _block(tree, device, dt) -> nn.ModuleDict:
    """One block's parameters: each matrix cast to ``dt``, the leaves of
    ``_NORMS`` and ``_KEPT`` as they are."""
    return nn.ModuleDict({part: nn.ParameterDict({
        name: _param(w, device, None if part in _NORMS or name in _KEPT
                     else dt) for name, w in leaves.items()})
        for part, leaves in tree.items()})


class Model(nn.Module):
    """The decoder on ``device`` (the card unless the caller asks for the
    CPU; without a card asking for it raises). ``params`` (the tree of
    ``init_params`` or of ``models/convert.from_reference``) is loaded with
    each matrix cast to ``cfg.dtype`` once, where the reference casts it at
    every use (the same numbers), and the leaves of ``_NORMS`` and
    ``_KEPT`` as they are; without it the parameters are drawn from
    ``seed`` on ``device``, straight into those dtypes. ``embed`` is None
    under ``embedding_inputs``; ``cross`` holds the VLM's G cross-attention
    groups (empty for every other model)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 params=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.cdtype
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
        self.embed = (None if cfg.embedding_inputs
                      else _param(params["embed"], device, dt))
        self.prefix = nn.ModuleList(_block(b, device, dt) for b in prefix)
        self.blocks = nn.ModuleList(_block(b, device, dt)
                                    for b in params["blocks"])
        self.cross = nn.ModuleList(_block(g, device, dt) for g in cross)
        self.shared_attn = (_block(params["shared_attn"], device, dt)
                            if cfg.block_pattern == "zamba2" else None)
        self.final_norm = nn.ParameterDict({
            k: _param(v, device) for k, v in params["final_norm"].items()})
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(params["lm_head"], device, dt))

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

    def _rwkv6_blocks(self, x, cache):
        """The reference's ``rwkv6`` body: norm, time mix, residual, norm,
        channel mix, residual; with a cache, each layer's shifts and wkv
        state written back in place."""
        cfg = self.cfg
        for i, blk in enumerate(self.blocks):
            tm_state = cm_state = None
            if cache is not None:
                c = cache["blocks"]
                tm_state = {"tm_shift": c["tm_shift"][i], "wkv": c["wkv"][i]}
                cm_state = {"cm_shift": c["cm_shift"][i]}
            a, tm_new = ssm.rwkv6_time_mix(
                blk["tm"], ll.rmsnorm(blk["ln1"], x, cfg.norm_eps,
                                      fast=cfg.fast_norm), cfg,
                state=tm_state)
            x = x + a
            m, cm_new = ssm.rwkv6_channel_mix(
                blk["cm"], ll.rmsnorm(blk["ln2"], x, cfg.norm_eps,
                                      fast=cfg.fast_norm), cfg,
                state=cm_state)
            x = x + m
            if cache is not None:
                for state, new in ((tm_state, tm_new), (cm_state, cm_new)):
                    for k, v in new.items():
                        state[k].copy_(v)
        return x

    def _zamba2_groups(self, x, positions, cache, cache_index):
        """The reference's ``zamba2`` groups: M Mamba2 layers behind their
        norms, then the shared attention block, the same weights in every
        group and a KV cache of its own a group; with a cache, each Mamba2
        layer's conv and ssm state written back in place."""
        cfg = self.cfg
        M = cfg.shared_attn_every
        for g in range(len(self.blocks) // M):
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

    def _vlm_groups(self, x, positions, cache, cache_index, patches):
        """The reference's ``_vlm_groups``: for each group its M self
        attention blocks (their k and v under the cache's
        ``cross_groups.self`` (G, M, ...)), then the cross-attention
        sublayer behind ``cross_ln``, over the group's ``cross_kv`` when
        decoding and over ``patches`` when not, then the MLP behind
        ``cross_ln2``. Returns (x, the summed load-balance loss)."""
        cfg = self.cfg
        M = cfg.cross_attn_every
        aux = torch.zeros((), device=x.device)
        for g, gp in enumerate(self.cross):
            for j in range(M):
                kv = None if cache is None else {
                    k: v[g, j] for k, v in
                    cache["cross_groups"]["self"].items()}
                x, a = self._attn_block(self.blocks[g * M + j], x, positions,
                                        kv, cache_index)
                if a is not None:
                    aux = aux + a
            kvc = None if cache is None else {
                k: v[g] for k, v in cache["cross_groups"]["cross_kv"].items()}
            z = ll.rmsnorm(gp["cross_ln"], x, cfg.norm_eps, fast=cfg.fast_norm)
            x = x + ll.cross_attention(gp["cross"], z, patches, cfg,
                                       kv_cache=kvc)
            z = ll.rmsnorm(gp["cross_ln2"], x, cfg.norm_eps,
                           fast=cfg.fast_norm)
            x = x + ll.mlp(gp["cross_mlp"], z, cfg.cdtype)
        return x, aux

    def _run_blocks(self, x, positions, cache, cache_index, patches=None):
        """Returns (x, the summed load-balance loss, float32)."""
        aux = torch.zeros((), device=x.device)
        if self.cfg.block_pattern == "rwkv6":
            return self._rwkv6_blocks(x, cache), aux
        if self.cfg.block_pattern == "zamba2":
            return self._zamba2_groups(x, positions, cache, cache_index), aux
        for i, blk in enumerate(self.prefix):
            c = None if cache is None else cache["prefix"][i]
            x, _ = self._attn_block(blk, x, positions, c, cache_index)
        if self.cross:
            return self._vlm_groups(x, positions, cache, cache_index, patches)
        for i, blk in enumerate(self.blocks):
            c = None if cache is None else {
                k: v[i] for k, v in cache["blocks"].items()}
            x, a = self._attn_block(blk, x, positions, c, cache_index)
            if a is not None:
                aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # forward / decode
    # ------------------------------------------------------------------

    def _embed_in(self, batch):
        """The token embeddings of ``batch["tokens"]`` (B, S), or under
        ``embedding_inputs`` ``batch["embeds"]`` (B, S, d) in the compute
        dtype."""
        if self.cfg.embedding_inputs:
            return torch.as_tensor(batch["embeds"]).to(
                device=self.device, dtype=self.cfg.cdtype)
        return self.embed[torch.as_tensor(batch["tokens"]).long()
                          .to(self.device)]

    def _logits(self, x):
        h = ll.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", h, self.head)

    def forward(self, batch):
        """Logits (B, S, V) of ``batch["tokens"]`` (B, S) (or ``"embeds"``
        (B, S, d)), and the summed load-balance loss of the MoE blocks
        (zero without them), as the reference's ``Model.forward``. The VLM
        needs ``batch["patches"]`` (B, P, d), cast to the compute dtype."""
        x = self._embed_in(batch)
        patches = batch.get("patches")
        if patches is not None:
            patches = torch.as_tensor(patches).to(device=x.device,
                                                  dtype=self.cfg.cdtype)
        elif self.cross:
            raise ValueError(f"{self.cfg.name}: forward needs "
                             f'batch["patches"] (B, num_patches, d_model)')
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux = self._run_blocks(x, positions, None, None, patches)
        return self._logits(x), aux

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
