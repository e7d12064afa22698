"""The dense decoder-only model (PyTorch port of the ``block_pattern ==
"attn"`` path of ``repro/models/transformer.py``): dense GQA/MQA/MHA
(smollm, yi, granite, phi3), with tied or separate embeddings.

``Model`` is an ``nn.Module`` with ``forward(batch)``, the single-token
serving step ``decode_step(cache, batch, cache_index)`` and
``init_cache(B, S_max)``. It serves: no autograd and no remat (training is
a later slice). Its parameters are the reference's tree with the stacked
``(L, ...)`` layer axis unstacked into one entry a layer. The reference
keeps them in ``cfg.param_dtype`` and casts the matrices to ``cfg.dtype``
at every use; the model holds each matrix once, in ``cfg.dtype``, which
computes the same numbers, and the norms' scales in ``cfg.param_dtype``.
A config that needs a part not ported yet raises ``NotImplementedError``
naming its ROADMAP item; it is never approximated.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models.common import Initializer, ModelConfig, unstack

# the config fields whose layers wait for a slice of their own, and what
# they wait for (ROADMAP.md, Queue 1)
_WAITS = (
    ("mla", "MLA + MoE (deepseek-v2-lite-16b), ROADMAP Queue 1 item 15"),
    ("first_dense", "MLA + MoE (deepseek-v2-lite-16b), ROADMAP Queue 1 "
                    "item 15"),
    ("moe", "MoE (olmoe-1b-7b, models/moe.py), ROADMAP Queue 1 item 14"),
    ("cross_attn_every", "VLM and audio (llama-3.2-vision-11b, "
                         "musicgen-large), ROADMAP Queue 1 item 17"),
    ("embedding_inputs", "VLM and audio (llama-3.2-vision-11b, "
                         "musicgen-large), ROADMAP Queue 1 item 17"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the dense family."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block_pattern {cfg.block_pattern!r} is not ported "
            f"yet: SSM/hybrid (rwkv6-3b, zamba2-2.7b, models/ssm.py, "
            f"models/gla.py), ROADMAP Queue 1 item 16")
    for field, waits in _WAITS:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"yet: {waits}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None):
    """The parameter tree drawn as the reference's ``Model.init`` draws it
    (stacked layers, the same kinds, scales and order), layers unstacked,
    on ``device`` (the card unless the caller asks for the CPU). The
    matrices come in ``dtype`` (``cfg.pdtype`` unless given), the norms'
    scales in ``cfg.pdtype``."""
    ini = Initializer(cfg, seed=seed, device=device, dtype=dtype)
    L, d = cfg.num_layers, cfg.d_model
    p: Dict[str, Any] = {"embed": ini.param("embed", (cfg.vocab_size, d),
                                            init="embed", scale=0.02)}
    blocks = {
        "ln1": ll.init_rmsnorm(ini, "blocks/ln1", d, (L,)),
        "ln2": ll.init_rmsnorm(ini, "blocks/ln2", d, (L,)),
        "attn": ll.init_attention(ini, "blocks/attn", cfg, (L,)),
        "mlp": ll.init_mlp(ini, "blocks/mlp", d, cfg.d_ff, (L,)),
    }
    p["blocks"] = unstack(blocks, L)
    p["final_norm"] = ll.init_rmsnorm(ini, "final_norm", d)
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.param("lm_head", (d, cfg.vocab_size), scale=0.02)
    return p


def _param(x, device, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(x).to(device=device, dtype=dtype),
                        requires_grad=False)


def _params(tree, device, dtype=None) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, device, dtype)
                             for k, v in tree.items()})


class Model(nn.Module):
    """The dense decoder on ``device`` (the card unless the caller asks for
    the CPU; without a card asking for it raises). ``params`` (the tree of
    ``init_params`` or of ``models/convert.from_reference``) is loaded with
    each matrix cast to ``cfg.dtype`` once, where the reference casts it at
    every use (the same numbers), and the norms' scales as they are;
    without it the parameters are drawn from ``seed`` on ``device``,
    straight into those dtypes."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 params=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.cdtype
        if params is None:
            params = init_params(cfg, seed=seed, device=device, dtype=dt)
        if len(params["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(params['blocks'])} layers of parameters "
                             f"for a config of {cfg.num_layers}")
        self.embed = _param(params["embed"], device, dt)
        self.blocks = nn.ModuleList(nn.ModuleDict({
            "ln1": _params(b["ln1"], device), "ln2": _params(b["ln2"], device),
            "attn": _params(b["attn"], device, dt),
            "mlp": _params(b["mlp"], device, dt)}) for b in params["blocks"])
        self.final_norm = _params(params["final_norm"], device)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(params["lm_head"], device, dt))

    @property
    def head(self) -> torch.Tensor:
        """The (d_model, vocab) output matrix: the embedding's transpose
        where the embeddings are tied."""
        return self.embed.T if self.lm_head is None else self.lm_head

    # ------------------------------------------------------------------
    # block application
    # ------------------------------------------------------------------

    def _attn_block(self, p, x, positions, cache, cache_index):
        cfg = self.cfg
        h = ll.rmsnorm(p["ln1"], x, cfg.norm_eps, fast=cfg.fast_norm)
        a, _ = ll.attention(p["attn"], h, cfg, positions=positions,
                            cache=cache, cache_index=cache_index)
        x = x + a
        h = ll.rmsnorm(p["ln2"], x, cfg.norm_eps, fast=cfg.fast_norm)
        return x + ll.mlp(p["mlp"], h, cfg.cdtype)

    def _run_blocks(self, x, positions, cache, cache_index):
        for i, blk in enumerate(self.blocks):
            c = None if cache is None else {
                "k": cache["blocks"]["k"][i], "v": cache["blocks"]["v"][i]}
            x = self._attn_block(blk, x, positions, c, cache_index)
        return x

    # ------------------------------------------------------------------
    # forward / decode
    # ------------------------------------------------------------------

    def _embed_in(self, batch):
        return self.embed[torch.as_tensor(batch["tokens"]).long()
                          .to(self.embed.device)]

    def _logits(self, x):
        h = ll.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", h, self.head)

    def forward(self, batch):
        """Logits (B, S, V) of ``batch["tokens"]`` (B, S), and the auxiliary
        loss (zero: no MoE), as the reference's ``Model.forward``."""
        x = self._embed_in(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run_blocks(x, positions, None, None)
        return self._logits(x), torch.zeros((), device=x.device)

    def decode_step(self, cache, batch, cache_index: int):
        """One-token decode: ``batch["tokens"]`` (B, 1) at position
        ``cache_index``. Returns (logits (B, 1, V), cache), the cache
        written in place."""
        x = self._embed_in(batch)
        positions = torch.full((x.shape[0], 1), int(cache_index),
                               device=x.device)
        x = self._run_blocks(x, positions, cache, int(cache_index))
        return self._logits(x), cache

    def init_cache(self, B: int, S_max: int):
        """The KV cache, zeros in ``cfg.dtype``: k and v of shape (L, B,
        S_max, KH, Dh) under "blocks", as the reference's."""
        cfg = self.cfg
        shape = (cfg.num_layers, B, S_max, cfg.num_kv_heads, cfg.head_dim)
        return {"blocks": {
            "k": torch.zeros(shape, dtype=cfg.cdtype, device=self.embed.device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=self.embed.device)}}

    def params(self):
        """The parameter tree, as ``params`` takes it."""
        p = {"embed": self.embed,
             "blocks": [{k: dict(v.items()) for k, v in b.items()}
                        for b in self.blocks],
             "final_norm": dict(self.final_norm.items())}
        if self.lm_head is not None:
            p["lm_head"] = self.lm_head
        return p
