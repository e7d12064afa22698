"""Shared model-config and parameter utilities (PyTorch port of
``repro/models/common.py``).

Every assigned architecture is expressed as one ``ModelConfig``, the
reference's own fields; ``cdtype`` and ``pdtype`` are torch dtypes here.
Parameters are nested dicts of tensors, drawn by ``Initializer`` from an
explicit ``torch.Generator`` on the card (or the CPU where the caller asks
for it) with the reference's init kinds and scales. The mesh rules (``spec_for``, ``tree_specs``, the
axis names) wait for the sharded path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves

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
    parameters across (``models/convert.py``)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 dtype=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = cfg.pdtype if dtype is None else dtype
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

    def param(self, path: str, shape, init="normal", scale=None, dtype=None):
        """One leaf. ``path`` names it, as the reference's does. A stacked
        leaf (leading layer axis, or zamba2's (G, M) group axes) takes its
        fan-in from its first axis, as the reference's does. ``dtype``
        overrides the drawn leaves' dtype for a leaf the model keeps in
        another (the MoE router, RWKV6's decay path and bonus)."""
        shape = tuple(int(s) for s in shape)
        drawn = self.dtype if dtype is None else dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=self.cfg.pdtype,
                               device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.cfg.pdtype,
                              device=self.device)
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
