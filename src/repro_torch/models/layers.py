"""Core transformer layers (PyTorch port of ``repro/models/layers.py``):
RMSNorm, RoPE, GQA/MQA/MHA attention (blockwise over query chunks) and the
SwiGLU MLP, and the activations written as the reference's XLA computes
them (``logistic``, ``silu``, ``softplus``).

Plain functions on nested dicts of tensors, as the reference's are, with
the reference's numerics: RMSNorm statistics and RoPE in float32, float32
attention scores under the -1e30 causal mask, softmax in float32, its
weights cast to ``v``'s dtype. "float32" is a floor (``wide``): a float64
model, which no reference config has, computes all of it in float64.
``scaled_dot_product_attention`` would change both the numbers and the
mask, so attention is written out with ``torch.einsum``, as the
reference leaves it to XLA. MLA (DeepSeek's multi-head latent attention)
decodes from its compressed cache, absorbed or expanded. Cross-attention (the VLM's) attends from the text to patch
embeddings, or to their k and v cached, with no mask, behind a tanh gate.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import Initializer, ModelConfig

def wide(x):
    """``x`` in float32, or as it is where it is wider (float64): the
    dtype of the statistics, rotations and scores the reference computes
    in float32."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(ini: Initializer, path: str, dim: int, stack=()):
    L = ("layers",) * len(stack)
    return {"scale": ini.param(f"{path}/scale", (*stack, dim), (*L, None),
                               init="ones")}


def rmsnorm(p, x, eps: float, fast: bool = False):
    """RMSNorm with float32 statistics. ``fast=True`` keeps the normalized
    tensor in the input dtype (only the per-row statistic is float32)."""
    var = wide(x).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    if fast:
        return x * r.to(x.dtype) * p["scale"].to(x.dtype)
    out = wide(x) * r
    return (out * p["scale"].to(out.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None, dtype=torch.float32):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=dtype,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    xw = wide(x)
    freqs = rope_freqs(d, theta, x.device, xw.dtype)              # (d/2,)
    ang = positions[..., :, None, None].to(xw.dtype) * freqs  # (.., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xw.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled dot-product attention (blockwise over query chunks)
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, *, causal: bool, q_offset, scale: float):
    """q: (B, Sq, H, D), k/v: (B, Sk, KH, D|Dv) with H % KH == 0.

    Returns (B, Sq, H, Dv). Scores accumulate in float32: the products of
    the inputs' values, exact in float32, summed in float32."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", wide(qg), wide(k))
    scores = scores * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, KH * G, v.shape[-1])


def attention_core(q, k, v, *, causal: bool, q_offset=0, chunk: int = 0,
                   scale=None):
    """Blockwise attention: queries in chunks of ``chunk``, so the
    materialized score block is (B, H, chunk, Sk) instead of (B, H, Sq,
    Sk)."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if not chunk or Sq <= chunk:
        return _sdpa(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    if Sq % chunk:
        raise ValueError(f"{Sq} queries do not split into chunks of {chunk}")
    return torch.cat([
        _sdpa(q[:, i:i + chunk], k, v, causal=causal, q_offset=q_offset + i,
              scale=scale) for i in range(0, Sq, chunk)], dim=1)


# ---------------------------------------------------------------------------
# GQA self-attention layer
# ---------------------------------------------------------------------------


def init_attention(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    L = ("layers",) * len(stack)
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ini.param(f"{path}/wq", (*stack, d, H, Dh),
                        (*L, None, "heads", None)),
        "wk": ini.param(f"{path}/wk", (*stack, d, KH, Dh),
                        (*L, None, "kv_heads", None)),
        "wv": ini.param(f"{path}/wv", (*stack, d, KH, Dh),
                        (*L, None, "kv_heads", None)),
        "wo": ini.param(f"{path}/wo", (*stack, H, Dh, d),
                        (*L, "heads", None, None),
                        scale=1.0 / math.sqrt(H * Dh)),
    }


def _qkv(p, x, cfg: ModelConfig, positions):
    """The queries, keys and values of ``x``, rotated."""
    dt = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _cache_range(cache_index: int, n: int, S_max: int) -> int:
    end = cache_index + n
    if not 0 <= cache_index <= end <= S_max:
        raise ValueError(f"cache positions [{cache_index}, {end}) outside "
                         f"a cache of {S_max}")
    return end


def attention(p, x, cfg: ModelConfig, *, positions, cache=None,
              cache_index=None):
    """Self attention. If ``cache`` is given (dict with k, v of shape
    (B, S_max, KH, Dh)), performs a decode step: writes k and v at
    ``cache_index`` (in place, where the reference returns an updated copy)
    and attends over the cache. Returns (out, cache)."""
    dt = cfg.cdtype
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        out = attention_core(q, k, v, causal=True, chunk=cfg.attn_chunk)
    else:
        ck, cv = cache["k"], cache["v"]
        end = _cache_range(cache_index, k.shape[1], ck.shape[1])
        ck[:, cache_index:end] = k.to(ck.dtype)
        cv[:, cache_index:end] = v.to(cv.dtype)
        # decode: positions past cache_index are masked by the causal offset
        out = attention_core(q, ck.to(dt), cv.to(dt), causal=True,
                             q_offset=cache_index, chunk=0)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache


def _kv_heads(k, v, cfg: ModelConfig, heads: int, j: int):
    """The keys and values that model rank ``j``'s ``heads`` query heads
    (its block of ``num_heads``) read, where the kv heads are replicated:
    their kv groups' contiguous block where the rank's heads are whole
    groups, else one kv head for each query head (kv head h // q_per_kv
    for query head h)."""
    G = cfg.q_per_kv
    if heads == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k, v                 # q replicated, or k and v sharded too
    if heads % G == 0:
        lo = j * heads // G
        return k[:, :, lo:lo + heads // G], v[:, :, lo:lo + heads // G]
    idx = torch.arange(j * heads, (j + 1) * heads, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_sharded(ps, hs, cfg: ModelConfig, ents, *, positions,
                      caches=None, layout=None, cache_index=None):
    """Self attention over a (data, model) mesh (``common.Entries``), the
    tensor-parallel layout of the reference's specs. ``ps`` is the grid of
    each entry's blocks of ``wq``, ``wk``, ``wv`` and ``wo``: q by head
    where ``model`` divides ``num_heads``, k and v by kv head where it
    divides ``num_kv_heads``, else replicated; where q is sharded and k and
    v are not, a rank reads the kv head of each of its query heads
    (``_kv_heads``). ``hs`` is the grid of entry inputs, each its data
    shard's whole sequence. With ``caches`` (the grid of each entry's part
    of one layer's k and v cache, laid out as ``Model.cache_specs`` says:
    ``layout`` "heads" (by kv head), "seq" (by position over ``model``) or
    None (replicated)), a decode step: each entry writes its k and v at
    ``cache_index`` into its part, where "seq" only the rank whose
    positions hold it; a "seq" cache is all-gathered over ``model``
    (counted) before the scores. Returns (the grid of outputs, whether
    they are partial sums over ``model``: ``wo`` is row-parallel where q
    is sharded, and the caller all-reduces or reduce-scatters them; where
    q is replicated each entry's output is complete)."""
    dt = cfg.cdtype
    qkv = ents.grid(lambda i, j: _qkv(ps[i][j], hs[i][j], cfg, positions))
    heads = ps[0][0]["wq"].shape[1]
    if caches is None:
        kv = [[(k, v) for _, k, v in row] for row in qkv]
    else:
        for i in range(ents.D):
            for j in range(ents.M):
                _, k, v = qkv[i][j]
                c = caches[i][j]
                n = c["k"].shape[1]
                lo = j * n if layout == "seq" else 0
                S_max = n * ents.M if layout == "seq" else n
                end = _cache_range(cache_index, k.shape[1], S_max)
                a, b = max(cache_index, lo), min(end, lo + n)
                for name, t in (("k", k), ("v", v)) if a < b else ():
                    c[name][:, a - lo:b - lo] = t[
                        :, a - cache_index:b - cache_index].to(c[name].dtype)
        ck = [[c["k"] for c in row] for row in caches]
        cv = [[c["v"] for c in row] for row in caches]
        if layout == "seq":
            ck = ents.model_all_gather(ck, 1)
            cv = ents.model_all_gather(cv, 1)
        kv = [[(a.to(dt), b.to(dt)) for a, b in zip(ra, rb)]
              for ra, rb in zip(ck, cv)]

    def out(i, j):
        q = qkv[i][j][0]
        k, v = _kv_heads(*kv[i][j], cfg, heads, j)
        if caches is None:
            o = attention_core(q, k, v, causal=True, chunk=cfg.attn_chunk)
        else:
            o = attention_core(q, k, v, causal=True, q_offset=cache_index,
                               chunk=0)
        return torch.einsum("bshk,hkd->bsd", o, ps[i][j]["wo"].to(dt))

    return ents.grid(out), heads < cfg.num_heads


# ---------------------------------------------------------------------------
# Cross-attention (VLM): queries from the text, k and v from patch embeddings
# ---------------------------------------------------------------------------


def init_cross_attention(ini: Initializer, path: str, cfg: ModelConfig,
                         stack=()):
    """The projections, as self-attention's, and the scalar ``gate``,
    zeros: a freshly drawn cross-attention adds nothing."""
    L = ("layers",) * len(stack)
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ini.param(f"{path}/wq", (*stack, d, H, Dh),
                        (*L, None, "heads", None)),
        "wk": ini.param(f"{path}/wk", (*stack, d, KH, Dh),
                        (*L, None, "kv_heads", None)),
        "wv": ini.param(f"{path}/wv", (*stack, d, KH, Dh),
                        (*L, None, "kv_heads", None)),
        "wo": ini.param(f"{path}/wo", (*stack, H, Dh, d),
                        (*L, "heads", None, None),
                        scale=1.0 / math.sqrt(H * Dh)),
        "gate": ini.param(f"{path}/gate", stack, L, init="zeros"),
    }


def cross_attention(p, x, patches, cfg: ModelConfig, *, kv_cache=None):
    """``x`` (B, S, d) attends to ``patches`` (B, P, d), the precomputed
    patch embeddings (the vision frontend is a stub), or, where
    ``kv_cache`` is given (decode), to its k and v (B, P, KH, Dh) over the
    patches, cast to the compute dtype. No mask; queries chunked by
    ``cfg.attn_chunk``. The output is scaled by tanh(gate), the gate in
    the compute dtype."""
    dt = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if kv_cache is not None:
        k, v = kv_cache["k"].to(dt), kv_cache["v"].to(dt)
    else:
        k = torch.einsum("bpd,dhk->bphk", patches, p["wk"].to(dt))
        v = torch.einsum("bpd,dhk->bphk", patches, p["wv"].to(dt))
    out = attention_core(q, k, v, causal=False, chunk=cfg.attn_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out * torch.tanh(p["gate"].to(dt))


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2)
# ---------------------------------------------------------------------------


def init_mla(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    """The MLA projections; ``kv_norm`` is the RMSNorm scale of the latent
    ``c_kv`` (ones, in ``cfg.pdtype``, as the norms' scales are)."""
    L = ("layers",) * len(stack)
    d, H = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": ini.param(f"{path}/wq", (*stack, d, H, dn + dr),
                        (*L, None, "heads", None)),
        "wkv_a": ini.param(f"{path}/wkv_a", (*stack, d, r), (*L, None, None)),
        "wk_rope": ini.param(f"{path}/wk_rope", (*stack, d, dr),
                             (*L, None, None)),
        "kv_norm": ini.param(f"{path}/kv_norm", (*stack, r), (*L, None),
                             init="ones"),
        "wk_b": ini.param(f"{path}/wk_b", (*stack, r, H, dn),
                          (*L, None, "heads", None)),
        "wv_b": ini.param(f"{path}/wv_b", (*stack, r, H, dv),
                          (*L, None, "heads", None)),
        "wo": ini.param(f"{path}/wo", (*stack, H, dv, d),
                        (*L, "heads", None, None),
                        scale=1.0 / math.sqrt(H * dv)),
    }


def _scores(a, b, spec):
    """``torch.einsum(spec, a, b)`` with float32 scores from inputs of the
    compute dtype (the reference's ``preferred_element_type=float32``)."""
    return torch.einsum(spec, wide(a), wide(b))


def mla_attention(p, x, cfg: ModelConfig, *, positions, cache=None,
                  cache_index=None):
    """MLA. Without ``cache`` (prefill) the latent is expanded to per-head
    keys and values. With ``cache`` (decode: the COMPRESSED latent, c_kv
    (B, S_max, r) and k_rope (B, S_max, dr)) the step writes its latent at
    ``cache_index`` in place and attends over the whole cache, positions
    past ``cache_index`` masked: absorbed when ``cfg.mla_absorb`` (queries
    mapped into the latent space, no per-step expansion of K/V), else
    expanded. Returns (out, cache)."""
    dt = cfg.cdtype
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(dt))
    c_kv = rmsnorm({"scale": p["kv_norm"]}, c_kv, cfg.norm_eps)
    k_rope = torch.einsum("bsd,dk->bsk", x, p["wk_rope"].to(dt))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]

    scale = 1.0 / math.sqrt(dn + dr)
    if cache is None:
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(dt))
        v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(dt))
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], -1)
        qf = torch.cat([q_nope, q_rope], -1)
        out = attention_core(qf, k, v, causal=True, chunk=cfg.attn_chunk,
                             scale=scale)
    else:
        cc, cr = cache["c_kv"], cache["k_rope"]
        end = cache_index + S
        if not 0 <= cache_index <= end <= cc.shape[1]:
            raise ValueError(f"cache positions [{cache_index}, {end}) outside "
                             f"a cache of {cc.shape[1]}")
        cc[:, cache_index:end] = c_kv.to(cc.dtype)
        cr[:, cache_index:end] = k_rope.to(cr.dtype)
        ccd, crd = cc.to(dt), cr.to(dt)
        kpos_ok = (torch.arange(cc.shape[1], device=x.device)
                   <= cache_index)[None, None, None, :]
        s_r = _scores(q_rope, crd, "bshk,btk->bhst")
        if cfg.mla_absorb:
            # absorb W_UK into q: q_lat (B,S,H,r); scores = q_lat . c_kv +
            # q_rope . k_rope
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(dt))
            s_n = _scores(q_lat, ccd, "bshr,btr->bhst")
            w = torch.softmax(((s_n + s_r) * scale).masked_fill(
                ~kpos_ok, -1e30), dim=-1)
            ctx = torch.einsum("bhst,btr->bshr", w.to(dt), ccd)
            out = torch.einsum("bshr,rhk->bshk", ctx, p["wv_b"].to(dt))
        else:
            k_nope = torch.einsum("btr,rhk->bthk", ccd, p["wk_b"].to(dt))
            v = torch.einsum("btr,rhk->bthk", ccd, p["wv_b"].to(dt))
            s_n = _scores(q_nope, k_nope, "bshk,bthk->bhst")
            w = torch.softmax(((s_n + s_r) * scale).masked_fill(
                ~kpos_ok, -1e30), dim=-1)
            out = torch.einsum("bhst,bthk->bshk", w.to(dt), v)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(ini: Initializer, path: str, d: int, d_ff: int, stack=()):
    L = ("layers",) * len(stack)
    return {
        "w_gate": ini.param(f"{path}/w_gate", (*stack, d, d_ff),
                            (*L, None, "mlp")),
        "w_up": ini.param(f"{path}/w_up", (*stack, d, d_ff), (*L, None, "mlp")),
        "w_down": ini.param(f"{path}/w_down", (*stack, d_ff, d),
                            (*L, "mlp", None),
                            scale=1.0 / math.sqrt(d_ff)),
    }


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: XLA's expansion forward, and its own derivative
    backward, g * (y * (1 - y)) (``jax/_src/lax/lax.py``). Autograd of the
    expansion would multiply 0 by the infinite exp(-x) where x < -88 (the
    float32 and bfloat16 range), a NaN gradient."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def logistic(x):
    """``jax.nn.sigmoid`` (``lax.logistic``) as the reference computes it:
    1 / (1 + exp(-x)) with every op rounded in x's dtype (XLA's
    expansion), differentiated as ``lax.logistic`` is."""
    return _Logistic.apply(x)


def silu(x):
    """``jax.nn.silu`` as the reference computes it: x * logistic(x), every
    op rounded in x's dtype (``F.silu`` rounds once, 1 bfloat16 ulp apart
    on about a third of the inputs)."""
    return x * logistic(x)


def softplus(x):
    """``jax.nn.softplus`` as the reference computes it,
    ``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)), NaN inputs
    passed through (``F.softplus`` has a threshold of 20 and another
    formula)."""
    return torch.where(torch.isnan(x), x,
                       torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())))


def mlp(p, x, dt):
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", silu(g) * u, p["w_down"].to(dt))
