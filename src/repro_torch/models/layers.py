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
    return rms_scale(p["scale"], x, wide(x).square().mean(dim=-1,
                                                            keepdim=True),
                     eps, fast)


def rms_scale(scale, x, var, eps: float, fast: bool = False):
    """``rmsnorm``'s output from the mean square ``var`` of the rows (float32
    or wider), which a caller may have summed over several parts of a row
    (``ssm.mamba2_sharded``'s gated norm)."""
    r = torch.rsqrt(var + eps)
    if fast:
        return x * r.to(x.dtype) * scale.to(x.dtype)
    out = wide(x) * r
    return (out * scale.to(out.dtype)).to(x.dtype)


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
    ang = (positions[..., :, None, None].to(xw.device, xw.dtype)
           * freqs)                                 # (.., S, 1, d/2)
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


def write_parts(caches, rows, ents, layout, cache_index: int) -> None:
    """Write each entry's new cache rows ``rows[i][j]`` (name -> (B, n,
    ...)) at ``cache_index`` into its part ``caches[i][j]`` (the same
    names), laid out as ``layout`` says: "seq" (by position over
    ``model``: only the rank whose positions hold a row writes it), or
    whole ("heads", by head, and None, replicated)."""
    for i in range(ents.D):
        for j in range(ents.M):
            c, new = caches[i][j], rows[i][j]
            n = next(iter(c.values())).shape[1]
            lo = j * n if layout == "seq" else 0
            S_max = n * ents.M if layout == "seq" else n
            end = _cache_range(cache_index, next(iter(new.values())).shape[1],
                               S_max)
            a, b = max(cache_index, lo), min(end, lo + n)
            for name, t in new.items() if a < b else ():
                c[name][:, a - lo:b - lo] = t[
                    :, a - cache_index:b - cache_index].to(c[name].dtype)


def read_parts(caches, ents, layout):
    """Each entry's whole view of its cache parts: a "seq" part (by
    position over ``model``) all-gathered over ``model`` (counted), a part
    by head or replicated as it is. A grid of dicts, name -> tensor."""
    out = {name: [[c[name] for c in row] for row in caches]
           for name in caches[0][0]}
    if layout == "seq":
        out = {name: ents.model_all_gather(g, 1) for name, g in out.items()}
    return ents.grid(lambda i, j: {name: g[i][j] for name, g in out.items()})


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
    positions hold it (``write_parts``); a "seq" cache is all-gathered
    over ``model`` (counted) before the scores (``read_parts``). Returns
    (the grid of outputs, whether they are partial sums over ``model``:
    ``wo`` is row-parallel where q is sharded, and the caller all-reduces
    or reduce-scatters them; where q is replicated each entry's output is
    complete)."""
    dt = cfg.cdtype
    qkv = ents.grid(lambda i, j: _qkv(ps[i][j], hs[i][j], cfg, positions))
    heads = ps[0][0]["wq"].shape[1]
    if caches is None:
        kv = [[(k, v) for _, k, v in row] for row in qkv]
    else:
        write_parts(caches, [[{"k": k, "v": v} for _, k, v in row]
                             for row in qkv], ents, layout, cache_index)
        kv = [[(c["k"].to(dt), c["v"].to(dt)) for c in row]
              for row in read_parts(caches, ents, layout)]

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
    if kv_cache is not None:
        k, v = kv_cache["k"].to(dt), kv_cache["v"].to(dt)
    else:
        k, v = _patch_kv(p, patches, dt)
    return cross_gate(p, _cross_out(p, x, k, v, cfg), cfg)


def _patch_kv(p, patches, dt):
    return (torch.einsum("bpd,dhk->bphk", patches, p["wk"].to(dt)),
            torch.einsum("bpd,dhk->bphk", patches, p["wv"].to(dt)))


def _cross_out(p, x, k, v, cfg: ModelConfig, j: int = 0):
    """The queries of ``x`` by ``p``'s heads over k and v, through ``wo``
    (model rank ``j``'s heads read their kv heads: ``_kv_heads``)."""
    dt = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k, v = _kv_heads(k, v, cfg, q.shape[2], j)
    out = attention_core(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def cross_gate(p, out, cfg: ModelConfig):
    """The cross-attention output scaled by tanh(gate)."""
    return out * torch.tanh(p["gate"].to(cfg.cdtype))


def cross_attention_sharded(ps, hs, patches, cfg: ModelConfig, ents, *,
                            kv_caches=None, layout=None):
    """``cross_attention`` over a (data, model) mesh, before its gate: q
    and ``wo`` by head, k and v by kv head where ``model`` divides
    ``num_kv_heads``, else replicated (each rank reading its query heads'
    kv heads), as ``attention_sharded``. ``hs`` is the grid of entry
    inputs, ``patches`` each data row's patches (B / D, P, d) on its
    entries' device, or with ``kv_caches`` (decode) the grid of each
    entry's part of the group's patch cache, laid out as ``layout`` says
    ("heads", "seq" by patch over ``model``, all-gathered (counted) before
    the scores, or None); decode only reads it. Returns (the grid of
    outputs, whether they are partial sums over ``model``): the caller
    reduces them and only then applies ``cross_gate``, as the reference
    scales the complete output."""
    dt = cfg.cdtype
    if kv_caches is not None:
        full = read_parts(kv_caches, ents, layout)
        kv = ents.grid(lambda i, j: (full[i][j]["k"].to(dt),
                                     full[i][j]["v"].to(dt)))
    else:
        kv = ents.grid(lambda i, j: _patch_kv(
            ps[i][j], patches[i].to(ents.devices[i][j]), dt))
    return (ents.grid(lambda i, j: _cross_out(ps[i][j], hs[i][j], *kv[i][j],
                                              cfg, j)),
            ps[0][0]["wq"].shape[1] < cfg.num_heads)


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


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """MLA's inputs to the scores: the queries of ``p``'s heads (their
    "nope" part, and the rotated "rope" part), the normalized latent
    ``c_kv`` (B, S, r) and the rotated shared ``k_rope`` (B, S, dr)."""
    dt = cfg.cdtype
    dn = cfg.qk_nope_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(dt))
    c_kv = rmsnorm({"scale": p["kv_norm"]}, c_kv, cfg.norm_eps)
    k_rope = torch.einsum("bsd,dk->bsk", x, p["wk_rope"].to(dt))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def _mla_prefill(p, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig):
    """Prefill: the latent expanded to ``p``'s heads' keys and values."""
    dt = cfg.cdtype
    B, S, H = q_nope.shape[:3]
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"].to(dt))
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H,
                                                     cfg.qk_rope_dim)], -1)
    qf = torch.cat([q_nope, q_rope], -1)
    return attention_core(qf, k, v, causal=True, chunk=cfg.attn_chunk,
                          scale=_mla_scale(cfg))


def _mla_decode(p, q_nope, q_rope, cc, cr, cfg: ModelConfig,
                cache_index: int):
    """Decode over the whole compressed cache ``cc`` (B, S_max, r), ``cr``
    (B, S_max, dr), positions past ``cache_index`` masked: absorbed or
    expanded by ``cfg.mla_absorb``, for ``p``'s heads."""
    dt = cfg.cdtype
    scale = _mla_scale(cfg)
    ccd, crd = cc.to(dt), cr.to(dt)
    kpos_ok = (torch.arange(cc.shape[1], device=cc.device)
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
        return torch.einsum("bshr,rhk->bshk", ctx, p["wv_b"].to(dt))
    k_nope = torch.einsum("btr,rhk->bthk", ccd, p["wk_b"].to(dt))
    v = torch.einsum("btr,rhk->bthk", ccd, p["wv_b"].to(dt))
    s_n = _scores(q_nope, k_nope, "bshk,bthk->bhst")
    w = torch.softmax(((s_n + s_r) * scale).masked_fill(
        ~kpos_ok, -1e30), dim=-1)
    return torch.einsum("bhst,bthk->bshk", w.to(dt), v)


def mla_attention(p, x, cfg: ModelConfig, *, positions, cache=None,
                  cache_index=None):
    """MLA. Without ``cache`` (prefill) the latent is expanded to per-head
    keys and values. With ``cache`` (decode: the COMPRESSED latent, c_kv
    (B, S_max, r) and k_rope (B, S_max, dr)) the step writes its latent at
    ``cache_index`` in place and attends over the whole cache, positions
    past ``cache_index`` masked: absorbed when ``cfg.mla_absorb`` (queries
    mapped into the latent space, no per-step expansion of K/V), else
    expanded. Returns (out, cache)."""
    q_nope, q_rope, c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    if cache is None:
        out = _mla_prefill(p, q_nope, q_rope, c_kv, k_rope, cfg)
    else:
        cc, cr = cache["c_kv"], cache["k_rope"]
        end = cache_index + x.shape[1]
        if not 0 <= cache_index <= end <= cc.shape[1]:
            raise ValueError(f"cache positions [{cache_index}, {end}) outside "
                             f"a cache of {cc.shape[1]}")
        cc[:, cache_index:end] = c_kv.to(cc.dtype)
        cr[:, cache_index:end] = k_rope.to(cr.dtype)
        out = _mla_decode(p, q_nope, q_rope, cc, cr, cfg, cache_index)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cfg.cdtype))
    return out, cache


def mla_attention_sharded(ps, hs, cfg: ModelConfig, ents, *, positions,
                          caches=None, layout=None, cache_index=None):
    """MLA over a (data, model) mesh: ``wq``, ``wk_b``, ``wv_b`` and ``wo``
    by head where ``model`` divides ``num_heads`` (else replicated);
    ``wkv_a``, ``wk_rope`` and ``kv_norm`` replicated, so every rank
    computes the same latent ``c_kv`` and ``k_rope``. With ``caches`` (the
    grid of each entry's part of one layer's latent cache: ``layout``
    "seq", by position over ``model``, or None, replicated) a decode step:
    the rank whose positions hold ``cache_index`` writes the token's
    latent (``write_parts``), and a "seq" cache is all-gathered (counted)
    before the scores, absorbed or expanded as ``cfg.mla_absorb`` says.
    Returns (the grid of outputs, whether they are partial sums over
    ``model``: ``wo`` row-parallel where the heads are cut)."""
    lat = ents.grid(lambda i, j: _mla_latent(ps[i][j], hs[i][j], cfg,
                                             positions))
    if caches is None:
        heads = ents.grid(lambda i, j: _mla_prefill(ps[i][j], *lat[i][j],
                                                    cfg))
    else:
        write_parts(caches, [[{"c_kv": c, "k_rope": r} for _, _, c, r in row]
                             for row in lat], ents, layout, cache_index)
        full = read_parts(caches, ents, layout)
        heads = ents.grid(lambda i, j: _mla_decode(
            ps[i][j], *lat[i][j][:2], full[i][j]["c_kv"],
            full[i][j]["k_rope"], cfg, cache_index))
    dt = cfg.cdtype
    return (ents.grid(lambda i, j: torch.einsum(
        "bshk,hkd->bsd", heads[i][j], ps[i][j]["wo"].to(dt))),
        ps[0][0]["wq"].shape[1] < cfg.num_heads)


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
