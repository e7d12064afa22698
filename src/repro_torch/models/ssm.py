"""Mamba2 (SSD) and RWKV6 (Finch) layers (PyTorch port of
``repro/models/ssm.py``), both lowered onto the chunked gated linear
attention of ``gla.py``: the chunked forms for a sequence, ``gla_step``
for one decode token.

Decode state:
  mamba2: {"conv": (B, K-1, conv_dim), "ssm": (B, H, d_state, head_dim)}
  rwkv6:  {"tm_shift": (B, d), "cm_shift": (B, d), "wkv": (B, H, hd, hd)}

The reference's numerics: every matrix cast to ``cfg.cdtype`` at use, the
decay path (``a_log``, ``dt_bias``, ``w0``, ``decay_w1``, ``decay_w2``, the
bonus ``u``), the norms and the recurrent states in float32 (float64 in a
float64 model: ``layers.wide``), ``jnp.var`` the population variance.

``mamba2_sharded``, ``rwkv6_time_mix_sharded`` and
``rwkv6_channel_mix_sharded`` run the layers over a (data, model) mesh
(``common.Entries``), each entry on its blocks of the leaves by the
reference's specs, for ``models/transformer.py:Model._sharded``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import Initializer, ModelConfig
from repro_torch.models.gla import (gla_chunked_scalar, gla_chunked_vector,
                                    gla_step)
from repro_torch.models.layers import (logistic, rms_scale, rmsnorm, silu,
                                       softplus, wide)

# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state  # x, B, C (ngroups=1)
    return d_inner, nheads, conv_dim


def init_mamba2(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    L = ("layers",) * len(stack)
    inner = (*L, "inner")
    d = cfg.d_model
    d_inner, H, conv_dim = mamba2_dims(cfg)
    proj_out = 2 * d_inner + 2 * cfg.ssm_state + H  # z, x, B, C, dt
    return {
        "in_proj": ini.param(f"{path}/in_proj", (*stack, d, proj_out),
                             (*L, None, "inner")),
        "conv_w": ini.param(f"{path}/conv_w", (*stack, cfg.conv_kernel,
                                                conv_dim),
                            (*L, None, "inner"),
                            scale=1.0 / math.sqrt(cfg.conv_kernel)),
        "conv_b": ini.param(f"{path}/conv_b", (*stack, conv_dim), inner,
                            init="zeros"),
        "a_log": ini.param(f"{path}/a_log", (*stack, H), inner, init="zeros"),
        "dt_bias": ini.param(f"{path}/dt_bias", (*stack, H), inner,
                             init="zeros"),
        "d_skip": ini.param(f"{path}/d_skip", (*stack, H), inner, init="ones"),
        "norm": ini.param(f"{path}/norm", (*stack, d_inner), inner,
                          init="ones"),
        "out_proj": ini.param(f"{path}/out_proj", (*stack, d_inner, d),
                              (*L, "inner", None),
                              scale=1.0 / math.sqrt(d_inner)),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, C); w: (K, C) depthwise. state: (B, K-1, C) trailing inputs.
    The K taps are summed in order, each product and sum rounded in x's
    dtype, as the reference's Python ``sum`` does."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b[None, None], new_state


def _ssd(p, xs, Bs, Cs, dt_raw, cfg: ModelConfig, ssm_state=None):
    """The SSD recurrence over the heads of ``p`` (``a_log``, ``dt_bias``,
    ``d_skip``: H' heads): ``xs`` (B, S, H' head_dim) their inputs,
    ``Bs`` and ``Cs`` (B, S, d_state) shared by every head, ``dt_raw`` (B,
    S, H') their steps; with ``ssm_state`` (B, H', d_state, head_dim) one
    decode token. Returns (y (B, S, H' head_dim) with the skip added, the
    new state)."""
    dt_ = cfg.cdtype
    B, S, Hl = dt_raw.shape
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    dt = softplus(wide(dt_raw) + wide(p["dt_bias"]))          # (B,S,H)
    A = -torch.exp(wide(p["a_log"]))                          # (H,)
    g = dt * A[None, None]                                    # log decay

    q = Cs[:, :, None].expand(B, S, Hl, ds)
    kk = Bs[:, :, None].expand(B, S, Hl, ds)
    v = (wide(xs.reshape(B, S, Hl, hd)) * dt[..., None]).to(dt_)

    if ssm_state is None:
        y, new_ssm = gla_chunked_scalar(q, kk, v, g, chunk=cfg.gla_chunk)
    else:
        yt, new_ssm = gla_step(ssm_state, q[:, 0], kk[:, 0], v[:, 0],
                               g[:, 0], inclusive=True)
        y = yt[:, None]

    y = y + xs.reshape(B, S, Hl, hd) * p["d_skip"].to(dt_)[None, None, :,
                                                           None]
    return y.reshape(B, S, Hl * hd), new_ssm


def mamba2_layer(p, x, cfg: ModelConfig, *, state=None):
    """x: (B, S, d). state for decode (S == 1). Returns (y, new_state)."""
    dt_ = cfg.cdtype
    d_inner, H, conv_dim = mamba2_dims(cfg)
    ds = cfg.ssm_state

    zxbcdt = torch.einsum("bsd,dp->bsp", x, p["in_proj"].to(dt_))
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), conv_state)
    xbc = silu(xbc)
    xs, Bs, Cs = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    y, new_ssm = _ssd(p, xs, Bs, Cs, dt_raw, cfg,
                      None if state is None else state["ssm"])
    y = rmsnorm({"scale": p["norm"]}, y * silu(z), cfg.norm_eps,
                fast=cfg.fast_norm)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(dt_))
    new_state = None if state is None else {
        "conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}
    return out, new_state


def _block_of(n: int, full: int, j: int) -> int:
    """The first index of model rank ``j``'s block of ``n`` of ``full``
    entries (0 where the leaf is whole)."""
    return j * n if n < full else 0


def mamba2_sharded(ps, hs, cfg: ModelConfig, ents, *, states=None):
    """``mamba2_layer`` over a (data, model) mesh, the reference's function
    under its "inner" specs. ``in_proj``'s columns, the concatenation [z,
    x, B, C, dt], are cut into ``model`` contiguous blocks that do not
    follow that split, and ``conv_w``, ``conv_b`` (and the conv state's
    channels) into blocks of [x, B, C]; ``a_log``, ``dt_bias``, ``d_skip``
    and the SSM state go by head, ``norm`` and ``out_proj``'s rows by
    channel of ``d_inner`` (each where ``model`` divides the dimension,
    else whole). The layout:

    1. each rank projects its ``in_proj`` columns; the projections are
       all-gathered over ``model`` (counted);
    2. each rank runs the depthwise conv (and its silu) on its own conv
       channels, with its own part of the conv state; the outputs are
       all-gathered (counted);
    3. each rank takes its heads' x, z and dt and the whole of B and C,
       and runs the SSD recurrence (``_ssd``: ``gla_chunked_scalar``, or
       ``gla_step`` at decode) on its heads, from its heads' SSM state;
    4. the gated RMSNorm normalizes over the whole ``d_inner``: each rank
       sums its channels' squares, and the sums are all-reduced over
       ``model`` (counted; in a fixed order);
    5. ``out_proj`` is row-parallel, so the outputs are partial sums.

    ``hs`` is the grid of entry inputs (each its data shard's whole
    sequence), ``states`` the grid of each entry's part of the layer's
    {"conv", "ssm"} state (decode). Returns (the grid of outputs, whether
    they are partial sums over ``model``, the grid of new states or
    None)."""
    dt_ = cfg.cdtype
    d_inner, H, conv_dim = mamba2_dims(cfg)
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    width = 2 * d_inner + 2 * ds + H

    Z = ents.grid(lambda i, j: torch.einsum(
        "bsd,dp->bsp", hs[i][j], ps[i][j]["in_proj"].to(dt_)))
    if Z[0][0].shape[-1] < width:
        Z = ents.model_all_gather(Z, -1)

    def conv(i, j):
        p = ps[i][j]
        cw = p["conv_w"].shape[-1]
        lo = _block_of(cw, conv_dim, j)
        xbc = Z[i][j][..., d_inner + lo:d_inner + lo + cw]
        st = None if states is None else states[i][j]["conv"]
        if st is not None and st.shape[-1] > cw:
            st = st[..., lo:lo + cw]
        out, new = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_),
                                st)
        return silu(out), new

    C = ents.grid(conv)
    XBC = [[c for c, _ in row] for row in C]
    if XBC[0][0].shape[-1] < conv_dim:
        XBC = ents.model_all_gather(XBC, -1)
    new_conv = None
    if states is not None:
        new_conv = [[n for _, n in row] for row in C]
        if new_conv[0][0].shape[-1] < states[0][0]["conv"].shape[-1]:
            new_conv = ents.model_all_gather(new_conv, -1)

    def heads(i, j):
        p = ps[i][j]
        Hl = p["a_log"].shape[0]
        h0 = _block_of(Hl, H, j)
        z, _, dt_raw = torch.split(Z[i][j], [d_inner, conv_dim, H], dim=-1)
        xs, Bs, Cs = torch.split(XBC[i][j], [d_inner, ds, ds], dim=-1)
        cols = slice(h0 * hd, (h0 + Hl) * hd)
        y, new = _ssd(p, xs[..., cols], Bs, Cs, dt_raw[..., h0:h0 + Hl], cfg,
                      None if states is None else states[i][j]["ssm"])
        yz = y * silu(z[..., cols])
        return yz, wide(yz).square().sum(-1, keepdim=True), new

    Y = ents.grid(heads)
    sq = [[s for _, s, _ in row] for row in Y]
    if ps[0][0]["a_log"].shape[0] < H:
        sq = ents.model_all_reduce(sq)

    def out(i, j):
        p = ps[i][j]
        yz = Y[i][j][0]
        nr = p["norm"].shape[0]
        if yz.shape[-1] != nr:        # every head here, the norm's rows cut
            n0 = _block_of(nr, d_inner, j)
            yz = yz[..., n0:n0 + nr]
        y = rms_scale(p["norm"], yz, sq[i][j] / d_inner, cfg.norm_eps,
                      cfg.fast_norm)
        return torch.einsum("bsi,id->bsd", y, p["out_proj"].to(dt_))

    new_states = None if states is None else ents.grid(lambda i, j: {
        "conv": new_conv[i][j].to(states[i][j]["conv"].dtype),
        "ssm": Y[i][j][2]})
    return (ents.grid(out), ps[0][0]["out_proj"].shape[0] < d_inner,
            new_states)


def mamba2_state(cfg: ModelConfig, B: int, device=None):
    d_inner, H, conv_dim = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((B, cfg.conv_kernel - 1, conv_dim),
                            dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((B, H, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=state_dtype(cfg), device=device),
    }


def state_dtype(cfg: ModelConfig) -> torch.dtype:
    """The recurrent states' dtype: float32, or float64 for a float64
    model (``wide``)."""
    return torch.float64 if cfg.cdtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

_STREAMS = 5  # r, k, v, w, g
_LORA_MIX = 32
_LORA_DECAY = 64


def rwkv6_dims(cfg: ModelConfig):
    hd = cfg.ssm_head_dim
    H = cfg.d_model // hd
    return H, hd


def init_rwkv6_tm(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    d = cfg.d_model
    H, hd = rwkv6_dims(cfg)
    n, rm, rd = _STREAMS, _LORA_MIX, _LORA_DECAY
    L = ("layers",) * len(stack)
    vec, mat, into = (*L, None), (*L, None, None), (*L, None, "inner")
    return {
        "mu_base": ini.param(f"{path}/mu_base", (*stack, d), vec,
                             init="uniform", scale=0.5),
        "mu": ini.param(f"{path}/mu", (*stack, n, d), mat, init="uniform",
                        scale=0.5),
        "mix_w1": ini.param(f"{path}/mix_w1", (*stack, d, n * rm), mat,
                            scale=0.02),
        "mix_w2": ini.param(f"{path}/mix_w2", (*stack, n, rm, d),
                            (*L, None, None, None), scale=0.02),
        "wr": ini.param(f"{path}/wr", (*stack, d, d), into),
        "wk": ini.param(f"{path}/wk", (*stack, d, d), into),
        "wv": ini.param(f"{path}/wv", (*stack, d, d), into),
        "wg": ini.param(f"{path}/wg", (*stack, d, d), into),
        "w0": ini.param(f"{path}/w0", (*stack, d), vec, init="uniform",
                        scale=1.0, dtype=cfg.pdtype),
        "decay_w1": ini.param(f"{path}/decay_w1", (*stack, d, rd), mat,
                              scale=0.02, dtype=cfg.pdtype),
        "decay_w2": ini.param(f"{path}/decay_w2", (*stack, rd, d), mat,
                              scale=0.02, dtype=cfg.pdtype),
        "u": ini.param(f"{path}/u", (*stack, H, hd), (*L, "inner", None),
                       init="uniform", scale=0.5, dtype=cfg.pdtype),
        "ln_scale": ini.param(f"{path}/ln_scale", (*stack, d), vec,
                              init="ones"),
        "wo": ini.param(f"{path}/wo", (*stack, d, d), (*L, "inner", None),
                        scale=1.0 / math.sqrt(d)),
    }


def init_rwkv6_cm(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    d, f = cfg.d_model, cfg.d_ff
    L = ("layers",) * len(stack)
    return {
        "mu_k": ini.param(f"{path}/mu_k", (*stack, d), (*L, None),
                          init="uniform", scale=0.5),
        "mu_r": ini.param(f"{path}/mu_r", (*stack, d), (*L, None),
                          init="uniform", scale=0.5),
        "wk": ini.param(f"{path}/wk", (*stack, d, f), (*L, None, "mlp")),
        "wv": ini.param(f"{path}/wv", (*stack, f, d), (*L, "mlp", None),
                        scale=1.0 / math.sqrt(f)),
        "wr": ini.param(f"{path}/wr", (*stack, d, d), (*L, None, None)),
    }


def _token_shift(x, shift_state):
    """prev-token stream: (B,S,d) -> (B,S,d); shift_state (B,d) or None."""
    if x.shape[1] == 1 and shift_state is not None:
        return shift_state[:, None].to(x.dtype)
    prev = torch.cat([x.new_zeros((x.shape[0], 1, x.shape[2])), x[:, :-1]],
                     dim=1)
    if shift_state is not None:
        prev[:, 0] = shift_state.to(x.dtype)
    return prev


def _rwkv6_streams(p, x, cfg: ModelConfig, shift):
    """The time mix's five token-shifted streams (r, k, v, w, g), full
    width: the mixes and their LoRA read replicated leaves only."""
    dt_ = cfg.cdtype
    B, S, d = x.shape
    dx = _token_shift(x, shift) - x

    base = x + dx * p["mu_base"].to(dt_)
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", base, p["mix_w1"].to(dt_)))
    lora = lora.reshape(B, S, _STREAMS, _LORA_MIX)
    mixes = p["mu"].to(dt_)[None, None] + torch.einsum(
        "bsnr,nrd->bsnd", lora, p["mix_w2"].to(dt_))
    return [x + dx * mixes[:, :, i] for i in range(_STREAMS)]


def _rwkv6_proj(p, streams, cfg: ModelConfig, lo: int):
    """r, k, v, the silu gate and the log decay g (float32 or wider) of the
    columns ``lo``.. of ``p``'s ``wr``, ``wk``, ``wv`` and ``wg`` (the
    whole width, or a model rank's block): each (B, S, columns)."""
    dt_ = cfg.cdtype
    xr, xk, xv, xw, xg = streams
    n = p["wr"].shape[1]
    r, k, v = (torch.einsum("bsd,de->bse", x, p[w].to(dt_))
               for x, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    gate = silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(dt_)))

    # the reference's einsum("bsd,dr,re->bse"): x . decay_w1 first (the
    # order its contraction path takes at every batch and width here)
    xw = wide(xw)
    wt = xw.dtype
    lora_w = torch.einsum("bsd,dr->bsr", xw, p["decay_w1"].to(wt))
    w_raw = p["w0"][lo:lo + n].to(wt)[None, None] + torch.einsum(
        "bsr,re->bse", lora_w, p["decay_w2"][:, lo:lo + n].to(wt))
    g = -torch.exp(torch.clamp(w_raw, -20.0, 2.0))    # log decay, (-inf, 0)
    g = torch.clamp(g, -8.0, -1e-4)                   # floor fast decays
    return r, k, v, gate, g


def _rwkv6_wkv(p, r, k, v, g, cfg: ModelConfig, lo: int, wkv=None):
    """The wkv recurrence and the per-head group norm of the whole heads
    whose columns (from ``lo``) r, k, v and g hold, with ``p["u"]`` their
    bonus (H', hd); with ``wkv`` (B, H', hd, hd) one decode token.
    Returns (y (B, S, columns) in the compute dtype, the new wkv state)."""
    B, S, n = r.shape
    hd = cfg.ssm_head_dim
    r, k, v, g = (t.reshape(B, S, n // hd, hd) for t in (r, k, v, g))
    u = p["u"]
    if wkv is None:
        y, new_wkv = gla_chunked_vector(r, k, v, g, u, chunk=16)
    else:
        yt, new_wkv = gla_step(wkv, r[:, 0], k[:, 0], v[:, 0], g[:, 0],
                               inclusive=False, u=u)
        y = yt[:, None]

    # per-head group norm (jnp.var: the population variance, the mean of
    # the squared deviations)
    yf = wide(y)
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    yf = (yf - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (yf.reshape(B, S, n) * wide(p["ln_scale"][lo:lo + n])).to(
        cfg.cdtype), new_wkv


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, state=None):
    shift = state["tm_shift"] if state is not None else None
    streams = _rwkv6_streams(p, x, cfg, shift)
    r, k, v, gate, g = _rwkv6_proj(p, streams, cfg, 0)
    y, new_wkv = _rwkv6_wkv(p, r, k, v, g, cfg, 0,
                            None if state is None else state["wkv"])
    out = torch.einsum("bsd,de->bse", y * gate, p["wo"].to(cfg.cdtype))
    new_state = None
    if state is not None:
        new_state = {"tm_shift": x[:, -1].to(state["tm_shift"].dtype),
                     "wkv": new_wkv}
    return out, new_state


def rwkv6_time_mix_sharded(ps, hs, cfg: ModelConfig, ents, *, states=None):
    """``rwkv6_time_mix`` over a (data, model) mesh: ``wr``, ``wk``, ``wv``
    and ``wg`` by column (the "inner" heads x head_dim), ``u`` by head,
    ``wo`` by row, each where ``model`` divides the dimension; the mixes,
    the decay LoRA (``decay_w1``, ``decay_w2``, ``w0``) and ``ln_scale``
    replicated, each rank taking its heads' columns of their full-width
    results. The group norm is per head, so it stays on the rank. Where a
    rank's column block is not whole heads (``model`` divides d but not
    the heads; ``u`` then replicated), r, k, v, the gate and the decay
    are all-gathered (counted) and every rank runs every head, then takes
    its columns for ``wo``. ``states`` is the grid of each entry's part
    of {"tm_shift", "wkv"} (decode): the wkv state is replicated over
    ``model`` (``Model.cache_specs``), so each rank advances its heads'
    slice and the new states are all-gathered over ``model`` (counted).
    Returns (the grid of outputs, whether they are partial sums over
    ``model``, the grid of new states or None)."""
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    p0 = ps[0][0]
    n = p0["wr"].shape[1]
    whole_heads = p0["u"].shape[0] * hd == n
    streams = ents.grid(lambda i, j: _rwkv6_streams(
        ps[i][j], hs[i][j], cfg,
        None if states is None else states[i][j]["tm_shift"]))
    proj = ents.grid(lambda i, j: _rwkv6_proj(ps[i][j], streams[i][j], cfg,
                                              _block_of(n, d, j)))
    if not whole_heads:
        parts = [ents.model_all_gather([[row[j][t] for j in range(ents.M)]
                                        for row in proj], -1)
                 for t in range(5)]
        proj = ents.grid(lambda i, j: tuple(x[i][j] for x in parts))

    def heads(i, j):
        r, k, v, gate, g = proj[i][j]
        lo = _block_of(n, d, j) if whole_heads else 0
        wkv = None
        if states is not None:
            wkv = states[i][j]["wkv"]
            if whole_heads and n < d:
                wkv = wkv[:, lo // hd:(lo + n) // hd]
        y, new = _rwkv6_wkv(ps[i][j], r, k, v, g, cfg, lo, wkv)
        yg = y * gate
        if not whole_heads:
            yg = yg[..., j * n:(j + 1) * n]
        return torch.einsum("bsd,de->bse", yg, ps[i][j]["wo"].to(cfg.cdtype)
                            ), new

    Y = ents.grid(heads)
    new_states = None
    if states is not None:
        wkv = [[new for _, new in row] for row in Y]
        if wkv[0][0].shape[1] < states[0][0]["wkv"].shape[1]:
            wkv = ents.model_all_gather(wkv, 1)
        new_states = ents.grid(lambda i, j: {
            "tm_shift": hs[i][j][:, -1].to(states[i][j]["tm_shift"].dtype),
            "wkv": wkv[i][j]})
    return ([[y for y, _ in row] for row in Y], p0["wo"].shape[0] < d,
            new_states)


def _rwkv6_cm(p, x, cfg: ModelConfig, shift):
    """The channel mix's value (through ``p``'s columns of ``wk`` and rows
    of ``wv``: the whole, or a model rank's partial sums) and its
    receptance."""
    dt_ = cfg.cdtype
    dx = _token_shift(x, shift) - x
    xk = x + dx * p["mu_k"].to(dt_)
    xr = x + dx * p["mu_r"].to(dt_)
    k = torch.einsum("bsd,df->bsf", xk, p["wk"].to(dt_))
    k = torch.relu(k).square()
    v = torch.einsum("bsf,fd->bsd", k, p["wv"].to(dt_))
    r = logistic(torch.einsum("bsd,de->bse", xr, p["wr"].to(dt_)))
    return v, r


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, state=None):
    shift = state["cm_shift"] if state is not None else None
    v, r = _rwkv6_cm(p, x, cfg, shift)
    new_state = None if state is None else {
        "cm_shift": x[:, -1].to(state["cm_shift"].dtype)}
    return r * v, new_state


def rwkv6_channel_mix_sharded(ps, hs, cfg: ModelConfig, ents, *,
                              states=None):
    """``rwkv6_channel_mix`` over a (data, model) mesh: ``wk`` by column and
    ``wv`` by row where ``model`` divides ``d_ff``, ``wr`` replicated.
    Returns (the grid of values, whether they are partial sums over
    ``model``, the grid of receptances, the grid of new states or None):
    the caller reduces the values and only then multiplies by the
    receptance, as the reference gates the complete value."""
    out = ents.grid(lambda i, j: _rwkv6_cm(
        ps[i][j], hs[i][j], cfg,
        None if states is None else states[i][j]["cm_shift"]))
    new_states = None if states is None else ents.grid(lambda i, j: {
        "cm_shift": hs[i][j][:, -1].to(states[i][j]["cm_shift"].dtype)})
    return ([[v for v, _ in row] for row in out],
            ps[0][0]["wv"].shape[0] < cfg.d_ff,
            [[r for _, r in row] for row in out], new_states)


def rwkv6_state(cfg: ModelConfig, B: int, device=None):
    H, hd = rwkv6_dims(cfg)
    return {
        "tm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.cdtype,
                                device=device),
        "cm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.cdtype,
                                device=device),
        "wkv": torch.zeros((B, H, hd, hd), dtype=state_dtype(cfg),
                           device=device),
    }
