"""Mamba2 (SSD) and RWKV6 (Finch) layers (PyTorch port of
``repro/models/ssm.py``), both lowered onto the chunked gated linear
attention of ``gla.py``: the chunked forms for a sequence, ``gla_step``
for one decode token.

Decode state:
  mamba2: {"conv": (B, K-1, conv_dim), "ssm": (B, H, d_state, head_dim)}
  rwkv6:  {"tm_shift": (B, d), "cm_shift": (B, d), "wkv": (B, H, hd, hd)}

The reference's numerics: every matrix cast to ``cfg.cdtype`` at use, the
decay path (``a_log``, ``dt_bias``, ``w0``, ``decay_w1``, ``decay_w2``, the
bonus ``u``) and the norms in float32, ``jnp.var`` the population variance.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import Initializer, ModelConfig
from repro_torch.models.gla import (gla_chunked_scalar, gla_chunked_vector,
                                    gla_step)
from repro_torch.models.layers import logistic, rmsnorm, silu, softplus

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


def mamba2_layer(p, x, cfg: ModelConfig, *, state=None):
    """x: (B, S, d). state for decode (S == 1). Returns (y, new_state)."""
    dt_ = cfg.cdtype
    B, S, d = x.shape
    d_inner, H, conv_dim = mamba2_dims(cfg)
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = torch.einsum("bsd,dp->bsp", x, p["in_proj"].to(dt_))
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), conv_state)
    xbc = silu(xbc)
    xs, Bs, Cs = torch.split(xbc, [d_inner, ds, ds], dim=-1)

    dt = softplus(dt_raw.float() + p["dt_bias"].float())       # (B,S,H)
    A = -torch.exp(p["a_log"].float())                          # (H,)
    g = dt * A[None, None]                                      # log decay

    q = Cs[:, :, None].expand(B, S, H, ds)
    kk = Bs[:, :, None].expand(B, S, H, ds)
    v = (xs.reshape(B, S, H, hd).float() * dt[..., None]).to(dt_)

    if state is None:
        y, new_ssm = gla_chunked_scalar(q, kk, v, g, chunk=cfg.gla_chunk)
    else:
        yt, new_ssm = gla_step(state["ssm"], q[:, 0], kk[:, 0], v[:, 0],
                               g[:, 0], inclusive=True)
        y = yt[:, None]

    y = y + xs.reshape(B, S, H, hd) * p["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    y = rmsnorm({"scale": p["norm"]}, y * silu(z), cfg.norm_eps,
                fast=cfg.fast_norm)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(dt_))
    new_state = None if state is None else {
        "conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}
    return out, new_state


def mamba2_state(cfg: ModelConfig, B: int, device=None):
    d_inner, H, conv_dim = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((B, cfg.conv_kernel - 1, conv_dim),
                            dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((B, H, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


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


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, state=None):
    dt_ = cfg.cdtype
    B, S, d = x.shape
    H, hd = rwkv6_dims(cfg)
    shift = state["tm_shift"] if state is not None else None
    xprev = _token_shift(x, shift)
    dx = xprev - x

    base = x + dx * p["mu_base"].to(dt_)
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", base, p["mix_w1"].to(dt_)))
    lora = lora.reshape(B, S, _STREAMS, _LORA_MIX)
    mixes = p["mu"].to(dt_)[None, None] + torch.einsum(
        "bsnr,nrd->bsnd", lora, p["mix_w2"].to(dt_))
    xr, xk, xv, xw, xg = [x + dx * mixes[:, :, i] for i in range(_STREAMS)]

    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt_)).reshape(B, S, H, hd)
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(dt_)).reshape(B, S, H, hd)
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(dt_)).reshape(B, S, H, hd)
    gate = silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(dt_)))

    # the reference's einsum("bsd,dr,re->bse"): x . decay_w1 first (the
    # order its contraction path takes at every batch and width here)
    lora_w = torch.einsum("bsd,dr->bsr", xw.float(), p["decay_w1"].float())
    w_raw = p["w0"].float()[None, None] + torch.einsum(
        "bsr,re->bse", lora_w, p["decay_w2"].float())
    g = -torch.exp(torch.clamp(w_raw, -20.0, 2.0))    # log decay, (-inf, 0)
    g = torch.clamp(g, -8.0, -1e-4).reshape(B, S, H, hd)  # floor fast decays

    u = p["u"]
    if state is None:
        y, new_wkv = gla_chunked_vector(r, k, v, g, u, chunk=16)
    else:
        yt, new_wkv = gla_step(state["wkv"], r[:, 0], k[:, 0], v[:, 0],
                               g[:, 0], inclusive=False, u=u)
        y = yt[:, None]

    # per-head group norm (jnp.var: the population variance, the mean of
    # the squared deviations)
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    yf = (yf - mean) * torch.rsqrt(var + cfg.norm_eps)
    y = (yf.reshape(B, S, d) * p["ln_scale"].float()).to(dt_)

    out = torch.einsum("bsd,de->bse", y * gate, p["wo"].to(dt_))
    new_state = None
    if state is not None:
        new_state = {"tm_shift": x[:, -1].to(state["tm_shift"].dtype),
                     "wkv": new_wkv}
    return out, new_state


def rwkv6_channel_mix(p, x, cfg: ModelConfig, *, state=None):
    dt_ = cfg.cdtype
    shift = state["cm_shift"] if state is not None else None
    xprev = _token_shift(x, shift)
    dx = xprev - x
    xk = x + dx * p["mu_k"].to(dt_)
    xr = x + dx * p["mu_r"].to(dt_)
    k = torch.einsum("bsd,df->bsf", xk, p["wk"].to(dt_))
    k = torch.relu(k).square()
    v = torch.einsum("bsf,fd->bsd", k, p["wv"].to(dt_))
    r = logistic(torch.einsum("bsd,de->bse", xr, p["wr"].to(dt_)))
    new_state = None if state is None else {
        "cm_shift": x[:, -1].to(state["cm_shift"].dtype)}
    return r * v, new_state


def rwkv6_state(cfg: ModelConfig, B: int, device=None):
    H, hd = rwkv6_dims(cfg)
    return {
        "tm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.cdtype,
                                device=device),
        "cm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.cdtype,
                                device=device),
        "wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=device),
    }
