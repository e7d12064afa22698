"""Chunked gated linear attention (PyTorch port of ``repro/models/gla.py``):
the Mamba2 SSD recurrence (scalar per-head decay) and the RWKV6 "Finch"
recurrence (vector per-channel decay, exclusive current-token bonus).

Recurrence (state S in R^{dk x dv} per head):
    S_t = Diag(exp(g_t)) . S_{t-1} + k_t v_t^T
    inclusive (mamba2):  y_t = q_t . S_t
    exclusive+bonus u (rwkv6):  y_t = q_t . S_{t-1} + (q_t * u * k_t).sum() v_t

Chunking: intra-chunk contributions are dense products, inter-chunk a
Python loop over chunks carrying the state (the reference's ``lax.scan``).
Two intra-chunk strategies:

* scalar decay  -> score[t,s] = (q_t . k_s) * exp(G_t - G_s): one product
  and an outer-difference decay mask. Chunk 128.
* vector decay  -> score[t,s] = sum_d q_td k_sd exp(G_{t',d} - G_{s,d}) with
  t' = t-1 (exclusive), through an explicit (C, C, dk) exponent-difference
  tensor; every exponent is clipped to [-60, 0], so this is
  unconditionally stable. Chunk 16, since the tensor is O(C^2 dk).

All state math is float32, or float64 for a float64 model (``wide``:
float32 is a floor, as in ``layers.py``). The reference's three-operand
einsums are written as an elementwise product followed by a two-operand
``torch.einsum``, in the order stated at each. ``gla_scan_ref`` is the scan
oracle the chunked forms are held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import wide


def _split_chunks(x, c):
    B, S = x.shape[0], x.shape[1]
    assert S % c == 0, (S, c)
    return x.reshape(B, S // c, c, *x.shape[2:])


def _pad_to_chunks(q, k, v, g, c):
    """Pad sequence to a multiple of c. Padding is inert: k=0 adds nothing to
    the state and g=0 (decay exp(0)=1) preserves it."""
    S = q.shape[1]
    pad = (-S) % c
    if pad == 0:
        return q, k, v, g, S

    def padded(x):
        return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)

    return padded(q), padded(k), padded(v), padded(g), S


def _bonus(qf, u, kf):
    """sum_k q u k over the last axis: the reference's three-operand
    ``einsum("...hk,hk,...hk->...h")``, as (q * u) then the sum with k."""
    return (qf * wide(u) * kf).sum(-1)


def _cumsum(x, dim: int):
    """The prefix sums of ``x`` along ``dim`` as the CPU's ``torch.cumsum``
    makes them for float32 (summed in float64, each rounded once), written
    as a product with a triangular matrix of ones in float64: the same on
    the card, and allowed under ``torch.use_deterministic_algorithms``,
    which refuses every floating-point ``torch.cumsum`` on CUDA."""
    n = x.shape[dim]
    ones = torch.ones((n, n), dtype=torch.float64, device=x.device).triu()
    sums = torch.einsum("...c,ct->...t", x.movedim(dim, -1).double(), ones)
    return sums.to(x.dtype).movedim(-1, dim)


def _zero_state(B, H, dk, dv, like):
    return torch.zeros((B, H, dk, dv), dtype=wide(like).dtype,
                       device=like.device)


# ---------------------------------------------------------------------------
# Reference: pure scan (oracle)
# ---------------------------------------------------------------------------


def gla_scan_ref(q, k, v, g, *, inclusive: bool,
                 u: Optional[torch.Tensor] = None,
                 init_state: Optional[torch.Tensor] = None):
    """q,k: (B,S,H,dk), v: (B,S,H,dv), g: (B,S,H) scalar or (B,S,H,dk) vector
    log-decay. Returns (y, final_state) with state (B,H,dk,dv). f32 math."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = (wide(x) for x in (q, k, v))
    gf = wide(g)
    if gf.ndim == 3:
        gf = gf[..., None].expand(B, S, H, dk)  # scalar decay over dk
    state = (_zero_state(B, H, dk, dv, q) if init_state is None
             else wide(init_state))
    ys = []
    for t in range(S):
        y, state = gla_step(state, qf[:, t], kf[:, t], vf[:, t], gf[:, t],
                            inclusive=inclusive, u=u)
        ys.append(y)
    return torch.stack(ys, 1).to(v.dtype), state


# ---------------------------------------------------------------------------
# Chunked, scalar decay (Mamba2 SSD), inclusive
# ---------------------------------------------------------------------------


def gla_chunked_scalar(q, k, v, g, *, chunk: int = 128,
                       init_state: Optional[torch.Tensor] = None):
    """g: (B,S,H) scalar log-decay per head. Inclusive (y_t sees k_t v_t)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    q, k, v, g, S_orig = _pad_to_chunks(q, k, v, wide(g), c)
    S = q.shape[1]
    qc, kc, vc = (_split_chunks(x, c) for x in (q, k, v))       # (B,N,c,H,.)
    G = _cumsum(_split_chunks(g, c), dim=2)                     # (B,N,c,H)
    Gtot = G[:, :, -1]                                          # (B,N,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))

    state = (_zero_state(B, H, dk, dv, q) if init_state is None
             else wide(init_state))
    ys = []
    for n in range(S // c):
        qf, kf, vf = (wide(x[:, n]) for x in (qc, kc, vc))
        Gt, Gtot_t = G[:, n], Gtot[:, n]        # (B,c,H), (B,H)
        # intra: scores[t,s] = (q_t . k_s) exp(G_t - G_s), s <= t
        qk = torch.einsum("bthk,bshk->bhts", qf, kf)
        Gh = Gt.transpose(1, 2)                 # (B,H,c)
        decay = torch.exp(torch.clamp(Gh[:, :, :, None] - Gh[:, :, None, :],
                                      -60.0, 0.0))
        scores = torch.where(mask[None, None], qk * decay, 0.0)
        y = torch.einsum("bhts,bshv->bthv", scores, vf)
        # inter: y_t += (q_t exp(G_t)) . S_prev
        y = y + torch.einsum("bthk,bhkv->bthv",
                             qf * torch.exp(Gt)[..., None], state)
        # state update: S = exp(Gtot) S + sum_s (k_s exp(Gtot - G_s)) v_s^T
        kd = kf * torch.exp(torch.clamp(Gtot_t[:, None] - Gt,
                                        -60.0, 0.0))[..., None]
        state = (state * torch.exp(Gtot_t)[..., None, None]
                 + torch.einsum("bshk,bshv->bhkv", kd, vf))
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S_orig]
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Chunked, vector decay (RWKV6), exclusive + bonus
# ---------------------------------------------------------------------------


def gla_chunked_vector(q, k, v, g, u, *, chunk: int = 16,
                       init_state: Optional[torch.Tensor] = None):
    """g: (B,S,H,dk) per-channel log-decay. Exclusive with bonus u (H,dk)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    q, k, v, g, S_orig = _pad_to_chunks(q, k, v, wide(g), c)
    S = q.shape[1]
    qc, kc, vc = (_split_chunks(x, c) for x in (q, k, v))
    gc = _split_chunks(g, c)                                    # (B,N,c,H,dk)
    G = _cumsum(gc, dim=2)
    Gtot = G[:, :, -1]                                          # (B,N,H,dk)
    Gprev = G - gc                                              # exclusive
    smask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device),
                       diagonal=-1)                             # s < t

    state = (_zero_state(B, H, dk, dv, q) if init_state is None
             else wide(init_state))
    ys = []
    for n in range(S // c):
        qf, kf, vf = (wide(x[:, n]) for x in (qc, kc, vc))
        Gp, Gi, Gtot_t = Gprev[:, n], G[:, n], Gtot[:, n]
        # intra (exact, stable): exponents G_{t-1,d} - G_{s,d} <= 0, s < t
        ed = torch.exp(torch.clamp(Gp[:, :, None] - Gi[:, None, :],
                                   -60.0, 0.0))                 # (B,t,s,H,dk)
        # the reference's einsum("bthk,bshk,btshk->bhts"): q * ed, then
        # contracted with k over dk
        scores = torch.einsum("btshk,bshk->bhts", qf[:, :, None] * ed, kf)
        scores = torch.where(smask[None, None], scores, 0.0)
        y = torch.einsum("bhts,bshv->bthv", scores, vf)
        # bonus (current token)
        y = y + _bonus(qf, u, kf)[..., None] * vf
        # inter: y_t += (q_t exp(G_{t-1})) . S_prev
        y = y + torch.einsum("bthk,bhkv->bthv", qf * torch.exp(Gp), state)
        # state update
        kd = kf * torch.exp(torch.clamp(Gtot_t[:, None] - Gi, -60.0, 0.0))
        state = (state * torch.exp(Gtot_t)[..., None]
                 + torch.einsum("bshk,bshv->bhkv", kd, vf))
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S_orig]
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Single-token decode step
# ---------------------------------------------------------------------------


def gla_step(state, q, k, v, g, *, inclusive: bool,
             u: Optional[torch.Tensor] = None):
    """state: (B,H,dk,dv); q,k: (B,H,dk); v: (B,H,dv); g: (B,H) or (B,H,dk)."""
    qf, kf, vf = (wide(x) for x in (q, k, v))
    gf = wide(g)
    if gf.ndim == 2:
        gf = gf[..., None].expand(kf.shape)
    if inclusive:
        state = (state * torch.exp(gf)[..., None]
                 + kf[..., None] * vf[..., None, :])
        y = torch.einsum("bhk,bhkv->bhv", qf, state)
    else:
        y = torch.einsum("bhk,bhkv->bhv", qf, state)
        if u is not None:
            y = y + _bonus(qf, u, kf)[..., None] * vf
        state = (state * torch.exp(gf)[..., None]
                 + kf[..., None] * vf[..., None, :])
    return y.to(v.dtype), state
