"""Mixture-of-Experts layer on one device (PyTorch port of
``repro/models/moe.py``).

Token routing, capacity-bounded scatter into per-expert slots, batched
expert SwiGLU and weighted combine, with the reference's numerics: router
logits, softmax and top-k in float32, the renormalised top-k weights cast
to ``cfg.cdtype``; an assignment whose rank within its expert (in
token-major ``(n, k)`` order) reaches the capacity is dropped, and its
token keeps only the residual (GShard/Switch semantics).

The expert products run over the reference's whole ``(E, cap, d)`` slot
buffer, every expert's weights included, as three batched products: a row's
result is the same whichever experts the buffer holds, so this gives the
reference's numbers, and a decode step reads every expert's weights
whether a token was routed to it or not.

The reference routes inside a ``shard_map`` and moves the slot buffer to
the expert owners with ``all_to_all`` over the ``model`` mesh axis. With
one device there is no model axis, and both reduce to the local function
ported here; ``cfg.moe_sp_dispatch`` (routing a sequence-sharded slice per
model rank) needs that axis too and is inert.

Shared experts (DeepSeek) are merged into one wider SwiGLU MLP and
computed densely outside this module (``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import Initializer, ModelConfig
from repro_torch.models.layers import silu


def init_moe(ini: Initializer, path: str, cfg: ModelConfig, stack=()):
    """The router (d, E), kept in ``cfg.pdtype`` because routing runs in
    float32, and the experts' ``w_gate``, ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), with a leading ``stack`` of layers."""
    L = ("layers",) * len(stack)
    experts = (*L, "experts", None, None)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    return {
        "router": ini.param(f"{path}/router", (*stack, d, E), (*L, None, None),
                            scale=0.02, dtype=cfg.pdtype),
        "w_gate": ini.param(f"{path}/w_gate", (*stack, E, d, f), experts),
        "w_up": ini.param(f"{path}/w_up", (*stack, E, d, f), experts),
        "w_down": ini.param(f"{path}/w_down", (*stack, E, f, d), experts,
                            scale=1.0 / math.sqrt(f)),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: ceil(N k
    capacity_factor / E), at least 1, rounded up to a multiple of 4."""
    c = max(int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                          / cfg.num_experts)), 1)
    return (c + 3) // 4 * 4


def route(router, xf, cfg: ModelConfig):
    """Router of the (N, d) tokens ``xf``: (probs (N, E) float32, top-k
    experts (N, k) in descending probability, their weights (N, k) in
    float32 before renormalisation). The sort is stable, so a tie goes to
    the lower expert index, as ``jax.lax.top_k``'s does."""
    logits = torch.einsum("nd,de->ne", xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, tope[:, :cfg.top_k], topw[:, :cfg.top_k]


def slots(tope, num_experts: int, cap: int):
    """Each assignment's rank within its expert, counted over the flattened
    token-major (N k,) order, and whether it is kept (rank < ``cap``)."""
    ef = tope.reshape(-1)
    onehot = torch.nn.functional.one_hot(ef, num_experts)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    return pos, pos < cap


def moe_layer(p, x, cfg: ModelConfig):
    """x: (B, S, d). Returns (y (B, S, d), the load-balance loss E sum_e
    f_e P_e, float32)."""
    E, k, dt = cfg.num_experts, cfg.top_k, cfg.cdtype
    B, S, d = x.shape
    N = B * S
    cap = capacity(N, cfg)
    xf = x.reshape(N, d)
    probs, tope, topw = route(p["router"], xf, cfg)
    topw = (topw / topw.sum(-1, keepdim=True)).to(dt)

    # load-balance aux (Switch): E * sum_e f_e * P_e
    f_e = torch.nn.functional.one_hot(tope, E).float().sum(1).mean(0)
    aux = E * (f_e * probs.mean(0)).sum()

    ef, wf = tope.reshape(-1), topw.reshape(-1)
    pos, keep = slots(tope, E, cap)
    dest = torch.where(keep, pos, cap)          # slot ``cap``: dropped
    xrep = xf.to(dt).repeat_interleave(k, dim=0)
    # one spare slot takes the dropped assignments, so the scatter needs no
    # count of the kept ones (no wait for the device); it is cut off before
    # the products
    buf = torch.zeros((E, cap + 1, d), dtype=dt, device=x.device)
    buf[ef, dest] = xrep
    buf = buf[:, :cap]

    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    out = torch.einsum("ecf,efd->ecd", silu(g) * u, p["w_down"].to(dt))

    got = torch.where(keep[:, None], out[ef, pos.clamp(max=cap - 1)],
                      0)                                         # (N k, d)
    # the weighted sum over k, accumulated in float32 and rounded once, as
    # jnp.sum accumulates a bfloat16 sum
    y = (got * wf[:, None]).reshape(N, k, d).float().sum(1).to(dt)
    return y.reshape(B, S, d), aux
