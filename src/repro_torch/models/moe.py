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

The reference routes inside a ``shard_map``: each (data, model) entry
routes its data shard's tokens, or under ``cfg.moe_sp_dispatch`` its
model rank's slice of the sequence, with a capacity from its own token
count, and moves the slot buffer to the expert owners with ``all_to_all``
over the ``model`` mesh axis; the load-balance loss is the mean of the
entries' losses. Given the model's run-time mesh (``common.Entries``),
``moe_layer`` does the same, entry by entry (``_moe_sharded``); without
one it runs the local function on the whole batch, which is the
reference's on a (1, 1) mesh.

Shared experts (DeepSeek) are merged into one wider SwiGLU MLP and
computed densely outside this module (``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import TP_AXIS, Initializer, ModelConfig
from repro_torch.models.layers import silu, wide


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
    float32 before renormalisation; float64 in a float64 model). The sort
    is stable, so a tie goes to the lower expert index, as
    ``jax.lax.top_k``'s does."""
    xw = wide(xf)
    logits = torch.einsum("nd,de->ne", xw, router.to(xw.dtype))
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


def _dispatch(router, x, cfg: ModelConfig, cap: int):
    """Route the tokens of ``x`` (B, S, d) and scatter them into the
    ``(E, cap, d)`` slot buffer. Returns (the buffer, the load-balance loss
    of these tokens, what ``_combine`` needs)."""
    E, k, dt = cfg.num_experts, cfg.top_k, cfg.cdtype
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    probs, tope, topw = route(router, xf, cfg)
    topw = (topw / topw.sum(-1, keepdim=True)).to(dt)

    # load-balance aux (Switch): E * sum_e f_e * P_e
    f_e = torch.nn.functional.one_hot(tope, E).to(probs.dtype).sum(1).mean(0)
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
    return buf[:, :cap], aux, (ef, wf, pos, keep, x.shape)


def _experts(p, buf, dt):
    """The experts' SwiGLU over their slots: ``buf`` (E', c, d) against
    ``w_gate``, ``w_up`` (E', d, f) and ``w_down`` (E', f, d)."""
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", silu(g) * u, p["w_down"].to(dt))


def _combine(out, state, cfg: ModelConfig):
    """Each token's kept assignments' outputs, weighted, summed over k."""
    ef, wf, pos, keep, shape = state
    cap = out.shape[1]
    got = torch.where(keep[:, None], out[ef, pos.clamp(max=cap - 1)],
                      0)                                         # (N k, d)
    # the weighted sum over k, accumulated in float32 and rounded once, as
    # jnp.sum accumulates a bfloat16 sum
    d = shape[-1]
    y = wide((got * wf[:, None]).reshape(-1, cfg.top_k, d)).sum(1)
    return y.to(cfg.cdtype).reshape(shape)


def moe_layer(p, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, d). Returns (y (B, S, d), the load-balance loss E sum_e
    f_e P_e, float32). With ``mesh`` (the model's ``common.Entries``),
    ``p`` and ``x`` are grids of each entry's: its block of the experts
    and the tokens it routes; see ``_moe_sharded``."""
    if mesh is not None:
        return _moe_sharded(p, x, cfg, mesh)
    B, S, _ = x.shape
    buf, aux, state = _dispatch(p["router"], x, cfg, capacity(B * S, cfg))
    return _combine(_experts(p, buf, cfg.cdtype), state, cfg), aux


def _moe_sharded(ps, xs, cfg: ModelConfig, ents):
    """The reference's ``local_fn`` on every entry of a (data, model) mesh:
    entry (i, j) routes its tokens ``xs[i][j]`` (Bl, Sl, d): its data
    shard's, or under ``moe_sp_dispatch`` rank j's slice of their
    sequence; its capacity comes from its own Bl Sl tokens, and its slot
    ranks, and so its drops, from its own order. The ``(E, cap, d)``
    buffers go through ``all_to_all`` over ``model`` to the expert owners,
    ``(E / m, m cap, d)``; rank j runs its E / m experts (``ps[i][j]``
    holds their block) and the reverse ``all_to_all`` brings the outputs
    back for the weighted combine. The load-balance loss is averaged over
    the data axes and ``model`` (``pmean``). Returns (the grid of outputs,
    the grid of the averaged loss)."""
    if cfg.num_experts % ents.M:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{ents.M} model ranks")
    dt = cfg.cdtype
    parts = ents.grid(lambda i, j: _dispatch(
        ps[i][j]["router"], xs[i][j], cfg,
        capacity(xs[i][j].shape[0] * xs[i][j].shape[1], cfg)))
    bufs = ents.model_all_to_all([[b for b, _, _ in row] for row in parts],
                                 0, 1)
    outs = ents.model_all_to_all(ents.grid(
        lambda i, j: _experts(ps[i][j], bufs[i][j], dt)), 1, 0)
    axes = ents.dp + ((TP_AXIS,) if TP_AXIS in ents.mesh.axis_names else ())
    aux = ents.pmean([[a for _, a, _ in row] for row in parts], axes)
    return ents.grid(lambda i, j: _combine(outs[i][j], parts[i][j][2],
                                           cfg)), aux
