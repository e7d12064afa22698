"""AdamW with global-norm clipping, a warmup-cosine schedule and int8
gradient compression with error feedback (PyTorch port of
``repro/optim/adamw.py``).

The reference's arithmetic, op for op, not ``torch.optim.AdamW``'s: the
clip scale min(1, clip_norm / max(gnorm, 1e-12)) from the float32 global
norm taken before clipping; the step counted from 1; bias correction
dividing the moments (``mhat``, ``nhat``), ``eps`` added to sqrt(nhat);
weight decay ``wd * p`` inside the update, scaled by the learning rate, on
every leaf. The parameters, moments and step live on the parameters'
device and are updated in place under ``torch.no_grad()``; the step is a
device tensor, so ``update`` never waits for the device. The per-leaf work
runs as ``torch._foreach_*`` ops, each one rounding of the reference's
expression (no fused multiply-add). A scalar divisor is a tensor on the
operands' device: CUDA divides by a host scalar as a multiply by its
reciprocal, which rounds otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_compress: bool = False     # int8 + error feedback on the DP reduce


class OptState(NamedTuple):
    step: torch.Tensor               # int32, 0-d, on the parameters' device
    mu: Any
    nu: Any
    err: Any                         # error-feedback residuals (or 0-d leaves)


def init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments of the parameters' shapes and dtypes; ``err`` zeros of
    the same unless ``grad_compress``, else one 0-d zero a leaf."""
    def zeros():
        return map_tree(lambda p: torch.zeros_like(p, requires_grad=False),
                        params)
    err = zeros() if cfg.grad_compress else map_tree(
        lambda p: torch.zeros((), dtype=p.dtype, device=p.device), params)
    device = leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    zeros(), zeros(), err)


def _div(x, d: float):
    """``x / d`` with the divisor a tensor on ``x``'s device (true
    division on every device)."""
    return x / torch.full_like(x, d)


def schedule(step, cfg: AdamWConfig):
    """The learning rate at ``step`` (0-d int tensor): linear warmup times
    cosine decay to ``min_lr_frac``."""
    s = step.float()
    warm = torch.clamp(_div(s, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(_div(s - cfg.warmup_steps,
                            max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares."""
    return torch.stack([x.float().square().sum()
                        for x in leaves(tree)]).sum().sqrt()


def compress_int8(g, err):
    """Symmetric int8 quantization with error feedback: returns (q, scale,
    new_err). The caller all-reduces q (8x fewer bytes) and rescales."""
    g = g + err
    scale = _div(torch.clamp(g.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g - deq


@torch.no_grad()
def update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step. ``params`` (a tree of tensors, the model's own) and
    the state's moments are updated in place; returns (params, the new
    state, {"grad_norm": the norm before clipping, "lr"}), device
    tensors."""
    ps, mus, nus = leaves(params), leaves(state.mu), leaves(state.nu)
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    g = torch._foreach_mul([x.float() for x in leaves(grads)], scale)

    step = state.step + 1
    lr = schedule(step, cfg)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    torch._foreach_mul_(mus, cfg.b1)
    torch._foreach_add_(mus, torch._foreach_mul(g, 1.0 - cfg.b1))
    torch._foreach_mul_(nus, cfg.b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(g, g),
                                                1.0 - cfg.b2))
    del g
    den = torch._foreach_div(nus, b2c)             # nhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(mus, b1c)           # mhat
    torch._foreach_div_(delta, den)
    del den
    pf = [p.float() for p in ps]
    torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    for p, new in zip(ps, torch._foreach_sub(pf, delta)):
        p.copy_(new)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
