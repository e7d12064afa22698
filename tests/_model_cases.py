"""The logit tolerances of the port's model tests and of ``chip_smoke.py``'s
model phase (numpy and torch only, so the card-side script imports no jax).

float32: ``F32_ATOL``, the two computations differing only in the order of
float32 sums; at full width and depth (the card against the CPU)
``f32_tolerance``, that much a level over the L + 1 levels. bfloat16: ``bf16_tolerance``. Each of the L blocks rounds its
two sublayer outputs, and the head its input, in bfloat16; two computations
that round at other places (the reference's compiled scan keeps some of
those roundings in float32, the card's matrix products sum in another
order than the CPU's) may part by about two roundings of relative size eps
a level over L + 1 levels, relative to the logits' scale: 2 (L + 1) eps
max|logits|, eps the bfloat16 spacing at 1.
"""
import numpy as np
import torch

F32_ATOL = 1e-4
EPS_BF16 = float(torch.finfo(torch.bfloat16).eps)     # 2 ** -7


def f32_tolerance(num_layers: int) -> float:
    """The float32 tolerance at a depth of ``num_layers`` blocks: ``F32_ATOL``
    a level (each block and the head) over L + 1 levels."""
    return F32_ATOL * (num_layers + 1)


def bf16_tolerance(num_layers: int, ref_logits) -> float:
    ref = ref_logits.float().cpu().numpy() if isinstance(
        ref_logits, torch.Tensor) else np.asarray(ref_logits, np.float32)
    return 2 * (num_layers + 1) * EPS_BF16 * float(np.abs(ref).max())


def tolerance(cfg, ref_logits) -> float:
    """The tolerance of a config's logits: ``F32_ATOL`` in float32, else
    ``bf16_tolerance``."""
    return (F32_ATOL if cfg.dtype == "float32"
            else bf16_tolerance(cfg.num_layers, ref_logits))
