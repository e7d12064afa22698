"""The logit and gradient tolerances of the port's model tests and of
``chip_smoke.py``'s model and training phases (numpy and torch only, so
the card-side script imports no jax).

float32: ``F32_ATOL``, the two computations differing only in the order of
float32 sums; at full width and depth (the card against the CPU)
``f32_tolerance``, that much a level over the L + 1 levels. bfloat16: ``bf16_tolerance``. Each of the L blocks rounds its
two sublayer outputs, and the head its input, in bfloat16; two computations
that round at other places (the reference's compiled scan keeps some of
those roundings in float32, the card's matrix products sum in another
order than the CPU's) may part by about two roundings of relative size eps
a level over L + 1 levels, relative to the logits' scale: 2 (L + 1) eps
max|logits|, eps the bfloat16 spacing at 1. Gradients, float32:
``grad_tolerance`` relative to each leaf's largest, and at full width on
the card ``card_grad_rtol``; the params after a first AdamW step:
``first_step_error``. Each states its reasoning.
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


# Gradients, float32, relative to a leaf's largest |gradient|: a backward
# pass runs through the same L + 1 levels as the forward, once more, and
# its float32 sums come in other orders too (autograd's and XLA's
# transposes, the softmax backward's subtraction of sum(w g), which
# cancels); so twice the forward's F32_ATOL a level, relative, over the
# L + 1 levels. A leaf whose gradient is zero must be zero.
GRAD_RTOL = 2 * F32_ATOL


def grad_tolerance(num_layers: int) -> float:
    """The float32 gradient tolerance at a depth of ``num_layers`` blocks,
    relative to each leaf's largest |gradient|."""
    return GRAD_RTOL * (num_layers + 1)


def grad_error(got, want) -> float:
    """max |got - want| / max |want| of one gradient leaf (numpy arrays or
    torch tensors); 0 where both are zero, inf where only ``want`` is."""
    if (want.numel() if hasattr(want, "numel") else want.size) == 0:
        return 0.0
    scale = float(abs(want).max())
    err = float(abs(got - want).max())
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / scale


def card_grad_rtol(cpu_error: float, num_layers: int) -> float:
    """How far, relative to a leaf's largest |gradient|, the card's float32
    gradient may part from the float64 one at full width: twice the CPU's
    own float32 error against it, or ``grad_tolerance``, whichever is
    larger. At full width float32's rounding in a gradient grows past
    ``grad_tolerance`` on any device (longer sums, saturated softmaxes;
    as the VLM's forward does at d 4096), so the card is
    held to the accuracy the CPU reaches on the same weights and tokens:
    a card that computed another function, or in a narrower type, parts
    by far more."""
    return max(2 * cpu_error, grad_tolerance(num_layers))


def first_step_error(got, want, old, grad, lr: float, rtol: float,
                     eps: float = 1e-8) -> float:
    """The largest ratio, over one parameter leaf's elements, of |got -
    want| (the leaf after one AdamW step from ``old`` on two sides) to the
    bound the gradient rule allows; it holds at <= 1. ``grad`` is the
    gradient one side's step applied to the leaf, after the clip
    (``mu / (1 - b1)`` at step 1), ``lr`` the step's learning rate,
    ``rtol`` how far the two sides' gradients may part, relative to the
    leaf's largest. At step 1 an element moves by lr (u(g) + wd p), u(g) =
    g / (|g| + eps): where two gradients part by at most d = rtol x max
    |grad|, u parts by at most (2 d / |g|) eps / (|g| / 2 + eps) where |g|
    > 2 d (tiny where |g| >> eps), and by up to 2 (the sign) where |g| <=
    2 d, where the two cannot tell the sign; beside it, the roundings of
    the update (1e-6 lr) and of the leaf (2 ulp)."""
    g = np.abs(np.asarray(grad, np.float64))
    d = rtol * (g.max() if g.size else 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.where(g > 2 * d, (2 * d / g) * eps / (g / 2 + eps), 2.0)
    bound = lr * (u + 1e-6) + 2.4e-7 * np.abs(np.asarray(old, np.float64))
    err = np.abs(np.asarray(got, np.float64) - want)
    return float((err / bound).max()) if err.size else 0.0
