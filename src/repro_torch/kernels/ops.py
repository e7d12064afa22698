"""Public wrappers around the port's kernels: dispatch by device.

``use_kernel`` replaces the reference's ``use_pallas``/``interpret`` pair
(``repro/kernels/ops.py``):

  None   auto: the CUDA kernel for CUDA tensors, the plain PyTorch version
         for CPU tensors (the only reason the plain version runs);
  False  force the plain version (how the card-side comparison runs it);
  True   force the kernel; raises for CPU tensors.

There is no fallback: a CUDA tensor reaches the kernel or the call raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import FLOAT, INT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sched_violation as _sched_violation_cuda
from repro_torch.kernels import sgs_decode as _sgs_decode_cuda
from repro_torch.kernels import usl_runtime as _usl_runtime_cuda


def _route(x, use_kernel: Optional[bool]) -> bool:
    """True when the call goes to the CUDA kernel; raises for a forced
    kernel on CPU tensors."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the CUDA "
                         f"kernel cannot run on {x.device}")
    return use_kernel


def sgs_decode(dur, dem, prio, release, pred, caps, *, T: int,
               use_kernel: Optional[bool] = None):
    """Batched grid-SGS decode — the solver's hot loop. See
    ``kernels/ref.sgs_decode_ref`` for the semantics (including the
    grouped (G, J) release / (G, J, J) pred form); the kernel is
    bit-identical."""
    if not _route(dur, use_kernel):
        return _ref.sgs_decode_ref(dur, dem, prio, release, pred, caps, T=T)
    release, pred = _ref.as_groups(release, pred)
    return _sgs_decode_cuda.sgs_decode(
        dur.to(INT).contiguous(), dem.to(FLOAT).contiguous(),
        prio.to(FLOAT).contiguous(), release.to(INT).contiguous(),
        pred.contiguous(), caps.to(FLOAT).contiguous(), T=T)


def sched_violation(start, dur, dem, caps, *, T: int,
                    use_kernel: Optional[bool] = None):
    """Batched capacity-violation mass (B,) of candidate schedules. See
    ``kernels/ref.sched_violation_ref`` for the semantics; the kernel is
    bit-identical."""
    if not _route(start, use_kernel):
        return _ref.sched_violation_ref(start, dur, dem, caps, T)
    return _sched_violation_cuda.sched_violation(start, dur, dem, caps, T=T)


def usl_runtime(n, alpha, beta, gamma, work, *,
                use_kernel: Optional[bool] = None):
    """USL runtime (paper Eq. 9) over the broadcast of five tensors. See
    ``kernels/ref.usl_runtime_ref``; the kernel is bit-identical."""
    if not _route(n, use_kernel):
        return _ref.usl_runtime_ref(n, alpha, beta, gamma, work)
    return _usl_runtime_cuda.usl_runtime(n, alpha, beta, gamma, work)


def schedule_objective(start, dur, dem, caps, costs, pred_pairs, goal_w,
                       ref_M, ref_C, *, T: int, lam_cap: float = 50.0,
                       lam_prec: float = 50.0,
                       use_kernel: Optional[bool] = None):
    """Penalized ('Ising-form') energy of a batch of candidate schedules.

    start, dur (B, J) grid units; dem (B, M, J); costs (B,); pred_pairs
    (E, 2) int [pred, succ]; goal_w, ref_M, ref_C float32 scalars (0-d
    tensors on the batch's device). Returns (energy (B,), makespan (B,),
    cap_viol (B,), prec_viol (B,)), as ``repro/kernels/ops.py:
    schedule_objective``."""
    finish = start + dur
    makespan = finish.amax(dim=1)
    viol = sched_violation(start, dur, dem, caps, T=T, use_kernel=use_kernel)
    p, s = pred_pairs[:, 0], pred_pairs[:, 1]
    gap = torch.clamp(finish[:, p] - start[:, s], min=0.0)       # (B, E)
    prec = gap.sum(dim=1)
    energy = (goal_w * (makespan - ref_M) / ref_M
              + (1.0 - goal_w) * (costs - ref_C) / ref_C
              + lam_cap * viol / (ref_M + 1.0)
              + lam_prec * prec / (ref_M + 1.0))
    return energy, makespan, viol, prec
