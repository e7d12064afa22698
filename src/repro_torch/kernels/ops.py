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

from repro_torch.device import FLOAT, INT
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sgs_decode as _sgs_decode_cuda


def sgs_decode(dur, dem, prio, release, pred, caps, *, T: int,
               use_kernel: Optional[bool] = None):
    """Batched grid-SGS decode — the solver's hot loop. See
    ``kernels/ref.sgs_decode_ref`` for the semantics (including the
    grouped (G, J) release / (G, J, J) pred form); the kernel is
    bit-identical."""
    if use_kernel is None:
        use_kernel = dur.is_cuda
    if not use_kernel:
        return _ref.sgs_decode_ref(dur, dem, prio, release, pred, caps, T=T)
    if not dur.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the CUDA "
                         f"kernel cannot run on {dur.device}")
    release, pred = _ref.as_groups(release, pred)
    return _sgs_decode_cuda.sgs_decode(
        dur.to(INT).contiguous(), dem.to(FLOAT).contiguous(),
        prio.to(FLOAT).contiguous(), release.to(INT).contiguous(),
        pred.contiguous(), caps.to(FLOAT).contiguous(), T=T)
