"""CUDA capacity-violation mass for Hopper: binding and launch counter.

The kernel (``csrc/sched_violation.cu``) replaces the Pallas TPU kernel
``repro/kernels/sched_energy.py:_kernel``; the source says what bounds it
on the card and how the design answers that. ``kernels/_build.py``
compiles it at first use; it is called through ``ctypes`` on PyTorch's
current stream.

Same contract as ``kernels/ref.sched_violation_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import FLOAT
from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("sched_violation")
    lib.sched_violation_launch.argtypes = ([ctypes.c_void_p] * 5
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    lib.sched_violation_launch.restype = ctypes.c_int
    return lib


def sched_violation(start, dur, dem, caps, *, T: int):
    """Launch the CUDA kernel. start, dur (B, J), dem (B, M, J) and caps
    (M,) on one CUDA device, float32 or bfloat16 (cast to float32 here, as
    the JAX wrapper does) -> viol (B,) float32. Counts each
    launch in ``sched_violation.launches``."""
    device = start.device
    if device.type != "cuda":
        raise ValueError("sched_violation kernel needs CUDA tensors, got "
                         f"{device}")
    start, dur, dem, caps = (x.to(FLOAT).contiguous()
                             for x in (start, dur, dem, caps))
    for name, x, dim in (("start", start, 2), ("dur", dur, 2),
                         ("dem", dem, 3), ("caps", caps, 1)):
        _build.check_tensor("sched_violation", name, x, (FLOAT,), dim,
                            device)
    B, J = start.shape
    M = caps.shape[0]
    if dur.shape != (B, J) or dem.shape != (B, M, J) or T < 1:
        raise ValueError("sched_violation: inconsistent shapes start "
                         f"{tuple(start.shape)} dur {tuple(dur.shape)} dem "
                         f"{tuple(dem.shape)} caps {tuple(caps.shape)} T {T}")
    out = torch.empty((B,), dtype=FLOAT, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sched_violation_launch(
            start.data_ptr(), dur.data_ptr(), dem.data_ptr(),
            caps.data_ptr(), out.data_ptr(), B, J, M, int(T), stream)
    _build.check_launch("sched_violation", lib, rc)
    sched_violation.launches += 1
    return out


sched_violation.launches = 0
