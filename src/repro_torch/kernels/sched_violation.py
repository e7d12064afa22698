"""CUDA capacity-violation mass for Hopper: binding, geometry and launch
counter.

The kernel (``csrc/sched_violation.cu``) replaces the Pallas TPU kernel
``repro/kernels/sched_energy.py:_kernel``; the source says what bounds it
on the card and how the design answers that: each candidate's (M, T) grid
in the registers of W warps, the tasks broadcast by shuffle, no barrier in
the task loop. ``geometry`` picks R, W, C and the layout K from the
shape and the card's SM count. Past the register layout's envelope (M > 8,
or more than 4096 cells) the wide path takes any M and T: one block a
candidate, S passes of 4096 cells, each pass a residue class of the cell
index modulo S, merged in ``pairwise_sum``'s order. ``start``,
``dur`` and ``dem`` are read through their strides, so the ising loop's
transposed ``dem`` view costs no copy. ``kernels/_build.py`` compiles
the kernel at first use; it is called through ``ctypes`` on PyTorch's
current stream. Nothing here builds or imports anything CUDA-specific
when the module is imported.

Same contract as ``kernels/ref.sched_violation_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import FLOAT
from repro_torch.kernels import _build

MAX_CELLS = 4096    # the largest padded grid N = 32 * W * C
MAX_M = 8
MIN_CELLS = 128     # smaller grids pad to 128 cells: C is 4, 8 or 16
MAX_C = 16
MAX_THREADS = 512   # a block's threads, as csrc/sched_violation.cu allows


WIDE = (1, 8, 16)   # the wide path's R, W, C: 4096 cells a pass


def _bind(lib: ctypes.CDLL) -> None:
    lib.sched_violation_launch.argtypes = ([ctypes.c_void_p] * 5
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_longlong] * 7
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    lib.sched_violation_launch.restype = ctypes.c_int
    lib.sched_violation_wide_launch.argtypes = ([ctypes.c_void_p] * 5
                                                + [ctypes.c_int] * 4
                                                + [ctypes.c_longlong] * 8
                                                + [ctypes.c_void_p])
    lib.sched_violation_wide_launch.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load("sched_violation", _bind)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def is_wide(M: int, N: int) -> bool:
    """Whether an (M, T) grid padded to N cells takes the wide path."""
    return M > MAX_M or N > MAX_CELLS


def geometry(B: int, M: int, T: int, sms: int):
    """(R candidates per block, W warps per candidate, C cells per lane, K
    layout, N cells) of a launch over B candidates of an (M, T) grid on a
    card of ``sms`` SMs. N is M * T padded to a power of two, at least 128,
    and 32 * W * C == N: C is 16 where N allows, and W is 1 up to 512
    cells. K is T / (32 W) where that is a power of two (the bin-major
    layout: one interval test a bin serves all M resources), else 0 (the
    general layout, any T). R doubles while every SM still gets a block, to
    at most 512 threads a block. Past the envelope (``is_wide``: M > 8 or
    N > 4096) the wide path's ``WIDE`` geometry, K 0, and N at least 4096:
    it runs N / 4096 passes of 4096 cells."""
    if M < 1 or T < 1:
        raise ValueError(f"sched_violation: an (M {M}, T {T}) grid has no "
                         f"cells; nothing was launched")
    N = max(MIN_CELLS, 1 << (M * T - 1).bit_length())
    if is_wide(M, N):
        return (*WIDE, 0, max(N, MAX_CELLS))
    C = min(MAX_C, N // 32)
    W = N // (32 * C)
    K, rest = divmod(T, 32 * W)
    if rest or K & (K - 1):
        K = 0
    R = 1
    while 64 * R * W <= MAX_THREADS and -(-B // (2 * R)) >= sms:
        R *= 2
    return R, W, C, K, N


def sched_violation(start, dur, dem, caps, *, T: int, geom=None):
    """Launch the CUDA kernel. start, dur (B, J), dem (B, M, J) and caps
    (M,) on one CUDA device, float32 or bfloat16 (cast to float32 here, as
    the JAX wrapper does), any strides -> viol (B,) float32. ``geom`` is
    the launch's (R, W, C, K), ``geometry``'s by default; another choice,
    such as K = 0 where ``geometry`` picks the bin-major layout, computes
    the same result. Counts each launch in ``sched_violation.launches``."""
    device = start.device
    if device.type != "cuda":
        raise ValueError("sched_violation kernel needs CUDA tensors, got "
                         f"{device}")
    # a cast makes a new tensor only for bfloat16; views keep their strides
    start, dur, dem = (x.to(FLOAT) for x in (start, dur, dem))
    caps = caps.to(FLOAT).contiguous()
    for name, x, dim in (("start", start, 2), ("dur", dur, 2),
                         ("dem", dem, 3)):
        if x.device != device or x.dim() != dim:
            raise ValueError(f"sched_violation: {name} must be a {dim}-d "
                             f"tensor on {device}, got shape "
                             f"{tuple(x.shape)} on {x.device}")
    _build.check_tensor("sched_violation", "caps", caps, (FLOAT,), 1, device)
    B, J = start.shape
    M = caps.shape[0]
    if dur.shape != (B, J) or dem.shape != (B, M, J) or T < 1:
        raise ValueError("sched_violation: inconsistent shapes start "
                         f"{tuple(start.shape)} dur {tuple(dur.shape)} dem "
                         f"{tuple(dem.shape)} caps {tuple(caps.shape)} T {T}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    R, W, C, K, N = geometry(B, M, int(T), _sms(index))
    wide = is_wide(M, N)
    if geom is not None:
        if wide:
            raise ValueError("sched_violation: the wide path takes no "
                             "geometry")
        R, W, C, K = geom
    out = torch.empty((B,), dtype=FLOAT, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = (start.data_ptr(), dur.data_ptr(), dem.data_ptr(),
                caps.data_ptr(), out.data_ptr(), B, J, M, int(T),
                *start.stride(), *dur.stride(), *dem.stride())
        if wide:
            rc = lib.sched_violation_wide_launch(*ptrs, N // MAX_CELLS,
                                                 stream)
        else:
            rc = lib.sched_violation_launch(*ptrs, R, W, C, K, stream)
    _build.check_launch("sched_violation", lib, rc)
    _build.count_launch(sched_violation)
    return out


sched_violation.launches = 0
