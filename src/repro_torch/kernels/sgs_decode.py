"""CUDA serial-SGS decode for Hopper: binding and launch counter.

The kernel (``csrc/sgs_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/sgs_decode.py:_kernel``; the source says what bounds it on
the card and how the design answers that: one warp per chain row, W rows
of one group per block, no block barrier in the step loop. A group whose
precedence and row state do not fit one block's shared memory on that
design, or with J > 2048, goes to the wide path, one block per row
(``sgs_decode_wide_kernel``); the launch picks the path and W itself
(``geometry``) and refuses, with a ``ValueError``, only a shape whose
inputs, outputs and scratch exceed the card's memory.
``kernels/_build.py`` compiles it at first use and loads it; it is called
through ``ctypes`` on PyTorch's current stream. Nothing here builds or
imports anything CUDA-specific when the module is imported.

Same contract as ``kernels/ref.sgs_decode_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import FLOAT, INT
from repro_torch.kernels import _build


def _bind(lib: ctypes.CDLL) -> None:
    lib.sgs_decode_launch.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p] * 2
                                      + [ctypes.POINTER(ctypes.c_int)])
    lib.sgs_decode_launch.restype = ctypes.c_int
    lib.sgs_decode_geometry.argtypes = ([ctypes.c_int] * 5
                                        + [ctypes.POINTER(ctypes.c_int)]
                                        + [ctypes.POINTER(ctypes.c_longlong)]
                                        * 3)
    lib.sgs_decode_geometry.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load("sgs_decode", _bind)


def geometry(rows: int, J: int, M: int, T: int, rows_per_group: int):
    """(route, rows per block W, dynamic shared memory per block, the card's
    limit per block, global scratch bytes) of a launch of this shape on the
    current CUDA device. ``route`` is "fast" (W rows a block), "wide" (one
    row a block, W = 0; shared memory 0 where the row state lives in the
    scratch) or None where the card cannot hold the launch."""
    lib = _library()
    warps, smem, limit, scratch = (ctypes.c_int(), ctypes.c_longlong(),
                                   ctypes.c_longlong(), ctypes.c_longlong())
    rc = lib.sgs_decode_geometry(rows, J, M, T, rows_per_group, warps, smem,
                                 limit, scratch)
    if rc > 0:
        _build.check_launch("sgs_decode", lib, rc)
    route = None if rc else ("fast" if warps.value else "wide")
    return route, warps.value, smem.value, limit.value, scratch.value


def _check(name: str, x: torch.Tensor, dtypes, dim: int, device) -> None:
    _build.check_tensor("sgs_decode", name, x, dtypes, dim, device)


def sgs_decode(dur, dem, prio, release, pred, caps, *, T: int):
    """Launch the CUDA kernel. dur (B, J) int32, dem (B, J, M) f32,
    prio (B, J) f32, release (G, J) int32, pred (G, J, J) bool or uint8,
    caps (M,) f32, all contiguous on one CUDA device; B divisible by G ->
    (start, finish (B, J) int32, ok (B, J) bool). Counts each launch in
    ``sgs_decode.launches``, and those of the wide path also in
    ``sgs_decode.wide_launches``."""
    device = dur.device
    if device.type != "cuda":
        raise ValueError(f"sgs_decode kernel needs CUDA tensors, got {device}")
    _check("dur", dur, (INT,), 2, device)
    _check("dem", dem, (FLOAT,), 3, device)
    _check("prio", prio, (FLOAT,), 2, device)
    _check("release", release, (INT,), 2, device)
    _check("pred", pred, (torch.bool, torch.uint8), 3, device)
    _check("caps", caps, (FLOAT,), 1, device)
    B, J = dur.shape
    G, M = release.shape[0], caps.shape[0]
    if (dem.shape != (B, J, M) or prio.shape != (B, J)
            or release.shape != (G, J) or pred.shape != (G, J, J)):
        raise ValueError("sgs_decode: inconsistent shapes "
                         f"dur {tuple(dur.shape)} dem {tuple(dem.shape)} "
                         f"prio {tuple(prio.shape)} release "
                         f"{tuple(release.shape)} pred {tuple(pred.shape)} "
                         f"caps {tuple(caps.shape)}")
    if G == 0 or B % G:
        raise ValueError(f"sgs_decode: {B} rows do not split into {G} groups")
    start = torch.empty((B, J), dtype=INT, device=device)
    finish = torch.empty((B, J), dtype=INT, device=device)
    ok = torch.empty((B, J), dtype=torch.bool, device=device)
    lib = _library()
    wide = ctypes.c_int()
    with torch.cuda.device(device):
        route, _, _, _, need = geometry(B, J, M, int(T), B // G)
        if route is None:
            raise ValueError(
                f"sgs_decode: {B} rows of J {J}, M {M}, T {T} need more "
                f"than the card's memory for their inputs, outputs and "
                f"{need} bytes of scratch; nothing was launched")
        scratch = (torch.empty(need, dtype=torch.uint8, device=device)
                   if need else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sgs_decode_launch(
            dur.data_ptr(), dem.data_ptr(), prio.data_ptr(),
            release.data_ptr(), pred.data_ptr(), caps.data_ptr(),
            start.data_ptr(), finish.data_ptr(), ok.data_ptr(),
            B, J, M, int(T), B // G,
            None if scratch is None else scratch.data_ptr(), stream, wide)
    _build.check_launch("sgs_decode", lib, rc)
    _build.count_launch(sgs_decode)
    if wide.value:
        _build.count_launch(sgs_decode, "wide_launches")
    return start, finish, ok


sgs_decode.launches = 0
sgs_decode.wide_launches = 0
