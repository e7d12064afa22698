"""CUDA serial-SGS decode for Hopper: binding and launch counters.

The kernel (``csrc/sgs_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/sgs_decode.py:_kernel``; the source says what bounds it on
the card and how the design answers that: one warp per chain row, W rows
of one group per block, no block barrier in the step loop. A shape takes
one of three routes (``geometry``):

  "fast"        the group's precedence and W rows' state in one block's
                shared memory (J up to about 1190 at M 2, T 256):
                ``sgs_decode_kernel``;
  "wide"        past that, for J <= 2048: one warp a row as well, the
                group's successor bitmask built once a launch in global
                scratch, the step reshaped for a long row
                (``sgs_decode_wide_kernel``);
  "wide-block"  J > 2048, or a row's state past a block's shared memory:
                one block of 128 threads a row
                (``sgs_decode_wide_block_kernel``).

The launch refuses, with a ``ValueError``, only a shape whose inputs,
outputs and scratch exceed the card's memory. ``kernels/_build.py``
compiles it at first use and loads it; it is called through ``ctypes`` on
PyTorch's current stream. The geometry of a shape is read from the card
once per device and cached, so a launch makes no query of the card.
Nothing here builds or imports anything CUDA-specific when the module is
imported.

Same contract as ``kernels/ref.sgs_decode_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import FLOAT, INT
from repro_torch.kernels import _build

ROUTES = ("fast", "wide", "wide-block")

# (device, rows, J, M, T, rows per group, asked route) -> geometry(...)
_geometries: Dict[Tuple, Tuple] = {}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sgs_decode_launch.argtypes = ([ptr] * 9 + [i32] * 7 + [i64]
                                      + [ptr] * 2)
    lib.sgs_decode_launch.restype = i32
    lib.sgs_decode_geometry.argtypes = (
        [i32] * 6 + [ctypes.POINTER(i32)] * 2
        + [ctypes.POINTER(i64)] * 3)
    lib.sgs_decode_geometry.restype = i32
    lib.sgs_decode_probe_host.argtypes = ([i32] * 5 + [i64] + [ptr] * 3
                                          + [i32]
                                          + [ctypes.POINTER(ctypes.c_double)])
    lib.sgs_decode_probe_host.restype = i32
    lib.sgs_decode_chain_cycles.argtypes = [i32] + [
        ctypes.POINTER(ctypes.c_double)] * 2
    lib.sgs_decode_chain_cycles.restype = i32


def _library() -> ctypes.CDLL:
    return _build.load("sgs_decode", _bind)


def geometry(rows: int, J: int, M: int, T: int, rows_per_group: int,
             route: Optional[str] = None):
    """(route, rows per block W, dynamic shared memory per block, the card's
    limit per block, global scratch bytes) of a launch of this shape on the
    current CUDA device. ``route`` is one of ``ROUTES`` (W = 0 on
    "wide-block", whose shared memory is 0 where the row state lives in the
    scratch), or None where the card cannot hold the launch. Asked for a
    ``route``, returns that route's geometry, or None where it does not
    take the shape. Cached per device and shape."""
    key = (torch.cuda.current_device(), rows, J, M, T, rows_per_group, route)
    hit = _geometries.get(key)
    if hit is not None:
        return hit
    lib = _library()
    code, warps = ctypes.c_int(), ctypes.c_int()
    smem, limit, scratch = (ctypes.c_longlong(), ctypes.c_longlong(),
                            ctypes.c_longlong())
    want = -1 if route is None else ROUTES.index(route)
    rc = lib.sgs_decode_geometry(rows, J, M, T, rows_per_group, want, code,
                                 warps, smem, limit, scratch)
    if rc > 0:
        _build.check_launch("sgs_decode", lib, rc)
    out = (None if rc else ROUTES[code.value], warps.value, smem.value,
           limit.value, scratch.value)
    _geometries[key] = out
    return out


def _check(name: str, x: torch.Tensor, dtypes, dim: int, device) -> None:
    _build.check_tensor("sgs_decode", name, x, dtypes, dim, device)


def sgs_decode(dur, dem, prio, release, pred, caps, *, T: int,
               route: Optional[str] = None):
    """Launch the CUDA kernel. dur (B, J) int32, dem (B, J, M) f32,
    prio (B, J) f32, release (G, J) int32, pred (G, J, J) bool or uint8,
    caps (M,) f32, all contiguous on one CUDA device; B divisible by G ->
    (start, finish (B, J) int32, ok (B, J) bool). ``route`` forces one of
    ``ROUTES`` (to compare them on one shape); by default ``geometry``
    picks it. Counts each launch in ``sgs_decode.launches``, those of the
    two wide routes also in ``sgs_decode.wide_launches``, and those of
    "wide-block" also in ``sgs_decode.wide_block_launches``."""
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
    with torch.cuda.device(device):
        taken, warps, smem, _, need = geometry(B, J, M, int(T), B // G, route)
        if taken is None:
            raise ValueError(
                f"sgs_decode: route {route} does not take {B} rows of J {J}"
                f", M {M}, T {T}" if route else
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
            B, J, M, int(T), B // G, ROUTES.index(taken), warps, smem,
            None if scratch is None else scratch.data_ptr(), stream)
    _build.check_launch("sgs_decode", lib, rc)
    _build.count_launch(sgs_decode)
    if taken != "fast":
        _build.count_launch(sgs_decode, "wide_launches")
    if taken == "wide-block":
        _build.count_launch(sgs_decode, "wide_block_launches")
    return start, finish, ok


sgs_decode.launches = 0
sgs_decode.wide_launches = 0
sgs_decode.wide_block_launches = 0


def probe_host(pred: torch.Tensor, rows: int, T: int, M: int,
               reps: int = 200) -> Dict[str, float]:
    """Host microseconds a call of each piece of a wide launch's host work
    takes on the current device, for a group's (1, J, J) ``pred`` on the
    card decoded by ``rows`` rows: what a launch repeated before it read
    the card once per device. For measurement; launches the prep kernel
    ``reps`` times on the current stream."""
    J = pred.shape[-1]
    lib = _library()
    _, _, smem, _, need = geometry(rows, J, M, T, rows, "wide")
    scratch = torch.empty(need, dtype=torch.uint8, device=pred.device)
    us = (ctypes.c_double * 9)()
    rc = lib.sgs_decode_probe_host(
        rows, J, M, T, rows, smem, pred.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(pred.device).cuda_stream, reps, us)
    _build.check_launch("sgs_decode", lib, rc)
    names = ("cudaGetDevice", "cudaDeviceGetAttribute(SMs)",
             "cudaDeviceGetAttribute(opt-in shared memory)",
             "cudaFuncGetAttributes", "cudaMemGetInfo",
             "cudaFuncSetAttribute", "cudaMemsetAsync", "prep launch",
             "sgs_decode_geometry (cached)")
    return dict(zip(names, us))


def chain_cycles(iters: int = 100000) -> Tuple[float, float]:
    """(cycles of one step's irreducible chain, the SM clock in GHz it ran
    at) on the current device: a redux, the chosen slot's dependent shared
    loads, a shuffle and one word of the window search, run back to back
    by one warp (``sgs_decode_chain``). J steps can take no less than J
    chains: the decode's latency floor. Synchronises the device."""
    lib = _library()
    cycles, ghz = ctypes.c_double(), ctypes.c_double()
    _build.check_launch("sgs_decode", lib,
                        lib.sgs_decode_chain_cycles(iters, cycles, ghz))
    return cycles.value, ghz.value
