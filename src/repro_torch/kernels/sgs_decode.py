"""CUDA serial-SGS decode for Hopper: build, binding and launch counter.

The kernel (``csrc/sgs_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/sgs_decode.py:_kernel``; the source says what bounds it on
the card and how the design answers that. It is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, cached by source hash under ``build/repro_torch/`` at the root
of the checkout, and called through ``ctypes`` on PyTorch's current
stream. Nothing here builds or imports anything CUDA-specific when the
module is imported.

Same contract as ``kernels/ref.sgs_decode_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.device import FLOAT, INT

SOURCE = Path(__file__).resolve().parent / "csrc" / "sgs_decode.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build() -> Path:
    """Compile the kernel library (once per source hash) and return its
    path. The compiler's ``-Xptxas -v`` report lands beside it as
    ``.log``; ``build.seconds`` holds the last compile's wall time (0.0
    when the cached library was reused)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libsgs_decode-{digest[:16]}.so"
    build.seconds = 0.0
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.monotonic()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, check=False)
    build.seconds = time.monotonic() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half
    return out


build.seconds = 0.0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sgs_decode_launch.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p])
    lib.sgs_decode_launch.restype = ctypes.c_int
    lib.sgs_decode_error_string.argtypes = [ctypes.c_int]
    lib.sgs_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtypes, dim: int, device) -> None:
    if x.device != device:
        raise ValueError(f"sgs_decode: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype not in dtypes:
        raise TypeError(f"sgs_decode: {name} has dtype {x.dtype}, expected "
                        f"one of {dtypes}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"sgs_decode: {name} must be a contiguous "
                         f"{dim}-d tensor, got shape {tuple(x.shape)}")


def sgs_decode(dur, dem, prio, release, pred, caps, *, T: int):
    """Launch the CUDA kernel. dur (B, J) int32, dem (B, J, M) f32,
    prio (B, J) f32, release (G, J) int32, pred (G, J, J) bool or uint8,
    caps (M,) f32, all contiguous on one CUDA device; B divisible by G ->
    (start, finish (B, J) int32, ok (B, J) bool). Counts each launch in
    ``sgs_decode.launches``."""
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
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sgs_decode_launch(
            dur.data_ptr(), dem.data_ptr(), prio.data_ptr(),
            release.data_ptr(), pred.data_ptr(), caps.data_ptr(),
            start.data_ptr(), finish.data_ptr(), ok.data_ptr(),
            B, J, M, int(T), B // G, stream)
    if rc != 0:
        raise RuntimeError("sgs_decode launch failed: "
                           + lib.sgs_decode_error_string(rc).decode())
    sgs_decode.launches += 1
    return start, finish, ok


sgs_decode.launches = 0
