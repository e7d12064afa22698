"""CUDA USL runtime prediction for Hopper: binding and launch counter.

The kernel (``csrc/usl_runtime.cu``) replaces the Pallas TPU kernel
``repro/kernels/usl_runtime.py:_kernel``; the source says what bounds it
on the card. ``kernels/_build.py`` compiles it at first use; it is called
through ``ctypes`` on PyTorch's current stream.

Same contract as ``kernels/ref.usl_runtime_ref``, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import FLOAT
from repro_torch.kernels import _build


def _bind(lib: ctypes.CDLL) -> None:
    lib.usl_runtime_launch.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int64, ctypes.c_void_p])
    lib.usl_runtime_launch.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load("usl_runtime", _bind)


def usl_runtime(n, alpha, beta, gamma, work):
    """Launch the CUDA kernel. Five broadcastable float32 or bfloat16
    tensors on one CUDA device -> float32 of the broadcast shape (the
    inputs are broadcast and cast to contiguous float32 here, as the JAX
    wrapper does). Counts each launch in ``usl_runtime.launches``."""
    device = n.device
    if device.type != "cuda":
        raise ValueError(f"usl_runtime kernel needs CUDA tensors, got {device}")
    args = torch.broadcast_tensors(n, alpha, beta, gamma, work)
    shape = args[0].shape
    flat = [x.to(FLOAT).contiguous().reshape(-1) for x in args]
    for name, x in zip(("n", "alpha", "beta", "gamma", "work"), flat):
        _build.check_tensor("usl_runtime", name, x, (FLOAT,), 1, device)
    out = torch.empty(flat[0].shape, dtype=FLOAT, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.usl_runtime_launch(*(x.data_ptr() for x in flat),
                                    out.data_ptr(), out.numel(), stream)
    _build.check_launch("usl_runtime", lib, rc)
    _build.count_launch(usl_runtime)
    return out.reshape(shape)


usl_runtime.launches = 0
