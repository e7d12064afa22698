"""Build and load the port's CUDA kernels: one ``nvcc`` per source.

Every ``csrc/<name>.cu`` is compiled at first use for ``sm_90a`` into a
shared library with a plain C interface, cached by a hash of its source
and the flags under ``build/repro_torch/`` at the root of the checkout
(git-ignored), and loaded with ``ctypes``. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) lands beside each library as
``.log``. ``build()`` starts one ``nvcc`` per missing library, all at
once, and waits for them. Nothing here runs when the module is imported.

All kernels build with ``--fmad=false``: their contracts with their plain
PyTorch versions are bit-for-bit (``sgs_decode``) or rest on the same
rounding of every add and multiply, so nothing may be contracted.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

# wall seconds of the last compile of each kernel (0.0: the cached library)
seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels under " + str(CSRC))


def build(*names: str) -> Dict[str, Path]:
    """Compile the named kernels (``csrc/<name>.cu``), each once per hash
    of its source and the flags, and return ``{name: library}``. The
    missing libraries compile in parallel, one ``nvcc`` each."""
    out = {}
    for name in names:
        digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out[name] = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    running = {}
    for name, lib in out.items():
        seconds[name] = 0.0
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, time.monotonic())
    failed = []
    for name, (proc, tmp, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode})"
                          f":\n{stderr}")
            continue
        lib = out[name]
        lib.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, lib)      # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built if needed, with its error-string entry
    point typed; the caller types its launch function."""
    lib = ctypes.CDLL(str(build(name)[name]))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_tensor(kernel: str, name: str, x, dtypes, dim: int,
                 device) -> None:
    """Raise unless ``x`` is a contiguous ``dim``-d tensor of one of
    ``dtypes`` on ``device``: what a kernel takes, checked before launch."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, expected "
                         f"{device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} has dtype {x.dtype}, expected "
                        f"one of {dtypes}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous "
                         f"{dim}-d tensor, got shape {tuple(x.shape)}")


def check_launch(name: str, lib: ctypes.CDLL, rc: int) -> None:
    """Raise unless the launch function returned 0 (``cudaSuccess``)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
