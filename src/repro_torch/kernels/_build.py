"""Build and load the port's CUDA kernels: one ``nvcc`` per source.

Every ``csrc/<name>.cu`` is compiled at first use for ``sm_90a`` into a
shared library with a plain C interface, cached by a hash of its source
and the flags under ``build/repro_torch/`` at the root of the checkout
(git-ignored), and loaded with ``ctypes``. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) lands beside each library as
``.log``. ``build()`` starts one ``nvcc`` per missing library, all at
once, and waits for them. Nothing here runs when the module is imported.

Threads may ask for a kernel at once (the serving daemon warms and serves
each pool on threads of its own): one lock serialises ``build`` and
``load``, so each library is compiled once and loaded once per process,
and ``count_launch`` keeps the wrappers' launch counters exact.

All kernels build with ``--fmad=false``: their contracts with their plain
PyTorch versions are bit-for-bit (``sgs_decode``) or rest on the same
rounding of every add and multiply, so nothing may be contracted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

# wall seconds of the last compile of each kernel (0.0: the cached library)
seconds: Dict[str, float] = {}
# nvcc runs of each kernel in this process
compiles: Dict[str, int] = {}

_lock = threading.RLock()            # one build or load at a time
_loaded: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


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
    missing libraries compile in parallel, one ``nvcc`` each; a second
    caller waits for the first and finds its libraries built."""
    with _lock:
        return _build(names)


def _build(names) -> Dict[str, Path]:
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
        compiles[name] = compiles.get(name, 0) + 1
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
        os.replace(tmp, lib)      # atomic: another process never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The kernel's library, built if needed and loaded once per process
    however many threads ask at once, with its error-string entry point
    typed; ``bind(lib)`` types the launch functions, once, before any
    caller gets the library."""
    lib = _loaded.get(name)      # the launch path: loaded, so no lock
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            if bind is not None:
                bind(lib)
            _loaded[name] = lib
        return lib


def use_build_dir(path) -> None:
    """Build into and load from ``path`` from now on. The libraries loaded
    so far are forgotten, so each kernel's next use builds its library
    there (or finds it built)."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)
        _loaded.clear()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to ``wrapper.<counter>``, exactly, whichever threads launch
    at once (a bare ``+= 1`` on an attribute can lose an increment)."""
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


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
