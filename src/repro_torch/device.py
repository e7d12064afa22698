"""Device and dtype policy of the PyTorch port.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``:
the port runs on the card unless the caller asks for the CPU, and asking
for CUDA where there is no card raises — nothing falls back to the CPU.

Dtypes are pinned: the reference runs with 64-bit types off, while
torch's ``arange``, ``argmax`` and ``randint`` default to int64, so every
tensor the solver keeps is created with an explicit ``INT`` / ``FLOAT``.
Index tensors handed to advanced indexing stay int64 (``INDEX``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

INT = torch.int32
FLOAT = torch.float32
INDEX = torch.int64

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the default, ``"cuda"``. Raises ``RuntimeError`` when
    CUDA is asked for and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the port on the CPU")
    return dev
