"""Carry the reference's weights across: the JAX package's parameter tree
(``repro.models.transformer.Model.init``'s, its leaves as numpy arrays) ->
the parameter tree ``Model(cfg, params=...)`` takes.

The reference stacks the layers on a leading ``(L, ...)`` axis (it scans
them); the port keeps one entry a layer, so ``blocks`` is unstacked. The
``first_dense`` prefix blocks (deepseek-v2-lite) are a list of unstacked
blocks in the reference too. Names, layouts and dtypes are the
reference's. Imports nothing of the reference:
the caller hands the tree over as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import unstack


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: no numpy kind
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return _tensor(tree)


def from_reference(params, num_layers: int):
    """The reference's parameter tree of the ``block_pattern == "attn"``
    family without cross-attention (``embed``, the ``prefix`` list of
    ``first_dense`` blocks where there is one, ``blocks`` stacked over the
    other layers of ``num_layers``, ``final_norm``, and ``lm_head`` unless
    the embeddings are tied) -> the port's, on the CPU."""
    extra = set(params) - {"embed", "prefix", "blocks", "final_norm",
                           "lm_head"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to a "
                                  f"model whose layers are not ported yet")
    out = _tensors({k: v for k, v in params.items() if k != "blocks"})
    out["blocks"] = unstack(_tensors(params["blocks"]),
                            num_layers - len(params.get("prefix", ())))
    return out
