"""Carry the reference's weights across: the JAX package's parameter tree
(``repro.models.transformer.Model.init``'s, its leaves as numpy arrays) ->
the parameter tree ``Model(cfg, params=...)`` takes.

The reference stacks the layers on a leading ``(L, ...)`` axis (zamba2's
on ``(G, M)``: G groups of M Mamba2 layers; it scans them); the port keeps
one entry a layer, so ``blocks`` is unstacked. The
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
    """The reference's parameter tree -> the port's, on the CPU: ``embed``,
    the ``prefix`` list of ``first_dense`` blocks where there is one,
    ``blocks`` stacked over the other layers of ``num_layers`` (the
    ``attn`` family without cross-attention, and ``rwkv6``: (L,)), or over
    zamba2's (G, M) groups of Mamba2 layers beside its one unstacked
    ``shared_attn`` block, ``final_norm``, and ``lm_head`` unless the
    embeddings are tied. Any other part raises ``NotImplementedError``."""
    extra = set(params) - {"embed", "prefix", "blocks", "shared_attn",
                           "final_norm", "lm_head"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to a "
                                  f"model whose layers are not ported yet")
    out = _tensors({k: v for k, v in params.items() if k != "blocks"})
    blocks = _tensors(params["blocks"])
    if "shared_attn" in params:
        # zamba2: the (G, M) stack, read off a leaf; G * M == num_layers
        # where M divides it
        G, M = np.shape(params["blocks"]["ln"]["scale"])[:2]
        if num_layers // M != G:
            raise ValueError(f"({G}, {M}) groups of Mamba2 layers for a "
                             f"config of {num_layers}")
        out["blocks"] = unstack(blocks, (G, M))
    else:
        out["blocks"] = unstack(blocks,
                                num_layers - len(params.get("prefix", ())))
    return out
