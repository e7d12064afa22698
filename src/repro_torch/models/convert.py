"""Carry the reference's weights across: the JAX package's parameter tree
(``repro.models.transformer.Model.init``'s, its leaves as numpy arrays) ->
the parameter tree ``Model(cfg, params=...)`` takes.

The reference stacks the layers on a leading ``(L, ...)`` axis (zamba2's
and the VLM's on ``(G, M)``: G groups of M Mamba2 or self-attention
layers; it scans them); the port keeps one entry a layer, so ``blocks`` is
unstacked. The VLM's cross-attention parts, stacked on ``(G,)``, become a
list ``cross`` of G group dicts. The ``first_dense`` prefix blocks
(deepseek-v2-lite) are a list of unstacked blocks in the reference too.
Names, layouts and dtypes are the reference's. Imports nothing of the
reference: the caller hands the tree over as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import unstack

# the VLM's cross-attention parts, each stacked on (G,) in the reference
CROSS = ("cross", "cross_ln", "cross_mlp", "cross_ln2")


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


def _group_axes(leaf, num_layers: int, what: str):
    """The (G, M) stack read off a leaf, checked against ``num_layers``:
    G == num_layers // M, as the reference's configs draw it."""
    G, M = np.shape(leaf)[:2]
    if num_layers // M != G:
        raise ValueError(f"({G}, {M}) groups of {what} for a config of "
                         f"{num_layers}")
    return G, M


def from_reference(params, num_layers: int):
    """The reference's parameter tree -> the port's, on the CPU: ``embed``
    (absent for a model fed embeddings), the ``prefix`` list of
    ``first_dense`` blocks where there is one, ``blocks`` stacked over the
    other layers of ``num_layers`` (the ``attn`` family without
    cross-attention, and ``rwkv6``: (L,)), or over zamba2's (G, M) groups
    of Mamba2 layers beside its one unstacked ``shared_attn`` block, or
    over the VLM's (G, M) groups of self blocks beside the (G,) stacked
    ``cross``, ``cross_ln``, ``cross_mlp`` and ``cross_ln2`` (the port's
    ``cross``: one dict of the four a group), ``final_norm``, and
    ``lm_head`` unless the embeddings are tied. Any other part raises
    ``NotImplementedError``."""
    extra = set(params) - {"embed", "prefix", "blocks", "shared_attn",
                           "final_norm", "lm_head", *CROSS}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} belong to no "
                                  f"model the port has")
    out = _tensors({k: v for k, v in params.items()
                    if k != "blocks" and k not in CROSS})
    blocks = _tensors(params["blocks"])
    if "shared_attn" in params:
        # zamba2: the (G, M) stack, read off a leaf
        GM = _group_axes(params["blocks"]["ln"]["scale"], num_layers,
                         "Mamba2 layers")
        out["blocks"] = unstack(blocks, GM)
    elif "cross" in params:
        # the VLM: G groups of M self blocks, each group's cross parts
        GM = _group_axes(params["blocks"]["ln1"]["scale"], num_layers,
                         "self-attention blocks")
        out["blocks"] = unstack(blocks, GM)
        out["cross"] = unstack(_tensors({k: params[k] for k in CROSS}),
                               GM[0])
    else:
        out["blocks"] = unstack(blocks,
                                num_layers - len(params.get("prefix", ())))
    return out
