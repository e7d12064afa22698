"""The assigned input-shape sets and abstract inputs (PyTorch port of
``repro/launch/shapes.py``):

  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill (forward) step
  decode_32k   seq=32768  global_batch=128   -> serve_step (1 token + cache)
  long_500k    seq=524288 global_batch=1     -> serve_step; SSM/hybrid only

Where the reference's abstract inputs are ``jax.ShapeDtypeStruct``s that
carry their sharding, the port's are empty tensors on the ``meta`` device
(shapes and dtypes, never allocated), and torch tensors carry no
sharding: each function returns the tensors and, beside them, a tree of
their specs (``models/common.P``) on the mesh. The dtypes are the
reference's (int32 tokens and labels, bfloat16 embeddings and patches).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig, P, axis_size, data_axes
from repro_torch.models.transformer import Model

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _dp_spec(mesh, batch: int):
    if mesh is None:
        return None
    dp = data_axes(mesh)
    n = 1
    for a in dp:
        n *= axis_size(mesh, a)
    return dp if (n > 1 and batch % n == 0) else None


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh=None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, P]]:
    """Abstract model inputs for one (arch x shape) cell, and their specs:
    the batch over the mesh's data axes where they divide it."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    dp = _dp_spec(mesh, B)
    batch: Dict[str, torch.Tensor] = {}
    specs: Dict[str, P] = {}

    def add(name, dims, dtype):
        batch[name] = torch.empty(dims, dtype=dtype, device=META)
        specs[name] = P(dp, *(None,) * (len(dims) - 1))

    if cfg.embedding_inputs:
        add("embeds", (B, S, cfg.d_model), torch.bfloat16)
    else:
        add("tokens", (B, S), torch.int32)
    if shape.kind == "train":
        add("labels", (B, S), torch.int32)
    if cfg.cross_attn_every and shape.kind != "decode":
        add("patches", (B, cfg.num_patches, cfg.d_model), torch.bfloat16)
    return batch, specs


def abstract_cache(model: Model, shape: ShapeSpec):
    """The decode cells' abstract KV / state cache and its specs: (cache,
    specs), as the reference's. ``model`` must live on ``meta``."""
    if model.device.type != "meta":
        raise ValueError(f"abstract_cache needs a model on meta, not "
                         f"{model.device}")
    B, S = shape.global_batch, shape.seq_len
    return model.init_cache(B, S), model.cache_specs(B, S)


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Returns a skip-reason string or None if this cell runs."""
    sub_quadratic = cfg.block_pattern in ("rwkv6", "zamba2")
    if shape.name == "long_500k" and not sub_quadratic:
        return "pure full-attention arch skips long_500k (per brief)"
    return None
