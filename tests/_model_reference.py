"""The reference's side of the port's model tests, built once a process and
shared by ``tests/test_torch_models.py`` and ``tests/test_torch_serve_model.py``:
an arch's SMOKE config, its ``Model``, its ``Model.init(seed=0)`` parameters,
those parameters carried across to the port, and its jitted decode step.
Nothing here is written to: the tests only read these trees.
"""
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np

from repro.configs import get_config as ref_config
from repro.models.transformer import Model as RefModel
from repro_torch.models import convert

DENSE = ["smollm-360m", "yi-6b", "granite-20b", "phi3-mini-3.8b"]


def _config(arch: str, replace=()):
    return ref_config(arch, smoke=True).replace(**dict(replace))


@functools.lru_cache(maxsize=None)
def _model(rcfg):
    return RefModel(rcfg)


@functools.lru_cache(maxsize=None)
def _step(rcfg):
    return jax.jit(_model(rcfg).decode_step)


def ref_model(arch: str, replace=()):
    """(config, model) of an arch's SMOKE config with ``replace`` (a tuple
    of (field, value) pairs) applied; one model a config."""
    rcfg = _config(arch, replace)
    return rcfg, _model(rcfg)


def ref_step(arch: str, replace=()):
    """The reference's ``decode_step`` jitted, as its serving loop runs it;
    one a config."""
    return _step(_config(arch, replace))


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    """The reference's ``Model.init(seed=0)`` parameters of an arch's SMOKE
    config. The draw reads the parameter dtype only, so every ``replace``
    of the tests (compute dtype, attention chunk, norm option) shares it."""
    return ref_model(arch)[1].init(seed=0)


@functools.lru_cache(maxsize=None)
def port_params(arch: str):
    """``ref_params(arch)`` as the port's parameter tree, on the CPU."""
    return convert.from_reference(jax.tree.map(np.asarray, ref_params(arch)),
                                  ref_model(arch)[0].num_layers)
