"""The reference's side of the port's model tests, built once a process and
shared by ``tests/test_torch_models.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_ssm.py``, ``tests/test_torch_multimodal.py``,
``tests/test_torch_serve_model.py`` and ``tests/test_torch_train.py``: an
arch's SMOKE config, its ``Model`` (MoE configs on the trivial (1, 1)
mesh), its ``Model.init(seed=0)`` parameters, those parameters carried
across to the port, and its jitted decode step. Nothing here is written
to: the tests only read these trees. Two context managers observe a run of
both sides: ``xla_products`` and ``routes``.

``jax_caches_cleared``, imported by each of those test files, is a
module-scoped autouse fixture: when the file's tests end it empties jax's
compiled-function caches. jax keeps every jitted function's compiled
entries in one least-recently-used list a process (8192 entries); the
reference's models compile many shapes, and a later file of the same
worker whose test reads a function's ``_cache_size()`` growing (the
reference's ``PlanResult.traced``) would otherwise see an entry of that
function evicted in place of a new one added. The jitted steps here then
compile again in the next file that runs them.
"""
import contextlib
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models.transformer import Model as RefModel
from repro_torch.models import convert, moe

DENSE = ["smollm-360m", "yi-6b", "granite-20b", "phi3-mini-3.8b"]
MOE = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
SSM = ["rwkv6-3b", "zamba2-2.7b"]
VLM = ["llama-3.2-vision-11b"]
AUDIO = ["musicgen-large"]


@pytest.fixture(scope="module", autouse=True)
def jax_caches_cleared():
    """Empty jax's compiled-function caches when the module's tests end
    (the module docstring says why)."""
    yield
    jax.clear_caches()


def _config(arch: str, replace=()):
    return ref_config(arch, smoke=True).replace(**dict(replace))


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _model(rcfg):
    # the reference's MoE layer routes inside a shard_map over a mesh; its
    # own tests give it the trivial (1, 1) mesh (tests/conftest.py)
    return RefModel(rcfg, mesh=_mesh() if rcfg.moe else None)


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


@functools.lru_cache(maxsize=None)
def gated(arch: str):
    """(the reference's ``Model.init(seed=0)`` tree with the VLM's gates set
    to seeded values in [0.5, 1.5), the same as the port's tree). The
    audio model has no gate: its trees as drawn."""
    ref = ref_params(arch)
    if "cross" not in ref:
        return ref, port_params(arch)
    G = ref["cross"]["gate"].shape[0]
    gates = 0.5 + np.random.default_rng(4).random(G).astype(np.float32)
    ref = {**ref, "cross": {**ref["cross"], "gate": jnp.asarray(gates)}}
    return ref, convert.from_reference(jax.tree.map(np.asarray, ref),
                                       ref_model(arch)[0].num_layers)


@contextlib.contextmanager
def xla_products():
    """``torch.einsum`` computed by ``jnp.einsum`` on the same operands
    while the block runs: every matrix product of the port's model layers
    is one ``torch.einsum`` call, so its float32 sums then run in the
    reference's order, and every other rounding the block makes is the
    port's own. A bfloat16 product's float32 sum order is the BLAS's:
    oneDNN's and XLA's part where a sum sits within float32 rounding of a
    bfloat16 midpoint, about 1 output in 1000, which moves a few of a
    SMOKE block's 1024 outputs on some inputs, dense blocks' as well as
    MoE blocks'."""
    einsum = torch.einsum

    def jnp_operand(t):
        a = jnp.asarray(t.float().numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a

    def xla_einsum(spec, a, b):
        out = jnp.einsum(spec, jnp_operand(a), jnp_operand(b))
        return torch.from_numpy(np.array(out, np.float32)).to(
            torch.promote_types(a.dtype, b.dtype))

    torch.einsum = xla_einsum
    try:
        yield
    finally:
        torch.einsum = einsum


@contextlib.contextmanager
def routes(E: int, k: int):
    """Record the routing of every MoE layer the reference and the port run
    meanwhile, in order: ``(ref, port)``, two lists of (top-k experts (N,
    k), the gap between the k-th and (k+1)-th router probability (N,)).
    The reference's from its own router inputs (a ``jax.debug.callback``,
    so a jitted or scanned step records too) through its lines
    (``repro/models/moe.py:64-66``); the port's from ``moe.route``. A
    function jitted before the recording began records nothing."""
    ref, port = [], []
    ref_layer, port_route = ref_moe.moe_layer, moe.route

    def gap(p):
        s = np.sort(np.asarray(p, np.float64), axis=-1)[:, ::-1]
        return s[:, k - 1] - s[:, k]

    def record(x, wr):
        xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(jnp.einsum("nd,de->ne", xf,
                                          jnp.asarray(wr, jnp.float32)), -1)
        ref.append((np.asarray(jax.lax.top_k(probs, k)[1]), gap(probs)))

    def moe_layer(p, x, cfg, mesh):
        jax.debug.callback(record, x, p["router"], ordered=True)
        return ref_layer(p, x, cfg, mesh)

    def route(router, xf, cfg):
        probs, tope, topw = port_route(router, xf, cfg)
        port.append((tope.numpy(), gap(probs.numpy())))
        return probs, tope, topw

    ref_moe.moe_layer, moe.route = moe_layer, route
    try:
        yield ref, port
    finally:
        ref_moe.moe_layer, moe.route = ref_layer, port_route


def same_routes(ref, port):
    """Assert the two sides routed every token of every MoE layer call to
    the same expert set; return the smallest router-probability gap between
    a k-th and a (k+1)-th expert among them."""
    assert len(ref) == len(port) > 0, (len(ref), len(port))
    for i, ((re_, rg), (pe, pg)) in enumerate(zip(ref, port)):
        np.testing.assert_array_equal(
            np.sort(pe, -1), np.sort(re_, -1),
            err_msg=f"MoE call {i}: expert sets part (smallest top-k gap "
                    f"{min(rg.min(), pg.min())!r})")
    return float(min(g.min() for _, g in ref + port))
