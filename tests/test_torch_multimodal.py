"""The port's VLM and audio backbones against the reference, on the CPU:
``llama-3.2-vision-11b`` (G groups of M self-attention blocks, each group
followed by a gated cross-attention sublayer over patch embeddings and an
MLP) and ``musicgen-large`` (dense blocks fed frame embeddings in place of
tokens, no embedding table), at their SMOKE configs, one intra-op thread.

The reference draws every cross-attention gate at zero, so a freshly drawn
VLM's cross-attention adds nothing. Every comparison here sets the gates to
seeded non-zero values, the same on both sides (``gated``), and the forward
test checks that the cross-attention then moves the logits. The
reference's serving never fills the patch cache; here one helper
(``patch_kv``) fills it on both sides from seeded patches through the
reference's own projection.

* ``cross_attention`` against the reference's, k and v projected from the
  patches and read from a filled cache: in float32 within ``F32_ATOL``; in
  bfloat16 run op by op, the products summed in the reference's order
  (``_model_reference.xla_products``), equal;
* whole models in float32: forward logits (the VLM with patches, also with
  its queries chunked; the audio model with embeddings) and teacher-forced
  decode logits and every final cache leaf within ``F32_ATOL``; the
  port's forward against its own stepped decode;
* the init tree (the VLM's fan-in from its (G, M) stack's first axis, G),
  ``init_cache``'s tree and the converter's round trip.
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

from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.models import common, convert
from repro_torch.models import layers as ll
from repro_torch.models.transformer import Model, init_params

from _model_cases import F32_ATOL
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import (AUDIO, VLM, port_params, ref_model, ref_params,
                              ref_step, xla_products)

B, S, CACHE_LEN = 2, 8, 16


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many, and
    leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


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


def pair(arch: str, **replace):
    """(reference config, its model, its gated params, the port's model on
    the CPU holding the same params)."""
    rcfg, rmodel = ref_model(arch, tuple(sorted(replace.items())))
    cfg = get_config(arch, smoke=True).replace(**replace)
    ref, port = gated(arch)
    return rcfg, rmodel, ref, Model(cfg, device="cpu", params=port)


def patches(cfg) -> np.ndarray:
    """Seeded patch embeddings (B, num_patches, d), float32."""
    return np.random.default_rng(3).normal(
        size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)


def patch_kv(rcfg, ref, pt):
    """The patch cache filled from ``pt``: k and v (G, B, P, KH, Dh), each
    group's projection through its ``wk`` and ``wv`` by the reference's own
    einsum (``repro/models/layers.py:174-175``) in the compute dtype, as
    float32 numpy."""
    dt = rcfg.cdtype
    p = jnp.asarray(pt).astype(dt)
    return {n: np.stack([f32(jnp.einsum("bpd,dhk->bphk", p, w.astype(dt)))
                         for w in ref["cross"][f"w{n}"]])
            for n in ("k", "v")}


def fill(rcache, cache, kv, rcfg):
    """Write the patch cache ``kv`` into the reference's cache (a new
    tree) and the port's (in place)."""
    rcache["cross_groups"]["cross_kv"] = {
        n: jnp.asarray(v).astype(rcfg.cdtype) for n, v in kv.items()}
    for n, v in kv.items():
        cache["cross_groups"]["cross_kv"][n].copy_(torch.from_numpy(v))


def inputs(cfg, S: int = S):
    """A seeded batch: tokens (B, S), or for the audio model embeddings (B,
    S, d) x 0.02 as its serving draws them; the VLM's with patches."""
    rng = np.random.default_rng(1)
    if cfg.embedding_inputs:
        batch = {"embeds": (rng.normal(size=(B, S, cfg.d_model))
                            * 0.02).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (B, S)).astype(np.int32)}
    if cfg.cross_attn_every:
        batch["patches"] = patches(cfg)
    return batch


def at(batch, t: int):
    """Position ``t`` of a batch's sequence, as a decode step takes it."""
    return {k: v[:, t:t + 1] for k, v in batch.items() if k != "patches"}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the cross-attention layer, float32 and bfloat16 op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", ["patches", "cache"])
def test_cross_attention_matches_reference(phase, dtype):
    """Group 0's cross-attention, its gate non-zero, the reference's run op
    by op: over 8 queries with k and v projected from the patches
    (``patches``), or over one query with k and v read from a filled patch
    cache (``cache``, as decode reads it). float32 within ``F32_ATOL``;
    bfloat16 with the products in the reference's order, equal."""
    rcfg, _, ref, port = pair(VLM[0], dtype=dtype)
    cfg = port.cfg
    ref_p = jax.tree.map(lambda a: a[0], ref["cross"])
    mine = port.cross[0]["cross"]
    assert float(mine["gate"]) == float(ref_p["gate"].astype(rcfg.cdtype)) > 0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(
        B, 8 if phase == "patches" else 1, cfg.d_model))).to(cfg.cdtype)
    xj = jnp.asarray(f32(x)).astype(rcfg.cdtype)
    pt = patches(cfg)
    if phase == "patches":
        args = (torch.from_numpy(pt).to(cfg.cdtype), None)
        ref_args = (jnp.asarray(pt).astype(rcfg.cdtype), None)
    else:
        kv = {n: v[0] for n, v in patch_kv(rcfg, ref, pt).items()}
        args = (None, {n: torch.from_numpy(v).to(cfg.cdtype)
                       for n, v in kv.items()})
        ref_args = (None, {n: jnp.asarray(v).astype(rcfg.cdtype)
                           for n, v in kv.items()})
    want = ref_layers.cross_attention(ref_p, xj, ref_args[0], rcfg,
                                      kv_cache=ref_args[1])
    products = (xla_products() if dtype == "bfloat16"
                else contextlib.nullcontext())
    with products:
        got = ll.cross_attention(mine, x, args[0], cfg, kv_cache=args[1])
    assert got.dtype == cfg.cdtype and got.shape == want.shape
    assert float(np.abs(f32(want)).max()) > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                                   atol=F32_ATOL)
    else:
        np.testing.assert_array_equal(f32(got), f32(want))


# ---------------------------------------------------------------------------
# whole models, float32
# ---------------------------------------------------------------------------

FORWARD = {"vlm": (VLM[0], {}), "vlm-query-chunked": (VLM[0], {
    "attn_chunk": 4}), "audio": (AUDIO[0], {})}


@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_logits_match_reference(case):
    """Forward logits in float32: the VLM over patches with its gates
    non-zero (and with its 8 queries in chunks of 4: the causal self
    attention and the unmasked cross-attention both chunked), the audio
    model over embeddings. The VLM's cross-attention moves the reference's
    logits by far more than the tolerance, so the comparison sees it."""
    arch, replace = FORWARD[case]
    rcfg, rmodel, ref, port = pair(arch, dtype="float32", **replace)
    batch = inputs(port.cfg)
    want, want_aux = rmodel.forward(ref, jnp_batch(batch))
    got, aux = port.forward(torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=F32_ATOL)
    if rcfg.cross_attn_every:
        bare, _ = rmodel.forward(ref_params(arch), jnp_batch(batch))
        assert float(np.abs(f32(want) - f32(bare)).max()) > 100 * F32_ATOL


def test_vlm_forward_needs_patches():
    """Without patches the VLM's forward raises (the reference would fail
    inside an einsum)."""
    _, _, _, port = pair(VLM[0], dtype="float32")
    batch = inputs(port.cfg)
    del batch["patches"]
    with pytest.raises(ValueError, match="patches"):
        port.forward(torch_batch(batch))


def cache_leaves(rcache, cache):
    """(path, the reference's leaf, the port's) for every leaf of the
    reference's cache; the two trees must have one structure."""
    assert jax.tree.structure(jax.tree.map(lambda a: 0, rcache)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, cache))
    for path, ref_leaf in jax.tree_util.tree_leaves_with_path(rcache):
        leaf = cache
        for key in path:
            leaf = leaf[key.key]
        yield jax.tree_util.keystr(path), ref_leaf, leaf


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_init_cache_has_the_references_tree(arch):
    """``init_cache`` gives the reference's tree, shapes and dtypes, all
    zeros: the VLM's ``cross_groups`` with ``self`` (G, M, B, S, KH, Dh)
    and the patch cache ``cross_kv`` (G, B, num_patches, KH, Dh)."""
    rcfg, rmodel = ref_model(arch)
    rcache, _ = rmodel.init_cache(B, CACHE_LEN)
    cache = Model(get_config(arch, smoke=True), device="cpu",
                  params=port_params(arch)).init_cache(B, CACHE_LEN)
    paths = []
    for path, ref_leaf, leaf in cache_leaves(rcache, cache):
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert str(leaf.dtype).split(".")[1] == str(ref_leaf.dtype), path
        assert not leaf.any(), path
        paths.append(path)
    if rcfg.cross_attn_every:
        G = rcfg.num_layers // rcfg.cross_attn_every
        assert cache["cross_groups"]["cross_kv"]["k"].shape == (
            G, B, rcfg.num_patches, rcfg.num_kv_heads, rcfg.head_dim)
        assert len(paths) == 4
    else:
        assert len(paths) == 2


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_teacher_forced_decode_matches_reference(arch):
    """``decode_step`` fed the same inputs one position at a time against
    the reference's jitted step, the VLM's patch cache filled on both sides
    and its gates non-zero: logits at every position within ``F32_ATOL``,
    the self blocks' k and v within ``F32_ATOL``, the patch cache as it
    was filled."""
    rcfg, rmodel, ref, port = pair(arch, dtype="float32")
    batch = inputs(port.cfg)
    rcache, _ = rmodel.init_cache(B, CACHE_LEN)
    cache = port.init_cache(B, CACHE_LEN)
    kv = None
    if rcfg.cross_attn_every:
        kv = patch_kv(rcfg, ref, batch["patches"])
        fill(rcache, cache, kv, rcfg)
    step = ref_step(arch, (("dtype", "float32"),))
    want, got = [], []
    for t in range(S):
        w, rcache = step(ref, rcache, jnp_batch(at(batch, t)), t)
        g, cache = port.decode_step(cache, torch_batch(at(batch, t)), t)
        want.append(f32(w))
        got.append(f32(g))
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(want, 1), rtol=0, atol=F32_ATOL)
    for path, ref_leaf, leaf in cache_leaves(rcache, cache):
        np.testing.assert_allclose(f32(leaf), f32(ref_leaf), rtol=0,
                                   atol=F32_ATOL, err_msg=path)
    if kv is not None:
        for n, v in kv.items():
            np.testing.assert_array_equal(
                f32(cache["cross_groups"]["cross_kv"][n]), v)
            np.testing.assert_array_equal(
                f32(rcache["cross_groups"]["cross_kv"][n]), v)


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_forward_matches_stepped_decode(arch):
    """The port's forward against its own decode steps over the same 8
    positions, in float32, the VLM's gates non-zero and its patch cache
    filled from the forward's patches: the property of the reference's
    ``test_prefill_matches_decode``, which it never runs for the VLM."""
    rcfg, _, ref, port = pair(arch, dtype="float32")
    batch = inputs(port.cfg)
    full, _ = port.forward(torch_batch(batch))
    cache = port.init_cache(B, CACHE_LEN)
    if rcfg.cross_attn_every:
        for n, v in patch_kv(rcfg, ref, batch["patches"]).items():
            cache["cross_groups"]["cross_kv"][n].copy_(torch.from_numpy(v))
    stepped = []
    for t in range(S):
        logits, cache = port.decode_step(cache, torch_batch(at(batch, t)), t)
        stepped.append(logits)
    np.testing.assert_allclose(f32(torch.cat(stepped, 1)), f32(full),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_float64_model_rounds_in_float64(arch):
    """float32 is a floor of the layers' norm statistics, rotations and
    attention scores (``layers.wide``), so a float64 model (which
    ``chip_smoke.py`` holds the served VLM's first group in) computes in
    float64 throughout: its forward and its stepped decode, the VLM's
    patch cache filled by the same projection in float64, agree to 1e-12,
    where a float32 score or statistic would part them by about 1e-7; and
    its logits are the float32 model's within ``F32_ATOL``."""
    cfg = get_config(arch, smoke=True).replace(dtype="float64",
                                               param_dtype="float64")
    model = Model(cfg, device="cpu", params=gated(arch)[1])
    batch = torch_batch(inputs(cfg))
    full, _ = model.forward(batch)
    assert full.dtype == torch.float64
    cache = model.init_cache(B, CACHE_LEN)
    if cfg.cross_attn_every:
        w = model.cross[0]["cross"]
        pt = batch["patches"].double()
        for g, grp in enumerate(model.cross):
            for n in ("k", "v"):
                cache["cross_groups"]["cross_kv"][n][g] = torch.einsum(
                    "bpd,dhk->bphk", pt, grp["cross"][f"w{n}"])
        assert w["wk"].dtype == torch.float64
    stepped = torch.cat([model.decode_step(cache, at(batch, t), t)[0]
                         for t in range(S)], 1)
    np.testing.assert_allclose(stepped.numpy(), full.numpy(), rtol=0,
                               atol=1e-12)
    _, _, _, port = pair(arch, dtype="float32")
    np.testing.assert_allclose(f32(full), f32(port.forward(batch)[0]),
                               rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# init and the converter
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# the leaves the model keeps in cfg.param_dtype (transformer._NORMS)
KEPT = ("/ln1/", "/ln2/", "/cross_ln/", "/cross_ln2/", "/final_norm/")


@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_init_has_the_references_tree_kinds_and_scales(arch):
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (no ``embed`` for the audio model), the ones and
    zeros where the reference has them (every gate at zero), and its
    scales: a stacked leaf takes its fan-in from its stack's first axis,
    L for the audio model and G for the VLM's (G, M) self blocks and (G,)
    cross parts (drawn at G 3, M 2, where G, M and G * M part). Drawn in
    bfloat16, the norms stay float32."""
    cfg = get_config(arch, smoke=True)
    mine = init_params(cfg, seed=0, device="cpu")
    a, b = dict(_leaves(mine)), dict(_leaves(port_params(arch)))
    assert sorted(a) == sorted(b)
    constant = set()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if torch.equal(b[k], torch.ones_like(b[k])) or \
                torch.equal(b[k], torch.zeros_like(b[k])):
            assert torch.equal(a[k], b[k]), k
            constant.add(k)
    assert common.param_count(mine) == common.param_count(port_params(arch))

    def std(tree, part, name):
        return float(torch.stack([v for k, v in _leaves(tree)
                                  if k.startswith(f"/{part}/")
                                  and k.endswith(name)]).std())

    if cfg.cross_attn_every:
        gates = [k for k in a if k.endswith("/cross/gate")]
        assert len(gates) == cfg.num_layers // cfg.cross_attn_every
        assert all(k in constant and not a[k].any() for k in gates)
        c6 = cfg.replace(num_layers=6)
        G = c6.num_layers // c6.cross_attn_every
        assert (G, c6.cross_attn_every) == (3, 2)
        six = init_params(c6, seed=0, device="cpu")
        assert len(six["blocks"]) == 6 and len(six["cross"]) == G
        for part, name, fan_in in (
                ("blocks", "/attn/wq", G), ("blocks", "/mlp/w_gate", G),
                ("cross", "/cross/wq", G), ("cross", "/cross/wk", G),
                ("cross", "/cross_mlp/w_up", G),
                ("cross", "/cross_mlp/w_down", cfg.d_ff),
                ("cross", "/cross/wo", cfg.num_heads * cfg.head_dim)):
            assert abs(std(six, part, name) * fan_in ** 0.5 - 1.0) < 0.05, \
                (part, name)
    else:
        assert "embed" not in mine and "/lm_head" in a
        L = cfg.num_layers
        assert abs(std(mine, "blocks", "/attn/wq") * L ** 0.5 - 1.0) < 0.05
        assert abs(float(mine["lm_head"].std()) / 0.02 - 1.0) < 0.05
    half = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for k, w in _leaves(half):
        want = (torch.float32 if k in constant or any(s in k for s in KEPT)
                else torch.bfloat16)
        assert w.dtype == want, k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", VLM + AUDIO)
def test_converter_round_trip(arch, dtype):
    """The reference's tree (gates non-zero) -> ``convert.from_reference``
    -> ``Model`` -> ``Model.params()`` returns the reference's leaves: the
    norms (moved off their init values here so that a bfloat16 rounding
    would show) bit for bit, the matrices and gates cast once to the
    compute dtype; one entry a layer or a group."""
    rng = np.random.default_rng(5)
    ref = jax.tree.map(np.array, gated(arch)[0])
    for name, leaf in _leaves(ref):
        if any(s in name for s in KEPT):
            leaf += rng.normal(size=leaf.shape).astype(np.float32) * 0.3
            assert f32(torch.from_numpy(leaf).bfloat16()).tolist() != \
                leaf.tolist(), name
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    model = Model(cfg, device="cpu",
                  params=convert.from_reference(ref, cfg.num_layers))
    back = dict(_leaves(model.params()))
    want = dict(_leaves(convert.from_reference(ref, cfg.num_layers)))
    assert sorted(back) == sorted(want)
    G = cfg.num_layers // (cfg.cross_attn_every or 1)
    copies = {"blocks": cfg.num_layers, **{p: G for p in convert.CROSS}}
    assert len(want) == sum(copies.get(k.split("/")[1], 1)
                            for k, _ in _leaves(ref))
    for k, w in want.items():
        keep = any(s in k for s in KEPT)
        assert back[k].dtype == (w.dtype if keep else cfg.cdtype), k
        assert torch.equal(back[k], w if keep else w.to(cfg.cdtype)), k
