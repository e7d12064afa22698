"""The port's MoE family against the reference, on the CPU: ``olmoe-1b-7b``
(MoE) and ``deepseek-v2-lite-16b`` (MLA attention, a dense prefix block,
MoE with a merged shared expert), at their SMOKE configs.

The reference's ``Model.init(seed=0)`` parameters are carried across with
``repro_torch.models.convert`` and the same inputs (numpy, seeded) go
through both packages:

* ``moe_layer`` alone, on the reference's (1, 1) mesh, in float32: the
  outputs, the load-balance loss, the expert sets, and a capacity that
  drops assignments (the same dropped set) and routers with ties;
* the whole model in float32 (``F32_ATOL``): forward logits and loss, the
  teacher-forced decode against the reference's jitted step (MLA absorbed
  and expanded), and the expert sets of every MoE call equal on both
  sides, token by token and layer by layer (the smallest gap between a
  k-th and a (k+1)-th router probability printed; ``-s`` shows it).
  Whole models are not compared
  in bfloat16: a router logit one rounding apart can swap the k-th and
  (k+1)-th expert, and the reference's compiled scan rounds elsewhere than
  eager code does;
* each kind of bfloat16 block op by op, bit for bit, its matrix products
  summed in the reference's order (``_model_reference.xla_products``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import convert, moe
from repro_torch.models.transformer import Model, init_params

from _model_cases import F32_ATOL
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import (MOE, port_params, ref_model, ref_params,
                              ref_step, routes, same_routes, xla_products)

CACHE_LEN = 16


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


def pair(arch: str, **replace):
    """(reference config, its model, its params, the port's model on the
    CPU holding the same params)."""
    rcfg, rmodel = ref_model(arch, tuple(sorted(replace.items())))
    cfg = get_config(arch, smoke=True).replace(**replace)
    return rcfg, rmodel, ref_params(arch), Model(
        cfg, device="cpu", params=port_params(arch))


def tokens(vocab: int, B: int = 2, S: int = 8, seed: int = 1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# moe_layer alone
# ---------------------------------------------------------------------------

def _layer_case(case: str):
    """(config changes, tokens B x S, router: the first MoE block's, or
    one the case builds). ``dropping``: capacity 4 slots an expert for 64
    assignments over 8 experts; ``tied``: every router logit equal, so
    top-k takes experts 0 and 1; ``tied-columns``: a column w of the
    router as expert 0's logit doubled and experts 1 and 6 sharing it, the
    others zero, so a token with x.w > 0 ties 1 and 6 at the k-th place
    (experts 0 and 1 are taken) and one with x.w < 0 ties the five
    zero-logit experts (2 and 3 are taken)."""
    router = np.array(ref_params("olmoe-1b-7b")["blocks"]["moe"]["router"][0])
    change, shape = {"dtype": "float32"}, (2, 8)
    if case == "dropping":
        change["capacity_factor"], shape = 0.25, (2, 16)
    elif case == "tied":
        router = np.zeros_like(router)
    elif case == "tied-columns":
        w = router[:, 0].copy()
        router = np.zeros_like(router)
        router[:, 0], router[:, 1], router[:, 6] = 2 * w, w, w
    return change, shape, router


@pytest.mark.parametrize("case", ["float32", "dropping", "tied",
                                  "tied-columns"])
def test_moe_layer_matches_reference(case, mesh11):
    change, (B, S), router = _layer_case(case)
    rcfg, _ = ref_model("olmoe-1b-7b", tuple(sorted(change.items())))
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(**change)
    blk = ref_params("olmoe-1b-7b")["blocks"]["moe"]
    p_ref = {k: (router if k == "router" else np.array(v[0]))
             for k, v in blk.items()}
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want, want_aux = ref_moe.moe_layer(
        {k: jnp.asarray(v) for k, v in p_ref.items()}, jnp.asarray(x), rcfg,
        mesh11)
    with routes(cfg.num_experts, cfg.top_k) as (ref_seen, port_seen):
        got, aux = moe.moe_layer({k: torch.from_numpy(v)
                                  for k, v in p_ref.items()},
                                 torch.from_numpy(x), cfg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=F32_ATOL)

    # the reference's top-k on its router's own float32 logits (its lines
    # moe.py:64-66), and its dropped set by its rank rule (:79-81)
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x.reshape(-1, cfg.d_model)),
                        jnp.asarray(router))
    _, ref_e = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    np.testing.assert_array_equal(port_seen[0][0], np.asarray(ref_e))
    ef = jax.nn.one_hot(ref_e.reshape(-1), cfg.num_experts, dtype=jnp.int32)
    ref_pos = jnp.sum((jnp.cumsum(ef, 0) - ef) * ef, -1)
    cap = moe.capacity(B * S, cfg)
    pos, keep = moe.slots(torch.from_numpy(port_seen[0][0]), cfg.num_experts,
                          cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_pos < cap))
    if case in ("dropping", "tied"):     # "tied": 32 assignments to 2
        assert 0 < int((~keep).sum()) < keep.numel()
    if case == "tied":
        assert (port_seen[0][0] == [0, 1]).all()
    if case == "tied-columns":
        up = (x.reshape(-1, cfg.d_model) @ router[:, 0] > 0)[:, None]
        assert 0 < up.sum() < up.size
        np.testing.assert_array_equal(port_seen[0][0],
                                      np.where(up, [0, 1], [2, 3]))


# ---------------------------------------------------------------------------
# whole models, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_reference(arch):
    rcfg, rmodel, params, port = pair(arch, dtype="float32")
    toks = tokens(rcfg.vocab_size)
    with routes(rcfg.num_experts, rcfg.top_k) as (ref_seen, port_seen):
        want, want_aux = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
        got, aux = port.forward({"tokens": torch.from_numpy(toks)})
    margin = same_routes(ref_seen, port_seen)
    print(f"{arch}: smallest top-{rcfg.top_k} gap {margin!r}")
    assert len(port_seen) == rcfg.num_layers - rcfg.first_dense
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=F32_ATOL,
                               err_msg=f"smallest top-k gap {margin!r}")
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("arch, absorb", [
    ("olmoe-1b-7b", True), ("deepseek-v2-lite-16b", True),
    ("deepseek-v2-lite-16b", False)],
    ids=["olmoe-1b-7b", "deepseek-v2-lite-16b-absorbed",
         "deepseek-v2-lite-16b-expanded"])
def test_teacher_forced_decode_matches_reference(arch, absorb):
    """``decode_step`` fed the same tokens one position at a time against
    the reference's jitted step (jitted here, under the recording): logits
    at every position, the caches (the prefix's and the compressed MLA
    latent included) and the expert sets of every step."""
    change = {"dtype": "float32", "mla_absorb": absorb}
    rcfg, rmodel, params, port = pair(arch, **change)
    toks = tokens(rcfg.vocab_size)
    B, S = toks.shape
    rcache, _ = rmodel.init_cache(B, CACHE_LEN)
    cache = port.init_cache(B, CACHE_LEN)
    assert jax.tree.structure(jax.tree.map(np.asarray, rcache)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), cache))
    want, got = [], []
    with routes(rcfg.num_experts, rcfg.top_k) as (ref_seen, port_seen):
        step = jax.jit(rmodel.decode_step)
        for t in range(S):
            w, rcache = step(params, rcache, {"tokens": jnp.asarray(
                toks[:, t:t + 1])}, t)
            g, cache = port.decode_step(cache, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])}, t)
            want.append(f32(w))
            got.append(f32(g))
        jax.effects_barrier()
    margin = same_routes(ref_seen, port_seen)
    print(f"{arch}, mla_absorb={absorb}: smallest top-{rcfg.top_k} gap "
          f"{margin!r}")
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(want, 1), rtol=0, atol=F32_ATOL,
                               err_msg=f"smallest top-k gap {margin!r}")
    for path, ref_leaf in jax.tree_util.tree_leaves_with_path(rcache):
        leaf = cache
        for key in path:
            leaf = leaf[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(f32(leaf), f32(ref_leaf), rtol=0,
                                   atol=F32_ATOL, err_msg=str(path))


# ---------------------------------------------------------------------------
# bfloat16 blocks, op by op
# ---------------------------------------------------------------------------

# (arch, block, mla_absorb, phase): absorbed or expanded, MLA differs in
# its decode branch only
BLOCKS = [("olmoe-1b-7b", "blocks", True, "prefill"),
          ("olmoe-1b-7b", "blocks", True, "decode"),
          ("deepseek-v2-lite-16b", "prefix", True, "prefill"),
          ("deepseek-v2-lite-16b", "prefix", True, "decode"),
          ("deepseek-v2-lite-16b", "prefix", False, "decode"),
          ("deepseek-v2-lite-16b", "blocks", True, "prefill"),
          ("deepseek-v2-lite-16b", "blocks", True, "decode"),
          ("deepseek-v2-lite-16b", "blocks", False, "decode")]


@pytest.mark.parametrize("arch, part, absorb, phase", BLOCKS, ids=[
    "olmoe-moe-prefill", "olmoe-moe-decode", "deepseek-prefix-prefill",
    "deepseek-prefix-decode", "deepseek-prefix-decode-expanded",
    "deepseek-moe-prefill", "deepseek-moe-decode",
    "deepseek-moe-decode-expanded"])
def test_block_matches_reference_op_by_op(arch, part, absorb, phase):
    """One bfloat16 block, the reference's run op by op (not in its scan),
    at the dense test's input: the port's output, its MoE loss and, in
    decode, its cache (written at position 5 of a filled one) are the
    reference's bit for bit (the MoE loss, float32, within ``F32_ATOL``).
    The products' float32 sums run in the reference's order
    (``xla_products``)."""
    rcfg, rmodel, params, port = pair(arch, mla_absorb=absorb)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, rcfg.d_model))
    ref_blk = (params["prefix"][0] if part == "prefix"
               else jax.tree.map(lambda a: a[0], params["blocks"]))
    blk = getattr(port, part)[0]
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).float().bfloat16()
    pos = np.arange(8)[None]
    rc = pc = None
    index = None
    if phase == "decode":
        xb, xt, pos, index = xb[:, :1], xt[:, :1], np.full((2, 1), 5), 5
        cache = port.init_cache(2, 8)
        cache = cache["prefix"][0] if part == "prefix" else {
            k: v[0] for k, v in cache["blocks"].items()}
        pc = {k: torch.from_numpy(rng.normal(size=v.shape)).float().bfloat16()
              for k, v in cache.items()}
        rc = {k: jnp.asarray(f32(v)).astype(jnp.bfloat16)
              for k, v in pc.items()}
    want, new_rc, want_aux = rmodel._attn_block(
        ref_blk, xb, jnp.asarray(pos), rc, index, part == "blocks")
    with xla_products():
        got, aux = port._attn_block(blk, xt, torch.from_numpy(pos), pc,
                                    index)
    np.testing.assert_array_equal(f32(got), f32(want))
    assert (aux is None) == (part == "prefix")
    if aux is not None:     # a float32 statistic: its sums' order is free
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                                   atol=F32_ATOL)
    if phase == "decode":
        for k in pc:
            np.testing.assert_array_equal(f32(pc[k]), f32(new_rc[k]))


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


@pytest.mark.parametrize("arch", MOE)
def test_init_has_the_references_tree_kinds_and_scales(arch):
    """The port's own init draws the reference's tree (``prefix``, ``moe``,
    ``shared`` and the MLA leaves among it): the same leaves, shapes and
    dtypes, the norms' scales (``kv_norm`` among them) at one, and the
    reference's scales: a stacked leaf takes its fan-in from the layer
    axis, a prefix leaf from its first axis, the router 0.02 and the
    experts' ``w_down`` 1/sqrt(d_ff_expert). Drawn in bfloat16, the router
    stays float32."""
    cfg = get_config(arch, smoke=True)
    mine = init_params(cfg, seed=0, device="cpu")
    a, b = dict(_leaves(mine)), dict(_leaves(port_params(arch)))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if "ln" in k or "norm" in k:
            assert torch.equal(a[k], torch.ones_like(a[k])), k
    n = cfg.num_layers - cfg.first_dense

    def std(name):
        return float(torch.stack([v for k, v in a.items()
                                  if k.endswith(name) and "/blocks/" in k])
                     .std())

    assert abs(std("/moe/router") / 0.02 - 1.0) < 0.05
    assert abs(std("/moe/w_down") * cfg.d_ff_expert ** 0.5 - 1.0) < 0.05
    assert abs(std("/moe/w_gate") * n ** 0.5 - 1.0) < 0.05
    assert abs(std("/attn/wq") * n ** 0.5 - 1.0) < 0.05
    if cfg.first_dense:
        wq = mine["prefix"][0]["attn"]["wq"]
        assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
        assert set(mine["blocks"][0]) == {"ln1", "ln2", "attn", "moe",
                                          "shared"}
        assert set(mine["prefix"][0]) == {"ln1", "ln2", "attn", "mlp"}
    half = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    blk = half["blocks"][0]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["w_gate"].dtype == torch.bfloat16
    assert torch.equal(blk["moe"]["w_gate"],
                       mine["blocks"][0]["moe"]["w_gate"].bfloat16())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", MOE)
def test_converter_round_trip(arch, dtype):
    """The reference's tree -> ``convert.from_reference`` -> ``Model`` ->
    ``Model.params()`` returns the reference's leaves: those the model
    keeps in float32 (the norms' scales, ``kv_norm`` and the router, here
    not at their init values) bit for bit, the matrices cast once to the
    compute dtype."""
    rng = np.random.default_rng(5)
    ref = jax.tree.map(np.array, ref_params(arch))
    kept = []
    for blk in [*ref.get("prefix", []), ref["blocks"]]:
        for part, name in (("attn", "kv_norm"), ("moe", "router")):
            if name in blk.get(part, {}):
                leaf = blk[part][name]
                leaf += rng.normal(size=leaf.shape).astype(np.float32) * 0.3
                assert f32(torch.from_numpy(leaf).bfloat16()).tolist() != \
                    leaf.tolist()
                kept.append(name)
    assert "router" in kept and ("kv_norm" in kept) == (arch != "olmoe-1b-7b")
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    model = Model(cfg, device="cpu",
                  params=convert.from_reference(ref, cfg.num_layers))
    back = dict(_leaves(model.params()))
    want = dict(_leaves(convert.from_reference(ref, cfg.num_layers)))
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        keep = any(s in k for s in ("/ln1/", "/ln2/", "norm", "router"))
        assert back[k].dtype == (w.dtype if keep else cfg.cdtype), k
        assert torch.equal(back[k], w if keep else w.to(cfg.cdtype)), k
