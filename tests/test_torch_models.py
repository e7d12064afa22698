"""The port's dense model family against the reference, on the CPU.

The four dense architectures' SMOKE configs (``smollm-360m`` with tied
embeddings, ``yi-6b`` GQA, ``granite-20b`` MQA, ``phi3-mini-3.8b`` MHA):
the reference's ``Model.init(seed=0)`` parameters are carried across with
``repro_torch.models.convert``, the same tokens (numpy, seeded) go through
both packages, and the logits must agree:

* in float32 (``cfg.replace(dtype="float32")``) within ``F32_ATOL``;
* in bfloat16 within ``bf16_tolerance`` (``tests/_model_cases.py`` derives
  it). A block run op by op equals the reference's exactly
  (``test_block_matches_reference_op_by_op``); whole models part because
  the reference runs its layers in a compiled scan, where XLA keeps some
  bfloat16 roundings in float32 (excess precision).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import common
from repro_torch.models.transformer import Model, init_params

from _model_cases import F32_ATOL, tolerance
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import (DENSE, port_params, ref_model, ref_params,
                              ref_step)

# the teacher-forced cache holds 16 positions, as the serving test's
# (tests/test_torch_serve_model.py) does, so the two share one jitted step
CACHE_LEN = 16


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many, and
    leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pair(arch: str, **replace):
    """(reference config, its model, its params, the port's model on the
    CPU holding the same params) of an arch's SMOKE config; the reference's
    side is built once a process (``tests/_model_reference.py``)."""
    rcfg, rmodel = ref_model(arch, tuple(sorted(replace.items())))
    cfg = get_config(arch, smoke=True).replace(**replace)
    port = Model(cfg, device="cpu", params=port_params(arch))
    return rcfg, rmodel, ref_params(arch), port


def tokens(vocab: int, B: int = 2, S: int = 8, seed: int = 1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch, dtype):
    rcfg, rmodel, params, port = pair(arch, dtype=dtype)
    toks = tokens(rcfg.vocab_size)
    want, _ = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward({"tokens": torch.from_numpy(toks)})
    assert got.dtype == port.cfg.cdtype and float(aux) == 0.0
    assert got.shape == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                               atol=tolerance(rcfg, want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_reference(arch, dtype):
    """``decode_step`` fed the same tokens one position at a time, the
    reference's jitted as its serving driver runs it: logits at every
    position."""
    rcfg, rmodel, params, port = pair(arch, dtype=dtype)
    toks = tokens(rcfg.vocab_size)
    B, S = toks.shape
    rcache, _ = rmodel.init_cache(B, CACHE_LEN)
    cache = port.init_cache(B, CACHE_LEN)
    step = ref_step(arch, (("dtype", dtype),))
    want, got = [], []
    for t in range(S):
        w, rcache = step(params, rcache, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, t)
        g, cache = port.decode_step(cache, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, t)
        want.append(f32(w))
        got.append(f32(g))
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=tolerance(rcfg, want))
    for name in ("k", "v"):
        ref_kv = rcache["blocks"][name]
        np.testing.assert_allclose(f32(cache["blocks"][name]), f32(ref_kv),
                                   rtol=0, atol=tolerance(rcfg, ref_kv))


@pytest.mark.parametrize("arch", DENSE)
def test_block_matches_reference_op_by_op(arch):
    """One bfloat16 block, the reference's run op by op (not in its scan):
    the port's output is the reference's, bit for bit."""
    rcfg, rmodel, params, port = pair(arch)
    x = np.random.default_rng(2).normal(size=(2, 8, rcfg.d_model))
    pos = np.arange(8)[None]
    block = jax.tree.map(lambda a: a[0], params["blocks"])
    want, _, _ = rmodel._attn_block(
        block, jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
        jnp.asarray(pos), None, None, False)
    got, aux = port._attn_block(port.blocks[0],
                                torch.from_numpy(x).float().bfloat16(),
                                torch.from_numpy(pos), None, None)
    assert aux is None
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("change", [dict(attn_chunk=4), dict(fast_norm=True)],
                         ids=["query-chunked", "fast-norm"])
def test_forward_options_match_reference(change):
    """The query-chunked attention branch (8 queries in chunks of 4) and the
    ``fast_norm`` RMSNorm, in float32."""
    rcfg, rmodel, params, port = pair("yi-6b", dtype="float32", **change)
    toks = tokens(rcfg.vocab_size)
    want, _ = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = port.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=F32_ATOL)


def test_load_state_dict_refreshes_the_cast_copy():
    """The model holds each matrix once, cast to ``cfg.dtype`` (bfloat16),
    and the norms' scales in ``cfg.param_dtype``: loading another model's
    state, in float32, casts into those and serves that model's logits."""
    cfg = get_config("smollm-360m", smoke=True)
    a = Model(cfg, seed=0, device="cpu")
    b = Model(cfg, seed=1, device="cpu")
    toks = {"tokens": torch.from_numpy(tokens(cfg.vocab_size))}
    a.load_state_dict({k: v.float() for k, v in b.state_dict().items()})
    for name, p in a.named_parameters():
        want = torch.float32 if ".ln" in name or "norm" in name \
            else torch.bfloat16
        assert p.dtype == want, name
    assert torch.equal(a.forward(toks)[0], b.forward(toks)[0])


def test_model_runs_on_the_card_unless_asked_for_the_cpu():
    """``Model``, ``init_params`` and ``Initializer`` default to the card
    and raise without one, as the port's other entry points do."""
    cfg = get_config("smollm-360m", smoke=True)
    if torch.cuda.is_available():
        assert Model(cfg).embed.device.type == "cuda"
        assert init_params(cfg)["embed"].device.type == "cuda"
        assert common.Initializer(cfg).device.type == "cuda"
        return
    for build in (Model, init_params, common.Initializer):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(cfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_decodes_on_the_cpu(arch):
    """Every architecture builds on the CPU from its own init and takes one
    ``decode_step``, fed a token or, for the audio model, an embedding:
    finite logits of the vocabulary's width, and the step writes the
    cache."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    cache = model.init_cache(2, 4)
    before = [t.clone() for t in jax.tree.leaves(cache)]
    rng = np.random.default_rng(0)
    batch = ({"embeds": torch.from_numpy(rng.normal(size=(
        2, 1, cfg.d_model)).astype(np.float32))} if cfg.embedding_inputs
        else {"tokens": torch.from_numpy(tokens(cfg.vocab_size, S=1))})
    logits, cache = model.decode_step(cache, batch, 0)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, jax.tree.leaves(cache)))


def test_unknown_block_pattern_raises():
    cfg = get_config("yi-6b", smoke=True).replace(block_pattern="mamba2")
    with pytest.raises(ValueError, match="block_pattern"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_configs_are_the_references(smoke):
    for arch in ARCH_IDS:
        want = dataclasses.asdict(ref_config(arch, smoke=smoke))
        assert dataclasses.asdict(get_config(arch, smoke=smoke)) == want


@pytest.mark.parametrize("arch", DENSE)
def test_init_has_the_references_tree_kinds_and_scales(arch):
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes, norms at one, and the reference's scales (a stacked
    leaf takes its fan-in from the layer axis, as the reference's does)."""
    cfg = get_config(arch, smoke=True)
    ref = port_params(arch)
    mine = init_params(cfg, seed=0, device="cpu")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    a, b = dict(leaves(mine)), dict(leaves(ref))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if "ln" in k or "norm" in k:
            assert torch.equal(a[k], torch.ones_like(a[k])), k
    L = cfg.num_layers
    wq = torch.stack([blk["attn"]["wq"] for blk in mine["blocks"]])
    assert abs(float(wq.std()) * L ** 0.5 - 1.0) < 0.05
    assert abs(float(mine["embed"].std()) / 0.02 - 1.0) < 0.05
    assert common.param_count(mine) == common.param_count(ref)
    half = common.cast(mine, torch.bfloat16)
    assert half["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert common.param_count(half) == common.param_count(mine)
    # the model's own draw: the same numbers, each matrix cast once
    model = Model(cfg, device="cpu", seed=0)
    assert torch.equal(model.blocks[0]["attn"]["wq"], mine["blocks"][0]
                       ["attn"]["wq"].to(cfg.cdtype))
    assert model.blocks[0]["ln1"]["scale"].dtype == cfg.pdtype
