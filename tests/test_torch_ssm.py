"""The port's SSM and hybrid family against the reference, on the CPU:
``rwkv6-3b`` (RWKV6 "Finch": time mix and channel mix over the vector-decay
recurrence) and ``zamba2-2.7b`` (groups of Mamba2 layers over the
scalar-decay recurrence, each group followed by one shared attention
block), at their SMOKE configs, one intra-op thread.

* ``repro_torch.models.gla``: the chunked forms against the port's own
  scan oracle at rtol = atol = 2e-4, as ``tests/test_gla.py`` holds the
  reference's (ragged lengths among the cases), strong decay, the state
  carried across two halves; and each GLA function against the
  reference's on the same numpy inputs;
* ``mamba2_layer``, ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` against
  the reference's, forward and with a state: in float32 within
  ``F32_ATOL``; in bfloat16 op by op, the products summed in the
  reference's order (``_model_reference.xla_products``), within one
  bfloat16 spacing at the output's scale (the reference's float32 ``exp``,
  ``tanh`` and ``log1p`` are XLA's own approximations, a float32 ulp or so
  from torch's, which can move a bfloat16 rounding that sits at a
  midpoint);
* whole models in float32, forward and teacher-forced decode, within
  ``F32_ATOL``, the caches compared leaf by leaf;
* the init tree's kinds and scales (zamba2's fan-in from its (G, M)
  stack's first axis, G) and the converter's round trip.

A recurrent state is a float32 sum whose entries reach hundreds or
thousands (an SSM state of the SMOKE zamba2 about 4300 after 8 tokens):
state leaves are held within ``F32_ATOL`` at the leaf's scale, max(1,
max|leaf|) · ``F32_ATOL``.
"""
import contextlib
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gla as ref_gla
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import common, convert, gla, ssm
from repro_torch.models.transformer import Model, init_params

from _model_cases import EPS_BF16, F32_ATOL
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)
from _model_reference import (SSM, port_params, ref_model, ref_params,
                              ref_step, xla_products)

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


def state_atol(ref_leaf) -> float:
    """``F32_ATOL`` at a state leaf's scale (the module docstring)."""
    return F32_ATOL * max(1.0, float(np.abs(f32(ref_leaf)).max()))


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
# gla: the chunked forms, the step, the scan oracle
# ---------------------------------------------------------------------------

def gla_inputs(seed, B, S, H, dk, dv, vector):
    """q, k, v, log-decay g (< 0; per channel when ``vector``), bonus u and
    an initial state, float32 numpy, as ``tests/test_gla.py`` draws them
    (g = -softplus(normal) - 1e-3, u = 0.5 normal)."""
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(2, B, S, H, dk))
    v = rng.normal(size=(B, S, H, dv))
    z = rng.normal(size=(B, S, H, dk) if vector else (B, S, H))
    g = -np.logaddexp(z, 0.0) - 1e-3
    u = rng.normal(size=(H, dk)) * 0.5
    s0 = rng.normal(size=(B, H, dk, dv))
    return tuple(np.asarray(a, np.float32) for a in (q, k, v, g, u, s0))


def torch_args(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def chunked(vector, q, k, v, g, u, chunk, init_state=None):
    if vector:
        return gla.gla_chunked_vector(q, k, v, g, u, chunk=chunk,
                                      init_state=init_state)
    return gla.gla_chunked_scalar(q, k, v, g, chunk=chunk,
                                  init_state=init_state)


def oracle(vector, q, k, v, g, u, init_state=None):
    if vector:
        return gla.gla_scan_ref(q, k, v, g, inclusive=False, u=u,
                                init_state=init_state)
    return gla.gla_scan_ref(q, k, v, g, inclusive=True,
                            init_state=init_state)


@pytest.mark.parametrize("vector, S, chunk", [
    (False, 32, 8), (False, 48, 32), (False, 20, 8),
    (True, 16, 4), (True, 48, 16), (True, 20, 8)],
    ids=["scalar-32-8", "scalar-48-32", "scalar-ragged-20-8",
         "vector-16-4", "vector-48-16", "vector-ragged-20-8"])
def test_chunked_matches_scan_oracle(vector, S, chunk):
    q, k, v, g, u, _ = torch_args(*gla_inputs(S + chunk, 2, S, 2, 8, 8,
                                              vector))
    y_ref, s_ref = oracle(vector, q, k, v, g, u)
    y, s = chunked(vector, q, k, v, g, u, chunk)
    assert y.shape == (2, S, 2, 8) and s.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(y_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(s), f32(s_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_strong_decay_is_stable(vector):
    """Near-hard decays (g = -7.9, about e^-8 a step) neither overflow nor
    lose the oracle (the clipped exponents)."""
    q, k, v, _, u, _ = torch_args(*gla_inputs(0, 1, 64, 1, 4, 4, vector))
    g = torch.full((1, 64, 1, 4) if vector else (1, 64, 1), -7.9)
    y, s = chunked(vector, q, k, v, g, u, 16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_ref, _ = oracle(vector, q, k, v, g, u)
    np.testing.assert_allclose(f32(y), f32(y_ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_state_carry_composes(vector):
    """Two half sequences with the state carried equal one whole run."""
    q, k, v, g, u, _ = torch_args(*gla_inputs(5, 1, 32, 2, 8, 8, vector))
    y_full, s_full = chunked(vector, q, k, v, g, u, 8)
    y1, s1 = chunked(vector, q[:, :16], k[:, :16], v[:, :16], g[:, :16], u, 8)
    y2, s2 = chunked(vector, q[:, 16:], k[:, 16:], v[:, 16:], g[:, 16:], u, 8,
                     init_state=s1)
    np.testing.assert_allclose(f32(torch.cat([y1, y2], 1)), f32(y_full),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(s2), f32(s_full), rtol=2e-4, atol=2e-4)


GLA_FUNCTIONS = ["scan-inclusive", "scan-exclusive-bonus", "chunked-scalar",
                 "chunked-scalar-ragged", "chunked-vector",
                 "chunked-vector-ragged", "step-inclusive",
                 "step-exclusive-bonus"]


def run_gla(lib, case, q, k, v, g, u, s0):
    """One GLA function of ``lib`` (the reference's module or the port's)
    on one case's inputs, from the initial state ``s0``."""
    if case == "scan-inclusive":
        return lib.gla_scan_ref(q, k, v, g, inclusive=True, init_state=s0)
    if case == "scan-exclusive-bonus":
        return lib.gla_scan_ref(q, k, v, g, inclusive=False, u=u,
                                init_state=s0)
    if case.startswith("chunked-scalar"):
        return lib.gla_chunked_scalar(q, k, v, g, chunk=8, init_state=s0)
    if case.startswith("chunked-vector"):
        return lib.gla_chunked_vector(q, k, v, g, u, chunk=8, init_state=s0)
    inclusive = case == "step-inclusive"
    return lib.gla_step(s0, q[:, 0], k[:, 0], v[:, 0], g[:, 0],
                        inclusive=inclusive, u=None if inclusive else u)


@pytest.mark.parametrize("case", GLA_FUNCTIONS)
def test_gla_function_matches_reference(case):
    """The same numpy inputs through the reference's function and the
    port's: outputs and final states within ``F32_ATOL`` at their scale."""
    vector = "bonus" in case or "vector" in case
    S = 20 if "ragged" in case else (1 if case.startswith("step") else 24)
    args = gla_inputs(11, 2, S, 2, 8, 8, vector)
    want_y, want_s = run_gla(ref_gla, case, *(jnp.asarray(a) for a in args))
    got_y, got_s = run_gla(gla, case, *torch_args(*args))
    assert got_s.dtype == torch.float32 and got_y.shape == want_y.shape
    np.testing.assert_allclose(f32(got_y), f32(want_y), rtol=0,
                               atol=state_atol(want_y))
    np.testing.assert_allclose(f32(got_s), f32(want_s), rtol=0,
                               atol=state_atol(want_s))


# ---------------------------------------------------------------------------
# the layers, float32 and bfloat16 op by op
# ---------------------------------------------------------------------------

# layer: (arch, the block's part, the function's name, its state leaves)
LAYERS = {"mamba2": ("zamba2-2.7b", "mamba", "mamba2_layer",
                     ("conv", "ssm")),
          "time-mix": ("rwkv6-3b", "tm", "rwkv6_time_mix",
                       ("tm_shift", "wkv")),
          "channel-mix": ("rwkv6-3b", "cm", "rwkv6_channel_mix",
                          ("cm_shift",))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", ["forward", "state"])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_matches_reference(layer, phase, dtype):
    """One layer of the first block (zamba2: of the first group), the
    reference's run op by op, at 8 tokens (``forward``: no state, the
    chunked form) or one token from a random state (``state``:
    ``gla_step``; the new state compared too). float32 within ``F32_ATOL``;
    bfloat16 with the products in the reference's order, within one
    bfloat16 spacing at the output's scale (the module docstring)."""
    arch, part, name, leaves = LAYERS[layer]
    rcfg, _, params, port = pair(arch, dtype=dtype)
    cfg = port.cfg
    ref_p = jax.tree.map(lambda a: a.reshape(-1, *a.shape[
        2 if arch == "zamba2-2.7b" else 1:])[0], params["blocks"][part])
    rng = np.random.default_rng(2)
    S = 8 if phase == "forward" else 1
    x = rng.normal(size=(2, S, cfg.d_model))
    xt = torch.from_numpy(x).to(cfg.cdtype)
    xj = jnp.asarray(f32(xt)).astype(rcfg.cdtype)
    state = ref_state = None
    if phase == "state":
        init = (ssm.mamba2_state if arch == "zamba2-2.7b"
                else ssm.rwkv6_state)(cfg, 2)
        state = {k: torch.from_numpy(rng.normal(size=init[k].shape)).to(
            init[k].dtype) for k in leaves}
        ref_state = {k: jnp.asarray(f32(v)).astype(
            jnp.float32 if v.dtype == torch.float32 else rcfg.cdtype)
            for k, v in state.items()}
    want, want_state = getattr(ref_ssm, name)(ref_p, xj, rcfg,
                                              state=ref_state)
    products = (xla_products() if dtype == "bfloat16"
                else contextlib.nullcontext())
    with products:
        got, got_state = getattr(ssm, name)(port.blocks[0][part], xt, cfg,
                                            state=state)
    assert got.dtype == cfg.cdtype and got.shape == want.shape
    atol = (F32_ATOL if dtype == "float32"
            else EPS_BF16 * float(np.abs(f32(want)).max()))
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=atol)
    assert (got_state is None) == (phase == "forward")
    if got_state is not None:
        assert sorted(got_state) == sorted(want_state)
        for k, w in want_state.items():
            assert got_state[k].dtype == state[k].dtype, k
            np.testing.assert_allclose(f32(got_state[k]), f32(w), rtol=0,
                                       atol=state_atol(w), err_msg=k)


# ---------------------------------------------------------------------------
# whole models, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM)
def test_forward_logits_match_reference(arch):
    rcfg, rmodel, params, port = pair(arch, dtype="float32")
    toks = tokens(rcfg.vocab_size)
    want, want_aux = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=F32_ATOL)


def cache_leaves(rcache, cache):
    """(path, the reference's leaf, the port's) for every leaf of the
    reference's cache; the two trees must have one structure."""
    assert jax.tree.structure(jax.tree.map(np.asarray, rcache)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), cache))
    for path, ref_leaf in jax.tree_util.tree_leaves_with_path(rcache):
        leaf = cache
        for key in path:
            leaf = leaf[key.key]
        yield jax.tree_util.keystr(path), ref_leaf, leaf


@pytest.mark.parametrize("arch", SSM)
def test_teacher_forced_decode_matches_reference(arch):
    """``decode_step`` fed the same tokens one position at a time against
    the reference's jitted step: logits at every position within
    ``F32_ATOL``, and every cache leaf (shifts, conv and recurrent states,
    the shared block's k and v) of the reference's shape and dtype, within
    ``F32_ATOL`` at its scale."""
    rcfg, rmodel, params, port = pair(arch, dtype="float32")
    toks = tokens(rcfg.vocab_size)
    B, S = toks.shape
    rcache, _ = rmodel.init_cache(B, CACHE_LEN)
    cache = port.init_cache(B, CACHE_LEN)
    for path, ref_leaf, leaf in cache_leaves(rcache, cache):
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert str(leaf.dtype).split(".")[1] == str(ref_leaf.dtype), path
    step = ref_step(arch, (("dtype", "float32"),))
    want, got = [], []
    for t in range(S):
        w, rcache = step(params, rcache, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, t)
        g, cache = port.decode_step(cache, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, t)
        want.append(f32(w))
        got.append(f32(g))
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(want, 1), rtol=0, atol=F32_ATOL)
    for path, ref_leaf, leaf in cache_leaves(rcache, cache):
        np.testing.assert_allclose(f32(leaf), f32(ref_leaf), rtol=0,
                                   atol=state_atol(ref_leaf), err_msg=path)


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


# the leaves the model keeps in cfg.param_dtype (transformer._KEPT, _NORMS)
KEPT = ("/ln/", "/ln1/", "/ln2/", "norm", "/w0", "/decay_w1", "/decay_w2",
        "/u", "/ln_scale", "/a_log", "/dt_bias")


@pytest.mark.parametrize("arch", SSM)
def test_init_has_the_references_tree_kinds_and_scales(arch):
    """The port's own init draws the reference's tree (zamba2's
    ``shared_attn`` among it): the same leaves, shapes and dtypes, the
    ones and zeros where the reference has them, and its scales: a stacked
    leaf takes its fan-in from its stack's first axis, L for rwkv6 and G
    (not M, not G * M) for zamba2. Drawn in bfloat16, the kept leaves stay
    float32."""
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

    def std(name):
        return float(torch.stack([v for k, v in a.items()
                                  if k.endswith(name) and "/blocks/" in k])
                     .std())

    if arch == "rwkv6-3b":
        L = cfg.num_layers
        assert abs(std("/tm/wr") * L ** 0.5 - 1.0) < 0.05
        assert abs(std("/cm/wv") * cfg.d_ff ** 0.5 - 1.0) < 0.05
        assert abs(std("/tm/mix_w2") / 0.02 - 1.0) < 0.05
        # uniform on [-s, s]: std s / sqrt(3)
        assert abs(std("/tm/u") * 3 ** 0.5 / 0.5 - 1.0) < 0.05
        assert abs(std("/tm/w0") * 3 ** 0.5 - 1.0) < 0.05
    else:
        G = cfg.num_layers // cfg.shared_attn_every
        assert abs(std("/mamba/in_proj") * G ** 0.5 - 1.0) < 0.05
        assert abs(std("/mamba/conv_w") * cfg.conv_kernel ** 0.5 - 1.0) < 0.1
        d_inner = ssm.mamba2_dims(cfg)[0]
        assert abs(std("/mamba/out_proj") * d_inner ** 0.5 - 1.0) < 0.05
        wq = mine["shared_attn"]["attn"]["wq"]
        assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert common.param_count(mine) == common.param_count(port_params(arch))
    # drawn in bfloat16: the kept leaves and the constant ones (ones,
    # zeros) come in cfg.pdtype, the other drawn leaves in bfloat16
    half = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for k, w in _leaves(half):
        want = (torch.float32 if k in constant or any(s in k for s in KEPT)
                else torch.bfloat16)
        assert w.dtype == want, k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", SSM)
def test_converter_round_trip(arch, dtype):
    """The reference's tree -> ``convert.from_reference`` -> ``Model`` ->
    ``Model.params()`` returns the reference's leaves: those the model
    keeps in float32 (norms, the decay path, the bonus; moved off their
    init values here so that a bfloat16 rounding would show) bit for bit,
    the matrices cast once to the compute dtype."""
    rng = np.random.default_rng(5)
    ref = jax.tree.map(np.array, ref_params(arch))
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
    assert len(want) == len(list(_leaves(ref))) + sum(
        (cfg.num_layers - 1) * len(list(_leaves(ref["blocks"][p])))
        for p in ref["blocks"])
    for k, w in want.items():
        keep = any(s in k for s in KEPT)
        assert back[k].dtype == (w.dtype if keep else cfg.cdtype), k
        assert torch.equal(back[k], w if keep else w.to(cfg.cdtype)), k


def test_unstack_takes_the_group_axes_and_the_converter_checks_them():
    """``unstack`` over (G, M) lists the G * M layers in order; the
    converter refuses a zamba2 tree whose groups do not make the config's
    layers, and a part no model has."""
    t = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    parts = common.unstack({"w": t}, (2, 3))
    assert [int(p["w"][0]) for p in parts] == [0, 4, 8, 12, 16, 20]
    with pytest.raises(ValueError, match="leading axes"):
        common.unstack({"w": t}, (3, 2))
    ref = jax.tree.map(np.array, ref_params("zamba2-2.7b"))
    with pytest.raises(ValueError, match="groups"):
        convert.from_reference(ref, 6)
    with pytest.raises(NotImplementedError, match="vision_tower"):
        convert.from_reference({**ref, "vision_tower": {}}, 4)
