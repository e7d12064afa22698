"""The port's model sharded over a (data, model) mesh at run time
(``Model(cfg, mesh=...)``, ``models/transformer.py``) against the
reference's under the same mesh, on the CPU.

The reference's numbers come from one subprocess with 8 placeholder
devices (``tests/_sharded_reference.py``), written to an ``.npz`` with its
parameters, which ``models/convert.py`` carries across. The port runs on
``DeviceMesh``es of ``cpu`` entries. Cases: ``olmoe-1b-7b`` SMOKE in
float32 at ``capacity_factor=1.0`` (assignments drop, and which drop
depends on the mesh: each data shard routes its own tokens with a
capacity from its own count), batch 4 x 16, on (1, 1), (2, 1), (1, 4),
(2, 4) and (2, 4) with ``moe_sp_dispatch``; ``yi-6b`` SMOKE with
``seq_parallel`` and ``fast_norm`` on (2, 4) (q by head, k and v
replicated); ``smollm-360m`` SMOKE on (2, 4) (attention replicated, tied
vocabulary shards, a cache by position).

* the loss within 2e-5, the logits and the load-balance loss within
  ``F32_ATOL``, every gradient leaf within ``grad_tolerance(L)``, and on
  (2, 4) the logits of 4 decode steps within ``F32_ATOL``;
* the one-device program lies more than 100 x the loss tolerance from the
  reference's (2, 4) losses, so a port that ignored the mesh would fail;
* the bytes of each collective kind equal the formulas of ``expected``;
  an entry's block of a leaf shares the parameter's storage;
* ``mesh=None`` and meshes of size-1 axes give the one-device numbers bit
  for bit and move nothing;
* a batch that the data axes do not divide raises under MoE (a stage
  axis beside a model axis is ``tests/test_torch_pipeline.py``'s);
* ``serve(mesh=)`` gives the reference's greedy tokens on its (2, 4) mesh,
  and ``train(mesh=)`` the one-device losses;
* a mesh of two device names (``cpu`` and ``cpu:0``, between which torch
  copies) gives the numbers and bytes of a mesh of one;
* ``DeviceMesh``'s collectives: values, byte counts, gradients, the fixed
  float32 summation order of a bfloat16 all-reduce.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import convert
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten, leaves

import _sharded_reference as ref_cases
from _model_cases import F32_ATOL, grad_error, grad_tolerance
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = ref_cases.B, ref_cases.S
CASES = {case: (arch, changes, shape)
         for case, arch, changes, shape in ref_cases.CASES}
LOSS_TOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's records (``tests/_sharded_reference.py``), computed
    once in a subprocess with 8 placeholder devices."""
    out = tmp_path_factory.mktemp("sharded") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_sharded_reference.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


def _tree(ref, prefix):
    """The nested dicts of the records under ``prefix``."""
    out = {}
    for key, value in ref.items():
        if key.startswith(prefix + "/"):
            node, *path = out, *key[len(prefix) + 1:].split("/")
            *inner, last = path
            for p in inner:
                node = node.setdefault(p, {})
            node[last] = value
    return out


def mesh(shape, names=("data", "model")):
    return DeviceMesh(np.full(shape, CPU, dtype=object), names)


def config(case):
    arch, changes, _ = CASES[case]
    return get_config(arch, smoke=True).replace(**changes)


def params(ref, case):
    cfg = config(case)
    return convert.from_reference(_tree(ref, f"{CASES[case][0]}/params"),
                                  cfg.num_layers)


def batch(cfg):
    return {k: torch.as_tensor(v)
            for k, v in ref_cases.batch_for(cfg.vocab_size).items()}


@pytest.fixture(scope="module")
def port(ref):
    """The port's (loss, aux, logits, {path: gradient}) of each case on
    its mesh, computed once a case."""
    done = {}

    def run(case):
        if case not in done:
            cfg = config(case)
            model = Model(cfg, device="cpu", params=params(ref, case),
                          trainable=True, mesh=mesh(CASES[case][2]))
            loss, metrics = model.loss(batch(cfg))
            grads = torch.autograd.grad(loss, leaves(model.params()))
            with torch.no_grad():
                logits, _ = model(batch(cfg))
            names = [k for k, _ in flatten(model.params())]
            done[case] = (float(loss.detach()), float(metrics["aux"]),
                          logits, dict(zip(names, grads)))
        return done[case]
    return run


@pytest.mark.parametrize("case", list(CASES))
def test_loss_logits_aux_match_reference(case, ref, port):
    loss, aux, logits, _ = port(case)
    assert abs(loss - float(ref[f"{case}/loss"])) <= LOSS_TOL, \
        (loss, float(ref[f"{case}/loss"]))
    assert abs(aux - float(ref[f"{case}/aux"])) <= F32_ATOL
    err = float((logits - torch.as_tensor(ref[f"{case}/logits"])).abs()
                .max())
    assert err <= F32_ATOL, err


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(case, ref, port):
    cfg = config(case)
    want = dict(flatten(convert.from_reference(_tree(ref, f"{case}/grad"),
                                               cfg.num_layers)))
    grads = port(case)[3]
    assert set(grads) == set(want)
    tol = grad_tolerance(cfg.num_layers)
    errs = {k: grad_error(g, torch.as_tensor(want[k]))
            for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst], tol)


@pytest.mark.parametrize("case", ["olmoe-2x4", "olmoe-2x4-sp"])
def test_one_device_cannot_pass_for_the_mesh(case, ref, port):
    """The one-device loss (the (1, 1) mesh's) parts from the reference's
    (2, 4) loss by far more than the loss tolerance: a port that ran
    unsharded under the mesh would fail ``test_loss_logits_aux_match``."""
    one = port("olmoe-1x1")[0]
    assert abs(one - float(ref[f"{case}/loss"])) > 100 * LOSS_TOL


def expected(case, cfg):
    """The bytes of each collective kind in one no-grad forward of batch B
    x S in float32 on the case's (D, M) mesh, in the reference's
    convention (every participant's output bytes). ``act``: every
    entry's copy of its data row's (B / D, S, d) activations, M times the
    batch's; ``logits``: the same of the (B / D, S, V) logits. The
    embedding lookup by vocabulary shard is one all-reduce of ``act``;
    a row-parallel sublayer (attention with q by head, an MLP by hidden
    unit) one all-reduce of ``act``, or under the sequence-parallel
    residual a reduce-scatter of ``act`` / M after an all-gather of its
    input slices (``act``); replicated attention moves nothing; the MoE
    layer two all-to-alls of every entry's (E, cap, d) slot buffer (cap
    from its own token count) and the pmean of its loss over data and
    model (2 D M scalars); under ``moe_sp_dispatch`` without the
    sequence-parallel residual, an all-gather of its outputs' slices
    (``act``); the logits one all-gather over model (``logits``)."""
    D, M = CASES[case][2]
    L, d, f32 = cfg.num_layers, cfg.d_model, 4
    act = M * B * S * d * f32
    logits = M * B * S * cfg.vocab_size * f32
    if case.startswith("olmoe"):
        sp = cfg.moe_sp_dispatch
        cap = capacity(B // D * (S // M if sp else S), cfg)
        slots = D * M * cfg.num_experts * cap * d * f32
        return {"all-reduce": act * (1 + L) + L * 2 * D * M * f32,
                "all-to-all": L * 2 * slots,
                "all-gather": logits + (L * act if sp else 0)}
    if case.startswith("yi"):
        return {"all-reduce": act, "reduce-scatter": L * 2 * act // M,
                "all-gather": L * 2 * act + act + logits}
    return {"all-reduce": act * (1 + L), "all-gather": logits}


@pytest.mark.parametrize("case", ["olmoe-2x4", "olmoe-2x4-sp", "yi-2x4-sp",
                                  "smollm-2x4"])
def test_hop_bytes_match_formula(case, ref):
    cfg = config(case)
    m = mesh(CASES[case][2])
    model = Model(cfg, device="cpu", params=params(ref, case), mesh=m)
    with torch.no_grad():
        model(batch(cfg))
    assert m.hops == expected(case, cfg)


@pytest.mark.parametrize("case", ["olmoe-2x4", "smollm-2x4"])
def test_decode_matches_reference(case, ref):
    """4 decode steps on (2, 4): ``olmoe-1b-7b``'s cache by kv head,
    ``smollm-360m``'s (1 kv head) by position, all-gathered before the
    scores; the bytes of each step by the formula of ``expected`` at S =
    1, and for the position-sharded cache its k and v all-gathered in
    every layer."""
    cfg = config(case)
    m = mesh(CASES[case][2])
    model = Model(cfg, device="cpu", params=params(ref, case), mesh=m)
    toks = batch(cfg)["tokens"]
    cache = model.init_cache(B, S)
    out = []
    for t in range(ref_cases.DECODE):
        logits, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1]},
                                          t)
        out.append(logits[:, 0])
    err = float((torch.stack(out, 1) - torch.as_tensor(
        ref[f"{case}/decode"])).abs().max())
    assert err <= F32_ATOL, err
    D, M = CASES[case][2]
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    act, f32 = M * B * d * 4, 4
    if case.startswith("olmoe"):
        cap = capacity(B // D, cfg)
        step = {"all-reduce": act * (1 + L) + L * 2 * D * M * f32,
                "all-to-all": L * 2 * D * M * cfg.num_experts * cap * d * f32,
                "all-gather": M * B * V * f32}
    else:
        kv = M * B * S * cfg.num_kv_heads * cfg.head_dim * f32
        step = {"all-reduce": act * (1 + L),
                "all-gather": M * B * V * f32 + L * 2 * kv}
    assert m.hops == {k: ref_cases.DECODE * v for k, v in step.items()}


@pytest.mark.parametrize("arch,shape", [
    ("granite-20b", (2, 4)), ("phi3-mini-3.8b", (1, 4)),
    ("musicgen-large", (2, 2))])
def test_other_archs_on_a_mesh_match_one_device(arch, shape):
    """The rest of the sharded program's scope, held against the port's
    one-device program (which the model tests hold against the
    reference) in float32: ``granite-20b`` (one kv head: q by head, each
    rank reading kv head 0, the cache by position), ``phi3-mini-3.8b`` (k
    and v by head) and ``musicgen-large`` (fed embeddings, no embedding
    table): the logits and loss of a batch, and 3 decode steps."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tree = Model(cfg, device="cpu").params()
    rng = np.random.default_rng(3)
    if cfg.embedding_inputs:
        b = {"embeds": torch.as_tensor(rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32))}
        feed = [{"embeds": b["embeds"][:, t:t + 1]} for t in range(3)]
    else:
        b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S)))}
        feed = [{"tokens": b["tokens"][:, t:t + 1]} for t in range(3)]
    b["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))

    def run(m):
        model = Model(cfg, device="cpu", params=tree, mesh=m)
        logits, _ = model(b)
        loss, _ = model.loss(b)
        cache = model.init_cache(B, S)
        steps = [model.decode_step(cache, f, t)[0]
                 for t, f in enumerate(feed)]
        return [logits, loss, *steps]

    m = mesh(shape)
    for got, want in zip(run(m), run(None)):
        assert float((got - want).abs().max()) <= F32_ATOL
    assert m.hops


def test_shards_are_views_of_the_parameters(ref):
    """On one device an entry's block of a leaf is a view of the model's
    parameter (a replicated leaf the parameter itself): no parameter is
    copied for each entry, and the gradients of the sharded loss reach
    every parameter."""
    case = "olmoe-2x4"
    cfg = config(case)
    for trainable in (False, True):
        model = Model(cfg, device="cpu", params=params(ref, case),
                      trainable=trainable, mesh=mesh((2, 4)))
        own = dict(flatten(model.params()))
        for row in model._parts():
            for part in row:
                for path, x in flatten(part):
                    p = own[path]
                    assert x.untyped_storage().data_ptr() == \
                        p.untyped_storage().data_ptr(), path
                    if x.shape == p.shape:
                        assert x is p, path
        assert len(list(model.parameters())) == len(own)
    loss, _ = model.loss(batch(cfg))
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "smollm-360m"])
def test_no_mesh_and_size_one_meshes_are_the_one_device_program(arch):
    """``mesh=None``, (1, 1) and (1, 1, 1) with a pod axis: the same
    logits, loss and decode steps bit for bit (bfloat16, the configs'
    own dtype), and nothing moved."""
    cfg = get_config(arch, smoke=True)
    tree = Model(cfg, device="cpu").params()
    b = batch(cfg)

    def run(m):
        model = Model(cfg, device="cpu", params=tree, mesh=m)
        logits, aux = model(b)
        loss, _ = model.loss(b)
        cache = model.init_cache(B, S)
        steps = [model.decode_step(cache, {"tokens": b["tokens"][:, t:t + 1]},
                                   t)[0] for t in range(3)]
        return [logits, aux, loss, *steps]

    want = run(None)
    for m in (mesh((1, 1)), mesh((1, 1, 1), ("pod", "data", "model"))):
        got = run(m)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        assert m.hops == {}


def test_batch_the_data_axes_do_not_divide(ref):
    """Under MoE a batch of 3 on 2 data shards raises, as the reference's
    ``shard_map`` does; a dense model replicates it over the data shards
    and gives the one-device logits."""
    cfg = config("olmoe-2x4")
    moe = Model(cfg, device="cpu", params=params(ref, "olmoe-2x4"),
                mesh=mesh((2, 4)))
    with pytest.raises(ValueError, match="does not split"):
        moe({"tokens": batch(cfg)["tokens"][:3]})
    cfg = config("smollm-2x4")
    tree = params(ref, "smollm-2x4")
    toks = {"tokens": batch(cfg)["tokens"][:3]}
    want, _ = Model(cfg, device="cpu", params=tree)(toks)
    got, _ = Model(cfg, device="cpu", params=tree, mesh=mesh((2, 4)))(toks)
    assert float((got - want).abs().max()) <= F32_ATOL


def test_serve_on_a_mesh_matches_reference(ref, monkeypatch):
    """``serve(mesh=)``: ``olmoe-1b-7b`` SMOKE in float32 on (2, 4) gives
    the reference's greedy tokens from its (2, 4) mesh."""
    import repro_torch.launch.serve_model as serving
    get = serving.get_config
    monkeypatch.setattr(serving, "get_config", lambda a, smoke=False: get(
        a, smoke).replace(dtype="float32"))
    got = serving.serve("olmoe-1b-7b", smoke=True, batch=4, prompt_len=8,
                        gen_tokens=8, params=params(ref, "olmoe-2x4"),
                        quiet=True, mesh=mesh((2, 4)))["tokens"]
    np.testing.assert_array_equal(got, ref["serve/tokens"])


def test_train_on_a_mesh_matches_one_device():
    """``train(mesh=)``: 3 steps of ``yi-6b`` SMOKE in float32 on (2, 4),
    batch 2 x 16 (``tests/test_torch_train.py``'s trainer shape), the
    losses of the one-device ``train()`` within ``F32_ATOL``. (At 4 x 32
    this trajectory is ill-conditioned by the third step: AdamW's
    normalised update turns float32 sum-order differences in near-zero
    gradients into whole steps, and a relative 1e-6 change of the
    one-device weights alone moves the third loss by 6e-4.)"""
    from repro_torch.launch.train import train
    kw = dict(arch="yi-6b", steps=3, batch=2, seq=16, quiet=True,
              config_overrides={"dtype": "float32"})
    want = train(device="cpu", **kw)["losses"]
    got = train(mesh=mesh((2, 4)), **kw)["losses"]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_entries_on_two_devices():
    """A (2, 4) mesh whose odd model ranks are ``cpu:0`` and the rest
    ``cpu`` (torch copies between the two names as between two devices):
    the entries' blocks are copies, the collectives move their tensors
    between the two, the cache parts are copied there and written back,
    and the remat'd layers rerun in one autograd node
    (``transformer._Rerun``). ``olmoe-1b-7b`` SMOKE in float64 against the
    mesh of ``cpu`` alone: the loss, every gradient leaf and the logits of
    4 decode steps within 1e-12 of each one's largest, the greedy tokens
    and the bytes moved equal."""
    from repro_torch.launch.mesh import make_mesh_for
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(
        dtype="float64", param_dtype="float64")
    tree = Model(cfg, device="cpu").params()
    b = batch(cfg)
    runs = []
    for names in (["cpu"] * 8, [("cpu:0" if j % 2 else "cpu")
                                for _ in range(2) for j in range(4)]):
        m = make_mesh_for(names, model_parallel=4)
        model = Model(cfg, device="cpu", params=tree, trainable=True, mesh=m)
        loss, _ = model.loss(b)
        grads = torch.autograd.grad(loss, leaves(model.params()))
        serving = Model(cfg, device="cpu", params=tree, mesh=m)
        cache = serving.init_cache(B, S)
        toks, out = b["tokens"][:, :1], []
        for t in range(4):
            logits, cache = serving.decode_step(cache, {"tokens": toks}, t)
            out.append(logits)
            toks = logits[:, -1].argmax(-1, keepdim=True)
        runs.append((loss.detach(), grads, torch.cat(out, 1), dict(m.hops)))
    (l0, g0, o0, h0), (l1, g1, o1, h1) = runs

    def close(a, b):
        return float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert close(l1, l0) and close(o1, o0)
    assert all(close(x, y) for x, y in zip(g1, g0))
    assert torch.equal(o1.argmax(-1), o0.argmax(-1))
    assert h1 == h0


# --- DeviceMesh's collectives ---------------------------------------------

N = 4


def _inputs(shape=(N, 2, 3), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_()
            for _ in range(N)]


def _want(kind, xs):
    total = sum(x.detach() for x in xs)
    if kind == "all_reduce":
        return [total] * N
    if kind == "pmean":
        return [total / N] * N
    if kind == "all_gather":
        return [torch.cat([x.detach() for x in xs], 1)] * N
    if kind == "reduce_scatter":
        return list(total.chunk(N, 0))
    return [torch.cat([x.detach().chunk(N, 0)[j] for x in xs], 1)
            for j in range(N)]


CALLS = {
    "all_reduce": (lambda m, xs: m.all_reduce(xs, "model"), "all-reduce"),
    "pmean": (lambda m, xs: m.pmean(xs, "model"), "all-reduce"),
    "all_gather": (lambda m, xs: m.all_gather(xs, "model", 1), "all-gather"),
    "reduce_scatter": (lambda m, xs: m.reduce_scatter(xs, "model", 0),
                       "reduce-scatter"),
    "all_to_all": (lambda m, xs: m.all_to_all(xs, "model", 0, 1),
                   "all-to-all"),
}


@pytest.mark.parametrize("kind", list(CALLS))
def test_collective_values_bytes_and_gradients(kind):
    """Each collective's outputs (one a model rank, each its own tensor),
    the bytes counted (every output's), the gradient of a weighted sum of
    the outputs, and an axis of size 1 passing its inputs through with
    nothing counted."""
    call, name = CALLS[kind]
    m = DeviceMesh(np.full((2, N), CPU, dtype=object), ("data", "model"))
    xs = _inputs()
    outs = call(m, xs)
    for got, want in zip(outs, _want(kind, xs)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert len({o.data_ptr() for o in outs}) == N
    assert m.hops == {name: sum(o.numel() * 4 for o in outs)}
    ws = _inputs(tuple(outs[0].shape), seed=1)
    grads = torch.autograd.grad(sum((o * w.detach()).sum()
                                    for o, w in zip(outs, ws)), xs)
    xs2 = [x.detach().clone().requires_grad_() for x in xs]
    # the same function written with plain ops, differentiated
    plain = {"all_reduce": lambda: [sum(xs2)] * N,
             "pmean": lambda: [sum(xs2) / N] * N,
             "all_gather": lambda: [torch.cat(xs2, 1)] * N,
             "reduce_scatter": lambda: list(sum(xs2).chunk(N, 0)),
             "all_to_all": lambda: [torch.cat([x.chunk(N, 0)[j] for x in xs2],
                                              1) for j in range(N)]}[kind]()
    want = torch.autograd.grad(sum((o * w.detach()).sum()
                                   for o, w in zip(plain, ws)), xs2)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    one = DeviceMesh(np.full((2, 1), CPU, dtype=object), ("data", "model"))
    assert call(one, xs[:1])[0] is xs[0] and one.hops == {}


def test_bfloat16_all_reduce_sums_in_float32_in_a_fixed_order():
    """256 + 1 + 1 + 1 in bfloat16: entry 0 first, accumulated in float32
    (259) and rounded once, 260; summed in bfloat16 it would stay 256.
    Every entry holds the same bits."""
    m = DeviceMesh(np.full((N,), CPU, dtype=object), ("model",))
    xs = [torch.tensor([256.0], dtype=torch.bfloat16)] + \
        [torch.tensor([1.0], dtype=torch.bfloat16)] * 3
    outs = m.all_reduce(xs, "model")
    assert all(o.dtype == torch.bfloat16 and float(o) == 260.0 for o in outs)
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    assert float(acc) == 256.0
