"""The port's MLA, the VLM's cross-attention groups, RWKV6 and Mamba2
sharded over a (data, model) mesh at run time (``Model(cfg, mesh=...)``,
``models/transformer.py:_run_sharded``) against the reference's under the
same (2, 4) mesh, on the CPU.

The reference's numbers come from one subprocess with 8 placeholder
devices (``tests/_sharded_families_reference.py``), written to an
``.npz`` with its parameters, which ``models/convert.py`` carries across.
The port runs on ``DeviceMesh``es of ``cpu`` entries. Cases, SMOKE
configs in float32, batch 4 x 16: ``deepseek-v2-lite-16b`` at
``capacity_factor=1.0``, with and without ``moe_sp_dispatch`` (MLA by
head, the latent cache by position, the dense prefix, the MoE blocks
expert-parallel); ``rwkv6-3b`` (the time mix by head, the channel mix by
hidden unit, the wkv state gathered); ``zamba2-2.7b`` (Mamba2's
projection and conv by block, the heads, the gated norm's all-reduced
statistic, the shared block); ``llama-3.2-vision-11b`` with its gates set
non-zero and patches fed (q by head over replicated k and v, the self
caches and the patch cache by position).

* the loss within 2e-5, the logits, the load-balance loss and the logits
  of 4 decode steps (deepseek's absorbed and expanded) within
  ``F32_ATOL``, every gradient leaf within ``grad_tolerance(L)``;
* a port that ignored the mesh must fail: deepseek's one-device loss lies
  more than 25 x the loss tolerance from the reference's (2, 4) loss (its
  MoE routes each data shard with a capacity of its own); the other three
  give the same numbers on any mesh, so for every case the bytes of each
  collective kind, in a forward and in each decode step, equal the
  formulas of ``forward_bytes`` and ``decode_bytes``, and are non-zero;
* other layouts against the port's one-device program: kv heads that
  ``model`` divides (the VLM on (2, 2): caches by head), RWKV6 heads it
  does not (column blocks of part of a head: r, k, v gathered), Mamba2
  heads it does not (the conv cut, its state whole; the norm's rows cut
  over every head), MLA heads replicated beside experts cut;
* size-1 meshes run the one-device program bit for bit;
* ``train(mesh=)`` of ``rwkv6-3b`` gives the one-device losses.
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
from repro_torch.models import convert, ssm
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten, leaves

import _sharded_families_reference as ref_cases
from _model_cases import F32_ATOL, grad_error, grad_tolerance
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, DECODE = ref_cases.B, ref_cases.S, ref_cases.DECODE
CASES = list(ref_cases.CASES)
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
    """The reference's records (``tests/_sharded_families_reference.py``),
    computed once in a subprocess with 8 placeholder devices."""
    out = tmp_path_factory.mktemp("sharded_families") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_sharded_families_reference.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


def _tree(ref, prefix):
    """The nested records under ``prefix``: dicts, and lists where the
    keys are a list's indices (deepseek's ``prefix``)."""
    out = {}
    for key, value in ref.items():
        if key.startswith(prefix + "/"):
            node, *path = out, *key[len(prefix) + 1:].split("/")
            *inner, last = path
            for p in inner:
                node = node.setdefault(p, {})
            node[last] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def mesh(shape, names=("data", "model")):
    return DeviceMesh(np.full(shape, CPU, dtype=object), names)


def config(case):
    arch, changes, _ = ref_cases.CASES[case]
    return get_config(arch, smoke=True).replace(**changes)


def params(ref, case):
    return convert.from_reference(_tree(ref, f"{case}/params"),
                                  config(case).num_layers)


def batch(cfg):
    return {k: torch.as_tensor(v)
            for k, v in ref_cases.batch_for(cfg).items()}


def filled_cache(model, b):
    """``model``'s empty cache for B x S, the VLM's patch cache filled with
    each group's projection of ``b["patches"]`` (the reference's fill)."""
    cache = model.init_cache(B, S)
    if model.cross:
        pt = b["patches"].to(model.cfg.cdtype)
        for g, gp in enumerate(model.cross):
            for n in ("k", "v"):
                cache["cross_groups"]["cross_kv"][n][g] = torch.einsum(
                    "bpd,dhk->bphk", pt, gp["cross"][f"w{n}"])
    return cache


def decode(model, b):
    """The logits (B, DECODE, V) of DECODE steps over ``b``'s first
    tokens, and the hop bytes each step added."""
    cache = filled_cache(model, b)
    out, hops = [], []
    for t in range(DECODE):
        before = dict(model.mesh.hops) if model.mesh else {}
        logits, cache = model.decode_step(
            cache, {"tokens": b["tokens"][:, t:t + 1]}, t)
        out.append(logits[:, 0])
        if model.mesh:
            hops.append({k: v - before.get(k, 0)
                         for k, v in model.mesh.hops.items()})
    return torch.stack(out, 1), hops


@pytest.fixture(scope="module")
def port(ref):
    """The port's (loss, aux, logits, {path: gradient}) of each case on
    the (2, 4) mesh, computed once a case."""
    done = {}

    def run(case):
        if case not in done:
            cfg = config(case)
            b = batch(cfg)
            model = Model(cfg, device="cpu", params=params(ref, case),
                          trainable=True, mesh=mesh(ref_cases.SHAPE))
            loss, metrics = model.loss(b)
            grads = torch.autograd.grad(loss, leaves(model.params()))
            with torch.no_grad():
                logits, _ = model(b)
            names = [k for k, _ in flatten(model.params())]
            done[case] = (float(loss.detach()),
                          float(metrics["aux"].detach()), logits,
                          dict(zip(names, grads)))
        return done[case]
    return run


@pytest.mark.parametrize("case", CASES)
def test_loss_logits_aux_match_reference(case, ref, port):
    loss, aux, logits, _ = port(case)
    assert abs(loss - float(ref[f"{case}/loss"])) <= LOSS_TOL, \
        (loss, float(ref[f"{case}/loss"]))
    assert abs(aux - float(ref[f"{case}/aux"])) <= F32_ATOL
    err = float((logits - torch.as_tensor(ref[f"{case}/logits"])).abs()
                .max())
    assert err <= F32_ATOL, err


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_reference(case, ref, port):
    cfg = config(case)
    want = dict(flatten(convert.from_reference(
        _tree(ref, f"{case}/grad"), cfg.num_layers)))
    grads = port(case)[3]
    assert set(grads) == set(want)
    tol = grad_tolerance(cfg.num_layers)
    errs = {k: grad_error(g, torch.as_tensor(want[k]))
            for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst], tol)


@pytest.mark.parametrize("case", ["deepseek-2x4", "deepseek-2x4-sp"])
def test_one_device_cannot_pass_for_the_mesh(case, ref):
    """deepseek's one-device loss parts from the reference's (2, 4) loss by
    more than 25 x the loss tolerance: a port that ran unsharded under the
    mesh would fail ``test_loss_logits_aux_match_reference``."""
    cfg = config(case)
    one, _ = Model(cfg, device="cpu", params=params(ref, case)).loss(
        batch(cfg))
    assert abs(float(one) - float(ref[f"{case}/loss"])) > 25 * LOSS_TOL


def _act(cfg, D, M, S):
    """Every entry's copy of its data row's (B / D, S, d) float32
    activations: M times the batch's."""
    return M * B * S * cfg.d_model * 4


def forward_bytes(case, cfg, S=S, D=2, M=4):
    """The bytes of each collective kind in one no-grad forward (or, at S
    = 1, a decode step's without its caches' gathers) of a batch B x S in
    float32 on the (D, M) mesh, every participant's output counted. ``act``
    (``_act``) a sublayer's activations; ``logits`` the same of the (B /
    D, S, V) logits, all-gathered from their vocabulary shards. Each
    arch's vocabulary splits over ``model``, so the embedding lookup is
    one all-reduce of ``act``.

    * deepseek: the prefix block's MLA (q by head: row-parallel ``wo``)
      and dense MLP, each an all-reduce of ``act``; each MoE block's MLA
      and shared expert, the same; its MoE layer two all-to-alls of every
      entry's (E, cap, d) slot buffer (cap from its own token count: the
      data row's, or under ``moe_sp_dispatch`` its model rank's S / M
      slice), the pmean of its load-balance loss over data and model (2 D
      M scalars), and under ``moe_sp_dispatch`` an all-gather of its
      outputs' slices (``act``);
    * rwkv6: each layer's time mix (row-parallel ``wo``) and channel mix
      (row-parallel ``wv``), each an all-reduce of ``act``;
    * zamba2: each Mamba2 layer's projection all-gathered ((B / D, S,
      2 d_inner + 2 d_state + H) a participant), its conv outputs ((B /
      D, S, conv_dim)), its gated norm's sums of squares all-reduced ((B
      / D, S, 1)), ``out_proj``'s partial sums (``act``); each group's
      shared block, attention and MLP, each an all-reduce of ``act``;
    * the VLM: each self block's attention and MLP, each group's
      cross-attention (q by head) and MLP, each an all-reduce of ``act``
      (k and v replicated: nothing gathered over the patches)."""
    act = _act(cfg, D, M, S)
    logits = M * B * S * cfg.vocab_size * 4
    if cfg.mla:
        n_moe = cfg.num_layers - cfg.first_dense
        sp = cfg.moe_sp_dispatch and S % M == 0 and S >= M
        cap = capacity(B // D * (S // M if sp else S), cfg)
        slots = D * M * cfg.num_experts * cap * cfg.d_model * 4
        return {"all-reduce": act * (1 + 2 * cfg.first_dense + 2 * n_moe)
                + n_moe * 2 * D * M * 4,
                "all-to-all": n_moe * 2 * slots,
                "all-gather": logits + (n_moe * act if sp else 0)}
    if cfg.block_pattern == "rwkv6":
        return {"all-reduce": act * (1 + 2 * cfg.num_layers),
                "all-gather": logits}
    if cfg.block_pattern == "zamba2":
        d_inner, H, conv_dim = ssm.mamba2_dims(cfg)
        G = cfg.num_layers // cfg.shared_attn_every
        per = M * B * S * 4
        proj = 2 * d_inner + 2 * cfg.ssm_state + H
        return {"all-reduce": act * (1 + cfg.num_layers + 2 * G)
                + cfg.num_layers * per,
                "all-gather": logits + cfg.num_layers * per
                * (proj + conv_dim)}
    G = cfg.num_layers // cfg.cross_attn_every
    return {"all-reduce": act * (1 + 2 * cfg.num_layers + 2 * G),
            "all-gather": logits}


def decode_bytes(case, cfg, D=2, M=4):
    """One decode step's bytes: ``forward_bytes`` at S = 1, plus the
    gathers of the caches laid out by position over ``model`` and of
    RWKV6's state: deepseek's latent cache (c_kv and k_rope, (B / D,
    S_max, r + dr) a participant) in each of its layers; rwkv6's new wkv
    state ((B / D, H, hd, hd)) in each layer; the VLM's self k and v
    ((B / D, S_max, KH, Dh), 2 kv heads over 4 ranks: by position) in
    each self block and its patch cache's k and v ((B / D, P, KH, Dh)) in
    each group. zamba2's caches go by head: nothing more."""
    out = forward_bytes(case, cfg, S=1, D=D, M=M)
    extra = 0
    if cfg.mla:
        extra = cfg.num_layers * M * B * S * (cfg.kv_lora_rank
                                              + cfg.qk_rope_dim) * 4
    elif cfg.block_pattern == "rwkv6":
        H, hd = ssm.rwkv6_dims(cfg)
        extra = cfg.num_layers * M * B * H * hd * hd * 4
    elif cfg.cross_attn_every:
        kv = M * B * cfg.num_kv_heads * cfg.head_dim * 4
        G = cfg.num_layers // cfg.cross_attn_every
        extra = cfg.num_layers * 2 * kv * S + G * 2 * kv * cfg.num_patches
    out["all-gather"] += extra
    return out


@pytest.mark.parametrize("case", CASES)
def test_hop_bytes_match_formula(case, ref):
    cfg = config(case)
    m = mesh(ref_cases.SHAPE)
    model = Model(cfg, device="cpu", params=params(ref, case), mesh=m)
    with torch.no_grad():
        model(batch(cfg))
    want = forward_bytes(case, cfg)
    assert m.hops == want
    assert all(want[k] > 0 for k in ("all-reduce", "all-gather"))
    assert want.get("all-to-all", 0) > 0 or not cfg.moe


@pytest.mark.parametrize("case,absorb", [
    ("deepseek-2x4", True), ("deepseek-2x4", False),
    ("deepseek-2x4-sp", True), ("rwkv6-2x4", True), ("zamba2-2x4", True),
    ("vlm-2x4", True)])
def test_decode_matches_reference(case, absorb, ref):
    """4 decode steps on (2, 4) against the reference's (deepseek's
    absorbed and expanded; the VLM's over the filled patch cache), each
    step's bytes by ``decode_bytes``."""
    cfg = config(case).replace(mla_absorb=absorb)
    model = Model(cfg, device="cpu", params=params(ref, case),
                  mesh=mesh(ref_cases.SHAPE))
    got, hops = decode(model, batch(cfg))
    key = f"{case}/decode" if absorb else f"{case}/decode-expanded"
    err = float((got - torch.as_tensor(ref[key])).abs().max())
    assert err <= F32_ATOL, err
    assert hops == [decode_bytes(case, cfg)] * DECODE


def _drawn(arch):
    """``arch``'s SMOKE config in float32, its port-drawn tree (the VLM's
    gates set to 0.7), and a seeded batch with patches where it takes
    them."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tree = Model(cfg, device="cpu").params()
    for g in tree.get("cross", []):
        g["cross"]["gate"] = torch.tensor(0.7)
    rng = np.random.default_rng(3)
    b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S))),
         "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.cross_attn_every:
        b["patches"] = torch.as_tensor(rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return cfg, tree, b


def _runs(cfg, tree, b, m):
    """[logits, loss, 3 decode steps' logits] and the final cache."""
    model = Model(cfg, device="cpu", params=tree, mesh=m)
    logits, _ = model(b)
    loss, _ = model.loss(b)
    cache = filled_cache(model, b)
    steps = [model.decode_step(cache, {"tokens": b["tokens"][:, t:t + 1]},
                               t)[0] for t in range(3)]
    return [logits, loss, *steps], cache


@pytest.mark.parametrize("arch,shape", [
    ("llama-3.2-vision-11b", (2, 2)), ("rwkv6-3b", (1, 8)),
    ("zamba2-2.7b", (1, 16)), ("deepseek-v2-lite-16b", (1, 8))])
def test_other_layouts_match_one_device(arch, shape):
    """Layouts the (2, 4) cases do not reach, held against the port's
    one-device program (which the model tests hold against the reference)
    in float32: the logits and loss of a batch, 3 decode steps and the
    final cache. The VLM on (2, 2): its 2 kv heads by head, so the self
    caches and the patch cache go by head; rwkv6 on (1, 8): 4 heads of 16
    over 8 ranks, each rank's columns half a head, so r, k, v, the gate
    and the decay are gathered and every rank runs every head; zamba2 on
    (1, 16): 8 heads and ``in_proj``'s 296 columns replicated, the conv's
    160 channels cut beside a whole conv state (its new state gathered),
    the norm's and ``out_proj``'s 128 rows cut over every head; deepseek
    on (1, 8): 4 heads replicated (complete MLA outputs, the latent cache
    by position), 8 experts one a rank."""
    cfg, tree, b = _drawn(arch)
    m = mesh(shape)
    got, got_cache = _runs(cfg, tree, b, m)
    want, want_cache = _runs(cfg, tree, b, None)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= F32_ATOL
    for (path, g), (_, w) in zip(flatten(got_cache), flatten(want_cache)):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= F32_ATOL * scale, path
    assert m.hops.get("all-reduce") and m.hops.get("all-gather")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-3b",
                                  "zamba2-2.7b", "llama-3.2-vision-11b"])
def test_size_one_meshes_are_the_one_device_program(arch):
    """(1, 1) and (1, 1, 1) with a pod axis: the logits, loss, decode steps
    and cache of ``mesh=None`` bit for bit (bfloat16, the configs' own
    dtype), and nothing moved."""
    cfg, tree, b = _drawn(arch)
    cfg = cfg.replace(dtype="bfloat16")
    want, want_cache = _runs(cfg, tree, b, None)
    for m in (mesh((1, 1)), mesh((1, 1, 1), ("pod", "data", "model"))):
        got, got_cache = _runs(cfg, tree, b, m)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for (_, g), (_, w) in
                   zip(flatten(got_cache), flatten(want_cache)))
        assert m.hops == {}


def test_train_on_a_mesh_matches_one_device():
    """``train(mesh=)``: 3 steps of ``rwkv6-3b`` SMOKE in float32 on (2,
    4), batch 2 x 16, the losses of the one-device ``train()`` within
    ``F32_ATOL``."""
    from repro_torch.launch.train import train
    kw = dict(arch="rwkv6-3b", steps=3, batch=2, seq=16, quiet=True,
              config_overrides={"dtype": "float32"})
    want = train(device="cpu", **kw)["losses"]
    got = train(mesh=mesh((2, 4)), **kw)["losses"]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
