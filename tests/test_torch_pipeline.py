"""The port's GPipe pipeline (``repro_torch.models.pipeline``) against the
reference, on the CPU, as ``tests/test_distributed.py`` holds the
reference's: ``smollm-360m``'s SMOKE config in float32, 4 layers, remat
"none", batch 8 x 16, the reference's ``Model.init(seed=0)`` parameters
carried across (``models/convert.py``), on a ("data", "stage") (2, 4) mesh
of ``cpu`` entries with ``n_micro = 4``, and on other meshes and
microbatch counts:

* the pipelined loss within 2e-4 of the reference's ``jax.jit(model.loss)``
  (``tests/test_distributed.py``'s rule) and of the port's unstaged loss;
* every gradient leaf within ``F32_ATOL`` of the port's unstaged one;
* the bytes the pipeline moves between mesh entries equal the formula:
  (K - 1) hops of each microbatch's activation, and the final
  ``psum``'s buffer on each entry;
* beside a model axis, on ("data", "stage", "model") meshes (2, 2, 2)
  and (1, 2, 4) with the model built on the mesh (the embedding and head
  sharded over (data, model), as the reference's test builds
  ``Model(cfg, mesh=mesh_pp)``): the loss within 2e-4 of the reference's,
  the gradients within ``F32_ATOL`` of the unstaged ones, and the bytes of
  a step, forward and backward, equal to ``model_axis_bytes``;
* the reference's two asserts (L % K, B % n_micro) raise, and so do a
  microbatch that does not split over the data shards and a model out of
  the pipeline's scope.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.transformer import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import convert
from repro_torch.models.pipeline import STAGE_AXIS, pp_loss_fn
from repro_torch.models.transformer import Model
from repro_torch.tree import leaves

from _model_cases import F32_ATOL
from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)

ARCH = "smollm-360m"
LAYERS, B, S = 4, 8, 16
REPLACE = dict(dtype="float32", num_layers=LAYERS, remat="none")


def _mesh(shape, names):
    return DeviceMesh(np.full(shape, torch.device("cpu"), dtype=object),
                      names)


MESHES = {
    "data2-stage4": ((2, 4), ("data", STAGE_AXIS)),
    "data1-stage4": ((1, 4), ("data", STAGE_AXIS)),
    "stage2-data2": ((2, 2), (STAGE_AXIS, "data")),
    "pod2-data1-stage2": ((2, 1, 2), ("pod", "data", STAGE_AXIS)),
    "stage1": ((1,), (STAGE_AXIS,)),
}


@pytest.fixture(scope="module")
def case():
    """(the reference's loss of the batch, the port's model on the CPU,
    the batch) for the SMOKE config at 4 layers in float32."""
    rcfg = ref_config(ARCH, smoke=True).replace(**REPLACE)
    rmodel = RefModel(rcfg, mesh=None)
    params = rmodel.init(seed=0)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (B, S)),
             "labels": rng.integers(0, rcfg.vocab_size, (B, S))}
    ref, _ = jax.jit(rmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_config(ARCH, smoke=True).replace(**REPLACE)
    model = Model(cfg, device="cpu", trainable=True,
                  params=convert.from_reference(
                      jax.tree.map(np.asarray, params), LAYERS))
    return float(ref), model, {k: torch.as_tensor(v) for k, v in
                               batch.items()}


def _grads(loss, model):
    return torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("n_micro", [4, 2, 1])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_pipelined_loss_and_gradients(case, mesh_id, n_micro):
    ref, model, batch = case
    mesh = _mesh(*MESHES[mesh_id])
    loss, metrics = pp_loss_fn(model, mesh, n_micro)(batch)
    base, _ = model.loss(batch)
    got = float(loss.detach())
    assert abs(got - ref) < 2e-4, (got, ref)
    assert abs(got - float(base.detach())) < 2e-4
    assert float(metrics["tokens"]) == B * S
    for g, want in zip(_grads(loss, model), _grads(base, model)):
        assert torch.allclose(g, want, rtol=0, atol=F32_ATOL), \
            float((g - want).abs().max())


def test_hop_bytes_match_the_formula(case):
    """On the (2, 4) mesh with 4 microbatches: each microbatch's
    activation (B / n_micro, S, d) float32 crosses K - 1 stage boundaries
    (split over the data shards, whose bytes sum to it), and the
    ``psum``'s (n_micro, B / n_micro / D, S, d) buffer counts once an
    entry."""
    _, model, batch = case
    (D, K), names = MESHES["data2-stage4"]
    mesh = _mesh((D, K), names)
    n_micro, d = 4, model.cfg.d_model
    pp_loss_fn(model, mesh, n_micro)(batch)
    act = B * S * d * 4
    assert mesh.hops == {"collective-permute": (K - 1) * act,
                         "all-reduce": D * K * act // D}


def test_one_stage_moves_nothing_between_stages(case):
    _, model, batch = case
    mesh = _mesh(*MESHES["stage1"])
    pp_loss_fn(model, mesh, 2)(batch)
    assert mesh.hops == {"all-reduce": B * S * model.cfg.d_model * 4}


def test_reference_asserts_raise(case):
    """L % K (4 layers over 3 stages) and B % n_micro (8 over 3) assert, as
    the reference's do; a microbatch of 1 over 2 data shards and a model
    outside the dense family raise ValueError."""
    _, model, batch = case
    with pytest.raises(AssertionError):
        pp_loss_fn(model, _mesh((1, 3), ("data", STAGE_AXIS)), 4)(batch)
    with pytest.raises(AssertionError):
        pp_loss_fn(model, _mesh(*MESHES["data1-stage4"]), 3)(batch)
    with pytest.raises(ValueError):
        pp_loss_fn(model, _mesh(*MESHES["data2-stage4"]), 8)(batch)
    moe = Model(get_config("olmoe-1b-7b", smoke=True), device="meta")
    with pytest.raises(ValueError):
        pp_loss_fn(moe, _mesh(*MESHES["data1-stage4"]), 4)


MODEL_MESHES = {
    "data2-stage2-model2": ((2, 2, 2), ("data", STAGE_AXIS, "model")),
    "data1-stage2-model4": ((1, 2, 4), ("data", STAGE_AXIS, "model")),
}


def model_axis_bytes(cfg, D, K, M, n_micro, backward):
    """The bytes of each collective kind in a pipelined step of batch B x
    S in float32 on a (D, K, M) ("data", "stage", "model") mesh, the model
    built on it (every participant's output, as ``DeviceMesh`` counts
    them). ``act`` = B S d x 4: the batch's activations.

    Forward: the embedding by vocabulary shard over ``model``, an
    all-reduce of every entry's lookups of its data row (M act); the
    stages, (K - 1) hops of every microbatch (``act`` over the data
    shards); the ``psum`` over ``stage``, every entry's (B / D, S, d)
    buffer (K M act); the head by vocabulary shard, an all-gather of every
    entry's logits of its row (M B S V x 4). Between the embedding's data
    rows (row i holds rows [i B / D, (i + 1) B / D)) and the pipeline's
    shards (shard d takes the d-th of D slices of each microbatch), the
    rows r whose row i(r) is not their shard d(r) hop in, once, and out,
    to each of the row's M head entries: collective-permute (1 + M)
    ``moved`` S d x 4.

    Backward (remat "none"): each collective's transpose, its inputs'
    bytes: the embedding's all-reduce again (M act), every hop again, the
    ``psum`` again (K M act), the logits' all-gather as a reduce-scatter
    (B S V x 4); and where D > 1 the gradients' all-reduce over data: D M
    times each (data, model) entry's leaves, a stage's blocks whole and
    the embedding (tied: the head) and final norm by their specs."""
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    act, f32 = B * S * d * 4, 4
    mb = B // n_micro
    moved = sum((r // (B // D)) != ((r % mb) // (mb // D)) for r in range(B))
    out = {"all-reduce": M * act + K * M * act,
           "collective-permute": (K - 1) * act + (1 + M) * moved * S * d * 4,
           "all-gather": M * B * S * V * f32}
    if backward:
        out["all-reduce"] *= 2
        out["collective-permute"] *= 2
        out["reduce-scatter"] = B * S * V * f32
        if D > 1:
            per_layer = 2 * d + d * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                * cfg.head_dim + cfg.num_heads * cfg.head_dim * d \
                + 3 * d * cfg.d_ff
            out["all-reduce"] += D * M * f32 * (
                L * per_layer + V * d // M + d)
    return out


@pytest.fixture(scope="module")
def staged(case):
    """The case's weights built on each model-axis mesh."""
    _, model, _ = case
    return {mid: Model(model.cfg, device="cpu", trainable=True,
                       params=model.params(), mesh=_mesh(*MODEL_MESHES[mid]))
            for mid in MODEL_MESHES}


@pytest.mark.parametrize("mesh_id", list(MODEL_MESHES))
def test_pipelined_beside_a_model_axis(case, staged, mesh_id):
    """The reference's loss within 2e-4 (4 microbatches), every gradient
    leaf within ``F32_ATOL`` of the port's unstaged one (the one-device
    model's), and the bytes of the step by ``model_axis_bytes``: the
    forward's, then the forward's and backward's."""
    ref, model, batch = case
    sharded = staged[mesh_id]
    mesh = sharded.mesh
    (D, K, M), _ = MODEL_MESHES[mesh_id]
    loss, metrics = pp_loss_fn(sharded, mesh, 4)(batch)
    got = float(loss.detach())
    assert abs(got - ref) < 2e-4, (got, ref)
    assert float(metrics["tokens"]) == B * S
    assert mesh.hops == model_axis_bytes(sharded.cfg, D, K, M, 4, False)
    base, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves(sharded.params()))
    assert mesh.hops == model_axis_bytes(sharded.cfg, D, K, M, 4, True)
    wants = torch.autograd.grad(base, leaves(model.params()))
    for g, want in zip(grads, wants):
        assert torch.allclose(g, want, rtol=0, atol=F32_ATOL), \
            float((g - want).abs().max())


def test_unstaged_loss_on_a_stage_mesh(case, staged):
    """``Model.loss`` of the model built on a ("data", "stage", "model")
    mesh is the (data, model) sharded program, ``stage`` at index 0: the
    unstaged loss within 2e-4, and the embedding's all-reduce and the
    logits' all-gather moved over its M model ranks, no hop."""
    _, model, batch = case
    sharded = staged["data2-stage2-model2"]
    sharded.mesh.hops.clear()
    with torch.no_grad():
        got, _ = sharded.loss(batch)
        want, _ = model.loss(batch)
    assert abs(float(got) - float(want)) < 2e-4
    assert set(sharded.mesh.hops) == {"all-reduce", "all-gather"}
