"""The dry run's sharded program, on the CPU: the one-entry ``meta``
trace of a (data, model) mesh against a run of every entry, its
collective bytes against the formulas the sharded tests state, the
backward's collective bytes against a formula, and counting that moves
no number.

* The one-entry trace is exact: on a (2, 4) mesh of ``meta`` entries the
  model runs entry (0, 0) alone, each op weighed by the 8 entries it
  stands for (``launch/dryrun.py``); the same step on a (2, 4) mesh of
  ``cpu`` entries runs all 8. SMOKE cells ``smollm-360m`` train,
  ``olmoe-1b-7b`` train, ``deepseek-v2-lite-16b`` decode, ``rwkv6-3b``
  prefill and ``llama-3.2-vision-11b`` decode, batch 4 x 16: FLOPs and
  collective bytes by kind equal, bytes equal but for MoE, within 1%
  (``one_hot`` takes another path on ``meta`` than on the CPU, as
  ``tests/test_torch_dryrun.py:test_meta_trace_counts_the_program_a_
  device_runs`` says).
* Forward counts: a forward (and a decode step) on the abstract mesh
  moves the bytes that ``tests/test_torch_sharded.py:expected`` and
  ``tests/test_torch_sharded_families.py:forward_bytes`` and
  ``decode_bytes`` state for the same cases run on CPU entries.
* Backward counts: the loss and gradient of ``yi-6b`` and ``olmoe-1b-7b``
  SMOKE in float32 on (2, 4), batch 4 x 16, move the bytes of
  ``train_bytes``: the forward's, each remat'd layer's forward again,
  each collective's transpose, and the gradients' all-reduce over the
  data axes. The reference's XLA program on 8 placeholder devices (the
  same configs, ``scan_layers=False``) moves, by kind (bytes):

    ``yi-6b``: all-reduce 1,198,112;
    ``olmoe-1b-7b``: all-reduce 510,016, all-to-all 589,824.

  ``PERF.md`` says why each kind differs.
* No loss or gradient moves: with the backward counted and not
  (``DeviceMesh.count_backward`` a no-op), the loss and every gradient
  are the same bits.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import test_torch_sharded as sharded
import test_torch_sharded_families as families
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten, leaves

from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)

B, S = 4, 16
D, M = 2, 4


@pytest.fixture(autouse=True)
def one_thread():
    """SMOKE widths: one intra-op thread runs them as fast as many."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def mesh(device, shape=(D, M)):
    return DeviceMesh(np.full(shape, torch.device(device), dtype=object),
                      ("data", "model"))


@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("olmoe-1b-7b", "train"),
    ("deepseek-v2-lite-16b", "decode"), ("rwkv6-3b", "prefill"),
    ("llama-3.2-vision-11b", "decode")])
def test_one_entry_trace_equals_every_entry_run(arch, kind):
    overrides = dataclasses.asdict(get_config(arch, smoke=True))
    shape = shp.ShapeSpec(f"tiny_{kind}", S, B, kind)
    runs = {}
    for device in ("meta", "cpu"):
        m = mesh(device)
        bundle, *_ = dr.lower_cell(arch, "", m, opt_overrides=overrides,
                                   shape=shape, device=device)
        runs[device] = dr.trace(bundle, mesh=m)
    one, every = runs["meta"], runs["cpu"]
    assert one["flops"] == every["flops"] > 0
    assert one["coll"] == every["coll"]
    assert sum(one["coll"].values()) > 0
    if get_config(arch).moe:
        assert abs(one["bytes"] - every["bytes"]) < 1e-2 * every["bytes"]
    else:
        assert one["bytes"] == every["bytes"] > 0


def _meta_batch(cfg, S_=S, patches=True):
    batch = {"tokens": torch.empty((B, S_), dtype=torch.int64,
                                   device="meta")}
    if cfg.cross_attn_every and patches:
        batch["patches"] = torch.empty((B, cfg.num_patches, cfg.d_model),
                                       device="meta")
    return batch


@pytest.mark.parametrize("case", ["olmoe-2x4", "olmoe-2x4-sp", "yi-2x4-sp",
                                  "smollm-2x4"])
def test_forward_counts_equal_the_sharded_formulas(case):
    """A forward of each ``tests/test_torch_sharded.py`` case on the
    abstract (2, 4) mesh: ``expected``'s bytes."""
    cfg = sharded.config(case)
    m = mesh("meta", sharded.CASES[case][2])
    with torch.no_grad():
        Model(cfg, device="meta", mesh=m)(_meta_batch(cfg))
    assert m.hops == sharded.expected(case, cfg)


@pytest.mark.parametrize("case", families.CASES)
def test_forward_and_decode_counts_equal_the_families_formulas(case):
    """A forward and a decode step of each
    ``tests/test_torch_sharded_families.py`` case on the abstract (2, 4)
    mesh: ``forward_bytes``' and ``decode_bytes``' bytes."""
    cfg = families.config(case)
    m = mesh("meta")
    model = Model(cfg, device="meta", mesh=m)
    with torch.no_grad():
        model(_meta_batch(cfg))
        assert m.hops == families.forward_bytes(case, cfg)
        m.hops.clear()
        model.decode_step(model.init_cache(B, S),
                          _meta_batch(cfg, 1, patches=False), 3)
    assert m.hops == families.decode_bytes(case, cfg)


def train_bytes(cfg):
    """(the forward's, the whole step's) bytes of each collective kind in
    ``Model.loss`` and its gradient, batch B x S in float32 on the (D, M)
    mesh, remat "full", every participant's output counted. ``act`` = M B
    S d x 4, every entry's copy of its data row's activations.

    Forward (``tests/test_torch_sharded.py:expected``): all-reduce ``act``
    for the embedding's vocabulary shards and for each row-parallel
    sublayer (yi: attention by head and the MLP in each layer; olmoe:
    attention, and the pmean of each MoE layer's load-balance loss over
    data and model, 2 D M scalars); olmoe's 2 all-to-alls of every entry's
    (E, cap, d) slot buffer a layer; all-gather the logits (M B S V x 4).

    Backward:
    * remat "full" reruns each layer's forward: its collectives again;
    * each forward collective's transpose once, its inputs' bytes: every
      all-reduce again, the all-to-alls again, the logits' all-gather as a
      reduce-scatter (B S V x 4), and of each layer's two pmeans (data,
      then model) the ones on the gradient's path: the model pmean of data
      row 0, whose rank 0 the loss reads (M scalars), and the M data
      pmeans that feed it (D scalars each);
    * the gradients' all-reduce over data: D M times each entry's block
      of every leaf (``Model._grad_bytes``): by vocabulary the embedding
      and head, by head q and the output projection (and olmoe's k and v;
      yi's 2 kv heads do not split over 4 ranks), by hidden unit the MLP,
      by expert the experts; the norms and olmoe's router whole."""
    L, d, V, f32 = cfg.num_layers, cfg.d_model, cfg.vocab_size, 4
    act = M * B * S * d * f32
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv = d * KH * Dh // (M if KH % M == 0 else 1)
    attn = 2 * d * H * Dh // M + 2 * kv
    if cfg.moe:
        slots = D * M * cfg.num_experts * capacity(B // D * S, cfg) * d * f32
        E, ff = cfg.num_experts, cfg.d_ff_expert
        layer = 2 * d + attn + d * E + 3 * E * d * ff // M
        fwd = {"all-reduce": act * (1 + L) + L * 2 * D * M * f32,
               "all-to-all": L * 2 * slots,
               "all-gather": M * B * S * V * f32}
        rerun = {"all-reduce": L * (act + 2 * D * M * f32),
                 "all-to-all": L * 2 * slots}
        back = {"all-reduce": act * (1 + L) + L * (M + M * D) * f32,
                "all-to-all": L * 2 * slots}
    else:
        layer = 2 * d + attn + 3 * d * cfg.d_ff // M
        fwd = {"all-reduce": act * (1 + 2 * L),
               "all-gather": M * B * S * V * f32}
        rerun = {"all-reduce": L * 2 * act}
        back = {"all-reduce": act * (1 + 2 * L)}
    grads = D * M * f32 * (2 * V * d // M + d + L * layer)
    out = dict(fwd)
    for part in (rerun, back, {"all-reduce": grads}):
        for k, v in part.items():
            out[k] += v
    out["reduce-scatter"] = B * S * V * f32
    return fwd, out


def _train(arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tree = Model(cfg, device="cpu").params()
    m = mesh("cpu")
    model = Model(cfg, device="cpu", params=tree, trainable=True, mesh=m)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    loss, _ = model.loss(batch)
    forward = dict(m.hops)
    grads = torch.autograd.grad(loss, leaves(model.params()))
    names = [k for k, _ in flatten(model.params())]
    return cfg, m, forward, loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_backward_counts_equal_the_formula(arch):
    cfg, m, forward, _, _ = _train(arch)
    fwd, want = train_bytes(cfg)
    assert forward == fwd
    assert m.hops == want


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_counting_moves_no_number(arch, monkeypatch):
    """The loss and every gradient leaf, bit for bit, with the backward
    counted and with ``DeviceMesh.count_backward`` a no-op (the program
    without the backward's count); only the counts differ."""
    _, on, _, loss_on, grads_on = _train(arch)
    monkeypatch.setattr(DeviceMesh, "count_backward",
                        lambda self, kind, outs, nbytes: None)
    _, off, _, loss_off, grads_off = _train(arch)
    assert torch.equal(loss_on, loss_off)
    assert grads_on.keys() == grads_off.keys()
    assert all(torch.equal(grads_on[k], grads_off[k]) for k in grads_on)
    assert sum(on.hops.values()) > sum(off.hops.values())
