"""The port's dry run against the reference's, on the CPU: the mesh rules,
the production meshes, the abstract inputs, the roofline arithmetic, the
dry-run cells, their counts and the extrapolation of
``run_roofline_cell``.

* Mesh rules: every parameter leaf's spec of all ten archs at published
  size, on the (16, 16) and (2, 16, 16) production meshes, equals the
  reference's (``Model(cfg, mesh=AbstractMesh).init(abstract=True)``'s
  ``NamedSharding.spec``); a leaf the port keeps unstacked equals its
  stack's spec without the leading layer entries, which must be None.
* Shapes: ``input_specs`` (shapes, dtypes, specs), ``abstract_cache``
  (leaf shapes, dtypes, specs) and ``runnable`` equal the reference's for
  ten archs x four shapes.
* Roofline: ``active_param_count``, ``model_flops``,
  ``estimate_hbm_bytes`` and ``_cache_bytes`` equal the reference's
  exactly for every arch and shape.
* Dry run: ``run_cell`` is ``ok`` at reduced depth for ``smollm-360m``,
  ``olmoe-1b-7b`` and ``rwkv6-3b`` on the (4, 2) and (2, 2, 2) meshes of
  the reference's ``MINI_DRYRUN`` (``tests/test_system.py``), the sharded
  program traced one entry for all: collective bytes above 0 in every
  kind the program moves (``MINI_KINDS``) and in no other.
* Counts: on a (1, 1) mesh (one device's program) the ``meta`` trace's
  FLOPs and bytes equal the same counter's for the step run on CPU
  tensors (SMOKE size), and its FLOPs equal
  ``torch.utils.flop_counter.FlopCounterMode``'s. The sharded program's
  one-entry trace against a run of every entry is
  ``tests/test_torch_dryrun_sharded.py``'s.
* Extrapolation: ``run_roofline_cell``'s extrapolated FLOPs, bytes,
  argument bytes and collective bytes equal a full-depth trace's
  exactly, for a dense stack, MoE with a dense prefix, RWKV6, the zamba2
  groups and the VLM's groups, on the (4, 2) mesh; each trace counts
  only the bytes it moved.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import roofline as ref_rl
from repro.configs import get_config as ref_config
from repro.launch import shapes as ref_shapes
from repro.launch.steps import abstract_opt_state as ref_abstract_opt_state
from repro.models.transformer import Model as RefModel
from repro_torch import roofline as rl
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import predictor
from repro_torch.launch import dryrun as dr
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import (DeviceMesh, make_mesh_for,
                                     make_production_mesh)
from repro_torch.launch.steps import abstract_opt_state, sharding_of
from repro_torch.models.common import P
from repro_torch.models.transformer import Model, init_params, param_specs
from repro_torch.tree import flatten, map_tree

from _model_reference import jax_caches_cleared  # noqa: F401 (autouse)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(multi_pod):
    sizes, names = MESHES[multi_pod]
    ref = jax.sharding.AbstractMesh(sizes, names)
    return ref, make_production_mesh(multi_pod=multi_pod,
                                     devices=["meta"] * (512 if multi_pod
                                                         else 256))


def _norm(spec):
    """A spec as a tuple of tuples of axis names, one a dimension (JAX
    writes one axis as a name, several as a tuple)."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _ref_leaves(tree, prefix=""):
    """(path, leaf) of a reference tree (dicts and lists)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _ref_leaves(v, f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, jax.sharding.PartitionSpec):
        return [x for i, v in enumerate(tree)
                for x in _ref_leaves(v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def _port_leaves(tree, specs):
    out = []
    map_tree(lambda t, s: out.append((t, s)), tree, specs)
    return [(path, t, s) for (path, _), (t, s) in zip(flatten(tree), out)]


def _ref_path(path):
    """The reference's path of a port leaf: ``blocks/i/...`` ->
    ``blocks/...``, ``cross/g/part/...`` -> ``part/...``."""
    head, *rest = path.split("/")
    if head == "blocks":
        return "/".join(["blocks", *rest[1:]])
    if head == "cross":
        return "/".join(rest[1:])
    return path


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, multi_pod):
    ref_mesh, mesh = _meshes(multi_pod)
    ref = dict(_ref_leaves(
        RefModel(ref_config(arch), mesh=ref_mesh).init(abstract=True)))
    params = init_params(get_config(arch), device="meta")
    seen = set()
    for path, leaf, spec in _port_leaves(params,
                                         param_specs(get_config(arch), mesh)):
        want = ref[_ref_path(path)]
        drop = len(want.shape) - leaf.dim()
        assert tuple(leaf.shape) == tuple(want.shape[drop:]), path
        assert leaf.dtype == getattr(torch, str(want.dtype)), path
        full = _norm(want.sharding.spec)
        assert full[:drop] == ((),) * drop, (path, full)
        assert _norm(spec) == full[drop:], (path, spec, full)
        seen.add(_ref_path(path))
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_match_reference(arch):
    """``input_specs``, ``abstract_cache`` and ``runnable`` for the four
    shapes on the (16, 16) mesh; the cache of the decode shapes."""
    ref_mesh, mesh = _meshes(False)
    cfg, rcfg = get_config(arch), ref_config(arch)
    model = Model(cfg, device="meta", mesh=mesh)
    rmodel = RefModel(rcfg, mesh=ref_mesh)
    for name, shape in shp.SHAPES.items():
        rshape = ref_shapes.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(rshape)
        assert shp.runnable(cfg, shape) == ref_shapes.runnable(rcfg, rshape)
        batch, specs = shp.input_specs(cfg, shape, mesh)
        ref = ref_shapes.input_specs(rcfg, rshape, ref_mesh)
        assert set(batch) == set(ref) == set(specs)
        for k, t in batch.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == ref[k].shape
            assert t.dtype == getattr(torch, str(ref[k].dtype))
            assert _norm(specs[k]) == _norm(ref[k].sharding.spec), k
        if shape.kind != "decode":
            continue
        cache, cspecs = shp.abstract_cache(model, shape)
        rcache, rspecs = ref_shapes.abstract_cache(rmodel, rshape)
        rc, rs = dict(_ref_leaves(rcache)), dict(_ref_leaves(rspecs))
        got = _port_leaves(cache, cspecs)
        assert {p for p, _, _ in got} == set(rc) == set(rs)
        for path, t, s in got:
            assert t.device.type == "meta"
            assert tuple(t.shape) == rc[path].shape, path
            assert t.dtype == getattr(torch, str(rc[path].dtype)), path
            assert _norm(s) == _norm(rs[path]), (path, s, rs[path])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_arithmetic_matches_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert rl.active_param_count(cfg) == ref_rl.active_param_count(rcfg)
    for name, shape in shp.SHAPES.items():
        rshape = ref_shapes.SHAPES[name]
        for kind in ("train", "prefill", "decode"):
            assert rl.model_flops(cfg, shape, kind) == \
                ref_rl.model_flops(rcfg, rshape, kind)
            assert rl.estimate_hbm_bytes(cfg, shape, kind) == \
                ref_rl.estimate_hbm_bytes(rcfg, rshape, kind)
        assert rl._cache_bytes(cfg, shape.global_batch, shape.seq_len) == \
            ref_rl._cache_bytes(rcfg, rshape.global_batch, rshape.seq_len)


def test_card_constants_have_one_home():
    """The predictor reads the roofline's H100 constants; the roofline's
    terms use them."""
    assert (predictor.PEAK_FLOPS, predictor.HBM_BW, predictor.NVLINK_BW) == \
        (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert "PEAK_FLOPS =" not in open(predictor.__file__).read()
    r = rl.Roofline("a", "s", "1", 2, 2 * 989e12, 2 * 3.35e12, 2 * 450e9, 0.0)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)
    assert rl.collective_bytes(None) == dict.fromkeys(rl.COLLECTIVES, 0)


def test_production_meshes():
    for multi_pod, (sizes, names) in MESHES.items():
        _, mesh = _meshes(multi_pod)
        assert mesh.axis_names == names
        assert tuple(mesh.shape.values()) == sizes
        assert {str(d) for d in mesh.devices.flat} == {"meta"}
        assert rl.mesh_name(mesh) == "x".join(map(str, sizes))
    m = make_mesh_for(["cpu"] * 8, model_parallel=2)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_mesh_for(["cpu"] * 8, model_parallel=3)
    with pytest.raises(ValueError):
        make_production_mesh(devices=["meta"] * 8)


def test_abstract_opt_state_matches_reference():
    """``abstract_opt_state``: meta moments of the parameters' shapes and
    dtypes and 0-d step and error leaves, their specs the reference's
    shardings; ``sharding_of`` refuses a spec that does not fit."""
    arch = "olmoe-1b-7b"
    ref_mesh, mesh = _meshes(False)
    cfg = get_config(arch)
    rparams = RefModel(ref_config(arch), mesh=ref_mesh).init(abstract=True)
    rstate = ref_abstract_opt_state(rparams, ref_mesh)
    model = Model(cfg, device="meta", trainable=True, mesh=mesh)
    state, specs = abstract_opt_state(model.params(), param_specs(cfg, mesh))
    assert state.step.shape == () and state.step.dtype == torch.int32
    assert _norm(specs.step) == _norm(rstate.step.sharding.spec) == ()
    for part in ("mu", "nu", "err"):
        ref = dict(_ref_leaves(getattr(rstate, part)))
        for path, t, s in _port_leaves(getattr(state, part),
                                       getattr(specs, part)):
            want = ref[_ref_path(path)]
            drop = len(want.shape) - t.dim()
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want.shape[drop:]), (part, path)
            assert _norm(s) == _norm(want.sharding.spec)[drop:], (part, path)
    assert sharding_of(state, specs) is not None
    with pytest.raises(ValueError):
        sharding_of({"w": torch.empty(2, 3, device="meta")}, {"w": P(None)})


def _mini(multi_pod=False):
    """The reference's MINI_DRYRUN meshes, of ``meta`` entries."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 2, 2) if multi_pod else (4, 2)
    return DeviceMesh(np.full(sizes, torch.device("meta"), dtype=object),
                      names)


# the collective kinds a training step of each moves on the mini meshes:
# the embedding's and the row-parallel sublayers' all-reduces, the
# logits' all-gather, their transposes (the all-gather's reduce-scatter),
# the gradients' all-reduce over the data axes, and MoE's all-to-alls
MINI_KINDS = {
    "smollm-360m": {"all-reduce", "all-gather", "reduce-scatter"},
    "olmoe-1b-7b": {"all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all"},
    "rwkv6-3b": {"all-reduce", "all-gather", "reduce-scatter"},
}


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "rwkv6-3b"])
def test_mini_dryrun_cells(arch, monkeypatch):
    """The reference's ``MINI_DRYRUN`` cells (2 layers, published width,
    train_4k, its ``small`` cut) on the (4, 2) and (2, 2, 2) meshes,
    swapped in for the production mesh as that test swaps them:
    ``ok``, every count positive, the per-device argument bytes below the
    unsharded peak, and the sharded program's collective bytes above 0 in
    each kind of ``MINI_KINDS`` and 0 in the others."""
    monkeypatch.setattr(dr, "production_mesh", _mini)
    orig = dr.get_config

    def small(a, smoke=False):
        c = orig(a, smoke)
        return c.replace(num_layers=2, first_dense=min(c.first_dense, 1),
                         cross_attn_every=min(c.cross_attn_every, 2) or 0,
                         shared_attn_every=min(c.shared_attn_every, 2) or 0)
    monkeypatch.setattr(dr, "get_config", small)
    for multi_pod in (False, True):
        rec = dr.run_cell(arch, "train_4k", multi_pod)
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["mesh"] == ("2x2x2" if multi_pod else "4x2")
        assert rec["chips"] == 8
        coll = rec["collective_bytes"]
        assert set(coll) == set(rl.COLLECTIVES)
        assert {k for k, v in coll.items() if v} == MINI_KINDS[arch], coll
        assert rec["collective_total"] == sum(coll.values()) > 0
        assert rec["t_collective"] > 0
        assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
        assert rec["compile_s"] == 0.0 and rec["lower_s"] >= 0
        mem = rec["memory"]
        assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
        assert mem["temp_bytes"] > 0


def _smoke(arch, **kw):
    """Overrides that turn an arch's published config into its SMOKE one."""
    return dict(dataclasses.asdict(get_config(arch, smoke=True)), **kw)


@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("olmoe-1b-7b", "train"),
    ("rwkv6-3b", "train"), ("zamba2-2.7b", "prefill"),
    ("llama-3.2-vision-11b", "decode")])
def test_meta_trace_counts_the_program_a_device_runs(arch, kind):
    """The same step, traced on ``meta`` and run on CPU tensors (SMOKE
    size): equal FLOPs under ``_Counter``, equal to ``FlopCounterMode``'s
    count of the CPU run, and equal bytes and peak of the step's own
    storages but for MoE: ``one_hot`` (the router's load count, the slot
    ranks) takes another path on ``meta`` (``arange`` and ``eq``) than on
    the CPU (a range check, ``zeros`` and ``scatter_``), a few kB of a
    step's bytes."""
    shape = shp.ShapeSpec(f"tiny_{kind}", 16, 2, kind)
    mesh = DeviceMesh(np.full((1, 1), torch.device("meta"), dtype=object),
                      ("data", "model"))
    meta, *_ = dr.lower_cell(arch, "", mesh, opt_overrides=_smoke(arch),
                             shape=shape)
    cpu, *_ = dr.lower_cell(arch, "", mesh, opt_overrides=_smoke(arch),
                            shape=shape, device="cpu")
    a = dr.trace(meta)
    b = dr.trace(cpu)
    assert a["flops"] == b["flops"] > 0
    if not get_config(arch).moe:
        assert a["bytes"] == b["bytes"] > 0
        assert a["temp_bytes"] == b["temp_bytes"] > 0
    else:
        assert abs(a["bytes"] - b["bytes"]) < 1e-2 * b["bytes"]
        assert abs(a["temp_bytes"] - b["temp_bytes"]) < \
            1e-2 * b["temp_bytes"]
    cpu, *_ = dr.lower_cell(arch, "", mesh, opt_overrides=_smoke(arch),
                            shape=shape, device="cpu")
    with FlopCounterMode(display=False) as fc:
        cpu.fn(*cpu.args)
    assert fc.get_total_flops() == a["flops"]


@pytest.mark.parametrize("arch", [
    "smollm-360m", "deepseek-v2-lite-16b", "rwkv6-3b", "zamba2-2.7b",
    "llama-3.2-vision-11b"])
def test_roofline_extrapolation_is_exact(arch, monkeypatch):
    """``run_roofline_cell``'s 1-unit and 2-unit extrapolation against a
    full-depth trace of the same cell: FLOPs, bytes, per-device argument
    bytes and the collective bytes of each kind equal (SMOKE widths at 3
    units of depth past the dense prefix, a training step: forward, remat
    and backward, AdamW), on the (4, 2) mesh. The batch is 4, so that it
    splits over the 4 data shards, as the MoE layer's routing needs."""
    cfg = get_config(arch, smoke=True)
    layers = cfg.first_dense + 3 * dr._layer_unit(cfg)
    monkeypatch.setattr(dr, "production_mesh", _mini)
    monkeypatch.setattr(dr, "get_config", lambda a: get_config(
        a, smoke=True).replace(num_layers=layers))
    monkeypatch.setitem(shp.SHAPES, "tiny_train",
                        shp.ShapeSpec("tiny_train", 16, 4, "train"))
    rec = dr.run_roofline_cell(arch, "tiny_train")
    assert rec["status"] == "ok", rec.get("trace")
    full = dr._cell_costs(arch, "tiny_train", _mini(False), layers)
    assert rec["hlo_flops"] == full["flops"]
    assert rec["hlo_bytes"] == full["bytes"]
    assert rec["memory"]["argument_bytes"] == full["args"]
    assert rec["collective_bytes"] == full["coll"]
    assert rec["collective_total"] == sum(full["coll"].values()) > 0


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_ops_that_alias_without_saying_so_count_as_views(device):
    """``reshape`` of a permuted tensor copies once (``clone``) and then
    aliases the copy (``_unsafe_view``, no alias annotation in its
    schema), and ``unsafe_split`` aliases its input: the bytes count the
    copy alone, the peak holds the copy once, and a repeat (a memo hit on
    ``meta``) allocates one more copy and no alias."""
    x = torch.empty(4, 6, 8, device=device)
    n = x.numel() * x.element_size()
    counter = dr._Counter([x])
    with counter:
        y = x.permute(1, 0, 2).reshape(6, 32)
        parts = torch.ops.aten.unsafe_split.Tensor(y, 3)
        z = x.permute(1, 0, 2).reshape(6, 32)
    assert counter.bytes == 2 * (2 * n)         # two clones, in and out
    assert counter.peak == counter.live == 2 * n
    assert dr._storage(parts[0]) == dr._storage(y)
    assert dr._storage(z) != dr._storage(y)


def test_extrapolation_counts_each_trace_hops(monkeypatch):
    """Each trace's collective bytes are its own, not the mesh's count
    since it was made: two traces of one cell on one mesh report the same
    bytes, the mesh holding their sum, and ``run_roofline_cell``'s
    extrapolated bytes of a 3-layer prefill equal a full-depth trace's:
    the forward's all-reduces (the embedding's vocabulary shards, each
    layer's row-parallel MLP; smollm's 3 heads do not split over 2 model
    ranks, so attention is replicated) and the logits' all-gather, the
    formulas of ``tests/test_torch_sharded.py:expected`` at this mesh and
    shape."""
    arch = "smollm-360m"
    cfg = get_config(arch, smoke=True)
    layers = 3
    monkeypatch.setattr(dr, "production_mesh", _mini)
    monkeypatch.setattr(dr, "get_config", lambda a: get_config(
        a, smoke=True).replace(num_layers=layers))
    monkeypatch.setitem(shp.SHAPES, "tiny_prefill",
                        shp.ShapeSpec("tiny_prefill", 16, 4, "prefill"))
    rec = dr.run_roofline_cell(arch, "tiny_prefill")
    assert rec["status"] == "ok", rec.get("trace")
    mesh = _mini(False)
    full = dr._cell_costs(arch, "tiny_prefill", mesh, layers)
    again = dr._cell_costs(arch, "tiny_prefill", mesh, layers)
    assert full["coll"] == again["coll"]
    assert mesh.hops == {k: 2 * v for k, v in full["coll"].items() if v}
    M, esize = 2, torch.finfo(cfg.cdtype).bits // 8
    act = M * 4 * 16 * cfg.d_model * esize
    want = dict.fromkeys(rl.COLLECTIVES, 0)
    want.update({"all-reduce": act * (1 + layers),
                 "all-gather": M * 4 * 16 * cfg.vocab_size * esize})
    assert full["coll"] == want
    assert rec["collective_bytes"] == want


def test_cli_prints_a_cell(capsys):
    """``python -m repro_torch.launch.dryrun --arch --shape``: one decode
    cell at published width, exit 0, its record in ``--out``."""
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dryrun.jsonl")
        with pytest.raises(SystemExit) as ex:
            dr.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--out", out])
        assert ex.value.code == 0
        rec = json.loads(open(out).read().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert "smollm-360m x decode_32k: ok" in capsys.readouterr().out
