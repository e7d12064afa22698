"""Multi-pod dry run (PyTorch port of ``repro/launch/dryrun.py``): trace
every (arch x input-shape x mesh) cell's step at the cell's global shapes
and extract the costs and memory of the roofline tables.

The reference lowers and compiles each step against placeholder devices
(``--xla_force_host_platform_device_count``, set at its import) and reads
XLA's ``cost_analysis`` and ``memory_analysis`` of one partition, times
the chips. The port's counterpart is one trace of the step on the
``meta`` device: every tensor has a shape and a dtype and no storage, so
nothing is allocated on any device and a cell of any size traces on a
laptop. The mesh is the production mesh of ``"meta"`` entries
(``launch/mesh.py:make_production_mesh``); nothing is set in the
environment, at import or after. The model runs sharded over it, as the
reference's does (``models/transformer.py:_sharded``), and since every
entry of an all-``meta`` mesh computes the same shapes, it runs entry
(0, ..., 0) alone for all of them (``models/common.py:Entries``): the
reference's own method of one partition's counts times the chips. The
trace runs under ``_Counter``, one dispatch mode that counts

- ``hlo_flops``: the matrix products' and convolutions' FLOPs by
  ``torch.utils.flop_counter``'s formulas, the count
  ``FlopCounterMode`` gives (tested equal; XLA counts elementwise
  operations too, these formulas do not);
- ``hlo_bytes``: each aten op's tensor operands and results by their
  bytes, the unfused count, as XLA:CPU's "bytes accessed" is. Views
  (ops whose result shares an operand's storage and that do not mutate)
  and ``empty`` tensors count 0; an in-place op counts its operands and
  its result;
- the storages the step allocates while they live, for the peak.

Each op is weighed by the mesh entries it stands for
(``launch/mesh.py:standing_for``): the one entry's work (forward, and in
the backward each autograd node by the weight in force where the forward
made it, read from its sequence number) by the entries it runs for, the
chips; work the port does once on the model's device (the batch split,
the gathered logits' concatenation and loss, AdamW, the sums that gather
a shared leaf's gradient) once; a collective's own copies and sums not
at all, since its traffic is its collective bytes. So each count is
global, and equals a run of the same sharded program with every entry
run (tested on CPU meshes at SMOKE size). ``hlo_flops`` and ``hlo_bytes``
count replicated compute (norms, the router, MLA's latent) on every
entry, as XLA's per-partition counts do, and so exceed the unsharded
program's.

The step is the port's (``launch/steps.py``): the train step is
``Model.loss``'s value and gradient under the config's remat, then
``adamw.update``, with the model's parameters float32; the prefill and
serve steps run a serving model, its matrices in ``cfg.dtype``.
Collective bytes are the bytes the sharded program moves between mesh
entries by kind (``roofline.collective_bytes``, from ``DeviceMesh.hops``:
every participant's output bytes, the reference's convention), the
backward's included: each collective's transpose, the rematerialized
forward's collectives again, and the gradients' all-reduce over the data
axes. ``memory`` keeps the reference's keys:

- ``argument_bytes``: per device, each argument leaf's bytes (the
  parameters, the optimizer state, the batch, the cache) divided by the
  sizes of the mesh axes its spec shards it over;
- ``output_bytes``: the step's outputs that are not its arguments (the
  train and serve steps update their arguments in place), unsharded;
- ``temp_bytes``: the most bytes the step's own allocations held at once
  in the trace: the one entry's part of the sharded program, beside what
  the port holds once on the model's device (the gathered logits, the
  gradients of the whole leaves, AdamW's temporaries). It is neither one
  device's nor the unsharded program's;
- ``peak_bytes``: the unsharded arguments' bytes plus ``temp_bytes``.

``lower_s`` is the trace's seconds; ``compile_s`` is kept, 0 in
``run_cell`` (nothing compiles), so readers of the reference's records
find it, and in ``run_roofline_cell`` it is the two traces' seconds, as
the reference's is its two compiles'.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mode roofline
  python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import roofline as rl
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import listen, make_production_mesh, stands_for
from repro_torch.launch.steps import (StepBundle, abstract_opt_state,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, sharding_of)
from repro_torch.models.common import block_bytes
from repro_torch.models.transformer import Model, param_specs
from repro_torch.optim import adamw
from repro_torch.tree import leaves, map_tree


def production_mesh(multi_pod: bool):
    """The production mesh of ``meta`` entries: the dry run's placeholder
    devices."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod
                                                    else 256))


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flat(args, kwargs):
    """An aten call's arguments flattened one level (an aten argument is a
    value or a list of values), and their structure: the keyword names
    and each argument's length, -1 for a value."""
    flat, lengths = [], []
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            flat.extend(a)
            lengths.append(len(a))
        else:
            flat.append(a)
            lengths.append(-1)
    return flat, (tuple(kwargs), tuple(lengths))


def _results(out):
    """The tensors an aten op returned."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


# the argument types a memo key holds by value
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _storage(t):
    """The identity of ``t``'s storage, one for every tensor that aliases
    it (the Python storage object is kept while its storage lives)."""
    return id(t.untyped_storage())


class _Counter(TorchDispatchMode):
    """While active, counts the aten ops that run:

    - ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s formula
      table (``flop_registry``), the one ``FlopCounterMode`` reads;
    - ``bytes``: each op's tensor operands' and results' bytes. A view
      counts 0, and so does ``empty``. An op is a view where its schema
      says so, or where a result shares an operand's storage and the op
      does not mutate: ``_unsafe_view`` (the last step of a ``reshape``
      that copies) and ``unsafe_split`` alias their input without saying
      so in their schemas;
    - ``live``, ``peak``: the bytes of the storages the ops allocate while
      those live, now and at most. Storages alive when it was made
      (``known``: the arguments) are not the step's own and not tracked.

    FLOPs and bytes are weighed by the mesh entries each op stands for:
    the innermost ``standing_for``'s weight where one is in force, else,
    in the backward, the weight in force where the forward made the
    autograd node that runs (``note`` records each change against
    autograd's sequence numbers), else 1.

    On ``meta`` tensors it also memoizes: an op that is no view and does
    not mutate, called again on arguments of the same shapes, strides,
    dtypes and other values, gets fresh empty results of the shapes,
    strides and dtypes its first call gave, without its meta kernel (most
    are Python, and a chunked recurrence calls the same ops thousands of
    times). A call whose results alias an operand is never memoized, so a
    hit is a call that allocates as its first did. The counts do not
    change."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = {_storage(t) for t in known}
        self._refs = {}              # storage id -> its weak reference
        self._memo = {}
        self._ops = {}               # op -> (view, mutates, empty, formula)
        self._seqs, self._weights = [], []

    def note(self, seq: int, weight) -> None:
        """From autograd sequence number ``seq`` on, nodes stand for
        ``weight`` entries (None: outside any ``standing_for``)."""
        self._seqs.append(seq)
        self._weights.append(weight)

    def weight(self) -> int:
        w = stands_for()
        if w is not None:
            return w
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        k = bisect.bisect_right(self._seqs, node._sequence_nr()) - 1
        w = self._weights[k] if k >= 0 else None
        return 1 if w is None else w

    def _op(self, func):
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = (
                func.is_view, func._schema.is_mutable,
                func.__name__.startswith("empty"),
                flop_registry.get(func._overloadpacket))
        return op

    def _release(self, key, n):
        self._seen.discard(key)
        del self._refs[key]
        self.live -= n

    def _key(self, func, flat, spec):
        """The memo key of a call, None where a call cannot be memoized (a
        tensor off ``meta``, an argument not held by value)."""
        key = [func, spec]
        for a in flat:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                key.append((a.shape, a.stride(), a.dtype))
            elif isinstance(a, _SCALARS):
                key.append((type(a), a))
            else:
                return None
        return tuple(key)

    def _call(self, func, flat, spec, args, kwargs):
        """(the result of a call that does not mutate, whether a result
        aliases an operand)."""
        key = self._key(func, flat, spec)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            kind, metas = hit
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in metas]
            return (made[0] if kind is None else kind(made)), False
        out = func(*args, **kwargs)
        made = _results(out)
        ins = {_storage(a) for a in flat if isinstance(a, torch.Tensor)}
        if any(_storage(o) in ins for o in made):
            return out, True
        if key is None or not made or any(o.device.type != "meta"
                                          for o in made):
            return out, False       # a factory's tensors on a real device
        if isinstance(out, torch.Tensor):
            self._memo[key] = (None, [(out.shape, out.stride(), out.dtype)])
        elif len(made) == len(out):
            self._memo[key] = (type(out), [(o.shape, o.stride(), o.dtype)
                                           for o in out])
        return out, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        view, mutates, empty, formula = self._op(func)
        flat, spec = _flat(args, kwargs)
        if view or mutates:
            out = func(*args, **kwargs)
        else:
            out, view = self._call(func, flat, spec, args, kwargs)
        w = self.weight()
        if formula is not None and w:
            self.flops += w * formula(*args, **kwargs, out_val=out)
        if view or empty:
            return out
        n = 0
        for t in flat:
            if isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()
        for t in _results(out):
            n += t.numel() * t.element_size()
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            size = st.nbytes()
            self._seen.add(key)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, size=size: self._release(key, size))
            self.live += size
            if self.live > self.peak:
                self.peak = self.live
        self.bytes += w * n
        return out


def trace(bundle: StepBundle, modes=(), mesh=None) -> dict:
    """Runs ``bundle.fn(*bundle.args)`` once under ``_Counter``: {"flops",
    "bytes", "temp_bytes", "output_bytes", "coll", "seconds"}, "coll" the
    bytes this run moved between ``mesh``'s entries by collective kind
    (``roofline.collective_bytes``; the mesh's count goes on across
    runs). Meant for ``meta`` arguments; on real tensors it runs the step
    for real and counts the same. ``modes`` (dispatch modes, a
    ``FlopCounterMode`` say) are entered above the counter, so they see
    every op of the trace, and its memo spares them the meta kernels."""
    args = _tensors(bundle.args)
    before = rl.collective_bytes(mesh)
    t0 = time.monotonic()
    counter = _Counter(args)
    counter.note(torch._C._autograd._get_sequence_nr(), stands_for())
    listen(counter.note)
    try:
        with contextlib.ExitStack() as stack:
            for mode in (counter, *modes):
                stack.enter_context(mode)
            out = bundle.fn(*bundle.args)
    finally:
        listen(None)
    seconds = time.monotonic() - t0
    after = rl.collective_bytes(mesh)
    mine = {_storage(t) for t in args}
    outputs = {_storage(t): t.untyped_storage().nbytes()
               for t in _tensors(out)}
    return {"flops": float(counter.flops),
            "bytes": float(counter.bytes),
            "temp_bytes": int(counter.peak),
            "output_bytes": int(sum(n for k, n in outputs.items()
                                    if k not in mine)),
            "coll": {k: after[k] - before[k] for k in after},
            "seconds": seconds}


def argument_bytes(bundle: StepBundle, mesh) -> Dict[str, int]:
    """{"argument_bytes": per device, each leaf's bytes over the mesh axes
    its spec shards it over; "unsharded": the leaves' bytes}."""
    per, whole = 0, 0
    for tree, specs in zip(bundle.args, bundle.in_shardings):
        for t, spec in zip(leaves(tree), _specs(tree, specs)):
            whole += t.numel() * t.element_size()
            per += block_bytes(t, spec, mesh)
    return {"argument_bytes": per, "unsharded": whole}


def _specs(tree, specs):
    """The specs of ``tree``'s leaves, in ``leaves`` order."""
    out = []
    map_tree(lambda _, s: out.append(s), tree, specs)
    return out


def lower_cell(arch: str, shape_name: str, mesh, *, opt_overrides=None,
               shape: Optional[shp.ShapeSpec] = None, device="meta"):
    """Returns (bundle, cfg, model, shape): the cell's step with its
    abstract arguments and their specs. ``shape`` replaces
    ``SHAPES[shape_name]`` (a cell of another batch or length); with
    ``device`` other than "meta" the arguments are real tensors (zeros;
    tokens 0), for a run of the same step. Raises on a spec that does not
    fit its leaf."""
    cfg = get_config(arch)
    if opt_overrides:
        cfg = cfg.replace(**opt_overrides)
    shape = shape or shp.SHAPES[shape_name]
    train = shape.kind == "train"
    # a mesh of meta entries runs the sharded program on meta, one entry
    # for all (models/common.py:Entries)
    model = Model(cfg, device=device, trainable=train, mesh=mesh)
    params = model.params()
    pspecs = param_specs(cfg, mesh)
    batch, bspecs = shp.input_specs(cfg, shape, mesh)
    if device != "meta":
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
    if train:
        step = make_train_step(model, adamw.AdamWConfig())
        opt_state, ospecs = abstract_opt_state(params, pspecs)
        if device != "meta":
            opt_state = adamw.init(params, adamw.AdamWConfig())
        # the step reads the parameters through the model, in place
        args, specs = (params, opt_state, batch), (pspecs, ospecs, bspecs)
        fn = lambda params, opt_state, batch: step(opt_state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        args, specs = (params, batch), (pspecs, bspecs)
        fn = lambda params, batch: step(batch)  # noqa: E731
    else:  # decode
        serve = make_serve_step(model)
        if device == "meta":
            cache, cspecs = shp.abstract_cache(model, shape)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len)
            cspecs = model.cache_specs(shape.global_batch, shape.seq_len)
        args, specs = (params, cache, batch), (pspecs, cspecs, bspecs)
        fn = lambda params, cache, batch: serve(cache, batch, 0)  # noqa: E731
    in_shardings = tuple(sharding_of(a, s) for a, s in zip(args, specs))
    bundle = StepBundle(fn, args, in_shardings, None)
    return bundle, cfg, model, shape


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_overrides=None) -> dict:
    """One cell traced at full depth on the production mesh."""
    mesh = production_mesh(multi_pod)
    t0 = time.monotonic()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": rl.mesh_name(mesh), "chips": int(mesh.devices.size),
           "status": "ok"}
    cfg = get_config(arch)
    skip = shp.runnable(cfg, shp.SHAPES[shape_name])
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    try:
        bundle, cfg, model, shape = lower_cell(arch, shape_name, mesh,
                                               opt_overrides=opt_overrides)
        costs = trace(bundle, mesh=mesh)
        t_lower = time.monotonic() - t0

        chips = int(mesh.devices.size)
        args = argument_bytes(bundle, mesh)
        mem_stats = {
            "argument_bytes": args["argument_bytes"],
            "output_bytes": costs["output_bytes"],
            "temp_bytes": costs["temp_bytes"],
            "peak_bytes": args["unsharded"] + costs["temp_bytes"],
        }
        coll = costs["coll"]
        mf = rl.model_flops(cfg, shape, shape.kind)
        roof = rl.Roofline(arch, shape_name, rl.mesh_name(mesh),
                           chips, costs["flops"], costs["bytes"],
                           float(sum(coll.values())), mf)
        rec.update(
            lower_s=round(t_lower, 1), compile_s=0.0,
            hlo_flops=costs["flops"], hlo_bytes=costs["bytes"],
            collective_bytes=coll, collective_total=float(sum(coll.values())),
            model_flops=mf, memory=mem_stats,
            t_compute=roof.t_compute, t_memory=roof.t_memory,
            t_collective=roof.t_collective, dominant=roof.dominant,
            useful_ratio=roof.useful_ratio,
            roofline_fraction=roof.roofline_fraction,
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def _layer_unit(cfg) -> int:
    if cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.block_pattern == "zamba2":
        return cfg.shared_attn_every
    return 1


def _cell_costs(arch: str, shape_name: str, mesh, layers: int,
                extra_overrides=None) -> dict:
    """Trace one reduced-depth variant and return its raw costs and the
    bundle's argument bytes."""
    ov = {"scan_layers": False, "num_layers": layers}
    ov.update(extra_overrides or {})
    bundle, cfg, model, shape = lower_cell(arch, shape_name, mesh,
                                           opt_overrides=ov)
    costs = trace(bundle, mesh=mesh)
    return {
        "flops": costs["flops"],
        "bytes": costs["bytes"],
        "coll": costs["coll"],
        "args": argument_bytes(bundle, mesh)["argument_bytes"],
    }


def run_roofline_cell(arch: str, shape_name: str,
                      multi_pod: bool = False) -> dict:
    """Exact-accounting roofline, the reference's: it compiles 1-unit and
    2-unit unrolled variants at full width and extrapolates linearly,
    because XLA counts a loop body once. The port's eager trace counts
    every layer, so a full-depth trace would count them too; the
    extrapolation is kept, so the records are built as the reference's
    are, and it is exact for these homogeneous stacks (tested against
    full-depth traces). ``memory.argument_bytes`` is extrapolated the
    same way."""
    mesh = production_mesh(multi_pod)
    cfg = get_config(arch)
    shape = shp.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": rl.mesh_name(mesh),
           "chips": int(mesh.devices.size), "status": "ok",
           "kind": "roofline"}
    skip = shp.runnable(cfg, shape)
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    try:
        t0 = time.monotonic()
        unit = _layer_unit(cfg)
        L1 = cfg.first_dense + unit
        L2 = L1 + unit
        n_units = (cfg.num_layers - cfg.first_dense) // unit
        c1 = _cell_costs(arch, shape_name, mesh, L1)
        c2 = _cell_costs(arch, shape_name, mesh, L2)

        def extrap(a, b):
            return a + (n_units - 1) * (b - a)

        flops = extrap(c1["flops"], c2["flops"])
        bytes_acc = extrap(c1["bytes"], c2["bytes"])
        coll = {k: extrap(c1["coll"][k], c2["coll"][k]) for k in c1["coll"]}
        mf = rl.model_flops(cfg, shape, shape.kind)
        est = rl.estimate_hbm_bytes(cfg, shape, shape.kind)
        roof = rl.Roofline(arch, shape_name, rl.mesh_name(mesh),
                           int(mesh.devices.size), flops, bytes_acc,
                           float(sum(coll.values())), mf, est_hbm_bytes=est)
        rec.update(
            compile_s=round(time.monotonic() - t0, 1),
            hlo_flops=flops, hlo_bytes=bytes_acc,
            collective_bytes=coll, collective_total=float(sum(coll.values())),
            model_flops=mf, est_hbm_bytes=est,
            memory={"argument_bytes": extrap(c1["args"], c2["args"])},
            t_compute=roof.t_compute, t_memory=roof.t_memory,
            t_memory_est=roof.t_memory_est,
            t_collective=roof.t_collective, dominant=roof.dominant,
            dominant_est=roof.dominant_est,
            useful_ratio=roof.useful_ratio,
            roofline_fraction=roof.roofline_fraction,
            roofline_fraction_est=roof.roofline_fraction_est,
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mode", default="compile", choices=["compile", "roofline"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out_f = open(args.out, "a") if args.out else None
    n_bad = 0
    try:
        for multi_pod in meshes:
            for arch in archs:
                for shape_name in shapes:
                    if args.mode == "roofline":
                        rec = run_roofline_cell(arch, shape_name, multi_pod)
                    else:
                        rec = run_cell(arch, shape_name, multi_pod)
                    line = json.dumps(rec)
                    if out_f:
                        out_f.write(line + "\n")
                        out_f.flush()
                    status = rec["status"]
                    msg = f"[{rec['mesh']}] {arch} x {shape_name}: {status}"
                    if status == "ok":
                        msg += (f"  compile={rec['compile_s']}s"
                                f" dominant={rec['dominant']}"
                                f" roofline="
                                f"{rec['roofline_fraction'] * 100:.1f}%")
                    elif status == "error":
                        n_bad += 1
                        msg += "  " + rec["error"][:200]
                    print(msg, flush=True)
                    if status == "ok" and len(archs) == 1 and len(shapes) == 1:
                        print("memory:", json.dumps(rec.get("memory", {})))
                        print("costs: flops=%.4g bytes=%.4g (global)"
                              % (rec.get("hlo_flops", 0),
                                 rec.get("hlo_bytes", 0)))
                        print("collectives:",
                              json.dumps(rec.get("collective_bytes", {})))
    finally:
        if out_f:
            out_f.close()
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
