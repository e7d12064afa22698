"""The port's CUDA kernel on the card (marked ``cuda``; each test skips
where ``torch.cuda.is_available()`` is false). Imports no jax, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit-for-bit (the plain
versions fix the order of every float32 sum to the kernels' order), and a
solve must return the same plans whichever of the two routes it runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _decode_cases import (MAIN_PATH_SHAPES, WIDE_CASE_NAMES, SCHED_ENVELOPE_SHAPES,
                           SCHED_MAIN_SHAPES, SCHED_SHAPES, SCHED_WIDE_SHAPES,
                           USL_SHAPES, WIDE_SHAPES, kernel_cases,
                           sched_instance, usl_instance, wide_cases,
                           wide_route)
from repro_torch.cluster.catalog import alibaba_cluster
from repro_torch.configs import get_config
from repro_torch.cluster.workloads import synth_trace
from repro_torch.core import dag as tdag
from repro_torch.core import ising
from repro_torch.core import vectorized as vec
from repro_torch.core.objectives import Goal
from repro_torch.kernels import ops
from repro_torch.kernels import sched_violation as sv_kernel
from repro_torch.kernels import sgs_decode as kernel
from repro_torch.kernels import usl_runtime as usl_kernel
from repro_torch.launch.serve_model import serve
from repro_torch.models.common import Initializer
from repro_torch.models.transformer import Model, init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_kernel_matches_plain_exactly(card):
    for args, T in kernel_cases():
        dev = [torch.from_numpy(a).to(card) for a in args]
        n = kernel.sgs_decode.launches
        got = ops.sgs_decode(*dev, T=T)
        assert kernel.sgs_decode.launches == n + 1
        want = ops.sgs_decode(*dev, T=T, use_kernel=False)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("G,rows,J,M,T", MAIN_PATH_SHAPES)
def test_decode_geometry_gives_each_row_a_scheduler(card, G, rows, J, M,
                                                    T):
    """W rows of one group per block: the largest of 8, 4, 2, 1 dividing
    the group's rows, at most 4 while the rows are fewer than the card's
    schedulers (4 an SM)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    route, W, smem, limit, scratch = kernel.geometry(G * rows, J, M, T, rows)
    want = max(w for w in (8, 4, 2, 1) if rows % w == 0)
    if G * rows < 4 * sms:
        want = min(want, 4)
    assert route == "fast" and 0 < smem <= limit and scratch == 0
    assert W == want


def test_kernel_refuses_shape_beyond_shared_memory(card):
    """Past one block's shared memory the decode takes the wide path (a
    group of J 2048 at M 2, T 256 launches and equals the plain version);
    only a shape whose inputs, outputs and scratch exceed the card's memory
    is refused, before any launch."""
    J, M, T = 2048, 2, 256
    args = [torch.zeros((1, J), dtype=torch.int32, device=card),
            torch.zeros((1, J, M), device=card),
            torch.zeros((1, J), device=card),
            torch.zeros((J,), dtype=torch.int32, device=card),
            torch.zeros((J, J), dtype=torch.bool, device=card),
            torch.ones((M,), device=card)]
    n, w = kernel.sgs_decode.launches, kernel.sgs_decode.wide_launches
    got = ops.sgs_decode(*args, T=T)
    want = ops.sgs_decode(*args, T=T, use_kernel=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.sgs_decode.launches == n + 1
    assert kernel.sgs_decode.wide_launches == w + 1
    # a (J, J) precedence of 90 GB: more than an 80 GB card holds
    assert kernel.geometry(1, 300_000, M, T, 1)[0] is None


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_solve_same_plans_either_decode(card, shared):
    cluster = alibaba_cluster(machines=20)
    dags = synth_trace(3, cluster, seed=11)
    for d in dags:
        d.release_time = 0.0
    probs = [tdag.flatten([d], cluster.num_resources) for d in dags]
    cfg = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    tape = vec.draw_tape(tdag.pack_problems(probs, cluster.num_resources,
                                            bucket_p=4), cfg, card)
    solve = (vec.vectorized_anneal_shared if shared
             else vec.vectorized_anneal_many)
    plans = []
    for use_kernel in (True, False):
        out = solve(probs, cluster, Goal.balanced(),
                    dataclasses.replace(cfg, use_kernel=use_kernel),
                    bucket_p=4, device=card, tape=tape)
        plans.append(out[0] if shared else out)
    for x, y in zip(*plans):
        np.testing.assert_array_equal(x.option_idx, y.option_idx)
        np.testing.assert_array_equal(x.start, y.start)
        np.testing.assert_array_equal(x.finish, y.finish)
        assert x.energy == y.energy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,J,M,T", SCHED_SHAPES)
def test_sched_violation_kernel_matches_plain_exactly(card, B, J, M, T,
                                                      dtype):
    start, dur, dem, caps = (torch.from_numpy(x).to(card)
                             for x in sched_instance(B, J, M, T))
    start, dur, dem = (x.to(dtype) for x in (start, dur, dem))
    n = sv_kernel.sched_violation.launches
    got = ops.sched_violation(start, dur, dem, caps, T=T)
    assert sv_kernel.sched_violation.launches == n + 1
    want = ops.sched_violation(start, dur, dem, caps, T=T, use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert (got >= 0).all()
    free = ops.sched_violation(start, dur, dem, torch.full_like(caps, 1e9),
                               T=T)
    assert torch.equal(free, torch.zeros_like(free))


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,J,M,T", SCHED_MAIN_SHAPES + SCHED_ENVELOPE_SHAPES)
def test_sched_violation_path_and_envelope_shapes_exactly(card, B, J, M, T,
                                                          dtype, transposed):
    """The ising engine's shapes and the envelope's largest grids, with dem
    contiguous or as the ising loop passes it: a (B, M, J) view of a (B, J,
    M) tensor, read through its strides."""
    start, dur, dem, caps = sched_instance(B, J, M, T)
    start, dur, caps = (torch.from_numpy(x).to(card) for x in
                        (start, dur, caps))
    if transposed:
        bjm = torch.empty((B, J, M), device=card)
        bjm.copy_(torch.from_numpy(dem).to(card).transpose(1, 2))
        dem = bjm.transpose(1, 2)
        assert dem.stride() == (J * M, 1, M)
    else:
        dem = torch.from_numpy(dem).to(card)
    start, dur, dem = (x.to(dtype) for x in (start, dur, dem))
    got = ops.sched_violation(start, dur, dem, caps, T=T)
    want = ops.sched_violation(start, dur, dem.contiguous(), caps, T=T,
                               use_kernel=False)
    torch.cuda.synchronize()
    assert got.shape == (B,) and torch.equal(got, want)
    assert (got > 0).any()
    free = ops.sched_violation(start, dur, dem, torch.full_like(caps, 1e9),
                               T=T)
    assert torch.equal(free, torch.zeros_like(free))


@pytest.mark.parametrize("B,J,M,T", [
    s for s in SCHED_SHAPES + SCHED_MAIN_SHAPES + SCHED_ENVELOPE_SHAPES
    if sv_kernel.geometry(s[0], s[2], s[3], 132)[3]])
def test_sched_violation_general_layout_equals_bin_major(card, B, J, M, T):
    """Where ``geometry`` picks the bin-major layout (K > 0), the general
    layout (K = 0) at the same R, W, C gives the same bits."""
    start, dur, dem, caps = (torch.from_numpy(x).to(card)
                             for x in sched_instance(B, J, M, T))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    R, W, C, K, _ = sv_kernel.geometry(B, M, T, sms)
    assert K > 0
    got = sv_kernel.sched_violation(start, dur, dem, caps, T=T,
                                    geom=(R, W, C, 0))
    want = sv_kernel.sched_violation(start, dur, dem, caps, T=T)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,J,M,T", SCHED_WIDE_SHAPES)
def test_sched_violation_wide_path_exactly(card, B, J, M, T, dtype,
                                           transposed):
    """Past the register envelope (M 4 x T 2048, the ising engine at grid
    2048; one cell past 4096; M 9; M 12; J 166) the wide path launches once
    and equals the plain version bit for bit, with dem contiguous or as the
    ising loop passes it."""
    start, dur, dem, caps = sched_instance(B, J, M, T)
    start, dur, caps = (torch.from_numpy(x).to(card) for x in
                        (start, dur, caps))
    dem = torch.from_numpy(dem).to(card)
    if transposed:
        dem = dem.transpose(1, 2).contiguous().transpose(1, 2)
        assert dem.stride()[::2] == (J * M, M)
    start, dur, dem = (x.to(dtype) for x in (start, dur, dem))
    assert sv_kernel.is_wide(M, sv_kernel.geometry(B, M, T, 132)[4])
    n = sv_kernel.sched_violation.launches
    got = ops.sched_violation(start, dur, dem, caps, T=T)
    assert sv_kernel.sched_violation.launches == n + 1
    want = ops.sched_violation(start, dur, dem.contiguous(), caps, T=T,
                               use_kernel=False)
    torch.cuda.synchronize()
    assert got.shape == (B,) and torch.equal(got, want)
    assert (got > 0).any()
    free = ops.sched_violation(start, dur, dem, torch.full_like(caps, 1e9),
                               T=T)
    assert torch.equal(free, torch.zeros_like(free))


def test_ising_serves_grid_2048_through_the_wide_path(card):
    """``ising_anneal(..., IsingConfig(grid=2048))`` on ``paper_cluster()``
    (M 4, 8192 cells): a valid plan, iters + 1 kernel launches."""
    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.cluster.workloads import dag1
    from repro_torch.core.sgs import validate_schedule
    pc = paper_cluster()
    prob = tdag.flatten([dag1(pc)], pc.num_resources)
    cfg = ising.IsingConfig(grid=2048)
    n = sv_kernel.sched_violation.launches
    sol = ising.ising_anneal(prob, pc, Goal.balanced(), cfg, device=card)
    assert sv_kernel.sched_violation.launches == n + cfg.iters + 1
    assert validate_schedule(prob, sol.option_idx, sol.start, sol.finish,
                             pc.caps) == []


# the first J past the fast path's shared memory at M 2, T 256 (a shared
# pool's decode) on an H100, as the card's shared memory per block bounds it
FIRST_WIDE_J = 1194


@pytest.mark.parametrize("case", range(len(WIDE_CASE_NAMES)),
                         ids=WIDE_CASE_NAMES)
def test_sgs_decode_wide_path_exactly(card, case):
    """Shapes past the fast path's shared memory (J 1194, 1792, 2048, 2049
    and 4096 at M 2, T 256 among them) route to the wide routes ("wide" up
    to J 2048, "wide-block" past it or past a block's shared memory) and
    equal the plain version bit for bit, and so does every other route that
    takes the shape; J 1193 still takes the fast path."""
    args, T = wide_cases()[case]
    dev = [torch.from_numpy(a).to(card) for a in args]
    rows, J = args[0].shape
    G, M = args[3].shape[0], args[5].shape[0]
    route = wide_route(J) if case < len(WIDE_SHAPES) else "wide"
    assert kernel.geometry(rows, J, M, T, rows // G)[0] == route
    n, w, b = (kernel.sgs_decode.launches, kernel.sgs_decode.wide_launches,
               kernel.sgs_decode.wide_block_launches)
    got = ops.sgs_decode(*dev, T=T)
    assert kernel.sgs_decode.launches == n + 1
    assert kernel.sgs_decode.wide_launches == w + 1
    assert kernel.sgs_decode.wide_block_launches == b + (route == "wide-block")
    want = ops.sgs_decode(*dev, T=T, use_kernel=False)
    for other in ("wide", "wide-block"):
        if other != route and kernel.geometry(rows, J, M, T, rows // G,
                                              other)[0] == other:
            forced = kernel.sgs_decode(*dev, T=T, route=other)
            for x, y in zip(want, forced):
                assert torch.equal(x, y), other
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert kernel.geometry(256, FIRST_WIDE_J - 1, 2, 256, 256)[0] == "fast"
    assert kernel.geometry(256, FIRST_WIDE_J, 2, 256, 256)[0] == "wide"


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_mesh_solves_on_one_card(card, shared, shape):
    """A (2, 1) or (1, 2) planner mesh over one card: valid plans, one
    decode launch a sweep per shard (and one at the start)."""
    from repro_torch.core.sgs import validate_schedule
    from repro_torch.launch.mesh import make_planner_mesh
    cluster = alibaba_cluster(machines=20)
    dags = synth_trace(3, cluster, seed=11)
    for d in dags:
        d.release_time = 0.0
    probs = [tdag.flatten([d], cluster.num_resources) for d in dags]
    cfg = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    mesh = make_planner_mesh(chains=shape[1], devices=[card] * 2)
    n = kernel.sgs_decode.launches
    if shared:
        sols, joint = vec.vectorized_anneal_shared(
            probs, cluster, Goal.balanced(), cfg, mesh=mesh)
        assert joint == []
        shards, extra = shape[1], 1
    else:
        sols = vec.vectorized_anneal_many(probs, cluster, Goal.balanced(),
                                          cfg, bucket_p=4, mesh=mesh)
        shards, extra = 2, 0
    assert kernel.sgs_decode.launches - n == shards * (cfg.iters + 1) + extra
    for p, sol in zip(probs, sols):
        assert validate_schedule(p, sol.option_idx, sol.start, sol.finish,
                                 cluster.caps) == []


@pytest.mark.parametrize("cell", ["isolated", "shared", "ising-isolated",
                                  "ising-shared"])
def test_quality_rule_holds_on_the_card(card, cell):
    """The full fixture (``tests/torch_golden/quality_full.json``): the
    cell's plans on the card's production draws are valid and hold the
    rule of ``tests/_quality.py`` against the reference's energies."""
    import importlib
    import json
    import os

    import _quality as q
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_golden", "quality_full.json")
    with open(path) as f:
        ref = {int(s): m for s, m in
               json.load(f)["cells"][cell]["seeds"].items()}
    api = q.modules({m: importlib.import_module(f"repro_torch.{m}")
                     for m in q.MODULES}, device=card)
    means, errors = q.sweep(api, cell, "full", seeds=sorted(ref))
    assert errors == []
    holds, mean, bound = q.check({s: m for s, (m, _) in means.items()}, ref)
    assert holds, (cell, mean, bound, means)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", USL_SHAPES)
def test_usl_runtime_kernel_matches_plain_exactly(card, shape, dtype):
    args = [torch.from_numpy(x).to(card).to(dtype)
            for x in usl_instance(shape)]
    n = usl_kernel.usl_runtime.launches
    got = ops.usl_runtime(*args)
    assert usl_kernel.usl_runtime.launches == n + 1
    want = ops.usl_runtime(*args, use_kernel=False)
    torch.cuda.synchronize()
    assert tuple(got.shape) == shape and torch.equal(got, want)


def _ising_same_plan_either_route(card, cfg):
    cluster = alibaba_cluster(machines=20)
    dag = synth_trace(3, cluster, seed=1)[0]
    prob = tdag.flatten([dag], cluster.num_resources)
    tape = ising.ising_tape(prob.option_arrays()[3], cfg, card)
    n = sv_kernel.sched_violation.launches
    sols = [ising.ising_anneal(prob, cluster, Goal.balanced(),
                               dataclasses.replace(cfg, use_kernel=k),
                               device=card, tape=tape)
            for k in (True, False)]
    assert sv_kernel.sched_violation.launches == n + cfg.iters + 1
    a, b = sols
    np.testing.assert_array_equal(a.option_idx, b.option_idx)
    np.testing.assert_array_equal(a.start, b.start)
    np.testing.assert_array_equal(a.finish, b.finish)
    assert a.energy == b.energy


def test_ising_same_plan_either_route(card):
    _ising_same_plan_either_route(card, ising.IsingConfig(chains=32,
                                                          iters=100, seed=0))


@pytest.mark.parametrize("grid", [96, 192])
def test_ising_same_plan_either_route_off_grid(card, grid):
    """A grid of T bins that is no power-of-two multiple of 32 W takes the
    kernel's general layout (``geometry``'s K = 0) on the ising path."""
    cfg = ising.IsingConfig(chains=32, iters=100, seed=0, grid=grid)
    assert sv_kernel.geometry(cfg.chains, 2, grid, 132)[3] == 0
    _ising_same_plan_either_route(card, cfg)


def test_launch_counter_exact_with_8_threads_on_the_card(card):
    """Eight threads launching the decode kernel at once: every launch is
    counted, and each thread's results equal the plain version."""
    import threading
    args, T = kernel_cases()[0]
    dev = [torch.from_numpy(a).to(card) for a in args]
    want = ops.sgs_decode(*dev, T=T, use_kernel=False)
    n = kernel.sgs_decode.launches
    errors = []

    def launch():
        try:
            for _ in range(50):
                got = ops.sgs_decode(*dev, T=T)
                torch.cuda.current_stream().synchronize()
                assert all(torch.equal(a, b) for a, b in zip(want, got))
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert errors == []
    assert kernel.sgs_decode.launches == n + 8 * 50


def test_two_pools_warm_concurrently_on_the_card(card, tmp_path,
                                                 monkeypatch):
    """The serving daemon's first use of the decode kernel from two threads
    at once: the shared and the isolated pool warm on threads of their own
    while the library is not built yet (an empty build directory). It is
    compiled once, both warmups finish, and the counter holds every
    solve's launches."""
    from repro_torch.core.agora import Agora
    from repro_torch.flow.daemon import DaemonConfig, PlannerService, PoolSpec
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "compiles", {})
    _build.use_build_dir(tmp_path)
    cluster = alibaba_cluster(machines=20)
    template = max(synth_trace(4, cluster, seed=3), key=lambda d: d.num_tasks)
    cfg = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    svc = PlannerService(
        Agora(cluster, goal=Goal.balanced(), solver="vectorized",
              vec_cfg=cfg, device=card),
        DaemonConfig(pools=(PoolSpec("shared", shared_capacity=True,
                                     bucket_p=4),
                            PoolSpec("isolated", shared_capacity=False,
                                     bucket_p=4)), max_batch=4))
    n = kernel.sgs_decode.launches
    futures = [e.session.warmup_async(template, max_p=4)
               for e in svc.entries.values()]
    warm = [f.result(timeout=600) for f in futures]
    assert all(set(w) == {4} for w in warm)
    assert _build.compiles == {"sgs_decode": 1}
    assert kernel.sgs_decode.launches - n >= 2 * (cfg.iters + 1)
    for entry in svc.entries.values():
        entry.executor.shutdown()
    svc._widen_pool.shutdown()


def test_model_path_runs_on_the_card_by_default(card):
    """The model path's entry points default to the card: ``Model``,
    ``init_params`` and ``Initializer`` draw there, the model holds its
    matrices once in bfloat16 and its norms' scales in float32, and
    ``serve`` serves there."""
    cfg = get_config("smollm-360m", smoke=True)
    model = Model(cfg)
    assert model.embed.device.type == "cuda"
    assert model.blocks[0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert model.blocks[0]["ln1"]["scale"].dtype == torch.float32
    assert init_params(cfg)["embed"].device.type == "cuda"
    assert Initializer(cfg).device.type == "cuda"
    out = serve(batch=1, prompt_len=2, gen_tokens=2, quiet=True)
    assert out["tokens"].shape == (1, 2)
