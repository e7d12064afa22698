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

from _decode_cases import (MAIN_PATH_SHAPES, SCHED_ENVELOPE_SHAPES,
                           SCHED_MAIN_SHAPES, SCHED_SHAPES, USL_SHAPES,
                           kernel_cases, sched_instance, usl_instance)
from repro_torch.cluster.catalog import alibaba_cluster
from repro_torch.cluster.workloads import synth_trace
from repro_torch.core import dag as tdag
from repro_torch.core import ising
from repro_torch.core import vectorized as vec
from repro_torch.core.objectives import Goal
from repro_torch.kernels import ops
from repro_torch.kernels import sched_violation as sv_kernel
from repro_torch.kernels import sgs_decode as kernel
from repro_torch.kernels import usl_runtime as usl_kernel

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
    W, smem, limit, fits = kernel.geometry(G * rows, J, M, T, rows)
    want = max(w for w in (8, 4, 2, 1) if rows % w == 0)
    if G * rows < 4 * sms:
        want = min(want, 4)
    assert fits and 0 < smem <= limit
    assert W == want


def test_kernel_refuses_shape_beyond_shared_memory(card):
    """A group whose precedence and row state do not fit one block's shared
    memory raises before any launch; nothing is truncated."""
    J, M, T = 2048, 2, 256
    args = [torch.zeros((1, J), dtype=torch.int32, device=card),
            torch.zeros((1, J, M), device=card),
            torch.zeros((1, J), device=card),
            torch.zeros((J,), dtype=torch.int32, device=card),
            torch.zeros((J, J), dtype=torch.bool, device=card),
            torch.ones((M,), device=card)]
    n = kernel.sgs_decode.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.sgs_decode(*args, T=T)
    assert kernel.sgs_decode.launches == n
    assert not kernel.geometry(1, J, M, T, 1)[3]


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


@pytest.mark.parametrize("M,T", [(1, 4097), (9, 16)])
def test_sched_violation_refuses_grid_beyond_envelope(card, M, T):
    """One cell past the envelope (M * T = 4097), or a ninth resource,
    raises before any launch; nothing is truncated."""
    B, J = 4, 3
    args = [torch.zeros((B, J), device=card), torch.ones((B, J), device=card),
            torch.ones((B, M, J), device=card), torch.ones((M,), device=card)]
    n = sv_kernel.sched_violation.launches
    with pytest.raises(ValueError, match="envelope"):
        ops.sched_violation(*args, T=T)
    assert sv_kernel.sched_violation.launches == n


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
