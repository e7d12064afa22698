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

from _decode_cases import (MAIN_PATH_SHAPES, SCHED_SHAPES, USL_SHAPES,
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


def test_ising_same_plan_either_route(card):
    cluster = alibaba_cluster(machines=20)
    dag = synth_trace(3, cluster, seed=1)[0]
    prob = tdag.flatten([dag], cluster.num_resources)
    cfg = ising.IsingConfig(chains=32, iters=100, seed=0)
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
