"""The port's mesh-sharded solves against the JAX package, on the CPU.

A mesh is a grid of devices driven by one process; here every entry is
the CPU, which changes no result. On the reference's replayed draws (the
tape of ``tests/test_torch_vectorized.py``):

* (1, 1) and (2, 1) planner meshes give the reference's unsharded plans
  bit for bit, isolated and shared;
* a (1, 2) mesh, fed the unsharded tape split by chain shard, gives them
  too: the replica exchange across chain shards is exact.

On production draws a (1, 2) mesh's plans are valid, meshes route through
``Agora`` and ``PlannerSession``, and an arrival inside a warmed bucket
runs no new signature.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import vectorized as jvec
from repro.core.objectives import Goal
from repro_torch.cluster.workloads import synth_trace
from repro_torch.core import vectorized as tvec
from repro_torch.core.agora import Agora
from repro_torch.core.objectives import Goal as TGoal
from repro_torch.core.sgs import validate_schedule
from repro_torch.launch.mesh import (DeviceMesh, make_planner_mesh,
                                     make_solver_mesh)
from test_torch_vectorized import (CPU, JCFG, TCFG, _assert_same_plans,
                                   _problems, _tape)

def _mesh(prob, chains):
    return make_planner_mesh(chains=chains, devices=[CPU] * (prob * chains))


@functools.lru_cache(maxsize=None)
def _reference(shared):
    """The reference's unsharded plans (bucket 4 isolated, as
    tests/test_mesh_planner.py solves them) and the replayed tape."""
    jc, jprobs, _, _ = _problems()
    M = jc.num_resources
    if shared:
        sols, errs = jvec.vectorized_anneal_shared(jprobs, jc,
                                                   Goal.balanced(), JCFG)
        assert errs == []
        return sols, _tape(jprobs, M, None, shared=True)
    sols = jvec.vectorized_anneal_many(jprobs, jc, Goal.balanced(), JCFG,
                                       bucket_p=4)
    return sols, _tape(jprobs, M, 4)


def _port(shared, mesh, tape=None):
    _, _, tc, tprobs = _problems()
    if shared:
        sols, errs = tvec.vectorized_anneal_shared(
            tprobs, tc, TGoal.balanced(), TCFG, mesh=mesh, tape=tape,
            device=CPU)
        assert errs == []
        return sols
    return tvec.vectorized_anneal_many(tprobs, tc, TGoal.balanced(), TCFG,
                                       bucket_p=4, mesh=mesh, tape=tape,
                                       device=CPU)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2)],
                         ids=["1x1", "2x1", "1x2-split-tape"])
@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_mesh_matches_unsharded_reference(shared, shape):
    ref, tape = _reference(shared)
    _assert_same_plans(ref, _port(shared, _mesh(*shape), tape))


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_chain_sharded_production_plans_are_valid(shared):
    """Two chain shards, each on its own streams: valid plans, no joint
    violation; splitting the problems as well changes nothing, since each
    problem's streams are its own."""
    _, _, tc, tprobs = _problems()
    sols = _port(shared, _mesh(1, 2))
    for prob, sol in zip(tprobs, sols):
        assert validate_schedule(prob, sol.option_idx, sol.start, sol.finish,
                                 tc.caps) == []
    if not shared:
        _assert_same_plans(sols, _port(shared, _mesh(2, 2)))


def test_exchange_equals_migration_over_chains_end_to_end():
    """The collective exchange over three shards equals ``_migrate_chains``
    on the chains laid end to end, ties included (first index on both
    sides)."""
    rng = np.random.default_rng(0)
    P, B, J = 3, 12, 5
    e = torch.from_numpy(rng.integers(0, 4, (P, B)).astype(np.float32))
    best_e = torch.from_numpy(rng.integers(-3, 1, (P, B)).astype(np.float32))
    opt = torch.from_numpy(rng.integers(0, 9, (P, B, J)).astype(np.int32))
    prio = torch.from_numpy(rng.normal(size=(P, B, J)).astype(np.float32))
    best_opt, best_prio = opt.flip(1), prio.flip(1)
    want = tvec._migrate_chains(opt, prio, e, best_opt, best_prio, best_e)
    row = []
    for sl in (slice(0, 4), slice(4, 8), slice(8, 12)):
        row.append(SimpleNamespace(
            opt=opt[:, sl], prio=prio[:, sl], e=e[:, sl],
            best_opt=best_opt[:, sl], best_prio=best_prio[:, sl],
            best_e=best_e[:, sl]))
    tvec._exchange(row)
    for k, w in zip(("opt", "prio", "e"), want):
        assert torch.equal(torch.cat([getattr(st, k) for st in row], 1), w)


def test_agora_and_session_route_planner_mesh_without_new_signatures():
    """``Agora(mesh=)`` serves through the sharded engines with the plans
    of the unsharded Agora (a chain axis of 1); a warmed (2, 1) session
    serves an arrival inside its bucket with no new signature."""
    _, _, tc, _ = _problems()
    dags = synth_trace(3, tc, seed=11)
    for d in dags:
        d.release_time = 0.0
    flat = Agora(tc, solver="vectorized", vec_cfg=TCFG, device=CPU)
    meshed = Agora(tc, solver="vectorized", vec_cfg=TCFG, mesh=_mesh(2, 1),
                   device=CPU)
    for shared in (False, True):
        a = flat.session(shared_capacity=shared, bucket_p=4).plan(dags)
        sess = meshed.session(shared_capacity=shared, bucket_p=4)
        sess.warmup(max(dags, key=lambda d: d.num_tasks))
        n0 = sess.stats.trace_count
        b = sess.plan(dags)
        sess.plan(dags[:2])
        assert sess.stats.trace_count == n0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.plan.solution.option_idx,
                                          y.plan.solution.option_idx)
            assert y.validate() == []


def test_chains_mesh_single_problem_solve():
    """``vectorized_anneal(mesh=)`` on a 1-D chains mesh: one device gives
    the unsharded solve; two give a valid plan through the exchange."""
    _, _, tc, tprobs = _problems()
    base = tvec.vectorized_anneal(tprobs[0], tc, TGoal.balanced(), TCFG,
                                  device=CPU)
    one = tvec.vectorized_anneal(tprobs[0], tc, TGoal.balanced(), TCFG,
                                 mesh=make_solver_mesh(devices=[CPU]))
    _assert_same_plans([base], [one])
    two = tvec.vectorized_anneal(tprobs[0], tc, TGoal.balanced(), TCFG,
                                 mesh=make_solver_mesh(devices=[CPU] * 2))
    assert validate_schedule(tprobs[0], two.option_idx, two.start,
                             two.finish, tc.caps) == []


@pytest.mark.parametrize("n,chains,shape", [(1, 1, (1, 1)), (2, 1, (2, 1)),
                                            (6, 1, (4, 1)), (6, 2, (2, 2)),
                                            (4, 4, (1, 4))])
def test_planner_mesh_clamps_problem_axis(n, chains, shape):
    mesh = make_planner_mesh(chains=chains, devices=["cpu"] * n)
    assert mesh.devices.shape == shape
    assert mesh.shape == {"prob": shape[0], "chain": shape[1]}
    assert mesh == DeviceMesh(mesh.devices, ("prob", "chain"))


def test_meshes_refuse_bad_layouts_and_default_to_the_card():
    with pytest.raises(ValueError, match="chain shards"):
        make_planner_mesh(chains=2, devices=["cpu"] * 3)
    _, _, tc, tprobs = _problems()
    with pytest.raises(ValueError, match="do not split"):
        tvec.vectorized_anneal_many(tprobs, tc, TGoal.balanced(),
                                    tvec.VecConfig(chains=6, iters=2),
                                    mesh=_mesh(1, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_planner_mesh()
