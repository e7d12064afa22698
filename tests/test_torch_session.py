"""The port's front door on the CPU: ``Agora`` and ``PlannerSession``.

Plans from both solvers validate, the signature count (``trace_count``)
stays flat after ``warmup``, meshes route to their engines, and the copied
framework-free modules give the JAX package's results for the same seeds.
"""
import numpy as np
import pytest

from repro.cluster import catalog as jcat
from repro.cluster import workloads as jwl
from repro.core import dag as jdag
from repro.core.annealer import reference_point as j_reference_point
from repro_torch.cluster import catalog as tcat
from repro_torch.cluster import workloads as twl
from repro_torch.core import dag as tdag
from repro_torch.core.agora import Agora
from repro_torch.core.annealer import AnnealConfig
from repro_torch.core.annealer import reference_point as t_reference_point
from repro_torch.core.session import PlanRequest
from repro_torch.core.vectorized import VecConfig

SMALL = VecConfig(chains=8, iters=20, grid=64, seed=0)
FAST_ANNEAL = AnnealConfig(min_iters=20, max_iters=60, exact_task_limit=0)


def _trace(n=3, seed=5):
    cluster = tcat.alibaba_cluster(machines=20)
    return cluster, twl.synth_trace(n, cluster, seed=seed)


@pytest.mark.parametrize("solver", ["vectorized", "anneal"])
def test_agora_plans_validate(solver):
    cluster = tcat.paper_cluster()
    agora = Agora(cluster, solver=solver, vec_cfg=SMALL,
                  anneal_cfg=FAST_ANNEAL, device="cpu")
    plan = agora.plan([twl.dag1(cluster)])
    assert plan.validate() == []
    assert np.isfinite(plan.makespan) and plan.makespan > 0


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
@pytest.mark.parametrize("solver", ["vectorized", "anneal"])
def test_session_serves_valid_plans(solver, shared):
    cluster, dags = _trace()
    agora = Agora(cluster, solver=solver, vec_cfg=SMALL,
                  anneal_cfg=FAST_ANNEAL, device="cpu")
    sess = agora.session(shared_capacity=shared, bucket_p=4)
    res = sess.plan([PlanRequest(dag=d) for d in dags])
    assert len(res) == len(dags)
    for r in res:
        assert r.validate() == []
        assert r.bucket == 4
        if shared:
            assert r.plan.joint_errors == []


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_trace_count_flat_after_warmup(shared):
    cluster, dags = _trace(n=3, seed=5)
    template = max(dags, key=lambda d: d.num_tasks)
    agora = Agora(cluster, solver="vectorized", vec_cfg=SMALL, device="cpu")
    sess = agora.session(shared_capacity=shared, bucket_p=4)
    warm = sess.warmup(template)
    assert set(warm) == {4}
    jmax = template.num_tasks
    omax = max(len(t.options) for t in template.tasks)
    assert sess.is_warm(len(dags), jmax, omax)
    n0 = sess.stats.trace_count
    for _ in range(2):
        res = sess.plan(dags)
        assert not any(r.traced for r in res)
        assert all(r.validate() == [] for r in res)
    assert sess.stats.trace_count == n0
    assert sess.stats.cache_hits >= 2
    assert sess.stats.bucket(4).steady_seconds > 0


def test_unported_engines_raise():
    """No engine is left unported: ``Agora(mesh=)`` and ``session(mesh=)``
    take a planner mesh (the batched engines shard on it) or a chains mesh
    (the host loop over the sharded single-problem solve), as the
    reference routes them; an object that is no mesh still raises."""
    from repro_torch.launch.mesh import make_planner_mesh, make_solver_mesh
    cluster = tcat.paper_cluster()
    planner = make_planner_mesh(chains=1, devices=["cpu", "cpu"])
    chains = make_solver_mesh(devices=["cpu", "cpu"])
    agora = Agora(cluster, solver="vectorized", vec_cfg=SMALL, mesh=planner,
                  device="cpu")
    assert agora.session().engine.key == "isolated"
    assert agora.session(shared_capacity=True).engine.key == "shared"
    assert agora.session(mesh=chains).engine.key == "host-anneal"
    assert agora.session(mesh=None).engine.key == "isolated"
    with pytest.raises(AttributeError):
        agora.session(mesh=object())


# --- the copied framework-free modules give the reference's results ------


def _j_trace(seed):
    c = jcat.alibaba_cluster(machines=20)
    return c, jwl.synth_trace(4, c, seed=seed)


def _t_trace(seed):
    c = tcat.alibaba_cluster(machines=20)
    return c, twl.synth_trace(4, c, seed=seed)


def _dag_fields(d):
    return (d.name, d.release_time, list(d.edges),
            [(t.name, t.default_option,
              [(o.label, o.duration, o.demands, o.cost) for o in t.options])
             for t in d.tasks])


def _synth(seed):
    return ([_dag_fields(d) for d in _j_trace(seed)[1]],
            [_dag_fields(d) for d in _t_trace(seed)[1]])


def _flatten(seed):
    (jc, jd), (tc, td) = _j_trace(seed), _t_trace(seed)
    a = jdag.flatten(jd, jc.num_resources).option_arrays()
    b = tdag.flatten(td, tc.num_resources).option_arrays()
    return [np.asarray(x) for x in a], [np.asarray(x) for x in b]


def _pack(seed):
    (jc, jd), (tc, td) = _j_trace(seed), _t_trace(seed)
    a = jdag.pack_problems([jdag.flatten([d], 2) for d in jd], 2,
                           shared_capacity=True, bucket_p=8)
    b = tdag.pack_problems([tdag.flatten([d], 2) for d in td], 2,
                           shared_capacity=True, bucket_p=8)
    keys = ("durations", "demands", "costs", "n_opts", "num_tasks",
            "task_mask", "pred_mask", "release", "default_option")
    la, lb = a.shared_layout(), b.shared_layout()
    return ([getattr(a, k) for k in keys] + [la.pred_mask, la.slot_mask],
            [getattr(b, k) for k in keys] + [lb.pred_mask, lb.slot_mask])


def _refpoint(seed):
    (jc, jd), (tc, td) = _j_trace(seed), _t_trace(seed)
    return ([j_reference_point(jdag.flatten([d], 2), jc) for d in jd],
            [t_reference_point(tdag.flatten([d], 2), tc) for d in td])


@pytest.mark.parametrize("what", [_synth, _flatten, _pack, _refpoint],
                         ids=["synth_trace", "flatten", "pack_problems",
                              "reference_point"])
@pytest.mark.parametrize("seed", [0, 11])
def test_copied_modules_match_reference(what, seed):
    a, b = what(seed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
