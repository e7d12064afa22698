"""The port's host serial SGS against the JAX package's, bit for bit.

The port places each task against a running usage profile and resolves
each chosen option once; the reference (``repro.core.sgs``) rescans every
placed task at every candidate start and builds the padded option arrays on
every call. Both must give the same starts, finishes, makespans and costs
on the instances the port's own generators draw (``cluster/workloads.py``),
carried into the reference's classes by ``_sgs_cases.as_reference``.
"""
import numpy as np
import pytest

from repro.core import annealer as rannealer
from repro.core import baselines as rbaselines
from repro.core import sgs as rsgs
from repro_torch.cluster.catalog import alibaba_cluster, paper_cluster
from repro_torch.cluster.workloads import (dag1, dag2, motivation_dag,
                                           synth_trace)
from repro_torch.core import annealer, baselines, dag, sgs

from _sgs_cases import as_reference, cluster_as_reference

SEEDS = [0, 1, 2]


def _assert_same_schedule(problem, option_idx, priority, caps):
    ref_s, ref_f = rsgs.sgs_schedule(as_reference(problem), option_idx,
                                     priority=priority, caps=caps)
    s, f = sgs.sgs_schedule(problem, option_idx, priority=priority, caps=caps)
    assert s.dtype == f.dtype == np.float64
    np.testing.assert_array_equal(s, ref_s)
    np.testing.assert_array_equal(f, ref_f)
    return s, f


def _ready_times(problem, finish):
    """Each task's earliest start: its release or its last predecessor's
    finish."""
    ready = np.asarray(problem.release, float).copy()
    for a, b in problem.edges:
        ready[b] = max(ready[b], finish[a])
    return ready


def _alibaba(seed, n=48):
    cluster = alibaba_cluster()
    return cluster, [dag.flatten([d], cluster.num_resources)
                     for d in synth_trace(n, cluster, seed=seed)]


def _aws_joint(seed, tenants=32):
    """``tenants`` paper DAGs drawn from DAG1, DAG2 and the motivation DAG,
    flattened into one joint problem on the m5 cluster."""
    cluster = paper_cluster()
    rng = np.random.default_rng(seed)
    makers = (dag1, dag2, motivation_dag)
    probs = [dag.flatten([makers[int(rng.integers(3))](cluster)],
                         cluster.num_resources) for _ in range(tenants)]
    return cluster, dag.concat_problems(probs)


@pytest.mark.parametrize("seed", SEEDS)
def test_alibaba_airflow_priorities(seed):
    cluster, probs = _alibaba(seed)
    for p in probs:
        oi = np.asarray([t.default_option for t in p.tasks], np.int64)
        pr = p.as_dag().downstream_counts().astype(float)
        _assert_same_schedule(p, oi, pr, cluster.caps)


@pytest.mark.parametrize("seed", SEEDS)
def test_alibaba_random_options_float32_priorities(seed):
    cluster, probs = _alibaba(seed)
    rng = np.random.default_rng(100 + seed)
    for p in probs:
        oi = rng.integers(0, 6, p.num_tasks)
        pr = rng.standard_normal(p.num_tasks).astype(np.float32)
        _assert_same_schedule(p, oi, pr, cluster.caps)


@pytest.mark.parametrize("seed", SEEDS)
def test_aws_joint_binding_capacity(seed):
    cluster, joint = _aws_joint(seed)
    assert 160 <= joint.num_tasks <= 230
    rng = np.random.default_rng(200 + seed)
    oi = rng.integers(0, 36, joint.num_tasks)
    pr = rng.standard_normal(joint.num_tasks)
    s, f = _assert_same_schedule(joint, oi, pr, cluster.caps)
    # the capacity binds: many tasks wait past their ready time
    assert np.mean(s > _ready_times(joint, f)) > 0.5


@pytest.mark.parametrize("scale", [0.25, 0.1, 0.05, 0.03, 0.01])
def test_scaled_down_capacity_makes_most_placements_wait(scale):
    _, probs = _alibaba(7, n=16)
    joint = dag.concat_problems(probs)
    joint.release = np.zeros(joint.num_tasks)
    rng = np.random.default_rng(3)
    oi = rng.integers(0, 6, joint.num_tasks)
    pr = rng.standard_normal(joint.num_tasks)
    dem = joint.chosen_options(oi)[1]
    # a share of the summed demands; at 0.01 some tasks exceed the
    # capacity alone and fall back to the last finish
    caps = dem.sum(axis=0) * scale
    s, f = _assert_same_schedule(joint, oi, pr, caps)
    if scale <= 0.05:
        assert np.mean(s > _ready_times(joint, f)) > 0.5
    assert (dem > caps).any(axis=1).any() == (scale == 0.01)


def _toy_problem(durations, demands, edges=(), release=None, n_opts=None):
    """One task a row; task j's option o is (durations[j][o],
    demands[j][o])."""
    tasks = []
    for j, (ds, rs) in enumerate(zip(durations, demands)):
        opts = [dag.TaskOption(f"o{o}", float(d), tuple(map(float, r)),
                               float(d) * float(sum(r)))
                for o, (d, r) in enumerate(zip(ds, rs))]
        tasks.append(dag.Task(f"t{j}", opts[:(n_opts or {}).get(j, len(opts))]))
    J = len(tasks)
    rel = np.zeros(J) if release is None else np.asarray(release, float)
    return dag.FlatProblem(tasks, list(edges), np.zeros(J, np.int64), ["toy"],
                           rel, len(demands[0][0]))


def _random_toy(rng, ties):
    """A small random instance: integer durations and demands make finish
    times and usages tie; zero durations and zero demands occur."""
    J, M = int(rng.integers(2, 24)), int(rng.integers(1, 5))
    if ties:
        dur = rng.choice([0, 1, 2, 3, 5], (J, 3))
        dem = rng.choice([0, 0, 1, 2], (J, 3, M))
    else:
        dur = np.where(rng.random((J, 3)) < 0.15, 0.0,
                       rng.uniform(0, 10, (J, 3)))
        dem = np.where(rng.random((J, 3, M)) < 0.3, 0.0,
                       rng.uniform(0, 3, (J, 3, M)))
    edges = [(a, b) for a in range(J) for b in range(a + 1, J)
             if rng.random() < 0.15]
    return _toy_problem(dur, dem, edges), M


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "continuous"])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_small_instances(seed, ties):
    rng = np.random.default_rng(300 + seed)
    for _ in range(300):
        p, M = _random_toy(rng, ties)
        caps = rng.choice([1.0, 2.0, 3.0, 0.5, 2.2, np.inf], M)
        oi = rng.integers(0, 3, p.num_tasks)
        pr = (rng.integers(0, 3, p.num_tasks).astype(float) if ties
              else rng.standard_normal(p.num_tasks))
        _assert_same_schedule(p, oi, pr, caps)


def test_ties_among_finish_times():
    # six equal tasks on a resource that holds two: finishes tie in pairs,
    # and each later pair starts at a tied finish
    p = _toy_problem([[4.0]] * 6, [[[1.0]]] * 6)
    s, f = _assert_same_schedule(p, np.zeros(6, np.int64), None,
                                 np.asarray([2.0]))
    np.testing.assert_array_equal(s, [0, 0, 4, 4, 8, 8])


def test_capacity_slack_is_one_nanounit():
    # 0.6 + 0.4000001 passes the capacity by more than the 1e-9 slack and
    # waits; 0.6 + 0.4000000001 stays within it and fits
    p = _toy_problem([[5.0]] * 3, [[[0.6]], [[0.4000001]], [[0.4000000001]]])
    s, _ = _assert_same_schedule(p, np.zeros(3, np.int64),
                                 np.asarray([3.0, 2, 1]), np.asarray([1.0]))
    np.testing.assert_array_equal(s, [0, 5, 0])


def test_zero_duration_and_zero_demand_tasks():
    # task 1 has no demand, task 2 no duration, task 3 neither; all fit
    # where the demanding tasks do not
    p = _toy_problem([[5.0], [7.0], [0.0], [0.0], [5.0]],
                     [[[2.0]], [[0.0]], [[2.0]], [[0.0]], [[2.0]]],
                     edges=[(0, 4)])
    s, f = _assert_same_schedule(p, np.zeros(5, np.int64),
                                 np.asarray([5.0, 4, 3, 2, 1]),
                                 np.asarray([2.0]))
    np.testing.assert_array_equal(s, [0, 0, 5, 0, 5])


def test_release_times_above_zero():
    cluster, probs = _alibaba(11, n=12)
    for i, p in enumerate(probs):
        p.release = np.full(p.num_tasks, 30.0 * (i % 4))
    joint = dag.concat_problems(probs)
    rng = np.random.default_rng(5)
    oi = rng.integers(0, 6, joint.num_tasks)
    caps = np.asarray([128.0, 12.0])
    s, _ = _assert_same_schedule(joint, oi, rng.standard_normal(
        joint.num_tasks), caps)
    assert np.all(s >= joint.release)


def test_option_index_past_a_tasks_count_takes_its_last():
    rng = np.random.default_rng(9)
    p = _toy_problem(rng.uniform(1, 9, (8, 4)), rng.uniform(0, 2, (8, 4, 2)),
                     edges=[(0, 3), (1, 3), (3, 6)],
                     n_opts={0: 1, 2: 2, 3: 3, 5: 1})
    oi = np.full(8, 3, np.int64)          # past the count of tasks 0, 2, 3, 5
    _assert_same_schedule(p, oi, rng.standard_normal(8), np.asarray([2.5, 3]))
    dur, dem = p.chosen_options(oi)
    ref_dur, ref_dem, _, _ = p.option_arrays()
    np.testing.assert_array_equal(dur, ref_dur[np.arange(8), oi])
    np.testing.assert_array_equal(dem, ref_dem[np.arange(8), oi])
    prices = np.asarray([0.3, 1.7])
    assert (sgs.schedule_cost(p, oi, prices)
            == rsgs.schedule_cost(as_reference(p), oi, prices))


@pytest.mark.parametrize("bad", [4, 9, -1, -9])
def test_validate_reports_an_option_index_out_of_range(bad):
    """An index past a narrower task's options is valid (it takes the
    task's last); one outside [0, O), O the widest task's count, is an
    error of the schedule checks, for one problem and jointly."""
    rng = np.random.default_rng(12)
    p = _toy_problem(rng.uniform(1, 9, (8, 4)), rng.uniform(0, 2, (8, 4, 2)),
                     n_opts={0: 1, 2: 2})
    caps = np.asarray([4.0, 4.0])
    oi = np.full(8, 3, np.int64)
    s, f = sgs.sgs_schedule(p, oi, caps=caps)
    assert sgs.validate_schedule(p, oi, s, f, caps) == []
    assert rsgs.validate_schedule(as_reference(p), oi, s, f, caps) == []
    bad_oi = oi.copy()
    bad_oi[2] = bad
    assert (sgs.validate_schedule(p, bad_oi, s, f, caps)
            == ["option index out of range"])
    assert sgs.validate_schedule_many([p, p], [oi, oi], [s, s], [f, f],
                                      2 * caps) == []
    assert (sgs.validate_schedule_many([p, p], [oi, bad_oi], [s, s], [f, f],
                                       2 * caps)
            == ["problem 1: option index out of range"])


@pytest.mark.parametrize("case", list(range(1 + len(SEEDS))),
                         ids=["alibaba"] + [f"aws-joint-{s}" for s in SEEDS])
def test_option_arrays_match_reference(case):
    _, _, probs = list(_deployments())[case]
    for p in probs:
        for ours, ref in zip(p.option_arrays(),
                             as_reference(p).option_arrays()):
            assert ours.dtype == ref.dtype and ours.shape == ref.shape
            np.testing.assert_array_equal(ours, ref)


def test_negative_demand_is_refused():
    p = _toy_problem([[1.0], [1.0]], [[[1.0]], [[-1.0]]])
    with pytest.raises(ValueError, match="non-negative"):
        sgs.sgs_schedule(p, np.zeros(2, np.int64), caps=np.asarray([1.0]))


def _deployments():
    cluster, probs = _alibaba(4, n=24)
    yield "alibaba", cluster, probs
    for seed in SEEDS:
        c, joint = _aws_joint(seed)
        yield f"aws-joint-{seed}", c, [joint]


@pytest.mark.parametrize("case", list(range(1 + len(SEEDS))),
                         ids=["alibaba"] + [f"aws-joint-{s}" for s in SEEDS])
def test_airflow_plan_and_reference_point(case):
    name, cluster, probs = list(_deployments())[case]
    rcluster = cluster_as_reference(cluster)
    for p in probs:
        rp = as_reference(p)
        ours, ref = baselines.airflow_plan(p, cluster), \
            rbaselines.airflow_plan(rp, rcluster)
        np.testing.assert_array_equal(ours.option_idx, ref.option_idx)
        np.testing.assert_array_equal(ours.start, ref.start)
        np.testing.assert_array_equal(ours.finish, ref.finish)
        assert (ours.makespan, ours.cost) == (ref.makespan, ref.cost)
        assert (annealer.reference_point(p, cluster)
                == rannealer.reference_point(rp, rcluster))


@pytest.mark.parametrize("case", list(range(1 + len(SEEDS))),
                         ids=["alibaba"] + [f"aws-joint-{s}" for s in SEEDS])
def test_schedule_cost(case):
    _, cluster, probs = list(_deployments())[case]
    rng = np.random.default_rng(case)
    for p in probs:
        oi = rng.integers(0, max(len(t.options) for t in p.tasks), p.num_tasks)
        dur, dem = p.chosen_options(oi)
        ref = rsgs.schedule_cost(as_reference(p), oi, cluster.prices_per_sec)
        assert sgs.schedule_cost(p, oi, cluster.prices_per_sec) == ref
        assert sgs.schedule_cost(p, oi, cluster.prices_per_sec,
                                 dur, dem) == ref
