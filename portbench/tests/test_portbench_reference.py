"""The reference against hand-made faults, and the frozen generators and the
reference's scheduler against the program's originals (CPU)."""
import numpy as np
import pytest

from portbench import gen, reference

ALIBABA = dict(kind="alibaba", machines=4034, cores_per_machine=96,
               cpu_frac=0.8, mem_frac=0.6, core_price_per_hour=0.00296875)
AWS = dict(kind="aws_m5", max_per_type=16)
SYNTH = dict(kind="synth_trace", tasks_lo=6, tasks_hi=14, width=4,
             pool_seed=2018)
PAPER = dict(kind="paper_dags", mix=dict(dag1=1, dag2=1, motivation=1),
             pool_seed=2022)


def _plans(dags, cluster, dtype=np.float64):
    """Sound plans: the default Airflow plan of DAGs sharing the cluster."""
    prices = gen.prices_per_sec(cluster)
    out = []
    for g, d in zip(dags, reference.airflow_group(dags, cluster["caps"],
                                                  dtype)):
        out.append(dict(option_idx=d["option_idx"],
                        start=d["start"].astype(np.float64),
                        finish=d["finish"].astype(np.float64),
                        makespan=float(d["finish"].max()),
                        cost=reference.plan_cost(g, d["option_idx"], prices)))
    return out


@pytest.fixture(scope="module")
def aws():
    cluster = gen.cluster_arrays(AWS)
    return cluster, gen.dag_arrays(PAPER, 8, cluster, 11)


def _judge(cluster, dags, plans, groups):
    return reference.judge(dags, plans, groups, cluster["caps"],
                           gen.prices_per_sec(cluster), 0.5)


def test_sound_plans_pass(aws):
    cluster, dags = aws
    res = _judge(cluster, dags, _plans(dags, cluster), [list(range(8))])
    assert res["plan_err"] < 1e-13 and res["mismatched"] == 0
    assert res["missing"] == 0 and len(res["gains"]) == 8
    # a plan against its own default gains exactly nothing
    assert max(abs(x) for x in res["gains"]) < 1e-12


def test_broken_precedence_is_caught():
    cluster = gen.cluster_arrays(ALIBABA)       # capacity never binds
    dags = gen.dag_arrays(SYNTH, 1, cluster, 4)
    plans = _plans(dags, cluster)
    a, b = dags[0]["edges"][0]
    shift = plans[0]["start"][b] - plans[0]["finish"][a] + 1.0
    plans[0]["start"][b] -= shift
    plans[0]["finish"][b] -= shift
    res = _judge(cluster, dags, plans, [[0]])
    assert res["plan_err"] > 1e-3 and "edge" in res["why"]


def test_capacity_overrun_is_caught(aws):
    cluster, dags = aws
    plans = _plans(dags[:2], cluster)
    # both tenants' first tasks (all 16 m5.4xlarge each) at once
    for p in plans:
        d = p["finish"][0] - p["start"][0]
        p["start"][0], p["finish"][0] = 0.0, d
    res = _judge(cluster, dags[:2], plans, [[0, 1]])
    assert res["plan_err"] >= 1.0 and res["why"] == "capacity"
    # judged apart (an isolated pool), the same plans fit
    assert _judge(cluster, dags[:2], plans, [[0], [1]])["plan_err"] < 1e-13


def test_wrong_duration_is_caught(aws):
    cluster, dags = aws
    plans = _plans(dags[:1], cluster)
    plans[0]["finish"][-1] += 1e-6
    plans[0]["makespan"] = float(plans[0]["finish"].max())
    res = _judge(cluster, dags[:1], plans, [[0]])
    assert res["plan_err"] > 1e-10 and "duration" in res["why"]


def test_swapped_result_is_caught():
    cluster = gen.cluster_arrays(ALIBABA)
    dags = gen.dag_arrays(SYNTH, 2, cluster, 5)
    plans = _plans(dags, cluster)
    res = _judge(cluster, dags, plans[::-1], [[0], [1]])
    assert res["mismatched"] > 0 or res["plan_err"] > 1e-3


def test_missing_and_wrong_report():
    cluster = gen.cluster_arrays(ALIBABA)
    dags = gen.dag_arrays(SYNTH, 3, cluster, 6)
    plans = _plans(dags, cluster)
    plans[1] = None
    plans[2]["cost"] *= 1.0 + 1e-6
    res = _judge(cluster, dags, plans, [[0], [1], [2]])
    assert res["missing"] == 1 and "cost" in res["why"]


def test_float32_control_fails_the_limit():
    """The control reads far over the limit on both configurations."""
    from portbench import control
    for wl in ("alibaba-iso-backlog", "aws-shared-backlog"):
        res = control.control_run(wl, 3, 96)
        assert not res["correct"] and res["plan_err"] > 1e2 * res["limit"]
        sound = control.control_run(wl, 3, 96, np.float64)
        assert sound["correct"] and sound["plan_err"] < 1e-4 * res["limit"]


def test_bulk_synth_trace_keeps_the_original_recipe():
    """The bulk draws against the program's ``synth_trace``: the same
    structure DAG by DAG, the same distributions over 3000 DAGs."""
    from repro_torch.cluster.catalog import alibaba_cluster
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.dag import flatten
    cluster = gen.cluster_arrays(ALIBABA)
    assert np.array_equal(cluster["caps"], alibaba_cluster().caps)
    ours = gen.synth_trace_arrays(3000, cluster, 2**31 + 7)
    theirs = synth_trace(3000, alibaba_cluster(), seed=2**31 + 7)
    for g in ours:
        J = len(g["default"])
        assert 6 <= J <= 14 and g["dur"].shape == (J, 6)
        assert np.array_equal(g["dem"][:, :, 0],
                              np.broadcast_to([2, 4, 8, 16, 32, 64], (J, 6)))
        assert np.all(g["dem"][:, :, 1] == g["dem"][:, :1, 1])
        # every task after the first layer fed by 1-4 distinct tasks of the
        # layer before, and the DAG's layers those of np.array_split
        depth = len({0} | {int(b) for b in _layers(J, g["edges"])})
        assert 3 <= depth <= 5
        preds = {}
        for a, b in g["edges"].tolist():
            preds.setdefault(b, []).append(a)
        assert all(1 <= len(v) <= 4 and len(set(v)) == len(v)
                   for v in preds.values())

    def stats(dags):
        dur = np.concatenate([d[:, 2] for d in dags[0]])
        return (np.mean(dags[1]), np.mean(dags[2]), np.median(dur),
                np.quantile(dur, 0.9),
                np.bincount(np.concatenate(dags[3]), minlength=6) / len(dur))
    a = stats(([g["dur"] for g in ours], [len(g["default"]) for g in ours],
               [len(g["edges"]) for g in ours],
               [g["default"] for g in ours]))
    b = stats(([flatten([d], 2).option_arrays()[0] for d in theirs],
               [len(d.tasks) for d in theirs], [len(d.edges) for d in theirs],
               [np.asarray([t.default_option for t in d.tasks])
                for d in theirs]))
    assert abs(a[0] - b[0]) < 0.15 and abs(a[1] - b[1]) < 0.6
    assert abs(a[2] / b[2] - 1) < 0.06 and abs(a[3] / b[3] - 1) < 0.06
    assert np.all(np.abs(a[4] - b[4]) < 0.02) and a[4][[0, 5]].sum() == 0


def _layers(J, edges):
    """Each task's layer: 0 without predecessors, else one past its
    predecessors' deepest."""
    depth = [0] * J
    for a, b in sorted(edges.tolist(), key=lambda e: e[1]):
        depth[b] = max(depth[b], depth[a] + 1)
    return depth


@pytest.mark.parametrize("name", ["motivation", "dag1", "dag2"])
def test_frozen_paper_dags_equal_the_originals(name):
    from repro_torch.cluster import workloads
    from repro_torch.cluster.catalog import paper_cluster
    from repro_torch.core.dag import flatten
    ours = gen.PAPER_DAGS[name](gen.cluster_arrays(AWS))
    theirs = getattr(workloads, {"motivation": "motivation_dag"}.get(
        name, name))(paper_cluster())
    dur, dem, cost, n = flatten([theirs], 4).option_arrays()
    assert np.array_equal(ours["dur"], dur) and np.array_equal(ours["dem"],
                                                               dem)
    assert np.allclose(ours["cost"], cost, rtol=1e-15, atol=0)
    assert list(ours["n_opts"]) == list(n)
    assert list(ours["default"]) == [t.default_option for t in theirs.tasks]
    assert [tuple(e) for e in ours["edges"]] == theirs.edges


@pytest.mark.parametrize("spec,family", [(AWS, PAPER), (ALIBABA, SYNTH)])
def test_reference_sgs_equals_the_program_airflow(spec, family):
    """A second witness: the reference's default plan and the program's
    ``airflow_plan`` give the same starts, jointly over 24 DAGs."""
    from portbench.port import build_cluster, build_dag
    from repro_torch.core.baselines import airflow_plan
    from repro_torch.core.dag import flatten
    cluster = gen.cluster_arrays(spec)
    dags = gen.dag_arrays(family, 24, cluster, 9)
    ours = reference.airflow_group(dags, cluster["caps"])
    sol = airflow_plan(flatten([build_dag(g) for g in dags],
                               len(cluster["caps"])), build_cluster(cluster))
    assert np.array_equal(np.concatenate([d["start"] for d in ours]),
                          sol.start)


def test_every_seed_plans_the_same_dags_in_another_order():
    cluster = gen.cluster_arrays(ALIBABA)
    a = gen.dag_arrays(SYNTH, 64, cluster, 1)
    b = gen.dag_arrays(SYNTH, 64, cluster, 2**31 + 1)
    key = sorted(g["name"] for g in a)
    assert key == sorted(g["name"] for g in b)
    assert [g["name"] for g in a] != [g["name"] for g in b]
    assert [g["name"] for g in a] == [g["name"] for g in
                                      gen.dag_arrays(SYNTH, 64, cluster, 1)]
