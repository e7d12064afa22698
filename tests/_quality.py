"""Plan quality of the port against the reference: the cells, the seed
sweep and the rule. Imports neither package: the caller hands in one
package's modules (``api``), so the same code runs the reference on CPU
JAX (``tests/_quality_reference.py``, which writes the fixtures under
``tests/torch_golden/``) and the port on its production draws
(``tests/test_torch_quality.py`` on the CPU, ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` on the card).

The rule on the card (``check``), per cell: every plan is valid, and the
port's mean energy over the seeds is at most the reference's mean plus two
standard errors of the reference's seed spread (its sample standard
deviation over the seeds, over the square root of their number). A seed's
energy is the mean ``Solution.energy`` over the cell's plans.

The rule on the CPU's small fixture (``check_two_sample``), over 64 seeds:
the port's mean minus the reference's mean is at most two standard errors
of that difference, sqrt(SE_port^2 + SE_ref^2). When both plan equally
well it misses 2.3% of the time; the one-sample rule, which leaves out the
port's own spread, misses about 8% of the time at any number of seeds.
"""
import math
from types import SimpleNamespace

import numpy as np

# The cells of PERF.md section 4 (chip_smoke.py's phases 3 and 4): DAGs
# from synth_trace(16, cluster, seed=d) for each DAG seed d, on
# alibaba_cluster(machines); "release_zero" tenants are all released at
# t = 0, so they contend for the same cores.
CELLS = {
    "isolated": dict(solver="vectorized", shared=False, machines=4034,
                     dag_seeds=(1, 2), release_zero=False),
    "shared": dict(solver="vectorized", shared=True, machines=20,
                   dag_seeds=(3, 5), release_zero=True),
    "ising-isolated": dict(solver="ising", shared=False, machines=4034,
                           dag_seeds=(1,), release_zero=False),
    "ising-shared": dict(solver="ising", shared=True, machines=20,
                         dag_seeds=(3,), release_zero=True),
}

# the full fixture: chip_smoke.py's cells at VecConfig() / IsingConfig()
# defaults; the small one: two vectorized cells on 4 DAGs, for the CPU
# (the small one takes the first DAG seed of each cell, bucket 4)
SCALES = {
    "full": dict(dags=16, batches=2, bucket=16, vec={}, ising={},
                 seeds={"isolated": 8, "shared": 8, "ising-isolated": 8,
                        "ising-shared": 8}),
    "small": dict(dags=4, batches=1, bucket=4,
                  vec=dict(chains=16, iters=60, grid=128), ising={},
                  seeds={"isolated": 64, "shared": 64}),
}


def modules(package, **solve_kw):
    """One package's modules (``package`` maps "cluster.catalog",
    "cluster.workloads", "core.dag", "core.sgs", "core.annealer",
    "core.vectorized", "core.ising" and "core.objectives" to the imported
    modules), and the keywords its solvers take (the port's ``device``)."""
    m = package
    return SimpleNamespace(
        catalog=m["cluster.catalog"], workloads=m["cluster.workloads"],
        dag=m["core.dag"], sgs=m["core.sgs"], annealer=m["core.annealer"],
        vec=m["core.vectorized"], ising=m["core.ising"],
        Goal=m["core.objectives"].Goal, kw=solve_kw)


MODULES = ("cluster.catalog", "cluster.workloads", "core.dag", "core.sgs",
           "core.annealer", "core.vectorized", "core.ising",
           "core.objectives")


def batches(api, cell: str, scale: str):
    """(cluster, [[FlatProblem, ...] per DAG seed]) of one cell."""
    spec = CELLS[cell]
    cluster = api.catalog.alibaba_cluster(machines=spec["machines"])
    out = []
    for s in spec["dag_seeds"][:SCALES[scale]["batches"]]:
        dags = api.workloads.synth_trace(SCALES[scale]["dags"], cluster,
                                         seed=s)
        if spec["release_zero"]:
            for d in dags:
                d.release_time = 0.0
        out.append([api.dag.flatten([d], cluster.num_resources)
                    for d in dags])
    return cluster, out


def solve(api, cell: str, scale: str, seed: int):
    """Plans of one cell at one solver seed -> (energies, validation
    errors, solver calls). Each batch is solved as ``PlannerSession`` does
    for the cell's engine (the scale's bucket on the vectorized engines; one
    ``ising_anneal`` per problem, or one on the concatenated problem split
    back per tenant), with the seed in the solver's config."""
    spec, sc = CELLS[cell], SCALES[scale]
    cluster, probs_per_batch = batches(api, cell, scale)
    goal = api.Goal.balanced()
    energies, errors, calls = [], [], 0
    for probs in probs_per_batch:
        refs = [api.annealer.reference_point(p, cluster) for p in probs]
        if spec["solver"] == "vectorized":
            cfg = api.vec.VecConfig(seed=seed, **sc["vec"])
            if spec["shared"]:
                sols, joint = api.vec.vectorized_anneal_shared(
                    probs, cluster, goal, cfg, refs, bucket_p=sc["bucket"],
                    **api.kw)
                errors += joint
            else:
                sols = api.vec.vectorized_anneal_many(
                    probs, cluster, goal, cfg, refs, bucket_p=sc["bucket"],
                    **api.kw)
            calls += 1
        else:
            cfg = api.ising.IsingConfig(seed=seed, **sc["ising"])
            if spec["shared"]:
                sols = _ising_shared(api, probs, refs, cluster, goal, cfg)
                calls += 1
            else:
                sols = [api.ising.ising_anneal(p, cluster, goal, cfg, r,
                                               **api.kw)
                        for p, r in zip(probs, refs)]
                calls += len(probs)
        for p, s in zip(probs, sols):
            errors += api.sgs.validate_schedule(
                p, s.option_idx, s.start, s.finish, cluster.caps)
        energies += [float(s.energy) for s in sols]
    return energies, errors, calls


def _ising_shared(api, probs, refs, cluster, goal, cfg):
    """``core/agora.py:_sequential_solve`` on the ising engine: one solve
    of the concatenated problem, split back into per-tenant solutions
    priced against each tenant's own reference point."""
    joint = api.dag.concat_problems(probs)
    js = api.ising.ising_anneal(
        joint, cluster, goal, cfg,
        api.annealer.reference_point(joint, cluster), **api.kw)
    sols, off = [], 0
    for p, (rM, rC) in zip(probs, refs):
        sl = slice(off, off + p.num_tasks)
        oi, s, f = js.option_idx[sl], js.start[sl], js.finish[sl]
        cost = api.sgs.schedule_cost(p, oi, cluster.prices_per_sec)
        mk = float(f.max())
        sols.append(SimpleNamespace(option_idx=oi, start=s, finish=f,
                                    energy=goal.energy(mk, cost, rM, rC)))
        off += p.num_tasks
    return sols


def sweep(api, cell: str, scale: str, seeds=None):
    """{seed: (mean energy of the seed's plans, number of plans)} and the
    validation errors of every plan."""
    seeds = range(SCALES[scale]["seeds"][cell]) if seeds is None else seeds
    out, errors = {}, []
    for s in seeds:
        e, errs, _ = solve(api, cell, scale, s)
        out[int(s)] = (float(np.mean(e)), len(e))
        errors += errs
    return out, errors


def limit(ref_means) -> float:
    """The rule's bound: the reference's mean over the seeds plus two
    standard errors of its seed spread."""
    x = np.asarray(list(ref_means), np.float64)
    se = float(np.std(x, ddof=1)) / math.sqrt(len(x)) if len(x) > 1 else 0.0
    return float(x.mean()) + 2.0 * se


def check(port_means, ref_means):
    """(holds, port mean, bound) of the rule for one cell; the seeds must
    be the reference's."""
    port, ref = dict(port_means), dict(ref_means)
    if sorted(port) != sorted(ref):
        raise ValueError(f"seeds {sorted(port)} differ from the "
                         f"reference's {sorted(ref)}")
    mean = float(np.mean([port[s] for s in sorted(ref)]))
    bound = limit(ref[s] for s in sorted(ref))
    return mean <= bound, mean, bound


def check_two_sample(port_means, ref_means):
    """(holds, port mean - reference mean, tolerance) of the two-sample
    rule for one cell: the gap is at most two standard errors of the
    difference of the two means, each standard error the sample standard
    deviation over the seeds over the square root of their number. The
    seeds must be the reference's."""
    port, ref = dict(port_means), dict(ref_means)
    if sorted(port) != sorted(ref):
        raise ValueError(f"seeds {sorted(port)} differ from the "
                         f"reference's {sorted(ref)}")
    p = np.asarray([port[s] for s in sorted(ref)], np.float64)
    r = np.asarray([ref[s] for s in sorted(ref)], np.float64)
    se2 = (np.var(p, ddof=1) / len(p)) + (np.var(r, ddof=1) / len(r))
    gap = float(p.mean() - r.mean())
    tol = 2.0 * math.sqrt(float(se2))
    return gap <= tol, gap, tol
