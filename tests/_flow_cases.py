"""Inputs for the control plane's differential tests, built the same way
in the JAX package (``repro``) and in the PyTorch port (``repro_torch``).

``pkg(name)`` gathers the modules of one package; every helper below
takes that namespace, so both packages get the same clusters, DAGs,
arrival draws and configurations from the same seeds. ``tape`` turns a
recorded event stream into comparable dicts with the wall-clock fields
masked: the flow's wall-clock sites (``flow/daemon.py`` submit, dispatch
and breaker latencies, the degraded path's solve seconds; the executor's
real-mode timings, which no simulated run reaches) and the session's own
events, whose ``ts`` and ``seconds`` ``core/session.py`` reads from
``time.monotonic``. Nothing else is masked.
"""
import dataclasses
import importlib
import types

import numpy as np

MODULES = {
    "catalog": "cluster.catalog", "workloads": "cluster.workloads",
    "dag": "core.dag", "agora": "core.agora", "annealer": "core.annealer",
    "objectives": "core.objectives", "session": "core.session",
    "vectorized": "core.vectorized", "executor": "flow.executor",
    "streaming": "flow.streaming", "chaos": "flow.chaos",
    "daemon": "flow.daemon", "sink": "obs.sink", "trace": "obs.trace",
    "events": "obs.events",
}
PACKAGES = ("repro", "repro_torch")
# the host annealer with no wall-clock budget: exact_task_limit=0 keeps
# the branch-and-bound (and its time_budget) out of every solve
FAST_ANNEAL = dict(min_iters=20, max_iters=60, exact_task_limit=0)
SMALL_VEC = dict(chains=8, iters=20, grid=64, seed=0)

# session events: their ts, and data["seconds"], are wall clock
_SESSION_TYPES = ("bucket_traced", "cache_hit", "plan_solved",
                  "solve_profile", "admission_decision")
# flow data fields written from time.monotonic (flow/daemon.py)
_WALL_DATA = {"dispatch": ("latency_s",), "pool_degraded": ("latency_s",)}
MASK = "<wall>"


def pkg(name: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=name)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    return ns


def agora(P, cluster, solver: str = "anneal", **kw):
    """An Agora of package ``P``: the host annealer without a time budget,
    or the vectorized engine at the CPU tests' size; the port on the CPU."""
    if P.name == "repro_torch":
        kw["device"] = "cpu"
    return P.agora.Agora(
        cluster, goal=P.objectives.Goal.balanced(), solver=solver,
        anneal_cfg=P.annealer.AnnealConfig(**FAST_ANNEAL),
        vec_cfg=P.vectorized.VecConfig(**SMALL_VEC), **kw)


def core_cluster(P, cores: float = 16.0, price: float = 0.0475):
    """The reference benches' demo cluster: one resource, ``cores`` cores."""
    return P.catalog.Cluster((P.catalog.InstanceType("cores", 1, 0, price),),
                             (cores,))


def unit_cluster(P, caps=(4.0,)):
    return P.catalog.Cluster(tuple(P.catalog.InstanceType(f"r{m}", 1, 1, 3.6)
                                   for m in range(len(caps))), tuple(caps))


def chain_dag(P, name, n=2, dur=2.0, dem=1.0, t0=0.0, price=3.6):
    D = P.dag
    tasks = [D.Task(f"t{i}", [D.TaskOption("o", dur, (dem,),
                                           dur * dem * price)])
             for i in range(n)]
    return D.DAG(name, tasks, [(i, i + 1) for i in range(n - 1)],
                 release_time=t0)


def grab_lean_dag(P, name, t0, jitter, price):
    """prep -> 2 heavies, each a fast 10-core "grab" or a slow 1-core
    "lean" (``benchmarks/bench_streaming.py:grab_lean_dag``)."""
    D = P.dag
    prep = D.Task("prep", [D.TaskOption("1-core", 20.0 * jitter, (1.0,),
                                        20.0 * jitter * price)])
    heavies = []
    for h in range(2):
        d_grab, d_lean = 100.0 * jitter, 400.0 * jitter
        heavies.append(D.Task(f"heavy{h}", [
            D.TaskOption("grab-10-cores", d_grab, (10.0,),
                         d_grab * 10.0 * price),
            D.TaskOption("lean-1-core", d_lean, (1.0,), d_lean * price),
        ], default_option=0))
    return D.DAG(name, [prep] + heavies, edges=[(0, 1), (0, 2)],
                 release_time=t0)


def poisson_stream(P, tenants, cluster, seed, arrival_mean=150.0,
                   deadline_budget=300.0):
    """Poisson arrivals with mixed SLA classes
    (``benchmarks/bench_streaming.py:poisson_stream``)."""
    S = P.streaming
    rng = np.random.default_rng(seed)
    price = float(cluster.prices_per_sec[0])
    reqs, t = [], 0.0
    for i in range(tenants):
        t += float(rng.exponential(arrival_mean))
        jitter = float(rng.uniform(0.95, 1.05))
        dag = grab_lean_dag(P, f"tenant{i}", t, jitter, price)
        u = float(rng.random())
        if u < 0.35:
            reqs.append(S.TenantRequest(dag, sla=S.SLA_GUARANTEED,
                                        deadline=t + deadline_budget
                                        * jitter))
        elif u < 0.65:
            reqs.append(S.TenantRequest(dag, sla=S.SLA_STANDARD))
        else:
            reqs.append(S.TenantRequest(dag, sla=S.SLA_BEST_EFFORT))
    return reqs


def revocation_stream(P, cluster):
    """Two contending tenants; a revocation takes most of the pool
    mid-dispatch (``benchmarks/bench_chaos.py:_stream_requests``)."""
    S = P.streaming
    price = float(cluster.prices_per_sec[0])
    return [S.TenantRequest(chain_dag(P, "be", 6, 50.0, 2.0, 0.0, price),
                            sla=S.SLA_BEST_EFFORT),
            S.TenantRequest(chain_dag(P, "g", 2, 50.0, 3.0, 40.0, price),
                            sla=S.SLA_GUARANTEED, deadline=40.0 + 130.0)]


def tape(events):
    """Recorded events as dicts, wall-clock fields masked (see above)."""
    out = []
    for e in events:
        d = e.to_json()
        data = dict(d.get("data") or {})
        if d["type"] in _SESSION_TYPES:
            d["ts"] = MASK
            if "seconds" in data:
                data["seconds"] = MASK
        for key in _WALL_DATA.get(d["type"], ()):
            if key in data:
                data[key] = MASK
        d["data"] = data
        out.append(d)
    return out


def plan_fields(plan):
    """A plan's decisions and scores, as plain values."""
    sol = plan.solution
    return dict(option_idx=np.asarray(sol.option_idx).tolist(),
                start=np.asarray(sol.start, float).tolist(),
                finish=np.asarray(sol.finish, float).tolist(),
                makespan=float(plan.makespan), cost=float(plan.cost),
                energy=float(sol.energy), errors=plan.validate(),
                joint_errors=list(plan.joint_errors or []))


def records(recs):
    return [dataclasses.asdict(r) for r in recs]
