"""The system under test, seen from the benchmark: the only module here that
imports the program (``repro_torch``).

It builds the program's ``Cluster`` and ``DAG`` objects from the arrays of
``gen.py``, starts one ``PlannerService`` pool as the traffic mix asks,
warms the shapes that traffic uses, and hands each plan back as plain
arrays. In a traced run it also wraps two of the program's calls with
spans of the benchmark's own (``portbench.*``) and records the shape of
every ``sgs_decode`` launch, for ``sgs_decode_roofline``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence

import numpy as np


def build_cluster(c: Dict):
    from repro_torch.cluster.catalog import Cluster, InstanceType
    types = tuple(InstanceType(n, int(v), int(m), float(p)) for n, v, m, p
                  in zip(c["names"], c["vcpus"], c["memory_gb"],
                         c["price_per_hour"]))
    return Cluster(types, tuple(int(x) for x in c["caps"]))


def build_dag(g: Dict):
    from repro_torch.core.dag import DAG, Task, TaskOption
    dur, dem, cost = g["dur"].tolist(), g["dem"].tolist(), g["cost"].tolist()
    tasks = [Task(f"t{j}", [TaskOption(lab[o], dur[j][o], tuple(dem[j][o]),
                                       cost[j][o]) for o in range(n)], d)
             for j, (lab, n, d) in enumerate(zip(g["labels"],
                                                 g["n_opts"].tolist(),
                                                 g["default"].tolist()))]
    return DAG(g["name"], tasks, [tuple(e) for e in g["edges"].tolist()],
               release_time=0.0)


class Port:
    """One pool of ``PlannerService`` over an ``Agora`` on ``device``."""

    POOL = "bench"

    def __init__(self, config: Dict, traffic: Dict, cluster: Dict, device,
                 sink):
        from repro_torch.core.agora import Agora
        from repro_torch.core.objectives import Goal
        from repro_torch.core.vectorized import VecConfig
        from repro_torch.flow.daemon import (DaemonConfig, PlannerService,
                                             PoolSpec)
        self.agora = Agora(build_cluster(cluster), Goal(**config["goal"]),
                           solver="vectorized",
                           vec_cfg=VecConfig(**config["vec"]), device=device)
        pool = traffic["pool"]
        spec = PoolSpec(self.POOL, shared_capacity=pool["shared_capacity"],
                        bucket_p=pool["bucket_p"])
        self.service = PlannerService(self.agora, DaemonConfig(
            pools=(spec,), sink=sink, **traffic["daemon"]))

    def warmup(self, template: Dict, buckets: Sequence[int]):
        return self.service.warmup(build_dag(template), buckets=list(buckets))

    async def submit(self, dag, trace: str):
        from repro_torch.core.session import PlanRequest
        return await self.service.submit(PlanRequest(dag=dag, trace=trace))

    @property
    def session(self):
        return self.service.entries[self.POOL].session


def plan_arrays(result) -> Dict:
    """The program's answer to one request, as the reference reads it."""
    sol = result.plan.solution
    return dict(option_idx=np.asarray(sol.option_idx, np.int64),
                start=np.asarray(sol.start, np.float64),
                finish=np.asarray(sol.finish, np.float64),
                makespan=float(sol.makespan), cost=float(sol.cost),
                trace=result.request.trace if result.request else None,
                degraded=bool(result.degraded))


@contextlib.contextmanager
def spans(record: List, launches: List):
    """For a traced run: record the solve's host phases into ``record`` as
    ``(name, start_ns, end_ns)`` on the profiler's clock
    (``time.time_ns``), and each ``sgs_decode`` launch's input shapes and
    time into ``launches``. Phases: ``portbench.prep`` (flattening,
    packing, the Airflow reference point), ``portbench.sa_loop`` (the
    sweep loop), ``portbench.host_reeval`` (the event-exact
    re-evaluation)."""
    from repro_torch.core import annealer, session, vectorized
    from repro_torch.kernels import ops

    def named(name, fn):
        def wrapper(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                record.append((name, t0, time.time_ns()))
        return wrapper

    decode = ops.sgs_decode

    def recorded(dur, dem, prio, release, pred, caps, *, T, use_kernel=None):
        launches.append(dict(dur=tuple(dur.shape), dem=tuple(dem.shape),
                             prio=tuple(prio.shape),
                             release=tuple(release.shape),
                             pred=tuple(pred.shape), caps=tuple(caps.shape),
                             T=int(T), t_ns=time.time_ns()))
        return decode(dur, dem, prio, release, pred, caps, T=T,
                      use_kernel=use_kernel)

    patches = [(session, "flatten", "portbench.prep"),
               (annealer, "reference_point", "portbench.prep"),
               (vectorized, "pack_problems", "portbench.prep"),
               (vectorized, "_sa_loop", "portbench.sa_loop"),
               (vectorized, "sgs_schedule", "portbench.host_reeval")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, named(name, getattr(mod, attr)))
    ops.sgs_decode = recorded
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        ops.sgs_decode = decode
