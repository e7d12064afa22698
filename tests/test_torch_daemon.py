"""The port's planner-serving daemon on the CPU (``repro_torch.flow.daemon``).

On the host annealer and a virtual clock the two packages' services,
given the same requests in the same order, must agree exactly: each
request's plan, bucket, ``traced`` and ``degraded`` flags, every shed
decision, the service counters, the ``/v1/plan`` JSON bodies (less
``solve_seconds``, a wall-clock reading) and the event tape (trace-id
prefix fixed, wall-clock fields masked: ``_flow_cases.tape``). On the
vectorized engine the port alone holds ``bench_daemon``'s and
``bench_chaos``'s gates, and the degraded path runs with ``jax`` blocked.
"""
import asyncio
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from _flow_cases import (PACKAGES, agora, chain_dag, pkg, plan_fields,
                         tape, unit_cluster)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class VClock:
    """A virtual clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _result(res):
    return dict(name=res.request.name, index=res.index, bucket=res.bucket,
                traced=bool(res.traced), degraded=bool(res.degraded),
                **plan_fields(res.plan))


async def _post(port, obj):
    """POST /v1/plan on 127.0.0.1:port; (status, JSON body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(obj).encode()
    writer.write(b"POST /v1/plan HTTP/1.1\r\nHost: x\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def _serve_scenario(name, solver="anneal"):
    """One service lifetime on a virtual clock: warmup, a fill burst per
    pool (one of mixed SLA classes), an infeasible guaranteed request, a
    lone guaranteed request flushed by its deadline, and two plans and a
    shed through the HTTP adapter, one phase after another."""
    P = pkg(name)
    Dm, Ss = P.daemon, P.session
    clock = VClock()
    ring = P.sink.RingSink()
    svc = Dm.PlannerService(agora(P, unit_cluster(P), solver=solver),
                            Dm.DaemonConfig(
        pools=(Dm.PoolSpec("shared", shared_capacity=True, bucket_p=True),
               Dm.PoolSpec("isolated", shared_capacity=False,
                           bucket_p=True)),
        max_batch=4, max_wait_s=1e6, slack_margin_s=1000.0, clock=clock,
        sink=ring))
    svc._trace_ids = P.trace.TraceIds("fixed")
    warm = svc.warmup(chain_dag(P, "tmpl"), max_p=4)
    trace0 = svc.stats()["trace_count"]
    out = dict(warm=sorted((p, sorted(b)) for p, b in warm.items()),
               results=[], shed=[], http=[])

    def req(i, **kw):
        return Ss.PlanRequest(dag=chain_dag(P, f"d{i}"), **kw)

    async def shed(request, pool):
        try:
            await svc.submit(request, pool=pool)
        except Dm.LoadShedError as exc:
            return ("LoadShedError", exc.reason)
        return ("served",)

    async def drive():
        async with svc:
            http = Dm.PlannerHTTPServer(svc)
            _, port = await http.start()
            burst = await asyncio.gather(
                *(svc.submit(req(i), pool="shared") for i in range(4)))
            clock.t += 10.0
            # the guaranteed request last: its admission runs off the loop
            mixed = await asyncio.gather(
                svc.submit(req(4), pool="isolated"),
                svc.submit(req(5, sla=Ss.SLA_BEST_EFFORT), pool="isolated"),
                svc.submit(req(6), pool="isolated"),
                svc.submit(req(7, sla=Ss.SLA_GUARANTEED,
                               deadline=clock.t + 1e5), pool="isolated"))
            clock.t += 10.0
            out["shed"].append(await shed(
                req(8, sla=Ss.SLA_GUARANTEED, deadline=clock.t + 1.0),
                "shared"))
            clock.t += 10.0
            lone = await svc.submit(
                req(9, sla=Ss.SLA_GUARANTEED, deadline=clock.t + 50.0),
                pool="shared")
            for i, (sla, slack) in enumerate((("guaranteed", 50.0),
                                               ("guaranteed", 60.0),
                                               ("guaranteed", 1.0))):
                clock.t += 10.0
                status, body = await _post(port, {
                    "dag": Dm.dag_to_json(chain_dag(P, f"h{i}")),
                    "sla": sla, "deadline": clock.t + slack,
                    "pool": "shared"})
                body.pop("solve_seconds", None)
                out["http"].append((status, body))
            await http.stop()
            return list(burst) + list(mixed) + [lone]

    out["results"] = [_result(r) for r in asyncio.run(drive())]
    st = svc.stats()
    out["counters"] = {k: st[k] for k in dataclasses.asdict(
        Dm.DaemonStats())}
    out["new_signatures"] = st["trace_count"] - trace0
    out["tape"] = tape(ring.events)
    return out


def test_daemon_matches_reference_on_virtual_clock():
    ref, got = (_serve_scenario(n) for n in PACKAGES)
    for key in ref:
        assert got[key] == ref[key], key
    assert got["counters"]["shed_admission"] == 2
    assert [s for s, _ in got["http"]] == [200, 200, 429]
    assert all(b["errors"] == [] for s, b in got["http"] if s == 200)
    assert all(r["errors"] == [] for r in got["results"])


# --- gates on the vectorized engine (the port alone) ------------------------


def test_daemon_gates_on_vectorized_engine():
    """``bench_daemon``'s serving contract: a burst fills the bucket in ONE
    dispatch, a lone guaranteed tenant is flushed by its deadline (not the
    max-wait timer), an infeasible deadline is shed, and nothing runs a
    new signature after warmup."""
    out = _serve_scenario("repro_torch", solver="vectorized")
    c = out["counters"]
    assert c["flush_fill"] == 2 and c["flush_deadline"] == 3
    assert c["flush_wait"] == 0 and c["batches"] == 5
    assert c["shed_admission"] == 2 and c["served"] == 11
    assert out["new_signatures"] == 0
    assert [r["bucket"] for r in out["results"]] == [4] * 8 + [1]
    assert not any(r["traced"] for r in out["results"])
    assert all(r["errors"] == [] and r["joint_errors"] == []
               for r in out["results"])
    assert out["shed"][0][0] == "LoadShedError"


def _chaos_run(name, degraded_serve, solver="vectorized", n=6):
    """``bench_chaos``'s trip / degrade / recover scenario on a virtual
    clock: the first four solve attempts fail. Returns each submission's
    outcome (a plan, flagged ``degraded`` or not, or the typed error), the
    service counters, the breaker's last state and the event tape."""
    P = pkg(name)
    Dm = P.daemon
    clock = VClock()
    ring = P.sink.RingSink()
    svc = Dm.PlannerService(agora(P, unit_cluster(P), solver=solver),
                            Dm.DaemonConfig(
        pools=(Dm.PoolSpec("shared", shared_capacity=True, bucket_p=True),),
        max_batch=1, max_wait_s=0.01, clock=clock,
        chaos=P.chaos.ChaosConfig(solver_error_solves=(0, 1, 2, 3)),
        breaker_threshold=2, breaker_cooldown_s=0.05, solve_retries=1,
        degraded_serve=degraded_serve, sink=ring))
    svc._trace_ids = P.trace.TraceIds("fixed")
    svc.warmup(chain_dag(P, "tmpl", 2, 2.0, 1.0), max_p=1)

    async def drive():
        out = []
        async with svc:
            for i in range(n):
                try:
                    out.append(_result(await svc.submit(
                        P.session.PlanRequest(
                            dag=chain_dag(P, f"d{i}", 2, 2.0, 1.0)))))
                except Dm.PlanServiceError as exc:
                    out.append(("PlanServiceError", exc.reason))
                clock.t += 0.08          # past the breaker's cooldown
        return out

    outcomes = asyncio.run(drive())
    st = svc.stats()
    counters = {k: st[k] for k in dataclasses.asdict(Dm.DaemonStats())}
    return (outcomes, counters, st["pools"]["shared"]["breaker"],
            tape(ring.events))


@pytest.mark.parametrize("degraded_serve", [True, False],
                         ids=["degraded", "failfast"])
def test_daemon_chaos_matches_reference(degraded_serve):
    ref, got = (_chaos_run(n, degraded_serve, solver="anneal")
                for n in PACKAGES)
    for a, b in zip(ref, got):
        assert b == a
    assert got[1]["faults_injected"] == 4


def test_chaos_gates_on_vectorized_engine():
    """``bench_chaos``'s gates: with degraded serving every submission is
    answered with a valid plan and the breaker ends closed; the fail-fast
    ablation answers fewer, and no future is stranded."""
    served, st, breaker, _ = _chaos_run("repro_torch", degraded_serve=True)
    plans = [o for o in served if isinstance(o, dict)]
    assert len(plans) == 6                         # availability 1.0
    assert all(r["errors"] == [] for r in plans)
    assert any(r["degraded"] for r in plans)
    assert st["degraded_served"] >= 1 and st["pool_restarts"] >= 1
    assert breaker == "closed"                     # probe recovered
    failfast, _, _, _ = _chaos_run("repro_torch", degraded_serve=False)
    answered = [o for o in failfast if isinstance(o, dict)]
    assert len(answered) < 6                       # fail-fast ablation
    assert len(failfast) == 6                      # no stranded future


def test_degraded_path_runs_with_jax_blocked():
    """The greedy fallback's lazy imports (``_degraded_results``) resolve
    inside the port: with ``jax`` blocked, a solver that always fails is
    served degraded plans, and no ``repro`` module is ever loaded."""
    code = """
import asyncio, sys
sys.modules["jax"] = None
from repro_torch.cluster.catalog import Cluster, InstanceType
from repro_torch.core.agora import Agora
from repro_torch.core.dag import DAG, Task, TaskOption
from repro_torch.core.objectives import Goal
from repro_torch.core.vectorized import VecConfig
from repro_torch.flow.chaos import ChaosConfig
from repro_torch.flow.daemon import DaemonConfig, PlannerService, PoolSpec

assert "repro_torch.core.baselines" not in sys.modules
cluster = Cluster((InstanceType("r0", 1, 1, 3.6),), (4.0,))
svc = PlannerService(
    Agora(cluster, goal=Goal.balanced(), solver="vectorized",
          vec_cfg=VecConfig(chains=4, iters=4, grid=16), device="cpu"),
    DaemonConfig(pools=(PoolSpec("p", bucket_p=True),), max_batch=1,
                 chaos=ChaosConfig(solver_error_solves=tuple(range(8)))))
dag = DAG("d", [Task("t", [TaskOption("o", 2.0, (1.0,), 7.2)])], [])

async def go():
    async with svc:
        return await svc.submit(dag)

res = asyncio.run(go())
assert res.degraded and res.validate() == [], res
assert "repro_torch.core.baselines" in sys.modules
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or m == "jax" and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_metrics_text_is_the_reference_format():
    """``/v1/metrics`` renders one stats snapshot the same way in both
    packages (a pure function of the snapshot)."""
    snap = {"running": True, "submitted": 3, "served": 2, "flush_fill": 1,
            "latency": {"p50": 0.5, "p99": None},
            "events": {"retraces": 0, "counts": {"submit": 3},
                       "deadline": {"guaranteed": {"hits": 1, "misses": 0,
                                                   "rate": 1.0}}},
            "pools": {"shared": {"pending": 0, "breaker": "open",
                                 "trace_count": 1, "cache_hits": 2,
                                 "plans": 2}}}
    text = pkg("repro_torch").daemon.metrics_text(snap)
    assert text == pkg("repro").daemon.metrics_text(snap)
    assert 'planner_pool_degraded{pool="shared"} 1' in text


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
@pytest.mark.parametrize("bad", [-1.0, float("nan"), float("inf")],
                         ids=["negative", "nan", "inf"])
def test_bad_demand_is_refused_alone(shared, bad):
    """A request whose option demands are negative or not finite is
    refused at the front door (``ValueError``, and 400 over HTTP); the
    requests submitted beside it are batched and planned without it."""
    P = pkg("repro_torch")
    Dm, D = P.daemon, P.dag
    svc = Dm.PlannerService(agora(P, unit_cluster(P)), Dm.DaemonConfig(
        pools=(Dm.PoolSpec("p", shared_capacity=shared, bucket_p=True),),
        max_batch=2, max_wait_s=1e6, clock=VClock()))
    bad_dag = D.DAG("bad", [D.Task("t", [D.TaskOption("o", 2.0, (bad,),
                                                      7.2)])], [])

    async def refused():
        try:
            await svc.submit(bad_dag)
        except ValueError as exc:
            return str(exc)
        return None

    async def drive():
        async with svc:
            http = Dm.PlannerHTTPServer(svc)
            _, port = await http.start()
            got = await asyncio.gather(svc.submit(chain_dag(P, "a")),
                                       refused(),
                                       svc.submit(chain_dag(P, "b")))
            status, body = await _post(port, {"dag": Dm.dag_to_json(bad_dag)})
            await http.stop()
            return got, status, body

    (a, err, b), status, body = asyncio.run(asyncio.wait_for(drive(), 120))
    assert err is not None and "non-negative" in err
    assert status == 400 and "non-negative" in body["error"]
    for name, res in (("a", a), ("b", b)):
        assert res.request.name == name and not res.degraded
        assert res.plan.validate() == []
    st = svc.stats()
    assert st["served"] == 2 and st["flush_fill"] == 1
