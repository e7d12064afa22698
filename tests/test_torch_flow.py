"""The port's control plane on the CPU: ``FlowRunner``,
``MultiTenantRunner``, ``StreamingRunner`` and the chaos plane.

On the host annealer (``solver="anneal"``, no wall-clock budget) both
packages run the same simulated clock from the same seeds, so the port's
results must equal the reference's exactly: ``FlowResult``,
``TenantRecord`` and ``StreamRecord`` lists (``dataclasses.asdict``,
tolerance 0), the runners' logs, and the event tapes once the trace-id
prefix is fixed and the wall-clock fields are masked
(``_flow_cases.tape``). On the vectorized engine, at the CPU tests' size,
the gates of ``benchmarks/bench_streaming.py`` hold for the port alone.
"""
import dataclasses

import numpy as np
import pytest

from _flow_cases import (PACKAGES, agora, chain_dag, core_cluster, pkg,
                         poisson_stream, records, revocation_stream, tape,
                         unit_cluster)


def _fix_trace_ids(P, runner):
    runner._trace_ids = P.trace.TraceIds("fixed")


# --- FlowRunner ------------------------------------------------------------


def _flow_run(name, case):
    P = pkg(name)
    E, C = P.executor, P.chaos
    if case == "revocation":
        cluster = unit_cluster(P)
        plan = agora(P, cluster).plan([chain_dag(P, "a", 3, 50.0, 2.0),
                                       chain_dag(P, "b", 3, 50.0, 2.0)])
        cfg = E.FlowConfig(mode="sim", enforce_capacity=True,
                           speculation=False, max_retries=20,
                           chaos=C.ChaosConfig(revocations=(
                               C.Revocation(at=25.0, delta=(2.0,),
                                            duration=100.0),)))
    else:
        cluster = P.catalog.alibaba_cluster(machines=20)
        dags = P.workloads.synth_trace(2, cluster, seed=5)
        plan = agora(P, cluster).plan(dags)
        cfg = E.FlowConfig(mode="sim", seed=3, failure_rate=0.2,
                           straggler_rate=0.3, noise_sigma=0.2,
                           retry_backoff=5.0, retry_jitter=0.5)
    runner = E.FlowRunner(plan, cfg)
    res = runner.run()
    return dataclasses.asdict(res), runner.events


@pytest.mark.parametrize("case", ["faults", "revocation"])
def test_flow_runner_matches_reference(case):
    (ref, ref_log), (got, got_log) = (_flow_run(n, case) for n in PACKAGES)
    assert got == ref
    assert got_log == ref_log
    if case == "revocation":
        assert got["kills"] == 1 and got["retries"] >= 1


# --- MultiTenantRunner -----------------------------------------------------


def _multi_run(name, shared):
    P = pkg(name)
    cluster = P.catalog.alibaba_cluster(machines=20)
    dags = P.workloads.synth_trace(5, cluster, seed=2,
                                   submit_rate=1.0 / 300.0)
    sink = P.sink.RingSink()
    runner = P.executor.MultiTenantRunner(
        agora(P, cluster), dags,
        P.executor.FlowConfig(mode="sim", failure_rate=0.05,
                              retry_backoff=5.0, seed=1),
        window=600.0, shared_cluster=shared, sink=sink)
    _fix_trace_ids(P, runner)
    recs = runner.run()
    return (records(recs), runner.rounds, runner.events,
            runner.session.stats.trace_count, tape(sink.events))


@pytest.mark.parametrize("shared", [False, True], ids=["isolated", "shared"])
def test_multi_tenant_runner_matches_reference(shared):
    ref, got = (_multi_run(n, shared) for n in PACKAGES)
    for a, b in zip(ref, got):
        assert b == a
    assert len(got[0]) == 5 and sum(got[1]) >= 5
    assert len(got[4]) > 0


# --- StreamingRunner -------------------------------------------------------


def _stream_run(name, case):
    P = pkg(name)
    S, E, C = P.streaming, P.executor, P.chaos
    fcfg = E.FlowConfig(mode="sim", enforce_capacity=True, speculation=False,
                        seed=0)
    if case == "revocation":
        cluster = unit_cluster(P)
        reqs = revocation_stream(P, cluster)
        sc = S.StreamConfig(chaos=C.ChaosConfig(revocations=(
            C.Revocation(at=25.0, delta=(3.0,), duration=60.0),)))
    else:
        cluster = core_cluster(P)
        reqs = poisson_stream(P, 8, cluster, seed=1)
        sc = (S.StreamConfig(bucket_p=8) if case == "sla" else
              S.StreamConfig(bucket_p=8, sla_aware=False,
                             replan_on_arrival=False, overlap_rounds=False))
    sink = P.sink.RingSink()
    runner = S.StreamingRunner(agora(P, cluster), reqs, fcfg, sc, sink=sink)
    _fix_trace_ids(P, runner)
    recs = runner.run()
    errs, headroom = runner.capacity_audit()
    s, f, d = runner.realized_intervals()
    return dict(records=records(recs), rounds=runner.rounds,
                events=runner.events, preempts=runner.preempt_events,
                kills=runner.revocation_kills, audit=errs,
                headroom=np.asarray(headroom).tolist(),
                intervals=[np.asarray(x).tolist() for x in (s, f, d)],
                hit=S.deadline_hit_rate(recs),
                tape=tape(sink.events))


@pytest.mark.parametrize("case", ["sla", "fifo", "revocation"])
def test_streaming_runner_matches_reference(case):
    ref, got = (_stream_run(n, case) for n in PACKAGES)
    for key in ref:
        assert got[key] == ref[key], key
    assert got["audit"] == []
    if case == "revocation":
        assert got["kills"] >= 1


# --- gates on the vectorized engine (the port alone) ------------------------


def test_streaming_gates_on_vectorized_engine():
    """``bench_streaming``'s gates at the CPU tests' size: guaranteed-class
    hit rate SLA-aware strictly above FIFO over the pooled draws, zero
    realized capacity violations in both modes, and no new signature for
    arrivals inside the warmed bucket."""
    P = pkg("repro_torch")
    S, E = P.streaming, P.executor
    cluster = core_cluster(P)
    met = {}
    for mode, sc in (("sla", S.StreamConfig(bucket_p=8)),
                     ("fifo", S.StreamConfig(bucket_p=8, sla_aware=False,
                                             replan_on_arrival=False,
                                             overlap_rounds=False))):
        hits = total = 0
        for k in range(3):
            runner = S.StreamingRunner(
                agora(P, cluster, solver="vectorized"),
                poisson_stream(P, 8, cluster, seed=k),
                E.FlowConfig(mode="sim", enforce_capacity=True,
                             speculation=False, seed=k), sc)
            recs = runner.run()
            s, f, d = runner.realized_intervals()
            assert S.capacity_violations(s, f, d, cluster.caps) == []
            g = [r for r in recs if r.sla == S.SLA_GUARANTEED]
            hits += sum(r.deadline_met for r in g)
            total += len(g)
        met[mode] = hits / max(total, 1)
    assert met["sla"] > met["fifo"], met

    warm = [r.dag for r in poisson_stream(P, 4, cluster, seed=91)]
    for d in warm:
        d.release_time = 0.0
    sess = agora(P, cluster, solver="vectorized").session(
        shared_capacity=True, bucket_p=8)
    sess.warmup(warm[0])
    n0 = sess.stats.trace_count
    for n in (2, 3, 4):
        res = sess.plan([P.session.PlanRequest(dag=d) for d in warm[:n]])
        assert all(r.validate() == [] for r in res)
    assert sess.stats.trace_count == n0


def test_chaos_off_is_bit_for_bit():
    """No chaos config, ``None`` and an all-zero ``ChaosConfig`` give the
    same stream (``bench_chaos``'s gate), and a revocation run stays inside
    the time-varying caps."""
    P = pkg("repro_torch")
    S, E, C = P.streaming, P.executor, P.chaos
    cluster = unit_cluster(P)
    fcfg = E.FlowConfig(mode="sim", enforce_capacity=True, speculation=False)

    def fingerprint(sc):
        recs = S.StreamingRunner(agora(P, cluster, solver="vectorized"),
                                 revocation_stream(P, cluster), fcfg,
                                 sc).run()
        return [(r.name, r.finished, r.cost, r.retries, r.deadline_met)
                for r in recs]

    base = fingerprint(S.StreamConfig())
    assert fingerprint(S.StreamConfig(chaos=None)) == base
    assert fingerprint(S.StreamConfig(chaos=C.ChaosConfig())) == base
    runner = S.StreamingRunner(
        agora(P, cluster, solver="vectorized"), revocation_stream(P, cluster),
        fcfg, S.StreamConfig(chaos=C.ChaosConfig(revocations=(
            C.Revocation(at=25.0, delta=(3.0,), duration=60.0),))))
    recs = runner.run()
    errs, _ = runner.capacity_audit()
    assert runner.revocation_kills >= 1 and errs == []
    assert len(recs) == 2 and not any(r.failed for r in recs)
