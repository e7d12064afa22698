"""The phases of a batch, recorded inside the port (CPU).

The session's solve event (``cache_hit`` / ``bucket_traced``) carries the
session's and the engine's phases under ``data["spans"]``; the daemon's
``dispatch`` event carries the front door's. Spans nest, use a fixed set of names, sit on the
profiler's clock, survive the JSON-lines wire, and change no plan.
"""
import asyncio

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.cluster import catalog as tcat
from repro_torch.cluster import workloads as twl
from repro_torch.core.agora import Agora
from repro_torch.core.annealer import AnnealConfig
from repro_torch.core.session import PlanRequest
from repro_torch.core.vectorized import VecConfig
from repro_torch.flow.daemon import DaemonConfig, PlannerService, PoolSpec
from repro_torch.obs import (BUCKET_TRACED, CACHE_HIT, DISPATCH, NULL, Event,
                             JsonlSink, RingSink, TeeSink, read_jsonl)
from repro_torch.obs.trace import render_trace

SMALL = VecConfig(chains=4, iters=6, grid=32, seed=0)
FAST_ANNEAL = AnnealConfig(min_iters=20, max_iters=60, exact_task_limit=0)
SESSION = {"session.prep", "session.flatten", "session.reference",
           "session.lock", "engine.solve"}
ENGINE = {"engine.pack", "engine.build", "engine.sa_loop", "engine.readback",
          "engine.reeval"}
DAEMON = ["daemon.wait", "daemon.solve", "daemon.return"]
# engine: (solver, shared capacity)
ENGINES = {"isolated": ("vectorized", False), "shared": ("vectorized", True),
           "host-anneal": ("anneal", False)}


def _trace(n=3, seed=5):
    cluster = tcat.alibaba_cluster(machines=20)
    return cluster, twl.synth_trace(n, cluster, seed=seed)


def _session(engine, sink, cluster):
    solver, shared = ENGINES[engine]
    agora = Agora(cluster, solver=solver, vec_cfg=SMALL,
                  anneal_cfg=FAST_ANNEAL, device="cpu")
    return agora.session(shared_capacity=shared, bucket_p=4, sink=sink)


def _solves(events):
    return [e for e in events if e.type in (BUCKET_TRACED, CACHE_HIT)]


def _inside(child, parent):
    return parent[1] <= child[1] <= child[2] <= parent[2]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_spans_nest_and_name_the_fixed_phases(engine):
    cluster, dags = _trace()
    template = max(dags, key=lambda d: d.num_tasks)
    ring = RingSink()
    sess = _session(engine, ring, cluster)
    sess.warmup(template)
    sess.plan([PlanRequest(dag=d) for d in dags])
    solves = _solves(ring.events)
    assert [e.data["warming"] for e in solves] == [True, False]
    for e in solves:
        spans = e.data["spans"]
        by_name = {s[0]: s for s in spans}
        assert len(by_name) == len(spans)
        want = SESSION | (ENGINE if engine != "host-anneal" else set())
        assert set(by_name) == want
        for name, start, end, parent in spans:
            assert isinstance(start, int) and start <= end
            if parent is not None:
                assert _inside(by_name[name], by_name[parent])
        for parent in {s[3] for s in spans}:
            kids = sorted((s for s in spans if s[3] == parent),
                          key=lambda s: s[1])
            assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:])), parent
        solve = by_name["engine.solve"]
        assert abs((solve[2] - solve[1]) / 1e9 - e.data["seconds"]) < 2e-3


def _plans(res):
    return [(r.plan.solution.option_idx.tolist(),
             np.asarray(r.plan.solution.start).tolist(),
             np.asarray(r.plan.solution.finish).tolist(),
             r.plan.makespan, r.plan.cost) for r in res]


@pytest.mark.parametrize("engine", ["isolated", "shared"])
def test_plans_are_bit_identical_with_and_without_spans(engine):
    cluster, dags = _trace(n=4, seed=11)
    sinks = (NULL, RingSink())
    got = [_plans(_session(engine, sink, cluster).plan(
        [PlanRequest(dag=d) for d in dags])) for sink in sinks]
    assert got[0] == got[1]
    assert all("spans" in e.data for e in _solves(sinks[1].events))


def test_a_daemon_batch_carries_its_front_door_phases():
    cluster, dags = _trace(n=4, seed=3)
    ring = RingSink()
    agora = Agora(cluster, solver="vectorized", vec_cfg=SMALL, device="cpu")
    svc = PlannerService(agora, DaemonConfig(
        pools=(PoolSpec("p", shared_capacity=False, bucket_p=4),),
        max_batch=4, max_wait_s=60.0, sink=ring))
    svc.warmup(max(dags, key=lambda d: d.num_tasks), buckets=[4])

    async def drive():
        async with svc:
            return await asyncio.gather(*(svc.submit(PlanRequest(dag=d))
                                          for d in dags))

    assert len(asyncio.run(drive())) == len(dags)
    [dispatch] = [e for e in ring.events if e.type == DISPATCH]
    spans = dispatch.data["spans"]
    assert [s[0] for s in spans] == DAEMON
    assert all(s[3] is None and s[1] <= s[2] for s in spans)
    assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
    # the session's phases of that batch lie inside the worker's solve
    [live] = [e for e in _solves(ring.events) if not e.data["warming"]]
    solve = spans[1]
    assert all(_inside(s, solve) for s in live.data["spans"])
    assert live.data["trace_ids"] == dispatch.data["trace_ids"]


def test_spans_survive_a_jsonl_round_trip(tmp_path):
    cluster, dags = _trace()
    path = tmp_path / "events.jsonl"
    ring, jsonl = RingSink(), JsonlSink(str(path))
    sess = _session("shared", TeeSink(ring, jsonl), cluster)
    sess.plan([PlanRequest(dag=d) for d in dags])
    jsonl.close()
    back = _solves(read_jsonl(str(path)))
    assert [e.data["spans"] for e in back] == \
        [e.data["spans"] for e in _solves(ring.events)]


@pytest.mark.parametrize("engine", ["isolated", "shared"])
def test_the_phases_share_the_profilers_clock(engine):
    """``torch.profiler`` stamps its events on ``time.time_ns``: every
    operator of a profiled solve lies inside its ``engine.solve`` span, and
    the Metropolis accept's ``exp`` (once a sweep) inside ``engine.sa_loop``.
    """
    cluster, dags = _trace()
    ring = RingSink()
    sess = _session(engine, ring, cluster)
    sess.plan(dags)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.plan(dags)
    by_name = {s[0]: s for s in _solves(ring.events)[-1].data["spans"]}
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert ops
    assert all(_inside(op, by_name["engine.solve"]) for op in ops)
    accepts = [op for op in ops if op[0] == "aten::exp"]
    assert len(accepts) == SMALL.iters
    assert all(_inside(op, by_name["engine.sa_loop"]) for op in accepts)


def test_render_trace_prints_each_batch_events_phases_in_ms():
    ms = 1_000_000
    events = [
        Event("submit", ts=0.0, trace_id="t-1"),
        Event(CACHE_HIT, ts=1.0, data={
            "bucket": 4, "seconds": 0.5, "warming": False,
            "trace_ids": ["t-1"],
            "spans": [["engine.sa_loop", 3 * ms, 5 * ms, "engine.solve"],
                      ["session.prep", 0, 2 * ms, None],
                      ["engine.solve", 2 * ms, 7 * ms, None],
                      ["session.flatten", 0, ms, "session.prep"]]}),
        Event(DISPATCH, ts=1.5, data={
            "mode": "daemon", "n": 1, "trace_ids": ["t-1"],
            "spans": [["daemon.wait", 0, ms // 2, None]]})]
    lines = render_trace(events, "t-1").splitlines()
    at = {ln.split()[0]: ln for ln in lines if ln.endswith(" ms")}
    assert list(at) == ["session.prep", "session.flatten", "engine.solve",
                        "engine.sa_loop", "daemon.wait"]
    indent = {k: len(v) - len(v.lstrip()) for k, v in at.items()}
    assert indent["session.flatten"] == indent["session.prep"] + 2
    assert indent["engine.sa_loop"] == indent["engine.solve"] + 2
    assert at["engine.solve"].split()[-2:] == ["5.000", "ms"]
    assert at["daemon.wait"].split()[-2:] == ["0.500", "ms"]
    # each event's phases come right under it
    assert lines.index(at["daemon.wait"]) == \
        next(i for i, ln in enumerate(lines) if "dispatch" in ln) + 1
