"""The metric arithmetic on hand-built records, the trace reduction on
made-up events, and the frozen bound (CPU)."""
import math
import types

import pytest

from portbench import bound, devtrace, harness


def _req(k, t_due, t_done, ok=True):
    r = harness.Request(k, 0, t_due, t_sub=t_due, t_done=t_done)
    r.plan = {"degraded": False} if ok else None
    r.error = None if ok else "LoadShedError: full"
    return r


def _run(requests, window=(0.0, 10.0), **kw):
    run = harness.Run("cell", {}, {}, window[1] - window[0], window=window,
                      requests=requests)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_dags_per_s_counts_from_the_first_batch_to_the_last_completion():
    # batches of 4 complete over 1.0-1.3, 3.0-3.3, 5.0-5.3 and (after the
    # close) 11 s; the first batch, by its solve's trace ids, opens the count
    times = [1.0 + 0.1 * i for i in range(4)] + \
        [3.0 + 0.1 * i for i in range(4)] + \
        [5.0 + 0.1 * i for i in range(4)] + [11.0] * 4
    reqs = [_req(i, 0.0, t) for i, t in enumerate(times)]
    events = [_ev("bucket_traced", 0.5, trace_ids=["pb9"], warming=True),
              _ev("cache_hit", 1.0, trace_ids=[f"pb{i}" for i in range(4)]),
              _ev("cache_hit", 3.0, trace_ids=[f"pb{i}" for i in range(4, 8)])]
    read = harness.metric_reader("dags_per_s")
    assert read(_run(reqs, events=events)) == pytest.approx(8 / (5.3 - 1.3))
    assert read(_run(reqs[:4], events=events)) is None
    assert read(_run(reqs)) is None


def test_plan_p95_s_is_nearest_rank_and_counts_failures_as_missing():
    read = harness.metric_reader("plan_p95_s")
    reqs = [_req(i, float(i) / 10, float(i) / 10 + 0.01 * (i + 1))
            for i in range(40)]
    # 40 latencies 0.01 .. 0.40: the 38th smallest is the p95
    assert read(_run(reqs)) == pytest.approx(0.38)
    failed = reqs[:37] + [_req(40 + i, 0.0, 1.0, ok=False) for i in range(3)]
    assert read(_run(failed)) is None
    # a request due after the close is not counted
    late = reqs + [_req(99, 10.5, 100.0)]
    assert read(_run(late)) == pytest.approx(0.38)


def test_plan_gain_is_the_mean_gain():
    read = harness.metric_reader("plan_gain")
    assert read(_run([], gains=[0.1, 0.3, 0.5])) == pytest.approx(0.3)
    assert read(_run([])) is None


def _ev(type_, ts, trace_id=None, **data):
    return types.SimpleNamespace(type=type_, ts=ts, trace_id=trace_id,
                                 data=data)


def test_queue_wait_and_solve_read_the_service_events():
    reqs = [_req(0, 0.0, 3.0), _req(1, 0.5, 3.0)]
    events = [_ev("submit", 0.0, "pb0"), _ev("submit", 0.5, "pb1"),
              _ev("cache_hit", 2.0, seconds=1.0, warming=True,
                  trace_ids=[]),
              _ev("cache_hit", 3.0, seconds=1.5, warming=False,
                  trace_ids=["pb0", "pb1"]),
              _ev("bucket_traced", 4.0, seconds=0.5, warming=False,
                  trace_ids=[])]
    run = _run(reqs, events=events)
    # the batch started at 3.0 - 1.5 = 1.5 s: waits 1.5 and 1.0 s
    assert harness.metric_reader("queue_wait_ms.open")(run) == \
        pytest.approx(1250.0)
    assert harness.metric_reader("solve_s.backlog")(run) == \
        pytest.approx(1.0)
    assert harness.metric_reader("warm_signatures.open")(run) == 1.0


def test_device_readers_need_a_trace():
    run = _run([])
    assert harness.metric_reader("device_idle.backlog")(run) is None
    assert harness.metric_reader("sgs_decode_roofline.open")(run) is None
    shapes = dict(dur=(4096, 14), dem=(4096, 14, 2), prio=(4096, 14),
                  release=(14,), pred=(14, 14), caps=(2,), T=256, t_ns=0)
    run = _run([], device_trace=dict(window_s=2.0, busy_s=0.5, decode_s=0.01,
                                     decode_launches=100),
               launches=[shapes])
    assert harness.metric_reader("device_idle.backlog")(run) == 0.75
    least = bound.decode_bound(shapes)[0]
    assert harness.metric_reader("sgs_decode_roofline.backlog")(run) == \
        pytest.approx(100 * least / 0.1)


def test_frozen_bound_matches_the_isolated_shape():
    """4096 rows, J 14, M 2, T 256: operations bound it at 2.2 us (the
    kernel table's 0.00222 ms less the placed-bin term)."""
    ms, by, nbytes, ops = bound.decode_bound(dict(
        dur=(4096, 14), dem=(4096, 14, 2), prio=(4096, 14), release=(14,),
        pred=(14, 14), caps=(2,), T=256))
    assert by == "operations" and ops == 4096 * 14 * (14 + 3 * 256 * 2
                                                      + 4 * 256)
    assert 0.00210 < ms < 0.00222


def _dev(name, s, d):
    return (name, True, s, d)


def test_reduce_busy_idle_and_labels():
    ms = 1_000_000
    events = [_dev("sgs_decode_kernel(int const*)", 10 * ms, 5 * ms),
              _dev("elementwise", 12 * ms, 6 * ms),       # overlaps
              _dev("sgs_decode_kernel(int const*)", 50 * ms, 10 * ms),
              ("cudaLaunchKernel", False, 30 * ms, 6 * ms)]
    spans = [("portbench.sa_loop", 0, 100 * ms)]
    out = devtrace.reduce(events, (0, 100 * ms), spans,
                          [9 * ms, 45 * ms])
    assert out["busy_s"] == pytest.approx(0.018)     # 10-18 and 50-60 ms
    assert out["window_s"] == pytest.approx(0.1)
    assert out["decode_launches"] == 2 and out["host_launches"] == 2
    assert out["decode_s"] == pytest.approx(0.015)
    gaps = dict(out["idle_gaps"])
    # gaps 0-10, 18-50 (middle 34 ms: in the launch call), 60-100
    assert gaps["portbench.sa_loop/cudaLaunchKernel"] == pytest.approx(0.032)
    assert gaps["portbench.sa_loop/python"] == pytest.approx(0.05)
    both = devtrace.combine([out, out, {}])
    assert both["stretches"] == 2 and both["busy_s"] == pytest.approx(0.036)


def test_reduce_refuses_a_trace_that_lost_launches():
    ms = 1_000_000
    events = [_dev("sgs_decode_kernel", 10 * ms, ms)]
    assert devtrace.reduce(events, (0, 100 * ms), (),
                           [t * ms for t in range(0, 100, 10)]) == {}
    assert devtrace.reduce([], (0, 100 * ms)) == {}
    # without the host's launches, the trace is read as it is
    assert devtrace.reduce(events, (0, 100 * ms))["busy_s"] == \
        pytest.approx(0.001)


def test_a_stretch_that_kept_no_kernels_is_lost():
    """The profiler keeps a stretch's kernels all or none: a stretch is
    traced again where it kept under half of the host's decode launches."""
    ms = 1_000_000
    launches = [t * ms for t in range(0, 100, 10)]
    kept = [_dev("sgs_decode_kernel", t + ms, ms) for t in launches[:-1]]
    assert not devtrace.lost(kept, (0, 100 * ms), launches)
    assert devtrace.lost([("cudaLaunchKernel", False, 5 * ms, ms),
                          _dev("Memcpy HtoD", 7 * ms, ms)],
                         (0, 100 * ms), launches)
    # a stretch in which the host launched no decode loses nothing
    assert not devtrace.lost([], (0, 100 * ms), [200 * ms])


def test_arrivals_send_the_same_gaps_for_every_seed():
    a = harness.arrivals(44.0, 45.0, 1)
    b = harness.arrivals(44.0, 45.0, 2**31 + 11)
    assert abs(len(a) - len(b)) <= 2 and a[0] == b[0] == 0.0
    assert not math.isclose(a[1], b[1])
    assert 1900 <= len(a) <= 1990
