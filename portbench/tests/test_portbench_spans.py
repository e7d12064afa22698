"""The readers of the program's per-batch spans, on made-up events (CPU):
the median over the window's live batches, so that one batch a profiler
holds up does not move it; warm-up solves left out, events outside the
window left out, and no number where the spans are missing or too few."""
import types

import pytest

from portbench import harness

MS = 1_000_000


def _ev(type_, ts, **data):
    return types.SimpleNamespace(type=type_, ts=ts, trace_id=None, data=data)


def _solve(ts, prep_ms, pack_ms, build_ms, loop_ms, back_ms, reeval_ms,
           warming=False):
    """A solve event whose phases follow one another from 0, in ms."""
    spans, t = [], 0
    for name, dur, parent in (("session.prep", prep_ms, None),
                              ("engine.pack", pack_ms, "engine.solve"),
                              ("engine.build", build_ms, "engine.solve"),
                              ("engine.sa_loop", loop_ms, "engine.solve"),
                              ("engine.readback", back_ms, "engine.solve"),
                              ("engine.reeval", reeval_ms, "engine.solve")):
        spans.append([name, t, t + dur * MS, parent])
        t += dur * MS
    return _ev("cache_hit", ts, warming=warming, seconds=t / 1e9,
               spans=spans)


def _dispatch(ts, start_ms, end_ms, warm=True):
    return _ev("dispatch", ts, mode="daemon", warm=warm,
               spans=[["daemon.wait", 0, start_ms * MS, None],
                      ["daemon.solve", start_ms * MS, end_ms * MS, None],
                      ["daemon.return", end_ms * MS, end_ms * MS + 1, None]])


def _run(events, window=(0.0, 10.0), config=None):
    return harness.Run("cell", {"vec": {"iters": 600}} if config is None
                       else config, {}, window[1] - window[0],
                       window=window, events=events)


def _read(name, events, **kw):
    return harness.metric_reader(name)(_run(events, **kw))


SOLVES = [_solve(0.5, 100, 5, 5, 600, 10, 50, warming=True),   # warm-up
          _solve(2.0, 10, 2, 3, 1200, 4, 30),
          _solve(3.0, 20, 4, 6, 1800, 8, 50),
          _solve(4.0, 900, 90, 90, 9000, 90, 900),               # held up
          _solve(12.0, 900, 9, 9, 900, 9, 900)]                  # after close


@pytest.mark.parametrize("name, want", [
    ("prep_s.backlog", 0.030),
    ("sweep_host_us.backlog", 1800e3 / 600),
    ("readback_s.backlog", 0.008),
    ("reeval_s.backlog", 0.050)])
def test_solve_phase_readers_average_the_window_s_live_solves(name, want):
    # the average is the median: the held-up solve does not move it
    assert _read(name, SOLVES) == pytest.approx(want)
    # warm-up and late solves alone give nothing, nor do events without
    # spans (a program that records none)
    assert _read(name, [SOLVES[0], SOLVES[4]]) is None
    assert _read(name, [_ev("cache_hit", 2.0, warming=False,
                            seconds=1.0)]) is None


def test_sweep_host_us_divides_by_the_configuration_s_sweeps():
    assert _read("sweep_host_us.backlog", SOLVES[1:2],
                 config={"vec": {"iters": 300}}) == pytest.approx(4000)
    assert _read("sweep_host_us.backlog", SOLVES[1:2], config={}) is None


def test_worker_idle_is_the_worker_s_idle_share_between_solves():
    # the median share of a batch's turn: the held-up hand-off does not
    # move it
    events = [_dispatch(1.0, 0, 400), _dispatch(2.0, 500, 900),
              _dispatch(3.0, 1000, 1500), _dispatch(4.0, 1510, 2010),
              _dispatch(5.0, 6010, 6510),                        # held up
              _dispatch(11.0, 6600, 7000),
              _dispatch(2.5, 300, 1200, warm=False)]
    # turns of the window's warm batches, idle over turn: 100/500,
    # 100/600, 10/510, 4000/4500; the one after the close is out, and so
    # is the one on the widen thread
    assert _read("worker_idle.backlog", events) == \
        pytest.approx((100 / 600 + 100 / 500) / 2)
    assert _read("worker_idle.backlog", events[:1] + events[5:]) is None
    assert _read("worker_idle.backlog",
                 [_ev("dispatch", 1.0, mode="daemon", warm=True)] * 3) is None
