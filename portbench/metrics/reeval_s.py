"""Engine, the host re-evaluation (``core/vectorized.py`` ->
``core/sgs.py``): per solve, the seconds of the ``engine.reeval`` span
(the event-exact ``sgs_schedule``, the costs and, in the shared engine,
``validate_schedule_many``); the median over the session's solve events
(``cache_hit`` / ``bucket_traced``, warm-up left out) that ended inside
the window, so that the solve a profiler's start or reading holds up
does not move it. No number where the program records no such span."""
import statistics


def read(run):
    t0, t1 = run.window
    per = [(end - start) / 1e9
           for e in run.events
           if e.type in ("cache_hit", "bucket_traced")
           and not e.data.get("warming") and t0 <= e.ts <= t1
           for n, start, end, _ in e.data.get("spans", ())
           if n == "engine.reeval"]
    return statistics.median(per) if per else None
