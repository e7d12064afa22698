"""Engine, the SA loop on the host (``core/vectorized.py:_sa_loop``): per
solve, the ``engine.sa_loop`` span over the configuration's sweeps
(``vec.iters``, which both vectorized engines run), in microseconds; the
median over the session's solve events (``cache_hit`` /
``bucket_traced``, warm-up left out) that ended inside the window, so
that the solve a profiler's start or reading holds up does not move it:
host time a sweep, the wait for the card included where the launch queue
fills. No number where the program records no such span."""
import statistics


def read(run):
    t0, t1 = run.window
    sweeps = run.config.get("vec", {}).get("iters")
    if not sweeps:
        return None
    per = [(end - start) / 1e3 / sweeps
           for e in run.events
           if e.type in ("cache_hit", "bucket_traced")
           and not e.data.get("warming") and t0 <= e.ts <= t1
           for n, start, end, _ in e.data.get("spans", ())
           if n == "engine.sa_loop"]
    return statistics.median(per) if per else None
