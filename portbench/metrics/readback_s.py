"""Engine, the host waiting on the card (``core/vectorized.py``): per
solve, the seconds of the ``engine.readback`` span, from the sweep loop's
end to the host holding the picked states (the first ``.cpu()`` waits for
every sweep the card still has queued; the shared engine's two-candidate
evaluation is inside); the median over the session's solve events
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
           if n == "engine.readback"]
    return statistics.median(per) if per else None
