"""Session and engine, host prep (``core/session.py`` ->
``core/vectorized.py``): per solve, the seconds of the session's
``session.prep`` span (flattening the DAGs, their reference points) and
the engine's ``engine.pack`` and ``engine.build`` spans (packing; the
device problem, weights and draws; the shared engine's joint reference
point); the median over the session's solve events (``cache_hit`` /
``bucket_traced``, warm-up left out) that ended inside the window, so
that the solve a profiler's start or reading holds up does not move it.
No number where the program records no such spans."""
import statistics

PHASES = ("session.prep", "engine.pack", "engine.build")


def read(run):
    t0, t1 = run.window
    per = []
    for e in run.events:
        if e.type in ("cache_hit", "bucket_traced") \
                and not e.data.get("warming") and t0 <= e.ts <= t1:
            got = {n: end - start for n, start, end, _ in
                   e.data.get("spans", ())}
            if all(p in got for p in PHASES):
                per.append(sum(got[p] for p in PHASES) / 1e9)
    return statistics.median(per) if per else None
