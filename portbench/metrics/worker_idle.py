"""Front door, the pool's worker thread (``flow/daemon.py``): for each
batch after the first, the share of its turn (from the previous batch's
``daemon.solve`` end to its own) that the pool's single worker spent
without a batch, before its ``daemon.solve`` began; the median over the
daemon's ``dispatch`` events that ended inside the window, so that the
hand-off a profiler's start or reading holds up does not move it. A
batch outside the warmed envelope (``warm`` false) solves on the
daemon's widen thread instead, and is left out. No number with fewer
than two such dispatches."""
import statistics


def read(run):
    t0, t1 = run.window
    solves = sorted((start, end)
                    for e in run.events
                    if e.type == "dispatch" and e.data.get("warm")
                    and t0 <= e.ts <= t1
                    for n, start, end, _ in e.data.get("spans", ())
                    if n == "daemon.solve")
    shares = [(s - prev) / (e - prev)
              for (_, prev), (s, e) in zip(solves, solves[1:]) if e > prev]
    return statistics.median(shares) if shares else None
