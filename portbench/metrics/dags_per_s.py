"""DAGs whose plans came back, over the time from the end of the window's
first batch to its last plan completion: all the work over all its time,
stalls included. The first batch (the session's first solve after the
warm-up, by its trace ids) opens the count and is not in it, so every
batch counted took its whole solve inside the time."""


def read(run):
    close = run.window[1]
    solves = sorted((e for e in run.events
                     if e.type in ("cache_hit", "bucket_traced")
                     and not e.data.get("warming")
                     and e.data.get("trace_ids")), key=lambda e: e.ts)
    if not solves:
        return None
    first = set(solves[0].data["trace_ids"])
    done = [(r.t_done, r.trace in first) for r in run.requests
            if r.plan is not None and r.error is None and r.t_done <= close]
    opened = [t for t, in_first in done if in_first]
    if not opened:
        return None
    t0 = max(opened)
    later = [t for t, in_first in done if not in_first and t > t0]
    if not later or max(later) <= t0:
        return None
    return len(later) / (max(later) - t0)
