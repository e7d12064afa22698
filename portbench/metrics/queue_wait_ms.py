"""Front door (``flow/daemon.py``): the mean time from a request's
``submit`` event to the start of the solve of the batch it rode in (the
session's ``cache_hit`` / ``bucket_traced`` event, at its end less its
``seconds``), matched by trace id, over the requests due in the window."""


def read(run):
    sub = {e.trace_id: e.ts for e in run.events if e.type == "submit"}
    start = {}
    for e in run.events:
        if e.type in ("cache_hit", "bucket_traced") \
                and not e.data.get("warming"):
            for t in e.data.get("trace_ids", ()):
                start[t] = e.ts - e.data["seconds"]
    waits = [start[r.trace] - sub[r.trace] for r in run.requests
             if r.t_due < run.window[1] and r.trace in start
             and r.trace in sub]
    return 1e3 * sum(waits) / len(waits) if waits else None
