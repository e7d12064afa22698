"""Session and engine (``core/session.py`` -> ``core/vectorized.py``): the
mean ``seconds`` of the session's solve events (``cache_hit`` /
``bucket_traced``, warm-up left out) of the batches that ended inside the
window: host clock around a solve whose plans come back to the host."""


def read(run):
    t0, t1 = run.window
    secs = [e.data["seconds"] for e in run.events
            if e.type in ("cache_hit", "bucket_traced")
            and not e.data.get("warming") and t0 <= e.ts <= t1]
    return sum(secs) / len(secs) if secs else None
