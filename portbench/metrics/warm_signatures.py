"""Session (``core/session.py``): solve signatures first run after the
warm-up (``bucket_traced`` events outside the warm-up, from the window's
start to the last answer). Zero where the warm-up covered the traffic."""


def read(run):
    return float(sum(1 for e in run.events
                     if e.type == "bucket_traced"
                     and not e.data.get("warming")
                     and e.ts >= run.window[0]))
