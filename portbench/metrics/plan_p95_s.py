"""95th percentile (nearest rank) of every request's client-side time from
when it was due under the open-loop schedule to its ``PlanResult``, over
every request due in the window. A request that failed or never came
counts as missing any limit; where those reach the percentile there is no
number."""
import math


def read(run):
    lat = sorted((r.t_done - r.t_due) if (r.plan is not None
                                          and r.error is None) else math.inf
                 for r in run.requests if r.t_due < run.window[1])
    if not lat:
        return None
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return p95 if math.isfinite(p95) else None
