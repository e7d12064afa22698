"""Device: the share of the traced window in which no operation ran on the
card (one less the union of the device's operation intervals over the
window, from ``torch.profiler``)."""


def read(run):
    t = run.device_trace
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
