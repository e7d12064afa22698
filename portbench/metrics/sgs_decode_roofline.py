"""The decode kernel (``kernels/csrc/sgs_decode.cu`` via
``kernels/ops.py``): the least time of a launch by the frozen bound
(``bound.py``, from the launch's shapes) over the device time per launch
in the traced window, in percent. No number where the trace saw no
launch."""
from portbench.bound import decode_bound


def read(run):
    t = run.device_trace
    if not t or not t.get("decode_launches") or not run.launches:
        return None
    least = sum(decode_bound(s)[0] for s in run.launches) / len(run.launches)
    per_launch = 1e3 * t["decode_s"] / t["decode_launches"]
    return 100.0 * least / per_launch
