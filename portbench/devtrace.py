"""Reduce a ``torch.profiler`` trace of part of the window to what the
per-layer metrics and the result's ``breakdown`` read.

The profiler records the card's activity only (kernels, copies and the
CUDA runtime calls that issue them): recording every host operation as
well slows the host-paced solve several times over and overflows the
profiler's buffers within seconds. What the host was doing comes from
the benchmark's own spans (``port.spans``), on the same clock.

``collect`` turns the profiler's events into plain tuples
``(name, on_device, start_ns, dur_ns)``; ``reduce`` works on those of one
traced stretch alone, and ``combine`` sums the stretches, so the
arithmetic is tested on the CPU with made-up events:

* busy: the union of the device's operation intervals inside the traced
  window;
* ``device_ops``: device time by operation name, the ten largest;
* ``idle_gaps``: the device's idle time, each gap named by what the host
  was doing at its middle (the innermost ``portbench.*`` span there, then
  the CUDA runtime call in progress or ``python``), summed by name, the
  ten largest;
* the decode: device time and launches of the ``sgs_decode`` kernels,
  beside the launches the host made in the window. Where the profiler
  kept fewer than half the launches the host made, the trace lost events
  (``lost``), and ``reduce`` returns nothing rather than a wrong share.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Sequence, Tuple

DECODE = "sgs_decode"
# kernels that run beside a decode launch's main kernel (their time counts
# in the decode's, they are no launch of their own)
DECODE_AUX = ("sgs_decode_wide_prep", "sgs_decode_chain")

Event = Tuple[str, bool, int, int]


def collect(prof) -> List[Event]:
    """The profiler's events as ``(name, on_device, start_ns, dur_ns)``."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             int(e.start_ns()), int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _top(totals: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def _covering(items: Sequence[Tuple[str, int, int]], starts: List[int],
              t: int, back: int = 512) -> str:
    """The shortest of ``items`` (name, start, end), sorted by start, that
    covers ``t``; "" where none does."""
    i = bisect.bisect_right(starts, t)
    best, best_len = "", None
    for name, s, e in items[max(0, i - back):i]:
        if s <= t < e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def is_decode(name: str) -> bool:
    return DECODE in name and not any(k in name for k in DECODE_AUX)


def lost(events: Sequence[Event], window: Tuple[int, int],
         launch_ns: Sequence[int]) -> bool:
    """Whether the trace of one stretch lost the device's kernels: it kept
    fewer than half of the decode launches the host made in ``window``.
    The card runs a launch some time after the host makes it, so the two
    counts differ by what is in flight at the edges; a stretch of the
    profiler's that lost its kernels keeps none of them."""
    w0, w1 = window
    host_n = sum(1 for t in launch_ns if w0 <= t < w1)
    decode_n = sum(1 for n, dev, s, d in events
                   if dev and d > 0 and s + d > w0 and s < w1
                   and is_decode(n))
    return decode_n < 0.5 * host_n


def reduce(events: Sequence[Event], window: Tuple[int, int],
           spans: Sequence[Tuple[str, int, int]] = (),
           launch_ns: Sequence[int] = ()) -> Dict:
    """Busy, idle and the decode inside ``window`` (ns). ``spans`` are the
    host's (name, start_ns, end_ns); ``launch_ns`` the times the host
    launched the decode. Returns an empty dict where the trace holds no
    device operation or lost some of the window's decode launches."""
    w0, w1 = window
    inside = [(n, max(s, w0), min(s + d, w1)) for n, dev, s, d in events
              if dev and d > 0 and s + d > w0 and s < w1]
    if not inside or w1 <= w0:
        return {}
    if launch_ns and lost(events, window, launch_ns):
        return {}
    decode_n = sum(1 for n, _, _ in inside if is_decode(n))
    host_n = sum(1 for t in launch_ns if w0 <= t < w1)
    busy = _merge([(s, e) for _, s, e in inside])
    by_op: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in inside:
        by_op[n[:96]] += (e - s) / 1e9

    host = sorted(spans, key=lambda x: x[1])
    host_starts = [x[1] for x in host]
    calls = sorted(((n, s, s + d) for n, dev, s, d in events
                    if not dev and n.startswith("cu")), key=lambda x: x[1])
    call_starts = [x[1] for x in calls]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            span = _covering(host, host_starts, mid) or "outside the solve"
            call = _covering(calls, call_starts, mid) or "python"
            gaps[f"{span}/{call}"] += (b - a) / 1e9
    return dict(window_s=(w1 - w0) / 1e9,
                busy_s=sum(e - s for s, e in busy) / 1e9,
                device_ops=_top(by_op), idle_gaps=_top(gaps),
                decode_s=sum(e - s for n, s, e in inside
                             if DECODE in n) / 1e9,
                decode_launches=decode_n, host_launches=host_n)


def combine(parts: Sequence[Dict]) -> Dict:
    """One reading from the reductions of several traced stretches: times
    and counts summed, operations and gaps merged by name. Stretches that
    kept nothing are left out; none kept, nothing."""
    parts = [p for p in parts if p]
    if not parts:
        return {}
    out = {k: sum(p[k] for p in parts)
           for k in ("window_s", "busy_s", "decode_s", "decode_launches",
                     "host_launches")}
    for key in ("device_ops", "idle_gaps"):
        totals: Dict[str, float] = collections.defaultdict(float)
        for p in parts:
            for name, secs in p[key]:
                totals[name] += secs
        out[key] = _top(totals)
    out["stretches"] = len(parts)
    return out
