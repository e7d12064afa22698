"""One run of one cell: set-up, the measured window, the checks, the metrics.

Driven by data. ``BENCHMARK.json`` names each cell's configuration and
traffic mix; the harness reads ``configs/<config>.json`` and
``traffic/<traffic>.json`` and takes each metric from the reader
``metrics/<name>.py`` (or, for ``<base>.<suffix>``, ``metrics/<base>.py``),
whose ``read(run)`` returns a number or None. A new configuration, mix or
metric is a new file and a new entry; nothing here changes.

The window drives ``PlannerService.submit`` (``port.py``) from one
asyncio loop: a closed loop of clients, each submitting its next DAG when
its last plan returns, or an open loop of Poisson arrivals. Every request
due in the window is then checked by the reference (``reference.py``).
"""
from __future__ import annotations

import asyncio
import copy
import dataclasses
import gc
import importlib.util
import os
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from portbench import gen, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# how long after the window's close the harness waits for the answers due
DRAIN_S = 60.0
# a traced run profiles TRACE_COUNT stretches of TRACE_S seconds spread
# over the window, each read after TRACE_WARM_S seconds of tracing that
# are thrown away. One: the profiler's first session in a process keeps
# the card's kernels, while a later one, once a stop has gone wrong, keeps
# none of them, and neither do the sessions after it
TRACE_S = 4.0
TRACE_WARM_S = 1.0
TRACE_COUNT = 1


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


def load_bench(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> Dict:
    return _load_json("configs", name)


def load_traffic(name: str) -> Dict:
    return _load_json("traffic", name)


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<base>.py``
    where ``name`` is ``<base>.<suffix>``."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics (an
    entry without ``workloads`` in every cell), or with ``trace`` the
    per-layer ones that list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def merged(base: Dict, over: Optional[Dict]) -> Dict:
    """``base`` with the keys of ``over`` put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


# ---------------------------------------------------------------------------
# What a run records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    k: int                       # submission number
    dag: int                     # index into the run's DAGs
    t_due: float                 # when it was due (open loop) or sent
    t_sub: float = math.nan      # when it was sent
    t_done: float = math.nan     # when its plan (or its error) came back
    plan: Optional[Dict] = None  # the program's answer, as plain arrays
    error: Optional[str] = None

    @property
    def trace(self) -> str:
        return f"pb{self.k}"


@dataclasses.dataclass
class Run:
    """Everything the metric readers see."""
    cell: str
    config: Dict
    traffic: Dict
    seconds: float
    window: tuple = (math.nan, math.nan)   # host clock, open and close
    setup_s: float = math.nan
    requests: List[Request] = dataclasses.field(default_factory=list)
    events: List = dataclasses.field(default_factory=list)
    gains: List[float] = dataclasses.field(default_factory=list)
    device_trace: Dict = dataclasses.field(default_factory=dict)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    launches: List[Dict] = dataclasses.field(default_factory=list)
    lateness_s: float = 0.0


class ListSink:
    """Keeps every event the service emits (threads append; a list append
    holds under the interpreter lock)."""

    def __init__(self):
        self.events: List = []

    def emit(self, event) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass

    def __bool__(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop send times: the exponential gaps of a Poisson stream at
    ``rate``, taken at fixed quantiles so that every seed sends the same
    gaps, in an order drawn from ``seed``."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(seed).permutation(gaps)
    t = np.cumsum(gaps) - gaps[0]
    return t[t < seconds]


async def _closed(port, dags, reqs, clients, t_end, clock, on_first):
    counter = iter(range(1 << 62))

    async def client():
        while clock() < t_end:
            k = next(counter)
            r = Request(k, k % len(dags), clock())
            reqs.append(r)
            await _send(port, dags, r, clock, on_first)

    return [asyncio.create_task(client()) for _ in range(clients)]


async def _open(port, dags, reqs, sends, t0, clock, on_first):
    tasks = []
    for k, at in enumerate(sends):
        delay = t0 + at - clock()
        if delay > 0:
            await asyncio.sleep(delay)
        r = Request(k, k % len(dags), t0 + at)
        reqs.append(r)
        tasks.append(asyncio.create_task(_send(port, dags, r, clock,
                                               on_first)))
    return tasks


async def _send(port, dags, r: Request, clock, on_first):
    from portbench.port import plan_arrays
    on_first()
    r.t_sub = clock()
    try:
        res = await port.submit(dags[r.dag], r.trace)
    except Exception as e:  # noqa: BLE001 — a refused or failed request
        r.error = f"{type(e).__name__}: {e}"
    else:
        r.plan = plan_arrays(res)
    r.t_done = clock()


async def drive(run: Run, port, dags, seed: int, trace: bool,
                t_proc: float, drain_s: float,
                device: str = "cuda") -> Optional[object]:
    """The measured window, then the wait for every answer due in it.
    Returns a traced run's profiled stretches and how many were lost
    (see ``_traced``)."""
    clock = time.monotonic
    loop_cfg = run.traffic["loop"]
    stretches = None
    started = []

    def on_first():
        if not started:
            started.append(clock())

    async with port.service:
        t0 = clock()
        t_end = t0 + run.seconds
        run.window = (t0, t_end)
        if loop_cfg["kind"] == "closed":
            tasks = await _closed(port, dags, run.requests,
                                  loop_cfg["clients"], t_end, clock, on_first)
            main = None
        elif loop_cfg["kind"] == "open":
            sends = arrivals(loop_cfg["rate"], run.seconds, seed)
            tasks = []
            main = asyncio.create_task(_open(port, dags, run.requests, sends,
                                             t0, clock, on_first))
        else:
            raise ValueError(f"unknown loop kind {loop_cfg['kind']!r}")
        if trace and device == "cuda":
            stretches = await _traced(run, TRACE_S, TRACE_WARM_S,
                                      TRACE_COUNT)
        if main is not None:
            tasks = await main
        await asyncio.sleep(max(0.0, t_end - clock()))
        if tasks:
            _, late = await asyncio.wait(tasks, timeout=drain_s
                                         + max(0.0, t_end - clock()))
            for t in late:
                t.cancel()
            await asyncio.gather(*late, return_exceptions=True)
    run.setup_s = (started[0] if started else t0) - t_proc
    run.lateness_s = max((r.t_sub - r.t_due for r in run.requests
                          if math.isfinite(r.t_sub)), default=0.0)
    return stretches


async def _traced(run: Run, span: float, warm: float,
                  count: int) -> Tuple[List, int]:
    """Profile the card's activity over ``count`` stretches of ``span``
    seconds, spread evenly over the window, each after ``warm`` seconds of
    tracing that are not read. A stretch whose trace lost the device's
    kernels (``devtrace.lost``) is thrown away and traced again at once,
    while the window lasts. Returns the kept stretches' events with their
    bounds on the profiler's clock (the last lost one where none was
    kept), and how many were thrown away."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace
    t_open = time.monotonic()
    t_close = t_open + run.seconds
    step = run.seconds / count
    span = min(step / 2, span)
    warm = min(step / 2, warm)
    out, lost, last = [], 0, None
    while len(out) < count:
        start = max(time.monotonic(),
                    t_open + (len(out) + 0.5) * step - span / 2 - warm)
        if start + warm + span > t_close:
            break
        await asyncio.sleep(max(0.0, start - time.monotonic()))
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        await asyncio.sleep(warm)
        t0 = time.time_ns()
        await asyncio.sleep(span)
        t1 = time.time_ns()
        prof.stop()
        stretch = (devtrace.collect(prof), (t0, t1))
        del prof
        if devtrace.lost(*stretch, [x["t_ns"] for x in run.launches]):
            lost += 1
            last = stretch
        else:
            out.append(stretch)
    return (out or ([last] if last else [])), lost


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _groups(run: Run, shared: bool) -> List[List[int]]:
    """Which requests share the cluster: a shared pool's batches, as the
    service's ``dispatch`` events list them; else each request alone."""
    if not shared:
        return [[i] for i in range(len(run.requests))]
    at = {r.trace: i for i, r in enumerate(run.requests)}
    out = []
    for e in run.events:
        if e.type == "dispatch" and e.data.get("mode") == "daemon":
            out.append([at[t] for t in e.data.get("trace_ids", [])
                        if t in at])
    return out


def check(run: Run, dags: List[Dict], cluster: Dict) -> Dict:
    """Hold every answer due in the window to the reference. Returns the
    numbers compared, each with its limit, and the plans' gains."""
    limits = run.config["limits"]
    failed = sum(1 for r in run.requests
                 if r.error is not None
                 or (r.plan is not None and r.plan["degraded"]))
    plans = [r.plan if r.error is None else None for r in run.requests]
    wrong_id = sum(1 for r, p in zip(run.requests, plans)
                   if p is not None and p["trace"] != r.trace)
    errors = sum(1 for r in run.requests if r.error is not None)
    res = reference.judge([dags[r.dag] for r in run.requests], plans,
                          _groups(run, run.traffic["pool"]["shared_capacity"]),
                          cluster["caps"], gen.prices_per_sec(cluster),
                          run.config["goal"]["w"],
                          keys=[r.dag for r in run.requests])
    run.gains = res["gains"]
    # a request that raised is counted as failed, not again as missing
    numbers = dict(plan_err=res["plan_err"],
                   mismatched=res["mismatched"] + wrong_id,
                   missing=res["missing"] - errors, failed=failed)
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    # the plans' quality: their mean gain over the default plan has to
    # reach the configuration's floor (no plan, no gain: not reached)
    gain = (float(np.mean(run.gains)) if run.gains else math.nan)
    checks["plan_gain"] = dict(value=gain, limit=limits["plan_gain_min"],
                               at_least=True)
    return dict(checks=checks, why=res["why"],
                correct=all(passes(c) for c in checks.values()))


def passes(c: Dict) -> bool:
    """A number within its limit: at most it, or with ``at_least`` at least
    it (a NaN is within neither)."""
    return (c["value"] >= c["limit"]) if c.get("at_least") \
        else (c["value"] <= c["limit"])


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_proc: Optional[float] = None,
             scale: Optional[Dict] = None, drain_s: float = DRAIN_S,
             root: Path = ROOT) -> Dict:
    """Run ``workload`` once and return its result line (a dict) with the
    lines for standard error under ``"stderr"``. ``scale`` overrides parts
    of the configuration (``"config"``) and the mix (``"traffic"``): the
    CPU tests run a cell's path at a size the CPU holds."""
    import torch
    t_proc = time.monotonic() if t_proc is None else t_proc
    bench = load_bench(root)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    scale = scale or {}
    config = merged(load_config(cell["config"]), scale.get("config"))
    traffic = merged(load_traffic(cell["traffic"]), scale.get("traffic"))
    wanted = cell_metrics(bench, workload, trace)
    readers = {m["name"]: metric_reader(m["name"]) for m in wanted}

    from portbench import port as sut
    marks = [("imports", time.monotonic())]
    cluster = gen.cluster_arrays(config["cluster"])
    dags = gen.dag_arrays(config["dags"], traffic["dags"], cluster, seed)
    dag_objs = [sut.build_dag(g) for g in dags]
    # the benchmark's own objects (the requests' DAGs) out of the
    # collector's reach, so that they do not lengthen its passes in the
    # window; the program's heap, built after, stays in it
    gc.collect()
    gc.freeze()
    marks.append(("dags", time.monotonic()))
    run = Run(workload, config, traffic, float(seconds))
    sink = ListSink()
    p = sut.Port(config, traffic, cluster, device, sink)
    marks.append(("service", time.monotonic()))
    template = max(dags, key=lambda g: (len(g["default"]), g["dur"].shape[1]))
    warm = p.warmup(template, traffic["warm_buckets"])
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warmup", time.monotonic()))

    def window():
        return asyncio.run(drive(run, p, dag_objs, seed, trace, t_proc,
                                 drain_s, device))

    if trace:
        with sut.spans(run.spans, run.launches):
            stretches = window()
    else:
        stretches = window()
    gc.unfreeze()
    run.events = list(sink.events)
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
               count=1,
               memory_peak_bytes=(int(torch.cuda.max_memory_allocated())
                                  if device == "cuda" else 0))
    # free the program's state before the reference runs
    del p, sink
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    breakdown, dropped = None, 0
    if stretches is not None:
        from portbench import devtrace
        stretches, dropped = stretches
        launch_ns = [x["t_ns"] for x in run.launches]
        parts = [devtrace.reduce(ev, win, run.spans, launch_ns)
                 for ev, win in stretches]
        # a stretch whose trace lost the decode's launches is left out, and
        # counted; where every stretch lost them, all are read as they
        # are, and the count says so
        dropped += sum(1 for x in parts if not x)
        if not any(parts):
            parts = [devtrace.reduce(ev, win, run.spans) for ev, win in
                     stretches]
        del stretches
        run.device_trace = devtrace.combine(parts)
        if run.device_trace:
            dev.update(busy_s=run.device_trace["busy_s"],
                       window_s=run.device_trace["window_s"])
            breakdown = dict(device_ops=run.device_trace["device_ops"],
                             idle_gaps=run.device_trace["idle_gaps"])

    verdict = check(run, dags, cluster)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    due = [r for r in run.requests if r.t_due < run.window[1]]
    line = dict(correct=verdict["correct"], attempted=len(due),
                failed=verdict["checks"]["failed"]["value"],
                metrics=metrics, device=dev)
    if breakdown is not None:
        line["breakdown"] = breakdown
    solves = sorted(e.data["seconds"] for e in run.events
                    if e.type in ("cache_hit", "bucket_traced")
                    and not e.data.get("warming"))
    prev, setup = t_proc, {}
    # where the set-up's time went, phase by phase from the process start
    for name, t in marks + [("to_first_submit", t_proc + run.setup_s)]:
        setup[name] = t - prev
        prev = t
    line["info"] = dict(requests=len(run.requests), seed=seed,
                        lateness_s=run.lateness_s, worst=verdict["why"],
                        setup=setup, warmup_s=warm, solves=len(solves),
                        solve_s=solves[::max(1, len(solves) // 4)][:5],
                        loadavg=os.getloadavg()[0])
    if trace and device == "cuda":
        t = run.device_trace
        line["info"]["trace"] = dict(
            kept=t.get("stretches", 0), dropped=dropped,
            decode_launches=t.get("decode_launches", 0),
            host_launches=t.get("host_launches", 0))
    line["checks"] = verdict["checks"]
    stderr = [f"check {k}: {c['value']!r} "
              f"({'at least' if c.get('at_least') else 'limit'} "
              f"{c['limit']!r})" for k, c in verdict["checks"].items()]
    return dict(line=line, stderr=stderr)


def emit(out: Dict) -> None:
    """The result: the checks as the last lines of standard error, the
    line as the last line of standard output."""
    for s in out["stderr"]:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
