#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each failing loudly (no phase's failure is caught):

1. build  — compile the port's three CUDA kernels
   (``src/repro_torch/kernels/csrc/*.cu``, one ``nvcc`` each, in parallel)
   from the checkout's sources and print ptxas' register/shared-memory
   report for each;
2. parity — each kernel against its plain PyTorch version on the card:
   ``sgs_decode`` bit for bit on the instances of the decode tests
   (``tests/_decode_cases.py``: the random sweep, the edge cases, grouped
   G > 1 calls, J = 300, and the main path's isolated and shared shapes
   with an odd group size at J > 32); ``sched_violation`` bit for bit on
   the shapes of ``tests/test_kernels.py``, the ising engine's shapes and
   the largest grids of its envelope, in float32 and bfloat16, with
   ``dem`` contiguous and as the ising loop passes it, a transposed view
   (zero at caps 1e9, never negative); ``usl_runtime`` on
   ``tests/test_kernels.py``'s shapes in float32 and bfloat16 (rtol 1e-5,
   atol 1e-5); and small vectorized and ising solves whose plans must not
   depend on which of the two routes ran;
3. main path — ``Agora(..., solver="vectorized", vec_cfg=VecConfig())``
   (256 chains, 600 sweeps, 256 time bins) serves an isolated session and
   a shared-capacity session (bucket 16: warm up, then two batches of 16
   DAGs each) and one quickstart ``agora.plan``. Every plan must validate,
   shared batches must have no joint violation, warm traffic must run no
   new signature, and the decode kernel's launch counter must show each
   solve went through it (iters + 1 launches at least);
4. ising path — ``Agora(..., solver="ising")`` at ``IsingConfig()``
   defaults (512 chains, 1500 steps, 256 time bins) serves an isolated
   session (warm up, then one batch of 16 DAGs, one solve per DAG), a
   shared-capacity session (16 tenants released at t = 0: one joint
   problem) and one quickstart plan, with the same checks; the
   ``sched_violation`` kernel must have run iters + 1 times per solve;
5. control plane (``repro_torch.flow``, ``repro_torch.launch``) at
   ``VecConfig()`` on ``alibaba_cluster(machines=20)``: (a) a
   ``PlannerService`` with a shared and an isolated pool (bucket 16,
   ``max_batch=16``, deadline flush) warms both pools at once on threads
   of their own from an empty build directory (``sgs_decode`` must be
   compiled once), then serves two rounds of 16 ``synth_trace`` DAGs per
   pool (seeds 3 and 5; 4 guaranteed with feasible deadlines, 8 standard,
   4 best effort), 4 of them through ``POST /v1/plan``, and sheds one
   guaranteed request with an infeasible deadline; every plan validates,
   no signature is new after warmup, every submission's causal chain is
   complete, ``/v1/stats`` and ``/v1/metrics`` answer, and the decode
   kernel ran iters + 1 times per dispatch at least; (b) an ising-backed
   service serves a burst of 16 in one joint solve (``sched_violation``
   iters + 1 times); (c) ``StreamingRunner`` on two Poisson draws of 16
   tenants with mixed SLA classes, SLA-aware and FIFO: the guaranteed hit
   rate SLA-aware must be strictly above FIFO, with no capacity
   violation, and arrivals inside the live bucket run no new signature;
   (d) solver errors on the shared pool: availability 1.0 with degraded
   serving (the breaker opens), below 1.0 fail-fast; (e) ``python -m
   repro_torch.launch.serve_planner`` in a subprocess with its default
   flags serves ``/healthz``, a plan and ``/v1/stats``, exits cleanly on
   SIGINT, and ``obs_report`` reads its event tape.

The inputs of one kernel call of each session are captured, checked
against the plain version and timed: ``sched_violation`` as the ising
loop passes them (a transposed ``dem`` view, read through its strides)
and, on an earlier line, contiguous and in the kernel's general layout
(K = 0) beside the bin-major one ``geometry`` picks; beside them the
device time of an empty launch and of a launch with no tasks.
``usl_runtime``, which no path calls, is timed on a grid of 4096 tasks x
256 configurations of contiguous float32 inputs, so that the call runs
no copy kernel; each timed call's PyTorch ops are recorded and the run
fails if one of them copies. The build fails if ptxas reports a spill in
``sched_violation``'s kernels.

Prints the card's name and power limit, the control plane's numbers
(warmup, dispatch and submit-to-result seconds, hit rates, availability)
beside them, one JSON line with the kernels' numbers, and, as the last
line, {"ok": true, "device": {...}}. Exits
non-zero without that line when CUDA is not available, when the port's
sources are not beside this script, or when any check fails.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sgs_decode": (f"{CSRC}/sgs_decode.cu",
                   "src/repro/kernels/sgs_decode.py:39"),
    "sched_violation": (f"{CSRC}/sched_violation.cu",
                        "src/repro/kernels/sched_energy.py:30"),
    "usl_runtime": (f"{CSRC}/usl_runtime.cu",
                    "src/repro/kernels/usl_runtime.py:19"),
}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str):
    """(entry, registers, spill store bytes, spill load bytes) of each
    kernel in an ``nvcc -Xptxas -v`` report."""
    out, entry, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), *spill))
            entry, spill = None, (0, 0)
    return out


# --- measurement helpers ---------------------------------------------------

def same_outputs(a, b) -> float:
    """Raise unless the two (start, finish, ok) triples are equal; return
    the max abs difference (0.0)."""
    import torch
    err = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"output mismatch: {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        err = max(err, float((x.to(torch.float64) - y.to(torch.float64))
                             .abs().max()) if x.numel() else 0.0)
    if err != 0.0:
        fail(f"kernel disagrees with its plain version (max abs err {err})")
    return err


def close_outputs(what, got, want, rtol, atol) -> float:
    """Raise unless ``got`` is within rtol/atol of ``want`` (same shape,
    float32); return the max abs difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: output {tuple(got.shape)}/{got.dtype} vs plain "
             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite kernel output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{what}: kernel disagrees with its plain version beyond rtol "
             f"{rtol}, atol {atol}")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``, its kernels run back to back. A spin
    kernel holds the stream while the host queues ``reps`` calls, so the
    events time the kernels and not the host launching them, which is what
    ``time_ms`` reads wherever the host is the slower (the ising kernels
    run for microseconds). The spin doubles until the host has queued
    every call before it ends."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin = 1 << 22                  # cycles; about 2 ms at 1.98 GHz
    while spin <= 1 << 31:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_behind_spin = not a.query()
        torch.cuda.synchronize()
        if queued_behind_spin:
            return a.elapsed_time(b) / reps
        spin *= 2
    fail(f"could not queue {reps} calls behind a spin of {spin // 2} cycles")


def least_ms(nbytes, ops):
    """The larger of the two times, in ms, and which one bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(args, out, T):
    """Least time the card needs for one decode of these inputs: each input
    read once, each output written once, over HBM; the simple float32/int
    operations this run's data needs over the float32 peak."""
    dur, dem, prio, release, pred, caps = args
    rows, J = dur.shape
    G = 1 if release.dim() == 1 else release.shape[0]
    M = caps.shape[0]
    nbytes = (4 * dur.numel() + 4 * dem.numel() + 4 * prio.numel()
              + 4 * J * G + J * J * G + 4 * M + 9 * rows * J)
    start, finish, _ = out
    placed = (finish.clamp(0, T) - start.clamp(0, T)).clamp(min=0)
    # per row and step: J argmax compares, 3 ops per (bin, resource) for
    # the overload flag, 4 per bin for the prefix sum and the window test;
    # then one add per (placed bin, resource)
    ops = rows * J * (J + 3 * T * M + 4 * T) + M * int(placed.sum())
    return (*least_ms(nbytes, ops), nbytes, ops)


def sched_bound(args, T):
    """Least time for one violation mass of these inputs: start, dur, dem
    and caps read once and (B,) written, over HBM; over the float32 peak,
    one add per task for its end, one add per (resource, covered bin) of
    each task — what this run's intervals cover — and a subtract, a max
    and a sum add per (candidate, resource, bin)."""
    import torch
    start, dur, dem, caps = (x.float() for x in args)
    B, M, J = dem.shape
    nbytes = 4 * (start.numel() + dur.numel() + dem.numel() + M + B)
    lo = torch.ceil(start).clamp(0, T)
    hi = torch.ceil(start + dur).clamp(0, T)
    covered = int((hi - lo).clamp(min=0).sum())
    ops = B * J + M * covered + 3 * B * M * T
    return (*least_ms(nbytes, ops), nbytes, ops)


def usl_bound(n_elems):
    """Five float32 inputs read and one written per element; ten simple
    operations (two subtracts, four multiplies, two adds, two divides) and
    one max per element."""
    nbytes, ops = 6 * 4 * n_elems, 11 * n_elems
    return (*least_ms(nbytes, ops), nbytes, ops)


class Capture:
    """Wraps ``kernels.ops.<name>`` and keeps a copy of the inputs of the
    ``at``-th call (the kernel call of one step of a live solve)."""

    def __init__(self, ops, name: str, at: int):
        self.ops, self.name, self.at, self.n = ops, name, at, 0
        self.orig = getattr(ops, name)
        self.args = self.T = None

    def __call__(self, *args, **kw):
        if self.n == self.at:
            self.args, self.T = [a.clone() for a in args], kw["T"]
        self.n += 1
        return self.orig(*args, **kw)

    def __enter__(self):
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def profile_solve(name, sess, batch, unprofiled_s) -> None:
    """Device busy time of one warm solve, by kernel (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.plan(batch)
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile {name}] one warm solve: {wall_ms:.1f} ms profiled, "
        f"{unprofiled_s * 1e3:.1f} ms unprofiled; device busy {busy_ms:.1f} "
        f"ms; idle share {1 - busy_ms / (unprofiled_s * 1e3):.3f} of the "
        f"unprofiled wall time")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top 8, and the port's own kernels wherever they rank
    for e in ranked[:8] + [e for e in ranked[8:]
                           if any(f"{k}_kernel" in e.key for k in KERNELS)]:
        log(f"[profile {name}]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x {e.key[:70]}")


def check_no_copy(what, fn) -> None:
    """Record the PyTorch ops one call of ``fn`` runs (torch.profiler, CPU
    side) and fail if one of them copies (``aten::copy_``, ``clone``,
    ``_to_copy``): no copy or cast kernel hides in a timed call. The
    kernel itself is launched through ctypes and is not an op."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = sorted({e.key for e in prof.key_averages()})
    copies = [n for n in names if "copy" in n or "clone" in n]
    if copies:
        fail(f"{what}: the timed call copies its inputs ({copies})")
    log(f"[no copy] {what}: the timed call runs the ops {names}, none of "
        f"them a copy")


# --- phase 5: the control plane ---------------------------------------------

SLA_MIX = (("guaranteed", 4), ("standard", 8), ("best_effort", 4))


def synth_stream(cluster, sess, tenants, seed, arrival_mean=300.0,
                 budget=1.5):
    """Poisson tenant arrivals of ``synth_trace`` DAGs with mixed SLA
    classes (35% guaranteed, 30% standard, 35% best effort), shaped like
    ``benchmarks/bench_streaming.py:poisson_stream``. A guaranteed
    tenant's deadline gives ``budget`` times its critical path of
    best-case durations (``session.admit``'s bound) past its arrival."""
    import numpy as np
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.session import PlanRequest
    from repro_torch.flow.streaming import (SLA_BEST_EFFORT, SLA_GUARANTEED,
                                            SLA_STANDARD, TenantRequest)
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for dag in synth_trace(tenants, cluster, seed=seed):
        t += float(rng.exponential(arrival_mean))
        dag.release_time = t
        u = float(rng.random())
        if u < 0.35:
            lb = sess.admit(PlanRequest(dag=dag),
                            now=t).completion_lower_bound
            reqs.append(TenantRequest(dag, sla=SLA_GUARANTEED,
                                      deadline=t + budget * (lb - t)))
        elif u < 0.65:
            reqs.append(TenantRequest(dag, sla=SLA_STANDARD))
        else:
            reqs.append(TenantRequest(dag, sla=SLA_BEST_EFFORT))
    return reqs


async def http_call(port, method, path, body=None):
    """One HTTP/1.1 request to 127.0.0.1:port -> (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def control_plane(dev, gpu, cfg, icfg) -> None:
    """Phase 5: the port's daemon (two pools warmed concurrently on an
    empty build directory, 64 requests of mixed SLA classes over two
    rounds, four through HTTP, one infeasible), an ising-backed service,
    the streaming runner SLA-aware and FIFO, the chaos plane with and
    without degraded serving, and the CLI in a subprocess."""
    import asyncio
    import dataclasses as dc
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.cluster.catalog import alibaba_cluster
    from repro_torch.cluster.workloads import synth_trace
    from repro_torch.core.agora import Agora
    from repro_torch.core.objectives import Goal
    from repro_torch.core.session import SLA_GUARANTEED, PlanRequest
    from repro_torch.flow.chaos import ChaosConfig
    from repro_torch.flow.daemon import (DaemonConfig, LoadShedError,
                                         PlannerHTTPServer, PlannerService,
                                         PlanServiceError, PoolSpec,
                                         dag_to_json)
    from repro_torch.flow.executor import FlowConfig
    from repro_torch.flow.streaming import (StreamConfig, StreamingRunner,
                                            capacity_violations,
                                            deadline_hit_rate)
    from repro_torch.kernels import _build
    from repro_torch.kernels import sched_violation as sv_kernel
    from repro_torch.kernels import sgs_decode as kernel
    from repro_torch.launch.serve_planner import demo_template
    from repro_torch.obs.sink import RingSink
    from repro_torch.obs.trace import chain_complete, spans, trace_ids

    c20 = alibaba_cluster(machines=20)
    agora = Agora(c20, goal=Goal.balanced(), solver="vectorized",
                  vec_cfg=cfg, device=dev)
    sets = [synth_trace(16, c20, seed=s) for s in (3, 5)]
    for dags in sets:
        for d in dags:
            d.release_time = 0.0     # the daemon plans from submission
    template = max(sets[0], key=lambda d: d.num_tasks)
    envelope = (template.num_tasks,
                max(len(t.options) for t in template.tasks))
    for dags in sets:
        if (max(d.num_tasks for d in dags),
                max(len(t.options) for d in dags for t in d.tasks)) \
                != envelope:
            fail(f"[daemon] a burst leaves the template's envelope "
                 f"{envelope}")

    # 5a. the daemon -------------------------------------------------------
    ring = RingSink(1 << 16)
    svc = PlannerService(agora, DaemonConfig(
        pools=(PoolSpec("shared", shared_capacity=True, bucket_p=16),
               PoolSpec("isolated", shared_capacity=False, bucket_p=16)),
        max_batch=16, max_wait_s=120.0, flush="deadline", sink=ring))
    # first use of the decode kernel from the two warmup threads at once:
    # an empty build directory, so both threads ask for a library that
    # is not built yet
    built = _build.BUILD_DIR
    fresh = built / "concurrent-first-use"
    shutil.rmtree(fresh, ignore_errors=True)
    _build.use_build_dir(fresh)
    compiled = _build.compiles.get("sgs_decode", 0)
    kernel.sgs_decode.launches = 0
    sv_kernel.sched_violation.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futures = {name: e.session.warmup_async(template, max_p=16)
               for name, e in svc.entries.items()}
    warm = {name: f.result() for name, f in futures.items()}
    warm_s = time.monotonic() - t0
    if _build.compiles.get("sgs_decode", 0) - compiled != 1:
        fail(f"[daemon] sgs_decode compiled "
             f"{_build.compiles.get('sgs_decode', 0) - compiled} times by "
             f"two concurrent warmups, expected once")
    _build.use_build_dir(built)      # back to the libraries of phase 1
    shutil.rmtree(fresh, ignore_errors=True)
    log(f"[daemon] pools warmed concurrently in {warm_s:.3f} s: "
        + ", ".join(f"{p} bucket {b} {s:.3f} s" for p, bs in warm.items()
                    for b, s in bs.items())
        + f"; of it nvcc of sgs_decode {_build.seconds['sgs_decode']:.2f} s "
        f"(one compile for both threads) ({gpu})")
    trace0 = svc.stats()["trace_count"]
    lat = {sla: [] for sla, _ in SLA_MIX}
    results, batches, shed = [], [], []

    def request(dag, sla, pool, now):
        kw = {}
        if sla == SLA_GUARANTEED:
            lb = svc.entries[pool].session.admit(
                PlanRequest(dag=dag), now=now).completion_lower_bound
            kw = dict(deadline=lb + 3600.0)   # feasible, far off
        return PlanRequest(dag=dag, sla=sla, **kw)

    async def timed(coro, sla):
        t = time.monotonic()
        res = await coro
        lat[sla].append(time.monotonic() - t)
        return res

    async def post(port, req, pool):
        body = {"dag": dag_to_json(req.dag), "sla": req.sla,
                "deadline": None if not np.isfinite(req.deadline)
                else req.deadline, "pool": pool}
        status, data = await http_call(port, "POST", "/v1/plan", body)
        if status != 200:
            fail(f"[daemon] POST /v1/plan answered {status}: {data[:200]}")
        return json.loads(data)

    async def drive():
        async with svc:
            http = PlannerHTTPServer(svc)
            _, port = await http.start()
            for rnd, pools in enumerate((("shared", "isolated"),
                                         ("isolated", "shared"))):
                before = svc.stats_counters.batches
                now = svc._now()
                calls = []
                for pool, dags in zip(pools, sets):
                    i = 0
                    for sla, n in SLA_MIX:
                        for d in dags[i:i + n]:
                            req = request(d, sla, pool, now)
                            if rnd == 1 and pool == "shared" and \
                                    len([c for c in calls if c[0]]) < 4 \
                                    and sla != "best_effort":
                                calls.append((True, sla, post(port, req,
                                                              pool)))
                            else:
                                calls.append((False, sla, svc.submit(
                                    req, pool=pool)))
                        i += n
                t = time.monotonic()
                out = await asyncio.gather(*(timed(c, sla)
                                             for _, sla, c in calls))
                batches.append((svc.stats_counters.batches - before,
                                time.monotonic() - t))
                results.extend(zip([h for h, _, _ in calls], out))
            # a guaranteed deadline no schedule can meet: shed at the door
            bad = PlanRequest(dag=dc.replace(template, name="infeasible"),
                              sla=SLA_GUARANTEED, deadline=svc._now() + 1.0)
            try:
                await svc.submit(bad, pool="shared")
                shed.append(False)
            except LoadShedError as exc:
                shed.append(exc.reason)
            status, stats = await http_call(port, "GET", "/v1/stats")
            mstatus, metrics = await http_call(port, "GET", "/v1/metrics")
            await http.stop()
            return status, json.loads(stats), mstatus, metrics.decode()

    status, stats, mstatus, metrics = asyncio.run(drive())
    torch.cuda.synchronize()
    decode_launches = kernel.sgs_decode.launches
    via_http = sum(h for h, _ in results)
    if len(results) != 64 or via_http != 4:
        fail(f"[daemon] {len(results)} answers, {via_http} through HTTP")
    for from_http, res in results:
        errs = res["errors"] if from_http else res.validate()
        if errs:
            fail(f"[daemon] invalid plan: {errs[:3]}")
        if not from_http and res.plan.joint_errors:
            fail(f"[daemon] joint violations {res.plan.joint_errors[:3]}")
    if not shed or shed[0] is False:
        fail("[daemon] the infeasible guaranteed request was served")
    if status != 200 or mstatus != 200 or \
            "planner_served_total 64" not in metrics:
        fail(f"[daemon] /v1/stats {status}, /v1/metrics {mstatus}")
    if stats["served"] != 64 or stats["shed_admission"] != 1:
        fail(f"[daemon] /v1/stats served {stats['served']}, shed "
             f"{stats['shed_admission']}")
    new_sigs = svc.stats()["trace_count"] - trace0
    if new_sigs:
        fail(f"[daemon] {new_sigs} new signatures after warmup")
    dispatches = 2 + sum(n for n, _ in batches)      # warmups + batches
    if decode_launches < (cfg.iters + 1) * dispatches:
        fail(f"[daemon] sgs_decode launched {decode_launches} times for "
             f"{dispatches} dispatches")
    ids = trace_ids(ring.events)
    complete = sum(chain_complete(spans(ring.events, t)) for t in ids)
    if len(ids) != 65 or complete != len(ids):
        fail(f"[daemon] {complete} of {len(ids)} causal chains complete "
             f"for 65 submissions")
    solve_s = {p: [e.data["seconds"] for e in ring.events
                   if e.type == "plan_solved" and e.pool == p]
               for p in svc.entries}
    log(f"[daemon] 2 rounds x 2 pools x 16 requests, 4 through POST "
        f"/v1/plan, 1 infeasible shed ({shed[0]}); dispatches per round "
        f"{[n for n, _ in batches]}, round seconds "
        f"{[round(s, 3) for _, s in batches]}; seconds per dispatch "
        + ", ".join(f"{p} {[round(x, 3) for x in xs]}"
                    for p, xs in solve_s.items())
        + f"; new signatures after warmup {new_sigs}; sgs_decode launches "
        f"{decode_launches} over {dispatches} dispatches; {complete} "
        f"complete causal chains ({gpu})")
    for sla, _ in SLA_MIX:
        p50, p99 = np.percentile(lat[sla], [50, 99])
        log(f"[daemon] submit->result {sla}: p50 {p50:.3f} s, p99 "
            f"{p99:.3f} s over {len(lat[sla])} requests ({gpu})")

    # 5b. an ising-backed service ------------------------------------------
    isvc = PlannerService(
        Agora(c20, goal=Goal.balanced(), solver="ising", vec_cfg=cfg,
              device=dev),
        DaemonConfig(pools=(PoolSpec("shared", shared_capacity=True,
                                     bucket_p=16),),
                     max_batch=16, max_wait_s=120.0))
    isvc.warmup(template, max_p=16)
    sv_kernel.sched_violation.launches = 0

    async def burst():
        async with isvc:
            return await asyncio.gather(*(isvc.submit(PlanRequest(dag=d))
                                          for d in sets[0]))

    t0 = time.monotonic()
    ires = asyncio.run(burst())
    iburst_s = time.monotonic() - t0
    torch.cuda.synchronize()
    viol = sv_kernel.sched_violation.launches
    for r in ires:
        if r.validate() or r.plan.joint_errors:
            fail(f"[ising service] invalid plan {r.request.name}")
    if isvc.stats()["batches"] != 1 or viol != icfg.iters + 1:
        fail(f"[ising service] {isvc.stats()['batches']} dispatches, "
             f"sched_violation launched {viol} times (expected "
             f"{icfg.iters + 1})")
    log(f"[ising service] one burst of 16: one joint solve in "
        f"{iburst_s:.3f} s; sched_violation launches {viol} ({gpu})")

    # 5c. the streaming runner, SLA-aware and FIFO ---------------------------
    sess = agora.session()
    hits, walls, viols = {}, {}, {}
    kernel.sgs_decode.launches = 0
    for mode, sc in (("sla", StreamConfig(bucket_p=16)),
                     ("fifo", StreamConfig(bucket_p=16, sla_aware=False,
                                           replan_on_arrival=False,
                                           overlap_rounds=False))):
        met = total = rounds = viols[mode] = 0
        per_draw = []
        t0 = time.monotonic()
        for seed in (0, 1):
            runner = StreamingRunner(
                agora, synth_stream(c20, sess, 16, seed),
                FlowConfig(mode="sim", enforce_capacity=True,
                           speculation=False, seed=seed), sc)
            recs = runner.run()
            s, f, d = runner.realized_intervals()
            viols[mode] += len(capacity_violations(s, f, d, c20.caps))
            g = [r for r in recs if r.sla == SLA_GUARANTEED]
            met += sum(r.deadline_met for r in g)
            total += len(g)
            rounds += len(runner.rounds)
            per_draw.append(round(deadline_hit_rate(recs), 3))
            if len(recs) != 16:
                fail(f"[streaming {mode}] {len(recs)} records of 16")
        walls[mode] = time.monotonic() - t0
        hits[mode] = (met, total, rounds, per_draw)
    stream_launches = kernel.sgs_decode.launches
    rate = {m: h[0] / max(h[1], 1) for m, h in hits.items()}
    if not rate["sla"] > rate["fifo"]:
        fail(f"[streaming] guaranteed hit rate SLA-aware {rate['sla']} is "
             f"not above FIFO {rate['fifo']}")
    if viols["sla"] or viols["fifo"]:
        fail(f"[streaming] capacity violations {viols}")
    if stream_launches < cfg.iters + 1:
        fail(f"[streaming] sgs_decode launched {stream_launches} times")
    # arrivals inside the live bucket and envelope run no new signature
    wsess = agora.session(shared_capacity=True, bucket_p=16)
    wsess.warmup(template)
    n0 = wsess.stats.trace_count
    rest = [d for d in sets[1] if d.name != template.name]
    for n in (2, 3, 4):
        for r in wsess.plan([template] + rest[:n - 1]):
            if r.validate():
                fail("[streaming] invalid plan inside the live bucket")
    if wsess.stats.trace_count != n0:
        fail(f"[streaming] {wsess.stats.trace_count - n0} new signatures "
             f"inside the live bucket")
    log(f"[streaming] 2 draws x 16 synth_trace tenants on "
        f"alibaba_cluster(machines=20): guaranteed hit rate SLA-aware "
        f"{rate['sla']:.3f} ({hits['sla'][0]}/{hits['sla'][1]}, per draw "
        f"{hits['sla'][3]}, {hits['sla'][2]} rounds, {walls['sla']:.1f} s) "
        f"vs FIFO {rate['fifo']:.3f} ({hits['fifo'][0]}/{hits['fifo'][1]}, "
        f"per draw {hits['fifo'][3]}, {hits['fifo'][2]} rounds, "
        f"{walls['fifo']:.1f} s); capacity "
        f"violations 0; new signatures inside the live bucket 0; "
        f"sgs_decode launches {stream_launches} ({gpu})")

    # 5d. chaos: solver errors on the daemon's shared pool -------------------
    def chaos(degraded_serve):
        ring = RingSink()
        csvc = PlannerService(agora, DaemonConfig(
            pools=(PoolSpec("shared", shared_capacity=True, bucket_p=16),),
            max_batch=1, max_wait_s=0.01,
            chaos=ChaosConfig(solver_error_solves=(0, 1, 2, 3)),
            breaker_threshold=2, breaker_cooldown_s=0.05, solve_retries=1,
            degraded_serve=degraded_serve, sink=ring))
        csvc.warmup(template, max_p=1)

        async def go():
            out = []
            async with csvc:
                for i in range(6):
                    try:
                        out.append(await csvc.submit(PlanRequest(
                            dag=dc.replace(template, name=f"c{i}"))))
                    except PlanServiceError as exc:
                        out.append(exc)
                    await asyncio.sleep(0.08)   # past the cooldown
            return out

        out = asyncio.run(go())
        plans = [o for o in out if not isinstance(o, Exception)]
        for r in plans:
            if r.validate():
                fail("[chaos] invalid plan")
        opened = any(e.type == "pool_degraded" for e in ring.events)
        return len(plans) / len(out), csvc.stats(), opened

    avail, st, opened = chaos(True)
    avail_off, _, _ = chaos(False)
    if avail != 1.0 or not opened or st["degraded_served"] < 1:
        fail(f"[chaos] degraded serving: availability {avail}, breaker "
             f"opened {opened}, degraded {st['degraded_served']}")
    if not avail_off < 1.0:
        fail(f"[chaos] fail-fast availability {avail_off}, expected < 1")
    log(f"[chaos] availability {avail:.3f} with degraded serving "
        f"({st['degraded_served']} degraded, breaker opened and ended "
        f"{st['pools']['shared']['breaker']}), {avail_off:.3f} fail-fast "
        f"({gpu})")

    # 5e. the CLI, as a user runs it ------------------------------------------
    built.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=built) as tmp:
        events = os.path.join(tmp, "events.jsonl")
        env = dict(os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1")
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_planner",
             "--port", "0", "--events", events], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        watchdog = threading.Timer(600.0, proc.kill)   # a hung CLI ends
        watchdog.start()
        try:
            port, lines = None, []
            while port is None:
                line = proc.stdout.readline()
                if not line:
                    fail(f"[cli] exited before serving: {''.join(lines)}"
                         f"{proc.stderr.read()[-2000:]}")
                lines.append(line)
                m = re.search(r"serving on http://[^:]+:(\d+)", line)
                port = int(m.group(1)) if m else None
            up_s = time.monotonic() - t0

            def call(path, body=None):
                status, data = asyncio.run(http_call(
                    port, "GET" if body is None else "POST", path, body))
                return status, json.loads(data)

            health = call("/healthz")
            # guaranteed, 10 s of slack past its 120 s critical path: the
            # deadline flush sends it at once (the clock is the machine's
            # monotonic clock, which the daemon reads too)
            t0 = time.monotonic()
            status, plan = call("/v1/plan", {
                "dag": dag_to_json(demo_template()), "sla": "guaranteed",
                "deadline": time.monotonic() + 130.0})
            plan_s = time.monotonic() - t0
            sstatus, stats = call("/v1/stats")
            proc.send_signal(signal.SIGINT)
            out, err = proc.communicate(timeout=120)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if health != (200, {"ok": True, "running": True}):
            fail(f"[cli] /healthz {health}")
        if status != 200 or plan["errors"]:
            fail(f"[cli] /v1/plan {status}: {plan}")
        if sstatus != 200 or stats["served"] != 1:
            fail(f"[cli] /v1/stats {sstatus}: served {stats.get('served')}")
        if proc.returncode != 0 or "shutting down" not in out:
            fail(f"[cli] exit {proc.returncode} after SIGINT: "
                 f"{err[-2000:]}")
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_report", events],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if rep.returncode != 0:
            fail(f"[cli] obs_report exit {rep.returncode}: "
                 f"{rep.stderr[-2000:]}")
    log(f"[cli] serve_planner up in {up_s:.1f} s, /healthz ok, one "
        f"guaranteed plan of the demo template in {plan_s:.3f} s (makespan "
        f"{plan['makespan']:.1f} s), /v1/stats served 1, clean exit on "
        f"SIGINT, obs_report exit 0 ({gpu})")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one warm solve per session with "
                             "torch.profiler and print device busy time")
    profile = parser.parse_args(argv).profile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    for source, _ in KERNELS.values():
        if not os.path.exists(os.path.join(ROOT, source)):
            print(f"chip_smoke: {source} not found beside this script; run "
                  f"it from a checkout of the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from _decode_cases import (SCHED_ENVELOPE_SHAPES, SCHED_MAIN_SHAPES,
                               SCHED_SHAPES, USL_SHAPES, kernel_cases,
                               sched_instance, usl_instance)

    from repro_torch.cluster.catalog import alibaba_cluster, paper_cluster
    from repro_torch.cluster.workloads import dag1, synth_trace
    from repro_torch.core import dag as tdag
    from repro_torch.core import ising
    from repro_torch.core import vectorized as vec
    from repro_torch.core.agora import Agora
    from repro_torch.core.objectives import Goal
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sched_violation as sv_kernel
    from repro_torch.kernels import sgs_decode as kernel
    from repro_torch.kernels import usl_runtime as usl_kernel

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(gpu)

    # 1. build ---------------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build(*KERNELS)
    log(f"[build] {len(libs)} kernels in {time.monotonic() - t0:.2f} s "
        f"(one nvcc each, in parallel)")
    for name, lib in libs.items():
        log(f"[build] {KERNELS[name][0]} -> {os.path.relpath(lib, ROOT)} "
            f"(nvcc {_build.seconds[name]:.2f} s)")
        report = lib.with_suffix(".log")
        entries = ptxas_kernels(report.read_text()) if report.exists() else []
        if name != "sched_violation":
            for entry, regs, st, ld in entries:
                log(f"[build] {name}: {entry[:60]}: {regs} registers, spill "
                    f"stores {st} B, loads {ld} B")
            continue
        # one kernel per (C cells a lane, K bins a row, MM resources)
        if not entries:
            fail("no ptxas report for sched_violation")
        shown = []
        for entry, regs, st, ld in entries:
            m = re.search(r"kernelILi(\d+)ELi(\d+)ELi(\d+)E", entry)
            shown.append(f"<{','.join(m.groups()) if m else entry}> {regs}")
            if st or ld:
                fail(f"ptxas spills in sched_violation {entry}: stores {st} "
                     f"B, loads {ld} B")
        most = max(regs for _, regs, _, _ in entries)
        log(f"[build] sched_violation: {len(entries)} kernels <C,K,MM> "
            f"registers: {', '.join(shown)}; no spills; at most {most} "
            f"registers x {sv_kernel.MAX_THREADS} threads a block")
        if most * sv_kernel.MAX_THREADS > 65536:
            fail(f"sched_violation: {most} registers a thread do not fit "
                 f"{sv_kernel.MAX_THREADS} threads in one SM's 64 K")

    # 2. kernels against their plain versions, on the card -------------------
    def on_card(args):
        return [torch.from_numpy(a).to(dev) for a in args]

    cases = kernel_cases()
    for args, T in cases:
        a = on_card(args)
        same_outputs(ops.sgs_decode(*a, T=T, use_kernel=True),
                     ops.sgs_decode(*a, T=T, use_kernel=False))
    torch.cuda.synchronize()
    log(f"[parity] {len(cases)} decode instances: kernel == plain version")

    sched_shapes = SCHED_SHAPES + SCHED_MAIN_SHAPES + SCHED_ENVELOPE_SHAPES
    sched_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, J, M, T in sched_shapes:
            start, dur, dem, caps = sched_instance(B, J, M, T)
            start, dur, caps = on_card([start, dur, caps])
            # dem contiguous, and as the ising loop passes it: a (B, M, J)
            # view of a (B, J, M) tensor
            views = (torch.from_numpy(dem).to(dev), torch.from_numpy(
                np.ascontiguousarray(dem.transpose(0, 2, 1))).to(dev)
                .transpose(1, 2))
            for layout, dm in zip(("contiguous", "transposed"), views):
                what = f"sched_violation {(B, J, M, T)} {dtype} {layout}"
                s_, d_, dm = (x.to(dtype) for x in (start, dur, dm))
                got = ops.sched_violation(s_, d_, dm, caps, T=T,
                                          use_kernel=True)
                want = ops.sched_violation(s_, d_, dm.contiguous(), caps,
                                           T=T, use_kernel=False)
                sched_err = max(sched_err, close_outputs(
                    what, got, want, rtol=2e-5, atol=2e-4))
                if not torch.equal(got, want):
                    fail(f"{what}: kernel differs from its plain version")
                if (got < 0).any():
                    fail(f"{what}: negative violation")
                free = ops.sched_violation(s_, d_, dm,
                                           torch.full_like(caps, 1e9), T=T,
                                           use_kernel=True)
                if (free != 0).any():
                    fail(f"{what}: nonzero violation at caps 1e9")
    torch.cuda.synchronize()
    log(f"[parity] sched_violation on {len(sched_shapes)} shapes x "
        f"(float32, bfloat16) x (dem contiguous, transposed view): bit for "
        f"bit equal to the plain version (max abs err {sched_err}); zero at "
        f"caps 1e9, never negative")

    usl_err = 0.0
    exact = True
    for dtype in (torch.float32, torch.bfloat16):
        for shape in USL_SHAPES:
            args = [x.to(dtype) for x in on_card(usl_instance(shape))]
            got = ops.usl_runtime(*args, use_kernel=True)
            want = ops.usl_runtime(*args, use_kernel=False)
            usl_err = max(usl_err, close_outputs(
                f"usl_runtime {shape} {dtype}", got, want, rtol=1e-5,
                atol=1e-5))
            exact = exact and torch.equal(got, want)
    torch.cuda.synchronize()
    log(f"[parity] usl_runtime on {len(USL_SHAPES)} shapes x (float32, "
        f"bfloat16): within rtol 1e-5, atol 1e-5 of the plain version "
        f"(max abs err {usl_err}, bit for bit: {exact})")

    # small end-to-end: the kernel route and the plain route give one plan
    def same_plans(what, xs, ys):
        for x, y in zip(xs, ys):
            if not (np.array_equal(x.option_idx, y.option_idx)
                    and np.array_equal(x.start, y.start)
                    and np.array_equal(x.finish, y.finish)):
                fail(f"{what}: kernel and plain routes disagree")
            if x.energy != y.energy:
                fail(f"{what}: energies differ")

    small = vec.VecConfig(chains=8, iters=40, grid=128, seed=0)
    c20 = alibaba_cluster(machines=20)
    dags = synth_trace(3, c20, seed=11)
    for d in dags:
        d.release_time = 0.0
    probs = [tdag.flatten([d], c20.num_resources) for d in dags]
    for solve in (vec.vectorized_anneal_many, vec.vectorized_anneal_shared):
        packed = tdag.pack_problems(probs, c20.num_resources, bucket_p=4)
        tape = vec.draw_tape(packed, small, dev)
        plans = []
        for use_kernel in (True, False):
            cfg = dataclasses.replace(small, use_kernel=use_kernel)
            out = solve(probs, c20, Goal.balanced(), cfg, bucket_p=4,
                        device=dev, tape=tape)
            plans.append(out[0] if isinstance(out, tuple) else out)
        same_plans(solve.__name__, *plans)
    small_ising = ising.IsingConfig(chains=32, iters=100, seed=0)
    tape = ising.ising_tape(probs[0].option_arrays()[3], small_ising, dev)
    plans = [[ising.ising_anneal(
        probs[0], c20, Goal.balanced(),
        dataclasses.replace(small_ising, use_kernel=use_kernel),
        device=dev, tape=tape)] for use_kernel in (True, False)]
    same_plans("ising_anneal", *plans)
    log("[parity] small isolated, shared and ising solves: kernel route == "
        "plain route, plan for plan")

    # 3-4. the main path and the ising path at their config defaults ---------
    usl_kernel.usl_runtime.launches = 0      # no path calls it
    cfg = vec.VecConfig()
    icfg = ising.IsingConfig()
    results = {}

    def serve(name, solver, cluster, seeds, shared, release_zero):
        """Warm a bucket-16 session up and serve a batch of 16 per seed;
        check plans, signatures and the path kernel's launches."""
        if solver == "ising":
            counted, call = sv_kernel.sched_violation, "sched_violation"
            per_solve, at = icfg.iters + 1, icfg.iters // 2
        else:
            counted, call = kernel.sgs_decode, "sgs_decode"
            per_solve = cfg.iters + 1 + (1 if shared else 0)
            at = cfg.iters // 2
        batches = [synth_trace(16, cluster, seed=s) for s in seeds]
        if release_zero:           # tenants contend for the same cores
            for b in batches:
                for d in b:
                    d.release_time = 0.0
        template = max(batches[0], key=lambda d: d.num_tasks)
        envelope = (template.num_tasks,
                    max(len(t.options) for t in template.tasks))
        for b in batches:
            jmax = max(d.num_tasks for d in b)
            omax = max(len(t.options) for d in b for t in d.tasks)
            if (jmax, omax) != envelope:
                fail(f"{name}: batch envelope {(jmax, omax)} != template's "
                     f"{envelope}")
        agora = Agora(cluster, solver=solver, vec_cfg=cfg, device=dev)
        sess = agora.session(shared_capacity=shared, bucket_p=16)
        torch.cuda.synchronize()
        counted.launches = 0
        t0 = time.monotonic()
        warm = sess.warmup(template)
        warm_s = time.monotonic() - t0
        traces = sess.stats.trace_count
        steady, captured = [], None
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            if i == 0:
                with Capture(ops, call, at=at) as cap:
                    res = sess.plan(batch)
                captured = (cap.args, cap.T)
            else:
                res = sess.plan(batch)
            steady.append(time.monotonic() - t0)
            for r in res:
                errs = r.validate()
                if errs:
                    fail(f"{name}: invalid plan {r.request.name}: {errs[:3]}")
                if shared and r.plan.joint_errors:
                    fail(f"{name}: joint violations {r.plan.joint_errors[:3]}")
                if not np.all(np.isfinite([r.makespan, r.cost])):
                    fail(f"{name}: non-finite makespan or cost")
            if len(res) != len(batch):
                fail(f"{name}: {len(res)} plans for {len(batch)} requests")
        torch.cuda.synchronize()
        launches = counted.launches
        # the ising engine solves an isolated batch one problem at a time
        per_batch = [len(b) if solver == "ising" and not shared else 1
                     for b in batches]
        solves = 1 + sum(per_batch)
        if sess.stats.trace_count != traces:
            fail(f"{name}: {sess.stats.trace_count - traces} new signatures "
                 f"after warmup")
        need = solves * per_solve
        if launches < need:
            fail(f"{name}: {call} launched {launches} times, expected at "
                 f"least {need}")
        bs = sess.stats.bucket(16)
        log(f"[{name}] warmup {warm_s:.3f} s ({warm}); steady batches "
            f"{[round(s, 3) for s in steady]} s; bucket 16 warmup_seconds "
            f"{bs.warmup_seconds:.3f} steady_seconds {bs.steady_seconds:.3f}; "
            f"trace_count {sess.stats.trace_count}; {call} launches "
            f"{launches} over {solves} solves")
        results[name] = dict(launches=launches, captured=captured,
                             solve_s=steady, warm_s=warm_s)
        if profile:
            if solver == "ising" and not shared:
                # one request: a batch is 16 sequential solves
                t0 = time.monotonic()
                sess.plan(batches[-1][:1])
                one_s = time.monotonic() - t0
                profile_solve(name, sess, batches[-1][:1], one_s)
            else:
                profile_solve(name, sess, batches[-1], steady[-1])

    def quickstart(name, solver, counted, per_solve):
        counted.launches = 0
        pc = paper_cluster()
        t0 = time.monotonic()
        plan = Agora(pc, solver=solver, vec_cfg=cfg, device=dev).plan(
            [dag1(pc)])
        quick_s = time.monotonic() - t0
        if plan.validate():
            fail(f"{name}: invalid plan {plan.validate()[:3]}")
        if counted.launches < per_solve:
            fail(f"{name}: kernel launched {counted.launches} times")
        log(f"[{name}] dag1 on paper_cluster: makespan {plan.makespan:.1f} "
            f"s cost ${plan.cost:.2f} in {quick_s:.3f} s; kernel launches "
            f"{counted.launches}")

    serve("isolated", "vectorized", alibaba_cluster(), (1, 2), shared=False,
          release_zero=False)
    serve("shared", "vectorized", alibaba_cluster(machines=20), (3, 5),
          shared=True, release_zero=True)
    quickstart("quickstart", "vectorized", kernel.sgs_decode, cfg.iters + 1)

    serve("ising-isolated", "ising", alibaba_cluster(), (1,), shared=False,
          release_zero=False)
    serve("ising-shared", "ising", alibaba_cluster(machines=20), (3,),
          shared=True, release_zero=True)
    quickstart("ising-quickstart", "ising", sv_kernel.sched_violation,
               icfg.iters + 1)

    # kernel numbers at the paths' shapes ------------------------------------
    entries = []

    def entry(name, launches, err, ms, plain_ms, bound_ms, bound_by):
        kernel_name = name.split("[")[0]
        source, replaces = KERNELS[kernel_name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    for name in ("isolated", "shared"):
        args, T = results[name]["captured"]
        if args is None:
            fail(f"{name}: no decode captured")
        k_args = [args[0].contiguous(), args[1].contiguous(),
                  args[2].contiguous(), *[x.contiguous() for x in
                                          ops._ref.as_groups(args[3], args[4])],
                  args[5].contiguous()]
        out_k = ops.sgs_decode(*args, T=T, use_kernel=True)
        out_p = ops.sgs_decode(*args, T=T, use_kernel=False)
        err = same_outputs(out_k, out_p)
        reps = 50 if name == "isolated" else 10
        call_ms = time_ms(lambda: kernel.sgs_decode(*k_args, T=T), reps)
        ms = kernel_ms(lambda: kernel.sgs_decode(*k_args, T=T), reps)
        plain_ms = time_ms(lambda: ops.sgs_decode(*args, T=T,
                                                  use_kernel=False), reps=3)
        bound_ms, bound_by, nbytes, nops = bound(args, out_k, T)
        rows, J = args[0].shape
        M, G = args[5].shape[0], k_args[3].shape[0]
        warps, smem, _, _ = kernel.geometry(rows, J, M, T, rows // G)
        log(f"[{name}] decode rows {rows} J {J} M {M} T {T}: kernel "
            f"{ms:.4f} ms/launch on the device, {ms * 1e3 / J:.3f} us per "
            f"step ({call_ms:.4f} ms per call as launched; {warps} rows per "
            f"block, {smem} B shared memory per block), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
            f"{nbytes} B, {nops} ops)")
        entry(f"sgs_decode[{name}]", results[name]["launches"], err, ms,
              plain_ms, bound_ms, bound_by)

    empty_ms = kernel_ms(lambda: torch.cuda._sleep(0), 200)
    log(f"[launch floor] an empty kernel (torch.cuda._sleep(0)), back to "
        f"back: {empty_ms:.5f} ms/launch on the device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("isolated", "shared"):
        args, T = results[f"ising-{name}"]["captured"]
        if args is None:
            fail(f"ising-{name}: no sched_violation call captured")
        B, M, J = args[2].shape
        got = ops.sched_violation(*args, T=T, use_kernel=True)
        want = ops.sched_violation(*args, T=T, use_kernel=False)
        err = close_outputs(f"sched_violation[{name}]", got, want,
                            rtol=2e-5, atol=2e-4)
        if not torch.equal(got, want):
            fail(f"sched_violation[{name}]: kernel differs from its plain "
                 f"version on the captured inputs")
        R, W, C, K, N = sv_kernel.geometry(B, M, T, sms)
        k_args = [x.float().contiguous() for x in args]
        contig_ms = kernel_ms(lambda: sv_kernel.sched_violation(*k_args,
                                                                T=T), 200)
        # the general layout (K = 0) on the same inputs, for the layout
        # choice; these launches are not on the path
        general = sv_kernel.sched_violation(*args, T=T, geom=(R, W, C, 0))
        if not torch.equal(general, got):
            fail(f"sched_violation[{name}]: the general layout differs "
                 f"from the bin-major one")
        general_ms = kernel_ms(lambda: sv_kernel.sched_violation(
            *args, T=T, geom=(R, W, C, 0)), 200)
        log(f"[ising-{name}] sched_violation B {B} J {J} M {M} T {T}: R "
            f"{R} candidates a block, W {W} warps a candidate, C {C} cells "
            f"a lane, layout K {K} (N {N}); on contiguous inputs "
            f"{contig_ms:.5f} ms/launch on the device; the general layout "
            f"(K 0) as passed {general_ms:.5f} ms/launch; dem as the ising "
            f"loop passes it has strides {tuple(args[2].stride())}")
        none = [torch.zeros((B, 0), device=dev), torch.zeros((B, 0),
                device=dev), torch.zeros((B, M, 0), device=dev), args[3]]
        no_task_ms = kernel_ms(lambda: sv_kernel.sched_violation(*none, T=T),
                               200)
        # timed as the ising loop passes the inputs: no copy of dem
        call_ms = time_ms(lambda: sv_kernel.sched_violation(*args, T=T),
                          reps=200)
        ms = kernel_ms(lambda: sv_kernel.sched_violation(*args, T=T), 200)
        plain_ms = time_ms(lambda: ops.sched_violation(*args, T=T,
                                                       use_kernel=False),
                           reps=5)
        bound_ms, bound_by, nbytes, nops = sched_bound(args, T)
        log(f"[ising-{name}] sched_violation as passed: kernel {ms:.5f} "
            f"ms/launch on the device ({call_ms:.4f} ms per call as "
            f"launched), plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}; {nbytes} B, {nops} ops), launch floor: "
            f"{no_task_ms:.5f} ms with no tasks, {empty_ms:.5f} ms empty; "
            f"max abs err {err}")
        check_no_copy(f"sched_violation[{name}]",
                      lambda: sv_kernel.sched_violation(*args, T=T))
        entry(f"sched_violation[{name}]", results[f"ising-{name}"]["launches"],
              err, ms, plain_ms, bound_ms, bound_by)

    # usl_runtime: no path calls it; a grid of 4096 tasks x 256 configurations
    path_launches = usl_kernel.usl_runtime.launches
    rng = np.random.default_rng(0)
    shape = (4096, 256)
    draws = (np.broadcast_to(rng.integers(1, 257, (1, 256)), shape),
             rng.uniform(0, 0.2, shape), rng.uniform(0, 0.01, shape),
             rng.uniform(0.5, 3, shape), rng.uniform(10, 1000, shape))
    # C-contiguous float32 (numpy's cast of the broadcast is column-major),
    # so the wrapper's .contiguous() runs no copy kernel in a timed call
    grid = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in draws]
    got = ops.usl_runtime(*grid, use_kernel=True)
    err = close_outputs("usl_runtime[grid]", got,
                        ops.usl_runtime(*grid, use_kernel=False),
                        rtol=1e-5, atol=1e-5)
    # six copies of the grid's 20 MB of inputs: the five calls between two
    # reads of one copy touch 120 MB with their outputs, against the 50 MB
    # L2, so each call of the rotation reads its inputs from HBM, as the
    # bound counts them
    grids = itertools.cycle([grid] + [[x.clone() for x in grid]
                                      for _ in range(5)])
    call_ms = time_ms(lambda: usl_kernel.usl_runtime(*next(grids)), reps=200)
    ms = kernel_ms(lambda: usl_kernel.usl_runtime(*next(grids)), 200)
    hot_ms = kernel_ms(lambda: usl_kernel.usl_runtime(*grid), 200)
    plain_ms = time_ms(lambda: ops.usl_runtime(*grid, use_kernel=False),
                       reps=50)
    bound_ms, bound_by, nbytes, nops = usl_bound(got.numel())
    check_no_copy("usl_runtime[grid]", lambda: usl_kernel.usl_runtime(*grid))
    log(f"[usl_runtime] grid {shape}, contiguous float32: kernel {ms:.5f} "
        f"ms/launch on the device from HBM, {hot_ms:.5f} ms with the inputs "
        f"in L2 ({call_ms:.4f} ms per call as launched), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; {nbytes} "
        f"B, {nops} ops), {bound_ms / ms:.2f} of the bound; max abs err "
        f"{err}; launches on the paths {path_launches}")
    entry("usl_runtime[grid]", path_launches, err, ms, plain_ms, bound_ms,
          bound_by)

    # 5. the control plane ---------------------------------------------------
    control_plane(dev, gpu, cfg, icfg)

    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
