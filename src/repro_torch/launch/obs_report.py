"""Operator report over the observability plane (pure stdlib — no jax).

Folds recorded event streams (JSON-lines files written by a ``JsonlSink``,
e.g. ``serve_planner --events events.jsonl``) and/or benchmark artifacts
(``BENCH_*.json``) into one human-readable serving report:

  PYTHONPATH=src python -m repro_torch.launch.obs_report events.jsonl
  PYTHONPATH=src python -m repro_torch.launch.obs_report \
      benchmarks/baselines/BENCH_streaming.json --json
  PYTHONPATH=src python -m repro_torch.launch.obs_report events.jsonl --traces
  PYTHONPATH=src python -m repro_torch.launch.obs_report events.jsonl \
      --trace <trace-id>

Event streams go through the SAME ``EventAggregator`` fold the daemon's
``/v1/stats`` and the ``bench_streaming`` / ``bench_daemon`` gates use,
so the report, the serving endpoint, and the benchmark accounting cannot
drift apart.  ``--trace`` renders one request's causal span timeline
(submit -> admit -> flush -> solve -> dispatch -> terminal verdict) from
the schema-v2 ``trace_id`` / ``parent`` fields; ``--traces`` lists every
trace id in the stream with its completeness verdict.  A missing input is
a loud failure (exit ``MISSING_ARTIFACT = 4`` from
``repro_torch.obs.artifacts``, the port's copy of the module
``benchmarks/compare_bench.py`` shares) — a
report over nothing must never read as a healthy system.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, List

from repro_torch.obs.aggregate import EventAggregator
from repro_torch.obs.artifacts import load_artifact, missing_artifact
from repro_torch.obs.events import Event, read_jsonl
from repro_torch.obs.trace import (chain_complete, render_trace, spans,
                                   trace_ids)


def load_events(path: str) -> List[Event]:
    """Read one JSONL event stream fully (loud on a missing file)."""
    if not os.path.exists(path):
        raise missing_artifact(path, role="event stream")
    return list(read_jsonl(path))


def fold_events(path: str) -> Dict[str, Any]:
    """Fold one JSONL event stream into the aggregator snapshot."""
    return EventAggregator.fold(load_events(path)).snapshot()


def _fmt(x, unit: str = "") -> str:
    if x is None:
        return "n/a"
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return f"{x:.3f}{unit}" if isinstance(x, float) else f"{x}{unit}"


def render_events(path: str, snap: Dict[str, Any]) -> None:
    print(f"== event stream {path} (schema v{snap['schema']}) ==")
    print(f"  events: {snap['events']}  "
          + " ".join(f"{k}={v}" for k, v in snap["counts"].items()))
    print(f"  retraces after warmup: {snap['retraces']}  "
          f"(warmup traces: {snap['warmup_traces']}, "
          f"cache hits: {snap['cache_hits']})")
    for sla, d in snap["deadline"].items():
        print(f"  sla={sla}: hit rate {d['rate']:.3f} "
              f"({d['hits']} hit / {d['misses']} missed)")
    lat = snap["latency"]
    if lat.get("p50") is not None:
        print(f"  submit-to-plan latency: p50 {lat['p50'] * 1e3:.0f}ms  "
              f"p99 {lat['p99'] * 1e3:.0f}ms")
    conv = snap.get("convergence") or {}
    if conv.get("profiles"):
        stb = conv.get("steps_to_best") or {}
        print(f"  convergence ({conv['profiles']} profiles): "
              f"steps-to-best p50 {_fmt(stb.get('p50'))} "
              f"p99 {_fmt(stb.get('p99'))}  "
              f"plateau {_fmt(conv.get('plateau_fraction'))}  "
              f"accept decay {_fmt(conv.get('accept_decay'))}")
    if snap["headroom"] is not None:
        head = ", ".join(f"{h:.3f}" for h in snap["headroom"])
        print(f"  realized capacity headroom (min over audits): [{head}]")
    print(f"  capacity violations: {snap['violations']}")
    for pool, c in snap["pools"].items():
        print(f"  pool={pool}: "
              + " ".join(f"{k}={v}" for k, v in c.items()))
    print(f"  tenants with terminal verdicts: {snap['tenants']}")


def render_trace_list(path: str, events: List[Event]) -> None:
    ids = trace_ids(events)
    print(f"== traces in {path}: {len(ids)} ==")
    for tid in ids:
        chain = spans(events, tid)
        who = next((e.tenant for e in chain if e.tenant), "-")
        verdict = "complete" if chain_complete(chain) else "INCOMPLETE"
        print(f"  {tid}  {verdict:<10}  {len(chain)} spans  "
              f"tenant={who}  [{' -> '.join(e.type for e in chain)}]")


def render_bench(path: str, art: Dict[str, Any]) -> None:
    print(f"== benchmark artifact {path} "
          f"(schema v{art.get('schema')}, smoke={art.get('smoke')}) ==")
    for key, entry in sorted((art.get("throughput") or {}).items()):
        for unit in ("dags_per_sec", "steps_per_sec"):
            if unit in entry:
                print(f"  throughput {key}: {entry[unit]:.2f} "
                      f"{unit.split('_')[0]}/s")
    st = art.get("streaming") or {}
    if st:
        print(f"  streaming hit rate: sla {_fmt(st.get('hit_sla'))} vs "
              f"fifo {_fmt(st.get('hit_fifo'))}  "
              f"(retrace delta {st.get('retrace_delta')})")
    d = art.get("daemon") or {}
    if d:
        print(f"  daemon: guaranteed hit rate {_fmt(d.get('hit_rate'))}, "
              f"p50 {_fmt(d.get('p50_ms'), 'ms')}, "
              f"p99 {_fmt(d.get('p99_ms'), 'ms')}, "
              f"retraces after warmup {d.get('retrace_after_warmup')}")
    ov = art.get("overhead") or {}
    if ov:
        print(f"  observability overhead: {_fmt(ov.get('overhead_pct'))}% "
              f"steady-state (gate < {_fmt(ov.get('gate_pct'))}%)")
    ev = art.get("events")
    if ev:
        print("  event-derived mirror (gated == post-hoc inside the bench):")
        render_events(path, ev)
    print(f"  ok: {art.get('ok')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fold event streams / benchmark artifacts into one "
                    "serving report")
    ap.add_argument("paths", nargs="+",
                    help="*.jsonl event streams (JsonlSink output) and/or "
                         "BENCH_*.json benchmark artifacts")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object instead of "
                         "the human report")
    ap.add_argument("--trace", metavar="ID",
                    help="render the causal span timeline of ONE trace id "
                         "from the given event stream(s)")
    ap.add_argument("--traces", action="store_true",
                    help="list every trace id in the event stream(s) with "
                         "its chain-completeness verdict")
    args = ap.parse_args(argv)
    if args.trace or args.traces:
        streams = [p for p in args.paths if p.endswith(".jsonl")]
        if not streams:
            ap.error("--trace/--traces need at least one *.jsonl stream")
        for path in streams:
            events = load_events(path)
            if args.traces:
                render_trace_list(path, events)
            if args.trace:
                print(render_trace(events, args.trace))
        return 0
    out: Dict[str, Any] = {}
    for path in args.paths:
        if path.endswith(".jsonl"):
            out[path] = {"kind": "events", "report": fold_events(path)}
        else:
            out[path] = {"kind": "bench",
                         "report": load_artifact(path, role="artifact")}
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    for path, entry in out.items():
        if entry["kind"] == "events":
            render_events(path, entry["report"])
        else:
            render_bench(path, entry["report"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
