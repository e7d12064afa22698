"""CLI entry for the planner-serving daemon (``repro_torch.flow.daemon``).

Stands up a ``PlannerService`` over a demo shared-capacity cluster, warms
the bucket schedule ahead of traffic, and serves the JSON-over-HTTP
adapter until interrupted. It solves on the card unless ``--device cpu``
is given; without a card and without that option it raises:

  PYTHONPATH=src python -m repro_torch.launch.serve_planner --port 8787
  PYTHONPATH=src python -m repro_torch.launch.serve_planner --device cpu

  curl -s localhost:8787/healthz
  curl -s localhost:8787/v1/stats
  curl -s -X POST localhost:8787/v1/plan -d '{"dag": {...}}'
"""
from __future__ import annotations

import argparse
import asyncio

from repro_torch.cluster.catalog import Cluster, InstanceType
from repro_torch.core.agora import Agora
from repro_torch.core.dag import DAG, Task, TaskOption
from repro_torch.core.objectives import Goal
from repro_torch.core.vectorized import VecConfig
from repro_torch.flow.daemon import (DaemonConfig, PlannerHTTPServer,
                                     PlannerService, PoolSpec)
from repro_torch.obs.sink import NULL, JsonlSink


def demo_cluster(cores: float = 16.0, price: float = 0.0475) -> Cluster:
    return Cluster((InstanceType("cores", 1, 0, price),), (cores,))


def demo_template(price: float = 0.0475) -> DAG:
    """Warmup template: fixes the (Jmax, Omax) envelope live batches must
    land inside (3 tasks, 2 options — the grab/lean benchmark shape)."""
    prep = Task("prep", [TaskOption("1-core", 20.0, (1.0,), 20.0 * price)])
    heavies = [
        Task(f"heavy{h}", [
            TaskOption("grab-10-cores", 100.0, (10.0,), 1000.0 * price),
            TaskOption("lean-1-core", 400.0, (1.0,), 400.0 * price),
        ]) for h in range(2)]
    return DAG("template", [prep] + heavies, edges=[(0, 1), (0, 2)])


async def _serve(args) -> None:
    cluster = demo_cluster()
    agora = Agora(cluster, goal=Goal.balanced(), solver="vectorized",
                  vec_cfg=VecConfig(chains=args.chains, iters=args.iters,
                                    grid=args.grid, seed=0),
                  device=args.device)
    # operator sink: tail with `tail -f events.jsonl` or fold after the
    # fact with `python -m repro_torch.launch.obs_report events.jsonl`
    sink = JsonlSink(args.events) if args.events else NULL
    cfg = DaemonConfig(
        pools=(PoolSpec("shared", shared_capacity=True,
                        bucket_p=args.bucket),),
        max_batch=args.max_batch, max_wait_s=args.max_wait,
        slack_margin_s=args.slack_margin, flush=args.flush, sink=sink)
    service = PlannerService(agora, cfg)
    print(f"warming buckets up to P={args.max_batch} ...", flush=True)
    warm = service.warmup(demo_template(), max_p=args.max_batch)
    for pool, buckets in warm.items():
        for b, secs in sorted(buckets.items()):
            print(f"  pool={pool} bucket P={b}: {secs:.2f}s", flush=True)
    http = PlannerHTTPServer(service, args.host, args.port)
    async with service:
        host, port = await http.start()
        print(f"planner daemon serving on http://{host}:{port} "
              f"(flush={cfg.flush}, max_batch={cfg.max_batch})", flush=True)
        try:
            await asyncio.Event().wait()   # serve until interrupted
        finally:
            await http.stop()
            sink.close()
    dropped = getattr(sink, "dropped", 0)
    if dropped:
        # the tape is short: events raced shutdown and missed the file
        print(f"WARNING: {dropped} event(s) dropped after the event "
              f"stream closed — {args.events} is incomplete", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--bucket", type=int, default=8,
                    help="minimum problem-axis bucket")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="bucket-fill flush target")
    ap.add_argument("--max-wait", type=float, default=30.0,
                    help="flush a non-empty queue after this long (s)")
    ap.add_argument("--slack-margin", type=float, default=10.0,
                    help="deadline-flush safety margin (s)")
    ap.add_argument("--flush", default="deadline",
                    choices=("deadline", "fill"))
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="append the structured event stream to this "
                         "JSON-lines file (see docs/events.md)")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help='where the solver runs ("cuda" or "cpu")')
    args = ap.parse_args(argv)
    try:
        asyncio.run(_serve(args))
    except KeyboardInterrupt:
        print("shutting down", flush=True)


if __name__ == "__main__":
    main()
