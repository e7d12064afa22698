"""Write the reference's plan energies for the port's quality rule.

Runs the JAX package on CPU JAX over the seed sweep of ``tests/_quality.py``
and writes one JSON fixture per scale under ``tests/torch_golden/``:
``quality_full.json`` (chip_smoke.py's four cells at their config
defaults, read on the card) and ``quality_small.json`` (the two vectorized
cells at ``VecConfig(chains=16, iters=60, grid=128)`` on 4 DAGs, read by
the CPU test). The machine with the card then needs no jax. Tier-1 never
runs this; regenerate after a change to the reference's solvers or to the
cells:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_quality_reference.py
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_quality_reference.py \\
        --scale full --cells shared --seeds 0 1

``--print-only`` prints the seed means and writes nothing (a wider sweep
than the fixture's, to compare the two packages' distributions);
``--package repro_torch`` runs the port on the CPU that way.
"""
import argparse
import importlib
import json
import os
import time

import numpy as np

import _quality as q

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_golden")


def path(scale: str) -> str:
    return os.path.join(GOLDEN, f"quality_{scale}.json")


def write(scale: str, cell: str, means, plans: int, seconds: float) -> None:
    """Merge one cell's seeds into the scale's fixture: other cells and the
    cell's other seeds are kept, so separate runs may write the cells and
    the seeds of one cell; the bound is recomputed over all its seeds."""
    out = path(scale)
    doc = {"scale": scale, "config": q.SCALES[scale], "cells": {}}
    if os.path.exists(out):
        with open(out) as f:
            doc["cells"] = json.load(f)["cells"]
    entry = doc["cells"].get(cell, {"seeds": {}, "cpu_seconds": 0.0})
    entry["seeds"].update({str(s): m for s, m in means.items()})
    entry["plans_per_seed"] = plans
    entry["bound"] = q.limit(entry["seeds"].values())
    entry["cpu_seconds"] = round(entry["cpu_seconds"] + seconds, 1)
    doc["cells"][cell] = entry
    os.makedirs(GOLDEN, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", choices=sorted(q.SCALES),
                        action="append")
    parser.add_argument("--cells", nargs="+", choices=sorted(q.CELLS))
    parser.add_argument("--seeds", nargs="+", type=int,
                        help="solver seeds to run (default: the scale's "
                             "sweep); merged into the fixture's others")
    parser.add_argument("--package", choices=("repro", "repro_torch"),
                        default="repro")
    parser.add_argument("--print-only", action="store_true")
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    port = args.package == "repro_torch"
    api = q.modules({m: importlib.import_module(f"{args.package}.{m}")
                     for m in q.MODULES}, **({"device": "cpu"} if port
                                              else {}))
    for scale in args.scale or sorted(q.SCALES):
        for cell in args.cells or sorted(q.SCALES[scale]["seeds"]):
            if cell not in q.SCALES[scale]["seeds"]:
                continue
            t0 = time.monotonic()
            means, errors = q.sweep(api, cell, scale, seeds=args.seeds)
            if errors:
                raise SystemExit(f"{scale}/{cell}: the reference returned "
                                 f"invalid plans: {errors[:3]}")
            values = [m for m, _ in means.values()]
            print(f"{args.package} {scale}/{cell}: {means}; mean "
                  f"{float(np.mean(values))!r} over {len(values)} seeds, "
                  f"standard error "
                  f"{float(np.std(values, ddof=1) / np.sqrt(len(values)))!r}",
                  flush=True)
            if not (port or args.print_only):
                write(scale, cell, {s: m for s, (m, _) in means.items()},
                      next(iter(means.values()))[1], time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
