"""Shared benchmark-artifact loading for the trend gate and obs_report.

Both ``benchmarks/compare_bench.py`` and the ``obs_report`` CLI read
committed/archived ``BENCH_*.json`` artifacts, and both must fail LOUDLY
when one is absent: a gate comparing nothing must never read as a pass.
The distinct exit code for that case (``MISSING_ARTIFACT = 4``, first
used by the trend gate) is defined here, once, so the two CLIs cannot
drift apart.
"""
from __future__ import annotations

import json

# distinct exit code for an absent artifact, so CI can tell "the gate had
# nothing to read" from "the gate failed" (exit 1)
MISSING_ARTIFACT = 4


def missing_artifact(path: str, role: str = "artifact") -> SystemExit:
    """Print the canonical missing-artifact message and return the
    ``SystemExit`` to raise (callers ``raise missing_artifact(...)``)."""
    print(f"MISSING {role}: {path} does not exist — the gate has "
          f"nothing to read; point it at a previous run's artifact "
          f"or a committed benchmarks/baselines/ file "
          f"(exit {MISSING_ARTIFACT})")
    return SystemExit(MISSING_ARTIFACT)


def load_artifact(path: str, role: str = "artifact") -> dict:
    """Load a benchmark/event JSON artifact, exiting ``MISSING_ARTIFACT``
    with an actionable message when the file does not exist."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise missing_artifact(path, role) from None
