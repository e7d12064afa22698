"""Least time of one ``sgs_decode`` launch, frozen into the benchmark.

Copied from ``chip_smoke.py:least_ms`` and ``bound`` (the decode's bytes
once over HBM, its float32 operations over the peak outside the tensor
cores), taking the launch's input shapes instead of its tensors. One term
of the original counts the (bin, resource) adds of the bins a launch
places, which only its outputs tell; it is left out here, so the least
time reads low by that term (about 2% of the operations at the cells'
shapes) and a share of it never reads high.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W limit).
"""
from __future__ import annotations

from math import prod
from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """The larger of the two times, in ms, and which one bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound(shapes: Dict) -> Tuple[float, str, float, float]:
    """(least ms, what bounds it, bytes, operations) of one launch whose
    inputs have ``shapes`` (dur, dem, prio, release, pred, caps as tuples,
    and the grid ``T``): each input read once and each output written once;
    per row and step J argmax compares, 3 operations per (bin, resource)
    for the overload flag and 4 per bin for the prefix sum and the window
    test."""
    rows, J = shapes["dur"]
    release = shapes["release"]
    G = 1 if len(release) == 1 else release[0]
    M = shapes["caps"][0]
    T = shapes["T"]
    nbytes = (4 * prod(shapes["dur"]) + 4 * prod(shapes["dem"])
              + 4 * prod(shapes["prio"]) + 4 * J * G + J * J * G + 4 * M
              + 9 * rows * J)
    ops = rows * J * (J + 3 * T * M + 4 * T)
    return (*least_ms(nbytes, ops), nbytes, ops)
