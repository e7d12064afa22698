"""Heterogeneous resource catalog.

Reproduces the paper's Table 1 (AWS m5 family, prices of 2022-01-27) and adds
a TPU-slice catalog so the same planner schedules accelerator pipelines. A
``Cluster`` is the capacity vector R_m of the RCPSP formulation: one resource
per instance type, capacity in instances, price per instance-hour.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class InstanceType:
    name: str
    vcpus: int
    memory_gb: int
    price_per_hour: float  # USD

    @property
    def price_per_sec(self) -> float:
        return self.price_per_hour / 3600.0


# Paper Table 1 (valid 2022-01-27).
AWS_M5: Tuple[InstanceType, ...] = (
    InstanceType("m5.4xlarge", 16, 64, 0.768),
    InstanceType("m5.8xlarge", 32, 128, 1.536),
    InstanceType("m5.12xlarge", 48, 192, 2.304),
    InstanceType("m5.16xlarge", 64, 256, 3.072),
)

# TPU v5e slice catalog (per-chip-hour list-price-like numbers; used when the
# planner schedules accelerator pipeline tasks). vcpus field doubles as chips.
TPU_V5E: Tuple[InstanceType, ...] = (
    InstanceType("v5e-4", 4, 64, 4.80),
    InstanceType("v5e-8", 8, 128, 9.60),
    InstanceType("v5e-16", 16, 256, 19.20),
    InstanceType("v5e-64", 64, 1024, 76.80),
    InstanceType("v5e-256", 256, 4096, 307.20),
)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Capacity vector over instance types (the RCPSP resources N)."""
    types: Tuple[InstanceType, ...]
    capacities: Tuple[int, ...]  # instances available per type

    def __post_init__(self):
        assert len(self.types) == len(self.capacities)

    @property
    def num_resources(self) -> int:
        return len(self.types)

    @property
    def caps(self) -> np.ndarray:
        return np.asarray(self.capacities, np.float64)

    @property
    def prices_per_sec(self) -> np.ndarray:
        return np.asarray([t.price_per_sec for t in self.types], np.float64)

    def index_of(self, name: str) -> int:
        for i, t in enumerate(self.types):
            if t.name == name:
                return i
        raise KeyError(name)


def paper_cluster(max_per_type: int = 16) -> Cluster:
    """The evaluation cluster: Table 1 types, up to 16 instances each
    (Table 2 selections never exceed 16)."""
    return Cluster(AWS_M5, (max_per_type,) * len(AWS_M5))


def tpu_cluster(max_per_type: int = 8) -> Cluster:
    return Cluster(TPU_V5E, (max_per_type,) * len(TPU_V5E))


def alibaba_cluster(machines: int = 4034, cores_per_machine: int = 96,
                    cpu_frac: float = 0.80, mem_frac: float = 0.60) -> Cluster:
    """Macro-benchmark cluster (§5.5.1): 4034 machines x 96 cores, reduced by
    the online-service share (20% cpu / 40% mem reserved). Modeled as one
    'cores' resource plus one 'memory' resource (percent-of-machine units)."""
    total_cores = int(machines * cores_per_machine * cpu_frac)
    total_mem = int(machines * 100 * mem_frac)  # memory in machine-percent units
    cores = InstanceType("cores", 1, 0, 0.0475 / 16)   # ~m5 per-vcpu price
    mem = InstanceType("mem-pct", 0, 1, 0.0)
    return Cluster((cores, mem), (total_cores, total_mem))
