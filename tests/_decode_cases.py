"""Kernel instances shared by the port's tests and ``chip_smoke.py`` (numpy
only, so the card-side tests import no jax): a numpy copy of
tests/test_sgs_decode.py's ``_random_instance`` and edge cases, and the
``sched_violation`` / ``usl_runtime`` inputs of tests/test_kernels.py."""
import numpy as np

SHAPES = [(1, 1, 1, 32), (4, 7, 2, 64), (8, 20, 3, 256), (2, 33, 4, 100),
          (3, 12, 1, 128)]


def random_instance(rng, B, J, M, T, edge_density=0.15):
    dur = rng.integers(0, max(T // 3, 1), (B, J)).astype(np.int32)
    dur[:, ::5] = 0                       # zero-duration (masked) slots
    dem = rng.uniform(0, 3, (B, J, M)).astype(np.float32)
    dem[:, ::3, :] = 0.0                  # zero-demand tasks
    prio = rng.normal(size=(B, J)).astype(np.float32)
    prio[:, ::7] = -1e9                   # masked-slot sentinel priority
    release = rng.integers(0, T, (J,)).astype(np.int32)
    pred = np.zeros((J, J), bool)
    for _ in range(int(edge_density * J * J) + J):
        a, b = rng.integers(0, J, 2)
        if a < b:
            pred[b, a] = True             # DAG: edges point forward
    caps = rng.uniform(0.5, 6, (M,)).astype(np.float32)
    return [dur, dem, prio, release, pred, caps]


def edge_cases():
    """(args, T): a fully masked padding problem, all-equal priorities, and
    releases past the horizon (the fallback placement path)."""
    T, J, M = 64, 6, 2
    z = np.zeros
    masked = [z((2, J), np.int32), z((2, J, M), np.float32),
              np.full((2, J), -1e9, np.float32), z((J,), np.int32),
              z((J, J), bool), np.ones((M,), np.float32)]
    rng = np.random.default_rng(1)
    dur = rng.integers(1, 8, (3, J)).astype(np.int32)
    dem = rng.uniform(0, 2, (3, J, M)).astype(np.float32)
    ties = [dur, dem, z((3, J), np.float32), z((J,), np.int32),
            z((J, J), bool), np.full((M,), 1.5, np.float32)]
    late = [dur, dem, rng.normal(size=(3, J)).astype(np.float32),
            np.full((J,), T + 5, np.int32), z((J, J), bool),
            np.full((M,), 0.1, np.float32)]
    return [(masked, T), (ties, T), (late, T)]


def grouped_instance(rng, G, rows, J, M, T):
    """G instances sharing one caps vector, stacked into one grouped call:
    returns (the per-group instances, the grouped arguments)."""
    insts = [random_instance(rng, rows, J, M, T) for _ in range(G)]
    caps = insts[0][5]
    for inst in insts:
        inst[5] = caps
    stacked = [np.concatenate([i[k] for i in insts]) for k in range(3)]
    return insts, stacked + [np.stack([i[3] for i in insts]),
                             np.stack([i[4] for i in insts]), caps]


# grouped shapes (G, rows per group, J, M, T) of the main path's decodes:
# the isolated engine's 16 problems x 256 chains at J 14, the shared
# engine's one joint problem of 16 x 14 slots, and an odd group size at
# J > 32 (one row per block, a partial last word of the successor mask)
MAIN_PATH_SHAPES = [(16, 256, 14, 2, 256), (1, 256, 224, 2, 256),
                    (3, 5, 40, 2, 100)]


def kernel_cases():
    """(args, T) instances the CUDA kernel is held to on the card: the
    random sweep, the edge cases, a grouped call at the isolated engine's
    width, one with J = 300 slots (ten words of slots a lane), and the
    ``MAIN_PATH_SHAPES``."""
    rng = np.random.default_rng(7)
    cases = [(random_instance(rng, *s), s[3]) for s in SHAPES]
    cases += edge_cases()
    cases.append((grouped_instance(rng, 4, 64, 16, 2, 256)[1], 256))
    cases.append((grouped_instance(rng, 1, 32, 300, 2, 300)[1], 300))
    cases += [(grouped_instance(rng, *s)[1], s[4]) for s in MAIN_PATH_SHAPES]
    return cases


# tests/test_kernels.py's shapes: sched_violation (B, J, M, T), usl_runtime
SCHED_SHAPES = [(1, 1, 1, 16), (4, 7, 4, 100), (8, 33, 2, 256),
                (2, 130, 3, 300), (16, 5, 1, 64), (3, 128, 8, 128)]
USL_SHAPES = [(1,), (100,), (7, 13), (1025,), (4, 8, 32)]

# sched_violation (B, J, M, T) beyond tests/test_kernels.py: the ising
# engine's isolated and shared shapes at IsingConfig() defaults; the
# largest grids of the kernel's envelope (M 8 x T 300 pads to 4096 cells,
# M 8 x T 512 is 4096 cells); and grids whose T is a multiple of 32 W but
# no power of two times it (T 96, 192, 288), which take the general layout
SCHED_MAIN_SHAPES = [(512, 10, 2, 256), (512, 166, 2, 256)]
SCHED_ENVELOPE_SHAPES = [(16, 40, 8, 300), (4, 33, 8, 512), (8, 33, 2, 96),
                         (8, 33, 2, 192), (4, 20, 1, 288)]


def sched_instance(B, J, M, T):
    """start, dur (B, J), dem (B, M, J), caps (M,) float32, seeded as
    tests/test_kernels.py seeds them."""
    rng = np.random.default_rng(B * 1000 + J)
    start = rng.uniform(0, T * 0.9, (B, J))
    dur = rng.uniform(1, T * 0.3, (B, J))
    dem = rng.uniform(0, 4, (B, M, J))
    caps = rng.uniform(2, 10, (M,))
    return [np.asarray(x, np.float32) for x in (start, dur, dem, caps)]


def usl_instance(shape):
    """n, alpha, beta, gamma, work of one shape, float32."""
    rng = np.random.default_rng(42)
    args = (rng.integers(1, 64, shape), rng.uniform(0, 0.2, shape),
            rng.uniform(0, 0.01, shape), rng.uniform(0.5, 3, shape),
            rng.uniform(10, 1000, shape))
    return [np.asarray(x, np.float32) for x in args]
