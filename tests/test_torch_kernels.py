"""The port's plain ``sched_violation``, ``usl_runtime`` and
``schedule_objective`` against the JAX package, on the CPU.

Inputs come from numpy seeds; bfloat16 cases round the same float32
values to bfloat16 in each framework. Tolerances are those of
``tests/test_kernels.py``: rtol 2e-5, atol 2e-4 for the violation mass
(float32 sums taken in another order), rtol 1e-5, atol 1e-5 for the USL
runtime and the objective's four outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sched_energy import sched_violation as j_sched_pallas
from _decode_cases import (SCHED_ENVELOPE_SHAPES, SCHED_MAIN_SHAPES,
                           SCHED_SHAPES, SCHED_WIDE_SHAPES, USL_SHAPES,
                           sched_instance, usl_instance)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sched_violation as sv_kernel

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """One float32 array as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _sched_inputs(B, J, M, T, dtype):
    start, dur, dem, caps = sched_instance(B, J, M, T)
    return tuple(zip(_both(start, dtype), _both(dur, dtype),
                     _both(dem, dtype), _both(caps, "f32")))


@pytest.mark.parametrize("B,J,M,T", SCHED_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sched_violation_matches_reference(B, J, M, T, dtype):
    jargs, targs = _sched_inputs(B, J, M, T, dtype)
    want = np.asarray(jref.sched_violation_ref(*jargs, T))
    got = ops.sched_violation(*targs, T=T)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    assert (got >= 0).all()
    inf_caps = torch.full((M,), 1e9)
    np.testing.assert_array_equal(
        ops.sched_violation(*targs[:3], inf_caps, T=T).numpy(), 0.0)


@pytest.mark.parametrize("B,J,M,T", [(4, 7, 4, 100), (2, 130, 3, 300)])
def test_sched_violation_matches_pallas_interpret(B, J, M, T):
    jargs, targs = _sched_inputs(B, J, M, T, "f32")
    want = np.asarray(j_sched_pallas(*jargs, T=T, interpret=True))
    got = ops.sched_violation(*targs, T=T)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("n", [1, 5, 8, 300, 1025])
def test_pairwise_sum_is_a_sum(n):
    x = torch.from_numpy(np.random.default_rng(n).uniform(0, 1, (3, n))
                         .astype(np.float32))
    np.testing.assert_allclose(ref.pairwise_sum(x).numpy(),
                               x.double().sum(dim=1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B", [1, 16, 512, 4096])
def test_sched_violation_geometry_covers_envelope(B, sms):
    """For every grid of the envelope (M <= 8, M * T <= 4096): a block of
    at most 512 threads (the kernel's limit, within 1024), the lanes'
    registers cover exactly the padded grid, and more than one candidate a
    block only while every SM still gets a block."""
    for M in range(1, sv_kernel.MAX_M + 1):
        for T in range(1, sv_kernel.MAX_CELLS // M + 1):
            R, W, C, K, N = sv_kernel.geometry(B, M, T, sms)
            assert N & (N - 1) == 0 and max(128, M * T) <= N <= 4096
            assert N < 2 * max(128, M * T)
            assert C in (4, 8, 16) and W & (W - 1) == 0
            assert W * 32 * C == N
            assert R * W * 32 <= sv_kernel.MAX_THREADS <= 1024
            assert R == 1 or -(-B // R) >= sms
            assert K == 0 or (T == 32 * W * K and K & (K - 1) == 0
                              and M * K <= C)


@pytest.mark.parametrize("M,T", [(9, 1), (1, 4097), (8, 513), (2, 0)])
def test_sched_violation_geometry_refuses_beyond_envelope(M, T):
    """Past the register layout's envelope the launch leaves it for the
    wide path (one candidate a block, N / 4096 passes of 4096 cells, N the
    grid padded to a power of two, at least 4096); a grid with no cells
    raises."""
    if T == 0:
        with pytest.raises(ValueError, match="no cells"):
            sv_kernel.geometry(512, M, T, 132)
        return
    R, W, C, K, N = sv_kernel.geometry(512, M, T, 132)
    assert sv_kernel.is_wide(M, N) and (R, W, C) == sv_kernel.WIDE
    assert K == 0 and N == max(4096, 1 << (M * T - 1).bit_length())


def test_sched_violation_geometry_of_ising_shape():
    """The ising engine's (B 512, M 2, T 256) on 132 SMs: one warp of 16
    cells a lane per candidate, two candidates a block, 256 blocks."""
    assert sv_kernel.geometry(512, 2, 256, 132) == (2, 1, 16, 8, 512)


@pytest.mark.parametrize("M,T,K", [(2, 256, 8), (4, 256, 4), (8, 512, 2),
                                   (1, 128, 4), (2, 96, 0), (2, 192, 0),
                                   (1, 288, 0), (3, 300, 0)])
def test_sched_violation_geometry_layout(M, T, K):
    """Bin-major (K > 0) exactly where T = 32 W K with K a power of two,
    as the kernel has it; the general layout (K = 0) for any other T."""
    assert sv_kernel.geometry(512, M, T, 132)[3] == K


def _kernel_order_sum(x: torch.Tensor, W: int, C: int) -> torch.Tensor:
    """The CUDA kernel's sum of x (B, N), N = 32 W C, in plain torch: cell
    c = 32 w + l + 32 W i is register i of lane l of warp w. Register
    levels (i += i + h), then warp levels (warp k += warp k + h, through
    shared memory), then five ``__shfl_down_sync`` levels, where a lane
    with no source lane gets its own value back."""
    B, N = x.shape
    assert N == 32 * W * C
    v = x.reshape(B, C, W, 32)                         # [b, i, w, l]
    h = C // 2
    while h:
        v = torch.cat([v[:, :h] + v[:, h:2 * h], v[:, h:]], dim=1)
        h //= 2
    v = v[:, 0]                                        # (B, W, 32)
    h = W // 2
    while h:
        v = torch.cat([v[:, :h] + v[:, h:2 * h], v[:, h:]], dim=1)
        h //= 2
    v = v[:, 0]                                        # (B, 32)
    lane = torch.arange(32)
    for h in (16, 8, 4, 2, 1):
        src = torch.where(lane + h < 32, lane + h, lane)
        v = v + v[:, src]
    return v[:, 0]


def _wide_order_sum(x: torch.Tensor, S: int) -> torch.Tensor:
    """The wide path's sum of x (B, 4096 S), in plain torch: pass r sums
    the cells r + S c', c' < 4096, in the register layout's order (8 warps
    of 16 cells a lane); the passes run in bit-reversed order of r and a
    binary counter merges their sums, older + newer, level by level."""
    log2 = S.bit_length() - 1
    assert x.shape[1] == 4096 * S and S == 1 << log2
    stack = {}
    for q in range(S):
        r = int(format(q, f"0{log2}b")[::-1], 2) if log2 else 0
        v, lvl = _kernel_order_sum(x[:, r::S], 8, 16), 0
        while (q >> lvl) & 1:
            v, lvl = stack[lvl] + v, lvl + 1
        stack[lvl] = v
    return stack[log2]


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sched_violation_wide_order_is_pairwise_sum(S):
    """The wide path's order equals ``pairwise_sum``'s, bit for bit, on
    float32 data of mixed signs and magnitudes, for a grid of any length
    (padded with +0 to 4096 S cells), where summing contiguous tiles and
    adding the tiles' sums would not."""
    rng = np.random.default_rng(S)
    for n in (4096 * S, 4096 * S - 2045, 4096 * S // 2 + 1):
        x = (rng.uniform(-1, 1, (32, n))
             * 10.0 ** rng.uniform(-8, 8, (32, n))).astype(np.float32)
        x = torch.from_numpy(x)
        padded = torch.nn.functional.pad(x, (0, 4096 * S - n))
        want = ref.pairwise_sum(x)
        assert torch.equal(_wide_order_sum(padded, S), want)
        if S > 1:
            tiles = torch.stack([_kernel_order_sum(t, 8, 16) for t in
                                 padded.split(4096, dim=1)], dim=1)
            assert not torch.equal(ref.pairwise_sum(tiles), want)


@pytest.mark.parametrize("B,J,M,T", SCHED_WIDE_SHAPES)
def test_sched_violation_wide_path_order_is_exact(B, J, M, T):
    """On the wide path's shapes (the ising engine at grid 2048 on four
    resources, one cell past 4096, M 9, M 12, J 166), the emulated order of
    the wide kernel over the excess grid equals ``sched_violation_ref``
    with ``torch.equal``, and the plain version agrees with the JAX
    reference within its tolerance."""
    start, dur, dem, caps = (torch.from_numpy(x)
                             for x in sched_instance(B, J, M, T))
    N = sv_kernel.geometry(B, M, T, 132)[4]
    over = ref.excess_grid(start, dur, dem, caps, T)
    got = _wide_order_sum(torch.nn.functional.pad(over, (0, N - M * T)),
                          N // 4096)
    want = ref.sched_violation_ref(start, dur, dem, caps, T)
    assert torch.equal(got, want)
    jwant = np.asarray(jref.sched_violation_ref(
        *(jnp.asarray(x.numpy()) for x in (start, dur, dem, caps)), T))
    np.testing.assert_allclose(want.numpy(), jwant, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("N", [32 << k for k in range(8)])
def test_sched_violation_kernel_order_is_pairwise_sum(N):
    """Every lane layout 32 W C = N (a superset of what ``geometry`` picks)
    sums in ``ref.pairwise_sum``'s order, bit for bit, on float32 data of
    mixed signs and magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(N)
    x = (rng.uniform(-1, 1, (64, N))
         * 10.0 ** rng.uniform(-30, 30, (64, N))).astype(np.float32)
    x[:, rng.integers(0, N, N // 4)] = 0.0
    x = torch.from_numpy(x)
    want = ref.pairwise_sum(x)
    for W in (1 << k for k in range(6)):
        if N % (32 * W) == 0:
            got = _kernel_order_sum(x, W, N // (32 * W))
            assert torch.equal(got, want), (N, W)


@pytest.mark.parametrize("B,J,M,T", SCHED_SHAPES + SCHED_MAIN_SHAPES
                         + SCHED_ENVELOPE_SHAPES)
def test_sched_violation_padding_is_exact(B, J, M, T):
    """The kernel pads the excess grid with +0 to geometry's N, past the
    power of two above M * T where that is under 128 cells; the kernel's
    order over the padded grid equals ``pairwise_sum`` over the unpadded
    one, for each lane layout geometry picks on 132 or 114 SMs."""
    start, dur, dem, caps = (torch.from_numpy(x)
                             for x in sched_instance(B, J, M, T))
    end = start + dur
    t = torch.arange(T, dtype=torch.float32)
    mask = ((t >= start[:, :, None]) & (t < end[:, :, None])).float()
    usage = torch.einsum("bmj,bjt->bmt", dem, mask)
    over = torch.clamp(usage - caps[None, :, None], min=0.0).reshape(B, -1)
    want = ref.pairwise_sum(over)
    for sms in (132, 114):
        _, W, C, _, N = sv_kernel.geometry(B, M, T, sms)
        padded = torch.nn.functional.pad(over, (0, N - M * T))
        assert torch.equal(_kernel_order_sum(padded, W, C), want)


@pytest.mark.parametrize("shape", USL_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_usl_runtime_matches_reference(shape, dtype):
    args = [_both(x, dtype) for x in usl_instance(shape)]
    want = np.asarray(jref.usl_runtime_ref(*[a[0] for a in args]))
    got = ops.usl_runtime(*[a[1] for a in args])
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_usl_runtime_broadcasts():
    n = torch.arange(1, 9, dtype=torch.float32)[:, None]          # (8, 1)
    w = torch.linspace(10, 100, 5)[None, :]                       # (1, 5)
    a, b, g = torch.tensor(0.05), torch.tensor(0.001), torch.tensor(1.5)
    got = ops.usl_runtime(n, a, b, g, w)
    want = jref.usl_runtime_ref(*(jnp.asarray(x.numpy())
                                  for x in (n, a, b, g, w)))
    assert tuple(got.shape) == (8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _objective_inputs(seed, edges):
    rng = np.random.default_rng(seed)
    B, J, M, T = 6, 9, 2, 96
    f32 = np.float32
    arrays = dict(
        start=rng.uniform(0, 60, (B, J)).astype(f32),
        dur=rng.uniform(1, 20, (B, J)).astype(f32),
        dem=rng.uniform(0, 2, (B, M, J)).astype(f32),
        caps=np.asarray([3.0, 4.0], f32),
        costs=rng.uniform(5, 50, (B,)).astype(f32))
    pairs = (np.asarray(edges, np.int32).reshape(-1, 2) if edges
             else np.zeros((1, 2), np.int32))       # the reference's dummy
    return arrays, pairs, T


@pytest.mark.parametrize("edges", [[(0, 1), (1, 4), (2, 4), (4, 8)], []],
                         ids=["dag", "edge-less"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_objective_matches_reference(edges, seed):
    arrays, pairs, T = _objective_inputs(seed, edges)
    goal_w, ref_M, ref_C = 0.5, 48.0, 30.0
    want = jops.schedule_objective(
        *(jnp.asarray(arrays[k]) for k in
          ("start", "dur", "dem", "caps", "costs")),
        jnp.asarray(pairs), goal_w, ref_M, ref_C, T=T)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    got = ops.schedule_objective(
        *(torch.from_numpy(arrays[k]) for k in
          ("start", "dur", "dem", "caps", "costs")),
        torch.from_numpy(pairs).long(), f32(goal_w), f32(ref_M), f32(ref_C),
        T=T)
    for name, w, g in zip(("energy", "makespan", "viol", "prec"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if not edges:
        # the dummy edge (0, 0) charges dur[task 0] to the precedence term
        np.testing.assert_allclose(got[3].numpy(), arrays["dur"][:, 0],
                                   rtol=1e-6)


def test_use_kernel_true_on_cpu_tensors_raises():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        ops.sched_violation(z((1, 2)), z((1, 2)), z((1, 1, 2)), z(1), T=8,
                            use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.usl_runtime(*[z(3)] * 5, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.schedule_objective(
            z((1, 2)), z((1, 2)), z((1, 1, 2)), z(1), z(1),
            torch.zeros((1, 2), dtype=torch.long), z(()), z(()) + 1,
            z(()) + 1, T=8, use_kernel=True)
