// Capacity-violation mass of B candidate schedules, for Hopper (sm_90a):
// the energy term of the penalized ("Ising-form") annealer.
//
// Replaces the Pallas TPU kernel repro/kernels/sched_energy.py:_kernel (the
// pl.pallas_call in sched_violation()). Contract: the same out[b] as
// repro_torch/kernels/ref.py:sched_violation_ref, bit for bit (the plain
// version fixes the order of every sum to the one used here), and within
// rtol 2e-5, atol 2e-4 of the JAX reference repro/kernels/ref.py.
//
//   usage[m, t] = sum_j dem[b, m, j] * 1[start_bj <= t < start_bj + dur_bj]
//   out[b]      = sum_{m, t < T} max(0, usage[m, t] - caps[m])
//
// Work: one thread block per candidate b; the threads share the (m, t)
// cells of the grid, cell k = m * T + t, with a loop when M * T exceeds the
// block. The row's start, end = start + dur and demands sit in shared
// memory, a tile of tasks at a time, and each thread adds the demands of
// the tasks covering its cell in task order, in float32. The excess
// max(0, usage - caps) of every cell goes to shared memory, and the block
// sums it by halving: pad to a power of two N, add cell k + N/2 into cell
// k, repeat. So a result is the same from run to run: no atomics, and the
// order is that of ref.py:pairwise_sum.
//
// What bounds it on this card: at the annealer's shapes (B = 512, M = 2 or
// 4, T = 256, J = 7 to 166) the arithmetic is B * M * T * J mask tests and
// adds, a few microseconds at the float32 peak, and the bytes (B * J *
// (2 + M) words) less; a launch of 512 small blocks is latency-bound. The
// TPU kernel's (J, Tt) mask-matmul on the MXU is not carried over: in TF32
// the tensor cores would lose too many bits for the contract, and the mask
// product is exact as an add.
//
// Exactness traps:
//   * the mask test is t >= s && t < s + d with s + d rounded in float32,
//     as in the reference; t - s < d would move the boundary;
//   * the build passes --fmad=false and every add is an explicit __fadd_rn
//     or __fsub_rn, so nothing is contracted;
//   * cells t >= T do not exist here (the TPU kernel masks its padding).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // opt-in limit of one block on sm_90

__global__ void __launch_bounds__(kThreads)
sched_violation_kernel(const float* __restrict__ start,  // (B, J)
                       const float* __restrict__ dur,    // (B, J)
                       const float* __restrict__ dem,    // (B, M, J)
                       const float* __restrict__ caps,   // (M,)
                       float* __restrict__ out,          // (B,)
                       int J, int M, int T, int n_pow2, int tile) {
  // dynamic shared memory: acc[n_pow2] | s[tile] | e[tile] | d[M * tile]
  extern __shared__ float smem[];
  float* acc = smem;
  float* s_t = acc + n_pow2;
  float* e_t = s_t + tile;
  float* d_t = e_t + tile;

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int cells = M * T;
  const float* start_b = start + b * J;
  const float* dur_b = dur + b * J;
  const float* dem_b = dem + b * (size_t)M * J;

  for (int k = tid; k < n_pow2; k += kThreads) acc[k] = 0.0f;
  for (int j0 = 0; j0 < J; j0 += tile) {
    const int nj = min(tile, J - j0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nj; i += kThreads) {
      const float s = start_b[j0 + i];
      s_t[i] = s;
      e_t[i] = __fadd_rn(s, dur_b[j0 + i]);
    }
    for (int i = tid; i < M * nj; i += kThreads) {
      const int m = i / nj;
      const int jj = i - m * nj;
      d_t[m * tile + jj] = dem_b[(size_t)m * J + j0 + jj];
    }
    __syncthreads();
    // each thread owns the cells k = tid + i * kThreads across all tiles
    for (int k = tid; k < cells; k += kThreads) {
      const int m = k / T;
      const float t = (float)(k - m * T);
      const float* d_m = d_t + m * tile;
      float u = acc[k];
      for (int jj = 0; jj < nj; ++jj)
        if (t >= s_t[jj] && t < e_t[jj]) u = __fadd_rn(u, d_m[jj]);
      acc[k] = u;
    }
  }
  for (int k = tid; k < cells; k += kThreads)
    acc[k] = fmaxf(__fsub_rn(acc[k], caps[k / T]), 0.0f);
  // the halving sum of ref.py:pairwise_sum, cells >= M * T are zeros
  for (int h = n_pow2 / 2; h > 0; h /= 2) {
    __syncthreads();
    for (int k = tid; k < h; k += kThreads)
      acc[k] = __fadd_rn(acc[k], acc[k + h]);
  }
  __syncthreads();
  if (tid == 0) out[b] = acc[0];
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue when one (M, T) grid does not fit in a block's
// shared memory.
int sched_violation_launch(const void* start, const void* dur,
                           const void* dem, const void* caps, void* out,
                           int B, int J, int M, int T, void* stream) {
  if (B <= 0) return 0;
  if (M <= 0 || T <= 0 || J < 0) return (int)cudaErrorInvalidValue;
  int n_pow2 = 1;
  while (n_pow2 < M * T) n_pow2 *= 2;
  // the largest task tile that fits in the default 48 KB, else in the
  // opt-in maximum
  const size_t per_task = 2 + (size_t)M;
  size_t budget = kDefaultSmem / sizeof(float);
  if ((size_t)n_pow2 + per_task > budget) budget = kMaxSmem / sizeof(float);
  if ((size_t)n_pow2 + per_task > budget) return (int)cudaErrorInvalidValue;
  const int tile = (int)std::min<size_t>(
      (size_t)(J > 0 ? J : 1), (budget - n_pow2) / per_task);
  const size_t smem = sizeof(float) * ((size_t)n_pow2 + per_task * tile);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sched_violation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sched_violation_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)start, (const float*)dur, (const float*)dem,
      (const float*)caps, (float*)out, J, M, T, n_pow2, tile);
  return (int)cudaGetLastError();
}

const char* sched_violation_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
