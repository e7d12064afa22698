// Serial-SGS grid decode for Hopper (sm_90a): the AGORA solver's hot loop.
//
// Replaces the Pallas TPU kernel repro/kernels/sgs_decode.py:_kernel (the
// pl.pallas_call in sgs_decode()). Contract: bit-for-bit the same start,
// finish and ok as repro_torch/kernels/ref.py:sgs_decode_ref, which is
// itself bit-for-bit the JAX reference repro/kernels/ref.py:sgs_decode_ref.
//
// Work: one thread block per chain row. Each block runs the J placement
// steps of its row in order; inside a step the threads share the time bins
// (one thread per bin at T = 256) and the task slots.
//   1. block argmax over eligible scores, FIRST index on ties (as
//      jnp.argmax / torch.argmax); ineligible slots score -inf, the masked
//      slot sentinel -1e9 is eligible;
//   2. ready = max(release, max finish of the predecessors);
//   3. per-bin overload flag: usage + r > caps + 1e-6 on a demanded resource;
//   4. integer block prefix sum of the flags, then the first feasible start
//      t >= ready with t + d <= T and a clean window, by min-reduction;
//   5. fallback t* = max(ready, T - d) with ok = false;
//   6. add the demand to the usage window [t*, min(t* + d, T)).
// Eligibility is a remaining-predecessor count per slot and ready is a
// running max pushed to the successors: both give exactly the reference's
// O(J^2)-per-step scan at O(J) per step.
//
// What bounds it on this card: neither the bytes (a row reads J*(3+M)
// words and writes J*9 bytes) nor the arithmetic (J*(J + 3*T*M + 2*T)
// simple ops per row) but latency: the J steps of a row are serial and each
// step is a chain of block-wide reductions and barriers. The design keeps
// the (T, M) usage, the prefix sums and the per-slot state in shared
// memory (a few KB per block), so a step never touches device memory
// besides the L2-resident pred column, and it runs one block per row so
// the 4096 rows of an isolated sweep fill all 132 SMs at once. The (T, T)
// mask-matmul of the TPU kernel (an MXU device) is not carried over: the
// integer prefix sum is the reference's own formulation and is exact.
//
// Exactness traps (each one breaks bit-for-bit parity):
//   * caps + 1e-6 is float32 arithmetic in the reference. A bare 1e-6 is a
//     double in C++ and would move the threshold, so the sum is
//     __fadd_rn(caps, 1e-6f); every float add is an explicit __fadd_rn and
//     the build passes --fmad=false, so nothing is contracted.
//   * a zero-duration slot lands on the first t >= ready with t < T: the
//     candidates are the bins [0, T) only (the Pallas kernel needs an
//     explicit tr < T; here the loop bound gives it).
//   * a fallback placement past T adds nothing to usage but still sets
//     finish = t* + d.
//   * an all-masked padding row (every dur 0, every prio -1e9) places each
//     slot at its ready bin in index order, as the reference does.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) beats (bv, bi): larger score, or the same score at a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
sgs_decode_kernel(const int32_t* __restrict__ dur,      // (rows, J)
                  const float* __restrict__ dem,        // (rows, J, M)
                  const float* __restrict__ prio,       // (rows, J)
                  const int32_t* __restrict__ release,  // (G, J)
                  const uint8_t* __restrict__ pred,     // (G, J, J)
                  const float* __restrict__ caps,       // (M,)
                  int32_t* __restrict__ start,          // (rows, J)
                  int32_t* __restrict__ finish,         // (rows, J)
                  uint8_t* __restrict__ ok,             // (rows, J)
                  int J, int M, int T, int rows_per_group) {
  // dynamic shared memory: usage[T*M] | r[M] | caps_eps[M] (f32),
  // cs[T+1] | npred[J] | ready[J] (i32), scheduled[J] (u8)
  extern __shared__ float smem[];
  float* usage = smem;
  float* r = usage + (size_t)T * M;
  float* caps_eps = r + M;
  int* cs = reinterpret_cast<int*>(caps_eps + M);
  int* npred = cs + (T + 1);
  int* ready_of = npred + J;
  uint8_t* scheduled = reinterpret_cast<uint8_t*>(ready_of + J);

  __shared__ float s_best_v[kWarps];
  __shared__ int s_best_i[kWarps];
  __shared__ int s_warp[kWarps];
  __shared__ int s_j, s_d, s_ready, s_tstar;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const size_t g = row / rows_per_group;
  const int32_t* dur_r = dur + row * J;
  const float* dem_r = dem + row * J * M;
  const float* prio_r = prio + row * J;
  const int32_t* rel_g = release + g * J;
  const uint8_t* pred_g = pred + g * J * J;

  for (int i = tid; i < T * M; i += kThreads) usage[i] = 0.0f;
  for (int m = tid; m < M; m += kThreads)
    caps_eps[m] = __fadd_rn(caps[m], 1e-6f);
  if (tid == 0) cs[0] = 0;
  // predecessor counts: one warp per slot reads its pred row coalesced
  for (int s = warp; s < J; s += kWarps) {
    int n = 0;
    for (int base = 0; base < J; base += 32) {  // same trip count on every lane
      const int p = base + lane;
      const bool edge = p < J && pred_g[(size_t)s * J + p] != 0;
      n += __popc(__ballot_sync(kFull, edge));
    }
    if (lane == 0) {
      npred[s] = n;
      ready_of[s] = 0;
      scheduled[s] = 0;
    }
  }
  __syncthreads();

  for (int step = 0; step < J; ++step) {
    // 1. argmax over eligible scores, first index on ties
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int s = tid; s < J; s += kThreads) {
      const float v = (!scheduled[s] && npred[s] == 0) ? prio_r[s] : -INFINITY;
      if (beats(v, s, bv, bi)) { bv = v; bi = s; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s_best_v[warp] = bv; s_best_i[warp] = bi; }
    __syncthreads();
    // 2. the chosen slot's duration, demand and ready bin
    if (tid == 0) {
      bv = s_best_v[0];
      bi = s_best_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (beats(s_best_v[w], s_best_i[w], bv, bi)) {
          bv = s_best_v[w];
          bi = s_best_i[w];
        }
      s_j = bi;
      s_d = dur_r[bi];
      s_ready = max(rel_g[bi], ready_of[bi]);
      for (int m = 0; m < M; ++m) r[m] = dem_r[(size_t)bi * M + m];
    }
    __syncthreads();
    const int j = s_j, d = s_d, ready = s_ready;

    // 3-4a. overload flags and their inclusive prefix sum cs[t+1]
    int carry = 0;
    for (int base = 0; base < T; base += kThreads) {
      const int t = base + tid;
      int x = 0;
      if (t < T) {
        for (int m = 0; m < M; ++m) {
          const float rm = r[m];
          if (rm > 0.0f && __fadd_rn(usage[(size_t)t * M + m], rm) > caps_eps[m])
            x = 1;
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) s_warp[warp] = x;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp[w];
        before += (w < warp) ? c : 0;
        total += c;
      }
      if (t < T) cs[t + 1] = carry + before + x;
      carry += total;
      __syncthreads();
    }
    // 4b. earliest t >= ready with t + d <= T and no overloaded bin in [t, t+d)
    int first = INT_MAX;
    for (int t = tid; t < T; t += kThreads) {
      const int end = min(t + d, T);
      if (t < first && t >= ready && t + d <= T && cs[end] - cs[t] == 0)
        first = t;
    }
    first = __reduce_min_sync(kFull, first);
    if (lane == 0) s_warp[warp] = first;
    __syncthreads();
    // 5. the placement (or the fallback), written out by one thread
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) first = min(first, s_warp[w]);
      const bool any_ok = first != INT_MAX;
      const int tstar = any_ok ? first : max(ready, T - d);
      const size_t o = row * J + j;
      start[o] = tstar;
      finish[o] = tstar + d;
      ok[o] = any_ok ? 1 : 0;
      scheduled[j] = 1;
      s_tstar = tstar;
    }
    __syncthreads();
    // 6. demand into the usage window, clipped to the grid; release the
    //    successors and push this finish into their ready bins
    const int tstar = s_tstar;
    const int lo = max(tstar, 0);
    const int hi = min(tstar + d, T);
    for (int i = tid; i < (hi - lo) * M; i += kThreads) {
      const size_t u = (size_t)lo * M + i;
      usage[u] = __fadd_rn(usage[u], r[i % M]);
    }
    for (int s = tid; s < J; s += kThreads) {
      if (pred_g[(size_t)s * J + j]) {
        npred[s] -= 1;
        ready_of[s] = max(ready_of[s], tstar + d);
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int J, int M, int T) {
  return sizeof(float) * ((size_t)T * M + 2 * (size_t)M)
       + sizeof(int) * ((size_t)T + 1 + 2 * (size_t)J)
       + (size_t)J;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int sgs_decode_launch(const void* dur, const void* dem, const void* prio,
                      const void* release, const void* pred, const void* caps,
                      void* start, void* finish, void* ok,
                      int rows, int J, int M, int T, int rows_per_group,
                      void* stream) {
  if (rows <= 0 || J <= 0) return 0;
  const size_t smem = smem_bytes(J, M, T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgs_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgs_decode_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)dur, (const float*)dem, (const float*)prio,
      (const int32_t*)release, (const uint8_t*)pred, (const float*)caps,
      (int32_t*)start, (int32_t*)finish, (uint8_t*)ok,
      J, M, T, rows_per_group);
  return (int)cudaGetLastError();
}

const char* sgs_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
