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
// Work: W warps per candidate b, R candidates per block; the launch takes
// R, W and C from repro_torch/kernels/sched_violation.py:geometry. The
// (M, T) grid, cell c = m * T + t, padded with zeros to N = 32 * W * C
// cells (a power of two, 128 <= N <= kMaxCells), lives in registers: lane
// l of warp w holds the cells c = 32 w + l + 32 W i, i < C. Tasks come 32
// at a time: lane l loads task j0 + l's start, end = start + dur and M
// demands, through the strides the caller passes (the ising loop passes
// dem as a transposed view), and __shfl_sync hands the tasks to the warp
// one by one in index order. Each lane adds the task's demand to each of
// its cells that the task covers. The task loop's only cross-lane values
// are those broadcasts: it has no __syncthreads and no __syncwarp.
//
// The sum is ref.py:pairwise_sum's, in its order: level h adds cell c + h
// into cell c, h = N/2, ..., 1. Under the ownership above the levels
// h >= 32 W pair two registers of one lane; the log2 W levels 16 W ... 32
// pair warp w with warp w + h / 32, which takes one block barrier (every
// warp leaves its 32 partial sums in shared memory, warp 0 of the candidate
// finishes those levels down its own column); h = 16 ... 1 are
// __shfl_down_sync by h. Padding past the power of two above M * T is
// exact: its levels add +0 to cells that are never negative. No atomics,
// so a result is the same from run to run.
//
// What bounds it on this card: at the annealer's shapes (B = 512, M = 2,
// T = 256, J = 7 to 166) the bytes, B * J * (2 + M) words, are a fraction
// of a microsecond; the work is B * N * J interval tests and conditional
// adds. Where T = 32 W K (the annealer's T 256) the bins of a lane repeat
// for every resource, so a bin's two compares serve M cells: about two
// instructions a (cell, task), half of them compares, which the card runs
// at half the rate of adds, plus 2 + M shuffles a task for each warp. At
// J 166 that is what the launch spends its time on; at J 10 it is a
// launch's latency. The loop spends nothing else: no shared memory, no
// barrier, no branch on the data. The TPU kernel's (J, Tt) mask-matmul on
// the MXU is not carried over: in TF32 the tensor cores would lose too
// many bits for the contract, and the mask product is exact as an add.
//
// The wide path (sched_violation_wide_kernel): any M and any T, for the
// grids past the register layout's envelope (M > 8, or more than 4096
// cells). pairwise_sum over the padded N = 4096 S cells reduces the top bits
// of the cell index first, so its subtrees are residue classes of the cell
// index modulo S, not contiguous tiles: one block takes one candidate and
// runs S passes; pass r holds the 4096 cells c = r + S c' (c' laid out over
// the lanes as above, W = 8, C = 16) and reduces them in the halving order,
// which sums the class r. The S partial sums are merged in pairwise_sum's
// order by a binary counter: the passes run in bit-reversed order of r, so
// each merge adds two classes that differ in the top bit still unreduced.
// A cell's resource m = c / T varies per register, so in place of the
// shuffled demands the block stages each 32 tasks' demands in shared
// memory (M <= 384), or a covered cell reads its own through L1.
//
// Exactness traps:
//   * the mask test is t >= s && t < s + d with s + d rounded in float32,
//     as in the reference; t - s < d would move the boundary;
//   * a cell adds only the demands of tasks that cover it: for finite
//     demands that equals the plain version's product with the 0/1 mask,
//     because adding +0 or -0 to a sum that began at +0 changes nothing;
//   * the build passes --fmad=false and every add is an explicit __fadd_rn
//     or __fsub_rn, so nothing is contracted;
//   * cells t >= T do not exist here (the TPU kernel masks its padding).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCells = 4096;  // the envelope: N <= 4096 (M 8 x T 300)
constexpr int kMaxM = 8;
constexpr unsigned kFull = 0xffffffffu;

// threads a block may have: no instantiation takes more than 128 registers
// a thread (ptxas -v), and 512 of them fit one SM's 64 K. No launch bound
// is set: ptxas then spills none of them.
constexpr int kMaxThreads = 512;

__host__ __device__ constexpr int min_int(int a, int b) {
  return a < b ? a : b;
}

// value `sel` of the MM values of one lane
template <int MM>
__device__ __forceinline__ float pick(const float (&d)[MM], int sel) {
  float v = d[0];
#pragma unroll
  for (int m = 1; m < MM; ++m) v = sel == m ? d[m] : v;
  return v;
}

// the register levels of the halving sum: v[i] += v[i + H], H = C/2 ... 1
template <int H, int C>
__device__ __forceinline__ void halve(float (&v)[C]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) v[i] = __fadd_rn(v[i], v[i + H]);
    halve<H / 2>(v);
  }
}

struct Rows {  // one candidate's task arrays, read through their strides
  const float* start;
  const float* dur;
  const float* dem;
  long long s_j, u_j, d_m, d_j;
};

// task j's start, end = start + dur and demands; zeros for j >= J
template <int MM>
__device__ __forceinline__ void load_task(const Rows& row, int j, int J,
                                          int M, float& s, float& e,
                                          float (&d)[MM]) {
  s = 0.0f;
  e = 0.0f;
#pragma unroll
  for (int m = 0; m < MM; ++m) d[m] = 0.0f;
  if (j < J) {
    s = row.start[j * row.s_j];
    e = __fadd_rn(s, row.dur[j * row.u_j]);
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (m < M) d[m] = row.dem[m * row.d_m + j * row.d_j];
  }
}

// Two layouts of the same ownership, chosen by the caller (geometry). K >
// 0, a power of two: T = 32 W K, so register i = m K + k of every lane
// holds resource m and bin t = 32 w + l + 32 W k; the interval test of bin
// k is done once for the MM = C / K resources (at most 8) that share it,
// and the demand needs no pick. K = 0: any T; each register has its own
// bin and resource, and the demand is picked per cell among MM = 8.
template <int C, int K, int MM>
__global__ void sched_violation_kernel(const float* __restrict__ start,  // (B, J) strided
                       const float* __restrict__ dur,    // (B, J) strided
                       const float* __restrict__ dem,    // (B, M, J) strided
                       const float* __restrict__ caps,   // (M,)
                       float* __restrict__ out,          // (B,)
                       int B, int J, int M, int T, int W, long long s_b,
                       long long s_j, long long u_b, long long u_j,
                       long long d_b, long long d_m, long long d_j) {
  constexpr int kBins = K > 0 ? K : C;  // bins a lane tests per task
  __shared__ float part[kMaxThreads];  // per warp, its 32 partial sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = warp / W;              // candidate of the block
  const int w = warp - r * W;          // warp of the candidate
  const int b = blockIdx.x * (blockDim.x / (32 * W)) + r;
  const int tasks = b < B ? J : 0;     // a block's spare candidates idle
  const int c0 = 32 * w + lane;        // the lane's first cell
  const int step = 32 * W;             // cells between its registers

  float t[kBins], u[C], cp[MM];
  int sel[K > 0 ? 1 : C];               // K = 0: each register's resource
  bool real[C];                        // a cell of the grid, not padding
#pragma unroll
  for (int m = 0; m < MM; ++m) cp[m] = m < M ? caps[m] : 0.0f;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = (float)(c0 + step * k);
#pragma unroll
    for (int i = 0; i < C; ++i) real[i] = i / K < M;
  } else {
    int m = c0 / T, tt = c0 - m * T;   // then step by step, no division
    const int dm = step / T, dt = step - dm * T;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      real[i] = m < M;
      t[i] = (float)tt;                // exact: t < 2^24
      sel[i] = m;
      m += dm;
      tt += dt;
      if (tt >= T) {
        tt -= T;
        ++m;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) u[i] = 0.0f;

  const size_t bb = b < B ? (size_t)b : 0;
  const Rows row{start + bb * s_b, dur + bb * u_b, dem + bb * d_b,
                 s_j, u_j, d_m, d_j};
  float cs, ce, cd[MM];
  load_task<MM>(row, lane, tasks, M, cs, ce, cd);
  for (int j0 = 0; j0 < tasks; j0 += 32) {
    float ns, ne, nd[MM];              // the next 32 tasks, in flight
    load_task<MM>(row, j0 + 32 + lane, tasks, M, ns, ne, nd);
    const int nj = min(32, tasks - j0);
#pragma unroll 4
    for (int k = 0; k < nj; ++k) {
      const float s = __shfl_sync(kFull, cs, k);
      const float e = __shfl_sync(kFull, ce, k);
      float d[MM];
#pragma unroll
      for (int m = 0; m < MM; ++m) d[m] = __shfl_sync(kFull, cd[m], k);
#pragma unroll
      for (int q = 0; q < kBins; ++q) {
        if (t[q] >= s && t[q] < e) {
          if constexpr (K > 0) {
#pragma unroll
            for (int m = 0; m < MM; ++m)
              u[m * K + q] = __fadd_rn(u[m * K + q], d[m]);
          } else {
            u[q] = __fadd_rn(u[q], pick<MM>(d, sel[q]));
          }
        }
      }
    }
    cs = ns;
    ce = ne;
#pragma unroll
    for (int m = 0; m < MM; ++m) cd[m] = nd[m];
  }

  // the excess of each cell, +0 in the padding; then the halving sum
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float cap;
    if constexpr (K > 0)
      cap = cp[min_int(i / K, MM - 1)];
    else
      cap = pick<MM>(cp, sel[i]);
    u[i] = real[i] ? fmaxf(__fsub_rn(u[i], cap), 0.0f) : 0.0f;
  }
  halve<C / 2>(u);
  float x = u[0];
  if (W > 1) {                         // the same for the whole block
    part[warp * 32 + lane] = x;
    __syncthreads();
    if (w == 0) {
      float* col = part + warp * 32 + lane;  // this lane's column, W warps
      for (int hw = W / 2; hw > 0; hw /= 2)
        for (int k = 0; k < hw; ++k)
          col[32 * k] = __fadd_rn(col[32 * k], col[32 * (k + hw)]);
      x = col[0];
    }
  }
  if (w == 0) {
#pragma unroll
    for (int lvl = 4; lvl >= 0; --lvl)
      x = __fadd_rn(x, __shfl_down_sync(kFull, x, 1 << lvl));
    if (lane == 0 && b < B) out[b] = x;
  }
}

template <int C, int K, int MM>
int launch(const void* start, const void* dur, const void* dem,
           const void* caps, void* out, int B, int J, int M, int T,
           const long long* st, int R, int W, cudaStream_t stream) {
  const int blocks = (B + R - 1) / R;
  sched_violation_kernel<C, K, MM><<<blocks, R * W * 32, 0, stream>>>(
      (const float*)start, (const float*)dur, (const float*)dem,
      (const float*)caps, (float*)out, B, J, M, T, W, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6]);
  return (int)cudaGetLastError();
}

// the kernel for C cells a lane: the bin-major layout for K > 0 (K a
// power of two, at most C), else the general one, which picks among up to
// 8 resources
template <int C>
int launch_c(const void* start, const void* dur, const void* dem,
             const void* caps, void* out, int B, int J, int M, int T, int K,
             const long long* st, int R, int W, cudaStream_t stream) {
#define SV_LAUNCH(K, MM)                                                    \
  return launch<C, K, MM>(start, dur, dem, caps, out, B, J, M, T, st, R, W, \
                          stream)
  if (K == 1) SV_LAUNCH(1, min_int(C, kMaxM));
  if (K == 2) SV_LAUNCH(2, min_int(C / 2, kMaxM));
  if (K == 4) SV_LAUNCH(4, C / 4);
  if constexpr (C >= 8) {
    if (K == 8) SV_LAUNCH(8, C / 8);
  }
  if constexpr (C >= 16) {
    if (K == 16) SV_LAUNCH(16, 1);
  }
  SV_LAUNCH(0, kMaxM);
#undef SV_LAUNCH
}

constexpr int kWideW = 8;                       // warps: one candidate
constexpr int kWideC = 16;                      // cells a lane, a pass
constexpr int kPass = 32 * kWideW * kWideC;     // 4096 cells a pass
constexpr int kStageM = 384;  // demands staged while M x 32 fit 48 KB

// task j's start and end = start + dur; zeros for j >= J
__device__ __forceinline__ void load_span(const Rows& row, int j, int J,
                                          float& s, float& e) {
  s = 0.0f;
  e = 0.0f;
  if (j < J) {
    s = row.start[j * row.s_j];
    e = __fadd_rn(s, row.dur[j * row.u_j]);
  }
}

// One candidate a block, S passes of 4096 cells (see the header): cells
// c = r + S (32 w + l + 256 i), i < 16, of the (M, T) grid padded to
// 4096 S cells; the passes' sums merged in pairwise_sum's order. kStaged:
// the block stages the demands of each 32 tasks in shared memory (M x 32
// floats, M <= kStageM), so a covered cell's add waits on shared memory,
// not on L2; else each covered cell reads its demand through L1.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kWideW)
sched_violation_wide_kernel(const float* __restrict__ start,  // (B, J) strided
                            const float* __restrict__ dur,    // (B, J) strided
                            const float* __restrict__ dem,    // (B, M, J) strided
                            const float* __restrict__ caps,   // (M,)
                            float* __restrict__ out,          // (B,)
                            int J, int M, int T, long long S, int log2S,
                            long long s_b, long long s_j, long long u_b,
                            long long u_j, long long d_b, long long d_m,
                            long long d_j) {
  extern __shared__ float tile[];      // kStaged: [m * 32 + k], M x 32
  __shared__ float part[32 * kWideW];  // per warp, its 32 partial sums
  __shared__ float stack[64];          // the merge's pending sums, by level
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const long long cells = (long long)M * T;
  const float* dem_b = dem + b * d_b;
  const Rows row{start + b * s_b, dur + b * u_b, dem_b, s_j, u_j, d_m, d_j};

  for (long long q = 0; q < S; ++q) {
    const long long r =
        log2S ? (long long)(__brevll((unsigned long long)q) >> (64 - log2S))
              : 0;
    float t[kWideC], u[kWideC];
    int m[kWideC];
    bool real[kWideC];
#pragma unroll
    for (int i = 0; i < kWideC; ++i) {
      const long long c = r + S * (32 * w + lane + 32LL * kWideW * i);
      real[i] = c < cells;
      m[i] = real[i] ? (int)(c / T) : 0;
      t[i] = (float)(c - (long long)m[i] * T);  // exact: t < 2^24
      u[i] = 0.0f;
    }
    float cs, ce;
    load_span(row, lane, J, cs, ce);
    for (int j0 = 0; j0 < J; j0 += 32) {
      float ns, ne;                    // the next 32 tasks, in flight
      load_span(row, j0 + 32 + lane, J, ns, ne);
      const int nj = min(32, J - j0);
      if constexpr (kStaged) {
        __syncthreads();               // the last 32 tasks' tile is read
        for (int x = threadIdx.x; x < 32 * M; x += 32 * kWideW) {
          const int k = x & 31;
          tile[x] = k < nj ? __ldg(dem_b + (long long)(x >> 5) * d_m
                                   + (long long)(j0 + k) * d_j)
                           : 0.0f;
        }
        __syncthreads();
      }
      for (int k = 0; k < nj; ++k) {
        const float s = __shfl_sync(kFull, cs, k);
        const float e = __shfl_sync(kFull, ce, k);
        const float* dj = dem_b + (long long)(j0 + k) * d_j;
#pragma unroll
        for (int i = 0; i < kWideC; ++i)
          if (real[i] && t[i] >= s && t[i] < e)
            u[i] = __fadd_rn(u[i], kStaged ? tile[m[i] * 32 + k]
                                           : __ldg(dj + m[i] * d_m));
      }
      cs = ns;
      ce = ne;
    }
#pragma unroll
    for (int i = 0; i < kWideC; ++i)
      u[i] = real[i] ? fmaxf(__fsub_rn(u[i], __ldg(caps + m[i])), 0.0f)
                     : 0.0f;
    halve<kWideC / 2>(u);
    part[w * 32 + lane] = u[0];
    __syncthreads();
    if (w == 0) {
      float* col = part + lane;        // this lane's column, 8 warps
      for (int hw = kWideW / 2; hw > 0; hw /= 2)
        for (int k = 0; k < hw; ++k)
          col[32 * k] = __fadd_rn(col[32 * k], col[32 * (k + hw)]);
      float x = col[0];
#pragma unroll
      for (int lvl = 4; lvl >= 0; --lvl)
        x = __fadd_rn(x, __shfl_down_sync(kFull, x, 1 << lvl));
      if (lane == 0) {                 // merge the class sum: level by level
        int lvl = 0;
        for (; (q >> lvl) & 1; ++lvl) x = __fadd_rn(stack[lvl], x);
        stack[lvl] = x;
      }
    }
    __syncthreads();                   // part is rewritten by the next pass
  }
  if (threadIdx.x == 0) out[b] = stack[log2S];
}

}  // namespace

extern "C" {

// Launch on `stream` with R candidates a block, W warps a candidate, C
// cells a lane and layout K (0: general; else bin-major, T = 32 W K); the
// strides are in elements: start (s_b, s_j), dur (u_b, u_j), dem (d_b,
// d_m, d_j). Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a geometry that does not cover the (M, T) grid
// or lies outside the envelope (M <= 8, 32 W C <= 4096).
int sched_violation_launch(const void* start, const void* dur,
                           const void* dem, const void* caps, void* out,
                           int B, int J, int M, int T, long long s_b,
                           long long s_j, long long u_b, long long u_j,
                           long long d_b, long long d_m, long long d_j,
                           int R, int W, int C, int K, void* stream) {
  if (B <= 0) return 0;
  const long long n = 32LL * W * C;
  const bool bin_major = K > 0 && K <= C && !(K & (K - 1))
                         && T == 32 * W * K && M * K <= C;
  if (M < 1 || M > kMaxM || T < 1 || J < 0 || R < 1 || W < 1
      || (W & (W - 1)) || R * W * 32 > kMaxThreads || n > kMaxCells
      || (long long)M * T > n || (K != 0 && !bin_major))
    return (int)cudaErrorInvalidValue;
  const long long st[7] = {s_b, s_j, u_b, u_j, d_b, d_m, d_j};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 4: return launch_c<4>(start, dur, dem, caps, out, B, J, M, T, K,
                               st, R, W, s);
    case 8: return launch_c<8>(start, dur, dem, caps, out, B, J, M, T, K,
                               st, R, W, s);
    case 16: return launch_c<16>(start, dur, dem, caps, out, B, J, M, T, K,
                                 st, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide path: any M >= 1 and T >= 1; the (M, T) grid padded to 4096 S
// cells, S a power of two with 4096 S >= M T. One block of 256 threads a
// candidate. Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for an S that does not cover the grid.
int sched_violation_wide_launch(const void* start, const void* dur,
                                const void* dem, const void* caps, void* out,
                                int B, int J, int M, int T, long long s_b,
                                long long s_j, long long u_b, long long u_j,
                                long long d_b, long long d_m, long long d_j,
                                long long S, void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || T < 1 || J < 0 || S < 1 || (S & (S - 1))
      || S > (1LL << 40) || (long long)kPass * S < (long long)M * T)
    return (int)cudaErrorInvalidValue;
  const int log2S = 63 - __builtin_clzll((unsigned long long)S);
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= kStageM)
    sched_violation_wide_kernel<true>
        <<<B, 32 * kWideW, (size_t)M * 32 * sizeof(float), st>>>(
            (const float*)start, (const float*)dur, (const float*)dem,
            (const float*)caps, (float*)out, J, M, T, S, log2S, s_b, s_j,
            u_b, u_j, d_b, d_m, d_j);
  else
    sched_violation_wide_kernel<false><<<B, 32 * kWideW, 0, st>>>(
        (const float*)start, (const float*)dur, (const float*)dem,
        (const float*)caps, (float*)out, J, M, T, S, log2S, s_b, s_j, u_b,
        u_j, d_b, d_m, d_j);
  return (int)cudaGetLastError();
}

const char* sched_violation_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
