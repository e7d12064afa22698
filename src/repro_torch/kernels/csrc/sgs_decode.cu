// Serial-SGS grid decode for Hopper (sm_90a): the AGORA solver's hot loop.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sgs_decode.py:_kernel
// (the pl.pallas_call in sgs_decode()). Contract: bit-for-bit the same
// start, finish and ok as repro_torch/kernels/ref.py:sgs_decode_ref, which
// is itself bit-for-bit the JAX reference repro/kernels/ref.py:sgs_decode_ref.
//
// What bounds it on this card: neither the bytes (a row reads J*(3+M)
// words and writes J*9 bytes) nor the operations (about J*(J + 3*T*M +
// 4*T) simple ones per row), but the latency of J serial steps: step k+1
// reads the usage that step k wrote. A row takes J times the latency of
// one step, a chain of dependent warp collectives (tens of cycles each),
// shared-memory loads and integer logic; the card's width only helps by
// running rows side by side.
//
// The design shortens that chain and the work every row repeats:
//   * One warp per chain row, W rows of one group per block. W is the
//     largest of 8, 4, 2, 1 that divides rows_per_group, at most 4 while
//     the rows are fewer than the card's schedulers (4 an SM: each row of
//     a latency-bound launch gets a scheduler of its own, and a block of
//     4 stages its group's precedence once for 4 rows), lowered while the
//     block's shared memory would not fit. Measured on an H100 at the
//     shared shape, W = 4 beat W = 1 (one block per row) and W = 8.
//     A step runs on warp collectives only: no __syncthreads and no
//     __syncwarp in the step loop.
//   * Lane l owns the slots s with s % 32 == l and the time bins t with
//     t % 32 == l: a slot's count, ready bin, start and flags, and a bin's
//     (M,) usage, are touched by their owner lane only. Eligibility is a
//     64-bit mask of the lane's slots in a register; the chosen slot's
//     pushed ready bin reaches the other lanes by one shuffle.
//   * Per-row state lives in the warp's slice of shared memory: the (M, T)
//     usage (bin-major per resource, so a warp's access is one bank each)
//     and the row's dur, dem and priority keys, staged once with coalesced
//     reads. The step loop reads no global memory; start, finish and ok
//     are buffered and written coalesced at the end.
//   * The group's precedence is read once per block, 16 bytes a thread,
//     and turned into a successor bitmask succ[p] (ceil(J/32) words: bit s
//     says p precedes s) and a predecessor count per slot, by shared-memory
//     atomics. Each byte is used once, so the 16-byte loads go straight
//     to registers (cp.async into a shared buffer measured no faster).
//   * Each slot's rank in (priority descending, index ascending) is
//     counted once per row, so the step's argmax is ONE redux.
// A step:
//   1. argmax over eligible scores, FIRST index on ties (as jnp.argmax /
//      torch.argmax): the least rkey = rank << 16 | slot over the eligible
//      slots, by __reduce_min_sync of each lane's least. Ranks order the
//      float priorities by their total-order bit patterns (-0 and +0 tie,
//      as they compare equal); the -1e9 masked sentinel stays eligible.
//      Where the best eligible score is -inf (or none is eligible), the
//      reference takes the first slot scored -inf, eligible or not, and so
//      does this kernel;
//   2. the chosen slot's d, demand and ready = max(release, pushed ready);
//   3-4. the earliest t >= max(ready, 0) with t + d <= T and no overloaded
//      bin (usage + r > caps + 1e-6 on a demanded resource) in [t, t + d):
//      a word of 32 bins at a time from the word of `ready` up, one ballot
//      of overload flags and one of clean windows per word, stopping at
//      the first word holding a clean window. Exact integer logic, the
//      same test as the reference's prefix-sum window count;
//   5. fallback t* = max(ready, T - d) with ok = false;
//   6. the demand into the usage window [t*, min(t* + d, T)) on each
//      lane's own bins, then the successors of the placed slot: lane q
//      loads word q of succ[j], the nonzero words go round by shuffle, and
//      each owner lane counts down, pushes t* + d into the ready bin and
//      updates its eligibility mask.
// The (T, T) mask-matmul of the TPU kernel (an MXU device) is not carried
// over: the window test is exact integer logic either way. Inputs that no
// path makes (a -inf priority, a cyclic pred) re-place a placed slot in
// the reference, which recomputes eligibility from the placed set; here a
// re-placed slot counts its successors down again, so such inputs lie
// outside the contract.
//
// ptxas (sm_90a, -O3 --fmad=false -Xptxas -v, CUDA 12.8): 64 registers
// (the cap of __launch_bounds__(256, 4)), no spills, no static shared
// memory; the dynamic shared memory of a block is block_bytes + W *
// warp_bytes below: 20,400 bytes at the isolated shape (W = 8) and 45,840
// at the shared shape (W = 4).
//
// Exactness traps (each one breaks bit-for-bit parity):
//   * caps + 1e-6 is float32 arithmetic in the reference. A bare 1e-6 is a
//     double in C++ and would move the threshold, so the sum is
//     __fadd_rn(caps, 1e-6f); every float add is an explicit __fadd_rn and
//     the build passes --fmad=false, so nothing is contracted.
//   * each bin's usage adds the placed demands in placement order, one
//     add per placement (the owner lane's), zero demands included.
//   * a zero-duration slot lands on the first t >= ready with t < T: the
//     candidates are the bins [0, T) only.
//   * a fallback placement past T adds nothing to usage but still sets
//     finish = t* + d.
//   * an all-masked padding row (every dur 0, every prio -1e9) places each
//     slot at its ready bin in index order, as the reference does.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kRegM = 4;                     // resources held in registers
constexpr uint32_t kNegInfKey = 0x007fffffu;  // order_key(-inf)
constexpr uint32_t kNone = 0xffffffffu;       // no eligible slot
constexpr int kMaxSlotWords = 64;             // slots a lane: bits of elig
constexpr int kBatch = 4;                     // 16-byte loads in flight

// float -> unsigned with the same order; -0 and +0 get one key
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// succ[J * NW] u32 | npred0[J] | rel[J] (i32) | caps_eps[M] (f32)
__host__ __device__ __forceinline__ size_t block_bytes(int J, int M) {
  const size_t NW = ((size_t)J + 31) / 32;
  return align16(4 * ((size_t)J * NW + 2 * (size_t)J + (size_t)M));
}

// pkey[J rounded up to 4] (u32, 16-byte aligned) | usage[M * T] |
// dem[J * M] (f32) | dur, rdy, start, npred[J] (i32) | rkey[J] (u32) |
// st[J] (u8: bit 0 ok, bit 1 placed)
__host__ __device__ __forceinline__ size_t warp_bytes(int J, int M, int T) {
  const size_t J4 = ((size_t)J + 3) & ~(size_t)3;
  return align16(4 * (J4 + (size_t)M * T + (size_t)J * M + 5 * (size_t)J)
                 + (size_t)J);
}

// pred[s][p] set: p precedes s
__device__ __forceinline__ void add_edge(unsigned e, int J, int NW,
                                         uint32_t* succ, int* npred0) {
  const int s = (int)(e / (unsigned)J);
  const int p = (int)(e - (unsigned)s * J);
  atomicOr(&succ[(size_t)p * NW + (s >> 5)], 1u << (s & 31));
  atomicAdd(&npred0[s], 1);
}

// the nonzero bytes of a 4-byte word of pred, starting at element e0
__device__ __forceinline__ void add_edges(uint32_t w, unsigned e0, int J,
                                          int NW, uint32_t* succ,
                                          int* npred0) {
  while (w) {
    const int b = (__ffs(w) - 1) >> 3;
    add_edge(e0 + b, J, NW, succ, npred0);
    w &= ~(0xffu << (8 * b));
  }
}

// 4 blocks of 8 rows on each SM: the isolated shape's 512 blocks in one wave
__global__ void __launch_bounds__(32 * kMaxWarps, 4)
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = (J + 31) >> 5;     // words of slots, = slots a lane
  const int NS = NW;
  const int K = (T + 31) >> 5;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = (size_t)blockIdx.x * (nthreads >> 5) + (tid >> 5);
  const size_t g = (size_t)blockIdx.x * (nthreads >> 5) / rows_per_group;

  uint32_t* succ = reinterpret_cast<uint32_t*>(smem);
  int* npred0 = reinterpret_cast<int*>(succ + (size_t)J * NW);
  int* rel = npred0 + J;
  float* caps_eps = reinterpret_cast<float*>(rel + J);
  unsigned char* mine = smem + block_bytes(J, M)
                      + (size_t)(tid >> 5) * warp_bytes(J, M, T);
  const int J4 = (J + 3) & ~3;
  uint32_t* pkey = reinterpret_cast<uint32_t*>(mine);
  float* usage = reinterpret_cast<float*>(pkey + J4);
  float* dem_s = usage + (size_t)M * T;
  int* dur_s = reinterpret_cast<int*>(dem_s + (size_t)J * M);
  int* rdy = dur_s + J;
  int* start_s = rdy + J;
  int* npred = start_s + J;
  uint32_t* rkey = reinterpret_cast<uint32_t*>(npred + J);
  uint8_t* st = reinterpret_cast<uint8_t*>(rkey + J);

  // --- staging: the group's arrays (block), the row's arrays (warp) -------
  for (int i = tid; i < J * NW; i += nthreads) succ[i] = 0u;
#pragma unroll 4
  for (int s = tid; s < J; s += nthreads) {
    npred0[s] = 0;
    rel[s] = release[g * J + s];
  }
  for (int m = tid; m < M; m += nthreads)
    caps_eps[m] = __fadd_rn(caps[m], 1e-6f);
  {
    const int32_t* dur_r = dur + row * J;
    const float* dem_r = dem + row * J * M;
    const float* prio_r = prio + row * J;
#pragma unroll 4
    for (int i = lane; i < J * M; i += 32) dem_s[i] = dem_r[i];
#pragma unroll 4
    for (int s = lane; s < J; s += 32) {
      dur_s[s] = dur_r[s];
      pkey[s] = order_key(prio_r[s]);
      rdy[s] = 0;
      start_s[s] = 0;
      st[s] = 0;
    }
    if (lane < J4 - J) pkey[J + lane] = 0u;   // below every key
    for (int i = lane; i < M * T; i += 32) usage[i] = 0.0f;
  }
  __syncthreads();
  {  // pred (J, J) of group g, once per block: 16-byte loads, batched
    const uint8_t* pg = pred + g * J * J;
    const unsigned n = (unsigned)J * J;
    unsigned head = (16 - ((uintptr_t)pg & 15)) & 15;
    if (head > n) head = n;
    for (unsigned e = tid; e < head; e += nthreads)
      if (pg[e]) add_edge(e, J, NW, succ, npred0);
    const unsigned n16 = (n - head) >> 4;
    const uint4* p4 = reinterpret_cast<const uint4*>(pg + head);
    for (unsigned base = 0; base < n16; base += kBatch * nthreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned i = base + u * nthreads + tid;
        v[u] = i < n16 ? __ldg(p4 + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned e0 = head + 16 * (base + u * nthreads + tid);
        add_edges(v[u].x, e0, J, NW, succ, npred0);
        add_edges(v[u].y, e0 + 4, J, NW, succ, npred0);
        add_edges(v[u].z, e0 + 8, J, NW, succ, npred0);
        add_edges(v[u].w, e0 + 12, J, NW, succ, npred0);
      }
    }
    for (unsigned e = head + 16 * n16 + tid; e < n; e += nthreads)
      if (pg[e]) add_edge(e, J, NW, succ, npred0);
  }
  __syncthreads();
  // each slot's rank in the order (priority descending, index ascending):
  // the argmax over eligible slots is the least rank among them, and one
  // redux of rkey = rank << 16 | slot finds it
  int fin = 0;               // slots whose priority is above -inf
  uint64_t elig = 0;         // bit k: slot lane + 32k is eligible
  uint32_t best = kNone;     // least rkey of this lane's eligible slots
  for (int k = 0, s = lane; k < NS; ++k, s += 32) {
    // rank = #{q < s: key_q >= key_s} + #{q > s: key_q > key_s}, over
    // warp-uniform bounds: the words of slots below this lane's word, its
    // own word, the words above; four keys a load from the padded pkey
    const uint32_t ks = s < J ? pkey[s] : kNone;
    const uint4* pk4 = reinterpret_cast<const uint4*>(pkey);
    int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll 4
    for (int c = 0; c < 8 * k; ++c) {
      const uint4 v = pk4[c];
      r0 += v.x >= ks; r1 += v.y >= ks; r2 += v.z >= ks; r3 += v.w >= ks;
    }
    for (int q = 32 * k; q < min(32 * k + 32, J); ++q)
      r0 += pkey[q] > ks - (q < s ? 1u : 0u);
#pragma unroll 4
    for (int c = 8 * k + 8; c < J4 / 4; ++c) {
      const uint4 v = pk4[c];
      r0 += v.x > ks; r1 += v.y > ks; r2 += v.z > ks; r3 += v.w > ks;
    }
    if (s < J) {
      const int rank = r0 + r1 + r2 + r3;
      fin += ks > kNegInfKey;
      const uint32_t rk = ((uint32_t)rank << 16) | (uint32_t)s;
      rkey[s] = rk;
      const int n0 = npred0[s];
      npred[s] = n0;
      if (n0 == 0) {
        elig |= 1ull << k;
        best = min(best, rk);
      }
    }
  }
  const int n_fin = __reduce_add_sync(kFull, fin);
  float ce[kRegM];          // caps + 1e-6 of the resources in registers
#pragma unroll
  for (int m = 0; m < kRegM; ++m) ce[m] = m < M ? caps_eps[m] : 0.0f;
  __syncwarp();

  // --- the J placement steps of this warp's row: no block barrier ---------
  for (int step = 0; step < J; ++step) {
    // 1. argmax over eligible scores, first index on ties: the least rkey
    const uint32_t top = __reduce_min_sync(kFull, best);
    int j = (int)(top & 0xffffu);
    if (top == kNone || (int)(top >> 16) >= n_fin) {
      // the best score is -inf: the reference's argmax then takes the
      // first slot scored -inf, eligible or not
      int lowest = INT_MAX;
      for (int k = 0, s = lane; k < NS && lowest == INT_MAX; ++k, s += 32)
        if (s < J && (!((elig >> k) & 1ull) || (int)(rkey[s] >> 16) >= n_fin))
          lowest = s;
      j = __reduce_min_sync(kFull, lowest);
    }
    const int owner = j & 31;

    // 2. the chosen slot's duration, demand and ready bin (its pushed
    //    ready bin is the owner lane's: one shuffle, no barrier)
    const int d = dur_s[j];
    const int ready = max(rel[j], __shfl_sync(kFull, rdy[j], owner));
    float r[kRegM];
#pragma unroll
    for (int m = 0; m < kRegM; ++m)
      r[m] = m < M ? dem_s[(size_t)j * M + m] : 0.0f;

    // 3-4. the earliest t >= t0 = max(ready, 0) whose window [t, t + d)
    //      lies in the grid and holds no overloaded bin. A zero-duration
    //      slot needs no window. Otherwise scan the grid a word of 32 bins
    //      at a time from t0 up: lane l tests the window that ENDS at bin
    //      e = 32k + l, clean when the last overloaded bin at or below e
    //      (this word's flags below l, else the carry from the words
    //      scanned) lies before its start e - d + 1. Bins below t0 never
    //      matter; the first word holding a clean window ends the scan.
    const int t0 = max(ready, 0);
    int first = INT_MAX;
    if (d == 0) {
      if (t0 < T) first = t0;
    } else if (t0 + d <= T) {
      int last_flag = -1;      // last overloaded bin in [t0, 32k)
      for (int k = t0 >> 5; k < K; ++k) {
        const int e = (k << 5) + lane;
        bool flag = false;
        if (e >= t0 && e < T) {
#pragma unroll
          for (int m = 0; m < kRegM; ++m)
            if (r[m] > 0.0f
                && __fadd_rn(usage[(size_t)m * T + e], r[m]) > ce[m])
              flag = true;
          for (int m = kRegM; m < M; ++m) {
            const float rm = dem_s[(size_t)j * M + m];
            if (rm > 0.0f
                && __fadd_rn(usage[(size_t)m * T + e], rm) > caps_eps[m])
              flag = true;
          }
        }
        const uint32_t word = __ballot_sync(kFull, flag);
        const uint32_t upto = word & (kFull >> (31 - lane));   // bits <= l
        const int last = upto ? (k << 5) + 31 - __clz(upto) : last_flag;
        const int t = e - d + 1;
        const uint32_t clean =
            __ballot_sync(kFull, t >= t0 && e < T && last < t);
        if (clean) {
          first = (k << 5) + __ffs(clean) - 1 - d + 1;
          break;
        }
        if (word) last_flag = (k << 5) + 31 - __clz(word);
      }
    }

    // 5. the placement, or the fallback
    const bool any_ok = first != INT_MAX;
    const int tstar = any_ok ? first : max(ready, T - d);
    const int fin = tstar + d;

    // 6. demand into the usage window, clipped to the grid (own bins)
    const int lo = max(tstar, 0);
    const int hi = min(fin, T);
    for (int k = lo >> 5; (k << 5) < hi; ++k) {
      const int t = (k << 5) + lane;
      if (t >= lo && t < hi) {
#pragma unroll
        for (int m = 0; m < kRegM; ++m)
          if (m < M) {
            float* u = usage + (size_t)m * T + t;
            *u = __fadd_rn(*u, r[m]);
          }
        for (int m = kRegM; m < M; ++m) {
          float* u = usage + (size_t)m * T + t;
          *u = __fadd_rn(*u, dem_s[(size_t)j * M + m]);
        }
      }
    }
    bool rescan = false;     // this lane's best slot left the eligible set
    if (lane == owner) {
      start_s[j] = tstar;
      st[j] = any_ok ? 3 : 2;
      elig &= ~(1ull << (j >> 5));
      rescan = true;
    }
    // release the successors and push this finish into their ready bins:
    // lane q loads word q of succ[j]; the nonzero words go round by shuffle
    const uint32_t* sj = succ + (size_t)j * NW;
    for (int w0 = 0; w0 < NW; w0 += 32) {
      const uint32_t mine_w = w0 + lane < NW ? sj[w0 + lane] : 0u;
      uint32_t nz = __ballot_sync(kFull, mine_w != 0u);
      while (nz) {
        const int q = __ffs(nz) - 1;
        nz &= nz - 1;
        const uint32_t bits = __shfl_sync(kFull, mine_w, q);
        if ((bits >> lane) & 1u) {
          const int k = w0 + q;
          const int s = (k << 5) + lane;
          const int c = npred[s] - 1;
          npred[s] = c;
          rdy[s] = max(rdy[s], fin);
          const bool now = c == 0 && !(st[s] & 2);
          if (now != (bool)((elig >> k) & 1ull)) {
            elig ^= 1ull << k;
            if (now) best = min(best, rkey[s]);
            else rescan = true;
          }
        }
      }
    }
    if (rescan) {            // the owner lane, in all but cyclic inputs
      best = kNone;
      for (uint64_t e = elig; e; e &= e - 1)
        best = min(best, rkey[(__ffsll((long long)e) - 1) * 32 + lane]);
    }
  }

  // --- write the row out, coalesced ----------------------------------------
  for (int s = lane; s < J; s += 32) {
    const size_t o = row * J + s;
    const int f = st[s];
    start[o] = start_s[s];
    finish[o] = (f & 2) ? start_s[s] + dur_s[s] : 0;
    ok[o] = (uint8_t)(f & 1);
  }
}

}  // namespace

extern "C" {

// Rows per block (*warps) and dynamic shared memory per block (*smem) for
// a launch of this shape on the current device, and the card's limit per
// block (*limit). Returns 0, -1 when one row's state and its group's
// precedence do not fit one block (*warps = 1, *smem what it would need),
// or a CUDA error code.
int sgs_decode_geometry(int rows, int J, int M, int T, int rows_per_group,
                        int* warps, long long* smem, long long* limit) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = block_bytes(J, M), per = warp_bytes(J, M, T);
  int W = kMaxWarps;
  while (W > 1 && rows_per_group % W) W >>= 1;
  if (rows < 4 * sms && W > 4) W = 4;     // a scheduler for every row
  while (W > 1 && fixed + W * per > (size_t)optin) W >>= 1;
  *warps = W;
  *smem = (long long)(fixed + W * per);
  *limit = optin;
  // a lane's eligible slots are one 64-bit mask: J <= 2048, a bound the
  // successor mask's J * ceil(J/32) words reach first
  return *smem > optin || (J + 31) / 32 > kMaxSlotWords ? -1 : 0;
}

// Launch on `stream`; returns -1 for a shape beyond one block's shared
// memory (nothing launched), else cudaGetLastError() after the launch.
int sgs_decode_launch(const void* dur, const void* dem, const void* prio,
                      const void* release, const void* pred, const void* caps,
                      void* start, void* finish, void* ok,
                      int rows, int J, int M, int T, int rows_per_group,
                      void* stream) {
  if (rows <= 0 || J <= 0) return 0;
  int W = 1;
  long long smem = 0, limit = 0;
  const int rc = sgs_decode_geometry(rows, J, M, T, rows_per_group, &W,
                                     &smem, &limit);
  if (rc != 0) return rc;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgs_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgs_decode_kernel<<<rows / W, 32 * W, (size_t)smem,
                      (cudaStream_t)stream>>>(
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
