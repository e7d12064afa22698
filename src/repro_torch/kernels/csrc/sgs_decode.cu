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
// The wide routes. Past the shared memory of a block on that design (the
// group's successor bitmask is J * ceil(J/32) words: J past about 1190 at M
// 2, T 256), sgs_decode_geometry picks one of two routes; both start with a
// prep kernel that turns each group's (J, J) precedence into that bitmask,
// succ[g][p] (bit s: p precedes s), and a predecessor count per slot, once
// per launch, in global scratch that the wrapper allocates (L2-resident:
// 401 KB a group at J 1792).
//   * wide (J <= 2048, the fast route's 64-bit lane mask):
//     sgs_decode_wide_kernel, one warp a row, up to kWideRows rows of a
//     group a block (each row on a scheduler of its own, as many as 227 KB
//     of shared memory holds), no block barrier in the step loop. Its step
//     is the fast route's reshaped for a long row (the kernel's comment
//     says how): eligibility a bitset over ranks that any lane updates, the
//     successors released by the lanes that hold their words, the
//     successor row fetched during the window search, the search's loads
//     overlapped, ranks from a sort. It is a kernel of its own: the two
//     routes compiled from one templated step loop cost the fast route 2.7%
//     at the isolated shape, where 8 warps share a scheduler and the
//     instruction stream is the bound (PERF.md).
//   * wide-block (J > 2048, or a row's state past a block's shared memory):
//     sgs_decode_wide_block_kernel, one block of kWideThreads threads a
//     row, the row's state in shared memory where it fits, else in the
//     scratch. Thread i owns the slot words w with w % kWideThreads == i;
//     the argmax is a block min over unique ranks, warp 0 runs the window
//     search while the other warps wait at the block's barrier: two
//     barriers a step.
// The host reads the card's facts (SMs, shared memory, the block kernel's
// attributes, its memory) and opts a kernel into its shared memory once per
// device, not per launch.
//
// ptxas (sm_90a, -O3 --fmad=false -Xptxas -v, CUDA 12.8): the fast route
// 64 registers (the cap of __launch_bounds__(256, 4)), no spills, no static
// shared memory; the dynamic shared memory of a block is block_bytes + W *
// warp_bytes below: 20,400 bytes at the isolated shape (W = 8) and 45,840
// at the shared shape (W = 4). The wide-block kernel: 88 registers (under
// the cap of __launch_bounds__(128, 4)), no spills, 48 bytes of static
// shared memory. PERF.md has the wide kernel's registers and the times.
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

#include <atomic>
#include <chrono>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kRegM = 4;                     // resources held in registers
constexpr uint32_t kNegInfKey = 0x007fffffu;  // order_key(-inf)
constexpr uint32_t kNone = 0xffffffffu;       // no eligible slot
constexpr int kMaxSlotWords = 64;             // slots a lane: bits of elig
constexpr int kBatch = 4;                     // 16-byte loads in flight
constexpr int kWideRows = 4;                  // rows a block, wide route
constexpr int kScanWords = 4;                 // words a search round, wide

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

// --- the wide routes: the successor bitmask in global scratch ------------

constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;

// One row's state on the wide path, as byte offsets from its base:
// rank, sor (rank -> slot), dur, rdy, start, npred, rel, pkey [J] (4 bytes
// each) | elig [NW] (u32) | dem [J * M] | usage [M * T] | caps_eps [M]
// (f32) | st [J] (u8: bit 0 ok, bit 1 placed)
struct WideState {
  size_t rank, sor, dur, rdy, start, npred, rel, pkey, elig, dem, usage,
      caps, st, bytes;
  __host__ __device__ WideState(int J, int M, int T) {
    const size_t nj = (size_t)J, nw = ((size_t)J + 31) / 32;
    rank = 0;
    sor = rank + 4 * nj;
    dur = sor + 4 * nj;
    rdy = dur + 4 * nj;
    start = rdy + 4 * nj;
    npred = start + 4 * nj;
    rel = npred + 4 * nj;
    pkey = rel + 4 * nj;
    elig = pkey + 4 * nj;
    dem = elig + 4 * nw;
    usage = dem + 4 * nj * (size_t)M;
    caps = usage + 4 * (size_t)M * T;
    st = caps + 4 * (size_t)M;
    bytes = align16(st + nj);
  }
};

// every group's successor bitmask and predecessor counts, zeroed before
// the prep: succ [G][J][NW] (u32) | npred0 [G][J] (i32)
__host__ __device__ __forceinline__ size_t wide_succ_words(int G, int J) {
  return (size_t)G * J * (((size_t)J + 31) / 32);
}

__host__ __device__ __forceinline__ size_t wide_prep_bytes(int G, int J) {
  return align16(4 * (wide_succ_words(G, J) + (size_t)G * J));
}

// one block per (group g, slot s): the predecessors p of s (row s of
// pred[g]) set bit s of succ[g][p] and count into npred0[g][s]
__global__ void __launch_bounds__(kWideThreads)
sgs_decode_wide_prep(const uint8_t* __restrict__ pred, int J,
                     uint32_t* __restrict__ succ, int* __restrict__ npred0) {
  const size_t gs = blockIdx.x;                  // g * J + s
  const size_t g = gs / (size_t)J;
  const int s = (int)(gs - g * J);
  const size_t NW = ((size_t)J + 31) / 32;
  const uint8_t* row = pred + gs * J;
  int n = 0;
  for (int p = threadIdx.x; p < J; p += kWideThreads)
    if (row[p]) {
      atomicOr(&succ[(g * J + p) * NW + (s >> 5)], 1u << (s & 31));
      ++n;
    }
  n = __reduce_add_sync(kFull, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&npred0[gs], n);
}

// --- the wide route: one warp a row past the fast route's shared memory ----

// the group's arrays in a block's shared memory on the wide route: rel[J]
// (i32) | caps_eps[M] (f32); succ and npred0 live in the prep's scratch
__host__ __device__ __forceinline__ size_t wide_block_bytes(int J, int M) {
  return align16(4 * ((size_t)J + (size_t)M));
}

// a row's arrays on the wide route: rdy, start, npred, dur[J] (i32; first
// the buffer of the rank sort, 8 bytes a slot rounded up to a power of two,
// < 16 J) | usage[M * T] | dem[J * M] (f32) | rank[J] (a slot's rank),
// sor[J] (the slot of a rank), elig[ceil(J/32)] (bit r: the slot of rank r
// is eligible) (u32) | st[J] (u8: bit 0 ok, bit 1 placed)
__host__ __device__ __forceinline__ size_t wide_warp_bytes(int J, int M,
                                                           int T) {
  const size_t NW = ((size_t)J + 31) / 32;
  return align16(4 * (6 * (size_t)J + NW + (size_t)M * T + (size_t)J * M)
                 + (size_t)J);
}

// sort the warp's n (a power of two) keys in shared memory, ascending:
// bitonic, each stage's pairs spread over the lanes. The pairs of a stage
// are disjoint, so a lane loads kSortPairs of them before it stores any
// (a store between two loads would make each load a round trip)
constexpr int kSortPairs = 8;
__device__ __forceinline__ void warp_sort(uint64_t* a, int n, int lane) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i0 = lane; i0 < half; i0 += 32 * kSortPairs) {
        uint64_t x[kSortPairs], y[kSortPairs];
#pragma unroll
        for (int u = 0; u < kSortPairs; ++u) {
          const int i = i0 + 32 * u;
          const int lo = 2 * i - (i & (jj - 1));
          if (i < half) {
            x[u] = a[lo];
            y[u] = a[lo + jj];
          }
        }
#pragma unroll
        for (int u = 0; u < kSortPairs; ++u) {
          const int i = i0 + 32 * u;
          const int lo = 2 * i - (i & (jj - 1));
          if (i < half) {
            const uint64_t mn = x[u] < y[u] ? x[u] : y[u];
            const uint64_t mx = x[u] < y[u] ? y[u] : x[u];
            const bool up = (lo & k) == 0;
            a[lo] = up ? mn : mx;
            a[lo + jj] = up ? mx : mn;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The wide route (J <= 2048): the fast route's algorithm and exactness, one
// warp a row and no block barrier in the step loop, W (at most kWideRows)
// rows of a group a block, the last block of a group holding fewer where W
// does not divide rows_per_group. The group's successor bitmask and
// predecessor counts come from sgs_decode_wide_prep's scratch in global
// memory (L2-resident), and the step is reshaped for a long row:
//   * eligibility is a bitset over ranks in the row's shared memory, not a
//     lane's register: lane l reads words l and l + 32, and the argmax is
//     one redux of their least set ranks, then a rank -> slot load;
//   * a placement's successors are released by the lanes that hold their
//     words of succ[j], all at once: each slot is touched by one lane a
//     step, and its eligible bit flips by a shared atomic. A __syncwarp at
//     the top of a step publishes what the lanes wrote, so the chosen
//     slot's ready bin is a plain load (no shuffle from an owner lane);
//   * the successor row of the chosen slot is fetched into registers as
//     soon as the slot is known and consumed after the window search;
//   * the window search loads kScanWords words of bins, then ballots them,
//     with no branch around a load, so the words' latencies overlap;
//   * every shared load of a slot's state is issued before its stores (the
//     compiler cannot tell the arrays apart, so a store in between makes
//     each load a round trip of its own);
//   * the ranks come from a bitonic sort of the row's keys, not from a
//     pairwise count (J^2 / 32 compares a lane).
__global__ void __launch_bounds__(32 * kWideRows, 4)
sgs_decode_wide_kernel(const int32_t* __restrict__ dur,      // (rows, J)
                       const float* __restrict__ dem,        // (rows, J, M)
                       const float* __restrict__ prio,       // (rows, J)
                       const int32_t* __restrict__ release,  // (G, J)
                       const uint32_t* __restrict__ succ_g,  // (G, J, NW)
                       const int* __restrict__ npred0_g,     // (G, J)
                       const float* __restrict__ caps,       // (M,)
                       int32_t* __restrict__ start,          // (rows, J)
                       int32_t* __restrict__ finish,         // (rows, J)
                       uint8_t* __restrict__ ok,             // (rows, J)
                       int J, int M, int T, int rows_per_group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = (J + 31) >> 5;     // words of slots (<= 64)
  const int K = (T + 31) >> 5;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int W = nthreads >> 5;
  const unsigned per_group = (unsigned)(rows_per_group + W - 1) / W;
  const size_t g = blockIdx.x / per_group;
  const int in_group = (int)(blockIdx.x - g * per_group) * W + (tid >> 5);
  const bool live = in_group < rows_per_group;   // a row of this group
  const size_t row = g * rows_per_group + in_group;

  int* rel = reinterpret_cast<int*>(smem);
  float* caps_eps = reinterpret_cast<float*>(rel + J);
  const uint32_t* succ = succ_g + g * (size_t)J * NW;
  const int* npred0 = npred0_g + g * (size_t)J;
  unsigned char* mine = smem + wide_block_bytes(J, M)
                      + (size_t)(tid >> 5) * wide_warp_bytes(J, M, T);
  int* rdy = reinterpret_cast<int*>(mine);
  int* start_s = rdy + J;
  int* npred = start_s + J;
  int* dur_s = npred + J;
  float* usage = reinterpret_cast<float*>(dur_s + J);
  float* dem_s = usage + (size_t)M * T;
  uint32_t* rank = reinterpret_cast<uint32_t*>(dem_s + (size_t)J * M);
  int* sor = reinterpret_cast<int*>(rank + J);
  uint32_t* elig = reinterpret_cast<uint32_t*>(sor + J);
  uint8_t* st = reinterpret_cast<uint8_t*>(elig + NW);
  const int32_t* dur_r = dur + row * J;
  const float* dem_r = dem + row * J * M;
  const float* prio_r = prio + row * J;

  // --- staging: the group's arrays (block), the row's arrays (warp) -------
#pragma unroll 4
  for (int s = tid; s < J; s += nthreads) rel[s] = release[g * J + s];
  for (int m = tid; m < M; m += nthreads)
    caps_eps[m] = __fadd_rn(caps[m], 1e-6f);
  if (live) {
#pragma unroll 8
    for (int i = lane; i < J * M; i += 32) dem_s[i] = dem_r[i];
#pragma unroll 4
    for (int s = lane; s < J; s += 32) st[s] = 0;
    for (int i = lane; i < M * T; i += 32) usage[i] = 0.0f;
  }
  __syncthreads();
  if (!live) return;    // no block barrier below
  // each slot's rank in the order (priority descending, index ascending):
  // sort (~key, slot) ascending in the buffer over rdy..dur, so position i
  // holds the slot of rank i; the slots scored -inf rank last, from n_fin
  int fin = 0;               // slots whose priority is above -inf
  uint64_t* keys = reinterpret_cast<uint64_t*>(rdy);
  int n = 1;
  while (n < J) n <<= 1;
#pragma unroll 8
  for (int s = lane; s < J; s += 32) {
    const uint32_t k = order_key(prio_r[s]);
    fin += k > kNegInfKey;
    keys[s] = ((uint64_t)~k << 32) | (uint32_t)s;
  }
  for (int i = J + lane; i < n; i += 32) keys[i] = ~0ull;   // sort last
  __syncwarp();
  warp_sort(keys, n, lane);
#pragma unroll 4
  for (int i = lane; i < J; i += 32) {
    const int s = (int)(uint32_t)keys[i];
    rank[s] = (uint32_t)i;
    sor[i] = s;
  }
  __syncwarp();              // every lane is done with the buffer
#pragma unroll 8
  for (int s = lane; s < J; s += 32) {
    dur_s[s] = dur_r[s];
    rdy[s] = 0;
    start_s[s] = 0;
    npred[s] = npred0[s];
  }
  __syncwarp();
  for (int w = lane; w < NW; w += 32) {
    uint32_t bits = 0u;
    for (int b = 0; b < 32 && 32 * w + b < J; ++b)
      bits |= (npred[sor[32 * w + b]] == 0 ? 1u : 0u) << b;
    elig[w] = bits;
  }
  const int n_fin = __reduce_add_sync(kFull, fin);
  float ce[kRegM];          // caps + 1e-6 of the resources in registers
#pragma unroll
  for (int m = 0; m < kRegM; ++m) ce[m] = m < M ? caps_eps[m] : 0.0f;

  // --- the J placement steps of this warp's row: no block barrier ---------
  for (int step = 0; step < J; ++step) {
    // 1. argmax over eligible scores, first index on ties: the least set
    //    rank of the eligible bitset
    __syncwarp();            // every lane's writes of the last step
    const uint32_t w0 = lane < NW ? elig[lane] : 0u;
    const uint32_t w1 = lane + 32 < NW ? elig[lane + 32] : 0u;
    const uint32_t top = __reduce_min_sync(
        kFull, w0 ? 32 * lane + __ffs(w0) - 1
                  : (w1 ? 32 * (lane + 32) + __ffs(w1) - 1 : kNone));
    int j = top == kNone ? 0 : sor[top];
    uint32_t rank_j = top;
    if (top == kNone || (int)top >= n_fin) {
      // the best score is -inf: the reference's argmax then takes the
      // first slot scored -inf, eligible or not
      int lowest = INT_MAX;
      for (int s = lane; s < J && lowest == INT_MAX; s += 32)
        if (npred[s] != 0 || (st[s] & 2) || (int)rank[s] >= n_fin)
          lowest = s;
      j = __reduce_min_sync(kFull, lowest);
      rank_j = rank[j];
    }
    if (lane == 0)             // j leaves the eligible set
      atomicAnd(&elig[rank_j >> 5], ~(1u << (rank_j & 31)));
    // the successor row of j, words lane and lane + 32, fetched now and
    // consumed after the window search
    const uint32_t* sj = succ + (size_t)j * NW;
    const uint32_t sw0 = lane < NW ? __ldg(sj + lane) : 0u;
    const uint32_t sw1 = lane + 32 < NW ? __ldg(sj + 32 + lane) : 0u;

    // 2. the chosen slot's duration, demand and ready bin
    const int d = dur_s[j];
    const int ready = max(rel[j], rdy[j]);
    float r[kRegM];
#pragma unroll
    for (int m = 0; m < kRegM; ++m)
      r[m] = m < M ? dem_s[(size_t)j * M + m] : 0.0f;

    // 3-4. the earliest t >= t0 = max(ready, 0) whose window [t, t + d)
    //      lies in the grid and holds no overloaded bin, as on the fast
    //      route, kScanWords words of 32 bins a round: their loads first
    //      (at a bin clamped into the grid), then their ballots. Lane l
    //      tests the window that ENDS at bin e = 32k + l, clean when the
    //      last overloaded bin at or below e lies before its start.
    const int t0 = max(ready, 0);
    int first = INT_MAX;
    if (d == 0) {
      if (t0 < T) first = t0;
    } else if (t0 + d <= T) {
      int last_flag = -1;      // last overloaded bin in [t0, 32k)
      for (int k = t0 >> 5; k < K; k += kScanWords) {
        float u[kScanWords][kRegM];
#pragma unroll
        for (int c = 0; c < kScanWords; ++c) {
          const int e = min(((k + c) << 5) + lane, T - 1);
#pragma unroll
          for (int m = 0; m < kRegM; ++m)
            u[c][m] = m < M ? usage[(size_t)m * T + e] : 0.0f;
        }
        uint32_t word[kScanWords];
#pragma unroll
        for (int c = 0; c < kScanWords; ++c) {
          const int e = ((k + c) << 5) + lane;
          bool flag = false;
#pragma unroll
          for (int m = 0; m < kRegM; ++m)
            flag |= r[m] > 0.0f && __fadd_rn(u[c][m], r[m]) > ce[m];
          if (M > kRegM && e < T)
            for (int m = kRegM; m < M; ++m) {
              const float rm = dem_s[(size_t)j * M + m];
              if (rm > 0.0f
                  && __fadd_rn(usage[(size_t)m * T + e], rm) > caps_eps[m])
                flag = true;
            }
          word[c] = __ballot_sync(kFull, flag && e >= t0 && e < T);
        }
        uint32_t clean = 0u;
        int at = 0;              // the word holding the first clean window
#pragma unroll
        for (int c = 0; c < kScanWords; ++c) {
          const int e = ((k + c) << 5) + lane;
          const uint32_t upto = word[c] & (kFull >> (31 - lane));  // <= l
          const int last =
              upto ? ((k + c) << 5) + 31 - __clz(upto) : last_flag;
          const int t = e - d + 1;
          const uint32_t cl =
              __ballot_sync(kFull, t >= t0 && e < T && last < t);
          if (cl && !clean) {
            clean = cl;
            at = k + c;
          }
          if (word[c]) last_flag = ((k + c) << 5) + 31 - __clz(word[c]);
        }
        if (clean) {
          first = (at << 5) + __ffs(clean) - 1 - d + 1;
          break;
        }
      }
    }

    // 5. the placement, or the fallback
    const bool any_ok = first != INT_MAX;
    const int tstar = any_ok ? first : max(ready, T - d);
    const int fin_j = tstar + d;

    // 6. demand into the usage window, clipped to the grid (own bins), the
    //    loads before the stores
    const int lo = max(tstar, 0);
    const int hi = min(fin_j, T);
    for (int k = lo >> 5; (k << 5) < hi; ++k) {
      const int t = (k << 5) + lane;
      if (t >= lo && t < hi) {
        float v[kRegM];
#pragma unroll
        for (int m = 0; m < kRegM; ++m)
          if (m < M) v[m] = usage[(size_t)m * T + t];
#pragma unroll
        for (int m = 0; m < kRegM; ++m)
          if (m < M) usage[(size_t)m * T + t] = __fadd_rn(v[m], r[m]);
        for (int m = kRegM; m < M; ++m) {
          float* p = usage + (size_t)m * T + t;
          *p = __fadd_rn(*p, dem_s[(size_t)j * M + m]);
        }
      }
    }
    if (lane == 0) {
      start_s[j] = tstar;
      st[j] = any_ok ? 3 : 2;
    }
    // release the successors and push this finish into their ready bins:
    // lane l releases the slots of words l and l + 32 itself, one lane a
    // slot, the loads before the stores; a slot's eligible bit flips when
    // its count reaches 0 (or leaves it, in cyclic inputs)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = lane + 32 * h;
      for (uint32_t bits = h ? sw1 : sw0; bits; bits &= bits - 1) {
        const int s = 32 * w + __ffs(bits) - 1;
        const int c = npred[s];
        const int rd = rdy[s];
        const bool placed = st[s] & 2;
        const uint32_t rs = rank[s];
        npred[s] = c - 1;
        rdy[s] = max(rd, fin_j);
        if (!placed && (c == 1 || c == 0))
          atomicXor(&elig[rs >> 5], 1u << (rs & 31));
      }
    }
  }
  __syncwarp();

  // --- write the row out, coalesced ----------------------------------------
  for (int s = lane; s < J; s += 32) {
    const size_t o = row * J + s;
    const int f = st[s];
    start[o] = start_s[s];
    finish[o] = (f & 2) ? start_s[s] + dur_s[s] : 0;
    ok[o] = (uint8_t)(f & 1);
  }
}

// --- the wide-block route: one block a row ---------------------------------

// the least v over the block, to every thread. red holds a word a warp;
// a caller reusing red passes a barrier first
__device__ __forceinline__ uint32_t block_min(uint32_t v, uint32_t* red) {
  v = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t out = red[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) out = min(out, red[w]);
  return out;
}

// at most 4 blocks an SM (shared memory allows 3 at J 1792, M 2, T 256),
// so up to 128 registers a thread: without the block count ptxas keeps
// 64-72 and spills 8-12 bytes (the row's output base, a loop bound)
__global__ void __launch_bounds__(kWideThreads, 4)
sgs_decode_wide_block_kernel(
    const int32_t* __restrict__ dur,      // (rows, J)
    const float* __restrict__ dem,        // (rows, J, M)
    const float* __restrict__ prio,       // (rows, J)
    const int32_t* __restrict__ release,  // (G, J)
    const uint32_t* __restrict__ succ,    // (G, J, NW)
    const int* __restrict__ npred0,       // (G, J)
    const float* __restrict__ caps,       // (M,)
    int32_t* __restrict__ start,          // (rows, J)
    int32_t* __restrict__ finish,         // (rows, J)
    uint8_t* __restrict__ ok,             // (rows, J)
    unsigned char* state_global,          // null: shared memory
    int J, int M, int T, int rows_per_group) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t red[2][kWideWarps];  // alternate: one barrier a use
  __shared__ int sel[2];                   // the step's t* and ok
  const int NW = (J + 31) >> 5;
  const int K = (T + 31) >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.x;
  const size_t g = row / (size_t)rows_per_group;
  const WideState L(J, M, T);
  unsigned char* base = state_global ? state_global + row * L.bytes : smem;
  uint32_t* rank = reinterpret_cast<uint32_t*>(base + L.rank);
  int* sor = reinterpret_cast<int*>(base + L.sor);
  int* dur_s = reinterpret_cast<int*>(base + L.dur);
  int* rdy = reinterpret_cast<int*>(base + L.rdy);
  int* start_s = reinterpret_cast<int*>(base + L.start);
  int* npred = reinterpret_cast<int*>(base + L.npred);
  int* rel = reinterpret_cast<int*>(base + L.rel);
  uint32_t* pkey = reinterpret_cast<uint32_t*>(base + L.pkey);
  uint32_t* elig = reinterpret_cast<uint32_t*>(base + L.elig);
  float* dem_s = reinterpret_cast<float*>(base + L.dem);
  float* usage = reinterpret_cast<float*>(base + L.usage);
  float* caps_eps = reinterpret_cast<float*>(base + L.caps);
  uint8_t* st = base + L.st;
  const uint32_t* succ_g = succ + g * (size_t)J * NW;

  // --- staging ----------------------------------------------------------------
  for (int s = tid; s < J; s += kWideThreads) {
    dur_s[s] = dur[row * J + s];
    pkey[s] = order_key(prio[row * J + s]);
    rel[s] = release[g * J + s];
    npred[s] = npred0[g * J + s];
    rdy[s] = 0;
    start_s[s] = 0;
    st[s] = 0;
  }
  for (size_t i = tid; i < (size_t)J * M; i += kWideThreads)
    dem_s[i] = dem[row * J * (size_t)M + i];
  for (int i = tid; i < M * T; i += kWideThreads) usage[i] = 0.0f;
  for (int m = tid; m < M; m += kWideThreads)
    caps_eps[m] = __fadd_rn(caps[m], 1e-6f);
  __syncthreads();
  // each slot's rank in (priority descending, index ascending): unique, so
  // sor inverts it; the slots scored -inf rank last, from n_fin up
  uint32_t inf = 0;          // this thread's slots scored -inf
  for (int s = tid; s < J; s += kWideThreads) {
    const uint32_t ks = pkey[s];
    uint32_t r = 0;
    for (int q = 0; q < J; ++q) {
      const uint32_t kq = pkey[q];
      r += kq > ks || (kq == ks && q < s);
    }
    rank[s] = r;
    sor[r] = s;
    inf += ks <= kNegInfKey;
  }
  inf = __reduce_add_sync(kFull, inf);
  if (lane == 0) red[0][tid >> 5] = inf;
  __syncthreads();
  uint32_t n_fin = (uint32_t)J;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) n_fin -= red[0][w];
  uint32_t best = kNone;     // least rank of this thread's eligible slots
  for (int w = tid; w < NW; w += kWideThreads) {
    uint32_t bits = 0;
    for (int b = 0, s = 32 * w; b < 32 && s < J; ++b, ++s)
      if (npred[s] == 0) {
        bits |= 1u << b;
        best = min(best, rank[s]);
      }
    elig[w] = bits;
  }
  // red[0] is read above and written again only after the first step's
  // barrier in block_min(red[1]), which every thread passes after reading

  // --- the J placement steps ----------------------------------------------------
  for (int step = 0; step < J; ++step) {
    // 1. argmax over eligible scores, first index on ties: the least rank
    //    (the barrier inside also publishes the previous step's writes)
    const uint32_t top = block_min(best, red[(step + 1) & 1]);
    int j;
    if (top == kNone || top >= n_fin) {
      // the best score is -inf: the reference's argmax then takes the
      // first slot scored -inf, eligible or not
      uint32_t lowest = kNone;
      for (int w = tid; w < NW && lowest == kNone; w += kWideThreads) {
        const uint32_t e = elig[w];
        for (int b = 0, s = 32 * w; b < 32 && s < J; ++b, ++s)
          if (!((e >> b) & 1u) || rank[s] >= n_fin) {
            lowest = (uint32_t)s;
            break;
          }
      }
      j = (int)block_min(lowest, red[step & 1]);
    } else {
      j = sor[top];
    }

    // 2-5. warp 0: the chosen slot's window, as the fast path's steps 3-5
    const int d = dur_s[j];
    const int ready = max(rel[j], rdy[j]);
    if (tid < 32) {
      const int t0 = max(ready, 0);
      int first = INT_MAX;
      if (d == 0) {
        if (t0 < T) first = t0;
      } else if (t0 + d <= T) {
        int last_flag = -1;      // last overloaded bin in [t0, 32k)
        for (int k = t0 >> 5; k < K; ++k) {
          const int e = (k << 5) + lane;
          bool flag = false;
          if (e >= t0 && e < T)
            for (int m = 0; m < M; ++m) {
              const float rm = dem_s[(size_t)j * M + m];
              if (rm > 0.0f
                  && __fadd_rn(usage[(size_t)m * T + e], rm) > caps_eps[m])
                flag = true;
            }
          const uint32_t word = __ballot_sync(kFull, flag);
          const uint32_t upto = word & (kFull >> (31 - lane));
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
      if (lane == 0) {
        sel[0] = first != INT_MAX ? first : max(ready, T - d);
        sel[1] = first != INT_MAX;
      }
    }
    __syncthreads();
    const int tstar = sel[0];
    const bool any_ok = sel[1] != 0;
    const int fin = tstar + d;

    // 6. demand into the usage window, clipped to the grid: one add per
    //    (bin, resource), by one thread
    const int lo = max(tstar, 0);
    const int hi = min(fin, T);
    for (int i = tid; i < (hi - lo) * M; i += kWideThreads) {
      const int t = lo + i / M, m = i - (i / M) * M;
      float* u = usage + (size_t)m * T + t;
      *u = __fadd_rn(*u, dem_s[(size_t)j * M + m]);
    }
    bool rescan = false;     // this thread's best slot left the eligible set
    if (tid == (j >> 5) % kWideThreads) {
      start_s[j] = tstar;
      st[j] = any_ok ? 3 : 2;
      elig[j >> 5] &= ~(1u << (j & 31));
      rescan = true;
    }
    // release the successors of j on the words this thread owns
    const uint32_t* sj = succ_g + (size_t)j * NW;
    for (int w = tid; w < NW; w += kWideThreads) {
      uint32_t bits = sj[w];
      if (!bits) continue;
      uint32_t e = elig[w];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const int s = 32 * w + b;
        const int c = npred[s] - 1;
        npred[s] = c;
        rdy[s] = max(rdy[s], fin);
        const bool now = c == 0 && !(st[s] & 2);
        if (now != (bool)((e >> b) & 1u)) {
          e ^= 1u << b;
          if (now) best = min(best, rank[s]);
          else rescan = true;
        }
      }
      elig[w] = e;
    }
    if (rescan) {
      best = kNone;
      for (int w = tid; w < NW; w += kWideThreads)
        for (uint32_t e = elig[w]; e; e &= e - 1)
          best = min(best, rank[32 * w + __ffs(e) - 1]);
    }
  }
  __syncthreads();

  // --- write the row out, coalesced ---------------------------------------------
  for (int s = tid; s < J; s += kWideThreads) {
    const size_t o = row * J + s;
    const int f = st[s];
    start[o] = start_s[s];
    finish[o] = (f & 2) ? start_s[s] + dur_s[s] : 0;
    ok[o] = (uint8_t)(f & 1);
  }
}

// The latency floor of a step: its irreducible chain, run `iters` times
// back to back by one warp. A redux picks the least rank; the chosen slot's
// dependent shared loads (the rank -> slot table, then the slot's ready
// bin); one shuffle; one word of the window search (a shared load, an add,
// a compare, a ballot), whose result feeds the next redux. Writes the
// cycles (clock64) and nanoseconds (%globaltimer) of the loop.
__global__ void __launch_bounds__(32)
sgs_decode_chain(int iters, long long* __restrict__ out) {
  __shared__ int sor_s[32], rdy_s[32];
  __shared__ float usage_s[32];
  const int lane = threadIdx.x;
  sor_s[lane] = (lane * 7) & 31;
  rdy_s[lane] = (lane * 11) & 31;
  usage_s[lane] = (float)lane;
  __syncwarp();
  uint32_t best = (uint32_t)lane;
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const uint32_t top = __reduce_min_sync(kFull, best);
    const int j = sor_s[top & 31];
    const int ready = __shfl_sync(kFull, rdy_s[j], j);
    const float u = __fadd_rn(usage_s[(ready + lane) & 31], 1.0f);
    const uint32_t word = __ballot_sync(kFull, u > 16.0f);
    best = (uint32_t)lane ^ (word & 1u);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(ns1 - ns0);
    out[2] = (long long)best;
  }
}

// What a device's launches need and never changes: read once per device.
struct DeviceInfo {
  std::atomic<int> ready;
  int sms, optin;                // SMs; shared memory a block may opt into
  size_t block_static;           // static shared memory of the block kernel
  size_t total;                  // device memory
  long long applied[3];          // dynamic shared memory opted into, a route
};
constexpr int kMaxDevices = 64;
DeviceInfo g_device[kMaxDevices];
std::mutex g_device_mu;

enum Route { kFast = 0, kWideWarp = 1, kWideBlock = 2 };

cudaError_t device_info(DeviceInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_device[dev];
  if (!d.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_device_mu);
    if (!d.ready.load(std::memory_order_relaxed)) {
      cudaFuncAttributes attr;
      size_t free_b = 0;
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&d.optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
      if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&attr, sgs_decode_wide_block_kernel);
      if (e == cudaSuccess) e = cudaMemGetInfo(&free_b, &d.total);
      if (e != cudaSuccess) return e;
      d.block_static = attr.sharedSizeBytes;
      d.applied[0] = d.applied[1] = d.applied[2] = 48 * 1024;
      d.ready.store(1, std::memory_order_release);
    }
  }
  *out = &d;
  return cudaSuccess;
}

// opt the route's kernel into `smem` bytes of dynamic shared memory, once
// per device and size
template <typename F>
cudaError_t opt_in(DeviceInfo* d, int route, F kernel, long long smem) {
  std::lock_guard<std::mutex> lock(g_device_mu);
  if (smem <= d->applied[route]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) d->applied[route] = smem;
  return e;
}

}  // namespace

extern "C" {

// The launch geometry of this shape on the current device, by route:
//   0 fast: *warps = W rows a block, *smem its dynamic shared memory;
//   1 wide, past the fast route's shared memory with J <= 2048: W rows a
//     block, the group's successor bitmask in the global scratch;
//   2 wide-block, J > 2048 or a row's state past a block's shared memory:
//     one row a block (*warps = 0), *smem the row's state in shared memory,
//     or 0 where it lives in the scratch.
// `want` < 0 picks the first route that takes the shape, else asks for that
// route (-2 where it does not take the shape). *scratch is the global
// scratch the launch needs, *limit the card's shared memory per block.
// Returns -1 when the inputs, outputs and scratch together exceed the
// card's memory, else a CUDA error code. Reads the card once per device.
int sgs_decode_geometry(int rows, int J, int M, int T, int rows_per_group,
                        int want, int* route, int* warps, long long* smem,
                        long long* limit, long long* scratch) {
  DeviceInfo* dev = nullptr;
  const cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return (int)e;
  const size_t optin = (size_t)dev->optin;
  *limit = dev->optin;
  *scratch = 0;
  // a lane's eligible slots are one 64-bit mask: J <= 2048
  const bool in_mask = (J + 31) / 32 <= kMaxSlotWords;
  if (want < 0 || want == kFast) {
    const size_t fixed = block_bytes(J, M);
    const size_t per = warp_bytes(J, M, T);
    int W = kMaxWarps;
    while (W > 1 && rows_per_group % W) W >>= 1;
    if (rows < 4 * dev->sms && W > 4) W = 4;  // a scheduler for every row
    while (W > 1 && fixed + W * per > optin) W >>= 1;
    if (fixed + W * per <= optin && in_mask) {
      *route = kFast;
      *warps = W;
      *smem = (long long)(fixed + W * per);
      return 0;
    }
    if (want == kFast) return -2;
  }
  const int G = rows_per_group > 0 ? rows / rows_per_group : 0;
  const size_t io = (size_t)rows * J * (4 + 4 * (size_t)M + 4 + 9)
                  + (size_t)G * J * (4 + (size_t)J) + 4 * (size_t)M;
  *scratch = (long long)wide_prep_bytes(G, J);
  const size_t fixed = wide_block_bytes(J, M);
  const size_t per = wide_warp_bytes(J, M, T);
  if ((want < 0 || want == kWideWarp) && in_mask && fixed + per <= optin) {
    // the most rows a block, each on a scheduler of its own (4 an SM)
    int W = rows_per_group < kWideRows ? rows_per_group : kWideRows;
    while (W > 1 && fixed + W * per > optin) --W;
    *route = kWideWarp;
    *warps = W;
    *smem = (long long)(fixed + W * per);
  } else if (want < 0 || want == kWideBlock) {
    const WideState L(J, M, T);
    const bool in_shared = L.bytes + dev->block_static <= optin;
    *route = kWideBlock;
    *warps = 0;
    *smem = in_shared ? (long long)L.bytes : 0;
    if (!in_shared) *scratch += (long long)((size_t)rows * L.bytes);
  } else {
    return -2;
  }
  return io + (size_t)*scratch > dev->total ? -1 : 0;
}

// Launch on `stream` the route that sgs_decode_geometry gave for this shape
// (route, warps, smem), with `scratch` of its bytes (unused on the fast
// route). Returns cudaGetLastError() after the launch. The wide routes zero
// and rebuild the successor bitmask on every launch.
int sgs_decode_launch(const void* dur, const void* dem, const void* prio,
                      const void* release, const void* pred, const void* caps,
                      void* start, void* finish, void* ok,
                      int rows, int J, int M, int T, int rows_per_group,
                      int route, int warps, long long smem, void* scratch,
                      void* stream) {
  if (rows <= 0 || J <= 0) return 0;
  DeviceInfo* dev = nullptr;
  cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = rows / rows_per_group;
  if (route == kFast) {
    e = opt_in(dev, kFast, sgs_decode_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    sgs_decode_kernel<<<rows / warps, 32 * warps, (size_t)smem, s>>>(
        (const int32_t*)dur, (const float*)dem, (const float*)prio,
        (const int32_t*)release, (const uint8_t*)pred, (const float*)caps,
        (int32_t*)start, (int32_t*)finish, (uint8_t*)ok,
        J, M, T, rows_per_group);
    return (int)cudaGetLastError();
  }
  uint32_t* succ = (uint32_t*)scratch;
  int* npred0 = (int*)(succ + wide_succ_words(G, J));
  e = cudaMemsetAsync(scratch, 0, wide_prep_bytes(G, J), s);
  if (e != cudaSuccess) return (int)e;
  sgs_decode_wide_prep<<<(unsigned)((size_t)G * J), kWideThreads, 0, s>>>(
      (const uint8_t*)pred, J, succ, npred0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (route == kWideWarp) {
    e = opt_in(dev, kWideWarp, sgs_decode_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks =
        (unsigned)G * (unsigned)((rows_per_group + warps - 1) / warps);
    sgs_decode_wide_kernel<<<blocks, 32 * warps, (size_t)smem, s>>>(
        (const int32_t*)dur, (const float*)dem, (const float*)prio,
        (const int32_t*)release, succ, npred0, (const float*)caps,
        (int32_t*)start, (int32_t*)finish, (uint8_t*)ok,
        J, M, T, rows_per_group);
    return (int)cudaGetLastError();
  }
  unsigned char* state =
      smem ? nullptr : (unsigned char*)scratch + wide_prep_bytes(G, J);
  e = opt_in(dev, kWideBlock, sgs_decode_wide_block_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sgs_decode_wide_block_kernel<<<rows, kWideThreads, (size_t)smem, s>>>(
      (const int32_t*)dur, (const float*)dem, (const float*)prio,
      (const int32_t*)release, succ, npred0, (const float*)caps,
      (int32_t*)start, (int32_t*)finish, (uint8_t*)ok, state,
      J, M, T, rows_per_group);
  return (int)cudaGetLastError();
}

// Host microseconds a call of each piece of a wide launch's host work takes,
// averaged over `reps` calls, into us[0..8]: cudaGetDevice, the SM count and
// the opt-in shared memory (cudaDeviceGetAttribute), cudaFuncGetAttributes,
// cudaMemGetInfo, cudaFuncSetAttribute (to the wide route's `smem`), the
// scratch's cudaMemsetAsync and the prep kernel's launch on `stream`, and
// sgs_decode_geometry as a launch now reads it. For measurement only.
int sgs_decode_probe_host(int rows, int J, int M, int T, int rows_per_group,
                          long long smem, const void* pred, void* scratch,
                          void* stream, int reps, double* us) {
  using clock = std::chrono::steady_clock;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = rows / rows_per_group;
  uint32_t* succ = (uint32_t*)scratch;
  int* npred0 = (int*)(succ + wide_succ_words(G, J));
  int dev = 0, v = 0, rt = 0, w = 0;
  long long sm = 0, lim = 0, scr = 0;
  size_t free_b = 0, total_b = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaSuccess;
  for (int piece = 0; piece < 9 && e == cudaSuccess; ++piece) {
    const auto t0 = clock::now();
    for (int i = 0; i < reps && e == cudaSuccess; ++i) {
      switch (piece) {
        case 0: e = cudaGetDevice(&dev); break;
        case 1:
          e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
          break;
        case 2:
          e = cudaDeviceGetAttribute(
              &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
          break;
        case 3: e = cudaFuncGetAttributes(&attr, sgs_decode_wide_block_kernel); break;
        case 4: e = cudaMemGetInfo(&free_b, &total_b); break;
        case 5:
          e = cudaFuncSetAttribute(sgs_decode_wide_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
          break;
        case 6:
          e = cudaMemsetAsync(scratch, 0, wide_prep_bytes(G, J), s);
          break;
        case 7:
          sgs_decode_wide_prep<<<(unsigned)((size_t)G * J), kWideThreads, 0,
                                 s>>>((const uint8_t*)pred, J, succ, npred0);
          e = cudaGetLastError();
          break;
        default: {
          const int rc = sgs_decode_geometry(rows, J, M, T, rows_per_group,
                                             -1, &rt, &w, &sm, &lim, &scr);
          if (rc > 0) e = (cudaError_t)rc;
        }
      }
    }
    us[piece] = std::chrono::duration<double, std::micro>(clock::now() - t0)
                    .count() / reps;
  }
  return (int)e;
}

// Cycles of one irreducible step chain and the SM clock (cycles per ns) it
// ran at, over `iters` chains on the current device (sgs_decode_chain).
// Synchronises the device. For the latency floor of a decode.
int sgs_decode_chain_cycles(int iters, double* cycles, double* ghz) {
  long long* out = nullptr;
  long long host[3] = {0, 0, 0};
  cudaError_t e = cudaMalloc(&out, sizeof(host));
  if (e != cudaSuccess) return (int)e;
  sgs_decode_chain<<<1, 32>>>(iters, out);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaMemcpy(host, out, sizeof(host),
                                       cudaMemcpyDeviceToHost);
  cudaFree(out);
  if (e != cudaSuccess) return (int)e;
  *cycles = (double)host[0] / iters;
  *ghz = host[1] > 0 ? (double)host[0] / (double)host[1] : 0.0;
  return 0;
}

const char* sgs_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
