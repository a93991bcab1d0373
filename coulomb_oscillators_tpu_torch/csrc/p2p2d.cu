// Near-field (P2P) pass of the kd-tree FMM in dim 2, hand-written for
// Hopper (sm_90a) for fmm2_kd's short, skewed partner rows.
//
// Replaces the dim = 2 bodies of two TPU kernels of
// coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py: _p2p_kernel
// (p2p_leaf_pairs) and _p2p_stream_kernel (p2p_leaf_pairs_streaming), which
// weigh a pair by r^2 in dim 2.  csrc/p2p.cu keeps dim 3, whose rows are
// long (268 entries a 128-slot block at N = 1M) and whose design gives a
// whole target block to one CUDA block.
//
// What bounds it.  A dim-2 pair is d2 = dx^2 + dy^2 + eps2 (two FFMA), r =
// rsqrt(d2), w = r*r and two FFMA into the sums: ~8 instructions, one of
// them the MUFU.RSQ.  So float is bound by the special-function units (one
// rsqrt a real pair at 132 SMs x 16 a clock at 1.98 GHz, 1 / 4.18e12 s),
// just above the flops (14 a pair at 67 TFLOP/s); double by the float64
// flops (33.5 TFLOP/s); the bytes (positions read and written once, the
// entries) are ~1% of either (utils/roofline.py).  fmm2_kd at ladder row
// 2 (p = 4, r = 2, the 2D beam; Gb x CB = 1024 x 128 at N = 100k, 8192 x
// 128 at 1M, nsub = 4 sub-leaves of C = 32): 59,648 entries and 9.29e7
// real pairs at 100k (bound 0.022 ms), 322,623 and 7.81e8 at 1M (0.187 ms).
//
// Why a design of its own.  The rows are short and skewed: a sub-leaf's
// partner row holds 13 entries at the median at N = 100k (p99 46, max
// 256) and 9 at 1M (p99 16, max 2,019).  The dim-3 design, compiled with
// DIM = 2, ran at 8-18% of the bound, for four reasons; what this design
// does about each:
//
//  1. The tail.  One CUDA block owned a 128-slot target block, so one SM
//     owned the heaviest row: at 1M that row is 0.95% of the real pairs,
//     ~7.4e6 pairs, >= 0.23 ms on one SM at its full rsqrt rate, more than
//     the whole call's bound.  Now the unit of work is an item: one warp
//     tile of 32 targets of a sub-leaf and a segment of at most K of its
//     row's entries (K is the launcher's argument; the wrapper's
//     SEG_ENTRIES).  A row of more than K entries is cut into segments
//     that run on different warps and SMs: at K = 16 the 2,019-entry row
//     is 127 items of ~58k pairs each.  Warps take items from a counter
//     (a persistent grid, every resident warp a worker), so no SM waits on
//     another's long item.
//  2. Work for each unit.  A stage unit was one partner entry, ~83 source
//     slots, against ~250 instructions of unit bookkeeping and copies.
//     Now a ring slot holds kP pieces of 32 sources (4 KB: 16 pieces in
//     float, 8 in double), packed from the selected lane groups of several
//     consecutive entries: a lane finds its piece's entry with a 5-step
//     shuffle search over the entries' inclusive piece counts.  The
//     bookkeeping is paid once a unit of up to 512 sources in float.
//  3. Work for each block.  A block staged its targets, zeroed and added 8
//     warps' shares and made three __syncthreads.  Now a warp is alone: it
//     reads its 32 targets from global memory, adds its H source shares
//     with a shuffle butterfly and writes its tile; no shared memory but
//     its own ring, no block barrier.
//  4. The sort on every call.  The wrapper sorted the blocks heaviest first
//     (~0.1 ms of small kernels at 100k, more than four times the bound).
//     Now it makes the plan with a cumsum (p2p_cuda.segment_plan): a
//     row's extra segments (beyond its first) come first in the item
//     order, longest rows' segments among them, then segment 0 of every
//     (row, tile) in row order; a warp maps an extra item to its row with a
//     32-way ballot search over the plan, and a first segment directly.
//
// The segments' ordered sum.  Segment s of an (n >= 2)-segment row writes
// S_s = S_(s+1) + p_s into a scratch row (`run`, shaped like `out`), where
// p_s is its own partial and S_(n-1) = p_(n-1); segment 0 adds its partial
// last and writes the target once.  A per-(row, tile) counter (`done`)
// says how many segments have committed: segment s waits (lane 0 polls
// with ld.acquire and __nanosleep) until done = n-1-s, reads S_(s+1)
// through L2 (ld.cg), adds, stores (st.cg), fences, and publishes done =
// n-s with st.release.  So every target is the same fixed-order sum in
// every run and under any schedule, with no float atomics.  A segment's
// item comes after the one it waits for in the item order (segments n-1,
// ..., 1 of a row in that order, segment 0 after all of them), and a warp
// takes items in increasing order, at most one ahead: the lowest item not
// yet done always runs on a warp, so the waits cannot deadlock, however
// many blocks are resident.
//
// Sums.  Inside an item each lane sums each unit into a partial and adds
// the partials in unit order, which is partner order (an accumulation over
// ~30k pairs in one sum drifted to 1.6e-4 of max|a| in float, csrc/p2p.cu).
// A warp tile: lane (li, h) holds kT targets li*kT.. (4 in float, 2 in
// double) and takes the sources j = 4h, 4h + 4H, ... of each piece in
// 4-source packets (H = 4 ways in float, 2 in double): a packet is two
// 16-byte shared loads in float (four in double) for 4 x kT pairs.  The
// butterfly adds the H shares in a fixed order, so every lane ends with
// bitwise the same sum.
//
// Pads.  The rules of csrc/p2p.cu: pad slots sit at FAR = 1e18 and trail
// each sub-leaf; in dim 2 a pad source's weight r^2 = 5e-37 does not
// underflow, so it adds ~5e-19 to a real target.  The float instantiation
// skips a 4-source packet whose four x are >= kPadX and a tile whose 32
// targets all are, and both skip the sentinel block (id Gb) and entries
// with no lane group: each dropped term is at most ~5e-19, far below the
// float32 resolution of a real target's sum.  Double skips no pad.
//
// Registers and shared memory: kWarps = 4 warps a block and
// __launch_bounds__(128, 4), so 16 warps an SM: 114 registers in float,
// 90 in double, no spill (nvcc -Xptxas -v on the H100 machine; chip_smoke
// phase 2 prints them); each warp's ring is kStages = 2 slots of 4 KB
// (32 KB a block); the grid is as many blocks as are resident (the
// occupancy query at the first launch), every warp taking items until the
// counter passes the last.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/p2p_bench.py, PERF.md
// section 6): at N = 1M the kernel takes ~0.34-0.35 ms of device time,
// ~54% of its 0.187 ms bound (the parent design 0.87 ms); at N = 100k
// ~0.092 ms, ~24% of 0.022 ms (0.12 ms).  What holds 100k back: the
// pads, since a sub-leaf holds ~24 of its 32 slots real there, so 42% of
// the slot pairs the warps evaluate are pad pairs (9% at 1M), and the
// grain, ~2.4 items a warp (16 at 1M), so the start of the grid and the
// last items (up to 16 entries, ~26 us at full occupancy) weigh.  Of K =
// 8, 12, 16, 24 and 32, 16 was the fastest at 100k in float (the others
// 9-35% slower) and within 0.3% of 12 at 1M; in double 8 was 4% faster
// and 32 67% slower.  None of 8 pieces a slot, 8 warps a block, 3 ring
// slots, 20 or 24 warps an SM, 8 targets a lane, or a table of each
// unit's real packets (pads skipped warp-wide: 7% faster at 100k, 8%
// slower at 1M, where every lane group is full) was faster at both
// sizes by more than a few %.
//
// Contract (the module contract of ops/fmm/p2p_cuda.py in dim 2):
//   pos     [Gb, CB, 2] float or double, 16-byte aligned, Gb * CB * 2 <
//           2^31: Gb target/source blocks of CB slots, nsub <= 8
//           sub-leaves of C = CB/nsub slots each, C a multiple of 32; pad
//           slots at FAR = 1e18 trail each sub-leaf.
//   row_ptr [Gb*nsub + 1] int32: CSR degrees of each sub-leaf's partner
//           list (a degree above dmax is clamped to dmax).
//   col2d   [Gb*nsub, dmax] int32, read as uint32: entry = blk | bits << s,
//           s = 32 - nsub; bit q of `bits` selects lane group q (slots
//           [qC, (q+1)C)) of source block `blk`; block id Gb is the FAR
//           sentinel.
//   work    [R + 2 + R*C/32] int32, R = Gb*nsub (p2p_cuda.segment_plan
//           with the same K): work[0..R] the prefix of the rows' extra
//           segments times C/32 (work[0] = 0), then the item counter and
//           the per-(row, tile) commit counters, all 0.
//   run     [Gb, CB, 2] as pos: scratch of the segments' running sums.
//   out     [Gb, CB, 2] as pos, each target written exactly once.
//   K       1..32 partner entries a segment.
// Pair weight: r = rsqrt(dist2), w = r*r; never a division of powers of
// dist2 (at a FAR pad dist2 ~ 2e36).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                  // targets of one item
constexpr int kPiece = 32;                 // source slots of a staged piece
constexpr int kMaxK = 32;                  // entries a segment: one a lane

template <typename T> struct Tiling;
template <> struct Tiling<float> {
  static constexpr int kT = 4;             // targets per lane
  static constexpr int kP = 16;            // pieces per ring slot (4 KB)
  static constexpr int kStages = 2;        // ring slots per warp
  static constexpr bool kSkipPads = true;  // pad terms ~5e-19
};
template <> struct Tiling<double> {
  static constexpr int kT = 2;
  static constexpr int kP = 8;             // 4 KB
  static constexpr int kStages = 2;
  static constexpr bool kSkipPads = false;
};

constexpr float kPadX = 1e17f;             // x at or above it: a pad slot

__device__ __forceinline__ float rsqrt_t(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// four (x, y) points, interleaved and 16-byte aligned, as SoA: a staged
// 4-source packet or a lane's targets
__device__ __forceinline__ void load4(const float* sp, float (&x)[4],
                                      float (&y)[4]) {
  const float4* v = reinterpret_cast<const float4*>(sp);
  const float4 a = v[0], b = v[1];
  x[0] = a.x; y[0] = a.y;
  x[1] = a.z; y[1] = a.w;
  x[2] = b.x; y[2] = b.y;
  x[3] = b.z; y[3] = b.w;
}
__device__ __forceinline__ void load4(const double* sp, double (&x)[4],
                                      double (&y)[4]) {
  const double2* v = reinterpret_cast<const double2*>(sp);
  const double2 a = v[0], b = v[1], c = v[2], d = v[3];
  x[0] = a.x; y[0] = a.y;
  x[1] = b.x; y[1] = b.y;
  x[2] = c.x; y[2] = c.y;
  x[3] = d.x; y[3] = d.y;
}

// a lane's kT targets (x, y interleaved) in global memory: read-only
// (ldg), through L2 only (cg, the running sums another SM wrote), stored
// through L2 (cg) or plainly
__device__ __forceinline__ void ldg_xy(const float* p, float (&x)[4],
                                       float (&y)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; y[0] = a.y; x[1] = a.z; y[1] = a.w;
  x[2] = b.x; y[2] = b.y; x[3] = b.z; y[3] = b.w;
}
__device__ __forceinline__ void ldg_xy(const double* p, double (&x)[2],
                                       double (&y)[2]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x; y[0] = a.y; x[1] = b.x; y[1] = b.y;
}
__device__ __forceinline__ void ldcg_xy(const float* p, float (&x)[4],
                                        float (&y)[4]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; y[0] = a.y; x[1] = a.z; y[1] = a.w;
  x[2] = b.x; y[2] = b.y; x[3] = b.z; y[3] = b.w;
}
__device__ __forceinline__ void ldcg_xy(const double* p, double (&x)[2],
                                        double (&y)[2]) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x; y[0] = a.y; x[1] = b.x; y[1] = b.y;
}
template <bool kCg>
__device__ __forceinline__ void st_xy(float* p, const float (&x)[4],
                                      const float (&y)[4]) {
  float4* v = reinterpret_cast<float4*>(p);
  const float4 a = make_float4(x[0], y[0], x[1], y[1]);
  const float4 b = make_float4(x[2], y[2], x[3], y[3]);
  if constexpr (kCg) {
    __stcg(v, a);
    __stcg(v + 1, b);
  } else {
    v[0] = a;
    v[1] = b;
  }
}
template <bool kCg>
__device__ __forceinline__ void st_xy(double* p, const double (&x)[2],
                                      const double (&y)[2]) {
  double2* v = reinterpret_cast<double2*>(p);
  const double2 a = make_double2(x[0], y[0]);
  const double2 b = make_double2(x[1], y[1]);
  if constexpr (kCg) {
    __stcg(v, a);
    __stcg(v + 1, b);
  } else {
    v[0] = a;
    v[1] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
p2p2d_kernel(const T* __restrict__ pos, const int32_t* __restrict__ row_ptr,
             const uint32_t* __restrict__ col2d, int32_t* __restrict__ work,
             T* __restrict__ run, T* __restrict__ out, int Gb, int CB, int C,
             int nsub, int dmax, int K, T eps2) {
  using Tl = Tiling<T>;
  constexpr int TT = Tl::kT, P = Tl::kP, S = Tl::kStages;
  constexpr int LT = kTile / TT;          // lanes across a tile's targets
  constexpr int H = 32 / LT;              // ways the sources are split
  constexpr int kSlot = P * kPiece * 2;   // values of a ring slot
  constexpr int kChunks = kPiece * 2 * int(sizeof(T)) / 16;  // a piece's
  constexpr int kPer = P * kChunks / 32;  // 16-byte copies a lane a unit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* ring = reinterpret_cast<const T*>(smem_raw) + warp * S * kSlot;
  const unsigned ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int R = Gb * nsub, ntile = C / kTile, cpg = C / kPiece;
  const int shift = 32 - nsub;
  const uint32_t blkmask = (1u << shift) - 1u;
  const int32_t* plan = work;             // [R + 1]
  int32_t* next_item = work + R + 1;
  int32_t* done = work + R + 2;           // [R * ntile]
  const int X = plan[R];                  // the extra segments' items
  const int total = X + R * ntile;
  const int li = lane % LT, h = lane / LT;

  int item = 0;
  if (lane == 0) item = atomicAdd(next_item, 1);
  item = __shfl_sync(~0u, item, 0);
  while (item < total) {
    int ahead = 0;                        // the next item, fetched now
    if (lane == 0) ahead = atomicAdd(next_item, 1);

    // the item's (row, tile, segment) and the row's segment count
    int row, tile, seg, nseg;
    if (item < X) {                       // an extra segment: search the
      int lo = 0, hi = R;                 // plan, plan[lo] <= item <
      while (hi - lo > 1) {               // plan[hi], 32 ways a step
        const int stride = (hi - lo + 31) >> 5;
        const int p = lo + (lane + 1) * stride;
        const bool le = p < hi && plan[p] <= item;
        lo += __popc(__ballot_sync(~0u, le)) * stride;
        hi = min(hi, lo + stride);
      }
      const int p0 = plan[lo];
      const int d = (item - p0) / ntile;  // segments above this one
      row = lo;
      tile = item - p0 - d * ntile;
      nseg = (plan[lo + 1] - p0) / ntile + 1;
      seg = nseg - 1 - d;
    } else {                              // segment 0 of (row, tile)
      row = (item - X) / ntile;
      tile = item - X - row * ntile;
      seg = 0;
      nseg = 0;
    }
    const int deg = max(0, min(row_ptr[row + 1] - row_ptr[row], dmax));
    if (item >= X) nseg = deg > K ? (deg + K - 1) / K : 1;

    // the segment's entries, one a lane, and the pieces each selects
    const int e0 = seg * K;
    const int ne = min(K, deg - e0);
    uint32_t v = 0u;
    int npc = 0;
    if (lane < ne) {
      v = col2d[int64_t(row) * dmax + e0 + lane];
      if ((v & blkmask) < uint32_t(Gb)) npc = __popc(v >> shift) * cpg;
    }
    const int64_t t0 = int64_t(row) * C + tile * kTile + li * TT;
    T tx[TT], ty[TT];
    ldg_xy(pos + 2 * t0, tx, ty);
    if constexpr (Tl::kSkipPads) {
      // a tile whose 32 targets all are pads adds nothing (its sums stay
      // 0; every caller drops pad targets)
      bool real = false;
#pragma unroll
      for (int k = 0; k < TT; ++k) real |= !(tx[k] >= kPadX);
      if (!__any_sync(~0u, real)) npc = 0;
    }
    int incl = npc;                       // inclusive piece counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - npc;
    const int np = __shfl_sync(~0u, incl, 31);
    const int nunit = (np + P - 1) / P;

    // copy unit u (pieces [uP, uP + P) of the segment) into ring slot
    // `slot`: lane l < P finds piece uP + l's entry, lane group and chunk
    auto issue = [&](int u, int slot) {
      const int p = u * P + lane;
      int e = 0;                          // lanes whose incl <= p
#pragma unroll
      for (int b = 16; b > 0; b >>= 1)
        if (__shfl_sync(~0u, incl, e + b - 1) <= p) e += b;
      const uint32_t ve = __shfl_sync(~0u, v, e);
      const int start = __shfl_sync(~0u, excl, e);
      int off = 0;
      if (lane < P && p < np) {
        const int local = p - start, g = local / cpg;
        uint32_t bits = ve >> shift;
        for (int i = 0; i < g; ++i) bits &= bits - 1u;  // g-th set group
        off = (int(ve & blkmask) * CB + (__ffs(bits) - 1) * C +
               (local - g * cpg) * kPiece) * 2;
      }
      const int npieces = min(P, np - u * P);
      const unsigned dst = ring_s + slot * kSlot * int(sizeof(T));
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = lane + 32 * i;      // 16-byte chunk k of the slot
        const int pc = k / kChunks;
        const int o = __shfl_sync(~0u, off, pc);
        if (pc < npieces)
          cp_async16(dst + 16 * k, reinterpret_cast<const char*>(pos + o) +
                                       16 * (k % kChunks));
      }
    };

    T ax[TT], ay[TT];                     // the item's sums
    T px[TT], py[TT];                     // the current unit's partial
#pragma unroll
    for (int k = 0; k < TT; ++k) ax[k] = ay[k] = px[k] = py[k] = T(0);
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < nunit) issue(i, i);
      cp_async_commit();
    }
    for (int u = 0; u < nunit; ++u) {
      if (u + S - 1 < nunit) issue(u + S - 1, (u + S - 1) % S);
      cp_async_commit();
      cp_async_wait<S - 1>();             // this lane's copies of unit u
      __syncwarp();                       // ... and every lane's
      const T* sb = ring + (u % S) * kSlot;
      const int npieces = min(P, np - u * P);
      for (int pc = 0; pc < npieces; ++pc) {
#pragma unroll
        for (int i = 0; i < kPiece / (4 * H); ++i) {
          T sx[4], sy[4];
          load4(sb + (pc * kPiece + 4 * (h + H * i)) * 2, sx, sy);
          if constexpr (Tl::kSkipPads) {
            if (fminf(fminf(sx[0], sx[1]), fminf(sx[2], sx[3])) >= kPadX)
              continue;                   // four pads: d * w ~5e-19 each
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
#pragma unroll
            for (int k = 0; k < TT; ++k) {
              const T dx = tx[k] - sx[s];
              const T dy = ty[k] - sy[s];
              const T d2 = fma(dy, dy, fma(dx, dx, eps2));
              const T r = rsqrt_t(d2);
              const T w = r * r;
              px[k] = fma(dx, w, px[k]);
              py[k] = fma(dy, w, py[k]);
            }
          }
        }
      }
      __syncwarp();                       // the slot is read: refillable
#pragma unroll
      for (int k = 0; k < TT; ++k) {
        ax[k] += px[k];
        ay[k] += py[k];
        px[k] = py[k] = T(0);
      }
    }
    // the H source shares, in a fixed order: every lane the same bits
#pragma unroll
    for (int k = 0; k < TT; ++k) {
#pragma unroll
      for (int o = LT; o < 32; o <<= 1) {
        ax[k] += __shfl_xor_sync(~0u, ax[k], o);
        ay[k] += __shfl_xor_sync(~0u, ay[k], o);
      }
    }

    // the ordered sum of a row's segments, highest first
    if (nseg > 1) {
      const int f = row * ntile + tile;
      const int above = nseg - 1 - seg;   // segments committed before this
      if (above > 0) {
        if (lane == 0) {
          // the segment above runs on a warp (the item order), so a wait
          // of seconds is a fault: fail the launch rather than hang
          for (int n = 0; ld_acquire(done + f) < above; ++n) {
            if (n > (1 << 26)) __trap();
            __nanosleep(64);
          }
        }
        __syncwarp();
        if (h == 0) {
          T rx[TT], ry[TT];
          ldcg_xy(run + 2 * t0, rx, ry);
#pragma unroll
          for (int k = 0; k < TT; ++k) {
            ax[k] = rx[k] + ax[k];
            ay[k] = ry[k] + ay[k];
          }
        }
      }
      if (seg > 0) {
        if (h == 0) st_xy<true>(run + 2 * t0, ax, ay);
        __threadfence();
        __syncwarp();
        if (lane == 0) st_release(done + f, above + 1);
      }
    }
    if (seg == 0 && h == 0) st_xy<false>(out + 2 * t0, ax, ay);
    item = __shfl_sync(~0u, ahead, 0);
  }
}

template <typename T>
int launch(const T* pos, const int32_t* row_ptr, const int32_t* col2d,
           int32_t* work, T* run, T* out, int Gb, int CB, int nsub, int dmax,
           int K, T eps2, void* stream) {
  if (Gb < 1 || nsub < 1 || nsub > 8 || CB % nsub != 0 ||
      (CB / nsub) % kPiece != 0 || dmax < 1 || K < 1 || K > kMaxK ||
      int64_t(Gb) * CB * 2 >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pos) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(run) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  constexpr int smem =
      kWarps * Tiling<T>::kStages * Tiling<T>::kP * kPiece * 2 * sizeof(T);
  static_assert(smem <= 48 * 1024, "the rings need no shared-memory opt-in");
  // the persistent grid: every block that fits, found at the first launch
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, p2p2d_kernel<T>, kThreads, smem) != cudaSuccess)
      return 0;
    return sms * per_sm;
  }();
  if (blocks < 1) return int(cudaErrorInvalidConfiguration);
  p2p2d_kernel<T><<<unsigned(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      pos, row_ptr, reinterpret_cast<const uint32_t*>(col2d), work, run, out,
      Gb, CB, CB / nsub, nsub, dmax, K, eps2);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the float (co_p2p2d_launch) or double (co_p2p2d_launch_f64)
// instantiation on `stream`; each returns the cudaError_t of the launch (0
// on success).  `work` comes from p2p_cuda.segment_plan with the same K.
// The caller checks shapes; this re-checks what would make the launch
// itself wrong.
extern "C" int co_p2p2d_launch(const float* pos, const int32_t* row_ptr,
                               const int32_t* col2d, int32_t* work,
                               float* run, float* out, int Gb, int CB,
                               int nsub, int dmax, int K, float eps2,
                               void* stream) {
  return launch<float>(pos, row_ptr, col2d, work, run, out, Gb, CB, nsub,
                       dmax, K, eps2, stream);
}

extern "C" int co_p2p2d_launch_f64(const double* pos, const int32_t* row_ptr,
                                   const int32_t* col2d, int32_t* work,
                                   double* run, double* out, int Gb, int CB,
                                   int nsub, int dmax, int K, double eps2,
                                   void* stream) {
  return launch<double>(pos, row_ptr, col2d, work, run, out, Gb, CB, nsub,
                        dmax, K, eps2, stream);
}
