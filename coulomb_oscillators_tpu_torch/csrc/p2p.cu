// Near-field (P2P) pass of the kd-tree FMM, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py
// in dim 3 (weight r^3): _p2p_kernel (p2p_leaf_pairs, the VMEM-resident
// form) and _p2p_stream_kernel (p2p_leaf_pairs_streaming, the
// HBM-streaming form).  Their dim-2 bodies (weight r^2) are csrc/p2p2d.cu,
// designed for fmm2_kd's short, skewed rows.
// On Hopper they are one kernel: no SM's shared memory holds every source,
// so partner blocks are gathered from global memory through L2 (the block
// coordinates are 12 MB at N = 1M and stay in the 50 MB L2).
//
// What bounds it.  At N = 1M on the main path's engine (Gb = 8192 blocks
// of CB = 128 slots, nsub = 4 sub-leaves of C = 32; chip_smoke.py phase 3
// prints these counts) the partner lists hold 2,195,685 (sub-leaf, block)
// entries and 6.51e9 slot pairs, 5.92e9 of them real (a real target and a
// real source).  At 20 FP32 flops a pair the real pairs need 1.77 ms of the
// card's 67 TFLOP/s; one rsqrt a pair needs 1.42 ms of the special-function
// units (132 SMs x 16 a clock at 1.98 GHz); the bytes (positions read and
// written once, the list entries) need 0.01 ms.  So FP32 issue bounds it.
// The inner loop issues ~13.25 instructions a pair (3 FADD, 6 FFMA, 2 FMUL
// and the MUFU.RSQ, 12 of which this formula cannot drop, plus a share of
// the three 16-byte loads, the pad test and the loop).
//
// The earlier design (one warp per sub-leaf, one thread per target) ran at
// ~18% of that bound, for three reasons; what this design does about each:
//
//  1. Per-entry overhead.  A warp staged each partner block alone with
//     lane-strided 4-byte loads and no copy in flight while it computed,
//     and it staged whole blocks where the mask selected some lane groups.
//     Now each warp streams its work through a ring of kStages slots (3 in
//     float, 2 in double) of 16-byte cp.async.cg copies: the copies of the
//     next units (a unit is one partner entry's chunk of at most kU source
//     slots, 1.5 KB) are in flight while the current one computes, and only
//     the pieces of selected lane groups are copied.  List entries are read
//     32 at a time, one per lane, a window ahead, and passed out with
//     shuffles; the block's targets sit in shared memory.  Where a source
//     block fits one unit (CB <= kU, the main path's case) a second
//     instantiation drops the chunk bookkeeping: 8% off that case.
//  2. The pair loop.  One thread owned one target and read each source as
//     three 4-byte broadcasts.  Now a warp owns a tile of kTile = 32
//     targets and each lane kT of them (4 in float, 2 in double): the lanes
//     split the tile's targets 32 / kT ways and the sources H = kT ways
//     (interleaved 4-source packets).  A packet is three aligned 16-byte
//     shared loads (six in double) that feed 4 x kT pairs: 0.19 loads a
//     pair in float against 3.  A fixed butterfly of __shfl_xor_sync adds
//     the H source shares at the end of a tile, so every lane ends with
//     bitwise the same sum.  The float rsqrt is rsqrt.approx.ftz.f32: with
//     rsqrtf and no -ftz the SASS wrapped each MUFU.RSQ in a denormal
//     fix-up (FSETP and two predicated FMULs); the shared NVCC_FLAGS stay
//     as they are, so direct.cu does not move.
//  3. The tail.  Rows are skewed (median 60 entries, max 1,728), and one
//     warp per row left a ~5M-pair row to one warp.  Now a CUDA block of
//     kWarps = 8 warps owns kSlots = 128 target slots (4 tiles) and deals
//     the tiles' entries round-robin to its warps; each warp writes its
//     share of each tile to shared memory and the block adds the 8 shares
//     in warp order, so each target is written once, with no atomics.  The
//     wrapper passes `order`, the blocks sorted by their entry count
//     (heaviest first, a stable sort), so the heaviest blocks start first;
//     order may be null (grid order).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/p2p_bench.py, PERF.md):
// the main path's case takes ~4.0 ms against 9.6 ms for the earlier
// design in the same call, ~44% of its 1.77 ms bound; the tree_L = 10 case
// (units of 128 sources) reaches ~53%.  What is left is per-unit work
// (~93 pairs a lane a unit at C = 32, against ~250 instructions of unit
// bookkeeping and copies).  A 2-, 3- or 4-slot ring, a weight-balanced
// split of the block's entries, 4 or 16 warps a block, 256 slots a block,
// 2 targets a lane, 3 resident blocks and an unrolled packet loop were
// each measured and none was faster on that case.  L2 traffic does not
// bound it: the selected lane groups are ~2.4 GB a call, ~0.6 TB/s, and
// the ring depth, which would move a kernel that waits on L2, did not move
// it; so the block's 4 sub-leaves (which fetch each shared partner block
// ~3 times) do not share their staging.
//
// Pads.  Pad slots sit at FAR = 1e18 and trail each sub-leaf.  In float a
// pad source's weight underflows to exactly 0 for every real target: d2 ~
// 3e36, r ~ 5.8e-19, r*r = 3.3e-37 (normal) and r*r*r ~ 2e-55 flushes to 0
// (below the least denormal, ftz or not), and d * w = -1e18 * 0 = -0: d is
// finite and w <= eps2^-1.5 = 1e27 at the default eps = 1e-9, so inf * 0
// never forms.  So the float instantiation skips a 4-source packet whose
// four x are >= kPadX, and a 32-target tile whose targets all are (a pad
// target's sum is exactly 0 there: d = 0 against pads, w = 0 against real
// sources).  Neither changes a result.  In double r^3 of a pad is 1e-54
// and does not underflow: each pad source adds ~1e-36, as the reference's
// sum does, so double skips nothing.
//
// Sums.  Each lane sums each partner entry (all chunks of one partner
// block) into a partial and adds the partials in partner order: one
// running sum over the ~30k pairs of a CB = 1024 target drifted to 1.6e-4
// of max|a| against a float64 sum.  The warps' shares and the H source
// shares are added in a fixed order, so the result does not depend on
// `order` or on timing.
//
// Registers and shared memory: __launch_bounds__(256, 2) in float (122
// registers, no spill) and (256, 3) in double (80 registers and ~200-300
// bytes of spill, faster than 2 blocks without spills); nvcc
// -Xptxas -v prints both, and chip_smoke phase 2 shows them.  Shared memory
// per block: the rings, 8 x 128 x 3 values of warp shares and the 128
// targets: 49.5 KB in float, 51 KB in double, set as the kernel's
// dynamic limit before each launch.
//
// Out of scope.  Newton-3 (each pair once, for both ends) needs atomics or
// a second pass and breaks "each target written once, deterministic".  The
// tensor cores: the |a|^2 + |b|^2 - 2ab matmul form cancels
// catastrophically in float32 for close pairs
// (coulomb_oscillators_tpu/ops/fmm/kdtree.py, _stage_p2p docstring).
//
// Contract (the same as the reference kernel's, without its flattened
// [Gb, CB*8] operand):
//   pos     [Gb, CB, 3] float or double, 16-byte aligned: Gb target/source
//           blocks of CB slots, nsub <= 8 sub-leaves of C = CB/nsub slots
//           each, C a multiple of 32; pad slots sit at FAR = 1e18 and
//           trail each sub-leaf.
//   row_ptr [Gb*nsub + 1] int32: CSR degrees of each sub-leaf's partner
//           list (a degree above dmax is clamped to dmax).
//   col2d   [Gb*nsub, dmax] int32, read as uint32: entry = blk | bits << s,
//           s = 32 - nsub; bit q of `bits` selects lane group q (slots
//           [qC, (q+1)C)) of source block `blk`.  Block id Gb is the FAR
//           sentinel, which contributes exactly zero in float; it is
//           skipped, as are entries with no bit set.
//   order   [Gb * ceil(CB/min(CB,128))] int32 or null: the CUDA blocks'
//           order of work (any permutation).
//   out     [Gb, CB, 3] as pos, each target written exactly once (no
//           atomics), in a deterministic order.
// Pair weight: r = rsqrt(dist2), w = r*r*r.  Never dist2^-1.5 through
// dist2^3: at a FAR pad dist2 ~ 3e36 cubes to inf and inf * 0 is NaN.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                  // target slots of one warp tile
constexpr int kSlots = 128;                // target slots per CUDA block
constexpr int kMaxTiles = kSlots / kTile;

template <typename T> struct Tiling;
template <> struct Tiling<float> {
  static constexpr int kT = 4;             // targets per lane
  static constexpr int kU = 128;           // source slots per stage unit
  static constexpr bool kSkipPads = true;  // pad weights are exactly 0
  static constexpr int kMinBlocks = 2;     // resident blocks per SM
  static constexpr int kStages = 3;        // ring slots per warp
};
template <> struct Tiling<double> {
  static constexpr int kT = 2;
  static constexpr int kU = 64;
  static constexpr bool kSkipPads = false; // pads add ~1e-36 each
  static constexpr int kMinBlocks = 3;
  static constexpr int kStages = 2;
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

// four staged sources (x, y, z interleaved, 16-byte aligned) as SoA
__device__ __forceinline__ void load4(const float* sp, float (&x)[4],
                                      float (&y)[4], float (&z)[4]) {
  const float4* v = reinterpret_cast<const float4*>(sp);
  const float4 a = v[0], b = v[1], c = v[2];
  x[0] = a.x; y[0] = a.y; z[0] = a.z;
  x[1] = a.w; y[1] = b.x; z[1] = b.y;
  x[2] = b.z; y[2] = b.w; z[2] = c.x;
  x[3] = c.y; y[3] = c.z; z[3] = c.w;
}
__device__ __forceinline__ void load4(const double* sp, double (&x)[4],
                                      double (&y)[4], double (&z)[4]) {
  const double2* v = reinterpret_cast<const double2*>(sp);
  const double2 a = v[0], b = v[1], c = v[2], d = v[3], e = v[4], f = v[5];
  x[0] = a.x; y[0] = a.y; z[0] = b.x;
  x[1] = b.y; y[1] = c.x; z[1] = c.y;
  x[2] = d.x; y[2] = d.y; z[2] = e.x;
  x[3] = e.y; y[3] = f.x; z[3] = f.y;
}

// one stage unit: chunk `chunk` (slots [chunk*U, +U)) of source block
// `blk` for item `item` (an entry of tile `tile`); the chunk meets lane
// groups q0..q1, and bit i of `mask` selects group q0 + i
struct Unit {
  int item, tile, chunk, q0, q1;
  uint32_t blk, mask;
};

// one CUDA block: kSlots target slots [t0, t0 + kSlots) of target block g;
// kWhole: a source block fits one stage unit (CB <= kU), the main path's
// case, compiled without the chunk bookkeeping
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads, Tiling<T>::kMinBlocks)
p2p_kernel(const T* __restrict__ pos, const int32_t* __restrict__ row_ptr,
           const uint32_t* __restrict__ col2d,
           const int32_t* __restrict__ order, T* __restrict__ out, int Gb,
           int CB, int C, int nsub, int dmax, T eps2) {
  constexpr int TT = Tiling<T>::kT, U0 = Tiling<T>::kU;
  constexpr int kStages = Tiling<T>::kStages;
  constexpr int LT = kTile / TT;          // lanes across a tile's targets
  constexpr int H = 32 / LT;              // ways the sources are split
  constexpr int RING = kStages * U0 * 3;  // one warp's ring, in values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);       // [kWarps][kStages][U0*3]
  T* comb = ring + kWarps * RING;                 // [kWarps][kSlots * 3]
  T* tgt_s = comb + kWarps * kSlots * 3;          // [kSlots * 3] targets
  __shared__ int s_pre[kMaxTiles + 1];   // prefix of the tiles' entry counts
  __shared__ int s_row[kMaxTiles];       // each tile's partner row

  const int S = min(CB, kSlots);
  const int nsc = (CB + S - 1) / S;
  const int b = order ? order[blockIdx.x] : int(blockIdx.x);
  const int g = b / nsc;
  const int t0 = (b - g * nsc) * S;
  const int ntile = min(S, CB - t0) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int U = min(CB, U0);
  const int nchunk = (CB + U - 1) / U;
  const int shift = 32 - nsub;
  const uint32_t blkmask = (1u << shift) - 1u;

  // the block's targets into shared memory; each tile's partner row and
  // clamped degree
  const T* tgt = pos + (int64_t(g) * CB + t0) * 3;
  for (int k = threadIdx.x; k < ntile * kTile * 3; k += kThreads)
    tgt_s[k] = tgt[k];
  for (int t = threadIdx.x; t < ntile; t += kThreads) {
    const int row = g * nsub + (t0 + t * kTile) / C;
    s_row[t] = row;
    s_pre[t + 1] = min(row_ptr[row + 1] - row_ptr[row], dmax);
  }
  __syncthreads();
  // a float tile whose 32 targets all are pads gets no entries: its sums
  // stay 0, which is exactly what its pairs would add
  if constexpr (Tiling<T>::kSkipPads) {
    for (int t = warp; t < ntile; t += kWarps)
      if (!__any_sync(~0u, !(tgt_s[(t * kTile + lane) * 3] >= kPadX)) &&
          lane == 0)
        s_pre[t + 1] = 0;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s_pre[0] = 0;
    for (int t = 1; t <= ntile; ++t) s_pre[t] += s_pre[t - 1];
  }
  __syncthreads();

  // the block's items (tile-major partner entries) dealt round-robin:
  // warp w takes items w, w + kWarps, ...
  const int W = s_pre[ntile];
  T* wring = ring + warp * RING;
  T* wcomb = comb + warp * kSlots * 3;
  for (int k = lane; k < kSlots * 3; k += 32) wcomb[k] = T(0);
  __syncwarp();

  constexpr int kStride = kWarps;        // warp w takes items w, w + 8, ..
  const int it0 = warp, it1 = W;
  // lane l of a window holds item base + l * kStride: its entry and tile
  auto window = [&](int base, uint32_t& v, int& tile) {
    const int x = base + lane * kStride;
    if (x < it1) {
      int t = 0;
      while (x >= s_pre[t + 1]) ++t;
      tile = t;
      v = col2d[int64_t(s_row[t]) * dmax + (x - s_pre[t])];
    }
  };
  // the producer's cursor: item `it`, its next chunk, the current window
  // (from item wbase) and the next one, loaded a window ahead
  int it = it0, chunk = 0, wbase = it0;
  int ctile = 0, cq = 0, wtile = 0, wtile2 = 0;
  uint32_t cblk = 0, cbits = 0, wv = 0, wv2 = 0;
  window(wbase, wv, wtile);
  window(wbase + 32 * kStride, wv2, wtile2);
  auto next = [&](Unit& u) -> bool {
    while (it < it1) {
      if (chunk == 0) {
        if (it - wbase >= 32 * kStride) {
          wbase += 32 * kStride;
          wv = wv2;
          wtile = wtile2;
          window(wbase + 32 * kStride, wv2, wtile2);
        }
        const int l = (it - wbase) / kStride;
        const uint32_t v = __shfl_sync(~0u, wv, l);
        ctile = __shfl_sync(~0u, wtile, l);
        cblk = v & blkmask;
        cbits = v >> shift;
        cq = 0;
        if (cblk >= uint32_t(Gb) || cbits == 0u) {
          it += kStride;
          continue;
        }
        if constexpr (kWhole) {
          u.item = it;
          u.tile = ctile;
          u.chunk = u.q0 = 0;
          u.q1 = nsub - 1;
          u.blk = cblk;
          u.mask = cbits;
          it += kStride;
          return true;
        }
      }
      // lane groups q0..q1 that the chunk meets (no division)
      const int c0 = chunk * U, cend = c0 + min(U, CB - c0);
      while ((cq + 1) * C <= c0) ++cq;
      int q1 = cq;
      while ((q1 + 1) * C < cend) ++q1;
      u.item = it;
      u.tile = ctile;
      u.chunk = chunk;
      u.q0 = cq;
      u.q1 = q1;
      u.blk = cblk;
      u.mask = (cbits >> cq) & ((2u << (q1 - cq)) - 1u);
      if (++chunk == nchunk) {
        chunk = 0;
        it += kStride;
      }
      if (u.mask) return true;
    }
    return false;
  };

  // copy the selected lane groups of a unit's chunk into ring slot `slot`
  // in 16-byte pieces (a lane group is C * 3 values, a multiple of 16
  // bytes); a piece's group is found with a float reciprocal, exact here
  const int pieces = C * 3 * int(sizeof(T)) / 16;
  const float inv_pieces = 1.0f / float(pieces);
  // a full unit is U0 * 3 values = 96 pieces, 3 a lane
  constexpr int kPieces = U0 * 3 * int(sizeof(T)) / (16 * 32);
  const unsigned ring_s = static_cast<unsigned>(
      __cvta_generic_to_shared(wring)) + 16 * lane;
  auto issue = [&](const Unit& u, int slot) {
    const int c0 = kWhole ? 0 : u.chunk * U;
    const int n16 = (kWhole ? CB : min(U, CB - c0)) * 3 * int(sizeof(T)) / 16;
    const int off16 = (c0 - u.q0 * C) * 3 * int(sizeof(T)) / 16;
    const char* src = reinterpret_cast<const char*>(
        pos + (int64_t(u.blk) * CB + c0) * 3) + 16 * lane;
    const unsigned dst = ring_s + slot * U0 * 3 * int(sizeof(T));
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int k = lane + 32 * i;
      const int q = int((float(off16 + k) + 0.5f) * inv_pieces);
      if (k < n16 && ((u.mask >> q) & 1u))
        cp_async16(dst + 512 * i, src + 512 * i);
    }
  };

  const int li = lane % LT, h = lane / LT;
  T tx[TT], ty[TT], tz[TT];
  T px[TT], py[TT], pz[TT];              // the current entry's partial
  T ax[TT], ay[TT], az[TT];              // this warp's share of the tile
#pragma unroll
  for (int k = 0; k < TT; ++k) {
    tx[k] = ty[k] = tz[k] = T(0);
    px[k] = py[k] = pz[k] = ax[k] = ay[k] = az[k] = T(0);
  }
  int loaded = -1;                       // tile whose targets are in tx..

  // un[0] computes while un[1..kStages-1] are in flight
  Unit un[kStages];
  bool has[kStages];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    has[i] = (i == 0 || has[i > 0 ? i - 1 : 0]) && next(un[i]);
    if (has[i]) issue(un[i], i);
    cp_async_commit();
  }
  int slot = 0;
  while (has[0]) {
    constexpr int L = kStages - 1;
    has[L] = has[L - 1] && next(un[L]);
    __syncwarp();                        // the slot un[L] reuses is read
    if (has[L]) issue(un[L], (slot + L) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // this lane's copies of un[0]
    __syncwarp();                        // ... and every lane's
    const Unit& cur = un[0];
    if (cur.tile != loaded) {
      loaded = cur.tile;
      const T* tp = tgt_s + (cur.tile * kTile + li * TT) * 3;
#pragma unroll
      for (int k = 0; k < TT; ++k) {
        tx[k] = tp[3 * k];
        ty[k] = tp[3 * k + 1];
        tz[k] = tp[3 * k + 2];
      }
    }
    const T* sb = wring + slot * U0 * 3;
    const int c0 = kWhole ? 0 : cur.chunk * U;
    const int cend = kWhole ? CB : c0 + min(U, CB - c0);
    for (int q = cur.q0; q <= cur.q1; ++q) {
      if (!((cur.mask >> (q - cur.q0)) & 1u)) continue;
      const int j1 = min((q + 1) * C, cend) - c0;
      for (int j = max(q * C, c0) - c0 + 4 * h; j < j1; j += 4 * H) {
        T sx[4], sy[4], sz[4];
        load4(sb + 3 * j, sx, sy, sz);
        if constexpr (Tiling<T>::kSkipPads) {
          if (fminf(fminf(sx[0], sx[1]), fminf(sx[2], sx[3])) >= kPadX)
            continue;                    // four pads: weight exactly 0
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int k = 0; k < TT; ++k) {
            const T dx = tx[k] - sx[s];
            const T dy = ty[k] - sy[s];
            const T dz = tz[k] - sz[s];
            const T d2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2)));
            const T r = rsqrt_t(d2);
            const T w = r * r * r;
            px[k] = fma(dx, w, px[k]);
            py[k] = fma(dy, w, py[k]);
            pz[k] = fma(dz, w, pz[k]);
          }
        }
      }
    }
    if (!has[1] || un[1].item != cur.item) {   // partner entry done
#pragma unroll
      for (int k = 0; k < TT; ++k) {
        ax[k] += px[k];
        ay[k] += py[k];
        az[k] += pz[k];
        px[k] = py[k] = pz[k] = T(0);
      }
    }
    if (!has[1] || un[1].tile != cur.tile) {   // this warp's share done
#pragma unroll
      for (int k = 0; k < TT; ++k) {
#pragma unroll
        for (int o = LT; o < 32; o <<= 1) {
          ax[k] += __shfl_xor_sync(~0u, ax[k], o);
          ay[k] += __shfl_xor_sync(~0u, ay[k], o);
          az[k] += __shfl_xor_sync(~0u, az[k], o);
        }
      }
      if (h == 0) {
        T* cp = wcomb + (cur.tile * kTile + li * TT) * 3;
#pragma unroll
        for (int k = 0; k < TT; ++k) {
          cp[3 * k] = ax[k];
          cp[3 * k + 1] = ay[k];
          cp[3 * k + 2] = az[k];
        }
      }
#pragma unroll
      for (int k = 0; k < TT; ++k) ax[k] = ay[k] = az[k] = T(0);
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      un[i] = un[i + 1];
      has[i] = has[i + 1];
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  __syncthreads();

  // each target: the warps' shares in warp order, written once
  T* op = out + (int64_t(g) * CB + t0) * 3;
  for (int k = threadIdx.x; k < ntile * kTile * 3; k += kThreads) {
    T s = comb[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += comb[w * kSlots * 3 + k];
    op[k] = s;
  }
}

template <typename T>
int launch(const T* pos, const int32_t* row_ptr, const int32_t* col2d,
           const int32_t* order, T* out, int Gb, int CB, int nsub, int dmax,
           T eps2, void* stream) {
  if (Gb < 1 || nsub < 1 || nsub > 8 || CB % nsub != 0 ||
      (CB / nsub) % 32 != 0 || dmax < 1)
    return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pos) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const int S = CB < kSlots ? CB : kSlots;
  const int64_t blocks = int64_t(Gb) * ((CB + S - 1) / S);
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int smem =
      (kWarps * (Tiling<T>::kStages * Tiling<T>::kU + kSlots) + kSlots) * 3 *
      int(sizeof(T));
  const auto kernel = CB <= Tiling<T>::kU ? p2p_kernel<T, true>
                                          : p2p_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<unsigned(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      pos, row_ptr, reinterpret_cast<const uint32_t*>(col2d), order, out, Gb,
      CB, CB / nsub, nsub, dmax, eps2);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the float / double instantiation on `stream`; each returns the
// cudaError_t of the launch (0 on success).  `order` may be null.  The
// caller checks shapes; this re-checks what would make the launch itself
// wrong.
extern "C" int co_p2p_launch(const float* pos, const int32_t* row_ptr,
                             const int32_t* col2d, const int32_t* order,
                             float* out, int Gb, int CB, int nsub, int dmax,
                             float eps2, void* stream) {
  return launch<float>(pos, row_ptr, col2d, order, out, Gb, CB, nsub, dmax,
                       eps2, stream);
}

extern "C" int co_p2p_launch_f64(const double* pos, const int32_t* row_ptr,
                                 const int32_t* col2d, const int32_t* order,
                                 double* out, int Gb, int CB, int nsub,
                                 int dmax, double eps2, void* stream) {
  return launch<double>(pos, row_ptr, col2d, order, out, Gb, CB, nsub, dmax,
                        eps2, stream);
}
