// Direct O(N^2) softened-Coulomb force, hand-written for Hopper (sm_90a).
//
// Replaces coulomb_oscillators_tpu/ops/direct.py: _direct_kernel (:161,
// called through `direct` at :204), the Pallas kernel tiled over (target,
// source) blocks that accumulates each target tile across the sequential
// source axis of its grid.  On Hopper the source axis is not sequential:
// blocks run in no order, so the source range is split over a second grid
// dimension and a second pass sums the splits in a fixed order.
//
// What bounds it on the H100.  A pair costs 20 flops in 3D, 14 in 2D
// (utils/roofline.py), and one special-function op.  In 3D that is 11
// FP32 instructions (3 FADD, 3 FFMA for |d|^2 + eps2, 2 FMUL for r^3, 3
// FFMA into the sum) beside one MUFU.RSQ: FP32 issue bounds it, ~0.30 ms
// at the CLI's N = 30001 (9.0e8 pairs) against the 0.269 ms flop bound.
// In 2D the pair is 6 FP32 instructions and one MUFU.RCP, and the
// special-function units (16 a clock per SM) bound it: 0.215 ms.  The
// sources are 360 KB at N = 30001 and stay in L2; bytes bound nothing.
//
// The earlier design (one target a thread, sources staged as three float
// arrays, a correctly rounded reciprocal times rsqrtf) issued ~32 (3D) /
// 24 (2D) instructions a pair in its inner loop and ran at 27% (3D) / 31%
// (2D) of the bound.  What this design does:
//
//  1. One special-function op a pair, with no fix-ups: 3D takes
//     r = rsqrt.approx.ftz.f32(dist2), w = r*r*r; 2D takes
//     w = rcp.approx.ftz.f32(dist2).  Inline PTX, so the shared build
//     flags keep no -ftz; rsqrtf without it wraps each MUFU.RSQ in a
//     denormal fix-up, and __frcp_rn adds Newton steps and a slow path.
//     The approximations keep the reference's contract with room (mean
//     relative error against Kahan at n = 1000: ~1.1e-7 in 3D, ~9e-8 in
//     2D, bound 1e-6), so no Newton step is added.
//  2. Register-tiled targets: each thread owns kT targets (8 in 3D, 4 in
//     2D), strided by kThreads so the loads and stores are coalesced.
//     The block's source tile sits in shared memory as float4: (x, y, z,
//     0) in 3D, two sources (x0, y0, x1, y1) in 2D, so one 16-byte
//     broadcast load feeds 8 pairs.  In 3D the eight pairs of a source
//     are written in stages (the eight dist2, then the eight rsqrt, then
//     the sums) and the launch bounds leave 128 registers (2 blocks a SM),
//     so more independent pairs are in flight per warp.  Each target
//     keeps a partial sum per tile, added into its running sum after the
//     tile (a two-level sum that bounds float32 drift over long source
//     ranges).
//     A full tile runs an unrolled loop; the last tile of a split may be
//     ragged and takes a loop bounded by its count, so no source at or
//     past N is ever read.  Targets at or past N are computed on the
//     coordinates of target N-1 and never written.
//  3. Filling the card: with 2048 (3D) / 1024 (2D) targets a block there
//     are few target blocks (15 / 30 at N = 30001), so the wrapper cuts
//     the source range into S splits (grid.y) of `src_per_split` sources,
//     a multiple of 32, the count whose grid fills its last wave of
//     resident slots best (co_direct_geometry reports the block's targets
//     and the resident blocks a SM).  Each split writes its partial sums to part[S, N, D];
//     sum_splits adds them in split order, so the result is bitwise
//     repeatable, with no atomics.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; direct_bench.py,
// PERF.md): the 3D pair loop issues 12.3 instructions a pair (SASS) and
// runs at ~0.41 ms at N = 30001, ~80% of the issue rate.  A 64-register
// build without the MUFU ran at 77% of its own, and more independent
// pairs a warp (8 targets at 128 registers against 4 at 80) gained 7%: the
// dependent FP32 chain of each pair within the register budget, not the
// special-function units, holds it.  2D issues 7.2 a pair and runs at
// ~0.26 ms, ~82% of the MUFU bound.
//
// The pair sum stays off the tensor cores: the |a|^2 + |b|^2 - 2ab matmul
// form cancels in float32 for close pairs.
//
// Contract (the reference kernel's):
//   pos  [N, D] float32, D in {2, 3}, row-major.
//   out  [N, D] float32: out_i = kappa * sum_j d * w, d = p_i - p_j,
//        dist2 = |d|^2 + eps2, w = dist2^(-3/2) in 3D and 1/dist2 in 2D.
//        The self pair has d = 0 and adds exactly 0.  The source loop is
//        bounded at N, so no padded source is ever read (the 2D weight of
//        a pad would not underflow).
//   part [S, N, D] float32 scratch (unused when S == 1).
// The targets may be another array than the sources (co_direct_launch_ts:
// tgt [Nt, D] against src [Ns, D], out and part over the Nt targets): the
// block-on-block force of the sharded direct engines (parallel/mesh.py),
// where a rank's rows meet a visiting block.  The kernel is the same; the
// all-pairs entry passes one array as both.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads per CUDA block
constexpr int kSrc = 256;        // sources per staged tile

template <int DIM> struct Geo;
template <> struct Geo<3> {
  static constexpr int kT = 8;           // targets per thread
  static constexpr int kVec = kSrc;      // float4 per tile: one source each
  static constexpr int kUnroll = 8;      // float4 loads a full-tile step
  static constexpr int kMinBlocks = 2;   // resident blocks a SM (<= 128 regs)
};
template <> struct Geo<2> {
  static constexpr int kT = 4;
  static constexpr int kVec = kSrc / 2;  // two sources per float4
  static constexpr int kUnroll = 16;
  static constexpr int kMinBlocks = 4;   // (<= 64 registers)
};

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// one source against the thread's T targets, 3D
template <int T>
__device__ __forceinline__ void pairs3(float sx, float sy, float sz,
                                       const float (&tx)[T],
                                       const float (&ty)[T],
                                       const float (&tz)[T], float eps2,
                                       float (&bx)[T], float (&by)[T],
                                       float (&bz)[T]) {
  float dx[T], dy[T], dz[T], r[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    dx[t] = tx[t] - sx;
    dy[t] = ty[t] - sy;
    dz[t] = tz[t] - sz;
    r[t] = fmaf(dz[t], dz[t], fmaf(dy[t], dy[t], fmaf(dx[t], dx[t], eps2)));
  }
#pragma unroll
  for (int t = 0; t < T; ++t) r[t] = rsqrt_approx(r[t]);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float w = r[t] * r[t] * r[t];
    bx[t] = fmaf(dx[t], w, bx[t]);
    by[t] = fmaf(dy[t], w, by[t]);
    bz[t] = fmaf(dz[t], w, bz[t]);
  }
}

// one source against the thread's T targets, 2D
template <int T>
__device__ __forceinline__ void pairs2(float sx, float sy,
                                       const float (&tx)[T],
                                       const float (&ty)[T], float eps2,
                                       float (&bx)[T], float (&by)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float dx = tx[t] - sx;
    const float dy = ty[t] - sy;
    const float w = rcp_approx(fmaf(dy, dy, fmaf(dx, dx, eps2)));
    bx[t] = fmaf(dx, w, bx[t]);
    by[t] = fmaf(dy, w, by[t]);
  }
}

// sources [j0, j0 + m) into the tile, m <= kSrc
template <int DIM>
__device__ __forceinline__ void stage(float4* tile, const float* pos,
                                      int64_t j0, int m) {
  if (DIM == 3) {
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const float* p = pos + (j0 + k) * 3;
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
  } else {
    for (int q = threadIdx.x; 2 * q < m; q += kThreads) {
      const float* p = pos + (j0 + 2 * q) * 2;
      const bool two = 2 * q + 1 < m;          // the odd last one is alone
      tile[q] = make_float4(p[0], p[1], two ? p[2] : 0.f, two ? p[3] : 0.f);
    }
  }
}

// grid (ceil(Nt / (kThreads * kT)), S); split s sums the sources
// [s * per, min((s + 1) * per, Ns)) of `pos` on the `nt` targets of `tgt`
// (the same array in the all-pairs case: both are only read, so the
// qualifiers hold) and writes out[s, i] (S > 1, unscaled) or kappa * sum
// (S == 1)
template <int DIM>
__global__ void __launch_bounds__(kThreads, Geo<DIM>::kMinBlocks)
direct_kernel(const float* __restrict__ tgt, const float* __restrict__ pos,
              float* __restrict__ out, int nt, int n, int per, float eps2,
              float scale) {
  constexpr int T = Geo<DIM>::kT;
  constexpr int V = Geo<DIM>::kVec;
  __shared__ float4 tile[V];
  const int64_t i0 = int64_t(blockIdx.x) * (kThreads * T) + threadIdx.x;
  float tx[T], ty[T], tz[T];
  float ax[T], ay[T], az[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    int64_t i = i0 + int64_t(t) * kThreads;
    if (i >= nt) i = nt - 1;                 // computed, never written
    tx[t] = tgt[i * DIM];
    ty[t] = tgt[i * DIM + 1];
    tz[t] = DIM == 3 ? tgt[i * DIM + 2] : 0.f;
    ax[t] = ay[t] = az[t] = 0.f;
  }
  const int64_t j_begin = int64_t(blockIdx.y) * per;
  const int64_t j_end = j_begin + per < n ? j_begin + per : int64_t(n);
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kSrc) {
    const int m = j_end - j0 < kSrc ? int(j_end - j0) : kSrc;
    __syncthreads();                         // previous tile fully read
    stage<DIM>(tile, pos, j0, m);
    __syncthreads();
    float bx[T], by[T], bz[T];
#pragma unroll
    for (int t = 0; t < T; ++t) bx[t] = by[t] = bz[t] = 0.f;
    if (m == kSrc) {
#pragma unroll (Geo<DIM>::kUnroll)
      for (int k = 0; k < V; ++k) {
        const float4 s = tile[k];
        if (DIM == 3) {
          pairs3<T>(s.x, s.y, s.z, tx, ty, tz, eps2, bx, by, bz);
        } else {
          pairs2<T>(s.x, s.y, tx, ty, eps2, bx, by);
          pairs2<T>(s.z, s.w, tx, ty, eps2, bx, by);
        }
      }
    } else if (DIM == 3) {
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        const float4 s = tile[k];
        pairs3<T>(s.x, s.y, s.z, tx, ty, tz, eps2, bx, by, bz);
      }
    } else {
#pragma unroll 2
      for (int q = 0; q < m / 2; ++q) {
        const float4 s = tile[q];
        pairs2<T>(s.x, s.y, tx, ty, eps2, bx, by);
        pairs2<T>(s.z, s.w, tx, ty, eps2, bx, by);
      }
      if (m & 1) {
        const float4 s = tile[m / 2];
        pairs2<T>(s.x, s.y, tx, ty, eps2, bx, by);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ax[t] += bx[t];
      ay[t] += by[t];
      az[t] += bz[t];
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int64_t i = i0 + int64_t(t) * kThreads;
    if (i < nt) {
      float* o = out + (int64_t(blockIdx.y) * nt + i) * DIM;
      o[0] = scale * ax[t];
      o[1] = scale * ay[t];
      if (DIM == 3) o[2] = scale * az[t];
    }
  }
}

// out[e] = kappa * sum_s part[s, e], in split order
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, int64_t nd, int S,
                           float kappa) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= nd) return;
  float acc = part[e];
  for (int s = 1; s < S; ++s) acc += part[s * nd + e];
  out[e] = kappa * acc;
}

int targets_per_block(int dim) {
  return kThreads * (dim == 3 ? Geo<3>::kT : Geo<2>::kT);
}

}  // namespace

// The kernel's geometry in `dim` (2 or 3): targets per CUDA block (the
// grid's x extent is ceil(N / this)) and the blocks that stay resident on
// one SM of the current device.  The wrapper's split rule reads both.
// Returns the cudaError_t of the occupancy query (0 on success).
extern "C" int co_direct_geometry(int dim, int* targets, int* blocks_per_sm) {
  if (dim != 2 && dim != 3) return int(cudaErrorInvalidValue);
  *targets = targets_per_block(dim);
  return int(dim == 3 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks_per_sm, direct_kernel<3>, kThreads, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            blocks_per_sm, direct_kernel<2>, kThreads, 0));
}

// Launches the direct kernel (and, for S > 1, the split sum) on `stream`
// for the `nt` targets of `tgt` against the `n` sources of `src`; returns
// the cudaError_t of the launches (0 on success).  The sources are cut
// into `splits` runs of `src_per_split`, each non-empty.  The caller checks
// shapes and allocates `part` ([S, Nt, D]; may be null when S == 1) and
// `out` ([Nt, D]).
extern "C" int co_direct_launch_ts(const float* tgt, const float* src,
                                   float* part, float* out, int nt, int n,
                                   int dim, int splits, int src_per_split,
                                   float eps2, float kappa, void* stream) {
  if (nt < 1 || n < 1 || (dim != 2 && dim != 3) || splits < 1 ||
      splits > 65535 ||
      src_per_split < 1 || int64_t(splits) * src_per_split < n ||
      int64_t(splits - 1) * src_per_split >= n ||
      (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tpb = targets_per_block(dim);
  const dim3 grid((nt + tpb - 1) / tpb, splits);
  float* dst = splits > 1 ? part : out;
  const float scale = splits > 1 ? 1.f : kappa;
  if (dim == 3)
    direct_kernel<3><<<grid, kThreads, 0, st>>>(tgt, src, dst, nt, n,
                                                src_per_split, eps2, scale);
  else
    direct_kernel<2><<<grid, kThreads, 0, st>>>(tgt, src, dst, nt, n,
                                                src_per_split, eps2, scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return int(rc);
  const int64_t nd = int64_t(nt) * dim;
  sum_splits<<<unsigned((nd + 255) / 256), 256, 0, st>>>(part, out, nd,
                                                          splits, kappa);
  return int(cudaGetLastError());
}

// The all-pairs case: `pos` [N, D] is both the targets and the sources.
extern "C" int co_direct_launch(const float* pos, float* part, float* out,
                                int n, int dim, int splits,
                                int src_per_split, float eps2, float kappa,
                                void* stream) {
  return co_direct_launch_ts(pos, pos, part, out, n, n, dim, splits,
                             src_per_split, eps2, kappa, stream);
}
