// Direct O(N^2) softened-Coulomb force, hand-written for Hopper (sm_90a).
//
// Replaces coulomb_oscillators_tpu/ops/direct.py: _direct_kernel (called
// through `direct`, the Pallas kernel tiled over (target, source) blocks
// that accumulates each target tile across the sequential source axis of
// its grid).  On Hopper the source axis is not sequential: blocks run in
// no order, so the source range is split over a second grid dimension and
// a second pass sums the splits in a fixed order.
//
// What bounds it on the H100: the special-function units — one rsqrtf and
// one correctly rounded reciprocal per pair in 3D (one reciprocal in 2D)
// beside ~10 FP32 operations — and, at the CLI's default N = 30001, too
// few targets to fill 132 SMs (118 blocks of 256).  The design: each thread
// owns one target and keeps float32 accumulators in registers; each block
// stages a tile of 256 sources in shared memory as SoA and every thread
// reads them as broadcasts, summing each tile into its own partial before
// adding it to the running sum (a two-level sum, as in p2p.cu, to bound
// float32 drift over long source ranges).  The source range is cut into S
// splits (grid.y) so that about 8 blocks are resident per SM; each split
// writes
// its partial sums to part[S, N, D] and sum_splits adds them in split
// order, so the result is deterministic, with no atomics.  The pair sum
// stays off the tensor cores: the |a|^2 + |b|^2 - 2ab matmul form cancels
// in float32 for close pairs.
//
// Contract (the reference kernel's):
//   pos  [N, D] float32, D in {2, 3}, row-major.
//   out  [N, D] float32: out_i = kappa * sum_j d * w, d = p_i - p_j,
//        dist2 = |d|^2 + eps2, w = (1/dist2) * rsqrt(dist2) in 3D and
//        1/dist2 in 2D.  The self pair has d = 0 and adds exactly 0.  The
//        source loop is bounded at N, so no padded source is ever read
//        (the 2D weight of a pad would not underflow).
//   part [S, N, D] float32 scratch (unused when S == 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // targets per block = sources per tile

template <int DIM>
__device__ __forceinline__ void accumulate(float tx, float ty, float tz,
                                           float sx, float sy, float sz,
                                           float eps2, float& ax, float& ay,
                                           float& az) {
  const float dx = tx - sx;
  const float dy = ty - sy;
  float d2 = dx * dx + dy * dy + eps2;
  float dz = 0.f;
  if (DIM == 3) {
    dz = tz - sz;
    d2 += dz * dz;
  }
  float w = __frcp_rn(d2);
  if (DIM == 3) w *= rsqrtf(d2);
  ax += dx * w;
  ay += dy * w;
  if (DIM == 3) az += dz * w;
}

// grid (ceil(N / kThreads), S); split s sums the sources of tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) and writes
// out[s, i] (S > 1, unscaled) or kappa * sum (S == 1)
template <int DIM>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const float* __restrict__ pos, float* __restrict__ out, int n,
              int tiles_per_split, float eps2, float scale) {
  __shared__ float sx[kThreads], sy[kThreads], sz[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (live) {
    tx = pos[int64_t(i) * DIM];
    ty = pos[int64_t(i) * DIM + 1];
    if (DIM == 3) tz = pos[int64_t(i) * DIM + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  const int64_t j_begin =
      int64_t(blockIdx.y) * tiles_per_split * kThreads;
  int64_t j_end = j_begin + int64_t(tiles_per_split) * kThreads;
  if (j_end > n) j_end = n;
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kThreads) {
    const int64_t j = j0 + threadIdx.x;
    __syncthreads();                       // previous tile fully read
    if (j < j_end) {
      sx[threadIdx.x] = pos[j * DIM];
      sy[threadIdx.x] = pos[j * DIM + 1];
      if (DIM == 3) sz[threadIdx.x] = pos[j * DIM + 2];
    }
    __syncthreads();
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (j_end - j0 >= kThreads) {
#pragma unroll 8
      for (int k = 0; k < kThreads; ++k)
        accumulate<DIM>(tx, ty, tz, sx[k], sy[k], sz[k], eps2, bx, by, bz);
    } else {
      const int m = int(j_end - j0);
      for (int k = 0; k < m; ++k)
        accumulate<DIM>(tx, ty, tz, sx[k], sy[k], sz[k], eps2, bx, by, bz);
    }
    ax += bx;
    ay += by;
    az += bz;
  }
  if (live) {
    float* o = out + (int64_t(blockIdx.y) * n + i) * DIM;
    o[0] = scale * ax;
    o[1] = scale * ay;
    if (DIM == 3) o[2] = scale * az;
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

}  // namespace

// Launches the direct kernel (and, for S > 1, the split sum) on `stream`;
// returns the cudaError_t of the launches (0 on success).  The caller
// checks shapes and allocates `part` ([S, N, D]; may be null when S == 1)
// and `out` ([N, D]).
extern "C" int co_direct_launch(const float* pos, float* part, float* out,
                                int n, int dim, int splits,
                                int tiles_per_split, float eps2,
                                float kappa, void* stream) {
  const int tiles = (n + kThreads - 1) / kThreads;
  if (n < 1 || (dim != 2 && dim != 3) || splits < 1 ||
      tiles_per_split < 1 || int64_t(splits) * tiles_per_split < tiles ||
      int64_t(splits - 1) * tiles_per_split >= tiles ||
      (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, splits);
  float* dst = splits > 1 ? part : out;
  const float scale = splits > 1 ? 1.f : kappa;
  if (dim == 3)
    direct_kernel<3><<<grid, kThreads, 0, st>>>(pos, dst, n, tiles_per_split,
                                                eps2, scale);
  else
    direct_kernel<2><<<grid, kThreads, 0, st>>>(pos, dst, n, tiles_per_split,
                                                eps2, scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return int(rc);
  const int64_t nd = int64_t(n) * dim;
  sum_splits<<<unsigned((nd + 255) / 256), 256, 0, st>>>(part, out, nd,
                                                          splits, kappa);
  return int(cudaGetLastError());
}
