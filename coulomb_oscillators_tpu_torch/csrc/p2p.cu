// Near-field (P2P) pass of the kd-tree FMM, hand-written for Hopper (sm_90a).
//
// Replaces coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py: _p2p_kernel (the
// VMEM-resident form) and _p2p_stream_kernel (the HBM-streaming form).  On
// Hopper they are one kernel: no SM's shared memory holds every source, so
// sources are always read from global memory through L2 (the block
// coordinates are 16 MB at N=1M and fit the 50 MB L2).
//
// What bounds it on the H100: FP32 issue — about 20 flops and one rsqrtf
// per pair, roughly 5.5G pair evaluations per step at N=1M — and the L2
// gathers of partner blocks.  This first design is the simple, correct
// one: each warp stages each of its partner blocks into its own
// shared-memory slice, in chunks of at most 256 slots, and every lane
// reads the staged coordinates as a broadcast.  A CUDA block holds at most
// 256 target slots; wider blocks (CB > 256: a forced coarse tree_L, or a
// low dens_inhom) take ceil(CB/256) CUDA blocks each, so threads per block
// and shared memory per warp stay bounded whatever CB is.  A block of at
// most 256 slots (the default trees) is staged whole, with a fixed
// per-lane-group loop: the generic chunk loop took 12.1 ms there against
// 9.6 ms at N=1M (NVIDIA H100 80GB HBM3, 700 W).  Each target sums each
// partner block into its own partial and adds the partials in
// partner order: one running sum over the ~30k pairs of a CB = 1024
// target drifted to 1.6e-4 of max|a| against a float64 sum, the two-level
// sum stays below 6e-7.  Block-level
// sharing of partner blocks, double-buffered cp.async/TMA staging and
// Newton-3 are left to later work.  The pair sum stays off the tensor
// cores: the matmul form cancels catastrophically in float32 for close
// pairs (coulomb_oscillators_tpu/ops/fmm/kdtree.py, _stage_p2p docstring).
//
// Contract (the same as the reference kernel's, without its flattened
// [Gb, CB*8] operand):
//   pos     [Gb, CB, 3] float or double: Gb target/source blocks of CB slots,
//           nsub sub-leaves of C = CB/nsub slots each; pad slots sit at
//           FAR = 1e18.
//   row_ptr [Gb*nsub + 1] int32: CSR degrees of each sub-leaf's partner list.
//   col2d   [Gb*nsub, dmax] int32, read as uint32: entry = blk | bits << s,
//           s = 32 - nsub; bit q of `bits` selects lane group q (slots
//           [qC, (q+1)C)) of source block `blk`.  Block id Gb is the FAR
//           sentinel, which contributes exactly zero in float; it is
//           skipped (partner rows never hold it within their degree).
//   out     [Gb, CB, 3] as pos, each target written exactly once (no
//           atomics).
// Pair weight: r = rsqrt(dist2), w = r*r*r.  Never dist2^3: at a FAR pad
// dist2 ~ 3e36 cubes to inf and inf * 0 is NaN, while r^3 underflows to 0.
//
// The kernel is a template on the float type, instantiated for float
// (co_p2p_launch) and double (co_p2p_launch_f64): the reference gates its
// kernel on backend and dim only, never on dtype, so a float64 kd run
// reaches it too.  In double, r^3 of a FAR pad is 1e-54 and does not
// underflow: each pad source adds about 1e-36 to a real target.  Pads are
// not masked, here or in the plain version, because the reference's sum
// carries the same term.  Each warp's staged slice is S * 3 values, so a
// 256-thread block stages 24 KB in float and 48 KB in double, inside the
// default dynamic shared-memory limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// target slots per CUDA block, and source slots per staged chunk
constexpr int kSlots = 256;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// one pair: a += d * r^3, r = rsqrt(|d|^2 + eps2)
template <typename T>
__device__ __forceinline__ void pair(T tx, T ty, T tz, const T* sp, T eps2,
                                     T& ax, T& ay, T& az) {
  const T dx = tx - sp[0];
  const T dy = ty - sp[1];
  const T dz = tz - sp[2];
  const T d2 = eps2 + dx * dx + dy * dy + dz * dz;
  const T r = rsqrt_t(d2);
  const T w = r * r * r;
  ax += dx * w;
  ay += dy * w;
  az += dz * w;
}

// grid (Gb, ceil(CB / S)), S = min(CB, kSlots) threads per CUDA block
template <typename T>
__global__ void p2p_kernel(const T* __restrict__ pos,
                           const int32_t* __restrict__ row_ptr,
                           const uint32_t* __restrict__ col2d,
                           T* __restrict__ out, int Gb, int CB, int C,
                           int nsub, int dmax, T eps2) {
  extern __shared__ unsigned char smem_raw[];  // per warp: S * 3 values
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int S = blockDim.x;
  const int g = blockIdx.x;
  const int t = blockIdx.y * S + threadIdx.x;  // target slot in block g
  // CB and S are multiples of 32, so this retires whole warps of the last
  // slice; nothing below synchronises more than one warp
  if (t >= CB) return;
  const int lane = threadIdx.x & 31;
  T* s = smem + (threadIdx.x >> 5) * S * 3;
  // C is a multiple of 32, so every lane of a warp serves one sub-leaf and
  // the partner loop below is warp-uniform
  const int64_t row = int64_t(g) * nsub + t / C;
  const int shift = 32 - nsub;
  const uint32_t blkmask = (1u << shift) - 1u;

  const T* tp = pos + (int64_t(g) * CB + t) * 3;
  const T tx = tp[0], ty = tp[1], tz = tp[2];
  T ax = 0, ay = 0, az = 0;

  int deg = row_ptr[row + 1] - row_ptr[row];
  if (deg > dmax) deg = dmax;
  const uint32_t* cols = col2d + row * dmax;
  for (int e = 0; e < deg; ++e) {
    const uint32_t v = cols[e];
    const uint32_t blk = v & blkmask;
    const uint32_t bits = v >> shift;
    if (blk >= uint32_t(Gb) || bits == 0u) continue;
    T bx = 0, by = 0, bz = 0;
    if (S == CB) {
      // the whole partner block in one chunk (CB <= 256)
      const T* src = pos + int64_t(blk) * CB * 3;
      __syncwarp();                        // previous block fully read
      for (int k = lane; k < CB * 3; k += 32) s[k] = src[k];
      __syncwarp();
      for (int q = 0; q < nsub; ++q) {
        if (!((bits >> q) & 1u)) continue;
        const T* sq = s + q * C * 3;
        for (int j = 0; j < C; ++j)
          pair(tx, ty, tz, sq + 3 * j, eps2, bx, by, bz);
      }
    } else {
      // source slots [c0, c0 + m) of block blk, lane groups q0..q1
      for (int c0 = 0; c0 < CB; c0 += S) {
        const int m = min(S, CB - c0);
        const int q0 = c0 / C, q1 = (c0 + m - 1) / C;
        if (((bits >> q0) & ((2u << (q1 - q0)) - 1u)) == 0u) continue;
        const T* src = pos + (int64_t(blk) * CB + c0) * 3;
        __syncwarp();                      // previous chunk fully read
        for (int k = lane; k < m * 3; k += 32) s[k] = src[k];
        __syncwarp();
        for (int q = q0; q <= q1; ++q) {
          if (!((bits >> q) & 1u)) continue;
          const int j1 = min((q + 1) * C, c0 + m) - c0;
          for (int j = max(q * C, c0) - c0; j < j1; ++j)
            pair(tx, ty, tz, s + 3 * j, eps2, bx, by, bz);
        }
      }
    }
    ax += bx;
    ay += by;
    az += bz;
  }
  T* op = out + (int64_t(g) * CB + t) * 3;
  op[0] = ax;
  op[1] = ay;
  op[2] = az;
}

template <typename T>
int launch(const T* pos, const int32_t* row_ptr, const int32_t* col2d, T* out,
           int Gb, int CB, int nsub, int dmax, T eps2, void* stream) {
  if (Gb < 1 || nsub < 1 || nsub > 8 || CB % nsub != 0 ||
      (CB / nsub) % 32 != 0 || dmax < 1)
    return int(cudaErrorInvalidValue);
  const int S = CB < kSlots ? CB : kSlots;
  const dim3 grid(Gb, (CB + S - 1) / S);
  const size_t smem = size_t(S / 32) * S * 3 * sizeof(T);
  p2p_kernel<T><<<grid, S, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, row_ptr, reinterpret_cast<const uint32_t*>(col2d), out, Gb, CB,
      CB / nsub, nsub, dmax, eps2);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the float / double instantiation on `stream`; each returns the
// cudaError_t of the launch (0 on success).  The caller checks shapes; this
// re-checks what would make the launch itself wrong.
extern "C" int co_p2p_launch(const float* pos, const int32_t* row_ptr,
                             const int32_t* col2d, float* out, int Gb,
                             int CB, int nsub, int dmax, float eps2,
                             void* stream) {
  return launch<float>(pos, row_ptr, col2d, out, Gb, CB, nsub, dmax, eps2,
                       stream);
}

extern "C" int co_p2p_launch_f64(const double* pos, const int32_t* row_ptr,
                                 const int32_t* col2d, double* out, int Gb,
                                 int CB, int nsub, int dmax, double eps2,
                                 void* stream) {
  return launch<double>(pos, row_ptr, col2d, out, Gb, CB, nsub, dmax, eps2,
                        stream);
}
