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
// one: each warp stages each of its partner blocks once into its own
// shared-memory slice and every lane reads the staged coordinates as a
// broadcast.  Block-level sharing of partner blocks, double-buffered
// cp.async/TMA staging and Newton-3 are left to later work.  The pair sum
// stays off the tensor cores: the matmul form cancels catastrophically in
// float32 for close pairs (coulomb_oscillators_tpu/ops/fmm/kdtree.py,
// _stage_p2p docstring).
//
// Contract (the same as the reference kernel's, without its flattened
// [Gb, CB*8] operand):
//   pos     [Gb, CB, 3] float32: Gb target/source blocks of CB padded slots,
//           nsub sub-leaves of C = CB/nsub slots each; pad slots sit at
//           FAR = 1e18.
//   row_ptr [Gb*nsub + 1] int32: CSR degrees of each sub-leaf's partner list.
//   col2d   [Gb*nsub, dmax] int32, read as uint32: entry = blk | bits << s,
//           s = 32 - nsub; bit q of `bits` selects lane group q (slots
//           [qC, (q+1)C)) of source block `blk`.  Block id Gb is the FAR
//           sentinel, which contributes exactly zero; it is skipped.
//   out     [Gb, CB, 3] float32, each target written exactly once (no
//           atomics).
// Pair weight: r = rsqrtf(dist2), w = r*r*r.  Never dist2^3: at a FAR pad
// dist2 ~ 3e36 cubes to inf and inf * 0 is NaN, while r^3 underflows to 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void p2p_kernel(const float* __restrict__ pos,
                           const int32_t* __restrict__ row_ptr,
                           const uint32_t* __restrict__ col2d,
                           float* __restrict__ out, int Gb, int CB, int C,
                           int nsub, int dmax, float eps2) {
  extern __shared__ float smem[];          // per warp: CB * 3 floats
  const int g = blockIdx.x;
  const int t = threadIdx.x;               // target slot in block g
  const int lane = t & 31;
  float* s = smem + (t >> 5) * CB * 3;
  // C is a multiple of 32, so every lane of a warp serves one sub-leaf and
  // the partner loop below is warp-uniform
  const int64_t row = int64_t(g) * nsub + t / C;
  const int shift = 32 - nsub;
  const uint32_t blkmask = (1u << shift) - 1u;

  const float* tp = pos + (int64_t(g) * CB + t) * 3;
  const float tx = tp[0], ty = tp[1], tz = tp[2];
  float ax = 0.f, ay = 0.f, az = 0.f;

  int deg = row_ptr[row + 1] - row_ptr[row];
  if (deg > dmax) deg = dmax;
  const uint32_t* cols = col2d + row * dmax;
  for (int e = 0; e < deg; ++e) {
    const uint32_t v = cols[e];
    const uint32_t blk = v & blkmask;
    const uint32_t bits = v >> shift;
    if (blk >= uint32_t(Gb) || bits == 0u) continue;
    const float* src = pos + int64_t(blk) * CB * 3;
    __syncwarp();                          // previous block fully read
    for (int k = lane; k < CB * 3; k += 32) s[k] = src[k];
    __syncwarp();
    for (int q = 0; q < nsub; ++q) {
      if (!((bits >> q) & 1u)) continue;
      const float* sq = s + q * C * 3;
      for (int j = 0; j < C; ++j) {
        const float dx = tx - sq[3 * j];
        const float dy = ty - sq[3 * j + 1];
        const float dz = tz - sq[3 * j + 2];
        const float d2 = eps2 + dx * dx + dy * dy + dz * dz;
        const float r = rsqrtf(d2);
        const float w = r * r * r;
        ax += dx * w;
        ay += dy * w;
        az += dz * w;
      }
    }
  }
  float* op = out + (int64_t(g) * CB + t) * 3;
  op[0] = ax;
  op[1] = ay;
  op[2] = az;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).  The caller checks shapes; this re-checks what would
// make the launch itself wrong.
extern "C" int co_p2p_launch(const float* pos, const int32_t* row_ptr,
                             const int32_t* col2d, float* out, int Gb,
                             int CB, int nsub, int dmax, float eps2,
                             void* stream) {
  if (Gb < 1 || nsub < 1 || nsub > 8 || CB % nsub != 0 ||
      (CB / nsub) % 32 != 0 || CB > 256 || dmax < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(CB / 32) * CB * 3 * sizeof(float);
  p2p_kernel<<<Gb, CB, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, row_ptr, reinterpret_cast<const uint32_t*>(col2d), out, Gb, CB,
      CB / nsub, nsub, dmax, eps2);
  return int(cudaGetLastError());
}
