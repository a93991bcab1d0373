// M2L stage of the kd-tree FMM, hand-written for Hopper (sm_90a): for every
// entry of the engine's directed M2L list, the geometry fold, the gather of
// the source multipole, the sparse contraction against the operator's term
// table, and the sum of each run of same-target entries into the local
// heap, in one pass.
//
// Replaces no TPU kernel: the reference's M2L (coulomb_oscillators_tpu/ops/
// fmm/kdtree.py _stage_m2l, ops/multipole/operators.py m2l_fold_geo and
// m2l_sparse_pre) is jnp that XLA fuses.  Written eagerly in PyTorch it is
// a chunked loop of gathers into [chunk, T] term tensors, their products
// and a GEMM against a [T, S_Lt] coefficient matrix (KdFmmEngine.m2l_plain,
// which stays the CPU path and this kernel's oracle): 54.8 ms a step at
// N = 1M, p = 6 on the H100, 73% of the step's device time, and ~3.3 GB of
// temporaries.
//
// The arithmetic, per entry e = (target t, source s), as the plain version
// computes it:
//   R = center[t] - center[s], r = |R|, Rhat = R / r (pad entries: R = 1);
//   u = lam[t] / r, v = lam[s] / r, w = v / u; 2D: logc = -log r - 1;
//   V[k]  = Rhat^(exponents of monomial k), each the product of per-axis
//           powers made by repeated multiplication;
//   H2[h] = (sum_k NUM[k, h] V[k]) * u^ord(h)  (/ r in 3D);
//   Mv[j] = M[s, j] * w^m_ord(j);
//   L[i]  = sum over the table's terms (i, j, h, c) of c * Mv[j] * H2[h]
//           (2D: L[0] += M[s, 0] * logc);
// and acc[t] += L over the valid entries.  Stored mode (CO_M2L_FLY=0) reads
// H2, w and logc from the state instead of folding them.
//
// The tables.  This file is not compiled alone: the wrapper
// (ops/fmm/m2l_cuda.py, `source`) writes the tables of one (dim, p) layout
// as straight-line code in front of it (the M2L_* sizes, m2l_harmonics,
// m2l_scale and m2l_contract), from the same numpy tables as the plain
// version's, with the scalar type M2L_T and the mode M2L_FLY, and builds
// one library for each layout, type and mode the engines launch (p <= 6,
// the sparse forms).  So every index is a constant of the code: an
// entry's H2 and Mv live in registers, and a term is one multiply and one
// FMA with an immediate coefficient.
//
// What bounds it.  At N = 1M, p = 6 (3D, no dipole: S_M = 53, S_H = 84,
// S_Lt = 49, 578 terms, 432 nonzeros of NUM) an entry is ~2.9k flops
// (m2l_cuda.work): 3 x 578 for the contraction (a product and an FMA a
// term), 2 x 432 + 84 for the harmonics, and ~300 for the monomials,
// powers, scales, the fold and the group sum.  The step's ~3-4M valid
// entries are ~9-12 GFLOP, ~0.13-0.18 ms at 67 TFLOP/s; the bytes
// (the multipole heap read once, the lists, the local heap written once)
// are ~60 MB, 0.02 ms at 3.35 TB/s, and sit in the 50 MB L2 for the most
// part.  So the flops bound it, and the design keeps every term's
// operands in registers, with no memory traffic a term; the plain version
// wrote every entry's [T] terms to memory and read them back.  Measured on
// an H100 (700 W): 1.49 ms on the 1M production lists against the plain
// loop's 42.5 ms, 8.8% of the flop bound; 168 registers a thread leave 3
// blocks of 4 warps an SM.
//
// Design.  A warp owns a tile of 32 consecutive entries, one a lane.
//  1. Fly mode folds the lane's entry in registers, one harmonic order at a
//     time (NUM is homogeneous: order n's harmonics read order n's
//     monomials alone, so a few dozen monomials are alive at once).
//     Stored mode copies the tile's H2 rows (one contiguous run) into
//     shared memory with consecutive lanes on consecutive values and reads
//     the lane's row back.
//  2. The warp copies the 32 source multipole rows into shared memory, each
//     row with consecutive lanes on consecutive slots (eight rows' loads in
//     flight), and each lane reads its row back (odd row stride: the 32
//     lanes hit 32 banks) and scales it by w's powers.  Pad entries read a
//     zero row, so they add exactly 0.
//  3. For each output i, each lane sums its entry's terms in a register; a
//     segmented shuffle sum adds the lanes of each run of equal targets
//     (the grouped layout's group target, or the entry's target when g =
//     1; runs cross group boundaries), and the run's first lane adds the
//     run's sum to acc[t, i] with one atomic.  The group sum costs no
//     memory traffic, and a target takes one atomic a run a tile.
// Tiles of pads alone (the list's tail up to its cap) are skipped.  The
// grid is persistent (every block that fits, walking the tiles).  True
// float32 (or float64) FMAs on the CUDA cores: no tensor cores, no TF32.
// Float atomics make the sum's order vary from run to run, as the plain
// version's index_add_ does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// odd row strides of a warp's staging rows, in elements
constexpr int kStrideM = M2L_SM | 1;
constexpr int kStrideH = M2L_SH | 1;

template <bool FLY>
__host__ __device__ constexpr int stage_stride() {
  return FLY || kStrideM > kStrideH ? kStrideM : kStrideH;
}

template <typename T, bool FLY>
__host__ __device__ constexpr size_t smem_bytes() {
  return size_t(kWarps) * 32 * stage_stride<FLY>() * sizeof(T);
}

// Copy row q = 0..31 of the warp's rows into sh[q * S + c], c < W, with
// consecutive lanes on consecutive values; `row` is this lane's row, or
// null for a zero row.
template <typename T, int W, int S>
__device__ __forceinline__ void stage_rows(T* sh, const T* row, int lane) {
  const unsigned long long mine = reinterpret_cast<unsigned long long>(row);
#pragma unroll 8
  for (int q = 0; q < 32; ++q) {
    const T* r = reinterpret_cast<const T*>(__shfl_sync(kFull, mine, q));
#pragma unroll
    for (int c0 = 0; c0 < W; c0 += 32) {
      const int c = c0 + lane;
      if (c < W) sh[q * S + c] = r ? r[c] : T(0);
    }
  }
}

template <typename T, bool FLY>
__global__ void __launch_bounds__(kThreads)
    m2l_fused_kernel(const T* __restrict__ mpole,   // [Mheap, S_M]
                     const T* __restrict__ center,  // [Mheap, DIM] (fly)
                     const T* __restrict__ lam,     // [Mheap] (fly)
                     const T* __restrict__ h2,      // [K, S_H] (stored)
                     const T* __restrict__ wst,     // [K] (stored)
                     const T* __restrict__ logcst,  // [K] (stored)
                     const int* __restrict__ tgt,   // [K]
                     const int* __restrict__ src,   // [K]
                     const uint8_t* __restrict__ valid,  // [K]
                     const int* __restrict__ gtgt,  // [K / g] (g > 1)
                     int K, int g, int Mheap,
                     T* __restrict__ acc) {  // [Mheap, S_Lt]
  constexpr int DIM = M2L_DIM, S = stage_stride<FLY>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sh = reinterpret_cast<T*>(smem) + warp * 32 * S;
  const int ntiles = (K + 31) / 32;
  for (int tile = blockIdx.x * kWarps + warp; tile < ntiles;
       tile += gridDim.x * kWarps) {
    const int e = tile * 32 + lane;
    const bool in = e < K;
    const bool ok = in && valid[e] != 0;
    if (__ballot_sync(kFull, ok) == 0) continue;  // pads alone add nothing
    const int tn = in ? tgt[e] : Mheap;
    const int sn = in ? src[e] : 0;
    const int key = in ? (g > 1 ? gtgt[e / g] : tn) : -1;
    T H[M2L_SH];
    T w, lc;
    if constexpr (FLY) {
      const int a = tn < Mheap - 1 ? tn : Mheap - 1;
      T R[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        R[d] = ok ? center[size_t(a) * DIM + d] - center[size_t(sn) * DIM + d]
                  : T(1);
      T r2 = R[0] * R[0];
#pragma unroll
      for (int d = 1; d < DIM; ++d) r2 = r2 + R[d] * R[d];
      const T r = sqrt(r2);
      const T u = lam[a] / r;
      w = (lam[sn] / r) / u;
      lc = DIM == 2 ? -log(r) - T(1) : T(0);
      // per-axis powers of Rhat, and u^n (/ r in 3D), by repeated
      // multiplication
      T pw[DIM][M2L_MAXH + 1], up[M2L_MAXH + 1];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T x = R[d] / r;
        pw[d][0] = T(1);
#pragma unroll
        for (int n = 1; n <= M2L_MAXH; ++n) pw[d][n] = pw[d][n - 1] * x;
      }
      T un = T(1);
#pragma unroll
      for (int n = 0; n <= M2L_MAXH; ++n) {
        up[n] = DIM == 3 ? un / r : un;
        un = un * u;
      }
      m2l_harmonics(pw, up, H);
    } else {
      w = ok ? wst[e] : T(1);
      lc = ok ? logcst[e] : T(0);
      // the tile's rows of the stored fold: one contiguous run
      const int rows = K - tile * 32 < 32 ? K - tile * 32 : 32;
      const T* base = h2 + size_t(tile) * 32 * M2L_SH;
      int row = 0, col = lane;
      while (col >= M2L_SH) {
        col -= M2L_SH;
        ++row;
      }
      for (int q = lane; q < rows * M2L_SH; q += 32) {
        sh[row * S + col] = base[q];
        col += 32;
        while (col >= M2L_SH) {
          col -= M2L_SH;
          ++row;
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < M2L_SH; ++h) H[h] = sh[lane * S + h];
      __syncwarp();
    }
    // the source multipoles, scaled by w's powers (zero for a pad entry)
    stage_rows<T, M2L_SM, S>(sh, ok ? mpole + size_t(sn) * M2L_SM : nullptr,
                             lane);
    __syncwarp();
    T Mv[M2L_SM];
#pragma unroll
    for (int j = 0; j < M2L_SM; ++j) Mv[j] = sh[lane * S + j];
    T wp[M2L_PM + 1];
    wp[0] = T(1);
#pragma unroll
    for (int n = 1; n <= M2L_PM; ++n) wp[n] = wp[n - 1] * w;
    m2l_scale(wp, Mv);
    // runs of equal keys among the tile's lanes: `end` is the last lane of
    // this lane's run, the run's first lane adds it
    const int knext = __shfl_down_sync(kFull, key, 1);
    const unsigned last = __ballot_sync(kFull, lane == 31 || knext != key);
    const int end = __ffs(last & (kFull << lane)) - 1;
    const int kprev = __shfl_up_sync(kFull, key, 1);
    const bool head = lane == 0 || kprev != key;
    const int maxrun = __reduce_max_sync(kFull, head ? end - lane + 1 : 0);
    const bool add = head && key >= 0 && key < Mheap;
    T* arow = acc + size_t(add ? key : 0) * M2L_SLT;
    m2l_contract(Mv, H, [&](int i, T s) {
      if (DIM == 2 && i == 0) s = s + Mv[0] * lc;  // Mv[0] = M[s, 0]
      s = ok ? s : T(0);
      for (int d = 1; d < maxrun; d <<= 1) {
        const T o = __shfl_down_sync(kFull, s, d);
        if (lane + d <= end) s = s + o;
      }
      if (add) atomicAdd(arow + i, s);
    });
    __syncwarp();  // the next tile rewrites the rows
  }
}

template <typename T, bool FLY>
int launch_t(const T* mpole, const T* center, const T* lam, const T* h2,
             const T* w, const T* logc, const int* tgt, const int* src,
             const uint8_t* valid, const int* gtgt, int K, int g, int Mheap,
             T* acc, cudaStream_t stream) {
  auto kern = m2l_fused_kernel<T, FLY>;
  constexpr size_t smem = smem_bytes<T, FLY>();
  static_assert(smem <= 227 * 1024, "a block's staging rows fit");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int64_t blocks = (int64_t(K) + 32 * kWarps - 1) / (32 * kWarps);
  const int64_t most = int64_t(per_sm) * sms;
  const unsigned grid =
      unsigned(blocks < 1 ? 1 : blocks < most ? blocks : most);
  kern<<<grid, kThreads, smem, stream>>>(mpole, center, lam, h2, w, logc,
                                         tgt, src, valid, gtgt, K, g, Mheap,
                                         acc);
  return int(cudaGetLastError());
}

// The instantiation this build holds: M2L_T (float or double) and M2L_FLY
// (1: fly mode, 0: stored mode) come with the tables.
using Real = M2L_T;

}  // namespace

// Launch the kernel on `stream`: fly mode takes `center` and `lam`, stored
// mode `h2`, `w` and `logc` (the others null).  `acc` [Mheap, S_Lt] must
// be zeroed; the kernel adds into it.  Returns the cudaError_t of the
// launch (0 on success).  The caller checks shapes; this re-checks what
// would make the launch itself wrong.
extern "C" int co_m2l_launch(const void* mpole, const void* center,
                             const void* lam, const void* h2, const void* w,
                             const void* logc, const void* tgt,
                             const void* src, const void* valid,
                             const void* gtgt, int K, int g, int Mheap,
                             void* acc, void* stream) {
  if (K < 0 || g < 1 || Mheap < 1 || (g > 1 && !gtgt) ||
      (M2L_FLY ? (!center || !lam) : (!h2 || !w || !logc)))
    return int(cudaErrorInvalidValue);
  return launch_t<Real, M2L_FLY != 0>(
      static_cast<const Real*>(mpole), static_cast<const Real*>(center),
      static_cast<const Real*>(lam), static_cast<const Real*>(h2),
      static_cast<const Real*>(w), static_cast<const Real*>(logc),
      static_cast<const int*>(tgt), static_cast<const int*>(src),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(gtgt), K,
      g, Mheap, static_cast<Real*>(acc), static_cast<cudaStream_t>(stream));
}
