// Dual-tree MAC traversal of the kd-tree FMM, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The reference runs this traversal on the host at
// rebuild time, and so did the port: native/co_native.cpp co_traverse_fine,
// a serial depth-first stack on one core.  At N = 1M (L = 15, 65,535 heap
// nodes, every node's bounds inflated by the stale margin) that stack visits
// tens of millions of node pairs, about 1.3 s of the re-sort that paces the
// production window.  This file runs the same decisions on the card; the
// wrapper (ops/fmm/traverse.py) turns the unordered pairs into the
// engine's directed, target-sorted lists with device sorts.
//
// Design.  A level-synchronous frontier of node pairs replaces the stack:
// one launch per level, one thread per pair.  A thread classifies its pair
// exactly as co_traverse_fine does:
//   * M2L   when i != j and max(pm2) * max(sz) < dist2;
//   * near  when both nodes are leaves;
//   * split otherwise: a self pair into (l,l), (l,r), (r,r); any other pair
//     into the two children of its larger non-leaf side.
// It appends the result to one of three buffers (the unordered M2L pairs,
// the unordered near sub-leaf pairs and the next frontier) with one atomic
// a warp and buffer (a ballot or a warp scan gives each lane its slot).
// The host reads back three counts a level; a level descends at least one
// side of every pair by one level, so a traversal takes at most 2L + 1
// levels.  A buffer that fills keeps counting without writing, so the
// caller learns the size it needs: the M2L and near buffers run on to the
// end, the frontier stops the traversal (its pairs are lost) and the caller
// runs it again with larger buffers.
//
// Same decisions as the host, bit for bit.  The per-node tables sz and pm2
// come from the host (co_traverse_tables: pm2 uses std::pow in float, which
// the device cannot reproduce), and dist2 is summed over the axes in the
// host's order with __fsub_rn / __fmul_rn / __fadd_rn, so that nvcc
// contracts nothing into an FMA (the host library is built with
// -ffp-contract=off); max() is the host's std::max, (a < b) ? b : a.
//
// What bounds it.  Each visited pair is read once (8 bytes) and written
// once as a child of the level before (8 bytes), each M2L and near pair is
// written once (8 bytes), and the node tables (M x (dim + 2) floats, 1.3 MB
// at N = 1M, resident in the 50 MB L2) are read: at N = 1M on the
// production beam 29.5M visited pairs and 14.8M results, 0.59 GB, 0.18 ms
// of the card's 3.35 TB/s.  The level loop is what the traversal costs: 30
// levels at 1M, each a launch, a read-back of its counts and a
// synchronisation of the caller's stream, ~2.5 ms in all on an idle card
// (~80 us a level), 20 levels and ~0.6 ms at N = 30001 (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind : int { kNone = 0, kM2L = 1, kNear = 2, kSelf = 3, kSplitI = 4,
                  kSplitJ = 5 };

template <int DIM>
__global__ void __launch_bounds__(kThreads)
frontier_kernel(const float* __restrict__ center,
                const float* __restrict__ sz,
                const float* __restrict__ pm2, int leaf0,
                const int2* __restrict__ front, long long nfront,
                int2* __restrict__ m2l, long long m2l_cap,
                int2* __restrict__ near, long long near_cap,
                int2* __restrict__ next, long long next_cap,
                unsigned long long* __restrict__ counts) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int i = 0, j = 0, kind = kNone;
  if (k < nfront) {
    const int2 e = front[k];
    i = e.x;
    j = e.y;
    const float szi = sz[i], szj = sz[j];
    if (i != j) {
      float dist2 = 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const float d = __fsub_rn(center[(long long)i * DIM + a],
                                  center[(long long)j * DIM + a]);
        dist2 = __fadd_rn(dist2, __fmul_rn(d, d));
      }
      const float pi = pm2[i], pj = pm2[j];
      const float pm = (pi < pj) ? pj : pi;
      const float sm = (szi < szj) ? szj : szi;
      if (__fmul_rn(pm, sm) < dist2) kind = kM2L;
    }
    if (kind == kNone) {
      const bool leaf_i = i >= leaf0, leaf_j = j >= leaf0;
      if (leaf_i && leaf_j)
        kind = kNear;
      else if (i == j)
        kind = kSelf;
      else if (!leaf_i && (leaf_j || szi >= szj))
        kind = kSplitI;
      else
        kind = kSplitJ;
    }
  }
  const unsigned full = 0xffffffffu;
  const unsigned below = (1u << lane) - 1u;
  const unsigned bm = __ballot_sync(full, kind == kM2L);
  const unsigned bn = __ballot_sync(full, kind == kNear);
  const int nchild = kind == kSelf ? 3 : (kind >= kSplitI ? 2 : 0);
  int incl = nchild;                       // inclusive warp scan of nchild
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(full, incl, 31);
  unsigned long long bm0 = 0, bn0 = 0, bc0 = 0;
  if (lane == 0) {
    if (bm) bm0 = atomicAdd(&counts[0], (unsigned long long)__popc(bm));
    if (bn) bn0 = atomicAdd(&counts[1], (unsigned long long)__popc(bn));
    if (total) bc0 = atomicAdd(&counts[2], (unsigned long long)total);
  }
  bm0 = __shfl_sync(full, bm0, 0);
  bn0 = __shfl_sync(full, bn0, 0);
  bc0 = __shfl_sync(full, bc0, 0);
  if (kind == kM2L) {
    const long long at = (long long)(bm0 + __popc(bm & below));
    if (at < m2l_cap) m2l[at] = make_int2(i, j);
  } else if (kind == kNear) {
    const long long at = (long long)(bn0 + __popc(bn & below));
    if (at < near_cap) near[at] = make_int2(i - leaf0, j - leaf0);
  } else if (nchild) {
    long long at = (long long)bc0 + incl - nchild;
    int2 c[3];
    if (kind == kSelf) {
      const int l = 2 * i + 1, r = 2 * i + 2;
      c[0] = make_int2(l, l);
      c[1] = make_int2(l, r);
      c[2] = make_int2(r, r);
    } else if (kind == kSplitI) {
      c[0] = make_int2(2 * i + 1, j);
      c[1] = make_int2(2 * i + 2, j);
    } else {
      c[0] = make_int2(i, 2 * j + 1);
      c[1] = make_int2(i, 2 * j + 2);
    }
    for (int q = 0; q < nchild; ++q, ++at)
      if (at < next_cap) next[at] = c[q];
  }
}

}  // namespace

// The whole traversal from the root pair, on `stream`, with the caller's
// buffers: fa and fb (front_cap pairs each) hold the frontier in turns;
// m2l (m2l_cap pairs) and near (near_cap pairs) receive the unordered
// results; dcount is 3 device counters and hcount 3 pinned host ones.
// Synchronises `stream` once a level (and no other stream).  Writes
// info = {M2L pairs, near pairs, levels (= launches), largest frontier,
// frontier overflow (0/1), pairs visited}; the pairs are counted in full even where
// their buffer was too small, unless the frontier overflowed (then the
// counts are those of the levels run).  Returns 0, or a cudaError_t.
extern "C" int co_traverse_run(const float* center, const float* sz,
                               const float* pm2, int dim, int L, int2* fa,
                               int2* fb, long long front_cap, int2* m2l,
                               long long m2l_cap, int2* near,
                               long long near_cap,
                               unsigned long long* dcount,
                               unsigned long long* hcount, long long* info,
                               cudaStream_t stream) {
  const int leaf0 = (1 << L) - 1;
  for (int q = 0; q < 6; ++q) info[q] = 0;
  cudaError_t err = cudaMemsetAsync(fa, 0, sizeof(int2), stream);  // (0, 0)
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dcount, 0, 3 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return int(err);
  long long nfront = 1, levels = 0, largest = 1, visited = 0;
  while (nfront > 0) {
    err = cudaMemsetAsync(dcount + 2, 0, sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return int(err);
    const unsigned blocks = unsigned((nfront + kThreads - 1) / kThreads);
    if (dim == 3)
      frontier_kernel<3><<<blocks, kThreads, 0, stream>>>(
          center, sz, pm2, leaf0, fa, nfront, m2l, m2l_cap, near, near_cap,
          fb, front_cap, dcount);
    else
      frontier_kernel<2><<<blocks, kThreads, 0, stream>>>(
          center, sz, pm2, leaf0, fa, nfront, m2l, m2l_cap, near, near_cap,
          fb, front_cap, dcount);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(hcount, dcount, 3 * sizeof(unsigned long long),
                            cudaMemcpyDeviceToHost, stream);
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return int(err);
    ++levels;
    visited += nfront;
    info[5] = visited;
    info[0] = (long long)hcount[0];
    info[1] = (long long)hcount[1];
    info[2] = levels;
    nfront = (long long)hcount[2];
    if (nfront > largest) largest = nfront;
    info[3] = largest;
    if (nfront > front_cap) {
      info[4] = 1;
      return 0;
    }
    int2* t = fa;
    fa = fb;
    fb = t;
  }
  return 0;
}
