// One BFS hop over packed reachability bitsets (uint32 words).
//
// Replaces the TPU kernel `bitset_expand_tiled` in
// src/repro/kernels/bitset_expand/bitset_expand.py (body `_expand_kernel`):
//
//     out[v] = reach[v] | OR{ reach[u] : edge u -> v }
//
// over the edges sorted by destination, in the segment-sum tile plan's
// layout (segments = destination vertices, `gather` = edge sources).
//
// What bounds it on an H100: bytes.  One OR per word moved; each edge reads
// one whole source row (W words) at a data-dependent address.  The design
// answers that with one warp per destination row: each lane owns 4
// consecutive words, so a warp reads a 512-byte row (W = 128) as 32
// coalesced 16-byte loads, ORs the rows of the destination's run of edges
// in registers, ORs in reach[v] and writes the row once.  The gather is
// fused (the gathered [Mpad, W] copy is never written), and OR needs no
// scan or matrix unit: the TPU kernel's Hillis-Steele scan and 16-bit split
// matmul have no counterpart.
//
// A warp finds its edge run by binary search: m2out (non-decreasing) gives
// the input-tile range of the destination's output tile, and inside it the
// valid rows are sorted by destination with the -1 pad rows after them, so
// comparing segment ids as unsigned (pad = 0xffffffff) keeps the range
// sorted.  Bitsets are stored as int32 tensors; the kernel reads them as
// uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lower_bound_i(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t lower_bound_u(const int* a, int64_t lo,
                                                 int64_t hi, unsigned key) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if ((unsigned)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kWarps = 8;

__global__ void bitset_expand_kernel(const uint32_t* __restrict__ reach,
                                     const int* __restrict__ gather,
                                     const int* __restrict__ seg,
                                     const int* __restrict__ m2out,
                                     int num_m_tiles, int tm, int ts, int n,
                                     int words, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;
  const int o = v / ts;
  const int t0 = lower_bound_i(m2out, num_m_tiles, o);
  const int t1 = lower_bound_i(m2out, num_m_tiles, o + 1);
  const int64_t g0 = (int64_t)t0 * tm, g1 = (int64_t)t1 * tm;
  const int64_t lo = lower_bound_u(seg, g0, g1, (unsigned)v);
  const int64_t hi = lower_bound_u(seg, lo, g1, (unsigned)v + 1u);

  for (int w = lane * 4; w < words; w += 128) {
    uint4 acc = *reinterpret_cast<const uint4*>(reach + (int64_t)v * words + w);
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t u = gather[r];
      const uint4 x =
          *reinterpret_cast<const uint4*>(reach + u * words + w);
      acc.x |= x.x;
      acc.y |= x.y;
      acc.z |= x.z;
      acc.w |= x.w;
    }
    *reinterpret_cast<uint4*>(out + (int64_t)v * words + w) = acc;
  }
}

}  // namespace

extern "C" int bitset_expand_u32(const uint32_t* reach, const int* gather,
                                 const int* seg, const int* m2out,
                                 int num_m_tiles, int tm, int ts, int n,
                                 int words, uint32_t* out, void* stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  bitset_expand_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      reach, gather, seg, m2out, num_m_tiles, tm, ts, n, words, out);
  return (int)cudaGetLastError();
}
