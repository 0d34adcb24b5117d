// One BFS hop over packed reachability bitsets (uint32 words), reading only
// the nonzero 16-byte groups of the source rows.
//
// Replaces the TPU kernel `bitset_expand_tiled` in
// src/repro/kernels/bitset_expand/bitset_expand.py (body `_expand_kernel`):
//
//     out[v] = reach[v] | OR{ reach[u] : edge u -> v }
//
// over the edges sorted by destination, in the segment-sum tile plan's
// layout (segments = destination vertices, `gather` = edge sources, -1 pad
// rows at the tail of each output tile's group of input tiles).
//
// What bounds it on an H100.  One OR per word and no matrix product, so
// bytes, and before them latency.  A frontier is sparse: one hop from the
// ~250 endpoints of an update batch leaves 0.25 % of the rows nonzero, and
// 4096 seeds after two hops leave ~1.4 % of the 16-byte groups nonzero.
// The least bytes are the output written once, the edge sources and run
// offsets read once, the masks, and the nonzero groups of `reach`; every
// further byte is a zero.  What is left to wait on is the chain of
// dependent loads (run offsets -> source ids -> source masks -> groups),
// so each warp keeps many of them in flight.
//
// The design:
//
// * Run offsets, no search.  `row_ptr[v]` are the CSR offsets of v's edges
//   among the plan's valid rows; `pad_before[v / ts]` (the pad rows laid out
//   before v's output tile) moves them onto the padded layout.
// * Occupancy masks.  `mask[v]` holds one bit per 16-byte group of row v
//   (words 4g..4g+3), one uint32 per 128 words; they stay in the 50 MB L2.
// * One warp serves a tile of kRows consecutive destinations (one output
//   tile, as ts is a multiple of kRows), whose edges are one contiguous run
//   of plan rows: one coalesced load of the tile's offsets and base masks,
//   then the source ids and their masks kUnroll chunks of 32 edges at a
//   time, all in flight together.  A ballot keeps the edges whose source
//   has a nonzero group; each such lane finds its destination among the
//   tile's offsets (a 3-step shuffle search) and loads its source's set
//   groups itself, up to four at once, so a load is issued per nonzero
//   group and not per lane.  The groups are ORed into the warp's tile of
//   accumulators in shared memory (atomicOr: two edges may share a
//   destination group).  The base rows go through the same path, while the
//   first round's source ids are in flight.
// * The tile's rows are then written whole (zeros too) as coalesced 16-byte
//   streaming stores, which keep the masks in L2, and their masks, built by
//   ballots, as one coalesced store, so the next hop gets its masks for
//   free.  Writing the output is then most of the time (chip_smoke.py
//   times a memset of the same bytes beside the kernel).
//
// No global atomics: each output row and mask word is written once by its
// warp, and OR is idempotent and commutative, so any order of the ORs
// gives the same bits.  A row wider than 128 words takes one pass over the
// tile's edges per 128-word chunk.  `bitset_mask_u32` is the pre-pass for
// a caller without masks: a warp loads the groups of 8 rows at once and
// ballots give their mask words.  Bitsets and masks are int32 tensors in
// PyTorch; the kernels read them as uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 8 destinations a warp and 4 warps a block measured faster on the H100
// than 16 or 32 a warp (more warps resident) and than 8 warps a block;
// kUnroll = 4 chunks cover a tile's ~80 edges at degree 10 in one round
// of loads.
constexpr int kRows = 8;          // destinations a warp (a power of 2, <= 32)
constexpr int kWarps = 4;         // warps a block
constexpr int kUnroll = 4;        // edge chunks loaded together
constexpr int kMaskRows = 8;      // rows a warp of the mask pre-pass loads together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 ldg16(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ bool nonzero(const uint4& a) {
  return (a.x | a.y | a.z | a.w) != 0u;
}

// OR the groups of row `u` set in `m` (chunk base `col0` words) into row
// `r` of the warp's accumulators, up to four loads in flight a lane.
__device__ __forceinline__ void or_groups(const uint32_t* __restrict__ reach,
                                          int64_t words, int col0, int u,
                                          uint32_t m, int r,
                                          uint4 (*acc)[32]) {
  while (__any_sync(kFull, m != 0u)) {
    uint4 d[4];
    int gq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gq[q] = -1;
      if (m) {
        gq[q] = __ffs(m) - 1;
        m &= m - 1u;
        d[q] = ldg16(reach + (int64_t)u * words + col0 + 4 * gq[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (gq[q] >= 0) {
        unsigned* a = reinterpret_cast<unsigned*>(&acc[r][gq[q]]);
        if (d[q].x) atomicOr(a + 0, d[q].x);
        if (d[q].y) atomicOr(a + 1, d[q].y);
        if (d[q].z) atomicOr(a + 2, d[q].z);
        if (d[q].w) atomicOr(a + 3, d[q].w);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    bitset_expand_kernel(const uint32_t* __restrict__ reach,
                         const uint32_t* __restrict__ mask_in,
                         const int* __restrict__ gather,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ pad_before, int n, int words,
                         int ts, uint32_t* __restrict__ out,
                         uint32_t* __restrict__ mask_out) {
  __shared__ uint4 acc_s[kWarps][kRows][32];
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int v0 = tile * kRows;
  if (v0 >= n) return;  // whole warps leave together
  uint4 (*acc)[32] = acc_s[threadIdx.x >> 5];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 8
  for (int i = 0; i < kRows; ++i) acc[i][lane] = zero;

  const int groups = words >> 2;
  const int mw = (groups + 31) >> 5;  // mask words a row
  const int v = v0 + lane;            // lane i < kRows: row v0 + i
  const bool row_ok = lane < kRows && v < n;
  // rs: where row v0 + lane starts (rows past the tile or n start at its end)
  const int rs = __ldg(row_ptr + min(lane < kRows ? v : v0 + kRows, n));
  const int e_end = __ldg(row_ptr + min(v0 + kRows, n));
  const int shift = __ldg(pad_before + v0 / ts);
  uint32_t bm = row_ok ? __ldg(mask_in + (int64_t)v * mw) : 0u;
  const int e_begin = __shfl_sync(kFull, rs, 0);
  __syncwarp();

  for (int c = 0; c < mw; ++c) {
    const int col0 = c * 128;
    const int left = groups - c * 32;  // groups in this chunk
    const uint32_t valid = left >= 32 ? kFull : ((1u << left) - 1u);
    if (c > 0) bm = row_ok ? __ldg(mask_in + (int64_t)v * mw + c) : 0u;
    // one round of kUnroll chunks at least: the base rows (row v0 + i into
    // accumulator row i) are ORed in while the first round's ids load
    for (int e = e_begin; e == e_begin || e < e_end; e += 32 * kUnroll) {
      int u[kUnroll];
      uint32_t m[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int p = e + 32 * q + lane;
        u[q] = p < e_end ? __ldg(gather + p + shift) : -1;
      }
      if (e == e_begin) or_groups(reach, words, col0, v, bm & valid, lane, acc);
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        m[q] = u[q] >= 0 ? (__ldg(mask_in + (int64_t)u[q] * mw + c) & valid) : 0u;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (__ballot_sync(kFull, m[q] != 0u) == 0u) continue;
        const int pos = e + 32 * q + lane;
        int r = 0;  // the last tile row starting at or before pos
#pragma unroll
        for (int s = kRows / 2; s > 0; s >>= 1) {
          const int start = __shfl_sync(kFull, rs, r + s);
          if (start <= pos) r += s;
        }
        or_groups(reach, words, col0, u[q], m[q], r, acc);
      }
    }
    __syncwarp();
    const bool mine = lane < left;
    uint32_t my_bits = 0u;
    for (int i = 0; i < kRows && v0 + i < n; ++i) {
      const uint4 a = acc[i][lane];
      acc[i][lane] = zero;
      if (mine)
        __stcs(reinterpret_cast<uint4*>(out + (int64_t)(v0 + i) * words + col0 + 4 * lane), a);
      const unsigned bits = __ballot_sync(kFull, mine && nonzero(a));
      if (lane == i) my_bits = bits;
    }
    if (row_ok) mask_out[(int64_t)v * mw + c] = my_bits;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(256)
    bitset_mask_kernel(const uint32_t* __restrict__ reach, int64_t items,
                       int words, uint32_t* __restrict__ mask) {
  // one item = (row, 128-word chunk); a warp loads kMaskRows items at once
  const int lane = threadIdx.x & 31;
  const int groups = words >> 2;
  const int mw = (groups + 31) >> 5;
  const int64_t base =
      ((int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kMaskRows;
  bool nz[kMaskRows];
#pragma unroll
  for (int q = 0; q < kMaskRows; ++q) {
    const int64_t w = base + q;
    const int g = (int)(w % mw) * 32 + lane;
    nz[q] = false;
    if (w < items && g < groups) {
      const uint4 x = ldg16(reach + (w / mw) * words + 4 * (int64_t)g);
      nz[q] = nonzero(x);
    }
  }
  uint32_t mine = 0u;
#pragma unroll
  for (int q = 0; q < kMaskRows; ++q) {
    const unsigned bits = __ballot_sync(kFull, nz[q]);
    if (lane == q) mine = bits;
  }
  if (lane < kMaskRows && base + lane < items) mask[base + lane] = mine;
}

}  // namespace

extern "C" int bitset_expand_u32(const uint32_t* reach, const uint32_t* mask_in,
                                 const int* gather, const int* row_ptr,
                                 const int* pad_before, int n, int words, int ts,
                                 uint32_t* out, uint32_t* mask_out,
                                 void* stream) {
  if (ts % kRows) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kRows - 1) / kRows;
  const int blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  bitset_expand_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      reach, mask_in, gather, row_ptr, pad_before, n, words, ts, out, mask_out);
  return (int)cudaGetLastError();
}

extern "C" int bitset_mask_u32(const uint32_t* reach, int n, int words,
                               uint32_t* mask, void* stream) {
  const int64_t items = (int64_t)n * (((words >> 2) + 31) >> 5);
  const int64_t per_block = 8 * kMaskRows;  // 8 warps of kMaskRows items
  const int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks == 0) return 0;
  bitset_mask_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      reach, items, words, mask);
  return (int)cudaGetLastError();
}
