// Fused gather + sorted segment sum over a tile plan (float32).
//
// Replaces the TPU kernel `segment_sum_tiled` in
// src/repro/kernels/segment_reduce/segment_reduce.py (body `_seg_sum_kernel`).
//
// What bounds it on an H100: bytes.  Each gathered row is one f32 add per
// channel, so the work is the gather: the plan's index arrays are read once
// in order, and the value rows are read at data-dependent addresses.  The
// design answers that by fusing the gather (values[gather[r], c] is read
// straight from the [S, C] matrix, so the gathered [Mpad, C] copy is never
// written to device memory) and by reading four rows per step, so each
// thread keeps four independent loads in flight.
//
// Layout (built on the host by build_tile_plan): rows are grouped by output
// tile of `ts` segment ids; the input tiles of one output tile are
// consecutive, `m2out[t]` names the output tile of input tile t and is
// non-decreasing; within a group the valid rows come first, sorted by
// segment id, and pad rows carry seg -1.  So every segment's rows are one
// contiguous run inside its group.
//
// One thread block per output tile; blocks need nothing from each other,
// so the TPU's revisit accumulation (`first_visit`) has no counterpart.
// The block binary-searches `m2out` for its input-tile range, marks each
// segment's run [lo, hi) in shared memory, then one thread per (segment,
// channel) sums the run in row order and writes the result once.  No
// atomics: the result is deterministic bit for bit, and a channel's sums do
// not depend on how many channels ride along.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int* __restrict__ gather,
                                   const int* __restrict__ seg,
                                   const int* __restrict__ m2out,
                                   int num_m_tiles, int tm, int ts,
                                   int channels, float* __restrict__ out) {
  extern __shared__ int run[];  // [2 * ts]: run_lo, run_hi (group-relative)
  int* run_lo = run;
  int* run_hi = run + ts;
  const int o = blockIdx.x;
  const int t0 = lower_bound(m2out, num_m_tiles, o);
  const int t1 = lower_bound(m2out, num_m_tiles, o + 1);
  const int64_t r0 = (int64_t)t0 * tm;
  const int rows = (t1 - t0) * tm;
  const int base = o * ts;

  for (int j = threadIdx.x; j < ts; j += blockDim.x) {
    run_lo[j] = 0;
    run_hi[j] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int s = seg[r0 + r];
    const int j = s - base;
    if (s < 0 || j < 0 || j >= ts) continue;
    if (r == 0 || seg[r0 + r - 1] != s) run_lo[j] = r;
    if (r == rows - 1 || seg[r0 + r + 1] != s) run_hi[j] = r + 1;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ts * channels; idx += blockDim.x) {
    const int j = idx / channels;
    const int c = idx - j * channels;
    const int lo = run_lo[j], hi = run_hi[j];
    float acc = 0.0f;
    int r = lo;
    for (; r + 4 <= hi; r += 4) {
      const int64_t g0 = gather ? gather[r0 + r] : r0 + r;
      const int64_t g1 = gather ? gather[r0 + r + 1] : r0 + r + 1;
      const int64_t g2 = gather ? gather[r0 + r + 2] : r0 + r + 2;
      const int64_t g3 = gather ? gather[r0 + r + 3] : r0 + r + 3;
      const float v0 = values[g0 * channels + c];
      const float v1 = values[g1 * channels + c];
      const float v2 = values[g2 * channels + c];
      const float v3 = values[g3 * channels + c];
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; r < hi; ++r) {
      const int64_t g = gather ? gather[r0 + r] : r0 + r;
      acc += values[g * channels + c];
    }
    out[(int64_t)(base + j) * channels + c] = acc;
  }
}

}  // namespace

extern "C" int segment_sum_f32(const float* values, const int* gather,
                               const int* seg, const int* m2out,
                               int num_m_tiles, int tm, int ts,
                               int num_out_tiles, int channels, float* out,
                               void* stream) {
  const int threads = 256;
  const size_t smem = 2 * (size_t)ts * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  segment_sum_kernel<<<num_out_tiles, threads, smem, (cudaStream_t)stream>>>(
      values, gather, seg, m2out, num_m_tiles, tm, ts, channels, out);
  return (int)cudaGetLastError();
}
