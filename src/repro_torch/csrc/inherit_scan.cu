// Inheritance scan along the I-Index's PID forest (float32), the level
// schedule of paper Algorithm 5 on the card:
//   for L = 1 .. max_level, for each v with level L, for each column j:
//     out[v, j] = op_j(wdp[v, j], out[pid[v], j])
// and the roots (level 0) keep wdp.  The columns split into consecutive
// groups (n_sum, n_min, n_max): op is +, a NaN-propagating min or a
// NaN-propagating max (jnp.minimum / jnp.maximum; fminf and fmaxf drop NaN,
// so they are not used).  Each vertex combines its own partial with its
// parent's finished value once, as the reference's masked `where` does, so
// the result is the reference's bit for bit given the same wdp.
//
// Replaces no Pallas kernel: the reference computes this scan in jnp
// (`_inherit_scan`, src/repro/core/engine_jax.py:611), as `max_level`
// sequential masked gathers.  Written as eager PyTorch launches that is
// ~3 launches a level, ~24,000 a query at depth ~8,100, so it is a kernel.
//
// What bounds it on an H100: latency.  Level L reads the values written at
// level L - 1, so the critical path is `max_level` dependent round trips to
// L2 plus one block barrier each, far above the few MB it moves.
//
// Design: one launch; columns are independent, so each block owns a slice of
// the columns and walks every level in order, with __syncthreads() between
// levels and no grid-wide synchronisation.  Threads stride over the level's
// (vertex, column) pairs.  The vertices are laid out by level (`order`, with
// level L at order[level_ptr[L] .. level_ptr[L+1])); level_ptr is staged in
// shared memory in chunks.  The loads that do not depend on earlier levels
// are issued ahead: each thread holds its first pair of level L + 1 (parent
// id and partial) and the vertex of its first pair of level L + 2, so a
// level's critical path is one L2 round trip for the parent's value (read
// with __ldcg: it was written by this block at the previous level) and the
// barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132;  // one block a column up to the SM count
constexpr int PTR_CHUNK = 1024;  // level_ptr entries staged at a time

__device__ __forceinline__ float combine(int op, float w, float p) {
  if (op == 0) return w + p;
  if (w != w) return w;  // NaN propagates, as jnp.minimum / jnp.maximum
  if (p != p) return p;
  if (op == 1) return p < w ? p : w;
  return p > w ? p : w;
}

__global__ void __launch_bounds__(THREADS)
inherit_scan_kernel(const float* __restrict__ wdp, const int* __restrict__ pid,
                    const int* __restrict__ order,
                    const int* __restrict__ level_ptr, int n, int c, int n_sum,
                    int n_min, int max_level, int cw, float* out) {
  __shared__ int s_ptr[PTR_CHUNK];
  const int c0 = blockIdx.x * cw;
  const int cn = min(cw, c - c0);  // this block's columns
  if (cn <= 0) return;
  const int tid = threadIdx.x;
  auto op_of = [&](int j) { return j < n_sum ? 0 : (j < n_sum + n_min ? 1 : 2); };
  int base = 0;
  // level_ptr[from .. from + PTR_CHUNK) into shared memory (n past the last
  // level); every thread of the block calls it at the same level
  auto stage = [&](int from) {
    __syncthreads();
    for (int k = tid; k < PTR_CHUNK; k += THREADS) {
      const int lv = from + k;
      s_ptr[k] = lv <= max_level + 1 ? level_ptr[lv] : n;
    }
    base = from;
    __syncthreads();
  };
  stage(0);

  // level 0: the roots keep their partials
  {
    const int lo = s_ptr[0];
    const int64_t pairs = (int64_t)(s_ptr[1] - lo) * cn;
    for (int64_t p = tid; p < pairs; p += THREADS) {
      const int v = order[lo + (int)(p / cn)];
      const int64_t at = (int64_t)v * c + c0 + (int)(p % cn);
      out[at] = wdp[at];
    }
  }
  if (max_level == 0) return;

  // a thread's first pair of any level has the same column
  const int j0 = c0 + tid % cn;
  const int op0 = op_of(j0);
  auto first_vertex = [&](int lv) {  // -1 when the level has no pair `tid`
    const int lo = s_ptr[lv - base];
    return tid < (int64_t)(s_ptr[lv + 1 - base] - lo) * cn ? order[lo + tid / cn] : -1;
  };
  // the pipeline: level 1's first pair, level 2's first vertex
  int v_cur = first_vertex(1);
  int par_cur = 0;
  float w_cur = 0.f;
  if (v_cur >= 0) {
    par_cur = pid[v_cur];
    w_cur = wdp[(int64_t)v_cur * c + j0];
  }
  int v_nxt = first_vertex(2);
  __syncthreads();  // the roots' values are written

  for (int lv = 1; lv <= max_level; ++lv) {
    if (lv + 3 - base >= PTR_CHUNK) stage(lv);
    // the critical load: the parent's finished value, written last level
    float a = 0.f;
    if (v_cur >= 0) a = __ldcg(out + (int64_t)par_cur * c + j0);
    // ahead: level lv + 1's first pair, level lv + 2's first vertex
    int par_nxt = 0;
    float w_nxt = 0.f;
    if (v_nxt >= 0) {
      par_nxt = pid[v_nxt];
      w_nxt = wdp[(int64_t)v_nxt * c + j0];
    }
    const int v_far = first_vertex(lv + 2);
    if (v_cur >= 0) out[(int64_t)v_cur * c + j0] = combine(op0, w_cur, a);
    // the rest of a level wider than the block, pair by pair
    const int lo = s_ptr[lv - base];
    const int64_t pairs = (int64_t)(s_ptr[lv + 1 - base] - lo) * cn;
    for (int64_t p = tid + THREADS; p < pairs; p += THREADS) {
      const int v = order[lo + (int)(p / cn)];
      const int j = c0 + (int)(p % cn);
      const float pa = __ldcg(out + (int64_t)pid[v] * c + j);
      out[(int64_t)v * c + j] = combine(op_of(j), wdp[(int64_t)v * c + j], pa);
    }
    __syncthreads();
    v_cur = v_nxt;
    par_cur = par_nxt;
    w_cur = w_nxt;
    v_nxt = v_far;
  }
}

}  // namespace

// wdp [n, c] float32 -> out [n, c] float32; pid, order [n] and level_ptr
// [n + 1] int32 (the vertices by level: level L is order[level_ptr[L] ..
// level_ptr[L + 1]); every vertex has a level <= max_level, and pid[v] is at
// level(v) - 1).  Columns [0, n_sum) add, [n_sum, n_sum + n_min) take the
// min, the rest the max.  Returns a cudaError_t.
extern "C" int inherit_scan_f32(const float* wdp, const int* pid, const int* order,
                                const int* level_ptr, int n, int c, int n_sum,
                                int n_min, int max_level, float* out,
                                void* stream) {
  if (n <= 0 || c <= 0 || n_sum < 0 || n_min < 0 || n_sum + n_min > c ||
      max_level < 0 || max_level >= n)
    return (int)cudaErrorInvalidValue;
  const int cw = (c + MAX_BLOCKS - 1) / MAX_BLOCKS;
  const int blocks = (c + cw - 1) / cw;
  inherit_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      wdp, pid, order, level_ptr, n, c, n_sum, n_min, max_level, cw, out);
  return (int)cudaGetLastError();
}
