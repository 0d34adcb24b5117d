// Inheritance scan along the I-Index's PID forest (float32): the values of
// paper Algorithm 5's level schedule,
//   out[v, j] = op_j(wdp[v, j], out[pid[v], j])   for every non-root v,
// with the roots keeping wdp, computed by walking the forest's heavy paths.
// The columns split into consecutive groups (n_sum, n_min, n_max): op is +,
// a NaN-propagating min or a NaN-propagating max (jnp.minimum /
// jnp.maximum; fminf and fmaxf drop NaN, so they are not used).  Each vertex
// combines its own partial with its parent's finished value once, operands
// in the reference's order, so the result is the reference's bit for bit
// given the same wdp, whatever the order in which vertices finish.
//
// Replaces no Pallas kernel: the reference computes this scan in jnp
// (`_inherit_scan`, src/repro/core/engine_jax.py:611), as `max_level`
// sequential masked gathers.
//
// What bounds it on an H100: latency.  The forest's depth is a chain of
// dependent combines (4,872 at n = 60,000), so the least time is depth x one
// dependent add, ~0.01 ms at the SM clock, far above the bytes it moves.
// Walked level by level (the first design) every level also paid a block
// barrier and an L2 round trip for the parent's value: 0.45 us a level.
//
// Design: the host cuts the forest into heavy paths (each vertex's chain
// goes on into its child with the largest subtree, so a root-to-leaf path
// crosses at most log2 n chains) and orders them so that every chain's
// parent lies in an earlier chain.  A warp owns one chain and a group of W
// columns (W = 4 when c <= 4, else 32) and carries each column's running
// value down the chain in a register: one add (sum), or one compare and one
// select (min; a max column walks as a min over sign-flipped values), a
// position.  Lanes meet global memory by position (lane i: position p + i,
// its vertex id and its row segment, 16 bytes at a time where aligned) and
// walk by column; a shared-memory tile per warp turns one into the other, so
// a batch of 32 positions costs one coalesced id load and one row load and
// one row store a lane.  The next batch's rows and the ids of the batch
// after are loaded before the walk.  Every 4 batches, and at the chain's
// end, the warp publishes: its stores, a warp barrier, a gpu-scope acq_rel
// fence (it waits for the stores to reach L2, so it is not paid per batch),
// then one ready flag a position.  A chain whose head has a parent spins
// (acquire loads, with a backoff sleep) on the flag of the parent's
// position, then reads the parent's finished value from L2.  Forward
// progress: warps of a persistent grid claim (chain, column group) items in
// layout order through one atomic ticket, never by blockIdx, so every item
// waited on was claimed earlier by a warp that is running and that itself
// waits only on earlier items.  The ticket and the flags are zeroed on the
// stream before each launch.  What is left: the spine's warp pays a batch's
// fixed latencies (the tile's round trips, the barriers) one batch after
// another, and chains of one or two vertices cost a claim and a few L2 round
// trips each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int BATCH = 32;  // chain positions loaded and walked at a time
constexpr int PUBLISH = 4;  // batches a publication covers
constexpr int PAD = 36;  // tile stride: conflict-free rows (scalar) and columns (16-byte)
constexpr unsigned FULL = 0xffffffffu;
// a head that waits this many polls (~17 s) traps instead of hanging the
// card: only a layout that breaks the chain order gets there
constexpr unsigned SPIN_LIMIT = 1u << 24;

// out = op(w, p), p the parent's value: w + p (SUM), or a NaN-propagating
// min (jnp.minimum; fminf drops NaN): min keeps p where p < w or p is NaN,
// unless w is NaN, so one compare (less-than or unordered) and one select
// on the dependent path.  A max column walks as a min over its values with
// the sign bit flipped (exact, NaN and -0.0 included, and the same compare
// and select), so a warp has at most two walks.
template <bool SUM>
__device__ __forceinline__ float combine(float w, float p) {
  if (SUM) return w + p;
  return !(p >= w) && w == w ? p : w;
}

__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// lane = position: its row's columns [0, wg) from src into r (16-byte loads
// when every row segment is 16-byte aligned); zeros where has is false
template <int W, bool VEC4>
__device__ __forceinline__ void load_row(float (&r)[W], const float* __restrict__ src, int wg,
                                         bool has) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    if (VEC4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has && 4 * q < wg) x = __ldg(reinterpret_cast<const float4*>(src) + q);
      r[4 * q] = x.x, r[4 * q + 1] = x.y, r[4 * q + 2] = x.z, r[4 * q + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 4 * q; e < 4 * q + 4; ++e) r[e] = has && e < wg ? __ldg(src + e) : 0.f;
    }
  }
}

// lane = position: r's columns [0, wg) to dst
template <int W, bool VEC4>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[W], int wg, bool has) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    if (VEC4) {
      if (has && 4 * q < wg)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 4 * q; e < 4 * q + 4; ++e)
        if (has && e < wg) dst[e] = r[e];
    }
  }
}

// the dependent walk down cnt positions: w[j] becomes out's value there; the
// first position of a root chain keeps its partial
template <bool SUM, bool FULL_BATCH>
__device__ __forceinline__ float walk(float (&w)[BATCH], float acc, bool keep_first,
                                      int cnt) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    if (FULL_BATCH || j < cnt) {
      acc = j == 0 && keep_first ? w[0] : combine<SUM>(w[j], acc);
      w[j] = acc;
    }
  }
  return acc;
}

template <bool FULL_BATCH>
__device__ __forceinline__ float walk_op(bool sum, float (&w)[BATCH], float acc,
                                         bool keep_first, int cnt) {
  return sum ? walk<true, FULL_BATCH>(w, acc, keep_first, cnt)
             : walk<false, FULL_BATCH>(w, acc, keep_first, cnt);
}

// W: the most columns a warp carries (4 when c <= 4, else 32)
template <int W, bool VEC4>
__global__ void __launch_bounds__(THREADS)
inherit_scan_kernel(const float* __restrict__ wdp, const int* __restrict__ verts,
                    const int* __restrict__ chain_ptr, const int* __restrict__ head_parent,
                    int n, int c, int n_sum, int n_min, int groups, int items,
                    int* ticket, int* flags, float* out) {
  // a warp's batch, column by column: tile[col * PAD + pos]
  __shared__ __align__(16) float tiles[WARPS][W * PAD];
  float* tile = tiles[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  const int my_col = lane < W ? lane : 0;  // lane = column for the walk
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= items) return;
    const int k = t / groups;
    const int g = t - k * groups;
    const int c0 = g * W;  // the warp's columns: [c0, c0 + wg)
    const int wg = min(W, c - c0);
    // columns past wg take column c0's monoid, so a warp of one monoid walks
    // without divergence
    const int col = my_col < wg ? c0 + my_col : c0;
    const bool sum = col < n_sum;
    const unsigned sign = col >= n_sum + n_min ? 0x80000000u : 0u;  // max: flipped
    int* flag = flags + (int64_t)g * n;
    const int lo = __ldg(chain_ptr + k), hi = __ldg(chain_ptr + k + 1);
    const int hp = __ldg(head_parent + k);

    // lane = position for everything global: its vertex, its row
    int v = lo + lane < hi ? __ldg(verts + lo + lane) : 0;
    int v_next = lo + BATCH + lane < hi ? __ldg(verts + lo + BATCH + lane) : 0;
    float r[W];
    load_row<W, VEC4>(r, wdp + v * c + c0, wg, lo + lane < hi);
    float acc = 0.f;
    if (hp >= 0) {  // wait for the parent's position, then take its value
      const int pv = __ldg(verts + hp);
      unsigned ns = 32;
      for (unsigned polls = 0; load_acquire(flag + hp) == 0; ++polls) {
        if (polls == SPIN_LIMIT) __trap();
        __nanosleep(ns);
        ns = ns < 1024 ? 2 * ns : 1024;
      }
      acc = flip(__ldcg(out + pv * c + col), sign);
    }
    int unpublished = 0;  // walked batches not yet published
    for (int p = lo; p < hi; p += BATCH) {
      const int cnt = min(BATCH, hi - p);
      // ahead: the next batch's rows, the ids of the batch after
      float r_next[W];
      load_row<W, VEC4>(r_next, wdp + v_next * c + c0, wg, p + BATCH + lane < hi);
      const int v_far = p + 2 * BATCH + lane < hi ? __ldg(verts + p + 2 * BATCH + lane) : 0;
      // rows to columns through the warp's tile
      __syncwarp();
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (e < wg) tile[e * PAD + lane] = r[e];
      __syncwarp();
      float w[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(tile + my_col * PAD)[q];
        w[4 * q] = flip(x.x, sign), w[4 * q + 1] = flip(x.y, sign);
        w[4 * q + 2] = flip(x.z, sign), w[4 * q + 3] = flip(x.w, sign);
      }
      // the walk, registers only: one dependent combine a position
      const bool keep_first = p == lo && hp < 0;
      acc = cnt == BATCH ? walk_op<true>(sum, w, acc, keep_first, cnt)
                         : walk_op<false>(sum, w, acc, keep_first, cnt);
      __syncwarp();
      // columns back to rows, each stored once
      if (lane < W) {
#pragma unroll
        for (int q = 0; q < BATCH / 4; ++q)
          reinterpret_cast<float4*>(tile + lane * PAD)[q] =
              make_float4(flip(w[4 * q], sign), flip(w[4 * q + 1], sign),
                          flip(w[4 * q + 2], sign), flip(w[4 * q + 3], sign));
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (e < wg) r[e] = tile[e * PAD + lane];
      store_row<W, VEC4>(out + v * c + c0, r, wg, lane < cnt);
      // the publication: every lane's stores, a gpu-scope fence, one ready
      // flag a position
      if (++unpublished == PUBLISH || p + BATCH >= hi) {
        __syncwarp();
        asm volatile("fence.acq_rel.gpu;" ::: "memory");
        for (int q = p - (unpublished - 1) * BATCH + lane; q < p + cnt; q += 32)
          store_relaxed(flag + q, 1);
        unpublished = 0;
      }
#pragma unroll
      for (int e = 0; e < W; ++e) r[e] = r_next[e];
      v = v_next;
      v_next = v_far;
    }
  }
}

}  // namespace

// wdp [n, c] float32 -> out [n, c] float32 over the chain layout: verts [n]
// int32 (chain k at verts[chain_ptr[k] .. chain_ptr[k + 1]), head to tail),
// chain_ptr [n + 1], head_parent [n] (the position in verts of chain k's
// head's parent, -1 for a root; always in an earlier chain), `chains`
// chains.  Columns [0, n_sum) add, [n_sum, n_sum + n_min) take the min, the
// rest the max.  work: 1 + ceil(c / 32) * n int32 of scratch, zeroed here
// on the stream.  Returns a cudaError_t.
extern "C" int inherit_scan_f32(const float* wdp, const int* verts, const int* chain_ptr,
                                const int* head_parent, int n, int c, int n_sum,
                                int n_min, int chains, int* work, float* out,
                                void* stream) {
  if (n <= 0 || c <= 0 || n_sum < 0 || n_min < 0 || n_sum + n_min > c || chains < 1 ||
      chains > n || (int64_t)n * c >= (int64_t)1 << 31)  // 32-bit row offsets
    return (int)cudaErrorInvalidValue;
  // a warp carries up to 4 columns when c <= 4, else up to 32; 16-byte row
  // accesses when every row segment is 16-byte aligned
  const int w_cols = c <= 4 ? 4 : 32;
  const bool vec4 = c % 4 == 0 && ((uintptr_t)wdp | (uintptr_t)out) % 16 == 0;
  const int variant = 2 * (w_cols == 32) + vec4;
  void (*const kernels[4])(const float*, const int*, const int*, const int*, int, int, int,
                           int, int, int, int*, int*, float*) = {
      inherit_scan_kernel<4, false>, inherit_scan_kernel<4, true>,
      inherit_scan_kernel<32, false>, inherit_scan_kernel<32, true>};
  const auto kernel = kernels[variant];
  static int resident_blocks[4] = {0, 0, 0, 0};  // the persistent grid: blocks that fit
  if (resident_blocks[variant] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    resident_blocks[variant] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int groups = (c + w_cols - 1) / w_cols;
  const int64_t items = (int64_t)chains * groups;
  if (items >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int) * (1 + (size_t)groups * n), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (items + WARPS - 1) / WARPS;
  const int blocks = (int)(want < resident_blocks[variant] ? want : resident_blocks[variant]);
  kernel<<<blocks, THREADS, 0, s>>>(wdp, verts, chain_ptr, head_parent, n, c, n_sum, n_min,
                                    groups, (int)items, work, work + 1, out);
  return (int)cudaGetLastError();
}
