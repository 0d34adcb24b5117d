// Causal GQA flash attention, forward, for bf16 on Hopper's tensor cores.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_flash_kernel`)
// for bfloat16 q/k/v with head size D in {64, 128}: the wrapper
// (kernels/flash_attention/flash_attention.py) sends exactly those calls
// here.  float32 calls, and bf16 with D in {16, 32}, stay on the CUDA-core
// kernel in flash_attention.cu: a float32 product on the tensor cores would
// be TF32, and D < 64 would need the 32- and 64-byte swizzles.
//
// q [B, Hq, S, D], k and v [B, Hkv, S, D] -> o [B, Hq, S, D] in bf16; query
// head h reads kv head h / (Hq / Hkv).  The TPU kernel's arithmetic, kept:
// the scores are a bf16 x bf16 product summed in float32 and multiplied by
// the scale after the product; the online softmax runs in float32 with the
// finite NEG_INF = -1e30 (so exp(m_prev - m_new) never makes a NaN); l sums
// the unrounded float32 p, the PV product takes p rounded to bf16 and sums
// in float32; the output is acc / max(l, 1e-30) rounded to bf16.  The one
// change: exp(x) is computed as exp2(x * log2(e)) with log2(e) folded into
// the scale.  No atomics, no split across blocks: every sum runs in a fixed
// order, so two launches give the same bits.
//
// What bounds it on an H100: operations.  The causal work is
// 2 * B * Hq * D * S * (S + 1) flops (QK^T and PV over the lower triangle)
// at 989 TFLOP/s of dense bf16 against S * D * 2 * (2 Hq + 2 Hkv) bytes at
// 3.35 TB/s: at S = 2048, D = 64 that is ~680 flops per byte, far past the
// card's ridge of ~295.  The design puts both products on wgmma and keeps
// the tensor cores fed with TMA, FlashAttention-3-shaped but kept simple:
//
//   * Block: three warpgroups.  Warpgroups 0 and 1 are consumers, each
//     owning one 64-row query tile (a "unit": one query head at one tile);
//     warpgroup 2 is the producer, one thread of which issues every TMA
//     load.  setmaxnreg gives the consumers 232 registers and the producer
//     40.  With Hq / Hkv even (qwen3: 2), a block's two units are two query
//     heads of one kv head at the same query tile: both read every K/V tile
//     loaded, and both walk the same causal extent.  Otherwise the pair is
//     two consecutive units of one kv head (G = 1: two neighbouring query
//     tiles), whose extents differ by at most one key tile.  The 1-D grid
//     walks the pairs from the longest query tiles down, heads fastest, so
//     the blocks with the most key tiles start first.
//   * TMA: 3-D tensor maps over [B*H, S, D] with a box of {64 columns, rows,
//     1} and CU_TENSOR_MAP_SWIZZLE_128B (64 bf16 are one 128-byte row; D =
//     128 is two boxes side by side).  A box row past S is zero-filled
//     within its own head, so any S >= 1 runs.  Q comes once per unit; K and
//     V come in 128-key tiles through a two-stage ring with a "full" and an
//     "empty" mbarrier per stage.  The producer loads only the tiles the
//     block's longer unit takes, so it never runs ahead of what the
//     consumers will release; a consumer whose unit is shorter (or absent)
//     still waits for each remaining tile and releases it, which keeps
//     every barrier's phases in step, and the ring drains with the last
//     tile.
//   * S = Q K^T: wgmma m64n128k16, A = Q and B = K both from shared memory
//     (both K-major: D is contiguous), D / 16 steps, float32 sums in
//     registers.
//   * Softmax in registers: a thread holds 2 rows of the 64 x 128 score
//     tile; a row's max and sum are reduced over the 4 threads of a quad
//     with __shfl_xor_sync 1 and 2.  m, l and the 64 x D float32 output
//     accumulator stay in registers.  Only the diagonal tile and a ragged
//     last tile (S not a multiple of 128) take the causal and col >= S
//     masks; tiles above the diagonal are never loaded.
//   * O += P V: wgmma m64nDk16 with A = P from registers.  The score
//     accumulator's fragment is the A-fragment layout, so p is converted
//     to bf16 pairs in place and never goes through shared memory.  B = V
//     from shared memory is MN-major (D contiguous), so the descriptor sets
//     the transpose bit for B; 128 / 16 steps.
//   * Fences: wgmma.fence before each product (the registers it reads were
//     written by ordinary code: the rescaled accumulator and P), then
//     commit_group and wait_group 0 before the registers are read.  Shared
//     memory is written only by the TMA, so no fence.proxy.async is needed;
//     fence.mbarrier_init publishes the barriers.
//   * Output: acc / max(l, 1e-30) rounded to bf16, with plain stores of bf16
//     pairs; rows past S are not written.
//
// A barrier wait that has not completed after ~2^34 clock cycles traps, so
// a fault in the ring ends the launch with an error instead of hanging the
// card.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per consumer warpgroup
constexpr int BK = 128;        // keys per K / V tile
constexpr int STAGES = 2;      // depth of the K / V ring
constexpr int CONSUMERS = 2;   // consumer warpgroups per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BOX = 64;        // columns per TMA box: one 128-byte swizzle row
constexpr int ROW_BYTES = BOX * 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WAIT_LIMIT = 1ll << 34;  // clock cycles

// Shared memory, in bytes from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows = 1024 bytes, and the wgmma descriptors
// assume tiles start on that period).
template <int D>
struct Smem {
  static constexpr int Q_TILE = BQ * D * 2;   // one consumer's Q tile
  static constexpr int KV_TILE = BK * D * 2;  // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + CONSUMERS * Q_TILE;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;  // full[], empty[], q
  static constexpr int ALLOC = BAR + 8 * (2 * STAGES + 1) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > WAIT_LIMIT) {
      __trap();
    }
  }
}

// One TMA box from the 3-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the fences and waits around them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, float32 sums.  `ss`: A and B from shared memory,
// both K-major; scale_d = 0 overwrites d.  `rs`: A from registers (the
// m64k16 fragment: 4 registers of bf16 pairs), B from shared memory
// MN-major (transpose bit set), accumulating into d.  Thread t of the
// warpgroup holds d[4i + 2j + c] = row 16 (t / 32) + (t % 32) / 4 + 8 j,
// column 8 i + 2 (t % 4) + c.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The query tile a consumer takes.  Unit u of kv head `bkv` (0 = the
// longest): query tile nqt - 1 - u / G of query head (bkv) * G + u % G;
// nkt is its number of key tiles, 0 when the block has no unit u.
struct Unit {
  int q0, head, nkt;
};

__device__ __forceinline__ Unit unit_of(int u, int bkv, int group, int s,
                                        int causal) {
  const int nqt = (s + BQ - 1) / BQ;
  if (u >= group * nqt) return {0, 0, 0};
  const int t = u / group;
  const int q0 = (nqt - 1 - t) * BQ;
  const int nkt_all = (s + BK - 1) / BK;
  const int nkt = causal ? min((q0 + BQ - 1) / BK + 1, nkt_all) : nkt_all;
  return {q0, bkv * group + (u - t * group), nkt};
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int bhkv, int group, int s,
               int causal, float scale_log2) {
  using L = Smem<D>;
  constexpr int NB = D / BOX;  // TMA boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q, k_s = base + L::K, v_s = base + L::V;
  const uint32_t full = base + L::BAR;        // full[i] at full + 8 i
  const uint32_t empty = full + 8 * STAGES;   // empty[i] at empty + 8 i
  const uint32_t q_bar = empty + 8 * STAGES;

  const int bkv = blockIdx.x % bhkv;  // b * Hkv + kv head
  const int pair = blockIdx.x / bhkv;
  const Unit u0 = unit_of(2 * pair, bkv, group, s, causal);
  const Unit u1 = unit_of(2 * pair + 1, bkv, group, s, causal);
  const int n_load = max(u0.nkt, u1.nkt);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, (u1.nkt ? 2 : 1) * L::Q_TILE);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(q_s + c * BQ * ROW_BYTES, &tm_q, q_bar, c * BOX, u0.q0, u0.head);
        if (u1.nkt)
          tma_load(q_s + L::Q_TILE + c * BQ * ROW_BYTES, &tm_q, q_bar, c * BOX,
                   u1.q0, u1.head);
      }
      for (int it = 0; it < n_load; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * L::KV_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const uint32_t off = st * L::KV_TILE + c * BK * ROW_BYTES;
          tma_load(k_s + off, &tm_k, bar, c * BOX, it * BK, bkv);
          tma_load(v_s + off, &tm_v, bar, c * BOX, it * BK, bkv);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: one 64-row query tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid / 128;
    const Unit me = wg == 0 ? u0 : u1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // its columns in each 8-column block
    const uint32_t my_q = q_s + wg * L::Q_TILE;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    if (me.nkt) mbar_wait(q_bar, 0);

    for (int it = 0; it < n_load; ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      if (it < me.nkt) {
        const uint32_t kt = k_s + st * L::KV_TILE, vt = v_s + st * L::KV_TILE;
        // S = Q K^T: 64 x 128, D / 16 steps of 16 columns (32 bytes) along
        // a 128-byte swizzled row; the next box of 64 columns after 4
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        pin(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk / 4), off = (kk % 4) * 32;
          wgmma_ss_n128(sc, sw128_desc(my_q + col * BQ * ROW_BYTES + off, 16, 1024),
                        sw128_desc(kt + col * BK * ROW_BYTES + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        pin(sc);

        // online softmax over this tile, in the log2 domain
        const int k0 = it * BK;
        const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > me.q0);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = sc[4 * i + 2 * j + c] * scale_log2;
              if (masked) {
                const int col = k0 + 8 * i + cq + c, row = me.q0 + r0 + 8 * j;
                if (col >= s || (causal && col > row)) x = NEG_INF;
              }
              sc[4 * i + 2 * j + c] = x;
              mx[j] = fmaxf(mx[j], x);
            }
          }
        }
        float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          m_new[j] = fmaxf(m[j], mx[j]);
          alpha[j] = exp2f(m[j] - m_new[j]);
          m[j] = m_new[j];
        }
        // p, unrounded into the row sums and rounded to bf16 pairs for PV:
        // p[2 i + j] holds (row r0 + 8 j, columns 8 i + cq, +1), so
        // p[4 kk .. 4 kk + 3] is the A fragment of PV step kk
        uint32_t p[BK / 4];
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p0 = exp2f(sc[4 * i + 2 * j] - m_new[j]);
            const float p1 = exp2f(sc[4 * i + 2 * j + 1] - m_new[j]);
            sum[j] += p0;
            sum[j] += p1;
            p[2 * i + j] = bf16x2(p0, p1);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
          l[j] = l[j] * alpha[j] + sum[j];
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[4 * i + 2 * j] *= alpha[j];
            acc[4 * i + 2 * j + 1] *= alpha[j];
          }
        }

        // O += P V: 128 / 16 steps of 16 keys = two 8-row swizzle atoms
        // (2048 bytes); the next box of 64 columns of V is BK rows on
        pin(acc);
        pin(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = sw128_desc(vt + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
          if constexpr (D == 64) {
            wgmma_rs_n64(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
          } else {
            wgmma_rs_n128(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        pin(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
    }

    if (me.nkt) {
      __nv_bfloat16* op = o + (int64_t)me.head * s * D;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = me.q0 + r0 + 8 * j;
        if (row >= s) continue;
        const float den = fmaxf(l[j], 1e-30f);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const uint32_t v = bf16x2(acc[4 * i + 2 * j] / den, acc[4 * i + 2 * j + 1] / den);
          *reinterpret_cast<uint32_t*>(op + (int64_t)row * D + 8 * i + cq) = v;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, s, d] bf16 in device memory, read in boxes of {64, rows, 1}.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int heads,
                int s, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int s, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(enc, &tq, q, b * hq, s, D, BQ) ||
      !tensor_map(enc, &tk, k, b * hkv, s, D, BK) ||
      !tensor_map(enc, &tv, v, b * hkv, s, D, BK))
    return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int64_t pairs = ((int64_t)group * ((s + BQ - 1) / BQ) + 1) / 2;
  const int64_t blocks = pairs * b * hkv;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_sm90<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, THREADS, Smem<D>::ALLOC, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), b * hkv, group, s, causal,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o; d in {64, 128}.  Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue for arguments or tensors the kernel does not take
// (including a tensor map the driver refuses), cudaErrorNotSupported when
// the driver has no tensor-map encoder.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                        void* o, int b, int hq, int hkv, int s, int d,
                                        int causal, float scale, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
  if (d == 128) return launch<128>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
