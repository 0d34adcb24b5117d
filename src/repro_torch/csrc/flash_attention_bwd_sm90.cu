// Causal GQA flash attention, backward, for bf16 on Hopper's tensor cores.
//
// Replaces no TPU kernel: the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py has no backward, and
// off the TPU the reference trains through autodiff of `flash_jnp`
// (src/repro/models/attention.py).  This is the backward of the port's K3
// for bfloat16 q/k/v with head size D in {64, 128}, the calls the wrapper
// (kernels/flash_attention/flash_attention.py, `bwd_route`) sends here.
// float32 calls, and bf16 with D in {16, 32}, stay on the CUDA-core backward
// in flash_attention_bwd.cu: a float32 product on the tensor cores would be
// TF32, and D < 64 would need the 32- and 64-byte swizzles.
//
// Given q [B, Hq, S, D], k and v [B, Hkv, S, D], the forward's output o and
// its gradient dO [B, Hq, S, D], it computes dq, dk, dv in bf16; query head
// h reads kv head h / (Hq / Hkv).  With s_ij = scale q_i . k_j (masked: j > i
// under causal, or j >= S) and p_ij = exp(s_ij - lse_i):
//
//   delta_i = sum_d dO_id o_id        dv_j = sum_i p_ij dO_i
//   dp_ij   = dO_i . v_j              ds_ij = p_ij (dp_ij - delta_i)
//   dq_i    = scale sum_j ds_ij k_j   dk_j  = scale sum_i ds_ij q_i
//
// What bounds it on an H100: operations.  The least work is five causal
// products of S x S x D a query head (q k^T, dO v^T, p^T dO, ds^T q, ds k),
// 5 B Hq D S (S + 1) flops at 989 TFLOP/s of dense bf16, against ~30 bytes
// a row of q, k, v, o, dO, dq, dk, dv at 3.35 TB/s: hundreds of flops a byte
// at training lengths, far past the card's ridge of ~295.  The design puts
// every product on wgmma, feeds it with TMA, and keeps every sum in float32
// registers.  Three launches on the caller's stream, each a block of three
// warpgroups: two consumers and a producer, one thread of which issues
// every TMA load into two-stage rings with full / empty mbarriers
// (setmaxnreg: consumers 232 registers, producer 40):
//
//   1. stats: one block per pair of units (a unit is one query head at one
//      64-row query tile), paired as the forward pairs them: two query heads
//      of one kv head at one tile when Hq / Hkv is even, else two
//      neighbouring tiles of one head.  Each consumer computes S = Q K^T
//      (m64n128k16, both operands K-major in shared memory) over 128-key
//      tiles, with the forward's online max and sum, and writes lse_i (log2
//      domain) and delta_i = sum dO o (float32, from plain 16-byte loads)
//      into float32 scratch of B * Hq * round_up(S, 64).
//   2. dK / dV: one block per (b x kv head, 128-key tile); each consumer
//      owns 64 of the keys, its K and V rows resident in shared memory.  The
//      block walks the G query heads and the 64-row query tiles at or after
//      its key tile; the ring brings each step's Q and dO tiles and their 64
//      lse and delta values (bulk copies).  A step is four products: S^T =
//      K Q^T and dP^T = V dO^T (shared x shared, two commit groups, so that
//      P^T = exp2(scale S^T - lse) is computed while dP^T is still on the
//      tensor cores), dS^T = P^T (dP^T - delta) in registers (masks only on
//      diagonal and ragged tiles), then dV += P^T dO and dK += dS^T Q with A
//      from registers (the score accumulator's fragment is the A-fragment
//      layout, rounded to bf16 pairs in place) and B = dO or Q MN-major (the
//      transpose bit, as the forward's PV product).  Each kv head's key rows
//      are one block's, so the sums need no atomics.
//   3. dQ: one block per pair of units, as in 1.  Q and dO stay in shared
//      memory; the ring brings K and V tiles (128 keys at D = 64, 64 at D =
//      128, where the 64 x D sums already take 64 registers) at or before
//      the diagonal.  Three products a step: S = Q K^T, dP = dO V^T (P again
//      computed while dP runs), then dQ += dS K with B = K MN-major.
//
// That is eight products against the bound's five (the stats and dQ passes
// recompute Q K^T, dQ recomputes dO V^T).  P and dS are rounded to bf16 as
// wgmma's A operand; every sum is float32.  S not a multiple of a tile is
// handled by TMA's zero fill within a head (3-D tensor maps over [B*H, S,
// D]); tiles above the diagonal are never loaded under causal; grids run
// the longest blocks first.  No atomics and no split across blocks: every
// sum runs in a fixed order, so two launches give the same bits.  A barrier
// wait that has not completed after ~2^34 clock cycles traps, so a fault in
// a ring ends the launch with an error instead of hanging the card.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a consumer of the stats and dQ passes owns
constexpr int BKV = 64;       // keys a consumer of the dK / dV pass owns
constexpr int STAGES = 2;     // depth of every ring
constexpr int CONSUMERS = 2;  // consumer warpgroups per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BOX = 64;       // columns per TMA box: one 128-byte swizzle row
constexpr int ROW_BYTES = BOX * 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long WAIT_LIMIT = 1ll << 34;  // clock cycles

// Keys of a streamed K tile in the stats pass, and of a streamed K / V
// tile in the dQ pass by head size: 128 where the registers allow (fewer,
// larger steps), 64 for dQ at D = 128, whose 64 x D float32 sums hold 64
// registers a thread.  The dK / dV pass streams BQ query rows a step (its
// two sums with 128-row steps spilled at D = 64).
constexpr int STATS_KEYS = 128;
__host__ __device__ constexpr int dq_keys(int d) { return d == 64 ? 128 : 64; }

// A tile of R rows (64 or 128) of D bf16 columns: D / 64 boxes of [R rows]
// [128 bytes], box c at c * R * 128 bytes, 128-byte swizzled, as TMA
// writes it (64 rows a copy).  Shared memory offsets are in bytes from a
// 1024-byte-aligned base (the swizzle repeats every 8 rows = 1024 bytes).
template <int R, int D>
__host__ __device__ constexpr int tile_bytes() { return R * D * 2; }

template <int D>
struct StatsSmem {  // Q of both units, a ring of K tiles
  static constexpr int KT = tile_bytes<STATS_KEYS, D>();
  static constexpr int Q = 0;
  static constexpr int K = Q + CONSUMERS * tile_bytes<BQ, D>();
  static constexpr int BAR = K + STAGES * KT;  // full[], empty[], q
  static constexpr int ALLOC = BAR + 8 * (2 * STAGES + 1) + 1024;
};
template <int D>
struct DkdvSmem {  // K and V of both consumers; a ring of Q, dO, lse, delta
  static constexpr int QT = tile_bytes<BQ, D>();
  static constexpr int VEC = BQ * 4;  // one step's lse or delta values
  static constexpr int K = 0;
  static constexpr int V = K + CONSUMERS * tile_bytes<BKV, D>();
  static constexpr int Q = V + CONSUMERS * tile_bytes<BKV, D>();
  static constexpr int DO = Q + STAGES * QT;
  static constexpr int LSE = DO + STAGES * QT;
  static constexpr int DL = LSE + STAGES * VEC;
  static constexpr int BAR = DL + STAGES * VEC;  // full[], empty[], kv
  static constexpr int ALLOC = BAR + 8 * (2 * STAGES + 1) + 1024;
};
template <int D>
struct DqSmem {  // Q and dO of both units; a ring of K and V
  static constexpr int KT = tile_bytes<dq_keys(D), D>();
  static constexpr int Q = 0;
  static constexpr int DO = Q + CONSUMERS * tile_bytes<BQ, D>();
  static constexpr int K = DO + CONSUMERS * tile_bytes<BQ, D>();
  static constexpr int V = K + STAGES * KT;
  static constexpr int BAR = V + STAGES * KT;  // full[], empty[], q
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

// An R-row tile (rows [row, row + R) of head `head`): every box, 64 rows a
// copy.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < D / BOX; ++c)
#pragma unroll
    for (int h = 0; h < R / 64; ++h)
      tma_load(dst + c * R * ROW_BYTES + h * 64 * ROW_BYTES, map, bar, c * BOX, row + 64 * h,
               head);
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A value the compiler may not hoist out of the loop it is computed in:
// the descriptors below are rebuilt from it at each use, so a loop over
// the query tiles does not keep sixteen 64-bit descriptors of its resident
// K and V tiles live in registers (which spilled at D = 128).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// Descriptors of an R-row tile at `tile` (or of 64 rows from `tile` on, as
// an A operand), step kk (16 deep): read K-major (D is the depth: 32 bytes
// along a 128-byte swizzled row, the next box after 4 steps) ...
template <int R>
struct KMajor {
  uint64_t d0;
  __device__ __forceinline__ explicit KMajor(uint32_t tile)
      : d0(sw128_desc(opaque(tile), 16, 1024)) {}
  __device__ __forceinline__ uint64_t at(int kk) const {
    return d0 + (uint64_t)(((kk / 4) * R * ROW_BYTES + (kk % 4) * 32) >> 4);
  }
};
// ... or MN-major (the rows are the depth: 16 rows = two 8-row swizzle
// atoms a step; the next 64 columns are the next box, R rows on).  The
// start address field (14 bits of 16 bytes) holds any shared address, so
// an offset adds to the descriptor without a carry out of the field.
template <int R>
struct MNMajor {
  uint64_t d0;
  __device__ __forceinline__ explicit MNMajor(uint32_t tile)
      : d0(sw128_desc(opaque(tile), R * ROW_BYTES, 1024)) {}
  __device__ __forceinline__ uint64_t at(int kk) const {
    return d0 + (uint64_t)((kk * 16 * ROW_BYTES) >> 4);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// d [64 x N] = A B^T over the depth D: A the 64 rows at `a` of an RA-row
// tile, B an N-row tile, both K-major.
template <int D, int RA, int N>
__device__ __forceinline__ void product_abt(float (&d)[N / 2], uint32_t a, uint32_t b) {
  const KMajor<RA> da(a);
  const KMajor<N> db(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (N == 64) {
      wgmma_ss_n64(d, da.at(kk), db.at(kk), kk > 0);
    } else {
      wgmma_ss_n128(d, da.at(kk), db.at(kk), kk > 0);
    }
  }
}

// acc [64 x D] += X B: X [64 x K] from registers (x[2 i + j] holds row
// r0 + 8 j, columns 8 i + cq and + 1, so x[4 kk .. 4 kk + 3] is the A
// fragment of step kk), B a K-row tile read MN-major.
template <int D, int K>
__device__ __forceinline__ void product_xb(float (&acc)[D / 2], const uint32_t (&x)[K / 4],
                                           uint32_t b) {
  const MNMajor<K> db(b);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(acc, x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3], db.at(kk));
    } else {
      wgmma_rs_n128(acc, x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3], db.at(kk));
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The query tile a consumer of the stats and dQ passes takes.  Unit u of
// kv head `bkv` (0 = the longest): query tile nqt - 1 - u / G of query head
// (bkv) * G + u % G; nkt is its number of `keys`-wide key tiles, 0 when the
// block has no unit u.
struct Unit {
  int q0, head, nkt;
};

__device__ __forceinline__ Unit unit_of(int u, int bkv, int group, int s, int causal,
                                        int keys) {
  const int nqt = (s + BQ - 1) / BQ;
  if (u >= group * nqt) return {0, 0, 0};
  const int t = u / group;
  const int q0 = (nqt - 1 - t) * BQ;
  const int nkt_all = (s + keys - 1) / keys;
  const int nkt = causal ? min((q0 + BQ - 1) / keys + 1, nkt_all) : nkt_all;
  return {q0, bkv * group + (u - t * group), nkt};
}

// Store a [64 x D] float32 accumulator times `mul` as bf16 rows [row0, s)
// of the [s, D] matrix at `out`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           int row0, int r0, int cq, int s, float mul) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + r0 + 8 * j;
    if (row >= s) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t v = bf16x2(acc[4 * i + 2 * j] * mul, acc[4 * i + 2 * j + 1] * mul);
      *reinterpret_cast<uint32_t*>(out + (int64_t)row * D + 8 * i + cq) = v;
    }
  }
}

// 1. lse (log2 domain) and delta of every query row, the rows of the last
// 64-row tile past S included (zero-score rows: finite lse, delta 0).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_stats_sm90(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout, float* __restrict__ lse,
                     float* __restrict__ delta, int bhkv, int group, int s, int sp,
                     int causal, float scale_log2) {
  using L = StatsSmem<D>;
  constexpr int NK = STATS_KEYS;
  constexpr int QT = tile_bytes<BQ, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q, k_s = base + L::K;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, q_bar = empty + 8 * STAGES;

  const int bkv = blockIdx.x % bhkv;
  const int pair = blockIdx.x / bhkv;
  const Unit u0 = unit_of(2 * pair, bkv, group, s, causal, NK);
  const Unit u1 = unit_of(2 * pair + 1, bkv, group, s, causal, NK);
  const int n_load = max(u0.nkt, u1.nkt);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, (u1.nkt ? 2 : 1) * QT);
      load_tile<BQ, D>(q_s, &tm_q, q_bar, u0.q0, u0.head);
      if (u1.nkt) load_tile<BQ, D>(q_s + QT, &tm_q, q_bar, u1.q0, u1.head);
      for (int it = 0; it < n_load; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * st, L::KT);
        load_tile<NK, D>(k_s + st * L::KT, &tm_k, full + 8 * st, it * NK, bkv);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid / 128, t = tid % 128;
    const Unit me = wg == 0 ? u0 : u1;
    const int warp = t / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
    const uint32_t my_q = q_s + wg * QT;

    if (me.nkt) {
      // delta: two threads a row, D / 2 columns each in 16-byte loads
      const int row = me.q0 + t / 2, half = t % 2;
      float acc = 0.f;
      if (row < s) {
        const int64_t at = ((int64_t)me.head * s + row) * D + half * (D / 2);
        const uint4* a = reinterpret_cast<const uint4*>(dout + at);
        const uint4* b = reinterpret_cast<const uint4*>(o + at);
#pragma unroll
        for (int v = 0; v < D / 16; ++v) {
          const uint4 x = a[v], y = b[v];
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
            const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) delta[(int64_t)me.head * sp + row] = acc;
      mbar_wait(q_bar, 0);
    }

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n_load; ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      if (it < me.nkt) {
        float sc[NK / 2];
        zero(sc);
        pin(sc);
        wgmma_fence();
        product_abt<D, BQ, NK>(sc, my_q, k_s + st * L::KT);
        wgmma_commit();
        wgmma_wait<0>();
        pin(sc);
        const int k0 = it * NK;
        const bool masked = k0 + NK > s || (causal && k0 + NK - 1 > me.q0);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < NK / 8; ++i) {
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
        float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          m_new[j] = fmaxf(m[j], mx[j]);
        }
#pragma unroll
        for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sum[j] += exp2f(sc[4 * i + 2 * j] - m_new[j]);
            sum[j] += exp2f(sc[4 * i + 2 * j + 1] - m_new[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
          l[j] = l[j] * exp2f(m[j] - m_new[j]) + sum[j];
          m[j] = m_new[j];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    if (me.nkt && lane % 4 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        lse[(int64_t)me.head * sp + me.q0 + r0 + 8 * j] = m[j] + log2f(l[j]);
    }
  }
}

// 2. dk and dv of one 128-key tile of one kv head: consumer w owns keys
// [k0 + 64 w, k0 + 64 w + 64); each step brings NQ query rows.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int bhkv,
                    int group, int s, int sp, int causal, float scale_log2, float scale) {
  using L = DkdvSmem<D>;
  constexpr int NQ = BQ;  // query rows a step brings
  constexpr int KT = tile_bytes<BKV, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base + L::K, v_s = base + L::V, q_s = base + L::Q,
                 do_s = base + L::DO, lse_s = base + L::LSE, dl_s = base + L::DL;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, kv_bar = empty + 8 * STAGES;
  // the same lse / delta stages as generic pointers, for the consumers' reads
  const float* lse_p = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::LSE);
  const float* dl_p = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::DL);

  const int bkv = blockIdx.x % bhkv;
  const int k0 = (blockIdx.x / bhkv) * CONSUMERS * BKV;  // the first key tiles have the most rows
  const int nqt = (s + NQ - 1) / NQ;
  const int qt0 = causal ? k0 / NQ : 0;
  const int per_head = nqt - qt0;
  const int n_load = group * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS * 128) {
      // a consumer whose keys all lie past S loads nothing (and computes nothing)
      const int n_kv = k0 + BKV < s ? CONSUMERS : 1;
      mbar_expect_tx(kv_bar, 2 * n_kv * KT);
      for (int w = 0; w < n_kv; ++w) {
        load_tile<BKV, D>(k_s + w * KT, &tm_k, kv_bar, k0 + w * BKV, bkv);
        load_tile<BKV, D>(v_s + w * KT, &tm_v, kv_bar, k0 + w * BKV, bkv);
      }
      for (int it = 0; it < n_load; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
        const int g = it / per_head, q0 = (qt0 + it - g * per_head) * NQ;
        const int head = bkv * group + g;
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * L::QT + 2 * L::VEC);
        load_tile<NQ, D>(q_s + st * L::QT, &tm_q, bar, q0, head);
        load_tile<NQ, D>(do_s + st * L::QT, &tm_do, bar, q0, head);
        const int64_t at = (int64_t)head * sp + q0;
        bulk_load(lse_s + st * L::VEC, lse + at, L::VEC, bar);
        bulk_load(dl_s + st * L::VEC, delta + at, L::VEC, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
    const int kw0 = k0 + wg * BKV;  // this consumer's first key
    const bool active = kw0 < s;
    const uint32_t my_k = k_s + wg * KT, my_v = v_s + wg * KT;

    float acc_dk[D / 2], acc_dv[D / 2];
    zero(acc_dk);
    zero(acc_dv);
    if (active) mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_load; ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      const int g = it / per_head, q0 = (qt0 + it - g * per_head) * NQ;
      if (active && !(causal && q0 + NQ - 1 < kw0)) {
        const uint32_t qt = q_s + st * L::QT, dot = do_s + st * L::QT;
        // S^T = K Q^T and dP^T = V dO^T (rows are keys, columns queries),
        // two groups: P^T is computed while dP^T is still on the tensor cores
        float sc[NQ / 2], dp[NQ / 2];
        zero(sc);
        zero(dp);
        pin(sc);
        pin(dp);
        wgmma_fence();
        product_abt<D, BKV, NQ>(sc, my_k, qt);
        wgmma_commit();
        product_abt<D, BKV, NQ>(dp, my_v, dot);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);

        const bool masked =
            q0 + NQ > s || kw0 + BKV > s || (causal && kw0 + BKV - 1 > q0);
        const float* lse_t = lse_p + st * NQ;
        const float* dl_t = dl_p + st * NQ;
#pragma unroll
        for (int i = 0; i < NQ / 8; ++i) {
          const float2 lv = *reinterpret_cast<const float2*>(lse_t + 8 * i + cq);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * i + 2 * j + c;
              float p = exp2f(sc[e] * scale_log2 - (c ? lv.y : lv.x));
              if (masked) {
                const int key = kw0 + r0 + 8 * j, col = q0 + 8 * i + cq + c;
                if (col >= s || key >= s || (causal && key > col)) p = 0.f;
              }
              sc[e] = p;
            }
          }
        }
        wgmma_wait<0>();
        pin(dp);
        // dS^T = P^T (dP^T - delta) and P^T, rounded to bf16 pairs (in
        // this order: packing P^T first spilled at D = 128)
        uint32_t pp[NQ / 4], dd[NQ / 4];
#pragma unroll
        for (int i = 0; i < NQ / 8; ++i) {
          const float2 dlv = *reinterpret_cast<const float2*>(dl_t + 8 * i + cq);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * i + 2 * j;
            dd[2 * i + j] = bf16x2(sc[e] * (dp[e] - dlv.x), sc[e + 1] * (dp[e + 1] - dlv.y));
            pp[2 * i + j] = bf16x2(sc[e], sc[e + 1]);
          }
        }

        // dV += P^T dO, dK += dS^T Q
        pin(acc_dv);
        pin(acc_dk);
        pin(pp);
        pin(dd);
        wgmma_fence();
        product_xb<D, NQ>(acc_dv, pp, dot);
        product_xb<D, NQ>(acc_dk, dd, qt);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc_dv);
        pin(acc_dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
    }

    if (active) {
      const int64_t at = (int64_t)bkv * s * D;
      store_rows<D>(dk + at, acc_dk, kw0, r0, cq, s, scale);
      store_rows<D>(dv + at, acc_dv, kw0, r0, cq, s, 1.f);
    }
  }
}

// 3. dq of one 64-row query tile per consumer.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int bhkv, int group, int s, int sp,
                  int causal, float scale_log2, float scale) {
  using L = DqSmem<D>;
  constexpr int NK = dq_keys(D);
  constexpr int QT = tile_bytes<BQ, D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q, do_s = base + L::DO, k_s = base + L::K, v_s = base + L::V;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES, q_bar = empty + 8 * STAGES;

  const int bkv = blockIdx.x % bhkv;
  const int pair = blockIdx.x / bhkv;
  const Unit u0 = unit_of(2 * pair, bkv, group, s, causal, NK);
  const Unit u1 = unit_of(2 * pair + 1, bkv, group, s, causal, NK);
  const int n_load = max(u0.nkt, u1.nkt);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, (u1.nkt ? 2 : 1) * 2 * QT);
      load_tile<BQ, D>(q_s, &tm_q, q_bar, u0.q0, u0.head);
      load_tile<BQ, D>(do_s, &tm_do, q_bar, u0.q0, u0.head);
      if (u1.nkt) {
        load_tile<BQ, D>(q_s + QT, &tm_q, q_bar, u1.q0, u1.head);
        load_tile<BQ, D>(do_s + QT, &tm_do, q_bar, u1.q0, u1.head);
      }
      for (int it = 0; it < n_load; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * L::KT);
        load_tile<NK, D>(k_s + st * L::KT, &tm_k, bar, it * NK, bkv);
        load_tile<NK, D>(v_s + st * L::KT, &tm_v, bar, it * NK, bkv);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid / 128;
    const Unit me = wg == 0 ? u0 : u1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
    const uint32_t my_q = q_s + wg * QT, my_do = do_s + wg * QT;

    float acc[D / 2];
    zero(acc);
    float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
    if (me.nkt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t at = (int64_t)me.head * sp + me.q0 + r0 + 8 * j;
        lse_r[j] = lse[at];
        dl_r[j] = delta[at];
      }
      mbar_wait(q_bar, 0);
    }

    for (int it = 0; it < n_load; ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      if (it < me.nkt) {
        const uint32_t kt = k_s + st * L::KT, vt = v_s + st * L::KT;
        // S = Q K^T and dP = dO V^T, two groups: P is computed while dP is
        // still on the tensor cores
        float sc[NK / 2], dp[NK / 2];
        zero(sc);
        zero(dp);
        pin(sc);
        pin(dp);
        wgmma_fence();
        product_abt<D, BQ, NK>(sc, my_q, kt);
        wgmma_commit();
        product_abt<D, BQ, NK>(dp, my_do, vt);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);

        const int k0 = it * NK;
        const bool masked = k0 + NK > s || (causal && k0 + NK - 1 > me.q0);
#pragma unroll
        for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * i + 2 * j + c;
              float p = exp2f(sc[e] * scale_log2 - lse_r[j]);
              if (masked) {
                const int col = k0 + 8 * i + cq + c, row = me.q0 + r0 + 8 * j;
                if (col >= s || (causal && col > row)) p = 0.f;
              }
              sc[e] = p;
            }
          }
        }
        wgmma_wait<0>();
        pin(dp);
        uint32_t dd[NK / 4];
#pragma unroll
        for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * i + 2 * j;
            dd[2 * i + j] = bf16x2(sc[e] * (dp[e] - dl_r[j]), sc[e + 1] * (dp[e + 1] - dl_r[j]));
          }
        }

        // dQ += dS K
        pin(acc);
        pin(dd);
        wgmma_fence();
        product_xb<D, NK>(acc, dd, kt);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    if (me.nkt) store_rows<D>(dq + (int64_t)me.head * s * D, acc, me.q0, r0, cq, s, scale);
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

// [heads, s, d] bf16 in device memory, read in boxes of {64, 64, 1}.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int heads, int s,
                int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int b, int hq, int hkv,
           int s, int causal, float scale, cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(enc, &tq, q, b * hq, s, D) || !tensor_map(enc, &tk, k, b * hkv, s, D) ||
      !tensor_map(enc, &tv, v, b * hkv, s, D) || !tensor_map(enc, &tdo, dout, b * hq, s, D))
    return (int)cudaErrorInvalidValue;
  const int group = hq / hkv, bhkv = b * hkv;
  const int sp = (s + BQ - 1) / BQ * BQ;
  const int64_t pairs = ((int64_t)group * ((s + BQ - 1) / BQ) + 1) / 2;
  const int64_t unit_blocks = pairs * bhkv;
  const int64_t key_blocks =
      (int64_t)((s + CONSUMERS * BKV - 1) / (CONSUMERS * BKV)) * bhkv;
  if (unit_blocks > 0x7fffffff || key_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  const auto* o_ = static_cast<const __nv_bfloat16*>(o);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  cudaError_t e;

  auto stats = flash_bwd_stats_sm90<D>;
  if ((e = allow_smem(stats, StatsSmem<D>::ALLOC)) != cudaSuccess) return (int)e;
  stats<<<(unsigned)unit_blocks, THREADS, StatsSmem<D>::ALLOC, st>>>(
      tq, tk, o_, do_, lse, delta, bhkv, group, s, sp, causal, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto dkdv = flash_bwd_dkdv_sm90<D>;
  if ((e = allow_smem(dkdv, DkdvSmem<D>::ALLOC)) != cudaSuccess) return (int)e;
  dkdv<<<(unsigned)key_blocks, THREADS, DkdvSmem<D>::ALLOC, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bhkv, group, s, sp, causal, scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_sm90<D>;
  if ((e = allow_smem(dqk, DqSmem<D>::ALLOC)) != cudaSuccess) return (int)e;
  dqk<<<(unsigned)unit_blocks, THREADS, DqSmem<D>::ALLOC, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), bhkv, group, s, sp,
      causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// bf16 q, k, v, o, dout, dq, dk, dv; d in {64, 128}; every pointer 16-byte
// aligned.  lse and delta: float32 scratch of B * Hq * round_up(S, 64)
// each.  Three launches on `stream`.  Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue for arguments or tensors the kernels do not take
// (including a tensor map the driver refuses), cudaErrorNotSupported when
// the driver has no tensor-map encoder.
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, void* dq,
                                        void* dk, void* dv, float* lse, float* delta,
                                        int b, int hq, int hkv, int s, int d, int causal,
                                        float scale, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[10] = {q, k, v, o, dout, dq, dk, dv, lse, delta};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
  if (d == 128) return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
