// Causal GQA flash attention, backward (bf16 or float32 in, float32 sums), on
// the CUDA cores.
//
// The TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py has no backward: off
// the TPU the reference trains through `flash_jnp`, whose streaming softmax
// autodiff differentiates (src/repro/models/attention.py).  This file is
// the backward of the port's K3 (flash_attention.cu, flash_attention_sm90.cu)
// so that training on the card takes gradients through the kernel and never
// through autograd of the plain version.
//
// Given q [B, Hq, S, D], k and v [B, Hkv, S, D], the forward's output o
// [B, Hq, S, D] and its gradient dO, it computes dq, dk and dv in the inputs'
// type; query head h reads kv head h / (Hq / Hkv).  With s_ij = scale *
// q_i . k_j (masked: j > i under causal, or j >= S), p_ij = exp(s_ij - lse_i):
//
//   delta_i = sum_d dO_id o_id        dv_j = sum_i p_ij dO_i
//   dp_ij   = dO_i . v_j              ds_ij = p_ij (dp_ij - delta_i)
//   dq_i    = scale sum_j ds_ij k_j   dk_j  = scale sum_i ds_ij q_i
//
// Three launches on the caller's stream:
//
//   1. stats: one block per (b x query head, 64-row query tile) recomputes
//      each row's log-sum-exp of its scaled, masked scores from q and k (the
//      forward's online max and sum) and delta_i, into float32 scratch;
//   2. dK, dV: one block per (b x kv head, 64-key tile).  It holds its K and
//      V tiles, loops over the G query heads of its kv head and over the
//      query tiles at or after its key tile, and sums dk and dv in
//      registers: each kv head's gradient is one block's, so no atomics;
//   3. dQ: one block per (b x query head, 64-row query tile), looping over
//      the key tiles at or before it and summing dq in registers.
//
// Every tile is staged in shared memory as float32, q, k, v and dO
// transposed ([D][64 + 4]) so that a thread reads its 4 rows or 4 keys at
// one depth as a float4; a 16 x 16 thread grid owns 4 x 4 score entries a
// thread; the products p^T dO, ds^T q and ds k read their tiles from the
// same transposed copies, a thread owning 4 rows (or keys) and the columns
// tx, tx + 16, ....  Every sum runs in a fixed order: two launches on the
// same inputs give the same bits.
//
// What bounds it on an H100: operations.  The least work is five causal
// products of S x S x D per head (q k^T, dO v^T, p^T dO, ds^T q, ds k);
// this design does eight (the stats and the dQ pass recompute q k^T, the
// dQ pass dO v^T) on the CUDA cores in float32, far below the bf16
// tensor-core bound.  It is written to be right and simple: no wgmma, no
// TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile (== BQ: tile kt > qt is masked)
constexpr int TS = BQ + 4;  // row stride of the transposed tiles
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a [s, D] matrix, transposed into t [D][TS] as
// float32 (zero past s)
template <typename T, int D>
__device__ __forceinline__ void load_t(const T* __restrict__ src, int r0, int s,
                                       float* t) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    t[d * TS + r] = (r0 + r < s) ? to_f32(src[(int64_t)(r0 + r) * D + d]) : 0.f;
  }
}

// sc[i][j] = sum_d a[d][4ty + i] * b[d][4tx + j] over two transposed tiles
template <int D>
__device__ __forceinline__ void tile_product(const float* a, const float* b,
                                             int ty, int tx, float (&sc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = *reinterpret_cast<const float4*>(a + d * TS + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + d * TS + tx * 4);
    const float aa[4] = {av.x, av.y, av.z, av.w};
    const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(aa[i], ba[j], sc[i][j]);
  }
}

// p and ds of a 4 x 4 score patch: rows q0 + 4ty + i, keys k0 + 4tx + j
__device__ __forceinline__ void probs(float (&sc)[4][4], float (&dp)[4][4],
                                      const float* lse_s, const float* dl_s,
                                      int q0, int k0, int ty, int tx, int s,
                                      int causal, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float lse = lse_s[ty * 4 + i], dl = dl_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool ok = row < s && col < s && !(causal && col > row);
      const float p = ok ? expf(sc[i][j] * scale - lse) : 0.f;
      sc[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl);
    }
  }
}

template <typename T, int D>
constexpr size_t stats_smem() { return (size_t)2 * D * TS * sizeof(float); }
template <typename T, int D>
constexpr size_t dkdv_smem() {
  return ((size_t)4 * D * TS + (size_t)2 * BQ * TS + 2 * BQ) * sizeof(float);
}
template <typename T, int D>
constexpr size_t dq_smem() {
  return ((size_t)4 * D * TS + (size_t)BK * TS + 2 * BQ) * sizeof(float);
}

// 1. lse_i and delta_i of every query row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ lse, float* __restrict__ delta,
                       int hq, int hkv, int s, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;           // [D][TS]
  float* kt_s = qt_s + D * TS;  // [D][TS]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nqt = (s + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const T* kp = k + ((int64_t)b * hkv + kvh) * s * D;
  load_t<T, D>(q + (int64_t)bh * s * D, q0, s, qt_s);

  // delta: 4 threads a row, each a quarter of the row, then two shuffles
  {
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < s) {
      const int64_t base = ((int64_t)bh * s + q0 + r) * D;
#pragma unroll 4
      for (int d = part * (D / 4); d < (part + 1) * (D / 4); ++d)
        acc = fmaf(to_f32(dout[base + d]), to_f32(o[base + d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && q0 + r < s) delta[(int64_t)bh * s + q0 + r] = acc;
  }

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
  const int nkt_all = (s + BK - 1) / BK;
  const int nkt = causal ? min(qt + 1, nkt_all) : nkt_all;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_t<T, D>(kp, k0, s, kt_s);
    __syncthreads();
    float sc[4][4];
    tile_product<D>(qt_s, kt_s, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = sc[i][j] * scale;
        if (col >= s || (causal && col > row)) x = NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(sc[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < s) lse[(int64_t)bh * s + row] = m[i] + logf(l[i]);
    }
  }
}

// 2. dk and dv of one 64-key tile of one kv head
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                      int s, int causal, float scale) {
  constexpr int DC = D / 16;  // columns a thread owns: tx, tx + 16, ...
  extern __shared__ __align__(16) float smem[];
  float* kt_s = smem;            // [D][TS]
  float* vt_s = kt_s + D * TS;   // [D][TS]
  float* qt_s = vt_s + D * TS;   // [D][TS]
  float* ot_s = qt_s + D * TS;   // [D][TS]  dO transposed
  float* p_s = ot_s + D * TS;    // [BQ][TS] p, row-major by query
  float* ds_s = p_s + BQ * TS;   // [BQ][TS] ds
  float* lse_s = ds_s + BQ * TS; // [BQ]
  float* dl_s = lse_s + BQ;      // [BQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x;  // under causal, the first key tiles have the most rows
  const int bkv = blockIdx.y, b = bkv / hkv, kvh = bkv - b * hkv;
  const int group = hq / hkv;
  const int k0 = kt * BK;
  const int64_t kv_off = (int64_t)bkv * s * D;
  load_t<T, D>(k + kv_off, k0, s, kt_s);
  load_t<T, D>(v + kv_off, k0, s, vt_s);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) { dka[j][c] = 0.f; dva[j][c] = 0.f; }

  const int nqt = (s + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + kvh * group + g;
    const int64_t q_off = (int64_t)bh * s * D;
    for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's readers are done
      load_t<T, D>(q + q_off, q0, s, qt_s);
      load_t<T, D>(dout + q_off, q0, s, ot_s);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool ok = q0 + r < s;
        lse_s[r] = ok ? lse[(int64_t)bh * s + q0 + r] : 0.f;
        dl_s[r] = ok ? delta[(int64_t)bh * s + q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      tile_product<D>(qt_s, kt_s, ty, tx, sc);
      tile_product<D>(ot_s, vt_s, ty, tx, dp);
      probs(sc, dp, lse_s, dl_s, q0, k0, ty, tx, s, causal, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * TS + tx * 4) =
            make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
        *reinterpret_cast<float4*>(ds_s + (ty * 4 + i) * TS + tx * 4) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      __syncthreads();
      // dv[keys 4ty+j, cols] += p[i, keys] dO[i, cols]; dk likewise with ds, q
      const int iend = min(BQ, s - q0);
      for (int i = 0; i < iend; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + i * TS + ty * 4);
        const float4 dsv = *reinterpret_cast<const float4*>(ds_s + i * TS + ty * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float da[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float oc = ot_s[(tx + 16 * c) * TS + i];
          const float qc = qt_s[(tx + 16 * c) * TS + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dva[j][c] = fmaf(pa[j], oc, dva[j][c]);
            dka[j][c] = fmaf(da[j], qc, dka[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key >= s) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int64_t at = kv_off + (int64_t)key * D + tx + 16 * c;
      dk[at] = from_f32<T>(dka[j][c] * scale);
      dv[at] = from_f32<T>(dva[j][c]);
    }
  }
}

// 3. dq of one 64-row query tile of one query head
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int hq, int hkv, int s, int causal,
                    float scale) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;             // [D][TS]
  float* ot_s = qt_s + D * TS;    // [D][TS]
  float* kt_s = ot_s + D * TS;    // [D][TS]
  float* vt_s = kt_s + D * TS;    // [D][TS]
  float* dst_s = vt_s + D * TS;   // [BK][TS] ds transposed
  float* lse_s = dst_s + BK * TS; // [BQ]
  float* dl_s = lse_s + BQ;       // [BQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nqt = (s + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int64_t q_off = (int64_t)bh * s * D;
  const int64_t kv_off = ((int64_t)b * hkv + kvh) * s * D;
  load_t<T, D>(q + q_off, q0, s, qt_s);
  load_t<T, D>(dout + q_off, q0, s, ot_s);
  for (int r = tid; r < BQ; r += THREADS) {
    const bool ok = q0 + r < s;
    lse_s[r] = ok ? lse[(int64_t)bh * s + q0 + r] : 0.f;
    dl_s[r] = ok ? delta[(int64_t)bh * s + q0 + r] : 0.f;
  }

  float dqa[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  const int nkt_all = (s + BK - 1) / BK;
  const int nkt = causal ? min(qt + 1, nkt_all) : nkt_all;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_t<T, D>(k + kv_off, k0, s, kt_s);
    load_t<T, D>(v + kv_off, k0, s, vt_s);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_product<D>(qt_s, kt_s, ty, tx, sc);
    tile_product<D>(ot_s, vt_s, ty, tx, dp);
    probs(sc, dp, lse_s, dl_s, q0, k0, ty, tx, s, causal, scale);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst_s + (tx * 4 + j) * TS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    // dq[rows 4ty+i, cols] += ds[rows, j] k[j, cols]
    const int jend = min(BK, s - k0);
    for (int j = 0; j < jend; ++j) {
      const float4 dsv = *reinterpret_cast<const float4*>(dst_s + j * TS + ty * 4);
      const float da[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kc = kt_s[(tx + 16 * c) * TS + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][c] = fmaf(da[i], kc, dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[q_off + (int64_t)row * D + tx + 16 * c] = from_f32<T>(dqa[i][c] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int b, int hq, int hkv, int s, int causal, float scale,
           cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  const int nqt = (s + BQ - 1) / BQ, nkt = (s + BK - 1) / BK;
  cudaError_t e;

  auto stats = flash_bwd_stats_kernel<T, D>;
  if ((e = allow_smem(stats, stats_smem<T, D>())) != cudaSuccess) return (int)e;
  stats<<<dim3(nqt, b * hq), THREADS, stats_smem<T, D>(), st>>>(
      q_, k_, o_, do_, lse, delta, hq, hkv, s, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  if ((e = allow_smem(dkdv, dkdv_smem<T, D>())) != cudaSuccess) return (int)e;
  dkdv<<<dim3(nkt, b * hkv), THREADS, dkdv_smem<T, D>(), st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), hq,
      hkv, s, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_kernel<T, D>;
  if ((e = allow_smem(dqk, dq_smem<T, D>())) != cudaSuccess) return (int)e;
  dqk<<<dim3(nqt, b * hq), THREADS, dq_smem<T, D>(), st>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), hq, hkv, s, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* delta, int b, int hq, int hkv, int s, int d, int causal,
               float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, s, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse and delta: float32 scratch of
// B * Hq * S each.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq,
                                   void* dk, void* dv, float* lse, float* delta,
                                   int dtype, int b, int hq, int hkv, int s,
                                   int d, int causal, float scale, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                             hkv, s, d, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                     b, hq, hkv, s, d, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
