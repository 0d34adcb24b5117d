// Causal GQA flash attention, forward (bf16 or float32 in, float32 sums), on
// the CUDA cores.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_flash_kernel`)
// for the calls the tensor-core kernel (flash_attention_sm90.cu) does not
// take: float32 with any D (a float32 product on the tensor cores would be
// TF32) and bf16 with D in {16, 32}.  bf16 with D in {64, 128}, the LM
// prefill's route, goes to flash_attention_sm90.cu; the wrapper
// (kernels/flash_attention/flash_attention.py) holds the table.
//
// q [B, Hq, S, D], k and v [B, Hkv, S, D] -> o [B, Hq, S, D] in q's type;
// query head h reads kv head h / (Hq / Hkv).  As in the TPU kernel, scores
// and the softmax run in float32, p is rounded to v's type before the PV
// product (so a bf16 call rounds p to bf16), and the output is
// acc / max(l, 1e-30) rounded to q's type.  Masked scores take the finite
// NEG_INF = -1e30, never -inf, so exp(m_prev - m_new) never makes a NaN.
//
// What bounds it on an H100: operations.  2 * B * Hq * D * S * (S + 1)
// multiply-adds against S * D * (2 * Hq + 2 * Hkv) elements of traffic; at
// S = 2048 the work is ~1000 operations per byte, far past the card's ridge.
// This design runs them on the CUDA cores in float32 (no wgmma, no TMA),
// so it is well below the bf16 tensor-core bound, and within the float32
// peak of the CUDA cores for float32 calls; it is written to be right and
// simple:
//
//   * one 256-thread block per (batch x query head, 64-row query tile); the
//     grid walks the query tiles from the last (longest) row down, so the
//     blocks with the most key tiles start first;
//   * the block stages its Q tile once and each 64-key K and V tile in
//     shared memory as float32 (Q and K transposed, so a thread reads its
//     4 query rows and 4 keys at one depth as two float4 loads);
//   * a 16 x 16 thread grid: thread (ty, tx) owns query rows 4ty..4ty+3,
//     keys 4tx..4tx+3 of the score tile and output columns
//     [tx * D/16, (tx + 1) * D/16); a row's max and sum are reduced over the
//     16 threads of its half-warp with shuffles, and the online softmax
//     state (m, l) and the accumulator stay in registers;
//   * key tiles wholly above the diagonal are never loaded; the ragged tail
//     (S not a multiple of 64) is masked: query rows past S are computed on
//     zeros and not written, keys past S get p = 0 and v = 0.
//
// Deterministic: every sum runs in a fixed order, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile (== BQ: tile kt > qt is masked)
constexpr int TS = BQ + 4;   // row stride of the transposed Q / K / P tiles
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

template <int D>
constexpr size_t smem_floats() {
  // Qt [D][TS], Kt [D][TS], V [BK][D], Pt [BK][TS]
  return (size_t)2 * D * TS + (size_t)BK * D + (size_t)BK * TS;
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      out[c] = x.x; out[c + 1] = x.y; out[c + 2] = x.z; out[c + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = p[c];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int s, int causal, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;                 // [D][TS]  Q transposed
  float* kt_s = qt_s + D * TS;        // [D][TS]  K transposed
  float* v_s = kt_s + D * TS;         // [BK][D]
  float* pt_s = v_s + BK * D;         // [BK][TS] P transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nqt = (s + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y;  // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const T* qp = q + (int64_t)bh * s * D;
  const T* kp = k + ((int64_t)b * hkv + kvh) * s * D;
  const T* vp = v + ((int64_t)b * hkv + kvh) * s * D;
  const int q0 = qt * BQ;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    qt_s[d * TS + r] = (q0 + r < s) ? to_f32(qp[(int64_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nkt_all = (s + BK - 1) / BK;
  const int nkt = causal ? min(qt + 1, nkt_all) : nkt_all;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done; Q is stored
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      const bool ok = k0 + r < s;
      const int64_t g = (int64_t)(k0 + r) * D + d;
      kt_s[d * TS + r] = ok ? to_f32(kp[g]) : 0.f;
      v_s[r * D + d] = ok ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    // scores: rows 4ty+i, keys 4tx+j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt_s + d * TS + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt_s + d * TS + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

    // online softmax over this tile, one row at a time
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
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        sc[i][j] = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt_s + (tx * 4 + j) * TS + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // acc[rows, cols] += P[rows, keys] @ V[keys, cols]
    const int kend = min(BK, s - k0);
    for (int c = 0; c < kend; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt_s + c * TS + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float vv[DC];
      load_row<DC>(v_s + c * D + tx * DC, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pa[i], vv[cc], acc[i][cc]);
    }
  }

  T* op = o + (int64_t)bh * s * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      op[(int64_t)row * D + tx * DC + cc] = from_f32<T>(acc[i][cc] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((s + BQ - 1) / BQ, b * hq);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int s, int d, int causal, float scale,
               cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int b, int hq, int hkv,
                                   int s, int d, int causal, float scale,
                                   void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, hq, hkv, s, d, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, causal,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}
