// FM second-order interaction (float32):
//   out[b] = 0.5 * sum_k ((sum_f e[b, f, k])^2 - sum_f e[b, f, k]^2)
//
// Replaces the TPU kernel `fm_interaction` in
// src/repro/kernels/fm_interaction/fm_interaction.py (body `_fm_kernel`).
//
// What bounds it on an H100: bytes.  Each example is F * K floats read once
// (1,560 bytes at F = 39, K = 10) for about 3 operations per float, so the
// kernel can only approach the time it takes to stream emb [B, F, K] once.
//
// Design: one warp per example.  The warp copies its example's F * K floats
// into shared memory with consecutive lanes on consecutive addresses (fully
// coalesced, ~13 loads of 128 bytes at F * K = 390), then lane k sums
// field by field the column e[:, k] and its squares in registers, and a
// warp shuffle adds the K terms.  No lane padding: the TPU kernel's pad of
// K to 128 lanes is a layout artefact of its vector unit.  Each example's
// sums run in a fixed order, so the result is the same bit for bit from
// launch to launch.
//
// The backward (fm_interaction_bwd_f32) has no TPU kernel behind it: the
// reference's Pallas kernel has no backward, and it trains through the
// plain jnp interaction.  It is here so that the FM trains on the card
// through kernels:  d emb[b, f, k] = g[b] * (sum_f' e[b, f', k] - e[b, f, k]).
// It is bound by bytes (emb read once, d emb written once), and keeps the
// forward's shape: one warp per example stages the row in shared memory,
// lane k sums column k into a shared [K] vector, then the warp writes the
// row's F * K gradients with consecutive lanes on consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr size_t SMEM_LIMIT = 48 * 1024;

__global__ void fm_interaction_kernel(const float* __restrict__ emb, int b,
                                      int f, int k, float* __restrict__ out) {
  extern __shared__ float rows[];  // [warps][f * k]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fk = f * k;
  const int64_t ex = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ex >= b) return;  // the whole warp leaves together
  float* row = rows + (size_t)warp * fk;
  const float* src = emb + ex * fk;
  for (int i = lane; i < fk; i += 32) row[i] = src[i];
  __syncwarp();
  float t = 0.f;
  for (int kk = lane; kk < k; kk += 32) {
    float s = 0.f, ss = 0.f;
    for (int ff = 0; ff < f; ++ff) {
      const float e = row[ff * k + kk];
      s += e;
      ss += e * e;
    }
    t += s * s - ss;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  if (lane == 0) out[ex] = 0.5f * t;
}

__global__ void fm_interaction_bwd_kernel(const float* __restrict__ emb,
                                          const float* __restrict__ g, int b,
                                          int f, int k, float* __restrict__ demb) {
  extern __shared__ float smem[];  // [warps][f * k + k]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fk = f * k;
  const int64_t ex = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ex >= b) return;
  float* row = smem + (size_t)warp * (fk + k);
  float* col = row + fk;
  const float* src = emb + ex * fk;
  for (int i = lane; i < fk; i += 32) row[i] = src[i];
  __syncwarp();
  for (int kk = lane; kk < k; kk += 32) {
    float s = 0.f;
    for (int ff = 0; ff < f; ++ff) s += row[ff * k + kk];
    col[kk] = s;
  }
  __syncwarp();
  const float gb = g[ex];
  float* dst = demb + ex * fk;
  for (int i = lane; i < fk; i += 32) dst[i] = gb * (col[i % k] - row[i]);
}

}  // namespace

// emb [b, f, k] float32 -> out [b] float32.  Returns a cudaError_t.
extern "C" int fm_interaction_f32(const float* emb, int b, int f, int k,
                                  float* out, void* stream) {
  if (b <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)f * k * sizeof(float);
  if (row_bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int warps = MAX_WARPS;
  while (warps > 1 && warps * row_bytes > SMEM_LIMIT) warps >>= 1;
  const int64_t blocks = ((int64_t)b + warps - 1) / warps;
  fm_interaction_kernel<<<(unsigned)blocks, warps * 32, warps * row_bytes,
                          static_cast<cudaStream_t>(stream)>>>(emb, b, f, k,
                                                               out);
  return (int)cudaGetLastError();
}

// emb [b, f, k] and g [b] float32 -> demb [b, f, k] float32, the gradient of
// sum_b g[b] * out[b].  Returns a cudaError_t.
extern "C" int fm_interaction_bwd_f32(const float* emb, const float* g, int b,
                                      int f, int k, float* demb, void* stream) {
  if (b <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = ((size_t)f * k + k) * sizeof(float);
  if (row_bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int warps = MAX_WARPS;
  while (warps > 1 && warps * row_bytes > SMEM_LIMIT) warps >>= 1;
  const int64_t blocks = ((int64_t)b + warps - 1) / warps;
  fm_interaction_bwd_kernel<<<(unsigned)blocks, warps * 32, warps * row_bytes,
                              static_cast<cudaStream_t>(stream)>>>(emb, g, b, f,
                                                                   k, demb);
  return (int)cudaGetLastError();
}
