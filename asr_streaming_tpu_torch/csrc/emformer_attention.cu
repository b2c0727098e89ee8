// Masked Emformer attention core in f32, hand-written for Hopper (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_attention.py::
// fused_emformer_attention (Pallas body _attention_kernel).  For each slot
// and head: logits = (q * 1/sqrt(Dh)) . k^T in f32, key validity from the
// fill counts (the first M - m_m memory columns and the first Lc - m_kv
// left-context columns are invalid) and the summary-row rule (with
// memory, the last query row never sees a memory column), an f32 softmax,
// and probs . v in f32.  Unlike the stack kernel's attention, nothing is
// rounded to a compute type: the Pallas kernel keeps f32 throughout and
// its caller casts the result.
//
// What bounds it on this card: at the Vietnamese serving shape (B=512,
// Q=21, K=56, D=512, H=8) one call reads q (22 MB) and k, v (59 MB each)
// and writes 22 MB: ~161 MB, 0.048 ms at 3.35 TB/s, against ~0.1 GFLOP of
// products, so it is bytes-bound.
//
// What the design does about it: one block per (slot, head) loads that
// head's q, k and v columns once into shared memory (rows padded to Dh+1
// floats so that a warp reading 32 key rows at one column hits 32 banks),
// and the logits, softmax and value product run from there; each input
// byte is read from device memory once and each output byte written once.
// Not yet done: vectorised 16-byte loads and register tiling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kErrShape = -2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q [B, Q, D], k/v [B, K, D] f32; m_m/m_kv [B]; out [B, Q, D] f32.
// Key columns are [memory (M), right context (R), left context (Lc),
// utterance]; grid (B, H).
__global__ void emformer_attention_kernel(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const int32_t* __restrict__ m_m,
                                          const int32_t* __restrict__ m_kv,
                                          float* __restrict__ out, int Q, int K,
                                          int D, int H, int M, int R, int Lc,
                                          int use_mem, float neg_inf) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int Dh = D / H, Dp = Dh + 1;
  float* qs = sm;                 // [Q, Dp]
  float* ks = qs + Q * Dp;        // [K, Dp]
  float* vs = ks + K * Dp;        // [K, Dh]
  float* ps = vs + K * Dh;        // [Q, K]
  const float scaling = (float)(1.0 / sqrt((double)Dh));

  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    int r = i / Dh, d = i % Dh;
    qs[r * Dp + d] = q[((size_t)b * Q + r) * D + h * Dh + d] * scaling;
  }
  for (int i = threadIdx.x; i < K * Dh; i += blockDim.x) {
    int c = i / Dh, d = i % Dh;
    size_t o = ((size_t)b * K + c) * D + h * Dh + d;
    ks[c * Dp + d] = k[o];
    vs[i] = v[o];
  }
  __syncthreads();

  const int mm = m_m[b], mkv = m_kv[b];
  for (int i = threadIdx.x; i < Q * K; i += blockDim.x) {
    int r = i / K, c = i % K;
    bool valid = !(c >= M + R && c < M + R + (Lc - mkv));
    if (use_mem && c < M) {
      if (c < M - mm) valid = false;
      if (r == Q - 1) valid = false;          // summary row is blind to memory
    }
    float acc = 0.f;
    for (int d = 0; d < Dh; ++d) acc = fmaf(qs[r * Dp + d], ks[c * Dp + d], acc);
    ps[i] = valid ? acc : neg_inf;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < Q; r += nw) {
    float mx = -3.402823466e38f;
    for (int c = lane; c < K; c += 32) mx = fmaxf(mx, ps[r * K + c]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int c = lane; c < K; c += 32) {
      float e = expf(ps[r * K + c] - mx);
      ps[r * K + c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < K; c += 32) ps[r * K + c] = ps[r * K + c] / s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    int r = i / Dh, d = i % Dh;
    float acc = 0.f;
    for (int c = 0; c < K; ++c) acc = fmaf(ps[r * K + c], vs[c * Dh + d], acc);
    out[((size_t)b * Q + r) * D + h * Dh + d] = acc;
  }
}

}  // namespace

extern "C" int asr_emformer_attention(const float* q, const float* k, const float* v,
                                      const int32_t* m_m, const int32_t* m_kv, float* out,
                                      int B, int Q, int K, int D, int H, int M, int R,
                                      int Lc, int use_mem, float neg_inf, void* stream) {
  if (B <= 0 || Q <= 0 || K <= 0 || H <= 0 || D % H != 0 || M + R + Lc > K)
    return kErrShape;
  const int Dh = D / H;
  const size_t smem =
      ((size_t)(Q + K) * (Dh + 1) + (size_t)K * Dh + (size_t)Q * K) * sizeof(float);
  if (smem > 48 * 1024) {
    int e = (int)cudaFuncSetAttribute(emformer_attention_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
    if (e != 0) return e;
  }
  emformer_attention_kernel<<<dim3(B, H), 128, smem, (cudaStream_t)stream>>>(
      q, k, v, m_m, m_kv, out, Q, K, D, H, M, R, Lc, use_mem, neg_inf);
  return (int)cudaGetLastError();
}
