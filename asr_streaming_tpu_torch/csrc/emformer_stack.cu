// Streaming Emformer step for all layers and all slots, hand-written for
// Hopper (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_emformer.py::fused_emformer_stack
// (Pallas body _stack_kernel, per-layer math _layer_math).  Computes what
// _layer_math computes, layer after layer: input LN + summary row, Q and
// KV projections, masked attention with an f32 softmax, out projection,
// memory tanh (or +-10 clip), residual, FFN LN, FFN, output LN, and the
// state roll committed where `advance` is set and zeroed where `reset` is
// set.  The bf16 rounding points are the Pallas kernel's: every projection
// is rounded to the compute type before its bias is added in that type,
// q*scaling is taken in the compute type, softmax probabilities and the
// attention output are rounded to it, LN and softmax run in f32.
//
// What bounds it on this card: at the Vietnamese serving shape (B=512,
// L=20, D=512, F=2048, U=16, R=4, Lc=32, M=4) one step is ~1.37 TFLOP of
// matrix products (~68 GFLOP per layer, 43 of them in the FFN) against
// ~1.6 GB of traffic (126 MB of bf16 weights, ~0.71 GB of carried state
// read and the same written), so it is compute-bound: >= 1.4 ms at the
// 989 TFLOP/s bf16 tensor-core peak.
//
// What the design does about it: every product runs on the tensor cores
// (WMMA bf16 16x16x16 with f32 accumulation, shared-memory tiles, the
// bias / activation epilogue fused into the GEMM so projections never
// make a second pass).  The Pallas kernel's VMEM-resident megakernel does
// not translate (a block has 227 KB of shared memory, the TPU tile had
// ~100 MB of VMEM), so the step is a short chain of simple kernels per
// layer: ln_in -> gemm(q) -> gemm(kv) -> state_roll -> attention ->
// gemm(out) -> residual_ffn_ln -> gemm(ffn1+act) -> gemm(ffn2) -> out_ln,
// all launched from one host call.  Inter-layer activations stay in f32
// device scratch.  The state roll writes new buffers (no in-place shift
// across threads).  The Mosaic tiling knobs (tile, layers_per_step,
// ffn_slices) carry no semantics and are not reproduced.  Not yet done:
// wgmma/TMA pipelining, one persistent launch for all layers, and the
// W8A8 (int8) mode of the Pallas kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

// ---------------------------------------------------------------- helpers

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to the compute type and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

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

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  if (act == ACT_GELU) {
    // tanh approximation (jax.nn.gelu default; torch approximate="tanh")
    const float k_beta = 0.7978845608028654f;   // sqrt(2/pi)
    const float k_kappa = 0.044715f;
    float inner = k_beta * (x + k_kappa * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  if (act == ACT_SILU) return x / (1.f + expf(-x));
  return x;
}

// projection epilogue: round(acc) + bias in the compute type, then the
// activation on that rounded value, rounded again
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int n, int act) {
  float v = rnd<T>(rnd<T>(acc) + to_f<T>(bias[n]));
  if (act != ACT_NONE) v = rnd<T>(activate(v, act));
  return from_f<T>(v);
}

// LayerNorm of one row held by a warp: lane owns elements lane + 32*i.
// D <= 32 * kMaxPerLane.
constexpr int kMaxPerLane = 32;

__device__ __forceinline__ void warp_layer_norm(float (&v)[kMaxPerLane], int D,
                                                const float* scale,
                                                const float* bias) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    if (d < D) s += v[i];
  }
  const float mean = warp_sum(s) / (float)D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    if (d < D) {
      float c = v[i] - mean;
      s2 += c * c;
    }
  }
  const float var = warp_sum(s2) / (float)D;
  const float inv = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    if (d < D) v[i] = (v[i] - mean) * inv * scale[d] + bias[d];
  }
}

// ------------------------------------------------------------------ GEMMs
// C[M,N] = epilogue(A[M,K] @ W[K,N]); all row-major, W is a [in, out]
// weight.  Ragged M, N and K are masked (zero-filled tiles).

// bf16: 128x128 block tile, 8 warps of 64x32 (WMMA 16x16x16, f32
// accumulators), two shared-memory stages filled by cp.async (16-byte
// copies; rows past M and columns past N or K zero-filled), so the next K
// slice loads while the tensor cores work on this one.  Needs K % 8 == 0
// and N % 8 == 0 (whole 16-byte vectors; the wrapper checks D and F).
constexpr int kPM = 128, kPN = 128, kPK = 32;
constexpr int kPAPitch = kPK + 8, kPBPitch = kPN + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;       // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(bytes));
}

__global__ void __launch_bounds__(256)
gemm_bf16_pipelined_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, bf16* __restrict__ C,
                           int M, int N, int K, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][kPM][kPAPitch];
  __shared__ __align__(128) bf16 Bs[2][kPK][kPBPitch];
  __shared__ __align__(128) float Cw[8][16][16];   // per-warp epilogue tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;        // 2 x 4 warps, 64x32 each
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {             // A: 128 x 32 = 512 vectors
      int i = tid + it * 256;
      int r = i >> 2, c = (i & 3) * 8;
      bool ok = (m0 + r) < M && (k0 + c) < K;
      cp_async16(&As[stage][r][c], ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {             // B: 32 x 128 = 512 vectors
      int i = tid + it * 256;
      int r = i >> 4, c = (i & 15) * 8;
      bool ok = (k0 + r) < K && (n0 + c) < N;
      cp_async16(&Bs[stage][r][c], ok ? W + (size_t)(k0 + r) * N + n0 + c : W, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + kPK - 1) / kPK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_stage(st ^ 1, (kt + 1) * kPK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[st][wm * 64 + i * 16][kk], kPAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk][wn * 32 + j * 16], kPBPitch);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();     // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cw[warp][0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int idx = lane + 32 * e, r = idx >> 4, c = idx & 15;
        int m = m0 + wm * 64 + i * 16 + r, n = n0 + wn * 32 + j * 16 + c;
        if (m < M && n < N) C[(size_t)m * N + n] = epilogue<bf16>(Cw[warp][r][c], bias, n, act);
      }
      __syncwarp();
    }
}

// f32 compute type: plain SIMT FMA GEMM (no tensor-core path keeps full
// f32; used by the float32 configurations, not by the bf16 serving path)
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ C,
                int M, int N, int K, int act) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += 256) {
      int r = i / BK, c = i % BK;
      int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? A[(size_t)m * K + k] : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += 256) {
      int r = i / BN, c = i % BN;
      int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? W[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) C[(size_t)m * N + n] = epilogue<float>(acc[i][j], bias, n, act);
    }
}

// ------------------------------------------------- per-layer row kernels

// Input LN of [rc; utt] (rows in that order), the summary row (mean of
// the LN'd utterance) and, at layer 0, the memory row (mean of the RAW
// utterance) plus the reordered f32 copy of the chunk.  Writes
// q_in [B,Q,D] = [ln_rc, ln_utt, summary] and
// kv_in [B,M+T,D] = [mem (zero where reset), ln_rc, ln_utt].
// One block per slot; one warp per row; LN'd rows kept in shared memory.
template <typename T>
__global__ void ln_in_kernel(const float* __restrict__ src, int first,
                             float* __restrict__ hin, float* __restrict__ memrow,
                             const T* __restrict__ mem_in,
                             const uint8_t* __restrict__ reset,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ q_in, T* __restrict__ kv_in,
                             int D, int U, int R, int M, int use_mem) {
  extern __shared__ float ln_rows[];          // [T, D]
  const int b = blockIdx.x;
  const int Tr = R + U, Q = Tr + use_mem, NKV = M + Tr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int t = warp; t < Tr; t += nw) {
    // layer 0 reads the chunk in its [utt; rc] order
    const int srow = first ? (t < R ? U + t : t - R) : t;
    const float* xr = src + ((size_t)b * Tr + srow) * D;
    float v[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      int d = lane + 32 * i;
      v[i] = d < D ? xr[d] : 0.f;
      if (first && d < D) hin[((size_t)b * Tr + t) * D + d] = v[i];
    }
    warp_layer_norm(v, D, scale, bias);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      int d = lane + 32 * i;
      if (d < D) {
        ln_rows[t * D + d] = v[i];
        const T y = from_f<T>(v[i]);
        q_in[((size_t)b * Q + t) * D + d] = y;
        kv_in[((size_t)b * NKV + M + t) * D + d] = y;
      }
    }
  }
  const bool rs = reset[b] != 0;
  for (int i = threadIdx.x; i < M * D; i += blockDim.x)
    kv_in[(size_t)b * NKV * D + i] = rs ? from_f<T>(0.f) : mem_in[(size_t)b * M * D + i];
  __syncthreads();
  if (use_mem) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float s = 0.f;
      for (int u = 0; u < U; ++u) s += ln_rows[(R + u) * D + d];
      q_in[((size_t)b * Q + Tr) * D + d] = from_f<T>(s / (float)U);
      if (first) {
        float r = 0.f;
        for (int u = 0; u < U; ++u) r += src[((size_t)b * Tr + u) * D + d];
        memrow[(size_t)b * D + d] = r / (float)U;
      }
    }
  }
}

// Masked attention core, one block per (slot, head).  Keys/values are
// [mem, rc, left context, new utterance] with `reset` zeroing the carried
// left context; validity from the reset-effective length:
// m_m = min(M, len // U) memory rows, m_kv = min(Lc, len) left-context
// rows (filled from the end); the summary query row never sees memory.
template <typename T>
__global__ void attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                 const T* __restrict__ lc_k, const T* __restrict__ lc_v,
                                 const int32_t* __restrict__ length,
                                 const uint8_t* __restrict__ reset,
                                 T* __restrict__ out, int D, int H, int U, int R,
                                 int M, int Lc, int use_mem, float neg_inf) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int Dh = D / H;
  const int Q = R + U + use_mem, K = M + R + Lc + U, NKV = M + R + U;
  // q and k rows padded to Dh + 1 floats: the logits loop has a warp read
  // 32 different key rows at the same d, which would otherwise all fall
  // in one shared-memory bank
  const int Dp = Dh + 1;
  float* qs = sm;                 // [Q, Dp]
  float* ks = qs + Q * Dp;        // [K, Dp]
  float* vs = ks + K * Dp;        // [K, Dh]
  float* ps = vs + K * Dh;        // [Q, K]
  const bool rs = reset[b] != 0;
  // q * (1/sqrt(Dh)) is taken in the compute type, as in the Pallas kernel
  const float scaling = rnd<T>((float)(1.0 / sqrt((double)Dh)));

  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    int r = i / Dh, d = i % Dh;
    qs[r * Dp + d] = rnd<T>(to_f<T>(q[((size_t)b * Q + r) * D + h * Dh + d]) * scaling);
  }
  for (int i = threadIdx.x; i < K * Dh; i += blockDim.x) {
    int c = i / Dh, d = i % Dh;
    float kval, vval;
    if (c < M + R) {
      const T* row = kv + ((size_t)b * NKV + c) * 2 * D + h * Dh + d;
      kval = to_f<T>(row[0]);
      vval = to_f<T>(row[D]);
    } else if (c < M + R + Lc) {
      size_t o = ((size_t)b * Lc + (c - M - R)) * D + h * Dh + d;
      kval = rs ? 0.f : to_f<T>(lc_k[o]);
      vval = rs ? 0.f : to_f<T>(lc_v[o]);
    } else {
      const T* row = kv + ((size_t)b * NKV + M + R + (c - M - R - Lc)) * 2 * D + h * Dh + d;
      kval = to_f<T>(row[0]);
      vval = to_f<T>(row[D]);
    }
    ks[c * Dp + d] = kval;
    vs[i] = vval;
  }
  __syncthreads();

  const int len = length[b];
  const int m_kv = min(Lc, len);
  const int m_m = min(M, len / max(U, 1));
  for (int i = threadIdx.x; i < Q * K; i += blockDim.x) {
    int r = i / K, c = i % K;
    bool valid = true;
    if (c >= M + R && c < M + R + Lc && (c - M - R) < Lc - m_kv) valid = false;
    if (use_mem && c < M) {
      if (c < M - m_m) valid = false;
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
    for (int c = lane; c < K; c += 32) ps[r * K + c] = rnd<T>(ps[r * K + c] / s);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Q * Dh; i += blockDim.x) {
    int r = i / Dh, d = i % Dh;
    float acc = 0.f;
    for (int c = 0; c < K; ++c) acc = fmaf(ps[r * K + c], vs[c * Dh + d], acc);
    out[((size_t)b * Q + r) * D + h * Dh + d] = from_f<T>(acc);
  }
}

// State roll into NEW buffers: memory shifts in this layer's input
// memory row; left-context K/V keep the newest Lc rows of
// [lc; new utterance K/V].  Committed where advance, else the
// (post-reset) previous state.  One block per (slot, output row).
template <typename T>
__global__ void state_roll_kernel(const T* __restrict__ mem_in,
                                  const T* __restrict__ lck_in,
                                  const T* __restrict__ lcv_in,
                                  const T* __restrict__ kv,
                                  const float* __restrict__ memrow,
                                  const uint8_t* __restrict__ reset,
                                  const uint8_t* __restrict__ advance,
                                  T* __restrict__ mem_out, T* __restrict__ lck_out,
                                  T* __restrict__ lcv_out, int D, int U, int R,
                                  int M, int Lc) {
  const int b = blockIdx.x, row = blockIdx.y;
  const bool rs = reset[b] != 0, adv = advance[b] != 0;
  const int NKV = M + R + U;
  const T zero = from_f<T>(0.f);
  if (row < M) {
    T* dst = mem_out + ((size_t)b * M + row) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      T val;
      if (adv && row == M - 1) val = from_f<T>(memrow[(size_t)b * D + d]);
      else {
        int srow = adv ? row + 1 : row;
        val = rs ? zero : mem_in[((size_t)b * M + srow) * D + d];
      }
      dst[d] = val;
    }
    return;
  }
  int j = row - M;
  const bool is_v = j >= Lc;
  if (is_v) j -= Lc;
  const T* lc_in = is_v ? lcv_in : lck_in;
  T* dst = (is_v ? lcv_out : lck_out) + ((size_t)b * Lc + j) * D;
  const int keep = max(0, Lc - U);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    T val;
    if (adv && j >= keep) {
      int u = U - (Lc - keep) + (j - keep);
      val = kv[((size_t)b * NKV + M + R + u) * 2 * D + (is_v ? D : 0) + d];
    } else {
      int srow = adv ? Lc - keep + j : j;
      val = rs ? zero : lc_in[((size_t)b * Lc + srow) * D + d];
    }
    dst[d] = val;
  }
}

// After the out projection: rows t < T give residual = out + input and
// the FFN LN (written in the compute type for the FFN product); row T
// (with memory) gives the next layer's memory row, tanh or +-10 clip.
// One warp per row.
template <typename T>
__global__ void residual_ffn_ln_kernel(const T* __restrict__ out,
                                       const float* __restrict__ hin,
                                       float* __restrict__ hres,
                                       float* __restrict__ memrow,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       T* __restrict__ ff_in, int B, int D, int Tr,
                                       int use_mem, int tanh_on_mem) {
  const int lane = threadIdx.x & 31;
  const int Q = Tr + use_mem;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B * Q) return;
  const int b = row / Q, t = row % Q;
  const T* o = out + ((size_t)b * Q + t) * D;
  if (t == Tr) {
    for (int d = lane; d < D; d += 32) {
      float x = to_f<T>(o[d]);
      memrow[(size_t)b * D + d] = tanh_on_mem ? tanhf(x) : fminf(fmaxf(x, -10.f), 10.f);
    }
    return;
  }
  const size_t base = ((size_t)b * Tr + t) * D;
  float v[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    v[i] = 0.f;
    if (d < D) {
      v[i] = to_f<T>(o[d]) + hin[base + d];
      hres[base + d] = v[i];
    }
  }
  warp_layer_norm(v, D, scale, bias);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    if (d < D) ff_in[base + d] = from_f<T>(v[i]);
  }
}

// Output LN of residual + FFN; the result is the next layer's input
// (rows [rc; utt]); at the last layer the utterance rows also go to y.
template <typename T>
__global__ void out_ln_kernel(const float* __restrict__ hres, const T* __restrict__ h2,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ hout, float* __restrict__ y,
                              int B, int D, int Tr, int R) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B * Tr) return;
  const int b = row / Tr, t = row % Tr, U = Tr - R;
  const size_t base = (size_t)row * D;
  float v[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    v[i] = d < D ? hres[base + d] + to_f<T>(h2[base + d]) : 0.f;
  }
  warp_layer_norm(v, D, scale, bias);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    int d = lane + 32 * i;
    if (d < D) {
      hout[base + d] = v[i];
      if (y != nullptr && t >= R) y[((size_t)b * U + (t - R)) * D + d] = v[i];
    }
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

// Field order and types mirror ops/emformer_stack.py::_Args (ctypes).
struct EmformerStackArgs {
  int64_t struct_size;
  int32_t dtype;          // 0 = float32, 1 = bfloat16 (compute/state type)
  int32_t B, L, D, H, F, U, R, M, Lc;
  int32_t use_mem, tanh_on_mem, activation;
  float neg_inf;
  // inputs
  const float* x;         // [B, U+R, D]
  const int32_t* length;  // [B] reset-effective
  const uint8_t* reset;   // [B]
  const uint8_t* advance; // [B]
  const void* mem_in;     // [L, B, M, D]
  const void* lck_in;     // [L, B, Lc, D]
  const void* lcv_in;
  // stacked weights: [L, in, out] / [L, out] in the compute type, LN f32
  const void* wq; const void* bq; const void* wkv; const void* bkv;
  const void* wout; const void* bout;
  const float* lnin_s; const float* lnin_b;
  const float* ffln_s; const float* ffln_b;
  const void* w1; const void* b1; const void* w2; const void* b2;
  const float* lnout_s; const float* lnout_b;
  // outputs
  float* y;               // [B, U, D]
  void* mem_out; void* lck_out; void* lcv_out;
  // scratch (compute type unless noted)
  void* q_in;   // [B, Q, D]
  void* kv_in;  // [B, M+T, D]
  void* q;      // [B, Q, D]
  void* kv;     // [B, M+T, 2D]
  void* attn;   // [B, Q, D]
  void* out;    // [B, Q, D]
  void* ff_in;  // [B, T, D]
  void* h1;     // [B, T, F]
  void* h2;     // [B, T, D]
  float* hin;   // [B, T, D] f32
  float* hres;  // [B, T, D] f32
  float* memrow;// [B, D] f32
  void* stream;
};

namespace {

constexpr int kErrStructSize = -1;
constexpr int kErrShape = -2;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
int gemm(const T* A, const T* W, const T* bias, T* C, int M, int N, int K,
         int act, cudaStream_t st);

template <>
int gemm<bf16>(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M,
               int N, int K, int act, cudaStream_t st) {
  if (K % 8 != 0 || N % 8 != 0) return kErrShape;
  dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
  gemm_bf16_pipelined_kernel<<<grid, 256, 0, st>>>(A, W, bias, C, M, N, K, act);
  return (int)cudaGetLastError();
}

template <>
int gemm<float>(const float* A, const float* W, const float* bias, float* C,
                int M, int N, int K, int act, cudaStream_t st) {
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_f32_kernel<<<grid, 256, 0, st>>>(A, W, bias, C, M, N, K, act);
  return (int)cudaGetLastError();
}

#define CHECK_LAUNCH()                          \
  do {                                          \
    int e_ = (int)cudaGetLastError();           \
    if (e_ != 0) return e_;                     \
  } while (0)

#define CHECK_RC(expr)                          \
  do {                                          \
    int e_ = (expr);                            \
    if (e_ != 0) return e_;                     \
  } while (0)

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int run_stack(const EmformerStackArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = a.B, D = a.D, F = a.F, U = a.U, R = a.R, M = a.M, Lc = a.Lc, H = a.H;
  const int Tr = R + U, Q = Tr + a.use_mem, NKV = M + Tr;
  const T* wq = (const T*)a.wq; const T* bq = (const T*)a.bq;
  const T* wkv = (const T*)a.wkv; const T* bkv = (const T*)a.bkv;
  const T* wout = (const T*)a.wout; const T* bout = (const T*)a.bout;
  const T* w1 = (const T*)a.w1; const T* b1 = (const T*)a.b1;
  const T* w2 = (const T*)a.w2; const T* b2 = (const T*)a.b2;
  T* q_in = (T*)a.q_in; T* kv_in = (T*)a.kv_in; T* q = (T*)a.q; T* kv = (T*)a.kv;
  T* attn = (T*)a.attn; T* out = (T*)a.out; T* ff_in = (T*)a.ff_in;
  T* h1 = (T*)a.h1; T* h2 = (T*)a.h2;

  const size_t ln_smem = (size_t)Tr * D * sizeof(float);
  const int Dh = D / H;
  const int Kk = M + R + Lc + U;
  const size_t attn_smem =
      ((size_t)(Q + Kk) * (Dh + 1) + (size_t)Kk * Dh + (size_t)Q * Kk) * sizeof(float);
  CHECK_RC(allow_smem(ln_in_kernel<T>, ln_smem));
  CHECK_RC(allow_smem(attention_kernel<T>, attn_smem));

  const int rows_per_block = 4;          // warps per block in row kernels
  for (int l = 0; l < a.L; ++l) {
    const size_t sMem = (size_t)l * B * M * D, sLc = (size_t)l * B * Lc * D;
    const T* mem_in = (const T*)a.mem_in + sMem;
    const T* lck_in = (const T*)a.lck_in + sLc;
    const T* lcv_in = (const T*)a.lcv_in + sLc;

    ln_in_kernel<T><<<B, 256, ln_smem, st>>>(
        l == 0 ? a.x : a.hin, l == 0, a.hin, a.memrow, mem_in, a.reset,
        a.lnin_s + (size_t)l * D, a.lnin_b + (size_t)l * D, q_in, kv_in, D, U, R,
        M, a.use_mem);
    CHECK_LAUNCH();
    CHECK_RC(gemm<T>(q_in, wq + (size_t)l * D * D, bq + (size_t)l * D, q, B * Q, D, D,
                     ACT_NONE, st));
    CHECK_RC(gemm<T>(kv_in, wkv + (size_t)l * D * 2 * D, bkv + (size_t)l * 2 * D, kv,
                     B * NKV, 2 * D, D, ACT_NONE, st));
    // the roll reads this layer's input memory row before residual_ffn_ln
    // overwrites it with the next layer's
    state_roll_kernel<T><<<dim3(B, M + 2 * Lc), 128, 0, st>>>(
        mem_in, lck_in, lcv_in, kv, a.memrow, a.reset, a.advance,
        (T*)a.mem_out + sMem, (T*)a.lck_out + sLc, (T*)a.lcv_out + sLc, D, U, R, M, Lc);
    CHECK_LAUNCH();
    attention_kernel<T><<<dim3(B, H), 128, attn_smem, st>>>(
        q, kv, lck_in, lcv_in, a.length, a.reset, attn, D, H, U, R, M, Lc, a.use_mem,
        a.neg_inf);
    CHECK_LAUNCH();
    CHECK_RC(gemm<T>(attn, wout + (size_t)l * D * D, bout + (size_t)l * D, out, B * Q, D,
                     D, ACT_NONE, st));
    residual_ffn_ln_kernel<T><<<(B * Q + rows_per_block - 1) / rows_per_block,
                                32 * rows_per_block, 0, st>>>(
        out, a.hin, a.hres, a.memrow, a.ffln_s + (size_t)l * D, a.ffln_b + (size_t)l * D,
        ff_in, B, D, Tr, a.use_mem, a.tanh_on_mem);
    CHECK_LAUNCH();
    CHECK_RC(gemm<T>(ff_in, w1 + (size_t)l * D * F, b1 + (size_t)l * F, h1, B * Tr, F, D,
                     a.activation, st));
    CHECK_RC(gemm<T>(h1, w2 + (size_t)l * F * D, b2 + (size_t)l * D, h2, B * Tr, D, F,
                     ACT_NONE, st));
    out_ln_kernel<T><<<(B * Tr + rows_per_block - 1) / rows_per_block,
                       32 * rows_per_block, 0, st>>>(
        a.hres, h2, a.lnout_s + (size_t)l * D, a.lnout_b + (size_t)l * D, a.hin,
        l == a.L - 1 ? a.y : nullptr, B, D, Tr, R);
    CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

extern "C" int asr_emformer_stack(const EmformerStackArgs* a) {
  if (a == nullptr || a->struct_size != (int64_t)sizeof(EmformerStackArgs))
    return kErrStructSize;
  if (a->D > 32 * kMaxPerLane || a->H <= 0 || a->D % a->H != 0 || a->B <= 0 ||
      a->L <= 0 || a->U <= 0 || (a->use_mem && a->M <= 0))
    return kErrShape;
  if (a->dtype == 1) return run_stack<bf16>(*a);
  if (a->dtype == 0) return run_stack<float>(*a);
  return kErrShape;
}

extern "C" const char* asr_cuda_error_string(int code) {
  if (code == kErrStructSize) return "argument struct size mismatch";
  if (code == kErrShape) return "unsupported shape or dtype";
  return cudaGetErrorString((cudaError_t)code);
}
