// Streaming Emformer step for all layers and all slots, hand-written for
// Hopper (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_emformer.py::fused_emformer_stack
// (Pallas body _stack_kernel, per-layer math _layer_math) and
// ::fused_emformer_layer (body _layer_kernel), with their W8A8 mode
// (_quantize_weight, _qdot, _kernel_quant_names).  Computes what
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
// 989 TFLOP/s bf16 tensor-core peak (W8A8: the five products at the
// 1,979 TOP/s int8 peak, the attention products still bf16).
//
// What the design does about it: every product runs on the tensor cores
// (WMMA bf16 16x16x16 with f32 accumulation, or WMMA s8 16x16x16 with s32
// accumulation in W8A8 mode, shared-memory tiles, the dequant / bias /
// activation epilogue fused into the GEMM so projections never make a
// second pass).  The Pallas kernel's VMEM-resident megakernel does not
// translate (a block has 227 KB of shared memory, the TPU tile had ~100 MB
// of VMEM), so one layer is a short chain of simple kernels: ln_in ->
// gemm(q) -> gemm(kv) -> state_roll -> attention -> gemm(out) ->
// residual_ffn_ln -> gemm(ffn1+act) -> gemm(ffn2) -> out_ln.  That chain
// is run_layer(); the C entry asr_emformer_layer runs it once (kernel C,
// one launch per layer from the host) and asr_emformer_stack loops it over
// the layers in one host call (kernel A), so the two cannot drift apart.
// Inter-layer activations stay in f32 device scratch.  The state roll
// writes new buffers (no in-place shift across threads).  In W8A8 mode a
// quantised product is a row-quantiser kernel followed by the int8 GEMM;
// the quantiser reads the f32 LN outputs for wq and ffw1 (ln_in and
// residual_ffn_ln then also write f32 copies) and the compute-type values
// for wkv, wout and ffw2, as _qdot(x.astype(f32)) does.  The Mosaic tiling
// knobs (tile, layers_per_step, ffn_slices) carry no semantics and are not
// reproduced.  Not yet done: wgmma/TMA pipelining, one persistent launch
// for all layers.

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

// ------------------------------------------------------------------ W8A8
// _qdot (pallas_emformer.py:54-62): per-row dynamic activation quant, an
// int8 x int8 -> int32 product (exact), f32 dequant.  The weights are
// quantised once per params object by the wrapper
// (ops/emformer_stack.py::_quantize_weight, a true division by the scale
// as in the Pallas code) and stored transposed, Wt [N, K], so both
// operand tiles are rows of K bytes.

// One block per row of x [rows, K]: amax, then s = max(amax, 1e-8) *
// (1/127) and xq = rint(x * (1/s)): the reciprocal is taken and then
// multiplied, as _qdot does (a division would flip some values), and
// rint rounds half to even like jnp.round.  The constants are the f32
// roundings of the doubles that JAX's weak types round.
template <typename Tin>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const Tin* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  __shared__ float red[8];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tin* xr = x + (size_t)row * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(to_f<Tin>(xr[k])));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float s = __fmul_rn(fmaxf(red[0], (float)1e-8), (float)(1.0 / 127.0));
  const float r = __frcp_rn(s);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* qr = xq + (size_t)row * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    qr[k] = (int8_t)__float2int_rn(__fmul_rn(to_f<Tin>(xr[k]), r));
}

// C[M,N] = epilogue((Aq[M,K] . Wt[N,K]^T) * as[m] * ws[n]): 128x128
// block tile, 8 warps of 64x32 (WMMA s8 16x16x16, s32 accumulators), two
// cp.async stages of 32 bytes of K.  Each stage keeps its two 16-byte K
// halves in separate arrays, so every WMMA fragment starts on a 256-byte
// boundary.  Needs K % 16 == 0 (whole 16-byte vectors; rows past M or N
// and K halves past K are zero-filled).  Dequant (acc * s) * ws in f32
// with no contraction, rounded to the compute type, then the bias in that
// type (_qdot(...).astype(cdt) + b.astype(cdt)).
constexpr int kQM = 128, kQN = 128, kQK = 32;

template <typename T>
__global__ void __launch_bounds__(256)
gemm_int8_kernel(const int8_t* __restrict__ Aq, const float* __restrict__ As,
                 const int8_t* __restrict__ Wt, const float* __restrict__ Ws,
                 const T* __restrict__ bias, T* __restrict__ C, int M, int N,
                 int K, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) int8_t Aqs[2][2][kQM][16];   // [stage][k half][row][k]
  __shared__ __align__(128) int8_t Bqs[2][2][kQN][16];   // [stage][k half][n][k]
  __shared__ __align__(128) int Cw[8][16][16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kQM, n0 = blockIdx.x * kQN;

  auto load_stage = [&](int stage, int k0) {
    const int r = tid >> 1, h = tid & 1, k = k0 + 16 * h;
    const bool oka = (m0 + r) < M && k < K;
    cp_async16(&Aqs[stage][h][r][0], oka ? Aq + (size_t)(m0 + r) * K + k : Aq, oka);
    const bool okb = (n0 + r) < N && k < K;
    cp_async16(&Bqs[stage][h][r][0], okb ? Wt + (size_t)(n0 + r) * K + k : Wt, okb);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (K + kQK - 1) / kQK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_stage(st ^ 1, (kt + 1) * kQK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &Aqs[st][h][wm * 64 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bqs[st][h][wn * 32 + j * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
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
        if (m < M && n < N) {
          const float v = __fmul_rn(__fmul_rn((float)Cw[warp][r][c], As[m]), Ws[n]);
          C[(size_t)m * N + n] = epilogue<T>(v, bias, n, act);
        }
      }
      __syncwarp();
    }
}

// ------------------------------------------------- per-layer row kernels

// Input LN of [rc; utt] (rows in that order), the summary row (mean of
// the LN'd utterance), with `reorder` the f32 copy of a chunk given in
// its [utt; rc] order into hin, and with `init_memrow` the memory row
// (mean of the RAW utterance, the first layer's).  Writes
// q_in [B,Q,D] = [ln_rc, ln_utt, summary] (and its f32 copy q_in32 when
// that is given: the W8A8 wq product quantises the f32 values) and
// kv_in [B,M+T,D] = [mem (zero where reset), ln_rc, ln_utt].
// One block per slot; one warp per row; LN'd rows kept in shared memory.
template <typename T>
__global__ void ln_in_kernel(const float* __restrict__ src, int reorder,
                             int init_memrow,
                             float* __restrict__ hin, float* __restrict__ memrow,
                             const T* __restrict__ mem_in,
                             const uint8_t* __restrict__ reset,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ q_in, T* __restrict__ kv_in,
                             float* __restrict__ q_in32,
                             int D, int U, int R, int M, int use_mem) {
  extern __shared__ float ln_rows[];          // [T, D]
  const int b = blockIdx.x;
  const int Tr = R + U, Q = Tr + use_mem, NKV = M + Tr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int t = warp; t < Tr; t += nw) {
    // a chunk (the first layer's input) comes in its [utt; rc] order
    const int srow = reorder ? (t < R ? U + t : t - R) : t;
    const float* xr = src + ((size_t)b * Tr + srow) * D;
    float v[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      int d = lane + 32 * i;
      v[i] = d < D ? xr[d] : 0.f;
      if (reorder && d < D) hin[((size_t)b * Tr + t) * D + d] = v[i];
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
        if (q_in32 != nullptr) q_in32[((size_t)b * Q + t) * D + d] = v[i];
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
      if (q_in32 != nullptr) q_in32[((size_t)b * Q + Tr) * D + d] = s / (float)U;
      if (init_memrow) {
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
// the FFN LN (written in the compute type for the FFN product, and in f32
// to ff_in32 when that is given, for the W8A8 ffw1 product); row T
// (with memory) gives the next layer's memory row, tanh or +-10 clip.
// One warp per row.
template <typename T>
__global__ void residual_ffn_ln_kernel(const T* __restrict__ out,
                                       const float* __restrict__ hin,
                                       float* __restrict__ hres,
                                       float* __restrict__ memrow,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       T* __restrict__ ff_in,
                                       float* __restrict__ ff_in32, int B, int D,
                                       int Tr, int use_mem, int tanh_on_mem) {
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
    if (d < D) {
      ff_in[base + d] = from_f<T>(v[i]);
      if (ff_in32 != nullptr) ff_in32[base + d] = v[i];
    }
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
// asr_emformer_stack takes the stacked [L, ...] weights and state;
// asr_emformer_layer takes one layer's (L = 1) and the memory row in
// `memrow` (in and out), unless init_memrow asks for the first layer's.
struct EmformerStackArgs {
  int64_t struct_size;
  int32_t dtype;          // 0 = float32, 1 = bfloat16 (compute/state type)
  int32_t B, L, D, H, F, U, R, M, Lc;
  int32_t use_mem, tanh_on_mem, activation;
  int32_t quant;          // W8A8 products, bits kQWq | kQWkv | kQWout | kQW1 | kQW2
  int32_t init_memrow;    // layer entry: memrow = mean of the raw utterance
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
  // W8A8 weights of the quantised products: int8 [L, out, in] (transposed)
  // and per-output-channel f32 scales [L, out]
  const int8_t* wq8; const float* wq_s; const int8_t* wkv8; const float* wkv_s;
  const int8_t* wout8; const float* wout_s;
  const int8_t* w18; const float* w1_s; const int8_t* w28; const float* w2_s;
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
  // W8A8 scratch (only with quant != 0)
  int8_t* aq;   // quantised rows, [max rows, max K]
  float* a_scale; // their scales, [max rows]
  float* q_in32;  // [B, Q, D] f32 copy of q_in (wq quantised)
  float* ff_in32; // [B, T, D] f32 copy of ff_in (ffw1 quantised)
  void* stream;
};

namespace {

constexpr int kErrStructSize = -1;
constexpr int kErrShape = -2;
constexpr size_t kDefaultSmem = 48 * 1024;

enum QuantBits { kQWq = 1, kQWkv = 2, kQWout = 4, kQW1 = 8, kQW2 = 16 };

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

// W8A8 product: quantise the rows of A [M, K] (f32 or compute type), then
// the int8 GEMM with the dequant epilogue
template <typename T, typename Tin>
int qgemm(const Tin* A, int8_t* aq, float* as, const int8_t* wt, const float* ws,
          const T* bias, T* C, int M, int N, int K, int act, cudaStream_t st) {
  if (K % 16 != 0 || aq == nullptr || as == nullptr || wt == nullptr || ws == nullptr)
    return kErrShape;
  quantize_rows_kernel<Tin><<<M, 256, 0, st>>>(A, aq, as, K);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  dim3 grid((N + kQN - 1) / kQN, (M + kQM - 1) / kQM);
  gemm_int8_kernel<T><<<grid, 256, 0, st>>>(aq, as, wt, ws, bias, C, M, N, K, act);
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

size_t ln_smem_bytes(const EmformerStackArgs& a) {
  return (size_t)(a.R + a.U) * a.D * sizeof(float);
}

size_t attn_smem_bytes(const EmformerStackArgs& a) {
  const int Q = a.R + a.U + a.use_mem, Kk = a.M + a.R + a.Lc + a.U, Dh = a.D / a.H;
  return ((size_t)(Q + Kk) * (Dh + 1) + (size_t)Kk * Dh + (size_t)Q * Kk) * sizeof(float);
}

template <typename T>
int prepare(const EmformerStackArgs& a) {
  CHECK_RC(allow_smem(ln_in_kernel<T>, ln_smem_bytes(a)));
  CHECK_RC(allow_smem(attention_kernel<T>, attn_smem_bytes(a)));
  return 0;
}

// One layer of the step: the chain of ten kernels (more in W8A8 mode).
// Layer l of the stacked weights and state; src is the layer's input
// ([utt; rc] order with reorder, else hin's [rc; utt]); y gets the
// utterance rows of the output (nullptr: not written).  The output rows
// [rc; utt] are left in hin and the next layer's memory row in memrow.
template <typename T>
int run_layer(const EmformerStackArgs& a, int l, const float* src, int reorder,
              int init_memrow, float* y) {
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
  const int qz = a.quant;

  const size_t sMem = (size_t)l * B * M * D, sLc = (size_t)l * B * Lc * D;
  const T* mem_in = (const T*)a.mem_in + sMem;
  const T* lck_in = (const T*)a.lck_in + sLc;
  const T* lcv_in = (const T*)a.lcv_in + sLc;
  const size_t wDD = (size_t)l * D * D, wDF = (size_t)l * D * F;
  const int rows_per_block = 4;          // warps per block in row kernels

  ln_in_kernel<T><<<B, 256, ln_smem_bytes(a), st>>>(
      src, reorder, init_memrow, a.hin, a.memrow, mem_in, a.reset,
      a.lnin_s + (size_t)l * D, a.lnin_b + (size_t)l * D, q_in, kv_in,
      (qz & kQWq) ? a.q_in32 : nullptr, D, U, R, M, a.use_mem);
  CHECK_LAUNCH();
  if (qz & kQWq)
    CHECK_RC((qgemm<T, float>(a.q_in32, a.aq, a.a_scale, a.wq8 + wDD, a.wq_s + (size_t)l * D,
                             bq + (size_t)l * D, q, B * Q, D, D, ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(q_in, wq + wDD, bq + (size_t)l * D, q, B * Q, D, D, ACT_NONE, st));
  if (qz & kQWkv)
    CHECK_RC((qgemm<T, T>(kv_in, a.aq, a.a_scale, a.wkv8 + 2 * wDD, a.wkv_s + (size_t)l * 2 * D,
                         bkv + (size_t)l * 2 * D, kv, B * NKV, 2 * D, D, ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(kv_in, wkv + 2 * wDD, bkv + (size_t)l * 2 * D, kv, B * NKV, 2 * D,
                     D, ACT_NONE, st));
  // the roll reads this layer's input memory row before residual_ffn_ln
  // overwrites it with the next layer's
  state_roll_kernel<T><<<dim3(B, M + 2 * Lc), 128, 0, st>>>(
      mem_in, lck_in, lcv_in, kv, a.memrow, a.reset, a.advance,
      (T*)a.mem_out + sMem, (T*)a.lck_out + sLc, (T*)a.lcv_out + sLc, D, U, R, M, Lc);
  CHECK_LAUNCH();
  attention_kernel<T><<<dim3(B, H), 128, attn_smem_bytes(a), st>>>(
      q, kv, lck_in, lcv_in, a.length, a.reset, attn, D, H, U, R, M, Lc, a.use_mem,
      a.neg_inf);
  CHECK_LAUNCH();
  if (qz & kQWout)
    CHECK_RC((qgemm<T, T>(attn, a.aq, a.a_scale, a.wout8 + wDD, a.wout_s + (size_t)l * D,
                         bout + (size_t)l * D, out, B * Q, D, D, ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(attn, wout + wDD, bout + (size_t)l * D, out, B * Q, D, D, ACT_NONE,
                     st));
  residual_ffn_ln_kernel<T><<<(B * Q + rows_per_block - 1) / rows_per_block,
                              32 * rows_per_block, 0, st>>>(
      out, a.hin, a.hres, a.memrow, a.ffln_s + (size_t)l * D, a.ffln_b + (size_t)l * D,
      ff_in, (qz & kQW1) ? a.ff_in32 : nullptr, B, D, Tr, a.use_mem, a.tanh_on_mem);
  CHECK_LAUNCH();
  if (qz & kQW1)
    CHECK_RC((qgemm<T, float>(a.ff_in32, a.aq, a.a_scale, a.w18 + wDF, a.w1_s + (size_t)l * F,
                             b1 + (size_t)l * F, h1, B * Tr, F, D, a.activation, st)));
  else
    CHECK_RC(gemm<T>(ff_in, w1 + wDF, b1 + (size_t)l * F, h1, B * Tr, F, D, a.activation,
                     st));
  if (qz & kQW2)
    CHECK_RC((qgemm<T, T>(h1, a.aq, a.a_scale, a.w28 + wDF, a.w2_s + (size_t)l * D,
                         b2 + (size_t)l * D, h2, B * Tr, D, F, ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(h1, w2 + wDF, b2 + (size_t)l * D, h2, B * Tr, D, F, ACT_NONE, st));
  out_ln_kernel<T><<<(B * Tr + rows_per_block - 1) / rows_per_block,
                     32 * rows_per_block, 0, st>>>(
      a.hres, h2, a.lnout_s + (size_t)l * D, a.lnout_b + (size_t)l * D, a.hin, y, B, D,
      Tr, R);
  CHECK_LAUNCH();
  return 0;
}

// all layers: layer 0 reads the chunk x, the others hin; the last writes y
template <typename T>
int run_stack(const EmformerStackArgs& a) {
  CHECK_RC(prepare<T>(a));
  for (int l = 0; l < a.L; ++l)
    CHECK_RC(run_layer<T>(a, l, l == 0 ? a.x : a.hin, l == 0, l == 0,
                          l == a.L - 1 ? a.y : nullptr));
  return 0;
}

template <typename T>
int run_one_layer(const EmformerStackArgs& a) {
  CHECK_RC(prepare<T>(a));
  return run_layer<T>(a, 0, a.x, 1, a.init_memrow, a.y);
}

int check_args(const EmformerStackArgs* a) {
  if (a == nullptr || a->struct_size != (int64_t)sizeof(EmformerStackArgs))
    return kErrStructSize;
  if (a->D > 32 * kMaxPerLane || a->H <= 0 || a->D % a->H != 0 || a->B <= 0 ||
      a->L <= 0 || a->U <= 0 || (a->use_mem && a->M <= 0) || a->y == nullptr ||
      (a->quant != 0 && (a->D % 16 != 0 || a->F % 16 != 0)) ||
      (a->dtype != 0 && a->dtype != 1))
    return kErrShape;
  return 0;
}

}  // namespace

extern "C" int asr_emformer_stack(const EmformerStackArgs* a) {
  CHECK_RC(check_args(a));
  return a->dtype == 1 ? run_stack<bf16>(*a) : run_stack<float>(*a);
}

// One layer (kernel C, fused_emformer_layer): the same chain as one layer
// of asr_emformer_stack, on one layer's weights and state (L = 1).  The
// input x is [utt; rc]; the outputs are y (new utterance), hin (the new
// [rc; utt] rows), memrow (the next memory row) and the rolled state.
extern "C" int asr_emformer_layer(const EmformerStackArgs* a) {
  CHECK_RC(check_args(a));
  if (a->L != 1) return kErrShape;
  return a->dtype == 1 ? run_one_layer<bf16>(*a) : run_one_layer<float>(*a);
}

// The W8A8 product alone (quantise the rows of x, int8 GEMM, dequant +
// bias + activation), for tests and timing.  x_is_f32: x is f32 (else
// the compute type); dtype as in EmformerStackArgs.
extern "C" int asr_w8a8_linear(int dtype, int x_is_f32, const void* x, int8_t* aq,
                               float* as, const int8_t* wt, const float* ws,
                               const void* bias, void* y, int M, int N, int K, int act,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return x_is_f32 ? qgemm<bf16, float>((const float*)x, aq, as, wt, ws,
                                         (const bf16*)bias, (bf16*)y, M, N, K, act, st)
                    : qgemm<bf16, bf16>((const bf16*)x, aq, as, wt, ws, (const bf16*)bias,
                                        (bf16*)y, M, N, K, act, st);
  if (dtype == 0)
    return qgemm<float, float>((const float*)x, aq, as, wt, ws, (const float*)bias,
                               (float*)y, M, N, K, act, st);
  return kErrShape;
}

extern "C" const char* asr_cuda_error_string(int code) {
  if (code == kErrStructSize) return "argument struct size mismatch";
  if (code == kErrShape) return "unsupported shape or dtype";
  return cudaGetErrorString((cudaError_t)code);
}
