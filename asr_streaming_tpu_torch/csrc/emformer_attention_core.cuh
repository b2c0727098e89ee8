// The masked Emformer attention core for one (slot, head), shared by
// kernel D (csrc/emformer_attention.cu, emformer_attention_kernel) and
// kernel A's attention (csrc/emformer_stack.cu, attention_kernel), with the
// small helpers both sources use.
//
// Replaces the per-(slot, head) body of asr_streaming_tpu/ops/
// pallas_attention.py::_attention_kernel and of the attention part of
// pallas_emformer.py::_layer_math: logits = (q * scaling) . k^T in f32,
// the key validity from the fill counts (the first M - m_m memory columns
// and the first Lc - m_kv left-context columns are invalid; with memory,
// the summary row, the last, sees no memory column), an f32 softmax, and
// probs . v in f32.  kRound adds the stack kernel's rounding points:
// q * scaling and the probabilities are rounded to the compute type T.
//
// What bounds it on this card: bytes, in principle.  At the Vietnamese
// shape (Q = 21, K = 56, Dh = 64) one (slot, head) moves 34 KB of f32
// q/k/v (17 KB in bf16) for 150 K multiply-adds, 4.4 per byte against the
// 20 f32 FLOP/byte at which the card turns compute-bound.  On the H100
// the FMA products hold it instead: kernel D on bf16 inputs (half the
// bytes) takes 86% of its f32 time.  Counting loads, conversions and the
// softmax, a (slot, head) is about 10 K warp instructions, so 4,096 of
// them keep the issue slots about as busy as the bytes keep the memory.
//
// What the design does about it: a block of 128 threads per (slot, head)
// stages its K and V rows with 16-byte cp.async copies (bf16 stays bf16
// in shared memory) while it reads and scales q with 16-byte loads, so
// each input byte crosses device memory once, in 16-byte pieces, and
// several blocks stay resident per SM: one computes while the others'
// copies are in flight.  Two product paths share that staging, the masks
// and the softmax:
// - FMA (attend): f32 products from registers.  A warp owns query rows
//   w, w+4, ...; a lane owns keys lane + 32j and takes their logits
//   against all of its warp's rows at once (16-byte key reads, broadcast
//   q reads, rows padded by 16 bytes so eight lanes hit 32 banks); the
//   softmax runs in those registers with warp shuffles; the value product
//   gives each lane 16 bytes of output columns of a few rows and stores
//   them as 16-byte vectors.  Every sum runs in the same order whatever T
//   is, so bf16 inputs give bit for bit what the same values widened to
//   f32 give.  Kernel D (f32 contract) and A in f32 take it.
// - Tensor cores (attend_mma): A in bf16, whose rounding points make both
//   products exact bf16 x bf16 terms summed in f32, runs them as
//   mma.sync m16n8k16 with the softmax on the accumulator registers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_core {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- helpers

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

// round an f32 value to T and back
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

// 16-byte global -> shared copy; valid = false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(bytes));
}

// elements of T in 16 bytes
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes of T (16-byte aligned) widened to f32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// N f32 values to N values of T at p (4 * N bytes aligned for f32, 2 * N
// for bf16): 16-byte stores where the run is 16 bytes or more
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int N>
__device__ __forceinline__ void store_row(bf16* p, const float (&v)[N]) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  }
}

// ------------------------------------------------------------ the core

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerWarp = 8;                  // Q <= 32
constexpr int kMaxKeyChunks = 4;                    // K <= 128 (keys per lane)
constexpr int kMaxRowsPerLane = kMaxRowsPerWarp / 2;

// Shared memory of one block: q scaled, probabilities [Q][Kp] f32, and the
// stage: k [Kp][Dh + 16 bytes] and v [Kp][vs] of one (slot, head) in T,
// the rows past K zero-filled.  FMA products: q
// [Q][Dh+4] f32, Kp = K rounded up to 4, vs = Dh.  Tensor-core products
// (mma, bf16 only): q [32][Dh+8] bf16, Kp = K rounded up to 16, vs =
// Dh + 8, no probabilities (they stay in registers); the 16-byte row
// padding puts eight ldmatrix rows on 32 different banks.
struct Layout {
  int Q, K, Kp, Dh, qs, ks, vs;  // qs, ks, vs: q, k and v row strides in elements
  int p_off, stage0, k_off, v_off, bytes;   // k/v: in the stage
};

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

template <typename T>
__host__ __device__ inline Layout make_layout(int Q, int K, int Dh, bool mma = false) {
  Layout L;
  L.Q = Q;
  L.K = K;
  L.Kp = mma ? (K + 15) & ~15 : (K + 3) & ~3;
  L.Dh = Dh;
  L.qs = mma ? Dh + 8 : Dh + 4;
  L.ks = Dh + (int)(16 / sizeof(T));
  L.vs = mma ? L.ks : Dh;
  L.p_off = align16(mma ? 32 * L.qs * 2 : Q * L.qs * 4);
  L.stage0 = L.p_off + (mma ? 0 : align16(Q * L.Kp * 4));
  L.k_off = 0;
  L.v_off = align16(L.Kp * L.ks * (int)sizeof(T));
  L.bytes = L.stage0 + L.v_off + align16(L.Kp * L.vs * (int)sizeof(T));
  return L;
}

// The shapes the core takes: Q <= 32 rows, K <= 128 keys, and Dh a power
// of two times the 16-byte vector with at least two rows per warp in the
// value product (Dh / (16 / sizeof(T)) in {1, 2, 4, 8, 16}).
template <typename T>
__host__ inline bool supports(int Q, int K, int Dh) {
  const int e = 16 / (int)sizeof(T), lpr = Dh / e;
  return Q >= 1 && Q <= kWarps * kMaxRowsPerWarp && K >= 1 &&
         K <= 32 * kMaxKeyChunks && Dh % e == 0 && lpr >= 1 && lpr <= 16 &&
         (lpr & (lpr - 1)) == 0;
}

// The shapes the tensor-core products take (bf16): Q <= 32 rows (two
// 16-row tiles), K <= 128 keys, Dh a multiple of 16 up to 64.
__host__ inline bool supports_mma(int Q, int K, int Dh) {
  return Q >= 1 && Q <= 32 && K >= 1 && K <= 128 && Dh % 16 == 0 && Dh <= 64;
}

// key chunks of 32 for K keys (the kernels' template argument)
__host__ inline int key_chunks(int K) { return (((K + 3) & ~3) + 31) / 32; }

// Issue the 16-byte copies of one (slot, head)'s K and V rows into the
// stage, as one cp.async group: rows(c, krow, vrow) sets row c's two
// source pointers (already offset to the head; a null pointer for a zero
// row); `any` is some valid global address for the zero-fill copies.
template <typename T, typename Rows>
__device__ __forceinline__ void load_kv(const Layout& L, unsigned char* stage, Rows rows,
                                        const T* any) {
  constexpr int E = Vec<T>::N;
  T* ks = reinterpret_cast<T*>(stage + L.k_off);
  T* vs = reinterpret_cast<T*>(stage + L.v_off);
  const int cpr = L.Dh / E;
  for (int i = threadIdx.x; i < L.Kp * cpr; i += kThreads) {
    const int c = i / cpr, e = (i - c * cpr) * E;
    const T* kr = nullptr;
    const T* vr = nullptr;
    if (c < L.K) rows(c, kr, vr);
    cp_async16(ks + c * L.ks + e, kr ? kr + e : any, kr != nullptr);
    cp_async16(vs + c * L.vs + e, vr ? vr + e : any, vr != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// q rows q + r * stride (offset to the head), read with 16-byte loads while
// the K/V copies are in flight, as f32 q * scaling, rounded to T with
// kRound; kept in f32 for the FMA products, in bf16 for the tensor-core
// ones (kMma: T is bf16 and kRound is set, so the value is the same).
template <typename T, bool kRound, bool kMma>
__device__ __forceinline__ void stage_q(const Layout& L, unsigned char* smem, const T* q,
                                        int stride, float scaling) {
  constexpr int E = Vec<T>::N;
  const int cpr = L.Dh / E;
  for (int i = threadIdx.x; i < L.Q * cpr; i += kThreads) {
    const int r = i / cpr, e = (i - r * cpr) * E;
    float v[E];
    load16(q + (size_t)r * stride + e, v);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[j] = v[j] * scaling;
      if (kRound) v[j] = rnd<T>(v[j]);
    }
    if constexpr (kMma)
      store_row<E>(reinterpret_cast<bf16*>(smem) + r * L.qs + e, v);
    else
      store_row<E>(reinterpret_cast<float*>(smem) + r * L.qs + e, v);
  }
}

// Logits, mask, softmax and the value product of the (slot, head) in
// `stage`, its q scaled; out + r * out_stride is query row r's output
// (offset to the head).
template <typename T, typename Tout, int KJ, bool kRound>
__device__ __forceinline__ void attend(const Layout& L, unsigned char* smem,
                                       const unsigned char* stage, int M, int R, int Lc,
                                       int use_mem, int mm, int mkv, float neg_inf, Tout* out,
                                       int out_stride) {
  constexpr int E = Vec<T>::N;
  const float* qs = reinterpret_cast<const float*>(smem);
  const T* ks = reinterpret_cast<const T*>(stage + L.k_off);
  const T* vs = reinterpret_cast<const T*>(stage + L.v_off);
  float* ps = reinterpret_cast<float*>(smem + L.p_off);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int Q = L.Q, K = L.K, Kp = L.Kp, Dh = L.Dh;
  const int rpw = (Q - w + kWarps - 1) / kWarps;    // rows w + kWarps * i

  // logits: acc[i][j] = q[row i] . k[lane + 32 j], summed over d in order
  float acc[kMaxRowsPerWarp][KJ];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < Dh; d0 += E) {
    float kv[KJ][E];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = lane + 32 * j;
      if (c < Kp) {
        load16(ks + c * L.ks + d0, kv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      if (i < rpw) {
        const float* qr = qs + (w + kWarps * i) * L.qs + d0;
        float qv[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(qr + e);
          qv[e] = t.x; qv[e + 1] = t.y; qv[e + 2] = t.z; qv[e + 3] = t.w;
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < KJ; ++j) acc[i][j] = fmaf(qv[e], kv[j][e], acc[i][j]);
      }
    }
  }

  // mask and softmax in registers; probabilities to shared memory
  const int lc_lo = M + R, lc_hi = M + R + (Lc - mkv), mem_hi = M - mm;
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    if (i < rpw) {
      const int r = w + kWarps * i;
      float mx = -3.402823466e38f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        bool valid = !(c >= lc_lo && c < lc_hi);
        if (use_mem && c < M && (c < mem_hi || r == Q - 1)) valid = false;
        acc[i][j] = valid ? acc[i][j] : neg_inf;
        if (c < K) mx = fmaxf(mx, acc[i][j]);
      }
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        acc[i][j] = c < K ? expf(acc[i][j] - mx) : 0.f;
        s += acc[i][j];
      }
      s = warp_sum(s);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        if (c < Kp) {
          float p = acc[i][j] / s;
          if (kRound) p = rnd<T>(p);
          ps[r * Kp + c] = p;
        }
      }
    }
  }
  __syncwarp();

  // value product: lane = (row slot g, column group cg) owns E columns of
  // rows i = g, g + rpi, ...; summed over the keys in order
  const int lpr = Dh / E, rpi = 32 / lpr;
  const int cg = lane % lpr, g = lane / lpr;
  const int rpl = (rpw + rpi - 1) / rpi;
  float o[kMaxRowsPerLane][E];
#pragma unroll
  for (int t = 0; t < kMaxRowsPerLane; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) o[t][e] = 0.f;
  for (int c0 = 0; c0 < Kp; c0 += 4) {
    float p4[kMaxRowsPerLane][4];
#pragma unroll
    for (int t = 0; t < kMaxRowsPerLane; ++t) {
      const int i = g + rpi * t;
      if (t < rpl && i < rpw) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (w + kWarps * i) * Kp + c0);
        p4[t][0] = pv.x; p4[t][1] = pv.y; p4[t][2] = pv.z; p4[t][3] = pv.w;
      } else {
        p4[t][0] = p4[t][1] = p4[t][2] = p4[t][3] = 0.f;
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float vv[E];
      load16(vs + (c0 + cc) * L.vs + cg * E, vv);
#pragma unroll
      for (int t = 0; t < kMaxRowsPerLane; ++t) {
        if (t < rpl) {
#pragma unroll
          for (int e = 0; e < E; ++e) o[t][e] = fmaf(p4[t][cc], vv[e], o[t][e]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxRowsPerLane; ++t) {
    const int i = g + rpi * t;
    if (t < rpl && i < rpw) {
      const int r = w + kWarps * i;
      store_row<E>(out + (size_t)r * out_stride + cg * E, o[t]);
    }
  }
}

// ------------------------------------------------ tensor-core products

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// attend() with both products on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 sums), for bf16 with the stack kernel's rounding points:
// q * scaling and the probabilities are bf16 values, so each product is
// exact and only the order of the f32 sums differs from the FMA path.
// Warp w < 2 takes query rows 16w .. 16w + 15: its logits stay in the
// accumulator registers (lane: rows g and g + 8, keys 8n + 2t, + 1) for
// the mask and the softmax (row max and sum over the quad of lanes that
// share a row), and its probabilities, rounded to bf16, become the A
// fragments of the value product as they are; V comes through ldmatrix
// .trans.  Warps past the query rows have nothing to do.
template <int KJ>
__device__ __forceinline__ void attend_mma(const Layout& L, unsigned char* smem,
                                           const unsigned char* stage, int M, int R, int Lc,
                                           int use_mem, int mm, int mkv, float neg_inf,
                                           bf16* out, int out_stride) {
  constexpr int NT = 4 * KJ;              // key tiles of 8
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w * 16 >= L.Q) return;
  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  const bf16* ks = reinterpret_cast<const bf16*>(stage + L.k_off);
  const bf16* vs = reinterpret_cast<const bf16*>(stage + L.v_off);
  const int m0 = 16 * w, g = lane >> 2, t = lane & 3;
  const int nt_n = L.Kp / 8;              // even: Kp is a multiple of 16

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int k0 = 0; k0 < L.Dh; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, qs + (m0 + (lane & 15)) * L.qs + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < nt_n) {
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * L.ks + k0 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // mask and softmax: value s[n][2h + e] is row m0 + g + 8h, key 8n + 2t + e
  const int lc_lo = M + R, lc_hi = M + R + (Lc - mkv), mem_hi = M - mm;
  float mx[2] = {-3.402823466e38f, -3.402823466e38f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e, r = m0 + g + 8 * h;
        bool valid = !(c >= lc_lo && c < lc_hi);
        if (use_mem && c < M && (c < mem_hi || r == L.Q - 1)) valid = false;
        const float x = valid ? s[n][2 * h + e] : neg_inf;
        s[n][2 * h + e] = x;
        if (n < nt_n && c < L.K) mx[h] = fmaxf(mx[h], x);
      }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        const float p = (n < nt_n && c < L.K) ? expf(s[n][2 * h + e] - mx[h]) : 0.f;
        s[n][2 * h + e] = p;
        sum[h] += p;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // value product: the probabilities of keys 16kk .. 16kk + 15 are the A
  // fragment (key tiles 2kk and 2kk + 1), rounded to bf16
  const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
  float o[8][4];                          // Dh <= 64
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < nt_n) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
      a[1] = pack_bf16x2(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
      a[2] = pack_bf16x2(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
      a[3] = pack_bf16x2(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np < L.Dh) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L.vs +
                               16 * np + (lane >> 4) * 8);
          mma_bf16(o[2 * np], a, b[0], b[1]);
          mma_bf16(o[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (8 * n < L.Dh) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        if (r < L.Q)
          *reinterpret_cast<uint32_t*>(out + (size_t)r * out_stride + 8 * n + 2 * t) =
              pack_bf16x2(o[n][2 * h], o[n][2 * h + 1]);
      }
    }
  }
}

// One (slot, head) item, item = slot * H + head, by one block: its K/V
// copies, q scaled meanwhile, then attend.  `it` gives the item's q
// (it.qrow(i), rows it.stride apart), its K/V rows (it.rows(i), as load_kv
// takes them), fill counts (it.mm(i), it.mkv(i)) and output (it.outrow(i),
// rows it.stride apart); it.any() is a valid global address.
template <typename T, typename Tout, int KJ, bool kRound, bool kMma, typename Item>
__device__ __forceinline__ void run(const Layout& L, unsigned char* smem, const Item& it,
                                    int i, float scaling, int M, int R, int Lc, int use_mem,
                                    float neg_inf) {
  unsigned char* stage = smem + L.stage0;
  load_kv<T>(L, stage, it.rows(i), it.any());
  stage_q<T, kRound, kMma>(L, smem, it.qrow(i), it.stride, scaling);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if constexpr (kMma)
    attend_mma<KJ>(L, smem, stage, M, R, Lc, use_mem, it.mm(i), it.mkv(i), neg_inf,
                   it.outrow(i), it.stride);
  else
    attend<T, Tout, KJ, kRound>(L, smem, stage, M, R, Lc, use_mem, it.mm(i), it.mkv(i),
                                neg_inf, it.outrow(i), it.stride);
}

}  // namespace attn_core
