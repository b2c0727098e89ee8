// Masked Emformer attention core, hand-written for Hopper (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_attention.py::
// fused_emformer_attention (Pallas body _attention_kernel).  For each slot
// and head: logits = (q * 1/sqrt(Dh)) . k^T in f32, key validity from the
// fill counts (the first M - m_m memory columns and the first Lc - m_kv
// left-context columns are invalid) and the summary-row rule (with
// memory, the last query row never sees a memory column), an f32 softmax,
// and probs . v in f32.  Unlike the stack kernel's attention, nothing is
// rounded to a compute type in between: the Pallas kernel keeps f32
// throughout.  q, k and v come as f32 or bf16 (bf16 is widened exactly on
// load, so it gives bit for bit what its f32 widening gives) and the
// output goes out as f32 or rounded once to bf16.
//
// What bounds it on this card: at the Vietnamese serving shape in f32
// (B=512, Q=21, K=56, D=512, H=8) one call reads q (22 MB) and k, v
// (59 MB each) and writes 22 MB: ~161 MB, 0.048 ms at 3.35 TB/s, against
// ~1.2 GFLOP (0.018 ms at the f32 rate), so by its bytes it is
// bytes-bound; the f32 FMA products' instruction count is what holds it
// above that (emformer_attention_core.cuh).
//
// What the design does about it: the FMA path of the core in
// emformer_attention_core.cuh (16-byte cp.async staging of K/V while q is
// read and scaled, register-tiled logits and value product, the softmax
// in registers, 16-byte stores; one block of 128 threads per (slot,
// head), several resident per SM so loads overlap compute).  No tensor
// cores: the contract is f32 products, and bf16 inputs must give what
// their f32 widening gives, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emformer_attention_core.cuh"

namespace {

using attn_core::bf16;

constexpr int kErrShape = -2;

// The items of one call: (slot b, head h) = (i / H, i % H) over q
// [B, Q, D], k/v [B, K, D] in Tin, m_m/m_kv [B] and out [B, Q, D] in Tout.
template <typename Tin, typename Tout>
struct Items {
  const Tin* q; const Tin* k; const Tin* v;
  const int32_t* m_m; const int32_t* m_kv;
  Tout* out;
  int Q, K, stride, H, Dh;      // stride = D

  __device__ size_t head(int i, int rows) const {
    return (size_t)(i / H) * rows * stride + (i % H) * Dh;
  }
  __device__ const Tin* any() const { return k; }
  __device__ const Tin* qrow(int i) const { return q + head(i, Q); }
  __device__ auto rows(int i) const {
    const Tin* kb = k + head(i, K);
    const Tin* vb = v + head(i, K);
    const int d = stride;
    return [=](int c, const Tin*& kr, const Tin*& vr) {
      kr = kb + (size_t)c * d;
      vr = vb + (size_t)c * d;
    };
  }
  __device__ int mm(int i) const { return m_m[i / H]; }
  __device__ int mkv(int i) const { return m_kv[i / H]; }
  __device__ Tout* outrow(int i) const { return out + head(i, Q); }
};

// Key columns are [memory (M), right context (R), left context (Lc),
// utterance]; one block per (slot, head) item.
template <typename Tin, typename Tout, int KJ>
__global__ void __launch_bounds__(attn_core::kThreads)
emformer_attention_kernel(Items<Tin, Tout> it, int M, int R, int Lc, int use_mem,
                          float neg_inf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const attn_core::Layout L = attn_core::make_layout<Tin>(it.Q, it.K, it.Dh);
  const float scaling = (float)(1.0 / sqrt((double)it.Dh));
  attn_core::run<Tin, Tout, KJ, false, false>(L, smem, it, blockIdx.x, scaling, M, R, Lc,
                                              use_mem, neg_inf);
}

template <typename Tin, typename Tout, int KJ>
int launch(const void* q, const void* k, const void* v, const int32_t* m_m,
           const int32_t* m_kv, void* out, int B, int Q, int K, int D, int H, int M, int R,
           int Lc, int use_mem, float neg_inf, cudaStream_t st) {
  auto kernel = emformer_attention_kernel<Tin, Tout, KJ>;
  const int smem = attn_core::make_layout<Tin>(Q, K, D / H).bytes;
  if (smem > 48 * 1024) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
    if (e != 0) return e;
  }
  const Items<Tin, Tout> it{(const Tin*)q, (const Tin*)k, (const Tin*)v, m_m, m_kv,
                            (Tout*)out, Q, K, D, H, D / H};
  kernel<<<B * H, attn_core::kThreads, smem, st>>>(it, M, R, Lc, use_mem, neg_inf);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int dispatch(int kj, const void* q, const void* k, const void* v, const int32_t* m_m,
             const int32_t* m_kv, void* out, int B, int Q, int K, int D, int H, int M,
             int R, int Lc, int use_mem, float neg_inf, cudaStream_t st) {
  switch (kj) {
    case 1: return launch<Tin, Tout, 1>(q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
    case 2: return launch<Tin, Tout, 2>(q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
    case 3: return launch<Tin, Tout, 3>(q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
    case 4: return launch<Tin, Tout, 4>(q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
  }
  return kErrShape;
}

}  // namespace

// in_bf16 / out_bf16: q, k, v / out are bf16 (else f32)
extern "C" int asr_emformer_attention(const void* q, const void* k, const void* v,
                                      const int32_t* m_m, const int32_t* m_kv, void* out,
                                      int B, int Q, int K, int D, int H, int M, int R,
                                      int Lc, int use_mem, float neg_inf, int in_bf16,
                                      int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || D % H != 0 || M + R + Lc > K) return kErrShape;
  const int Dh = D / H;
  if (in_bf16 ? !attn_core::supports<bf16>(Q, K, Dh) : !attn_core::supports<float>(Q, K, Dh))
    return kErrShape;
  const int kj = attn_core::key_chunks(K);
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16)
    return out_bf16 ? dispatch<bf16, bf16>(kj, q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st)
                    : dispatch<bf16, float>(kj, q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
  return out_bf16 ? dispatch<float, bf16>(kj, q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st)
                  : dispatch<float, float>(kj, q, k, v, m_m, m_kv, out, B, Q, K, D, H, M, R, Lc, use_mem, neg_inf, st);
}
