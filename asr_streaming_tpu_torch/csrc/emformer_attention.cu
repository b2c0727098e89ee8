// Masked Emformer attention core (kernel D), hand-written for Hopper
// (sm_90a).
//
// Replaces: asr_streaming_tpu/ops/pallas_attention.py::
// fused_emformer_attention (Pallas body _attention_kernel, :31-80).  For
// each slot and head: logits = (q * 1/sqrt(Dh)) . k^T in f32, key
// validity from the fill counts (the first M - m_m memory columns and the
// first Lc - m_kv left-context columns are invalid) and the summary-row
// rule (with memory, the last query row never sees a memory column), an
// f32 softmax, and probs . v in f32.  Unlike the stack kernel's attention,
// nothing is rounded to a compute type in between: the Pallas kernel keeps
// f32 throughout.  q, k and v come as f32 or bf16 (bf16 is widened
// exactly on load, so it gives bit for bit what its f32 widening gives)
// and the output goes out as f32 or rounded once to bf16.
//
// What bounds it on this card: at the Vietnamese serving shape in f32
// (B=512, Q=21, K=56, D=512, H=8) one call reads q (22 MB) and k, v
// (59 MB each) and writes 22 MB: ~161 MB, 0.048 ms at 3.35 TB/s, against
// ~1.2 GFLOP (0.018 ms at the f32 rate), so by its bytes it is
// bytes-bound; the f32 FMA products' instruction count is what holds it
// above that (emformer_attention_core.cuh).
//
// What the design does about it: the FMA path of the core in
// emformer_attention_core.cuh: persistent blocks of up to 16 warps in
// groups, each group a unit (a slot's head) of up to 6 query rows a warp
// (at small B one row a warp, a head's rows over several blocks), a ring
// of stages filled by TMA boxes of a unit's q, k and v while the groups
// compute theirs, register-tiled logits and value product, the softmax
// in registers, 16-byte stores.  No tensor cores: the contract is f32
// products, and bf16 inputs must give what their f32 widening gives, bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emformer_attention_core.cuh"

namespace {

using attn_core::bf16;
using attn_core::kErrShape;

// Key columns are [memory (M), right context (R), left context (Lc),
// utterance]; q [B, Q, D], k/v [B, K, D] in Tin, m_m/m_kv [B], out
// [B, Q, D] in f32 or bf16 (a.out_bf16).
template <typename Tin, int KJ, int RW, int DH>
__global__ void __launch_bounds__(attn_core::kMaxWarps * 32, 1)
emformer_attention_kernel(const __grid_constant__ attn_core::Args a) {
  attn_core::run<Tin, KJ, RW, DH, false, false>(a);
}

// the plan and the TMA maps of q, k and v
template <typename Tin>
int make_args(attn_core::Args* x, const void* q, const void* k, const void* v,
              const int32_t* m_m, const int32_t* m_kv, void* out, int out_bf16, int B, int Q,
              int K, int D, int H, int M, int R, int Lc, int use_mem, float neg_inf) {
  constexpr int elem = (int)sizeof(Tin);
  attn_core::Geo& g = x->g;
  if (!attn_core::plain_geo(g, elem, B, Q, K, D, H, M, R, Lc, use_mem)) return kErrShape;
  int rc = attn_core::rows_maps(x->q_map, g, q, elem, Q, D, (long)Q * D, g.qb, g.hpu);
  if (rc == 0) rc = attn_core::rows_maps(x->k_map[0], g, k, elem, K, D, (long)K * D, K, g.hpu);
  if (rc == 0) rc = attn_core::rows_maps(x->v_map, g, v, elem, K, D, (long)K * D, K, g.hpu);
  if (rc != 0) return rc;
  x->out = out;
  x->out_bf16 = out_bf16;
  x->length = nullptr;
  x->reset = nullptr;
  x->m_m = m_m;
  x->m_kv = m_kv;
  x->scaling = (float)(1.0 / sqrt((double)g.Dh));
  x->neg_inf = neg_inf;
  return 0;
}

// the kernel of a plan: by 32-key chunks and rows a warp (1 at small B,
// else up to 6), the serving head width (64) fixed at compile time
template <typename Tin, int RW, int DH>
auto kernel_rows(int kj) {
  switch (kj) {
    case 1: return emformer_attention_kernel<Tin, 1, RW, DH>;
    case 2: return emformer_attention_kernel<Tin, 2, RW, DH>;
    case 3: return emformer_attention_kernel<Tin, 3, RW, DH>;
  }
  return emformer_attention_kernel<Tin, 4, RW, DH>;
}

template <typename Tin, int DH>
auto kernel_dh(const attn_core::Geo& g) {
  const int kj = attn_core::key_chunks(g.K);
  return g.rpw == 1 ? kernel_rows<Tin, 1, DH>(kj)
                    : kernel_rows<Tin, attn_core::kMaxRowsPerWarp, DH>(kj);
}

template <typename Tin>
auto kernel_for(const attn_core::Geo& g) {
  return g.Dh == 64 ? kernel_dh<Tin, 64>(g) : kernel_dh<Tin, 0>(g);
}

template <typename Tin>
int launch(const void* q, const void* k, const void* v, const int32_t* m_m,
           const int32_t* m_kv, void* out, int out_bf16, int B, int Q, int K, int D, int H,
           int M, int R, int Lc, int use_mem, float neg_inf, cudaStream_t st) {
  attn_core::Args x;
  const int rc = make_args<Tin>(&x, q, k, v, m_m, m_kv, out, out_bf16, B, Q, K, D, H, M, R, Lc,
                                use_mem, neg_inf);
  if (rc != 0) return rc;
  return attn_core::launch(kernel_for<Tin>(x.g), x, st);
}

bool geometry_ok(int B, int Q, int K, int D, int H, int M, int R, int Lc, int in_bf16) {
  if (B <= 0 || H <= 0 || D % H != 0 || M + R + Lc > K) return false;
  return in_bf16 ? attn_core::supports<bf16>(Q, K, D / H)
                 : attn_core::supports<float>(Q, K, D / H);
}

}  // namespace

// in_bf16 / out_bf16: q, k, v / out are bf16 (else f32)
extern "C" int asr_emformer_attention(const void* q, const void* k, const void* v,
                                      const int32_t* m_m, const int32_t* m_kv, void* out,
                                      int B, int Q, int K, int D, int H, int M, int R,
                                      int Lc, int use_mem, float neg_inf, int in_bf16,
                                      int out_bf16, void* stream) {
  if (!geometry_ok(B, Q, K, D, H, M, R, Lc, in_bf16)) return kErrShape;
  cudaStream_t st = (cudaStream_t)stream;
  return in_bf16 ? launch<bf16>(q, k, v, m_m, m_kv, out, out_bf16, B, Q, K, D, H, M, R, Lc,
                                use_mem, neg_inf, st)
                 : launch<float>(q, k, v, m_m, m_kv, out, out_bf16, B, Q, K, D, H, M, R, Lc,
                                 use_mem, neg_inf, st);
}

// What D's launch uses at a geometry: out[0..14] as attn_core::report
// gives them (its plan, registers a thread, blocks resident an SM); needs
// the card.
extern "C" int asr_emformer_attention_plan(int B, int Q, int K, int D, int H, int M, int R,
                                           int Lc, int use_mem, int in_bf16, int out_bf16,
                                           int* out) {
  if (!geometry_ok(B, Q, K, D, H, M, R, Lc, in_bf16)) return kErrShape;
  attn_core::Geo g;
  if (!attn_core::plain_geo(g, in_bf16 ? 2 : 4, B, Q, K, D, H, M, R, Lc, use_mem))
    return kErrShape;
  (void)out_bf16;   // the output type is a launch argument, not a kernel
  return in_bf16 ? attn_core::report(kernel_for<bf16>(g), g, out)
                 : attn_core::report(kernel_for<float>(g), g, out);
}
