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
// What the design does about it: the five bf16 products of a layer run on
// one Hopper GEMM (gemm_bf16_wgmma_kernel: persistent blocks, one an SM,
// TMA loads into a ring of 128-byte-swizzled stages, a producer warp, and
// two consumer warpgroups that take the block's tiles in turn, a whole
// tile each: a ping-pong, so that one warpgroup's epilogue (the bias, the
// roundings, the activation, the TMA stores) runs while the other's
// wgmma do).  The main loop is bound by the bytes the SMs load from L2
// (about 11 TB/s over the card at every serving product), so the tile
// per product is the one whose busiest SM loads the fewest bytes, 128x128
// or 64x128 (gemm_config), and a layer's q and kv products share one
// launch, their tiles one list, which at the EN shape (2,560 rows) puts
// a tile on every SM.  The epilogue's bias and scales load under the main
// loop (load_ep); its GELU and SiLU read a table of all 65,536 bf16
// inputs built once per card (act_lookup).  The epilogue shares the SM's
// shared memory with the other warpgroup's main loop (wgmma operands, TMA
// stages), and that, not its arithmetic, is what it waits on: the
// activation's table reads still hold ffn1 at about twice its main loop.
// Computing the activation (tanhf, or exact fast arithmetic away from
// rounding midpoints), or applying it in the unrolled first pass, was
// slower on the card.  The other design measured, both warpgroups on one
// 128x256 tile with an asynchronous TMA-store epilogue, was slower at
// every serving product (tools/gemm_epilogue.py; PERF.md).  The attention runs on the core it
// shares with kernel D (emformer_attention_core.cuh), in bf16 on the
// tensor cores (mma.sync); the W8A8 products run the same GEMM on int8
// (gemm_int8_wgmma_kernel: wgmma m64n128k32 s8 with exact s32 sums, the
// dequant epilogue of _qdot; at 1,979 TOP/s the int8 peak is twice the
// bf16 one) on rows quantised where they are made, or by a quantiser
// kernel (below).  In f32 (the offline API: 1-3 slots,
// 20-72 rows a product) the work is bound by the weights' bytes, and a
// product of up to 128 rows runs on a split-K kernel that streams them
// over the whole card (gemm_f32_splitk_kernel, note below); more rows
// take the tiled f32 kernel.  The Pallas kernel's VMEM-resident
// megakernel does not translate (a block has 227 KB of shared memory, the
// TPU tile had ~100 MB of VMEM), so one layer is a short chain of simple
// kernels: gemm(q, kv) -> attention -> gemm(out) -> rows_residual ->
// gemm(ffn1+act) -> gemm(ffn2) -> rows_boundary (this layer's output LN
// and the next layer's input LN in one pass), with rows_first before the
// first layer and rows_last in place of the last boundary; the state roll
// runs inside those row kernels (their notes, below).  That
// chain is run_layer(); the C entry asr_emformer_layer runs it once
// (kernel C, one launch per layer from the host) and asr_emformer_stack
// loops it over the layers in one host call (kernel A), so the two cannot
// drift apart.  Inter-layer activations stay in f32 device scratch.  The
// state roll writes new buffers (no in-place shift across threads).  In
// W8A8 mode each product quantises the values _qdot(x.astype(f32)) reads:
// the row kernels quantise q's rows (the f32 LN rows and summary row),
// kv's (the memory rows and the LN rows rounded to the compute type) and
// ffn1's (the f32 FFN-LN rows) as they make them (store_row_q8), so q and
// kv run in one int8 launch; out's rows (the attention's, a row over its
// heads' blocks) and ffn2's (ffn1's epilogue, a row over its N tiles)
// take quantize_rows_kernel, a warp a row held in registers.  The Mosaic
// tiling knobs (tile, layers_per_step, ffn_slices) carry no semantics and
// are not reproduced.
// Not yet done: a main loop nearer the bf16 peak (it runs at 55-65% of
// it, bound by L2 bytes).  Clusters of two blocks sharing each W slice by
// TMA multicast (a stage refilled once both blocks released it) held the
// digests but ran slower on the card, and were not kept.  Also the row
// kernels (and out's and ffn2's quantisers) in the GEMMs' prologues and
// epilogues, one persistent launch for all layers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <mutex>
#include <type_traits>

#include "emformer_attention_core.cuh"

namespace {

using attn_core::bf16;
using attn_core::from_f;
using attn_core::rnd;
using attn_core::to_f;
using attn_core::warp_max;
using attn_core::warp_sum;

// ---------------------------------------------------------------- helpers

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
// activation on that rounded value, rounded again (returned widened)
template <typename T>
__device__ __forceinline__ float epilogue_v(float acc, float bias, int act) {
  float v = rnd<T>(rnd<T>(acc) + bias);
  if (act != ACT_NONE) v = rnd<T>(activate(v, act));
  return v;
}

template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, int n, int act) {
  return from_f<T>(epilogue_v<T>(acc, to_f<T>(bias[n]), act));
}

// LayerNorm of one row held by a warp: lane owns elements lane + 32*i,
// i < N (D <= 32 * N).  Lanes past D add nothing, so the bits do not
// depend on N.
constexpr int kMaxPerLane = 32;

template <int N>
__device__ __forceinline__ void warp_layer_norm(float (&v)[N], int D, const float* scale,
                                                const float* bias) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int d = lane + 32 * i;
    if (d < D) s += v[i];
  }
  const float mean = warp_sum(s) / (float)D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int d = lane + 32 * i;
    if (d < D) {
      float c = v[i] - mean;
      s2 += c * c;
    }
  }
  const float var = warp_sum(s2) / (float)D;
  const float inv = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int d = lane + 32 * i;
    if (d < D) v[i] = (v[i] - mean) * inv * scale[d] + bias[d];
  }
}

// ------------------------------------------------------------------ GEMMs
// C[M,N] = epilogue(A[M,K] @ W[K,N]); A and C row-major.  Ragged M, N and
// K are masked (zero-filled tiles).

// bf16 on Hopper: C = epilogue(A . Wt^T) with the weight K-major, Wt
// [L, N, K] (the wrapper's copy of the [in, out] weight, transposed once
// per params object), the product reading layer `layer`.  Persistent
// blocks, one an SM, walk the output tiles (the tile index striding by
// the grid); a launch may hold two products with the same K, their tiles
// one list (GemmLaunch: a layer's q and kv).  TMA copies 64-deep K slices
// of A and Wt (128 bytes of bf16 per row, 128-byte swizzle) into a ring of
// ST stages that runs on across tiles; one producer warp keeps it full,
// mbarriers marking each stage full (TMA bytes landed) and empty (its
// consumer's wgmma done with it).  Two consumer warpgroups take the
// block's tiles in turn, a whole WM x BN tile each (wgmma m64n128k16, bf16
// in, f32 accumulators in registers, one K slice's group in flight), so
// that one's epilogue runs under the other's products (gemm_body).  The
// epilogue keeps epilogue_v<bf16>'s rounding: round(acc) + bias in bf16
// into the warpgroup's swizzled output tile in shared memory, then the
// activation of that, rounded (GELU and SiLU from a table: act_lookup),
// then TMA stores.  Needs K % 8 == 0 and N % 8 == 0 (16-byte
// TMA strides).  The W8A8 product (gemm_int8_wgmma_kernel) is the same
// kernel on int8 operands: 128-deep K slices (the same 128 bytes a row),
// wgmma m64n128k32 s8 with s32 sums, the dequant in the epilogue's first
// pass; it needs K % 16 == 0.
namespace gemm90 {

constexpr int kBK = 64;           // bf16 K per stage: one 128-byte swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the waits
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] . B[N x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 128, "the tiles are 128 columns wide");
  wgmma_m64n128k16(d, da, db);
}

// D[64 x N] += A[64 x 32] . B[N x 32]^T in int8 with s32 sums (exact),
// both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 128, "the tiles are 128 columns wide");
  wgmma_m64n128k32_s8(d, da, db);
}

// The epilogue's GELU or SiLU, round(act(v)) of a bf16 v, is a function
// of 16 bits, tabulated once per card with activate() for all 65,536 v
// (g_act_table, act_table_kernel, run by gemm_setup), so a lookup gives
// the bits a computed activation gives.  A block copies the part that
// serving outputs fall in, |v| in [2^-14, 16) (biased exponents kLutE0 ..
// kLutE0 + kLutExps - 1, both signs: two contiguous runs of the table),
// into shared memory while its first slices load; the rest (zeros, the
// smallest values, |v| >= 16, not finite: rare after a layer norm) is
// read from the table in device memory.  One read takes the place of a
// tanh or an exp, and no call or inlined tanh sits in the unrolled
// epilogue (an inlined activation there swamped the instruction cache;
// ReLU is computed).
constexpr int kLutE0 = 113, kLutExps = 18;
constexpr int kLutEntries = 2 * kLutExps * 128;

__device__ __align__(16) uint16_t g_act_table[2][65536];       // GELU, SiLU

__device__ __forceinline__ uint32_t act_bits(uint32_t h, int act) {
  return attn_core::pack_bf16x2(activate(__uint_as_float(h << 16), act), 0.f) & 0xffffu;
}

__global__ void act_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * 65536)
    g_act_table[i >> 16][i & 0xffff] = (uint16_t)act_bits(i & 0xffff, i >> 16 ? ACT_SILU : ACT_GELU);
}

// round(act(v)) of the bf16 bits h: the block's shared-memory part of the
// table, else the table in device memory
__device__ __forceinline__ uint32_t act_lookup(const uint16_t* lut, const uint16_t* table,
                                               uint32_t h) {
  const uint32_t e = ((h >> 7) & 0xffu) - kLutE0;
  return e < (uint32_t)kLutExps ? lut[((h >> 15) * kLutExps + e) * 128 + (h & 127u)]
                                : __ldg(table + h);
}

// the activation of two packed bf16 values (ReLU computed: act_bits'
// arithmetic without its other branches)
__device__ __forceinline__ uint32_t relu_bits(uint32_t h) {
  return attn_core::pack_bf16x2(fmaxf(__uint_as_float(h << 16), 0.f), 0.f) & 0xffffu;
}

__device__ __forceinline__ uint32_t act_pair(uint32_t w, int act, const uint16_t* lut,
                                             const uint16_t* table) {
  if (act == ACT_RELU) return relu_bits(w & 0xffffu) | (relu_bits(w >> 16) << 16);
  return act_lookup(lut, table, w & 0xffffu) | (act_lookup(lut, table, w >> 16) << 16);
}

// the block's copy of the table's serving part (GELU or SiLU), read after
// the barrier that follows it
__device__ __forceinline__ void load_act_lut(uint16_t* lut, int act, int tid, int threads) {
  constexpr int kRun = kLutExps * 128 * 2 / 16;                  // uint4 a sign
  const uint16_t* table = g_act_table[act == ACT_GELU ? 0 : 1];
  for (int i = tid; i < 2 * kRun; i += threads) {
    const int sign = i / kRun;
    reinterpret_cast<uint4*>(lut)[i] = reinterpret_cast<const uint4*>(
        table + (sign << 15) + (kLutE0 << 7))[i % kRun];
  }
}

// act < 0 (kActSkip): the product's main loop alone, no epilogue and no
// output written (asr_gemm_bf16 / asr_w8a8_linear timing only)
constexpr int kActSkip = -1;

// an asynchronous B-byte copy global -> shared (B = 4, 8 or 16), zero
// filled where !valid (nothing is read); waited for by cp.async.wait_all
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(B), "r"(valid ? B : 0)
               : "memory");
}

// A warpgroup's epilogue operands of one tile in shared memory, copied
// while its main loop runs: the bias (bf16, BN), the weights' scales
// (f32, BN) and the rows' scales (f32, WM: W8A8), zero past N and M.
constexpr int kEpBytes = 256 * 6 + 128 * 4;

template <int WM, int BN, bool kInt8>
__device__ __forceinline__ void load_ep(unsigned char* ep, const bf16* __restrict__ bias,
                                        const float* __restrict__ as,
                                        const float* __restrict__ ws, int m0, int n0, int M,
                                        int N, int tid) {
  for (int i = tid; i < BN / 2; i += 128) {
    const int n = n0 + 2 * i;
    const bool ok = n < N;
    cp_async<4>(ep + 4 * i, ok ? bias + n : bias, ok);
    if constexpr (kInt8) cp_async<8>(ep + BN * 2 + 8 * i, ok ? ws + n : ws, ok);
  }
  if constexpr (kInt8)
    for (int i = tid; i < WM; i += 128) {
      const bool ok = m0 + i < M;
      cp_async<4>(ep + BN * 6 + 4 * i, ok ? as + m0 + i : as, ok);
    }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// one box of shared memory into a 3-d tensor map: an asynchronous bulk
// store, committed and waited for by the thread that issues it
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}

// A warpgroup's bf16 output tile in shared memory, as the output's tensor
// map stores it: BN / 64 boxes of [WM rows][128 bytes] (64 columns), each
// 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)), so that a
// quad of lanes writing eight rows, or eight lanes reading a row's 16-byte
// chunks, hit 32 banks.  Byte offset of column c of row r:
template <int WM>
__device__ __forceinline__ uint32_t out_offset(int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * WM * 128 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

// The epilogue's first pass, a warpgroup's 64-row block of accumulators
// (rows r0 .. r0 + 63 of its tile) taken to round(v) + bias in bf16 into
// the output tile, the bias and the scales from the warpgroup's operand
// copy ep (load_ep).  Lane (warp wi, quad lane q) holds rows 16 wi + lane
// / 4 and 8 below, columns 8j + 2q and 8j + 2q + 1 of every 8-column group
// j (d[4j .. 4j+3]).  The int8 accumulators are dequantised as _qdot
// does, (float)acc * as[m] * ws[n] with no contraction (the row scale
// first).  Unrolled over the accumulators, it holds nothing else: the
// activation is a pass of its own (an unrolled one swamped the
// instruction cache).
template <int WM, int BN, typename Acc>
__device__ __forceinline__ void stage_rows(const Acc (&d)[BN / 2], unsigned char* tile, int r0,
                                           const unsigned char* ep) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int rl = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float rs[2] = {1.f, 1.f};
  if constexpr (kInt8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rs[h] = reinterpret_cast<const float*>(ep + BN * 6)[rl + 8 * h];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nl = 8 * j + 2 * q;
    const __nv_bfloat162 bb = reinterpret_cast<const __nv_bfloat162*>(ep)[nl / 2];
    const float b0 = __low2float(bb), b1 = __high2float(bb);
    float w0 = 1.f, w1 = 1.f;
    if constexpr (kInt8) {
      const float2 ww = reinterpret_cast<const float2*>(ep + BN * 2)[nl / 2];
      w0 = ww.x;
      w1 = ww.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0, v1;
      if constexpr (kInt8) {
        v0 = __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h]), rs[h]), w0);
        v1 = __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]), rs[h]), w1);
      } else {
        v0 = d[4 * j + 2 * h];
        v1 = d[4 * j + 2 * h + 1];
      }
      *reinterpret_cast<uint32_t*>(tile + out_offset<WM>(rl + 8 * h, nl)) =
          attn_core::pack_bf16x2(epilogue_v<bf16>(v0, b0, ACT_NONE),
                                 epilogue_v<bf16>(v1, b1, ACT_NONE));
    }
  }
}

// The activation pass over a warpgroup's output tile, in place: each
// value's activation, rounded (act_pair), 16 bytes a thread at a time; a
// rolled loop, two chunks in flight a thread.
template <int WM, int BN>
__device__ __forceinline__ void activate_tile(unsigned char* tile, int act, const uint16_t* lut,
                                              const uint16_t* table) {
#pragma unroll 2
  for (int c = threadIdx.x & 127; c < WM * BN / 8; c += 128) {
    const int r = c / (BN / 8);
    uint4* p = reinterpret_cast<uint4*>(tile + out_offset<WM>(r, (c % (BN / 8)) * 8));
    uint4 u = *p;
    u.x = act_pair(u.x, act, lut, table);
    u.y = act_pair(u.y, act, lut, table);
    u.z = act_pair(u.z, act, lut, table);
    u.w = act_pair(u.w, act, lut, table);
    *p = u;
  }
}

// The f32-output epilogue (the float32 configurations' W8A8 products, not
// a serving path): epilogue_v<float> stored from the registers.
template <int BN>
__device__ __forceinline__ void store_rows_f32(const int (&d)[BN / 2], int r0,
                                               const float* __restrict__ bias,
                                               const float* __restrict__ as,
                                               const float* __restrict__ ws, float* C, int m0,
                                               int n0, int M, int N, int act) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int rl = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + rl + 8 * h;
    if (m >= M) continue;
    const float rs = as[m];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= N) continue;
      const float2 bb = *reinterpret_cast<const float2*>(bias + n);
      const float2 ww = *reinterpret_cast<const float2*>(ws + n);
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h]), rs), ww.x);
      const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]), rs), ww.y);
      *reinterpret_cast<float2*>(C + (size_t)m * N + n) =
          make_float2(epilogue_v<float>(v0, bb.x, act), epilogue_v<float>(v1, bb.y, act));
    }
  }
}

// Shared memory of a tile shape: the ring's ST stages of a WM x 128-byte
// A slice and a BN x 128-byte W slice, the two consumer warpgroups'
// output tiles, the activation table's serving part, the warpgroups'
// epilogue operands, the stages' barriers and the 1024-byte alignment of
// the swizzled stages and output tiles.
template <int WM, int BN, int ST>
constexpr size_t smem_bytes() {
  return (size_t)ST * (WM + BN) * kBK * 2 + (size_t)2 * WM * BN * 2 +
         kLutEntries * sizeof(uint16_t) + 2 * kEpBytes + 2 * ST * sizeof(uint64_t) + 1024;
}

constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kGemmThreads = kConsumers * 128 + 32;

// One product of a GEMM launch: A [M, K] and the stacked weight Wt [L, N,
// K] as tensor maps (boxes of 128 bytes of K by WM and BN rows), the
// bias, the W8A8 scales (as [M], ws [N]; int8 only) and C [M, N] (a bf16
// C also as a tensor map, boxes of 64 columns by WM rows); `end`
// is one past its last tile in the launch's walk (its tiles follow those
// of the product before it).
struct alignas(64) GemmOperand {
  CUtensorMap a, b, c;                 // c: C's map (bf16 outputs)
  const void* bias;
  const float* as;
  const float* ws;
  void* C;
  int M, N, end;
};

// A launch: one product, or two that share K and the layer (a layer's q
// and kv products, whose inputs the same row kernel writes), their tiles
// walked as one list so that the second fills the first's last round.
struct GemmLaunch {
  GemmOperand op[2];
  int count, K, layer, act;
};

// The product behind both GEMM kernels, on In = bf16 (f32 accumulators)
// or In = int8 (s32 accumulators, W8A8), as a ping-pong: a block's two
// consumer warpgroups take its tiles in turn (tile j of the block's walk
// to warpgroup j % 2), each a whole WM x BN tile (WM / 64 wgmma row
// blocks), so that one warpgroup's epilogue runs while the other's wgmma
// do.  The tiles' main loops run in walk order: tile j's starts once
// tile j - 1's has issued its last slice (named barriers 2 and 3).  That
// keeps the tensor cores on one tile at a time, and it is what lets the
// stages' parity waits stand: a warpgroup never waits on a stage more
// than one use ahead.  A K slice is 128 bytes of each row in both types:
// 64 bf16 or 128 int8 values, four 32-byte wgmma k steps (k16 bf16, k32
// s8), every output's sum over the slices in order.  A bf16 output
// leaves through the warpgroup's own output tile in shared memory: the
// bias and the roundings from the registers (stage_rows, its bias and
// scales copied under the main loop by load_ep), the activation in place
// (activate_tile), then TMA stores that one thread issues; the warpgroup
// goes on to its next tile at once, and waits for those stores to have
// read the tile only before it writes the tile again.  An f32 output is
// stored from the registers.
template <int WM, int BN, int ST, typename In, typename Out>
__device__ __forceinline__ void gemm_body(const GemmLaunch& g) {
  constexpr bool kInt8 = std::is_same<In, int8_t>::value;
  constexpr bool kBf16Out = std::is_same<Out, bf16>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int MW = WM / 64, kKE = kBK * 2 / (int)sizeof(In);
  constexpr uint32_t kStageA = WM * kBK * 2, kStageB = BN * kBK * 2;
  constexpr uint32_t kTile = WM * BN * 2;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages and output tiles start on a 1024-byte boundary
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* sa = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* sb = sa + ST * kStageA;
  unsigned char* ct = sb + ST * kStageB;                             // [2][kTile]
  uint16_t* lut = reinterpret_cast<uint16_t*>(ct + kConsumers * kTile);  // [kLutEntries]
  unsigned char* eps = reinterpret_cast<unsigned char*>(lut + kLutEntries);  // [2][kEpBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(eps + kConsumers * kEpBytes);
  uint64_t* empty = full + ST;
  const int tiles = g.op[g.count - 1].end, act = g.act;
  const int nk = (g.K + kKE - 1) / kKE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // tile t's product and its first row and column
  auto locate = [&g](int t, int& m0, int& n0) -> const GemmOperand& {
    const int i = g.count > 1 && t >= g.op[0].end;
    const GemmOperand& op = g.op[i];
    const int tl = t - (i ? g.op[0].end : 0), n_tiles = (op.N + BN - 1) / BN;
    m0 = (tl / n_tiles) * WM;
    n0 = (tl % n_tiles) * BN;
    return op;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);        // the slice's warpgroup releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // k-slice it (counted across this block's tiles) sits in stage it % ST,
  // the (it / ST)-th use of that stage
  if (warp == 4 * kConsumers) {         // producer warp: one lane issues
    if (lane == 0) {
      for (int i = 0; i < g.count; ++i) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&g.op[i].a))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&g.op[i].b))
                     : "memory");
        if (kBf16Out)
          asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&g.op[i].c))
                       : "memory");
      }
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        const GemmOperand& op = locate(t, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(&empty[s], ((it / ST) + 1) & 1);
          mbar_expect_tx(&full[s], kStageA + kStageB);
          tma_load_3d(sa + s * kStageA, &op.a, &full[s], kt * kKE, m0, 0);
          tma_load_3d(sb + s * kStageB, &op.b, &full[s], kt * kKE, n0, g.layer);
        }
      }
    }
    return;
  }

  // the activation table's serving part (bf16 outputs), copied while the
  // first slices load, in before either warpgroup's first epilogue
  const bool use_lut = kBf16Out && (act == ACT_GELU || act == ACT_SILU);
  const uint16_t* table = g_act_table[act == ACT_SILU ? 1 : 0];
  if (use_lut) {
    load_act_lut(lut, act, threadIdx.x, kConsumers * 128);
    bar_sync(1, kConsumers * 128);
  }

  const int wg = warp >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* cw = ct + wg * kTile;                             // this warpgroup's tile
  unsigned char* ep = eps + wg * kEpBytes;                         // and its operands
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  for (int j = wg; j < mine; j += kConsumers) {
    int m0, n0;
    const GemmOperand& op = locate(blockIdx.x + j * gridDim.x, m0, n0);
    const Out* bias = static_cast<const Out*>(op.bias);
    const int M = op.M, N = op.N;
    Acc d[MW][BN / 2];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[mi][i] = 0;
      fence_acc(d[mi]);
    }
    // the epilogue's operands load under the main loop
    if constexpr (kBf16Out) {
      if (act >= 0) {
        load_ep<WM, BN, kInt8>(ep, bias, op.as, op.ws, m0, n0, M, N, threadIdx.x & 127);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
    // tile j's main loop after tile j - 1's last slice was issued
    if (j > 0) bar_sync(2 + (j & 1), kConsumers * 128);
    int it = j * nk;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const unsigned char* a = sa + s * kStageA;
      const unsigned char* b = sb + s * kStageB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)                 // 32 bytes of K a step
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
          wgmma_tile<BN>(d[mi], sw128_desc(a + mi * 64 * 128 + kk * 32), sw128_desc(b + kk * 32));
      wgmma_commit();
      // the previous slice's group is done: its stage goes back
      wgmma_wait<1>();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) fence_acc(d[mi]);
      if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % ST]);
    }
    if (j + 1 < mine) bar_arrive(2 + ((j + 1) & 1), kConsumers * 128);
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) fence_acc(d[mi]);
    if (leader) mbar_arrive(&empty[(it - 1) % ST]);
    if (act < 0) continue;

    if constexpr (kBf16Out) {
      // the operands are in, and the stores of the tile before have read
      // the output tile
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(4 + wg, 128);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) stage_rows<WM, BN, Acc>(d[mi], cw, mi * 64, ep);
      if (act != ACT_NONE) {
        bar_sync(4 + wg, 128);
        activate_tile<WM, BN>(cw, act, lut, table);
      }
      // the tile's writes, seen by the async proxy, then one thread's stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(4 + wg, 128);
      if (leader) {
#pragma unroll
        for (int bx = 0; bx < BN / 64; ++bx)
          if (n0 + 64 * bx < N) tma_store_3d(&op.c, cw + bx * WM * 128, n0 + 64 * bx, m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        store_rows_f32<BN>(d[mi], mi * 64, bias, op.as, op.ws, static_cast<Out*>(op.C), m0,
                           n0, M, N, act);
    }
  }
  // the last stores are done before the block's shared memory goes
  if (kBf16Out && leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int WM, int BN, int ST>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_bf16_wgmma_kernel(const __grid_constant__ GemmLaunch g) {
  gemm_body<WM, BN, ST, bf16, bf16>(g);
}

// W8A8: C = epilogue((Aq . Wt^T) * as[m] * ws[n]), Aq [M, K] and Wt
// [L, N, K] int8 (layer `layer`), the sum exact in s32
template <int WM, int BN, int ST, typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_int8_wgmma_kernel(const __grid_constant__ GemmLaunch g) {
  gemm_body<WM, BN, ST, int8_t, T>(g);
}

}  // namespace gemm90

// f32 compute type, the tiled regime (more than f32small::kMaxRows rows,
// or N or K no multiple of 4: the 512-slot f32 step): a plain SIMT FMA
// GEMM, one 256-thread block per 64x64 output tile, each K-serial (no
// tensor-core path keeps full f32; not on the bf16 serving path)
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

// ------------------------------------------- f32 product, small M: split-K
// Replaces the f32 mode of asr_streaming_tpu/ops/pallas_emformer.py:642
// (fused_emformer_stack with compute_dtype float32; each product is
// jnp.dot(x, w, preferred_element_type=f32) + bias, then the activation,
// pallas_emformer.py:121-126) where a product has few rows: the offline
// API's batch of 1-3 slots, 20-72 rows against [512, 512], [512, 1024],
// [512, 2048] and [2048, 512] weights.
//
// What bounds it: the weights.  One B=1 step reads 20 x (4 x 512^2 + 2 x
// 512 x 2048) x 4 B = 251.7 MB of them (0.075 ms at 3.35 TB/s) for 2.6
// GFLOP (0.039 ms at 67 TFLOP/s of f32 FMA), so it is bound by bytes, by
// about 2x, and only when every SM streams weights at once.  The tiled
// kernel above ran one block per 64x64 tile, 8-32 blocks on 132 SMs, each
// walking all of K serially.
//
// What the design does about it: the product is cut into N tiles of 32
// columns times K splits of k_slice rows (gemm_f32_config in
// ops/emformer_stack.py picks the slice from N and K alone, for about
// 2 x 132 blocks: 256 at every offline product).  A block's 8 warps each
// take a kw = k_slice / 8 row part of the slice, and a lane one column:
// it loads its kw weights straight into registers (each warp load 128
// contiguous bytes of a W row), all at once, then the block's [M,
// k_slice] slice of the rows streams into shared memory as cp.async
// 16-byte copies.  Each weight is used from its register for every row,
// against the row's values read as broadcast float4s (one shared-memory
// read per 4 FMAs; four rows at a time, four independent FMA chains),
// each row's sum taken over the warp's kw rows of K in ascending k, one
// fmaf at a time; the warps' sums are added in warp order through shared
// memory.  The split-K reduction is deterministic and has no float
// atomics: every block writes its [M, 32] partial to the f32 workspace
// and counts itself in at its tile with an integer atomicAdd; the last
// to arrive sums the partials in split order
// 0, 1, ..., S-1 (at most 16, loaded together), applies the bias and the
// activation once, writes C and resets the tile's counter to 0 for the
// next launch.  The split and every summation order depend on (N, K)
// only, never on M, so a row's bits do not depend on how many rows share
// the launch (a B=1 step and a B=3 step give equal bits for equal slots).
// A block's weights are at most 16 KB and all in flight at once, so
// they skip shared memory: a ring of cp.async stages there (each warp 4
// rows of every stage, the rows' sums kept in shared memory between
// stages) made a B=1 step's 100 products about 5% slower
// (tools/gemm_f32_ring.py).  Measured on an H100 80GB HBM3 at 700 W
// (PERF.md): 6.5-8.8 us a product at B=1, about 1.1-1.2x torch.matmul's
// two-kernel f32 split-K; most of it is latency (the launch, one load
// round trip, the partials' fence, counter and reads), not bytes.
namespace f32small {

constexpr int kThreads = 256, kWarps = kThreads / 32, kTileN = 32;
constexpr int kMaxKW = 16;                      // k-rows of W a lane holds
constexpr int kMaxRows = 128;                   // rows of the small regime
constexpr int kMaxSplits = 16;                  // partials loaded at once

// the shared memory of a block: its rows' slice, then the warps' sums
__host__ __device__ constexpr size_t smem_floats(int rows, int k_slice) {
  return (size_t)rows * k_slice + (size_t)kWarps * rows * kTileN;
}

// 16 bytes global -> shared, zero-filled where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   gemm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// the last block of a tile: output float4 e of the tile ([M, 8])
// summed over the splits' partials in split order, then the epilogue
__device__ __forceinline__ void reduce_splits(const float* ws, const float* bias, float* C,
                                              int e, int n0, int M, int N, int splits,
                                              int act) {
  const int m = e / (kTileN / 4), n = n0 + 4 * (e % (kTileN / 4));
  if (n >= N) return;
  float4 p[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits)
      p[s] = __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)s * M + m) * N + n));
  float4 v = p[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s)
    if (s < splits) {
      v.x += p[s].x; v.y += p[s].y; v.z += p[s].z; v.w += p[s].w;
    }
  *reinterpret_cast<float4*>(C + (size_t)m * N + n) =
      make_float4(epilogue<float>(v.x, bias, n, act), epilogue<float>(v.y, bias, n + 1, act),
                  epilogue<float>(v.z, bias, n + 2, act), epilogue<float>(v.w, bias, n + 3, act));
}

// C [M, N] = act(A [M, K] . W [K, N] + bias); grid (N tiles of kTileN
// columns, K splits, at most kMaxSplits).  Needs M <= kMaxRows, N and K
// multiples of 4, k_slice a multiple of 4 kWarps up to kWarps kMaxKW
// (ops/emformer_stack.py checks them: gemm_f32_config); ws holds
// [splits, M, N] f32 and tiles one int per N tile, all 0 (only read when
// there are 2 splits or more).
__global__ void __launch_bounds__(kThreads)
gemm_f32_splitk_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       const float* __restrict__ bias, float* __restrict__ C,
                       float* __restrict__ ws, int* __restrict__ tiles, int M, int N,
                       int K, int k_slice, int act) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                            // [M][k_slice]
  float* sums = smem + M * k_slice;             // [kWarps][M][kTileN]
  __shared__ int last;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * kTileN, k0 = split * k_slice;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = k_slice / kWarps, kb = warp * kw, n = n0 + lane;

  // this lane's weights into registers (zero past K and N) ...
  float w[kMaxKW];
#pragma unroll
  for (int j = 0; j < kMaxKW; ++j) {
    const int k = k0 + kb + j;
    w[j] = j < kw && k < K && n < N ? __ldg(W + (size_t)k * N + n) : 0.f;
  }
  // ... while the rows' slice streams into shared memory (zero past K)
  for (int i = tid; i < M * (k_slice / 4); i += kThreads) {
    const int m = i / (k_slice / 4), k = 4 * (i % (k_slice / 4));
    const bool ok = k0 + k < K;
    cp_async16(a_s + m * k_slice + k, ok ? A + (size_t)m * K + k0 + k : A, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // each row's sum over this warp's kw rows of K, four rows at a time
  for (int m0 = 0; m0 < M; m0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j4 = 0; j4 < kMaxKW / 4; ++j4) {
      if (4 * j4 < kw) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (m0 + r < M) {
            const float4 a =
                *reinterpret_cast<const float4*>(a_s + (m0 + r) * k_slice + kb + 4 * j4);
            acc[r] = fmaf(a.x, w[4 * j4], acc[r]);
            acc[r] = fmaf(a.y, w[4 * j4 + 1], acc[r]);
            acc[r] = fmaf(a.z, w[4 * j4 + 2], acc[r]);
            acc[r] = fmaf(a.w, w[4 * j4 + 3], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (m0 + r < M) sums[(warp * M + m0 + r) * kTileN + lane] = acc[r];
  }
  __syncthreads();

  // the block's sum over its warps, in warp order; with one split the
  // result, else this split's partial
  for (int i = tid; i < M * kTileN; i += kThreads) {
    const int m = i / kTileN, c = i % kTileN, nn = n0 + c;
    float v = sums[m * kTileN + c];
    for (int j = 1; j < kWarps; ++j) v += sums[(j * M + m) * kTileN + c];
    if (nn >= N) continue;
    if (splits == 1)
      C[(size_t)m * N + nn] = epilogue<float>(v, bias, nn, act);
    else
      __stcg(ws + ((size_t)split * M + m) * N + nn, v);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tiles[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of the tile: the partials in split order 0, 1, ...
  for (int e = tid; e < M * kTileN / 4; e += kThreads)
    reduce_splits(ws, bias, C, e, n0, M, N, splits, act);
  if (tid == 0) tiles[tile] = 0;
}

}  // namespace f32small

// ------------------------------------------------------------------ W8A8
// _qdot (pallas_emformer.py:54-62): per-row dynamic activation quant, an
// int8 x int8 -> int32 product (exact), f32 dequant.  The weights are
// quantised once per params object by the wrapper
// (ops/emformer_stack.py::_quantize_weight, a true division by the scale
// as in the Pallas code) and stored transposed, Wt [N, K]: both operands
// K-major, as wgmma takes 8-bit ones.  The product runs on
// gemm_int8_wgmma_kernel (above).

// The rows the chain cannot quantise where it makes them (out's, from the
// attention, a row spread over its heads' blocks; ffn2's, from ffn1's
// GEMM epilogue, a row over its N tiles), and w8a8_linear's: x [rows, K]
// (f32 or the compute type) into int8 xq [rows, K] and scales xs [rows],
// as store_row_q8 computes them.  Bound by bytes (the row read once, the
// int8 row and its scale written once: 79 MB a layer at the VI serving
// shape, out's and ffn2's rows), so a warp takes a row and a block
// kQuantRows rows, and the row stays in registers between its amax and
// its quantisation: a lane holds NC chunks of kQuantChunk values (16-byte
// loads; its int8 chunk one 16-byte store), chunk c of the row in lane c
// % 32.  NC = 0 is the fallback for a row that does not split into such
// chunks (K % 16, an x or xq not 16-byte aligned, K past 32 * 16 * 4):
// scalar loads, the row read twice.
constexpr int kQuantRows = 8;
constexpr int kQuantChunk = 16;
constexpr int kQuantMaxChunks = 4;    // a lane's, so K <= 2048 in registers

// value e of a chunk of 16-byte vectors (bf16: two a 32-bit word, the
// lower first; f32: one)
template <typename Tin>
__device__ __forceinline__ float chunk_value(const uint4* c, int e) {
  const uint4 w = c[e / (16 / (int)sizeof(Tin))];
  const int i = e % (16 / (int)sizeof(Tin));
  if constexpr (std::is_same<Tin, float>::value) {
    return __uint_as_float(i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w);
  } else {
    const uint32_t u = (i >> 1) == 0 ? w.x : (i >> 1) == 1 ? w.y : (i >> 1) == 2 ? w.z : w.w;
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
}

template <typename Tin, int NC>
__global__ void __launch_bounds__(32 * kQuantRows)
quantize_rows_kernel(const Tin* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int rows, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Tin* xr = x + (size_t)row * K;
  int8_t* qr = xq + (size_t)row * K;
  float m = 0.f;
  if constexpr (NC == 0) {
    for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_f<Tin>(xr[k])));
  }
  constexpr int kLoads = kQuantChunk * (int)sizeof(Tin) / 16;
  const int chunks = K / kQuantChunk;
  uint4 raw[NC > 0 ? NC : 1][kLoads];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int k = lane + 32 * c;
    if (k >= chunks) continue;
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      raw[c][l] = reinterpret_cast<const uint4*>(xr + (size_t)k * kQuantChunk)[l];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c >= chunks) continue;
#pragma unroll
    for (int e = 0; e < kQuantChunk; ++e) m = fmaxf(m, fabsf(chunk_value<Tin>(raw[c], e)));
  }
  m = warp_max(m);
  const float s = __fmul_rn(fmaxf(m, (float)1e-8), (float)(1.0 / 127.0));
  const float r = __frcp_rn(s);
  if (lane == 0) xs[row] = s;
  if constexpr (NC == 0) {
    for (int k = lane; k < K; k += 32)
      qr[k] = (int8_t)__float2int_rn(__fmul_rn(to_f<Tin>(xr[k]), r));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int k = lane + 32 * c;
    if (k >= chunks) continue;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = __float2int_rn(__fmul_rn(chunk_value<Tin>(raw[c], 4 * j + e), r));
        w[j] |= (uint32_t)(q & 0xff) << (8 * e);
      }
    }
    reinterpret_cast<uint4*>(qr)[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Masked attention (A's attention launch, 20 a VI step) on the core shared
// with kernel D (emformer_attention_core.cuh), with the stack kernel's
// rounding points.  Replaces the attention of ops/pallas_emformer.py:162-185
// (_layer_math).  Keys/values are [mem, rc, left context, new utterance],
// read from the interleaved kv [B, M+R+U, 2, D] (the memory and right-
// context rows, and the utterance rows, each one TMA box of k and v
// together) and from lc_k/lc_v [B, Lc, D] (a box each; none where `reset`
// is set, whose rows read as zeros); validity from the reset-effective
// length: m_m = min(M, len // U) memory rows, m_kv = min(Lc, len) left-
// context rows (filled from the end); the summary query row never sees
// memory.  What bounds it on this card: bytes at 512 slots (q, the kv
// rows, the left context and the output once: 81 MB a VI launch, 24 us at
// 3.35 TB/s), latency at B = 1; in practice the warps' instruction
// latency.  The design: the core's persistent blocks of up to 16 warps,
// each group of warps a unit on a ring of TMA stages; on the tensor cores
// in bf16 a warp a 16-row tile of one head (VI: 4 heads x 2 tiles a unit,
// 2 units a block; EN: 4 x 1, 4 a block), its output tile one TMA store;
// in f32 the FMA path, whose rows spread over more blocks at small B (the
// offline API's B = 1).
template <typename T, int KN, int RW, int DH, bool kMma>
__global__ void __launch_bounds__(attn_core::kMaxWarps * 32, 1)
attention_kernel(const __grid_constant__ attn_core::Args a) {
  attn_core::run<T, KN, RW, DH, true, kMma>(a);
}

// the kernel of a plan: bf16 on the tensor cores by 16-key tiles, f32 on
// the FMA path by 32-key chunks and rows a warp (1 at small B, else up to
// 6); the serving head width (64) fixed at compile time
template <typename T, int DH>
auto attention_kernel_dh(const attn_core::Geo& g) {
  if constexpr (std::is_same<T, bf16>::value) {
    switch ((g.K + 15) / 16) {
      case 1: return attention_kernel<T, 1, 1, DH, true>;
      case 2: return attention_kernel<T, 2, 1, DH, true>;
      case 3: return attention_kernel<T, 3, 1, DH, true>;
      case 4: return attention_kernel<T, 4, 1, DH, true>;
      case 5: return attention_kernel<T, 5, 1, DH, true>;
      case 6: return attention_kernel<T, 6, 1, DH, true>;
      case 7: return attention_kernel<T, 7, 1, DH, true>;
    }
    return attention_kernel<T, 8, 1, DH, true>;
  } else {
    constexpr int R = attn_core::kMaxRowsPerWarp;
    const bool one = g.rpw == 1;
    switch (attn_core::key_chunks(g.K)) {
      case 1: return one ? attention_kernel<T, 1, 1, DH, false> : attention_kernel<T, 1, R, DH, false>;
      case 2: return one ? attention_kernel<T, 2, 1, DH, false> : attention_kernel<T, 2, R, DH, false>;
      case 3: return one ? attention_kernel<T, 3, 1, DH, false> : attention_kernel<T, 3, R, DH, false>;
    }
    return one ? attention_kernel<T, 4, 1, DH, false> : attention_kernel<T, 4, R, DH, false>;
  }
}

template <typename T>
auto attention_kernel_for(const attn_core::Geo& g) {
  return g.Dh == 64 ? attention_kernel_dh<T, 64>(g) : attention_kernel_dh<T, 0>(g);
}

// ------------------------------------------------- per-layer row kernels
// A layer's row work takes two launches.  After the out product,
// rows_residual_kernel: the FFN LN of residual = out + input, the next
// layer's memory row, and, in blocks of their own beside those rows, the
// left-context half of the state roll.  After ffn2, rows_boundary_kernel:
// the output LN of this layer (of out + input + h2: the residual is taken
// again with the same f32 add, not stored) and, on its f32 result still
// in registers, the input LN of the next layer with its summary row and
// the memory half of the next layer's roll; at the last layer
// rows_last_kernel (the output LN, also into y).  The first layer starts
// with rows_first_kernel (the chunk's input LN).  Each half of the roll
// runs where its inputs are ready and not yet overwritten: the memory
// rows need the layer's input memory row, which the layer's
// rows_residual_kernel overwrites with the next layer's, and the new
// left-context rows need the layer's kv scratch, which the next layer's
// kv product overwrites.  The roll writes new buffers (the attention
// reads the old ones).
//
// What bounds them: bytes, about 195 MB a layer at the VI serving shape
// (B=512), each tensor read or written once (chip_smoke.py::row_bytes);
// at B=1 the launches' latency.  An LN row is one warp, lane owning
// d = lane + 32 i (warp_layer_norm's order, so every kernel gives the
// same bits), with all of a lane's loads issued before the sums; the
// roll's copies move 16-byte vectors, several a thread, all loads before
// the stores.  A slot's input LN is one block (the summary row needs the
// slot's LN'd utterance rows, kept in shared memory: 32 KB at VI, so four
// blocks an SM and all 512 slots in one wave); with few slots a block
// takes more warps, so that a slot's rows run at once.  Measured on the
// card and not kept: the memory rows on spare warps of a few-slot block.
// In W8A8 mode the warp that holds a row quantises it (store_row_q8: its
// amax by warp_max, then the int8 row and its scale) into the product's
// int8 operand, in place of the compute-type row (and in place of the f32
// copy that a quantiser kernel would read back).

constexpr int kRowThreads = 256;      // 8 warps: a warp an LN row
constexpr int kSlotThreadsMax = 1024; // a slot's block, with few slots
constexpr int kFewSlots = 128;        // below the card's 132 SMs
constexpr int kRollUnits = 4;         // 16-byte vectors a roll thread moves

// What the row kernels read and write, for one launch: the state slices
// and LN vectors of the layer(s) it serves.  Unused pointers are null.
template <typename T>
struct RowArgs {
  int B, D, U, R, M, Lc, use_mem, tanh_on_mem;
  int init_memrow;   // rows_first: the memory row from the raw utterance
  int ln_blocks;     // rows_residual: blocks of LN rows (the roll's after)
  const uint8_t* reset;
  const uint8_t* advance;
  const float* ln_s;    // residual: the FFN LN; boundary, last: the output LN
  const float* ln_b;
  const float* in_s;    // first, boundary: the input LN (boundary: the next
  const float* in_b;    // layer's)
  const float* x;       // first: the chunk [B, T, D] in [utt; rc] order
  const T* out;         // the out product [B, Q, D]
  const T* h2;          // boundary, last: ffn2 [B, T, D]
  const T* kv;          // residual: the kv product [B, M+T, 2D]
  const T* mem_in;      // first, boundary: the layer's memory [B, M, D]
  const T* lck_in;      // residual: the layer's left context [B, Lc, D]
  const T* lcv_in;
  float* hin;           // [B, T, D] f32 rows [rc; utt] (boundary, last:
                        // read, then overwritten row by row)
  float* memrow;        // [B, D] f32 memory row
  T* q_in;              // [B, Q, D]
  T* kv_in;             // [B, M+T, D]
  T* ff_in;             // [B, T, D]
  // W8A8: the q, kv and ffn1 products' operands as int8 rows [rows, D]
  // and their scales [rows] (store_row_q8), written in place of q_in,
  // kv_in and ff_in; null where that product runs in the compute type
  int8_t* q8; float* q8_s;      // [B, Q, D]
  int8_t* kv8; float* kv8_s;    // [B, M+T, D]
  int8_t* ff8; float* ff8_s;    // [B, T, D]
  T* mem_out;           // rolled state: [B, M, D], [B, Lc, D]
  T* lck_out;
  T* lcv_out;
  float* y;             // last: [B, U, D]
};

// lane's share of a row: v[i] = row[lane + 32 i], 0 past D
template <int N, typename T>
__device__ __forceinline__ void load_row(float (&v)[N], const T* row, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? to_f<T>(row[d]) : 0.f;
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&v)[N], int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = lane + 32 * i;
    if (d < D) row[d] = from_f<T>(v[i]);
  }
}

// _qdot's activation quant (pallas_emformer.py:54-62) of a row held as
// load_row holds it, into int8 row and its scale: s = max(amax, 1e-8) *
// (1/127), then xq = rint(x * (1/s)), the reciprocal taken and then
// multiplied (a division would flip some values), rint half to even like
// jnp.round; the constants are the f32 roundings of the doubles JAX's
// weak types round.  quantize_rows_kernel computes the same.
template <int N>
__device__ __forceinline__ void store_row_q8(int8_t* row, float* scale, const float (&v)[N],
                                             int D) {
  const int lane = threadIdx.x & 31;
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (lane + 32 * i < D) m = fmaxf(m, fabsf(v[i]));
  m = warp_max(m);
  const float s = __fmul_rn(fmaxf(m, (float)1e-8), (float)(1.0 / 127.0));
  const float r = __frcp_rn(s);
  if (lane == 0) *scale = s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = lane + 32 * i;
    if (d < D) row[d] = (int8_t)__float2int_rn(__fmul_rn(v[i], r));
  }
}

// The input LN of row t ([rc; utt] order) of slot b, v its f32 values:
// into q_in (W8A8: q8 from the f32 values, as _qdot(x.astype(f32))
// reads them) and kv_in after the memory rows (W8A8: kv8 from the values
// rounded to the compute type, as kv_in holds them); an utterance row
// also into ln_utt [U, D] (shared memory) for the summary row.
template <int N, typename T>
__device__ __forceinline__ void input_ln_row(float (&v)[N], const RowArgs<T>& p,
                                             const float* scale, const float* bias, int b,
                                             int t, float* ln_utt) {
  const int D = p.D, Tr = p.R + p.U, Q = Tr + p.use_mem, NKV = p.M + Tr;
  const size_t qr = (size_t)b * Q + t, kvr = (size_t)b * NKV + p.M + t;
  warp_layer_norm(v, D, scale, bias);
  if (p.q8 != nullptr) store_row_q8(p.q8 + qr * D, p.q8_s + qr, v, D);
  else store_row(p.q_in + qr * D, v, D);
  if (p.use_mem && t >= p.R) store_row(ln_utt + (t - p.R) * D, v, D);
  if (p.kv8 == nullptr) {
    store_row(p.kv_in + kvr * D, v, D);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = rnd<T>(v[i]);
  store_row_q8(p.kv8 + kvr * D, p.kv8_s + kvr, v, D);
}

// The roll's copies move 16-byte vectors: check_rows_args holds D to a
// whole number of them, row_kernel the pointers to 16-byte alignment.
using Vec16 = uint4;

// The memory rows of slot b, in 16-byte vectors: kv_in's M memory rows
// (the layer's input memory, zero where reset; none with kv_in null) and
// the rolled state from the same values (advance: up one row; else as
// they are); each input value is read once.
template <typename T>
__device__ __forceinline__ void memory_rows(const T* mem, T* kv_in, T* mem_out, bool rs,
                                            bool adv, int M, int D) {
  const int per_row = D / (int)(sizeof(Vec16) / sizeof(T)), n = M * per_row;
  const Vec16* src = reinterpret_cast<const Vec16*>(mem);
  Vec16* kv = reinterpret_cast<Vec16*>(kv_in);
  Vec16* dst = reinterpret_cast<Vec16*>(mem_out);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Vec16 val = rs ? make_uint4(0, 0, 0, 0) : src[i];
    if (kv != nullptr) kv[i] = val;
    if (!adv) dst[i] = val;
    else if (i >= per_row) dst[i - per_row] = val;
  }
}

// The memory half of slot b's roll and kv's memory rows, first in a
// slot's block (they read no LN row), and where advance is set the last
// memory row from the layer's input memory row, unless the block computes
// that row itself (init_memrow: slot_summary writes it).  kv's memory rows
// go to kv_in with the roll's vectors, or in W8A8 to kv8, a warp a row.
template <int N, typename T>
__device__ __forceinline__ void slot_memory(const RowArgs<T>& p, int b) {
  if (!p.use_mem) return;
  const int D = p.D, M = p.M, NKV = M + p.R + p.U;
  const bool rs = p.reset[b] != 0, adv = p.advance[b] != 0;
  const T* mem = p.mem_in + (size_t)b * M * D;
  T* out = p.mem_out + (size_t)b * M * D;
  memory_rows(mem, p.kv8 != nullptr ? nullptr : p.kv_in + (size_t)b * NKV * D, out, rs, adv,
              M, D);
  if (p.kv8 != nullptr)
    for (int m = threadIdx.x >> 5; m < M; m += blockDim.x >> 5) {
      float v[N];
      load_row(v, mem + (size_t)m * D, rs ? 0 : D);
      const size_t r = (size_t)b * NKV + m;
      store_row_q8(p.kv8 + r * D, p.kv8_s + r, v, D);
    }
  if (adv && !p.init_memrow)
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      out[(size_t)(M - 1) * D + d] = from_f<T>(p.memrow[(size_t)b * D + d]);
}

// After a slot's input LN rows: the summary row (the mean of the LN'd
// utterance, summed in u order) into q_in (W8A8: its f32 values over
// ln_utt's row 0, each column by the thread that summed it, then into q8
// by warp 0); with init_memrow the memory row (the mean of the raw
// utterance, the first layer's), and where advance is set the rolled
// memory's last row from it.
template <int N, typename T>
__device__ __forceinline__ void slot_summary(const RowArgs<T>& p, int b, float* ln_utt) {
  if (!p.use_mem) return;
  const int D = p.D, U = p.U, Tr = p.R + U, Q = Tr + 1;
  const size_t qr = (size_t)b * Q + Tr;
  const bool adv = p.advance[b] != 0;
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int u = 0; u < U; ++u) s += ln_utt[u * D + d];
    if (p.q8 != nullptr) ln_utt[d] = s / (float)U;
    else p.q_in[qr * D + d] = from_f<T>(s / (float)U);
    if (p.init_memrow) {
      float r = 0.f;
      for (int u = 0; u < U; ++u) r += p.x[((size_t)b * Tr + u) * D + d];
      p.memrow[(size_t)b * D + d] = r / (float)U;
      if (adv) p.mem_out[((size_t)b * p.M + p.M - 1) * D + d] = from_f<T>(r / (float)U);
    }
  }
  if (p.q8 == nullptr) return;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v[N];
    load_row(v, ln_utt, D);
    store_row_q8(p.q8 + qr * D, p.q8_s + qr, v, D);
  }
}

// The first layer's input: the chunk x in its [utt; rc] order, copied to
// hin as [rc; utt], its input LN, the summary row, the memory row (with
// init_memrow) and the layer's memory rows.  One block per slot.
template <typename T, int N>
__global__ void __launch_bounds__(kSlotThreadsMax) rows_first_kernel(RowArgs<T> p) {
  extern __shared__ float ln_utt[];     // [U, D] with memory
  const int b = blockIdx.x, D = p.D, U = p.U, R = p.R, Tr = R + U;
  const int nw = blockDim.x >> 5;
  slot_memory<N>(p, b);
  for (int t = threadIdx.x >> 5; t < Tr; t += nw) {
    const int srow = t < R ? U + t : t - R;
    float v[N];
    load_row(v, p.x + ((size_t)b * Tr + srow) * D, D);
    store_row(p.hin + ((size_t)b * Tr + t) * D, v, D);
    input_ln_row(v, p, p.in_s, p.in_b, b, t, ln_utt);
  }
  slot_summary<N>(p, b, ln_utt);
}

// Between two layers: the output LN of layer l (residual + h2, the
// residual out + hin taken again with rows_residual's f32 add, so the
// residual never goes through memory) into hin, and on the same f32
// values the input LN of layer l+1, its summary row and its memory rows.
// One block per slot.
template <typename T, int N>
__global__ void __launch_bounds__(kSlotThreadsMax) rows_boundary_kernel(RowArgs<T> p) {
  extern __shared__ float ln_utt[];     // [U, D] with memory
  const int b = blockIdx.x, D = p.D, Tr = p.R + p.U, Q = Tr + p.use_mem;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  slot_memory<N>(p, b);
  for (int t = threadIdx.x >> 5; t < Tr; t += nw) {
    const size_t base = ((size_t)b * Tr + t) * D;
    const T* o = p.out + ((size_t)b * Q + t) * D;
    float v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < D ? (to_f<T>(o[d]) + p.hin[base + d]) + to_f<T>(p.h2[base + d]) : 0.f;
    }
    warp_layer_norm(v, D, p.ln_s, p.ln_b);
    store_row(p.hin + base, v, D);
    input_ln_row(v, p, p.in_s, p.in_b, b, t, ln_utt);
  }
  slot_summary<N>(p, b, ln_utt);
}

// The left-context half of the roll in 16-byte vectors, kRollUnits a
// thread from vector `first`, blockDim apart:
// output row j of slot b keeps the newest Lc rows of [lc; new utterance
// K/V] where advance is set (rows j >= keep from this layer's kv), else
// row j of the post-reset input.
template <typename T>
__device__ __forceinline__ void roll_left_context(const RowArgs<T>& p, long first) {
  using W = Vec16;
  constexpr int V = sizeof(W) / sizeof(T);
  const int D = p.D, Lc = p.Lc, per_row = D / V, keep = max(0, Lc - p.U);
  const int NKV = p.M + p.R + p.U;
  const long units = (long)p.B * 2 * Lc * per_row;
  W val[kRollUnits];
  W* dst[kRollUnits];
#pragma unroll
  for (int k = 0; k < kRollUnits; ++k) {
    const long u = first + (long)k * blockDim.x;
    dst[k] = nullptr;
    if (u >= units) continue;
    const int c = (int)(u % per_row);
    const long rest = u / per_row;
    int j = (int)(rest % (2 * Lc));
    const int b = (int)(rest / (2 * Lc));
    const bool is_v = j >= Lc;
    if (is_v) j -= Lc;
    const bool rs = p.reset[b] != 0, adv = p.advance[b] != 0;
    const T* src;
    if (adv && j >= keep) {
      const int nu = p.U - (Lc - keep) + (j - keep);
      src = p.kv + ((size_t)b * NKV + p.M + p.R + nu) * 2 * D + (is_v ? D : 0);
    } else {
      const int srow = adv ? Lc - keep + j : j;
      src = rs ? nullptr : (is_v ? p.lcv_in : p.lck_in) + ((size_t)b * Lc + srow) * D;
    }
    val[k] = src == nullptr ? make_uint4(0, 0, 0, 0) : reinterpret_cast<const W*>(src)[c];
    dst[k] = reinterpret_cast<W*>((is_v ? p.lcv_out : p.lck_out) + ((size_t)b * Lc + j) * D) + c;
  }
#pragma unroll
  for (int k = 0; k < kRollUnits; ++k)
    if (dst[k] != nullptr) *dst[k] = val[k];
}

// After the out product.  Blocks below ln_blocks, a warp a row: rows
// t < T give residual = out + input and its FFN LN (ff_in, or in W8A8
// the ffn1 product's int8 rows ff8 from the f32 values); row T (with memory) the next
// layer's memory row, tanh or +-10 clip.  The blocks after: the
// left-context half of this layer's roll.
template <typename T, int N>
__global__ void __launch_bounds__(kRowThreads, 4) rows_residual_kernel(RowArgs<T> p) {
  if ((int)blockIdx.x >= p.ln_blocks) {
    const long first =
        (long)(blockIdx.x - p.ln_blocks) * kRollUnits * blockDim.x + threadIdx.x;
    roll_left_context(p, first);
    return;
  }
  const int lane = threadIdx.x & 31, D = p.D;
  const int Tr = p.R + p.U, Q = Tr + p.use_mem;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= p.B * Q) return;
  const int b = row / Q, t = row % Q;
  const T* o = p.out + ((size_t)b * Q + t) * D;
  if (t == Tr) {
    for (int d = lane; d < D; d += 32) {
      float x = to_f<T>(o[d]);
      p.memrow[(size_t)b * D + d] = p.tanh_on_mem ? tanhf(x) : fminf(fmaxf(x, -10.f), 10.f);
    }
    return;
  }
  const size_t r = (size_t)b * Tr + t, base = r * D;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? to_f<T>(o[d]) + p.hin[base + d] : 0.f;
  }
  warp_layer_norm(v, D, p.ln_s, p.ln_b);
  if (p.ff8 != nullptr) store_row_q8(p.ff8 + base, p.ff8_s + r, v, D);
  else store_row(p.ff_in + base, v, D);
}

// The last layer's output LN of residual (out + hin, as rows_boundary
// takes it) + FFN into hin (rows [rc; utt]) and its utterance rows into
// y.  A warp a row.
template <typename T, int N>
__global__ void __launch_bounds__(kRowThreads, 4) rows_last_kernel(RowArgs<T> p) {
  const int lane = threadIdx.x & 31, D = p.D, R = p.R, U = p.U, Tr = R + U;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= p.B * Tr) return;
  const int b = row / Tr, t = row % Tr;
  const size_t base = (size_t)row * D;
  const T* o = p.out + ((size_t)b * (Tr + p.use_mem) + t) * D;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? (to_f<T>(o[d]) + p.hin[base + d]) + to_f<T>(p.h2[base + d]) : 0.f;
  }
  warp_layer_norm(v, D, p.ln_s, p.ln_b);
  store_row(p.hin + base, v, D);
  if (t >= R) store_row(p.y + ((size_t)b * U + (t - R)) * D, v, D);
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
  // stacked weights in the compute type: products [L, in, out] in f32,
  // [L, out, in] (K-major, the bf16 GEMM's operand) in bf16; biases
  // [L, out]; LN vectors f32
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
  float* memrow;// [B, D] f32
  // W8A8 scratch (only with quant != 0): each quantised product's int8
  // rows and their scales.  The row kernels write q's, kv's and ffn1's
  // (in place of q_in, kv_in and ff_in); quantize_rows writes out's and
  // ffn2's, one after the other, into aq.
  int8_t* aq;     // [max rows, max K]
  float* a_scale; // [max rows]
  int8_t* q8; float* q8_s;   // [B, Q, D], [B, Q]
  int8_t* kv8; float* kv8_s; // [B, M+T, D], [B, M+T]
  int8_t* ff8; float* ff8_s; // [B, T, D], [B, T]
  // f32 products (dtype 0): the k-slice of each of q, kv, out, ffn1,
  // ffn2 (ops/emformer_stack.py::gemm_f32_config; 0: the tiled kernel), the
  // split-K workspace of partial sums and one counter per N tile (zeroed
  // by the caller; the kernel leaves them 0)
  int32_t f32_kslice[5];
  float* f32_ws;
  int32_t* f32_tiles;
  void* stream;
};

namespace {

constexpr int kErrStructSize = -1;
using attn_core::kErrDriver;
using attn_core::kErrShape;
using attn_core::kErrTensorMap;
constexpr size_t kDefaultSmem = 48 * 1024;

enum QuantBits { kQWq = 1, kQWkv = 2, kQWout = 4, kQW1 = 8, kQW2 = 16 };

// the kernels whose launches the library counts on the host as each is
// queued (asr_launch_counts): a profile may drop kernel records, these do
// not.  The row kernels by RowKind, then the W8A8 quantiser, the two
// wgmma GEMMs and the attention.
enum RowKind { kRowsFirst = 0, kRowsResidual = 1, kRowsBoundary = 2, kRowsLast = 3 };
enum Counted {
  kCountQuantise = 4,
  kCountGemmInt8 = 5,
  kCountGemmBf16 = 6,
  kCountAttention = 7,
  kCounted = 8
};
std::atomic<long long> g_launches[kCounted];

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

// ------------------------------------------------------ bf16 GEMM, host

// The map of a bf16 (elem_bytes 2) or int8 (1) tensor [layers, rows,
// inner] (inner contiguous) read in boxes of 128 bytes x box_rows x 1,
// 128-byte swizzled, zero past the edges (attn_core::encode, whose cache
// holds a step's maps: the five activation operands and the five stacked
// weights, whose map covers all layers).
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t rows,
               uint64_t layers, uint32_t box_rows, uint32_t elem_bytes) {
  attn_core::MapKey k;
  memset(&k, 0, sizeof(k));
  k.ptr = ptr;
  k.rank = 3;
  k.elem = elem_bytes;
  k.line = gemm90::kBK * 2;
  k.l2 = 256;
  k.dims[0] = inner;
  k.dims[1] = rows;
  k.dims[2] = layers;
  k.strides[0] = inner * elem_bytes;
  k.strides[1] = inner * rows * elem_bytes;
  k.box[0] = k.line / elem_bytes;
  k.box[1] = box_rows;
  k.box[2] = 1;
  return attn_core::encode(out, k);
}

// The tile shapes: each consumer warpgroup's tile, WM rows by BN columns
// (128x128: 128 accumulators a thread, two wgmma row blocks; 64x128: 64),
// and the ring's stages, as many as fit beside the two output tiles, the
// activation table and the operands in shared memory: one block an SM.
// The bf16 and the int8 kernels of a shape take the same shared memory (a
// stage is 128 bytes of K a row in both).  (A 64x256 tile, the same 128
// accumulators, loads 25% more bytes a tile than 128x128 and was never
// the faster at a serving shape.)
constexpr int kGemmCfgs = 2;
constexpr int kCfgWM[kGemmCfgs] = {128, 64};
constexpr int kCfgBN[kGemmCfgs] = {128, 128};

struct GemmSetup {
  int status = 0, sms = 0;
};

template <int WM, int BN, int ST>
int gemm_setup_one() {
  const int smem = (int)gemm90::smem_bytes<WM, BN, ST>();
  int e = 0, blocks = 0;
  for (const void* k : {(const void*)gemm90::gemm_int8_wgmma_kernel<WM, BN, ST, bf16>,
                        (const void*)gemm90::gemm_int8_wgmma_kernel<WM, BN, ST, float>,
                        (const void*)gemm90::gemm_bf16_wgmma_kernel<WM, BN, ST>})
    if (e == 0) e = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == 0)
    blocks = attn_core::resident(gemm90::gemm_bf16_wgmma_kernel<WM, BN, ST>,
                                 gemm90::kGemmThreads, smem);
  return e == 0 && blocks < 1 ? kErrShape : e;
}

// the activation tables of this card (g_act_table), built once and
// waited for, on a stream of their own
int gemm_act_tables() {
  cudaStream_t st;
  int e = (int)cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  if (e != 0) return e;
  gemm90::act_table_kernel<<<2 * 65536 / 256, 256, 0, st>>>();
  e = (int)cudaGetLastError();
  if (e == 0) e = (int)cudaStreamSynchronize(st);
  cudaStreamDestroy(st);
  return e;
}

// the kernels' shared-memory limits, the activation tables and the SM
// count, once per device: a function's shared-memory limit is an
// attribute of the device that was current when it was set, and a
// __device__ table is one per card, so each card the process launches on
// is set up on its first launch there (the wrappers make the tensors'
// device current around every launch)
constexpr int kMaxDevices = 64;

const GemmSetup& gemm_setup() {
  static GemmSetup table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  int dev = 0;
  const int e = (int)cudaGetDevice(&dev);
  if (e != 0 || dev < 0 || dev >= kMaxDevices) {
    thread_local GemmSetup failed;
    failed.status = e != 0 ? e : kErrShape;
    return failed;
  }
  std::call_once(once[dev], [dev] {
    GemmSetup& s = table[dev];
    s.sms = attn_core::sm_count();
    s.status = s.sms > 0 ? 0 : kErrShape;
    if (s.status == 0) s.status = gemm_setup_one<128, 128, 4>();
    if (s.status == 0) s.status = gemm_setup_one<64, 128, 7>();
    if (s.status == 0) s.status = gemm_act_tables();
  });
  return table[dev];
}

long gemm_tiles(int i, int M, int N) {
  return (long)((M + kCfgWM[i] - 1) / kCfgWM[i]) * ((N + kCfgBN[i] - 1) / kCfgBN[i]);
}

// one product of a GEMM launch, as the host gives it (gemm90::GemmOperand
// holds its tensor maps): A [M, K] and Wt [L, N, K] (bf16, or int8 with
// the scales as [M] and ws [N]), the bias and C [M, N]
struct GemmProduct {
  const void* A;
  const void* Wt;
  const void* bias;
  const float* as;
  const float* ws;
  void* C;
  int M, N;
};

// The tile of a launch of `count` products (their tiles one list).  The
// main loop is bound by the bytes the SMs load from L2 (each stage's A and
// W slices: about 11 TB/s over the card), so the tile with the least such
// bytes on the busiest SM: rounds of tiles over the SMs (one block an SM,
// its two warpgroups' main loops in turn) times a tile's rows and columns
// (its bytes per K slice); on a tie the larger tile.  It depends on the
// shapes alone.
int gemm_config(const GemmSetup& s, const GemmProduct* p, int count) {
  int best = 0;
  long best_cost = -1;
  for (int i = 0; i < kGemmCfgs; ++i) {
    long tiles = 0;
    for (int k = 0; k < count; ++k) tiles += gemm_tiles(i, p[k].M, p[k].N);
    const long cost = (tiles + s.sms - 1) / s.sms * (kCfgWM[i] + kCfgBN[i]);
    if (best_cost < 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

// one launch of the GEMM on tile shape (WM, BN, ST) over `count` products
// of K-deep sums of In (bf16, or int8 with T the output type), layer
// `layer` of their stacked weights
template <int WM, int BN, int ST, typename In, typename T>
int launch_gemm(const GemmSetup& s, const GemmProduct* p, int count, int L, int layer, int K,
                int act, cudaStream_t st) {
  gemm90::GemmLaunch g{};
  g.count = count;
  g.K = K;
  g.layer = layer;
  g.act = act;
  int end = 0;
  for (int i = 0; i < count; ++i) {
    gemm90::GemmOperand& o = g.op[i];
    CHECK_RC(tensor_map(&o.a, p[i].A, K, p[i].M, 1, WM, sizeof(In)));
    CHECK_RC(tensor_map(&o.b, p[i].Wt, K, p[i].N, L, BN, sizeof(In)));
    if (std::is_same<T, bf16>::value) CHECK_RC(tensor_map(&o.c, p[i].C, p[i].N, p[i].M, 1, WM, 2));
    o.bias = p[i].bias;
    o.as = p[i].as;
    o.ws = p[i].ws;
    o.C = p[i].C;
    o.M = p[i].M;
    o.N = p[i].N;
    end += (int)(((p[i].M + WM - 1) / WM) * ((p[i].N + BN - 1) / BN));
    o.end = end;
  }
  const int grid = end < s.sms ? end : s.sms;
  constexpr size_t smem = gemm90::smem_bytes<WM, BN, ST>();
  constexpr bool kBf16 = std::is_same<In, bf16>::value;
  if constexpr (kBf16)
    gemm90::gemm_bf16_wgmma_kernel<WM, BN, ST><<<grid, gemm90::kGemmThreads, smem, st>>>(g);
  else
    gemm90::gemm_int8_wgmma_kernel<WM, BN, ST, T><<<grid, gemm90::kGemmThreads, smem, st>>>(g);
  const int rc = (int)cudaGetLastError();
  if (rc == 0) ++g_launches[kBf16 ? kCountGemmBf16 : kCountGemmInt8];
  return rc;
}

template <typename In, typename T>
int launch_gemm_cfg(const GemmSetup& s, int cfg, const GemmProduct* p, int count, int L,
                    int layer, int K, int act, cudaStream_t st) {
  if (cfg == 0) return launch_gemm<128, 128, 4, In, T>(s, p, count, L, layer, K, act, st);
  return launch_gemm<64, 128, 7, In, T>(s, p, count, L, layer, K, act, st);
}

// The bf16 products of one launch (one, or a layer's q and kv) on tile
// configuration cfg (-1: gemm_config's choice); act kActSkip runs the
// main loop alone (timing).
int gemm_bf16_cfg(int cfg, const GemmProduct* p, int count, int L, int layer, int K, int act,
                  cudaStream_t st) {
  if (K % 8 != 0 || K <= 0 || count < 1 || count > 2 || cfg < -1 || cfg >= kGemmCfgs ||
      act < gemm90::kActSkip || act > ACT_SILU)
    return kErrShape;
  for (int i = 0; i < count; ++i)
    if (p[i].N % 8 != 0 || p[i].M <= 0 || p[i].N <= 0) return kErrShape;
  const GemmSetup& s = gemm_setup();
  CHECK_RC(s.status);
  if (cfg < 0) cfg = gemm_config(s, p, count);
  return launch_gemm_cfg<bf16, bf16>(s, cfg, p, count, L, layer, K, act, st);
}

// how an f32 product runs: k_slice 0 takes the tiled kernel, else the
// split-K kernel with that k-slice, its workspace and tile counters
struct F32Split {
  int k_slice;
  float* ws;
  int* tiles;
};

// the f32 product y [M, N] = epilogue(x [M, K] . w [K, N]), as run_layer
// and asr_gemm_f32 run it.  The k-slice is gemm_f32_config's, whose
// checks the split-K kernel's limits are left to
int gemm_f32(const float* A, const float* W, const float* bias, float* C, int M, int N, int K,
             int act, const F32Split& sp, cudaStream_t st) {
  using namespace f32small;
  if (M <= 0 || N <= 0 || K <= 0 || sp.k_slice < 0) return kErrShape;
  if (sp.k_slice == 0) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(A, W, bias, C, M, N, K, act);
    return (int)cudaGetLastError();
  }
  const int splits = (K + sp.k_slice - 1) / sp.k_slice;
  if (splits > 1 && (sp.ws == nullptr || sp.tiles == nullptr)) return kErrShape;
  const size_t smem = smem_floats(M, sp.k_slice) * sizeof(float);
  // the largest any launch takes: a launch on another thread may set it too
  if (smem > kDefaultSmem)
    CHECK_RC(allow_smem(gemm_f32_splitk_kernel,
                        smem_floats(kMaxRows, kWarps * kMaxKW) * sizeof(float)));
  gemm_f32_splitk_kernel<<<dim3((N + kTileN - 1) / kTileN, splits), kThreads, smem, st>>>(
      A, W, bias, C, sp.ws, sp.tiles, M, N, K, sp.k_slice, act);
  return (int)cudaGetLastError();
}

// C = epilogue(A . W) with W given as Wt [L, N, K] in bf16 (layer `layer`)
// or as W [L, K, N] in f32 (sp: how the f32 product runs)
template <typename T>
int gemm(const T* A, const T* W, int L, int layer, const T* bias, T* C, int M, int N, int K,
         int act, const F32Split& sp, cudaStream_t st);

template <>
int gemm<bf16>(const bf16* A, const bf16* Wt, int L, int layer, const bf16* bias, bf16* C,
               int M, int N, int K, int act, const F32Split&, cudaStream_t st) {
  const GemmProduct p{A, Wt, bias, nullptr, nullptr, C, M, N};
  return gemm_bf16_cfg(-1, &p, 1, L, layer, K, act, st);
}

template <>
int gemm<float>(const float* A, const float* W, int L, int layer, const float* bias,
                float* C, int M, int N, int K, int act, const F32Split& sp, cudaStream_t st) {
  (void)L;
  return gemm_f32(A, W + (size_t)layer * K * N, bias, C, M, N, K, act, sp, st);
}

// the int8 GEMM's limits: K % 16 == 0 (16-byte TMA strides), N % 8 == 0
// (whole 16-byte output vectors), one or two products, every operand given
int int8_shape(int cfg, const GemmProduct* p, int count, int K, int act) {
  if (K % 16 != 0 || K <= 0 || count < 1 || count > 2 || cfg < -1 || cfg >= kGemmCfgs ||
      act < gemm90::kActSkip || act > ACT_SILU)
    return kErrShape;
  for (int i = 0; i < count; ++i)
    if (p[i].N % 8 != 0 || p[i].M <= 0 || p[i].N <= 0 || p[i].A == nullptr ||
        p[i].as == nullptr || p[i].Wt == nullptr || p[i].ws == nullptr)
      return kErrShape;
  return 0;
}

// The int8 wgmma GEMM with the dequant epilogue over `count` products of
// quantised rows (A int8 [M, K] and its scales as [M]) and Wt [L, N, K]
// (layer `layer`; ws is that layer's scales), on tile configuration cfg
// (-1: gemm_config's choice).
template <typename T>
int gemm_int8(int cfg, const GemmProduct* p, int count, int L, int layer, int K, int act,
              cudaStream_t st) {
  CHECK_RC(int8_shape(cfg, p, count, K, act));
  const GemmSetup& s = gemm_setup();
  CHECK_RC(s.status);
  if (cfg < 0) cfg = gemm_config(s, p, count);
  return launch_gemm_cfg<int8_t, T>(s, cfg, p, count, L, layer, K, act, st);
}

// the roll's 16-byte vectors (and quantize_rows') may be read and written
// at these addresses
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (((uintptr_t)q & 15) != 0) return false;
  return true;
}

// quantize_rows_kernel over x [M, K] (f32 or the compute type) into xq
// [M, K] and xs [M]: a lane's share of a row in registers where the row
// splits into whole 16-byte chunks that fit them, else the scalar fallback
template <typename Tin>
int quantize_rows(const Tin* x, int8_t* xq, float* xs, int M, int K, cudaStream_t st) {
  if (M <= 0 || K <= 0 || x == nullptr || xq == nullptr || xs == nullptr) return kErrShape;
  const int chunks = K / kQuantChunk, grid = (M + kQuantRows - 1) / kQuantRows;
  const int per_lane = (chunks + 31) / 32;
  const bool vec = K % kQuantChunk == 0 && per_lane <= kQuantMaxChunks && aligned16({x, xq});
  constexpr int threads = 32 * kQuantRows;
  if (!vec) quantize_rows_kernel<Tin, 0><<<grid, threads, 0, st>>>(x, xq, xs, M, K);
  else if (per_lane == 1) quantize_rows_kernel<Tin, 1><<<grid, threads, 0, st>>>(x, xq, xs, M, K);
  else if (per_lane == 2) quantize_rows_kernel<Tin, 2><<<grid, threads, 0, st>>>(x, xq, xs, M, K);
  else quantize_rows_kernel<Tin, 4><<<grid, threads, 0, st>>>(x, xq, xs, M, K);
  const int rc = (int)cudaGetLastError();
  if (rc == 0) ++g_launches[kCountQuantise];
  return rc;
}

// W8A8 product of rows A [M, K] (f32 or the compute type): quantize_rows
// into aq / as, then gemm_int8 on Wt [L, N, K] (layer `layer`, ws its
// scales).  The shapes are checked before anything is launched.
template <typename T, typename Tin>
int qgemm(int cfg, const Tin* A, int8_t* aq, float* as, const int8_t* wt, int L, int layer,
          const float* ws, const T* bias, T* C, int M, int N, int K, int act,
          cudaStream_t st) {
  const GemmProduct p{aq, wt, bias, as, ws, C, M, N};
  CHECK_RC(int8_shape(cfg, &p, 1, K, act));
  CHECK_RC(quantize_rows<Tin>(A, aq, as, M, K, st));
  return gemm_int8<T>(cfg, &p, 1, L, layer, K, act, st);
}

// ------------------------------------------------------ row kernels, host

// a lane's share N of a row of D (D <= 32 N)
int lanes_for(int D) {
  return D <= 64 ? 2 : D <= 128 ? 4 : D <= 256 ? 8 : D <= 512 ? 16 : kMaxPerLane;
}

template <typename T, int N>
int launch_rows_n(int kind, RowArgs<T> p, cudaStream_t st) {
  const int Tr = p.R + p.U, Q = Tr + p.use_mem, warps = kRowThreads / 32;
  if (kind == kRowsFirst || kind == kRowsBoundary) {
    const int slot_warps = p.B < kFewSlots ? kSlotThreadsMax / 32 : warps;
    const size_t smem = p.use_mem ? (size_t)p.U * p.D * sizeof(float) : 0;
    auto kernel = kind == kRowsFirst ? rows_first_kernel<T, N> : rows_boundary_kernel<T, N>;
    CHECK_RC(allow_smem(kernel, smem));
    kernel<<<p.B, 32 * (Tr < slot_warps ? Tr : slot_warps), smem, st>>>(p);
  } else if (kind == kRowsResidual) {
    p.ln_blocks = (p.B * Q + warps - 1) / warps;
    const long per_row = p.D / (long)(sizeof(Vec16) / sizeof(T));
    const long per_block = (long)kRowThreads * kRollUnits;
    const long roll = ((long)p.B * 2 * p.Lc * per_row + per_block - 1) / per_block;
    rows_residual_kernel<T, N><<<p.ln_blocks + (int)roll, kRowThreads, 0, st>>>(p);
  } else {
    rows_last_kernel<T, N><<<(p.B * Tr + warps - 1) / warps, kRowThreads, 0, st>>>(p);
  }
  const int rc = (int)cudaGetLastError();
  if (rc == 0) ++g_launches[kind];
  return rc;
}

// One row kernel of layer l: `kind`'s, with the input LN and memory rows
// of layer l_in (the first layer's, or the next one's at a boundary).
template <typename T>
int row_kernel(const EmformerStackArgs& a, int kind, int l, int l_in, int init_memrow,
         cudaStream_t st) {
  const size_t D = a.D, sMem = (size_t)l_in * a.B * a.M * D, sLc = (size_t)l * a.B * a.Lc * D;
  RowArgs<T> p{};
  p.B = a.B; p.D = a.D; p.U = a.U; p.R = a.R; p.M = a.M; p.Lc = a.Lc;
  p.use_mem = a.use_mem; p.tanh_on_mem = a.tanh_on_mem; p.init_memrow = init_memrow;
  p.reset = a.reset; p.advance = a.advance;
  const bool ffn = kind == kRowsResidual;
  p.ln_s = (ffn ? a.ffln_s : a.lnout_s) + l * D;
  p.ln_b = (ffn ? a.ffln_b : a.lnout_b) + l * D;
  p.in_s = a.lnin_s + l_in * D;
  p.in_b = a.lnin_b + l_in * D;
  p.x = a.x;
  p.out = (const T*)a.out; p.h2 = (const T*)a.h2; p.kv = (const T*)a.kv;
  p.mem_in = (const T*)a.mem_in + sMem; p.mem_out = (T*)a.mem_out + sMem;
  p.lck_in = (const T*)a.lck_in + sLc; p.lcv_in = (const T*)a.lcv_in + sLc;
  p.lck_out = (T*)a.lck_out + sLc; p.lcv_out = (T*)a.lcv_out + sLc;
  p.hin = a.hin; p.memrow = a.memrow;
  p.q_in = (T*)a.q_in; p.kv_in = (T*)a.kv_in; p.ff_in = (T*)a.ff_in; p.y = a.y;
  if (a.quant & kQWq) { p.q8 = a.q8; p.q8_s = a.q8_s; }
  if (a.quant & kQWkv) { p.kv8 = a.kv8; p.kv8_s = a.kv8_s; }
  if (a.quant & kQW1) { p.ff8 = a.ff8; p.ff8_s = a.ff8_s; }
  if (!(ffn ? aligned16({p.kv, p.lck_in, p.lcv_in, p.lck_out, p.lcv_out})
            : aligned16({p.mem_in, p.kv_in, p.mem_out})))
    return kErrShape;
  switch (lanes_for(a.D)) {
    case 2: return launch_rows_n<T, 2>(kind, p, st);
    case 4: return launch_rows_n<T, 4>(kind, p, st);
    case 8: return launch_rows_n<T, 8>(kind, p, st);
    case 16: return launch_rows_n<T, 16>(kind, p, st);
  }
  return launch_rows_n<T, kMaxPerLane>(kind, p, st);
}

// The arguments of A's attention launch: its plan (tensor cores in bf16,
// check_args holds the head width to them; FMA in f32) and the TMA maps of
// q, the kv rows, this layer's left context and the output
template <typename T>
int attention_args(attn_core::Args* x, const EmformerStackArgs& a, const T* q, const T* kv,
                   const T* lck, const T* lcv, T* attn) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int elem = (int)sizeof(T);
  attn_core::Geo& g = x->g;
  if (!attn_core::stack_geo(g, kMma, elem, a.B, a.H, a.D, a.U, a.R, a.M, a.Lc, a.use_mem))
    return kErrShape;
  const int Q = g.Q, D = a.D, MR = a.M + a.R, NKV = MR + a.U, hpu = g.hpu;
  CHECK_RC(attn_core::rows_maps(x->q_map, g, q, elem, Q, D, (long)Q * D, g.qb, hpu));
  if (MR > 0)
    CHECK_RC(attn_core::rows_maps(x->k_map[0], g, kv, elem, NKV, 2 * D, (long)NKV * 2 * D, MR,
                                  hpu, D));
  if (a.Lc > 0) {
    CHECK_RC(attn_core::rows_maps(x->k_map[1], g, lck, elem, a.Lc, D, (long)a.Lc * D, a.Lc,
                                  hpu));
    CHECK_RC(attn_core::rows_maps(x->v_map, g, lcv, elem, a.Lc, D, (long)a.Lc * D, a.Lc, hpu));
  }
  CHECK_RC(attn_core::rows_maps(x->k_map[2], g, kv, elem, NKV, 2 * D, (long)NKV * 2 * D, a.U,
                                hpu, D));
  if (kMma) CHECK_RC(attn_core::rows_maps(x->out_map, g, attn, elem, Q, D, (long)Q * D, 16, 1));
  x->out = attn;
  x->out_bf16 = 0;
  x->length = a.length;
  x->reset = a.reset;
  x->m_m = x->m_kv = nullptr;
  // q * (1/sqrt(Dh)) is taken in the compute type, as in the Pallas kernel
  const float scaling = (float)(1.0 / sqrt((double)g.Dh));
  x->scaling = kMma ? __bfloat162float(__float2bfloat16_rn(scaling)) : scaling;
  x->neg_inf = a.neg_inf;
  return 0;
}

template <typename T>
int attention(const EmformerStackArgs& a, const T* q, const T* kv, const T* lck,
              const T* lcv, T* attn, cudaStream_t st) {
  attn_core::Args x;
  CHECK_RC(attention_args<T>(&x, a, q, kv, lck, lcv, attn));
  const int rc = attn_core::launch(attention_kernel_for<T>(x.g), x, st);
  if (rc == 0) ++g_launches[kCountAttention];
  return rc;
}

// One layer of the step: the chain of nine kernels (W8A8: the same nine,
// less ffn1's quantiser or q's and kv's, plus out's and ffn2's),
// from the layer's input rows (q_in, kv_in, hin and its memory rows, left
// by rows_first or the previous layer's boundary): the q and kv products,
// the attention, the out product, rows_residual, ffn1, ffn2, then the
// boundary into layer l + 1, or at the last layer rows_last (y).  Layer l
// of the stacked weights and state.  The output rows [rc; utt] are left
// in hin and the next layer's memory row in memrow.
template <typename T>
int run_layer(const EmformerStackArgs& a, int l, bool last) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = a.B, D = a.D, F = a.F, U = a.U, R = a.R, M = a.M, Lc = a.Lc;
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
  // product p's f32 split (q, kv, out, ffn1, ffn2; ignored in bf16)
  auto sp = [&a](int p) { return F32Split{a.f32_kslice[p], a.f32_ws, a.f32_tiles}; };

  const size_t sLc = (size_t)l * B * Lc * D;
  const T* lck_in = (const T*)a.lck_in + sLc;
  const T* lcv_in = (const T*)a.lcv_in + sLc;

  if (qz & kQWq) {
    // W8A8 (q and kv together: check_args): both from the int8 rows the
    // row kernel wrote, in one launch
    const GemmProduct qkv[2] = {
        {a.q8, a.wq8, bq + (size_t)l * D, a.q8_s, a.wq_s + (size_t)l * D, q, B * Q, D},
        {a.kv8, a.wkv8, bkv + (size_t)l * 2 * D, a.kv8_s, a.wkv_s + (size_t)l * 2 * D, kv,
         B * NKV, 2 * D}};
    CHECK_RC(gemm_int8<T>(-1, qkv, 2, a.L, l, D, ACT_NONE, st));
  } else if (std::is_same<T, bf16>::value) {
    // the bf16 q and kv products in one launch
    const GemmProduct qkv[2] = {
        {q_in, wq, bq + (size_t)l * D, nullptr, nullptr, q, B * Q, D},
        {kv_in, wkv, bkv + (size_t)l * 2 * D, nullptr, nullptr, kv, B * NKV, 2 * D}};
    CHECK_RC(gemm_bf16_cfg(-1, qkv, 2, a.L, l, D, ACT_NONE, st));
  } else {
    CHECK_RC(gemm<T>(q_in, wq, a.L, l, bq + (size_t)l * D, q, B * Q, D, D, ACT_NONE, sp(0),
                     st));
    CHECK_RC(gemm<T>(kv_in, wkv, a.L, l, bkv + (size_t)l * 2 * D, kv, B * NKV, 2 * D, D,
                     ACT_NONE, sp(1), st));
  }
  CHECK_RC(attention<T>(a, q, kv, lck_in, lcv_in, attn, st));
  if (qz & kQWout)
    CHECK_RC((qgemm<T, T>(-1, attn, a.aq, a.a_scale, a.wout8, a.L, l,
                         a.wout_s + (size_t)l * D, bout + (size_t)l * D, out, B * Q, D, D,
                         ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(attn, wout, a.L, l, bout + (size_t)l * D, out, B * Q, D, D, ACT_NONE,
                     sp(2), st));
  // with the left-context roll, which reads this layer's kv
  CHECK_RC(row_kernel<T>(a, kRowsResidual, l, l, 0, st));
  if (qz & kQW1) {
    const GemmProduct p1{a.ff8, a.w18, b1 + (size_t)l * F, a.ff8_s, a.w1_s + (size_t)l * F,
                         h1, B * Tr, F};
    CHECK_RC(gemm_int8<T>(-1, &p1, 1, a.L, l, D, a.activation, st));
  } else
    CHECK_RC(gemm<T>(ff_in, w1, a.L, l, b1 + (size_t)l * F, h1, B * Tr, F, D, a.activation,
                     sp(3), st));
  if (qz & kQW2)
    CHECK_RC((qgemm<T, T>(-1, h1, a.aq, a.a_scale, a.w28, a.L, l, a.w2_s + (size_t)l * D,
                         b2 + (size_t)l * D, h2, B * Tr, D, F, ACT_NONE, st)));
  else
    CHECK_RC(gemm<T>(h1, w2, a.L, l, b2 + (size_t)l * D, h2, B * Tr, D, F, ACT_NONE, sp(4),
                     st));
  return last ? row_kernel<T>(a, kRowsLast, l, l, 0, st)
              : row_kernel<T>(a, kRowsBoundary, l, l + 1, 0, st);
}

// all layers: the first reads the chunk x, the last writes y
template <typename T>
int run_stack(const EmformerStackArgs& a) {
  CHECK_RC(row_kernel<T>(a, kRowsFirst, 0, 0, 1, (cudaStream_t)a.stream));
  for (int l = 0; l < a.L; ++l) CHECK_RC(run_layer<T>(a, l, l == a.L - 1));
  return 0;
}

template <typename T>
int run_one_layer(const EmformerStackArgs& a) {
  CHECK_RC(row_kernel<T>(a, kRowsFirst, 0, 0, a.init_memrow, (cudaStream_t)a.stream));
  return run_layer<T>(a, 0, true);
}

// what every entry of the chain needs: memory exactly when M > 0, D a
// whole number of the roll's 16-byte vectors (8 bf16 or 4 f32), and the
// int8 rows and scales of each product the row kernels quantise
int check_rows_args(const EmformerStackArgs* a) {
  if (a == nullptr || a->struct_size != (int64_t)sizeof(EmformerStackArgs))
    return kErrStructSize;
  if (a->D <= 0 || a->D > 32 * kMaxPerLane || a->B <= 0 || a->L <= 0 || a->U <= 0 ||
      a->R < 0 || a->M < 0 || a->Lc < 0 || (a->use_mem != 0) != (a->M > 0) ||
      (a->dtype != 0 && a->dtype != 1) || a->D % (a->dtype == 1 ? 8 : 4) != 0 ||
      ((a->quant & kQWq) && (a->q8 == nullptr || a->q8_s == nullptr)) ||
      ((a->quant & kQWkv) && (a->kv8 == nullptr || a->kv8_s == nullptr)) ||
      ((a->quant & kQW1) && (a->ff8 == nullptr || a->ff8_s == nullptr)))
    return kErrShape;
  return 0;
}

// the chain's: q and kv quantised together (one int8 launch), and the
// quantiser's buffer where out or ffn2 is quantised
int check_args(const EmformerStackArgs* a) {
  CHECK_RC(check_rows_args(a));
  if (a->H <= 0 || a->D % a->H != 0 || a->y == nullptr ||
      (a->quant != 0 && (a->D % 16 != 0 || a->F % 16 != 0)) ||
      !(a->quant & kQWq) != !(a->quant & kQWkv) ||
      ((a->quant & (kQWout | kQW2)) && (a->aq == nullptr || a->a_scale == nullptr)))
    return kErrShape;
  const int Q = a->R + a->U + a->use_mem, K = a->M + a->R + a->Lc + a->U, Dh = a->D / a->H;
  if (!(a->dtype == 1 ? attn_core::supports<bf16>(Q, K, Dh) && attn_core::supports_mma(Q, K, Dh)
                      : attn_core::supports<float>(Q, K, Dh)))
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

// One row kernel of the chain alone, as run_layer launches it, for tests
// and timing, on one layer's (L = 1) LN vectors and state: kind 0 the
// first layer's input (x; with init_memrow the memory row from x, else
// memrow as given), 1 rows_residual (with the left-context roll), 2 the
// boundary (the output LN with lnout_s/lnout_b, then the input LN with
// lnin_s/lnin_b and the memory rows of mem_in), 3 rows_last (into y).
extern "C" int asr_emformer_rows(const EmformerStackArgs* a, int kind) {
  CHECK_RC(check_rows_args(a));
  if (a->L != 1 || kind < kRowsFirst || kind > kRowsLast) return kErrShape;
  cudaStream_t st = (cudaStream_t)a->stream;
  const int init_memrow = kind == kRowsFirst ? a->init_memrow : 0;
  return a->dtype == 1 ? row_kernel<bf16>(*a, kind, 0, 0, init_memrow, st)
                       : row_kernel<float>(*a, kind, 0, 0, init_memrow, st);
}

// What A's attention launch uses at a geometry (dtype 1 bf16, 0 f32):
// out[0..14] as attn_core::report gives them (its plan, registers a
// thread, blocks resident an SM); needs the card.
extern "C" int asr_stack_attention_plan(int B, int H, int D, int U, int R, int M, int Lc,
                                        int use_mem, int dtype, int* out) {
  attn_core::Geo g;
  const bool mma = dtype == 1;
  if (B <= 0 || H <= 0 || D % H != 0 ||
      !attn_core::stack_geo(g, mma, mma ? 2 : 4, B, H, D, U, R, M, Lc, use_mem))
    return kErrShape;
  return mma ? attn_core::report(attention_kernel_for<bf16>(g), g, out)
             : attn_core::report(attention_kernel_for<float>(g), g, out);
}

// The counted kernels' launches since the library was loaded, as queued
// without a launch error: out[0..3] the row kernels (kRowsFirst ..
// kRowsLast), out[4] quantize_rows, out[5] and out[6] the int8 and the
// bf16 wgmma GEMM, out[7] the attention.  Returns how many it wrote
// (kCounted).
extern "C" int asr_launch_counts(long long* out) {
  for (int k = 0; k < kCounted; ++k) out[k] = g_launches[k].load();
  return kCounted;
}

// The W8A8 row quantiser alone, as run_layer runs it on out's and ffn2's
// rows, for tests and timing: x [M, K] (x_is_f32: f32, else bf16) into
// xq [M, K] int8 and xs [M] f32.
extern "C" int asr_quantize_rows(int x_is_f32, const void* x, int8_t* xq, float* xs, int M,
                                 int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return x_is_f32 ? quantize_rows<float>((const float*)x, xq, xs, M, K, st)
                  : quantize_rows<bf16>((const bf16*)x, xq, xs, M, K, st);
}

// The W8A8 product alone (quantize_rows on x, int8 GEMM, dequant + bias
// + activation), as run_layer runs out's and ffn2's, for tests and timing.
// x_is_f32: x is f32 (else the compute type); dtype as in
// EmformerStackArgs; wt [N, K] int8; cfg the tile configuration as in
// asr_gemm_bf16 (-1: the one run_layer picks); act as there.
extern "C" int asr_w8a8_linear(int dtype, int x_is_f32, const void* x, int8_t* aq,
                               float* as, const int8_t* wt, const float* ws,
                               const void* bias, void* y, int M, int N, int K, int act,
                               int cfg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return x_is_f32 ? qgemm<bf16, float>(cfg, (const float*)x, aq, as, wt, 1, 0, ws,
                                         (const bf16*)bias, (bf16*)y, M, N, K, act, st)
                    : qgemm<bf16, bf16>(cfg, (const bf16*)x, aq, as, wt, 1, 0, ws,
                                        (const bf16*)bias, (bf16*)y, M, N, K, act, st);
  if (dtype == 0)
    return qgemm<float, float>(cfg, (const float*)x, aq, as, wt, 1, 0, ws, (const float*)bias,
                               (float*)y, M, N, K, act, st);
  return kErrShape;
}

// The bf16 product alone, y [M, N] = epilogue(x [M, K] . wt [N, K]^T)
// with bias [N] and the activation, as run_layer runs each product, for
// tests and timing; cfg is the tile configuration (0, 1: a warpgroup's
// 128x128 or 64x128 tile), -1 the one run_layer picks for the shape; act
// kActSkip (-1) runs the main loop alone and writes nothing.
extern "C" int asr_gemm_bf16(const void* x, const void* wt, const void* bias, void* y,
                             int M, int N, int K, int act, int cfg, void* stream) {
  const GemmProduct p{x, wt, bias, nullptr, nullptr, y, M, N};
  return gemm_bf16_cfg(cfg, &p, 1, 1, 0, K, act, (cudaStream_t)stream);
}

// Two bf16 products with the same K in one launch, as run_layer runs a
// layer's q and kv products: y0 = x0 . wt0^T + bias0 and y1 = x1 . wt1^T +
// bias1 (no activation), their tiles one list; cfg as in asr_gemm_bf16
// (-1: the one run_layer picks for the pair).
extern "C" int asr_gemm_bf16_pair(const void* x0, const void* wt0, const void* bias0, void* y0,
                                  int M0, int N0, const void* x1, const void* wt1,
                                  const void* bias1, void* y1, int M1, int N1, int K, int cfg,
                                  void* stream) {
  const GemmProduct p[2] = {{x0, wt0, bias0, nullptr, nullptr, y0, M0, N0},
                            {x1, wt1, bias1, nullptr, nullptr, y1, M1, N1}};
  return gemm_bf16_cfg(cfg, p, 2, 1, 0, K, ACT_NONE, (cudaStream_t)stream);
}

// The f32 product alone, y [M, N] = epilogue(x [M, K] . w [K, N]) with
// bias [N] and the activation, as run_layer runs each f32 product, for
// tests and timing: k_slice 0 runs the tiled kernel, else the split-K one
// (ws [splits, M, N] f32 and tiles [N / 32] int32, zeroed; see
// ops/emformer_stack.py::gemm_f32_config).
extern "C" int asr_gemm_f32(const float* x, const float* w, const float* bias, float* y,
                            float* ws, int32_t* tiles, int M, int N, int K, int act,
                            int k_slice, void* stream) {
  return gemm_f32(x, w, bias, y, M, N, K, act, F32Split{k_slice, ws, tiles},
                  (cudaStream_t)stream);
}

// The tile configuration run_layer picks for an [M, N] product (bf16 or
// int8: the choice reads the shapes alone), or with M1 > 0 for it and an
// [M1, N1] product in one launch; a negative error code if the kernels
// cannot be set up.
extern "C" int asr_gemm_config(int M, int N, int M1, int N1) {
  const GemmSetup& s = gemm_setup();
  const GemmProduct p[2] = {{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M, N},
                            {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M1, N1}};
  return s.status > 0 ? -s.status : s.status < 0 ? s.status : gemm_config(s, p, M1 > 0 ? 2 : 1);
}

// This card's activation table (GELU for act 2, SiLU for 3: round(act(v))
// for each of the 65,536 bf16 bit patterns v) into out (65,536 uint16 on
// the card), for tests.
extern "C" int asr_gemm_act_table(int act, void* out, void* stream) {
  if (act != ACT_GELU && act != ACT_SILU) return kErrShape;
  const GemmSetup& s = gemm_setup();
  CHECK_RC(s.status);
  return (int)cudaMemcpyFromSymbolAsync(out, gemm90::g_act_table, 65536 * sizeof(uint16_t),
                                        (act == ACT_GELU ? 0 : 65536) * sizeof(uint16_t),
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}

extern "C" const char* asr_cuda_error_string(int code) {
  if (code == kErrStructSize) return "argument struct size mismatch";
  if (code == kErrShape) return "unsupported shape or dtype";
  if (code == kErrDriver) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled rejected the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
