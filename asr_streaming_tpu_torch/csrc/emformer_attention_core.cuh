// The masked Emformer attention core, shared by kernel D
// (csrc/emformer_attention.cu, emformer_attention_kernel) and kernel A's
// attention (csrc/emformer_stack.cu, attention_kernel), with the small
// helpers both sources use.
//
// Replaces the per-(slot, head) body of asr_streaming_tpu/ops/
// pallas_attention.py:31-80 (_attention_kernel) and of the attention part
// of pallas_emformer.py:162-185 (_layer_math): logits = (q * scaling) .
// k^T in f32, the key validity from the fill counts (the first M - m_m
// memory columns and the first Lc - m_kv left-context columns are invalid;
// with memory, the summary row, the last, sees no memory column), an f32
// softmax, and probs . v in f32.  kRound adds the stack kernel's rounding
// points: q * scaling and the probabilities are rounded to the compute
// type T.
//
// What bounds it on this card: bytes.  At the Vietnamese serving shape
// (B = 512, Q = 21, K = 56, D = 512, H = 8) one bf16 launch of A moves
// 81 MB (q, the kv rows, the left context and the output, each once:
// 24 us at 3.35 TB/s) against 1.2 GFLOP of bf16 products, 15 FLOP a
// byte, far below the 295 at which the tensor cores become the limit.  At
// B = 1 (the offline API, f32) one launch moves 0.3 MB: its latency
// bounds it.  In practice the warps' instruction latency holds it: a
// warp's logits, softmax and value product are short dependent chains,
// so the SM needs many warps in flight, and registers (up to 128 a
// thread) and shared memory (a unit's rows) cap them.
//
// What the design does about it:
// - A work item is one warp's query rows of one head: a 16-row m-tile on
//   the tensor cores (A in bf16), a group of rows in the FMA path (A in
//   f32, D).  A unit is a slot's group of heads (and, at small B, a share
//   of their query rows), taken by one group of warps, all of which hold
//   rows: at VI 4 heads x 2 tiles, at EN 4 heads x 1 tile, in f32 one
//   head x 4 warps of up to 6 rows.  A block is up to 16 warps: 2 groups
//   at VI, 4 at EN and in f32.  The plan (make_plan, mirrored in
//   ops/emformer_attention.py::attention_plan) is computed on the host.
// - The grid is persistent: as many blocks as fit on the SMs walk the
//   units.  Each block runs a ring of groups + 1 shared-memory stages:
//   one thread issues a unit's copies as TMA tensor-map boxes completing
//   on the stage's mbarrier (q, and a box a key segment: A's memory +
//   right context and its utterance rows from the interleaved kv scratch,
//   k and v in one box, and its left context from the state; D's k and
//   v), so that a unit's rows are in flight while the groups compute
//   theirs.  The boxes land 16-byte-swizzled in lines of up to 128 bytes
//   (a head row is `planes` lines, each plane a region of the stage), so
//   a warp's ldmatrix or 16-byte loads of eight consecutive rows hit 32
//   different banks; a row's address is one XOR and one add from its line,
//   taken once a unit (reading the plan from parameter space on every
//   access cost more than the arithmetic).  Rows past K (the value
//   product's padding) and the left-context rows of a slot being reset
//   are read from a zero line: no copy is issued for them.
// - On the tensor cores a warp stages its output tile over its own q rows
//   and writes it with one TMA store a plane, released at its next unit;
//   the FMA path stores 16-byte vectors from registers.
// - At small B (fewer slots x heads than SMs) the FMA path gives each
//   warp one query row and a unit a share of a head's rows, so the
//   offline step's attention runs on 24 blocks, not 8.
// - Every output keeps its order of sums, so A's and D's bits are those
//   of the design they replace:
//   - FMA (attend_fma): f32 products from registers.  A lane owns keys
//     lane + 32j and takes their logits against all of its warp's rows,
//     each summed over d in order; the softmax runs in those registers
//     with warp shuffles (max and sum over the same lanes in the same
//     order); the value product gives each lane 16 bytes of output
//     columns of a few rows, summed over the keys in order.  Every sum
//     runs in the same order whatever T is, so bf16 inputs give bit for
//     bit what the same values widened to f32 give.  Kernel D (f32
//     contract) and A in f32 take it.
//   - Tensor cores (attend_mma): A in bf16, whose rounding points make
//     both products exact bf16 x bf16 terms summed in f32, runs them as
//     mma.sync m16n8k16 (k-steps of 16 over Dh in order, key tiles in
//     order) with the softmax on the accumulator registers.  wgmma's 64-row
//     tiles would waste most of a tile at Q = 21 or 5, and heads cannot
//     share rows (each slot's keys differ).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <string.h>

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// elements of T in 16 bytes
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes of shared memory (a shared-window address) widened to f32
__device__ __forceinline__ void lds16(uint32_t a, float (&v)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(a));
}

__device__ __forceinline__ void lds16(uint32_t a, float (&v)[8]) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(a));
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_tag(uint32_t tag, int u) {
  asm volatile("st.volatile.shared.u32 [%0], %1;\n" ::"r"(tag), "r"(u) : "memory");
}

// wait until a stage's tag says unit u was issued into it
__device__ __forceinline__ void wait_tag(uint32_t tag, int u) {
  int v;
  do {
    asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(tag) : "memory");
  } while (v != u);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------- the launch plan

constexpr int kMaxWarps = 16;                       // a block: its groups' warps
constexpr int kMaxGroupWarps = 8;                   // a group: one unit's warps
constexpr int kMaxQueries = 32;
constexpr int kMaxRowsPerWarp = 6;                  // FMA path, at large B
constexpr int kMaxKeyChunks = 4;                    // K <= 128 (keys per lane)
constexpr int kMaxSmem = 232448;                    // a block's dynamic shared memory
constexpr int kZeroBytes = 128;                     // a zero line
constexpr int kMaxSegs = 3;
constexpr int kMaxPlanes = 3;                       // bf16 Dh = 48: 3 lines of 32 bytes

// Where a unit's rows come from and land.  Keys are [memory (M), right
// context (R), left context (Lc), utterance] in up to three segments, each
// one TMA box (`joint`: k and v together, from the interleaved kv rows)
// or two (k and v); a `reset` segment (A's left context) is not copied
// for a slot being reset, whose rows read as zeros.  The plan: a unit is
// slot b's heads [hg * hpu, (hg + 1) * hpu) and its query rows [split *
// qb, (split + 1) * qb) (clipped to Q), taken by a group of hpu * wph
// warps: warp w of the group takes head hg * hpu + w / wph and, on the
// tensor cores, the 16-row tile w % wph, in the FMA path the rows [split
// * qb + (w % wph) * rpw, + rpw).  A block is `groups` groups that take
// its units in turn, on a ring of stages = groups + 1 (unit k in stage k
// % stages): more warps an SM beat more stages a group on the card.  A
// head row is
// `planes` lines of `line` bytes; a stage is one region of plane_bytes a
// plane, each holding its bytes of every row: the unit's q box (on the
// tensor cores 16 rows a tile, those past Q zero, where each warp then
// stages its output tile), each segment's box(es), each 1024-byte
// aligned, and a zero line (rows past K and a reset slot's left context
// read it).  Then come the FMA path's per-warp scaled q and probabilities,
// the barriers and each stage's tag: the unit last issued into it.  A
// group may run a round ahead of the group before it in the ring, and an
// mbarrier's parity cannot tell the phase it waits for from the one
// before, so a warp first waits for its unit's tag.
struct Geo {
  // geometry
  int B, H, Q, K, Dh, D, M, R, Lc, U, use_mem;
  int nseg, seg_c0[kMaxSegs], seg_rows[kMaxSegs], seg_src[kMaxSegs], seg_joint[kMaxSegs],
      seg_reset[kMaxSegs];
  int fill_from_length;  // A: m_m, m_kv from the lengths; D: given
  // plan
  int mma, hpu, wph, rpw, qb, splits, gwarps, groups, units, stages;
  int line, planes, swz_bits, kp;
  int q_off, seg_koff[kMaxSegs], seg_voff[kMaxSegs], zero_off, plane_bytes, stage_bytes;
  int warp_off, warp_bytes, bar_off, smem;
  uint32_t tx_full, tx_reset;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the FMA path's rows a warp at most (its kernels' RW): 1 at small B
__host__ __device__ inline int fma_rows(int rpw) { return rpw == 1 ? 1 : kMaxRowsPerWarp; }

// the stage layout and shared memory of a plan (fills the offsets, the
// sizes and smem)
inline void layout(Geo& g) {
  int off = round_up(g.hpu * g.qb * g.line, 1024);
  g.q_off = 0;
  uint32_t tx = (uint32_t)(g.hpu * g.qb * g.line), tx_reset = 0;
  for (int s = 0; s < kMaxSegs; ++s) {
    g.seg_koff[s] = g.seg_voff[s] = 0;
    if (s >= g.nseg || g.seg_rows[s] == 0) continue;
    const int one = g.hpu * g.seg_rows[s] * g.line;
    g.seg_koff[s] = off;
    if (g.seg_joint[s]) {
      g.seg_voff[s] = off + one;
      off += round_up(2 * one, 1024);
    } else {
      off += round_up(one, 1024);
      g.seg_voff[s] = off;
      off += round_up(one, 1024);
    }
    tx += 2u * one;
    if (g.seg_reset[s]) tx_reset += 2u * one;
  }
  g.zero_off = off;
  g.plane_bytes = round_up(off + kZeroBytes, 1024);
  g.stage_bytes = g.planes * g.plane_bytes;
  g.tx_full = tx * g.planes;
  g.tx_reset = (tx - tx_reset) * g.planes;
  g.warp_bytes = g.mma ? 0 : round_up(fma_rows(g.rpw) * (g.Dh + g.kp) * 4, 16);
  g.warp_off = g.stages * g.stage_bytes;
  g.bar_off = g.warp_off + g.groups * g.gwarps * g.warp_bytes;
  // 1024: aligning the base; then two barriers and a tag a stage
  g.smem = 1024 + g.bar_off + 20 * g.stages;
}

// The plan for `sms` SMs (see Geo).  Tensor cores: a warp a 16-row tile,
// up to 8 warps a group.  FMA: at large B (B * H >= sms) a warp up to 6
// rows, ceil(Q / 6) warps a head, up to 4 warps a group; at small B a warp
// one row, a unit the largest divisor of Q up to 8 rows of one head, so
// that a head's rows spread over Q / wph blocks.  Then the heads a unit
// (a divisor of H) and the groups a block (stages = groups + 1, up to 16
// warps) that give a block the most warps whose shared memory fits, more
// heads first; one group where the units are no more than the SMs.
// Returns false if no plan fits.
inline bool make_plan(Geo& g, bool mma, int elem, int sms) {
  g.mma = mma;
  int line = 128;
  while ((g.Dh * elem) % line) line /= 2;
  g.line = line;
  g.planes = g.Dh * elem / line;
  g.swz_bits = line == 128 ? 3 : line == 64 ? 2 : line == 32 ? 1 : 0;
  g.kp = round_up(g.K, mma ? 16 : 4);
  if (g.planes > kMaxPlanes) return false;
  int max_gw;
  if (mma) {
    g.wph = (g.Q + 15) / 16;
    g.rpw = 16;
    g.qb = 16 * g.wph;
    g.splits = 1;
    max_gw = kMaxGroupWarps;
  } else if ((long)g.B * g.H < sms) {
    g.rpw = 1;
    g.wph = 1;
    for (int d = kMaxGroupWarps; d >= 1; --d)
      if (g.Q % d == 0) { g.wph = d; break; }
    g.qb = g.wph;
    g.splits = g.Q / g.wph;
    max_gw = g.wph;
  } else {
    g.rpw = g.Q < kMaxRowsPerWarp ? g.Q : kMaxRowsPerWarp;
    g.wph = (g.Q + g.rpw - 1) / g.rpw;
    g.qb = g.Q;
    g.splits = 1;
    max_gw = g.wph > 4 ? g.wph : 4;
  }
  int best = 0;
  Geo pick = g;
  for (int hpu = g.H; hpu >= 1; --hpu) {
    if (g.H % hpu || hpu * g.wph > max_gw) continue;
    const long units = (long)g.B * (g.H / hpu) * g.splits;
    const int max_groups = units <= sms ? 1 : kMaxWarps / (hpu * g.wph);
    for (int groups = max_groups; groups >= 1; --groups) {
      Geo t = g;
      t.hpu = hpu;
      t.gwarps = hpu * g.wph;
      t.groups = groups;
      t.stages = groups + 1;
      layout(t);
      if (t.smem > kMaxSmem) continue;
      if (groups * t.gwarps > best) {
        best = groups * t.gwarps;
        pick = t;
        pick.units = (int)units;
      }
      break;
    }
  }
  if (best == 0) return false;
  g = pick;
  return true;
}

// The shapes the core takes: Q <= 32 rows, K <= 128 keys, and Dh a power
// of two times the 16-byte vector with at least two rows per warp in the
// value product (Dh / (16 / sizeof(T)) in {1, 2, 4, 8, 16}).
template <typename T>
__host__ inline bool supports(int Q, int K, int Dh) {
  const int e = 16 / (int)sizeof(T), lpr = Dh / e;
  return Q >= 1 && Q <= kMaxQueries && K >= 1 && K <= 32 * kMaxKeyChunks && Dh % e == 0 &&
         lpr >= 1 && lpr <= 16 && (lpr & (lpr - 1)) == 0;
}

// The shapes the tensor-core products take (bf16): Q <= 32 rows (two
// 16-row tiles), K <= 128 keys, Dh a multiple of 16 up to 64.
__host__ inline bool supports_mma(int Q, int K, int Dh) {
  return Q >= 1 && Q <= 32 && K >= 1 && K <= 128 && Dh % 16 == 0 && Dh <= 64;
}

// key chunks of 32 for K keys (the kernels' template argument)
__host__ inline int key_chunks(int K) { return (((K + 3) & ~3) + 31) / 32; }

// ------------------------------------------------------ host: TMA maps
//
// The host side of TMA for both libraries that include this header (its
// tensor maps, their cache, the SM count and the occupancy query) and the
// error codes the C entries return: emformer_stack.cu's GEMM encodes its
// maps here too.

constexpr int kErrShape = -2;
constexpr int kErrDriver = -3;
constexpr int kErrTensorMap = -4;

// The kernel's arguments: the plan, the TMA maps, a plane each (q; each
// key segment's k, or k + v where joint; the separate segment's v; A's
// bf16 output, a head's 16 rows a box) and the rest.
struct Args {
  CUtensorMap q_map[kMaxPlanes];
  CUtensorMap k_map[kMaxSegs][kMaxPlanes];
  CUtensorMap v_map[kMaxPlanes];
  CUtensorMap out_map[kMaxPlanes];
  Geo g;
  void* out;
  int out_bf16;            // the FMA path's output: bf16, else f32
  const int32_t* length;   // A: fill counts from the lengths
  const uint8_t* reset;    // A: slots whose left context reads as zeros
  const int32_t* m_m;      // D
  const int32_t* m_kv;
  float scaling, neg_inf;
};

typedef CUresult (*EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// libraries link no libcuda)
inline EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeFn)p : nullptr;
  }();
  return fn;
}

// A tensor map's description, the key of the map cache: elem is the
// element's bytes (1: uint8, 2: bf16, 4: f32), l2 the L2 promotion in
// bytes (128 or 256).  Zero it before filling it: the cache compares its
// bytes.
struct MapKey {
  const void* ptr;
  uint64_t dims[5], strides[4];
  uint32_t box[5], rank, elem, line, l2;
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(MapKey)) == 0; }
};

// The map of a tensor of `rank` dims (dim 0 contiguous, `line` bytes a box
// row, swizzled to match), zero past its edges.  A step's maps (the
// attention's few a launch and the left context's per layer; the GEMM's
// activation operands and stacked weights) are kept in a direct-mapped
// cache.
inline int encode(CUtensorMap* out, const MapKey& k) {
  constexpr int kSlots = 1024;
  static std::mutex mu;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static bool used[kSlots];
  uint64_t h = 1469598103934665603ull;
  const unsigned char* w = reinterpret_cast<const unsigned char*>(&k);
  for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ w[i]) * 1099511628211ull;
  const int slot = (int)(h % kSlots);
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && keys[slot] == k) {
    *out = maps[slot];
    return 0;
  }
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return kErrDriver;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = k.line == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : k.line == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : k.line == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                               : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (fn(&maps[slot],
         k.elem == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : k.elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         k.rank, const_cast<void*>(k.ptr), k.dims, k.strides, k.box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         k.l2 == 256 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    used[slot] = false;
    return kErrTensorMap;
  }
  keys[slot] = k;
  used[slot] = true;
  *out = maps[slot];
  return 0;
}

// The maps, one a plane, of rows of a [slots, rows, D] tensor (row stride
// `row_stride` elements, slot stride `slot_stride`): plane p's map starts
// p * line bytes into a row and reads boxes of line bytes x box_rows rows
// x `heads` heads (Dh apart) x one slot; with kv_stride > 0 a 5-d map
// whose fourth dim (2, stride kv_stride elements) takes k and v together.
inline int rows_maps(CUtensorMap* out, const Geo& g, const void* ptr, int elem, int rows,
                     int row_stride, long slot_stride, int box_rows, int heads,
                     int kv_stride = 0) {
  for (int p = 0; p < g.planes; ++p) {
    MapKey k;
    memset(&k, 0, sizeof(k));   // the cache compares its bytes
    k.ptr = static_cast<const unsigned char*>(ptr) + (size_t)p * g.line;
    k.elem = (uint32_t)elem;
    k.line = (uint32_t)g.line;
    k.l2 = 128;
    const uint64_t le = (uint64_t)(g.line / elem);
    k.dims[0] = le;
    k.dims[1] = (uint64_t)rows;
    k.dims[2] = (uint64_t)g.H;
    k.strides[0] = (uint64_t)row_stride * elem;
    k.strides[1] = (uint64_t)g.Dh * elem;
    k.box[0] = (uint32_t)le;
    k.box[1] = (uint32_t)box_rows;
    k.box[2] = (uint32_t)heads;
    if (kv_stride) {
      k.rank = 5;
      k.dims[3] = 2;
      k.dims[4] = (uint64_t)g.B;
      k.strides[2] = (uint64_t)kv_stride * elem;
      k.strides[3] = (uint64_t)slot_stride * elem;
      k.box[3] = 2;
      k.box[4] = 1;
    } else {
      k.rank = 4;
      k.dims[3] = (uint64_t)g.B;
      k.strides[2] = (uint64_t)slot_stride * elem;
      k.box[3] = 1;
    }
    const int rc = encode(&out[p], k);
    if (rc != 0) return rc;
  }
  return 0;
}

// the number of SMs of the current device
inline int sm_count() {
  constexpr int kDevices = 64;
  static int sms[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// blocks of `kernel` resident on an SM with `threads` threads and `smem`
// bytes of dynamic shared memory (cached by kernel, size and device)
template <typename K>
inline int resident(K kernel, int threads, int smem) {
  struct Entry { const void* f; int threads, smem, dev, blocks; };
  constexpr int kSlots = 256;
  static std::mutex mu;
  static Entry cache[kSlots];
  int dev = 0;
  cudaGetDevice(&dev);
  const void* f = reinterpret_cast<const void*>(kernel);
  const int slot =
      (int)(((reinterpret_cast<uintptr_t>(f) >> 4) * 31u + threads * 7u + smem + dev) % kSlots);
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[slot];
  if (e.f == f && e.threads == threads && e.smem == smem && e.dev == dev) return e.blocks;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  e = Entry{f, threads, smem, dev, blocks};
  return blocks;
}

// Launch kernel<<<grid, warps x 32>>> on the plan in a: the persistent
// grid is the units or the blocks resident on the card, the fewer.
template <typename K>
inline int launch(K kernel, const Args& a, cudaStream_t st) {
  const int threads = a.g.groups * a.g.gwarps * 32;
  if (a.g.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_sm = resident(kernel, threads, a.g.smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long fit = (long)per_sm * sm_count();
  const int grid = (int)(a.g.units < fit ? a.g.units : fit);
  kernel<<<grid, threads, a.g.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// What a kernel of the plan uses (the C entries' report): out[0..14] =
// mma, hpu, wph, rpw, qb, splits, groups, warps a block, units, stages,
// stage_bytes, smem, grid, registers a thread, blocks resident an SM.
template <typename K>
inline int report(K kernel, const Geo& g, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  if (g.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = g.groups * g.gwarps;
  const int per_sm = resident(kernel, warps * 32, g.smem);
  const long fit = (long)per_sm * sm_count();
  const int v[15] = {g.mma, g.hpu, g.wph, g.rpw, g.qb, g.splits, g.groups, warps, g.units,
                     g.stages, g.stage_bytes, g.smem, (int)(g.units < fit ? g.units : fit),
                     attr.numRegs, per_sm};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

// The geometry of A's attention (fill counts from the lengths; keys from
// the interleaved kv rows [B, M+R+U, 2, D] and the left context [B, Lc,
// D]) and of D's (fill counts given; k and v [B, K, D]), with its plan
inline bool stack_geo(Geo& g, bool mma, int elem, int B, int H, int D, int U, int R, int M,
                      int Lc, int use_mem) {
  const int MR = M + R;
  g = Geo{};
  g.B = B; g.H = H; g.D = D; g.Dh = D / H; g.U = U; g.R = R; g.M = M; g.Lc = Lc;
  g.use_mem = use_mem;
  g.Q = R + U + use_mem;
  g.K = MR + Lc + U;
  g.nseg = 3;
  const int c0[3] = {0, MR, MR + Lc}, rows[3] = {MR, Lc, U}, src[3] = {0, 0, MR};
  for (int s = 0; s < 3; ++s) {
    g.seg_c0[s] = c0[s];
    g.seg_rows[s] = rows[s];
    g.seg_src[s] = src[s];
    g.seg_joint[s] = s != 1;
    g.seg_reset[s] = s == 1;
  }
  g.fill_from_length = 1;
  return make_plan(g, mma, elem, sm_count());
}

inline bool plain_geo(Geo& g, int elem, int B, int Q, int K, int D, int H, int M, int R,
                      int Lc, int use_mem) {
  g = Geo{};
  g.B = B; g.H = H; g.D = D; g.Dh = D / H; g.Q = Q; g.K = K;
  g.M = M; g.R = R; g.Lc = Lc; g.U = K - M - R - Lc; g.use_mem = use_mem;
  g.nseg = 1;
  g.seg_rows[0] = K;
  return make_plan(g, false, elem, sm_count());
}

// ---------------------------------------------------------- the device

// What the warps' loops read, in registers (copied once from the
// parameters: reading the plan from parameter space in the loops, through
// a reference, cost a chain of loads on every access)
struct Ctx {
  int Q, K, Dh, D, M, R, Lc, use_mem, kp, line, lshift, mask, plane_bytes;
  float scaling, neg_inf;
};

// A unit's keys for one head, in registers: key c of segment s lies in
// plane 0's line kb_s (vb_s for v) + c * line; zero: plane 0's zero line
struct Keys {
  uint32_t kb0, kb1, kb2, vb0, vb1, vb2, zero;
  int c1, c2;
  bool z1;      // segment 1 (A's left context) reads zeros: the slot is reset
};

// The swizzle of the TMA boxes (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B for a
// line of 32/64/128 bytes, none for 16): address bits [4, 4 + b) XOR bits
// [7, 7 + b), b = log2(line / 16), on shared-window addresses (every box
// starts 1024-byte aligned); mask = ((1 << b) - 1) << 4.  Of a line's
// address: a byte within it is then at (swz_line ^ byte).
__device__ __forceinline__ uint32_t swz_line(uint32_t la, int mask) {
  return la ^ ((la >> 3) & (uint32_t)mask);
}

__device__ __forceinline__ Keys unit_keys(const Geo& g, uint32_t stage, int hl, bool rs) {
  Keys k;
  const int line = g.line;
  k.kb0 = stage + (uint32_t)(g.seg_koff[0] + (hl * g.seg_rows[0] - g.seg_c0[0]) * line);
  k.vb0 = stage + (uint32_t)(g.seg_voff[0] + (hl * g.seg_rows[0] - g.seg_c0[0]) * line);
  k.kb1 = stage + (uint32_t)(g.seg_koff[1] + (hl * g.seg_rows[1] - g.seg_c0[1]) * line);
  k.vb1 = stage + (uint32_t)(g.seg_voff[1] + (hl * g.seg_rows[1] - g.seg_c0[1]) * line);
  k.kb2 = stage + (uint32_t)(g.seg_koff[2] + (hl * g.seg_rows[2] - g.seg_c0[2]) * line);
  k.vb2 = stage + (uint32_t)(g.seg_voff[2] + (hl * g.seg_rows[2] - g.seg_c0[2]) * line);
  k.zero = stage + (uint32_t)g.zero_off;
  k.c1 = g.nseg > 1 ? g.seg_c0[1] : g.K;
  k.c2 = g.nseg > 2 ? g.seg_c0[2] : g.K;
  k.z1 = rs && g.seg_reset[1];
  return k;
}

// the swizzled plane-0 line of key c (kv 0: k, 1: v), without branches;
// byte b of plane p of that row is at (line ^ b) + p * plane_bytes
__device__ __forceinline__ uint32_t key_line(const Ctx& x, const Keys& k, int kv, int c) {
  const bool s2 = c >= k.c2, s1 = c >= k.c1;
  const uint32_t b = kv ? (s2 ? k.vb2 : s1 ? k.vb1 : k.vb0) : (s2 ? k.kb2 : s1 ? k.kb1 : k.kb0);
  const uint32_t la = swz_line(b + (uint32_t)(c * x.line), x.mask);
  return (c >= x.K || (s1 && !s2 && k.z1)) ? k.zero : la;
}

// the swizzled plane-0 line of row r of head hl's q box
__device__ __forceinline__ uint32_t q_line(const Ctx& x, uint32_t stage, int hl, int qb,
                                           int r) {
  return swz_line(stage + (uint32_t)((hl * qb + r) * x.line), x.mask);
}

__device__ __forceinline__ uint32_t at(const Ctx& x, uint32_t lx, int byte) {
  return (lx ^ (uint32_t)(byte & (x.line - 1))) + (uint32_t)((byte >> x.lshift) * x.plane_bytes);
}

// A unit's copies into a stage, by one thread: each plane's q, then each
// segment
__device__ __forceinline__ void issue(const Args& a, int u, uint32_t stage, uint32_t bar,
                                      uint32_t tag, bool rs) {
  const Geo& g = a.g;
  st_tag(tag, u);
  const int split = u % g.splits, hg = (u / g.splits) % (g.H / g.hpu);
  const int b = u / g.splits / (g.H / g.hpu);
  const int h0 = hg * g.hpu;
  mbar_expect_tx(bar, rs ? g.tx_reset : g.tx_full);
  for (int p = 0; p < g.planes; ++p) {
    const uint32_t st = stage + (uint32_t)(p * g.plane_bytes);
    tma_load_4d(st + g.q_off, &a.q_map[p], bar, 0, split * g.qb, h0, b);
#pragma unroll
    for (int s = 0; s < kMaxSegs; ++s) {
      if (s >= g.nseg || g.seg_rows[s] == 0 || (rs && g.seg_reset[s])) continue;
      if (g.seg_joint[s]) {
        tma_load_5d(st + g.seg_koff[s], &a.k_map[s][p], bar, 0, g.seg_src[s], h0, 0, b);
      } else {
        tma_load_4d(st + g.seg_koff[s], &a.k_map[s][p], bar, 0, g.seg_src[s], h0, b);
        tma_load_4d(st + g.seg_voff[s], &a.v_map[p], bar, 0, g.seg_src[s], h0, b);
      }
    }
  }
}

// Logits, mask, softmax and the value product of the warp's n <= RW query
// rows (q box rows r0 .. r0 + n - 1 of the unit's head hl; global rows q0
// ..) on the FMA path; releases the stage (arrive on `empty`) once it is
// read, then stores to out (f32, or bf16 with out_bf16).  qs/ps: the
// warp's scaled q [rpw][Dh] and probabilities [rpw][kp], f32.  DH: the
// head width if fixed at compile time (0: x.Dh).  The products run over
// all RW rows whatever n is, so that no branch splits their loads from
// their sums; rows past n are never stored.
template <typename T, int KJ, int RW, int DH, bool kRound>
__device__ __forceinline__ void attend_fma(const Ctx& x, const Keys& ky, uint32_t stage,
                                           uint32_t empty, float* qs, float* ps, int hl,
                                           int qb, int r0, int n, int q0, void* out_ptr,
                                           bool out_bf16, int mm, int mkv) {
  constexpr int E = Vec<T>::N;
  constexpr int EB = 16;                  // bytes a lane's vector
  // rows a lane in the value product: a row takes Dh / E lanes, so rows
  // RPI apart share a lane (at least 2 apart; exact with DH fixed)
  constexpr int RPI = DH ? 32 / (DH / E) : 2;
  constexpr int RL = (RW + RPI - 1) / RPI;
  const int lane = threadIdx.x & 31;
  const int Q = x.Q, K = x.K, Kp = x.kp, Dh = DH ? DH : x.Dh;
  const int cpr = Dh / E;

  // q * scaling (rounded to T with kRound) into the warp's f32 rows
  for (int i = lane; i < n * cpr; i += 32) {
    const int r = i / cpr, c = i - r * cpr;
    float v[E];
    lds16(at(x, q_line(x, stage, hl, qb, r0 + r), c * EB), v);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[j] = v[j] * x.scaling;
      if (kRound) v[j] = rnd<T>(v[j]);
    }
    store_row<E>(qs + r * Dh + c * E, v);
  }
  __syncwarp();

  // logits: acc[i][j] = q[row i] . k[lane + 32 j], summed over d in order
  uint32_t kl[KJ], vl[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    kl[j] = key_line(x, ky, 0, lane + 32 * j);
    vl[j] = key_line(x, ky, 1, lane + 32 * j);
  }
  float acc[RW][KJ];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
#pragma unroll(DH ? DH / E : 1)
  for (int d0 = 0; d0 < Dh; d0 += E) {
    float kv[KJ][E];
#pragma unroll
    for (int j = 0; j < KJ; ++j) lds16(at(x, kl[j], d0 * (int)sizeof(T)), kv[j]);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float* qr = qs + i * Dh + d0;
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

  // mask and softmax in registers; probabilities to the warp's rows
  const int lc_lo = x.M + x.R, lc_hi = x.M + x.R + (x.Lc - mkv), mem_hi = x.M - mm;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i < n) {
      const int r = q0 + i;
      float mx = -3.402823466e38f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = lane + 32 * j;
        bool valid = !(c >= lc_lo && c < lc_hi);
        if (x.use_mem && c < x.M && (c < mem_hi || r == Q - 1)) valid = false;
        acc[i][j] = valid ? acc[i][j] : x.neg_inf;
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
          float pr = acc[i][j] / s;
          if (kRound) pr = rnd<T>(pr);
          ps[i * Kp + c] = pr;
        }
      }
    }
  }
  __syncwarp();

  // value product: lane = (row slot gq, column group cg) owns E columns of
  // rows i = gq, gq + rpi, ...; summed over the keys in order, four keys'
  // rows (their lines shuffled from the lanes that hold them) loaded
  // before their products
  const int lpr = Dh / E, rpi = 32 / lpr;
  const int cg = lane % lpr, gq = lane / lpr;
  float o[RL][E];
#pragma unroll
  for (int t = 0; t < RL; ++t)
#pragma unroll
    for (int e = 0; e < E; ++e) o[t][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    for (int c0 = 32 * j; c0 < Kp && c0 < 32 * j + 32; c0 += 4) {
      float vv[4][E];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        lds16(at(x, __shfl_sync(0xffffffffu, vl[j], c0 + cc - 32 * j), cg * EB), vv[cc]);
      float p4[RL][4];
#pragma unroll
      for (int t = 0; t < RL; ++t) {
        const int i = min(gq + rpi * t, RW - 1);
        const float4 pv = *reinterpret_cast<const float4*>(ps + i * Kp + c0);
        p4[t][0] = pv.x; p4[t][1] = pv.y; p4[t][2] = pv.z; p4[t][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int t = 0; t < RL; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) o[t][e] = fmaf(p4[t][cc], vv[cc][e], o[t][e]);
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
#pragma unroll
  for (int t = 0; t < RL; ++t) {
    const int i = gq + rpi * t;
    if (i < n) {
      const size_t at_row = (size_t)i * x.D + cg * E;
      if (out_bf16)
        store_row<E>(static_cast<bf16*>(out_ptr) + at_row, o[t]);
      else
        store_row<E>(static_cast<float*>(out_ptr) + at_row, o[t]);
    }
  }
}

// ------------------------------------------------ tensor-core products

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

// bf16 pair * scaling, rounded to bf16 (the value the stack kernel's q *
// scaling takes)
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scaling) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16x2(f.x * scaling, f.y * scaling);
}

// Both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// sums), for bf16 with the stack kernel's rounding points: q * scaling
// and the probabilities are bf16 values, so each product is exact and
// only the order of the f32 sums differs from the FMA path.  The warp
// takes query rows m0 .. m0 + 15 of head hl (KT tiles of 16 keys; KS
// k-steps if fixed at compile time, else Dh / 16): its q
// fragments come scaled from the stage (rows past Q are zero), its logits
// stay in the accumulator registers (lane: rows g and g + 8, keys 8n +
// 2t, + 1; each key tile summed over the k-steps in order) for the mask
// (a key's validity taken once for both rows) and the softmax (row max
// and sum over the quad of lanes that share a row), and its
// probabilities, rounded to bf16, become the A fragments of the value
// product as they are; V comes through ldmatrix .trans.  The output tile
// overwrites the warp's own q rows in the stage (swizzled as they came)
// and goes out as one TMA store a plane, rows past Q clipped; the warp
// releases the stage once the store has read it, at its next unit (run).
template <int KT, int KS>
__device__ __forceinline__ void attend_mma(const Args& a, const Ctx& x, const Keys& ky,
                                           uint32_t stage, int hl, int qb,
                                           int m0, int b, int h, int mm, int mkv, int planes) {
  constexpr int NT = 2 * KT;              // key tiles of 8
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ksteps = KS ? KS : x.Dh / 16; // k-steps of 16 over Dh

  // q fragments of the k-steps, scaled
  uint32_t qa[4][4];
  const uint32_t ql = q_line(x, stage, hl, qb, m0 + (lane & 15));
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks < ksteps) {
      ldsm_x4(qa[ks], at(x, ql, (16 * ks + (lane >> 4) * 8) * 2));
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_pair(qa[ks][i], x.scaling);
    }
  }

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int np = 0; np < KT; ++np) {
    const uint32_t kl = key_line(x, ky, 0, 16 * np + (lane & 7) + ((lane >> 4) << 3));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < ksteps) {
        uint32_t bb[4];
        ldsm_x4(bb, at(x, kl, (16 * ks + ((lane >> 3) & 1) * 8) * 2));
        mma_bf16(s[2 * np], qa[ks], bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], qa[ks], bb[2], bb[3]);
      }
    }
  }

  // mask and softmax: value s[n][2h + e] is row m0 + gq + 8h, key 8n + 2tq + e
  const int lc_lo = x.M + x.R, lc_hi = x.M + x.R + (x.Lc - mkv), mem_hi = x.M - mm;
  const bool summary[2] = {x.use_mem && m0 + gq == x.Q - 1, x.use_mem && m0 + gq + 8 == x.Q - 1};
  float mt[NT][2];                        // a key tile's max: a tree, not a chain
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mt[n][0] = mt[n][1] = -3.402823466e38f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + 2 * tq + e;
      const bool in_k = c < x.K, mem = x.use_mem && c < x.M;
      const bool open = !(c >= lc_lo && c < lc_hi) && !(mem && c < mem_hi);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool valid = open && !(mem && summary[hh]);
        const float v = valid ? s[n][2 * hh + e] : x.neg_inf;
        s[n][2 * hh + e] = v;
        if (in_k) mt[n][hh] = fmaxf(mt[n][hh], v);
      }
    }
  }
#pragma unroll
  for (int w = 1; w < NT; w *= 2)
#pragma unroll
    for (int n = 0; n + w < NT; n += 2 * w) {
      mt[n][0] = fmaxf(mt[n][0], mt[n + w][0]);
      mt[n][1] = fmaxf(mt[n][1], mt[n + w][1]);
    }
  float mx[2] = {mt[0][0], mt[0][1]};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n < x.K) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * tq + e;
          const float p = c < x.K ? expf(s[n][2 * hh + e] - mx[hh]) : 0.f;
          s[n][2 * hh + e] = p;
          sum[hh] += p;
        }
    } else {
      // a tile past K adds +0 to the sums, as its zero probabilities did
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[n][2 * hh] = s[n][2 * hh + 1] = 0.f;
        sum[hh] += 0.f;
        sum[hh] += 0.f;
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }

  // value product: the probabilities of keys 16kk .. 16kk + 15 are the A
  // fragment (key tiles 2kk and 2kk + 1), rounded to bf16
  const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
  float o[8][4];                          // Dh <= 64
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
    pa[1] = pack_bf16x2(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
    pa[2] = pack_bf16x2(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
    pa[3] = pack_bf16x2(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
    const uint32_t vl = key_line(x, ky, 1, 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < ksteps) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, at(x, vl, (16 * np + (lane >> 4) * 8) * 2));
        mma_bf16(o[2 * np], pa, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
      }
    }
  }

  // the output tile over the warp's q rows, then one TMA store a plane
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint32_t rl = q_line(x, stage, hl, qb, m0 + gq + 8 * hh);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (8 * n < x.Dh)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at(x, rl, (8 * n + 2 * tq) * 2)),
                     "r"(pack_bf16x2(o[n][2 * hh], o[n][2 * hh + 1]))
                     : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    const uint32_t tile = stage + (uint32_t)((hl * qb + m0) * x.line);
    for (int p = 0; p < planes; ++p)
      tma_store_4d(&a.out_map[p], tile + (uint32_t)(p * x.plane_bytes), 0, m0, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// The persistent body of both kernels: thread 0 fills the ring of stages
// first; then each group of warps takes every groups-th unit the block
// walks, and its first lane refills each stage the group releases (see
// Geo).  On the tensor cores a warp releases a unit's stage at the start
// of its next unit, once its output store has read it.
// KN: 16-key tiles on the tensor cores, 32-key chunks on the FMA path;
// RW: the FMA path's rows a warp at most; DH: the head width if fixed at
// compile time (0: from the plan).  Each warp reads a unit's fill counts
// and reset flag one unit ahead.
template <typename T, int KN, int RW, int DH, bool kRound, bool kMma>
__device__ __forceinline__ void run(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geo& g = a.g;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages = g.stages, units = g.units, splits = g.splits, HG = g.H / g.hpu;
  const int groups = g.groups, gwarps = g.gwarps;
  const int stage_bytes = g.stage_bytes, qb = g.qb, rpw = g.rpw, planes = g.planes;
  const uint32_t full0 = base + g.bar_off, empty0 = full0 + 8 * stages;
  const uint32_t tag0 = empty0 + 8 * stages;
  Ctx x;
  x.Q = g.Q; x.K = g.K; x.Dh = g.Dh; x.D = g.D; x.M = g.M; x.R = g.R; x.Lc = g.Lc;
  x.use_mem = g.use_mem; x.kp = g.kp; x.line = g.line; x.lshift = __ffs(g.line) - 1;
  x.mask = ((1 << g.swz_bits) - 1) << 4;
  x.plane_bytes = g.plane_bytes;
  x.scaling = a.scaling;
  x.neg_inf = a.neg_inf;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, gwarps);
      st_tag(tag0 + 4 * s, -1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every stage's zero lines, which no copy writes
  for (int i = threadIdx.x; i < stages * planes * (kZeroBytes / 16); i += blockDim.x) {
    const int sp = i / (kZeroBytes / 16), c = i - sp * (kZeroBytes / 16);
    *reinterpret_cast<uint4*>(gbase + sp * g.plane_bytes + g.zero_off + 16 * c) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const uint8_t* reset = a.reset;
  auto slot_of = [&](int u) { return u / splits / HG; };
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) {
      const int u = blockIdx.x + s * gridDim.x;
      if (u < units)
        issue(a, u, base + s * stage_bytes, full0 + 8 * s, tag0 + 4 * s,
              reset != nullptr && reset[slot_of(u)] != 0);
    }

  const int grp = warp / gwarps, wg = warp - grp * gwarps;
  const int hl = wg / g.wph, wi = wg - hl * g.wph;
  const bool leader = wg == 0 && lane == 0;
  const bool from_length = g.fill_from_length != 0;
  const int U = max(g.U, 1);
  // a unit's slot's fill counts (mm, mkv) and reset flag, read ahead
  auto counts = [&](int u, int& mm, int& mkv, bool& rs) {
    if (u >= units) return;
    const int b = slot_of(u);
    if (from_length) {
      const int len = a.length[b];
      mm = min(x.M, len / U);
      mkv = min(x.Lc, len);
    } else {
      mm = a.m_m[b];
      mkv = a.m_kv[b];
    }
    rs = reset != nullptr && reset[b] != 0;
  };
  int mm = 0, mkv = 0;
  bool rs = false;
  counts(blockIdx.x + grp * gridDim.x, mm, mkv, rs);
  int prev = -1;                          // tensor cores: the stage to release
  bool prev_rs = false;                   // the reset flag of its refill
  for (int k = grp;; k += groups) {
    const int u = blockIdx.x + k * gridDim.x;
    if (u >= units) break;
    const int s = k % stages;
    const uint32_t parity = (uint32_t)((k / stages) & 1);
    const int split = u % splits, hg = (u / splits) % HG, b = slot_of(u);
    const int h = hg * g.hpu + hl;
    const int u_next = u + stages * gridDim.x;
    const bool rs_next = leader && u_next < units && reset != nullptr &&
                         reset[slot_of(u_next)] != 0;
    int mm_n = 0, mkv_n = 0;
    bool rs_n = false;
    counts(u + groups * gridDim.x, mm_n, mkv_n, rs_n);
    const uint32_t stage = base + s * stage_bytes;
    const Keys ky = unit_keys(g, stage, hl, rs);
    if (kMma && prev >= 0) {
      const int ps = prev % stages;
      const uint32_t pp = (uint32_t)((prev / stages) & 1);
      const int pu = blockIdx.x + (prev + stages) * gridDim.x;
      if (lane == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(empty0 + 8 * ps);
      }
      if (leader && pu < units) {
        mbar_wait(empty0 + 8 * ps, pp);
        issue(a, pu, base + ps * stage_bytes, full0 + 8 * ps, tag0 + 4 * ps, prev_rs);
      }
      __syncwarp();
    }
    wait_tag(tag0 + 4 * s, u);
    mbar_wait(full0 + 8 * s, parity);
    __syncwarp();       // converged for ldmatrix / mma.sync
    if constexpr (kMma) {
      attend_mma<KN, DH / 16>(a, x, ky, stage, hl, qb, 16 * wi, b, h, mm, mkv, planes);
      prev = k;
      prev_rs = rs_next;
    } else {
      float* qs = reinterpret_cast<float*>(gbase + g.warp_off + warp * g.warp_bytes);
      float* ps = qs + RW * x.Dh;
      const int r0 = wi * rpw, q0 = split * qb + r0;
      int n = min(rpw, x.Q - q0);
      if (n < 0) n = 0;
      const size_t off = ((size_t)b * x.Q + q0) * x.D + h * x.Dh;
      void* out = a.out_bf16 ? (void*)(static_cast<bf16*>(a.out) + off)
                             : (void*)(static_cast<float*>(a.out) + off);
      attend_fma<T, KN, RW, DH, kRound>(x, ky, stage, empty0 + 8 * s, qs, ps, hl, qb, r0, n,
                                        q0, out, a.out_bf16 != 0, mm, mkv);
    }
    if (!kMma && leader && u_next < units) {
      mbar_wait(empty0 + 8 * s, parity);
      issue(a, u_next, stage, full0 + 8 * s, tag0 + 4 * s, rs_next);
    }
    __syncwarp();
    mm = mm_n;
    mkv = mkv_n;
    rs = rs_n;
  }
  if (kMma && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace attn_core
